"""hvdlint CLI: file collection, engine dispatch, output formatting.

Counterpart: ``horovod_tpu/analysis/cli.py`` (``tools/hvdlint``).  The
port's CLI is ``python -m horovod_tpu_torch.analysis [paths]``: without
paths it lints the port's package, and it subtracts the port's own
baseline (``horovod_tpu_torch/analysis/baseline.json``) unless
``--no-baseline`` is given.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import baseline as baseline_mod
from . import contracts as contracts_mod
from . import divergence, guarded_by, lifecycle, lock_order, user_rules
from .report import (Finding, RULES, apply_suppressions,
                     file_skipped, iter_suppressions)

_SKIP_DIRS = {"__pycache__", ".git", "build", "dist", "node_modules",
              ".pytest_cache", ".hypothesis"}

#: All engines, in run order.  "guards" is the HVD110–115 guarded-by
#: race detector (guarded_by.py); "divergence" is the HVD200–HVD205
#: SPMD rank-divergence dataflow engine (divergence.py); "lifecycle"
#: is the HVD400–HVD407 concurrency-lifecycle engine (lifecycle.py:
#: blocking-under-lock, unbounded growth, clock mixing, shutdown
#: hygiene); "contracts" is the HVD300–HVD307 cross-artifact contract
#: checker (contracts.py) — the only engine that reasons repo-wide
#: instead of per-module, so it runs once per analyze_files() call,
#: not per file.
ENGINES = ("user", "locks", "guards", "divergence", "lifecycle",
           "contracts")

#: The per-module engines (everything except the repo-wide pass).
_MODULE_ENGINES = ("user", "locks", "guards", "divergence", "lifecycle")

#: Parsed-AST cache keyed by absolute path: every pass (user rules,
#: lock-order, guarded-by, divergence) and every re-run in one process
#: (e.g. the framework-wide pytest pins) reuses one parse per file
#: revision.  The entry is validated against the SOURCE CONTENT
#: (size + crc32), never against mtime — a file edited between read and
#: stat can not poison the cache with a stale tree.  The cache stores
#: ONLY the parse result, which depends on nothing but the source, so
#: it needs no ANALYZER_VERSION keying; findings are recomputed from
#: the AST on every call, and the version token guards the artifacts
#: that DO persist findings (the baseline files, baseline.py).
_AST_CACHE: Dict[str, Tuple[Tuple[int, int], ast.Module]] = {}


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in _SKIP_DIRS
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
        else:
            out.append(p)
    return out


def changed_files(base: str = "HEAD",
                  paths: Optional[Sequence[str]] = None) -> List[str]:
    """Python files changed in the working tree against ``base`` (the
    ``--changed`` pre-commit mode: ``git diff --name-only``).

    git emits repo-root-relative names; they are resolved against the
    repository toplevel so the mode works from any subdirectory."""
    import subprocess
    top = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                         capture_output=True, text=True)
    if top.returncode != 0:
        raise RuntimeError(
            f"not inside a git repository: {top.stderr.strip()}")
    toplevel = top.stdout.strip()
    proc = subprocess.run(
        ["git", "diff", "--name-only", "--diff-filter=d", base, "--"],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"git diff --name-only {base} failed: "
            f"{proc.stderr.strip() or proc.stdout.strip()}")
    roots = [os.path.abspath(p) for p in (paths or [])]
    out = []
    for name in proc.stdout.splitlines():
        name = name.strip()
        if not name.endswith(".py"):
            continue
        full = os.path.join(toplevel, name)
        if not os.path.exists(full):
            continue
        if roots and not any(
                full == r or full.startswith(r + os.sep) for r in roots):
            continue
        out.append(os.path.relpath(full))
    return sorted(out)


def analyze_source(source: str, path: str = "<string>",
                   include_skipped: bool = False,
                   engines: Iterable[str] = ENGINES,
                   tree: Optional[ast.Module] = None,
                   ) -> List[Finding]:
    """Run the selected PER-MODULE engines over one module's source.

    The repo-wide "contracts" engine cannot see a single module in
    isolation and is ignored here; it runs from analyze_files()."""
    if not include_skipped and file_skipped(source):
        return []
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            return [Finding("HVD000", path, exc.lineno or 1, exc.offset or 0,
                            f"could not parse: {exc.msg}")]
    findings: List[Finding] = []
    if "user" in engines:
        findings.extend(user_rules.check_module(tree, path))
    if "locks" in engines:
        findings.extend(lock_order.check_module(tree, path))
    if "guards" in engines:
        findings.extend(guarded_by.check_module(tree, path))
    if "divergence" in engines:
        findings.extend(divergence.check_module(tree, path))
    if "lifecycle" in engines:
        findings.extend(lifecycle.check_module(tree, path))
    findings = _dedupe_generalized(findings)
    findings = apply_suppressions(findings, iter_suppressions(source))
    findings.sort(key=lambda f: (f.line, f.col, f.code))
    return findings


#: The divergence engine generalizes two user rules; when both fire on
#: the same line, the specific rule's message wins and the generalized
#: finding is dropped (one bug, one finding).
_GENERALIZES = {"HVD200": "HVD001", "HVD202": "HVD003"}


def _dedupe_generalized(findings: List[Finding]) -> List[Finding]:
    specific = {(f.code, f.path, f.line) for f in findings}
    return [f for f in findings
            if f.code not in _GENERALIZES
            or (_GENERALIZES[f.code], f.path, f.line) not in specific]


def analyze_paths(paths: Sequence[str], include_skipped: bool = False,
                  engines: Iterable[str] = ENGINES,
                  select: Optional[Sequence[str]] = None,
                  ) -> List[Finding]:
    """Walk ``paths`` (files or directories) and analyze every .py file."""
    return analyze_files(collect_files(paths), include_skipped, engines,
                         select)


def _parse_cached(path: str, source: str) -> Optional[ast.Module]:
    """Parse ``source``, reusing the cached AST while the content is
    unchanged (size + crc32 of the source actually read).  Returns None
    on syntax errors — the caller reports HVD000."""
    import zlib
    data = source.encode("utf-8", errors="surrogatepass")
    key = (len(data), zlib.crc32(data))
    cache_key = os.path.abspath(path)
    hit = _AST_CACHE.get(cache_key)
    if hit is not None and hit[0] == key:
        return hit[1]
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    _AST_CACHE[cache_key] = (key, tree)
    return tree


def _read_or_empty(path: str) -> str:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def analyze_files(files: Sequence[str], include_skipped: bool = False,
                  engines: Iterable[str] = ENGINES,
                  select: Optional[Sequence[str]] = None,
                  ) -> List[Finding]:
    findings: List[Finding] = []
    module_engines = [e for e in engines if e in _MODULE_ENGINES]
    inputs: List[Tuple[str, str, Optional[ast.Module]]] = []
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
        except OSError as exc:
            findings.append(Finding("HVD000", path, 1, 0,
                                    f"could not read: {exc}"))
            continue
        tree = _parse_cached(path, source)
        inputs.append((path, source, tree))
        findings.extend(analyze_source(
            source, path, include_skipped=include_skipped,
            engines=module_engines, tree=tree))
    if "contracts" in engines:
        # repo-wide pass: one extraction over the canonical scan set
        # (plus the explicit inputs), riding the shared AST cache
        findings.extend(contracts_mod.check_files(
            inputs, include_skipped=include_skipped, parse=_parse_cached))
    if select:
        wanted = {c.strip().upper() for c in select}
        findings = [f for f in findings if f.code in wanted]
    return findings


_RANGE_RE = re.compile(r"^HVD(\d+)-(?:HVD)?(\d+)$")


def expand_select(spec: str) -> Tuple[List[str], List[str]]:
    """Parse a ``--select`` spec with ranges (``HVD110-HVD115``).
    Returns (codes, unknown tokens)."""
    codes: List[str] = []
    unknown: List[str] = []
    for tok in spec.split(","):
        tok = tok.strip().upper()
        if not tok:
            continue
        m = _RANGE_RE.match(tok)
        if m:
            lo, hi = int(m.group(1)), int(m.group(2))
            hits = [f"HVD{n:03d}" for n in range(lo, hi + 1)
                    if f"HVD{n:03d}" in RULES]
            # a range may span a family's reserved band (HVD200-HVD215
            # selects the divergence+schedule family even though 206-209
            # and 212-215 are not yet assigned), but a range selecting
            # NOTHING is a typo — it would filter out every finding and
            # exit 0, fatal in a CI gate
            if hi < lo or not hits:
                unknown.append(tok)
                continue
            codes.extend(hits)
        elif tok in RULES:
            codes.append(tok)
        else:
            unknown.append(tok)
    return codes, unknown


def to_sarif(findings: Sequence[Finding]) -> dict:
    """SARIF 2.1.0 log for one run — the interchange format CI systems
    (GitHub code scanning, Gerrit checks) ingest to annotate diffs.

    One run, one driver ("hvdlint"), the full six-engine rule catalog in
    ``tool.driver.rules`` (so viewers can render titles/help for codes
    with zero results), one ``result`` per finding.  Columns are
    0-based internally; SARIF wants 1-based ``startColumn``.  Absolute
    finding paths are rewritten relative to the repo root (same walk-up
    the contracts engine uses), so a run over ``/abs/path/to/repo/...``
    emits the same SRCROOT-relative URIs as an in-repo run."""
    from .report import ANALYZER_VERSION
    root = contracts_mod.find_repo_root([f.path for f in findings])
    rules = [{
        "id": code,
        "shortDescription": {"text": title},
        "help": {"text": fixit},
    } for code, (title, fixit) in sorted(RULES.items())]
    index = {r["id"]: i for i, r in enumerate(rules)}
    results = []
    for f in findings:
        uri = f.path
        if root and os.path.isabs(uri):
            ap = os.path.abspath(uri)
            if ap == root or ap.startswith(root + os.sep):
                uri = os.path.relpath(ap, root)
        results.append({
            "ruleId": f.code,
            "ruleIndex": index.get(f.code, -1),
            "level": "error",
            "message": {"text": f"{f.message}\nfix: {f.fixit}"},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": uri.replace(os.sep, "/"),
                        "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(f.line, 1),
                               "startColumn": f.col + 1},
                }}],
        })
    return {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "hvdlint",
                "version": str(ANALYZER_VERSION),
                "informationUri": "docs/analysis.md",
                "rules": rules,
            }},
            "columnKind": "utf16CodeUnits",
            "results": results,
        }],
    }


def _list_rules() -> str:
    lines = ["hvdlint rules:"]
    for code, (title, fixit) in sorted(RULES.items()):
        lines.append(f"  {code}  {title}")
        lines.append(f"         fix: {fixit}")
    return "\n".join(lines)


def _docs_path() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "docs", "analysis.md")


def explain_rule(code: str) -> str:
    """The docs/analysis.md catalog entry for ``code`` (falls back to the
    built-in title + fix-it when the docs tree is not installed)."""
    code = code.strip().upper()
    if code not in RULES:
        return f"unknown rule code: {code} (see --list-rules)"
    section: List[str] = []
    try:
        with open(_docs_path(), "r", encoding="utf-8") as f:
            in_section = False
            for line in f:
                if line.startswith("### "):
                    if in_section:
                        break
                    in_section = line.startswith(f"### {code}")
                elif in_section and line.startswith("## "):
                    break
                if in_section:
                    section.append(line.rstrip("\n"))
    except OSError:
        section = []
    if section:
        return "\n".join(section).strip()
    title, fixit = RULES[code]
    return f"### {code} — {title}\n\nfix: {fixit}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="hvdlint: static collective-consistency, lock-order "
                    "and guarded-by race analyzer for horovod_tpu_torch")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to analyze (default: "
                             "the horovod_tpu_torch package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--sarif", metavar="OUT.json",
                        help="also write the findings as a SARIF 2.1.0 "
                             "log to this file (what CI code-scanning "
                             "ingests to annotate diffs); '-' writes to "
                             "stdout instead of the text report")
    parser.add_argument("--select", metavar="CODES",
                        help="comma-separated rule codes to report; "
                             "ranges allowed (HVD110-HVD115)")
    parser.add_argument("--engine",
                        choices=("user", "locks", "guards", "divergence",
                                 "lifecycle", "contracts", "all"),
                        default="all",
                        help="user-script rules, the lock-order "
                             "self-check, the guarded-by race detector, "
                             "the SPMD divergence dataflow engine, the "
                             "concurrency-lifecycle engine, the "
                             "cross-artifact contract checker, or all "
                             "six (default)")
    parser.add_argument("--include-skipped", action="store_true",
                        help="analyze files marked '# hvdlint: skip-file' "
                             "(for linting the lint fixtures themselves)")
    parser.add_argument("--baseline", metavar="FILE",
                        default=baseline_mod.DEFAULT,
                        help="subtract findings recorded in this baseline "
                             "file; only NEW findings are reported "
                             "(default: the port's own, "
                             "horovod_tpu_torch/analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, baselined or not")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the --baseline file from the "
                             "current findings and exit 0")
    parser.add_argument("--changed", action="store_true",
                        help="lint only files changed against --base "
                             "(git diff --name-only); positional paths "
                             "then act as filters")
    parser.add_argument("--base", metavar="REF", default="HEAD",
                        help="base ref for --changed (default: HEAD)")
    parser.add_argument("--explain", metavar="CODE",
                        help="print the docs/analysis.md entry for a rule "
                             "and exit")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--contracts-json", action="store_true",
                        help="print the extracted registries (env knobs, "
                             "metric families, RPC methods, chaos sites) "
                             "as stable JSON and exit — the machine-"
                             "readable inventory downstream controllers "
                             "consume")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0
    if args.explain:
        text = explain_rule(args.explain)
        print(text)
        return 0 if not text.startswith("unknown rule code") else 2
    if args.contracts_json:
        # registries only — no per-module findings pass needed; paths
        # (or the cwd) locate the repo root the scan anchors at
        repo = contracts_mod.build_repo(
            [], parse=_parse_cached) if not args.paths else \
            contracts_mod.build_repo(
                [(p, _read_or_empty(p), None)
                 for p in collect_files(args.paths)],
                include_skipped=args.include_skipped, parse=_parse_cached)
        print(json.dumps(contracts_mod.registries(repo), indent=2,
                         sort_keys=True))
        return 0
    if args.no_baseline:
        if args.update_baseline:
            parser.error("--update-baseline needs a baseline file")
        args.baseline = None
    if args.update_baseline and (args.changed or args.select
                                 or args.engine != "all"):
        # rewriting the ratchet from a filtered subset would silently
        # drop every entry the filter excluded
        parser.error("--update-baseline must record a full run; drop "
                     "--changed/--select/--engine")
    if not args.paths and not args.changed:
        args.paths = [os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))]

    engines = ENGINES if args.engine == "all" else (args.engine,)
    select = None
    if args.select:
        select, unknown = expand_select(args.select)
        if unknown:
            # a typo'd code would otherwise filter out every finding and
            # exit 0 — fatal in a CI gate
            parser.error(f"unknown rule code(s): {', '.join(unknown)} "
                         f"(see --list-rules)")
    if args.changed:
        try:
            files = changed_files(args.base, args.paths)
        except RuntimeError as exc:
            parser.error(str(exc))
    else:
        files = collect_files(args.paths)
    findings = analyze_files(files, engines=engines,
                             include_skipped=args.include_skipped,
                             select=select)

    if args.update_baseline:
        n = baseline_mod.save(args.baseline, findings)
        print(f"hvdlint: baseline {args.baseline} updated "
              f"({n} entr{'y' if n == 1 else 'ies'}, "
              f"{len(findings)} finding(s))")
        return 0

    baselined = 0
    if args.baseline:
        try:
            allowed = baseline_mod.load(args.baseline)
        except OSError as exc:
            parser.error(f"could not read baseline {args.baseline}: {exc}")
        except (ValueError, KeyError) as exc:
            parser.error(f"malformed baseline {args.baseline}: {exc}")
        findings, baselined = baseline_mod.apply(findings, allowed)

    if args.sarif:
        sarif = to_sarif(findings)
        if args.sarif == "-":
            print(json.dumps(sarif, indent=2, sort_keys=True))
            return 1 if findings else 0
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(sarif, f, indent=2, sort_keys=True)
            f.write("\n")

    if args.format == "json":
        print(json.dumps({"findings": [f.as_dict() for f in findings],
                          "count": len(findings),
                          "baselined": baselined}, indent=2))
    else:
        for f in findings:
            print(f.format_text())
        n_files = len(files)
        note = (f" ({baselined} baselined finding(s) not shown)"
                if baselined else "")
        if findings:
            new = "NEW " if args.baseline else ""
            print(f"\nhvdlint: {len(findings)} {new}finding(s) in "
                  f"{n_files} file(s){note} — see docs/analysis.md for "
                  f"the rule catalog; suppress a false positive with "
                  f"'# hvdlint: disable=<code>'")
        else:
            print(f"hvdlint: {n_files} file(s) clean{note}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
