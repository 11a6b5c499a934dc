"""Engine 5: cross-artifact contract checker (HVD300–HVD307).

Counterpart: ``horovod_tpu/analysis/contracts.py``, re-pointed at the
port: the scan set is the port's package (``horovod_tpu_torch/``) and
its tests (``tests/test_torch_*.py``, ``tests/torch_*.py``), anchored at
the directory holding the package.  The port has no ``docs/`` tables, so
every contract whose artifact is missing is skipped by name
(:data:`SKIPPED`); the token-schema contract holds ``EntrySig`` against
the port's own native core (``horovod_tpu_torch/native/core.cpp``).

The other four engines reason about ONE module at a time.  This one
reasons about the REPO: it AST-extracts the registries the operator
surfaces are built from — the ``HOROVOD_*`` env knobs, the metric
families, the JSON-RPC method tables, the chaos injection sites, and
the controller's negotiation-token field schema — and diffs them
against each other and against the docs tables (``docs/env.md``,
``docs/metrics.md``) plus the native extension (``native/core.cpp``).
Every divergence the runtime would only surface as a stale doc, a
silently-dropped metric label, a 404'd RPC, an inert chaos seed, or a
job-merge ``ValueError`` becomes a static finding instead:

====== ==========================================================
HVD300 env var read in code with no config.py row / env.md entry
HVD301 config.py row <-> docs/env.md table drift (both directions)
HVD302 metric family <-> docs/metrics.md drift (both directions)
HVD303 one histogram family declared with two different lo/hi edges
HVD304 RPC method with no handler / handler no client ever calls
HVD305 chaos site drift: fired vs documented vs seeded in tests/CI
HVD306 negotiation-token / EntrySig field-schema drift vs consumers
HVD307 metric call-site labels outside the family's declared labels
====== ==========================================================

Extraction is always repo-wide and anchored at the repo root (found by
walking up from the analyzed files to the directory holding
``docs/env.md``), independent of which paths were passed on the
command line — a ``json_request`` client in one file resolves against
a handler table in another, whether or not both were passed.  Facts
from ``tests/`` join the RESOLUTION sets (a handler a test exercises
is not an orphan) but, with the single exception of HVD305 inert-seed
findings, never anchor findings of their own: tests legitimately read
ad-hoc env vars and register throwaway local handler tables.

Files marked ``# hvdlint: skip-file`` are excluded from extraction —
the antipatterns fixture must not dirty (or silently satisfy!) the
real tree's registries — unless they are explicitly passed as inputs
under ``--include-skipped``, which is how the fixture convicts itself.

The extracted registries are also emitted as stable JSON
(``python -m horovod_tpu_torch.analysis --contracts-json``) for
downstream consumers: the knob and metric inventory, read from here
instead of re-scraped.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .report import ANALYZER_VERSION, Finding, apply_suppressions, \
    file_skipped, iter_suppressions

_ENV_RE = re.compile(r"^(?:HOROVOD|HVD)_[A-Z0-9_]+$")
_BACKTICK_RE = re.compile(r"`([^`]+)`")
#: A chaos site name: two+ dot-separated lower_snake segments, none
#: starting with an underscore (filters Python dotted names such as
#: ``os._exit`` out of the docs prose).
_SITE_RE = re.compile(r"^[a-z][a-z0-9_]*(?:\.[a-z][a-z0-9_]*)+$")
#: Fallback action vocabulary when the tree under analysis does not
#: ship chaos/schedule.py (unit-test mini-repos).
_DEFAULT_ACTIONS = frozenset((
    "delay", "drop", "reset", "http500", "error", "crash",
    "dup", "stale", "flap", "drop-reply", "nan", "scale",
))
#: Metric mutator kwargs that are values, not labels.
_VALUE_KWARGS = {"amount", "value"}
#: Histogram bucket-edge defaults (metrics.registry.Registry.histogram).
_HIST_LO, _HIST_HI = -17, 6

#: The port's package, whose parent directory anchors the scan.
PACKAGE = "horovod_tpu_torch"

#: Contracts skipped because the port lacks the artifact they hold the
#: code against (a contract runs again once its artifact exists).
SKIPPED = {
    "HVD300": "env reads against docs/env.md: the port has no docs tree",
    "HVD301": "config.py rows against docs/env.md: no docs tree",
    "HVD302": "metric families against docs/metrics.md: no docs tree",
    "HVD305-docs": "fired chaos sites against docs/env.md's site list: "
                   "no docs tree (inert seeds are still checked)",
}


# --------------------------------------------------------------------------
# markdown table parsing
# --------------------------------------------------------------------------

def parse_md_tables(text: str) -> List[List[Tuple[int, List[str]]]]:
    """Parse every pipe table in a markdown document.

    Returns a list of tables; each table is a list of
    ``(lineno, cells)`` rows (1-based line numbers, header row
    included, ``|---|`` separator rows dropped).  Tolerances the repo's
    docs actually exercise:

    * escaped pipes (``hit\\|miss\\|stale``) stay inside their cell;
    * leading/trailing ``|`` optional;
    * a non-table continuation line directly under a row (a hand-
      wrapped cell) is folded into that row's last cell;
    * any number of tables per file, prose in between.
    """
    tables: List[List[Tuple[int, List[str]]]] = []
    current: Optional[List[Tuple[int, List[str]]]] = None
    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if stripped.startswith("|"):
            cells = _split_row(stripped)
            if all(re.fullmatch(r":?-+:?", c) for c in cells if c):
                continue                      # |---|---| separator
            if current is None:
                current = []
                tables.append(current)
            current.append((lineno, cells))
        elif current is not None and stripped and not stripped.startswith(
                ("#", "```")):
            # wrapped cell: fold the continuation into the last cell
            row = current[-1]
            row[1][-1] = (row[1][-1] + " " + stripped).strip()
        else:
            current = None
    return [t for t in tables if t]


def _split_row(line: str) -> List[str]:
    """Split one ``| a | b |`` row into stripped cells, honoring
    ``\\|`` escapes."""
    cells: List[str] = []
    buf: List[str] = []
    escaped = False
    for ch in line:
        if escaped:
            buf.append(ch)
            escaped = False
        elif ch == "\\":
            escaped = True
        elif ch == "|":
            cells.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    cells.append("".join(buf).strip())
    if cells and cells[0] == "":
        cells = cells[1:]
    if cells and cells[-1] == "":
        cells = cells[:-1]
    return cells


def _first_backticked(cell: str) -> Optional[str]:
    m = _BACKTICK_RE.search(cell)
    return m.group(1) if m else None


# --------------------------------------------------------------------------
# chaos seed parsing (lightweight re-parse of the rule grammar)
# --------------------------------------------------------------------------

def parse_seed_rules(text: str) -> List[Tuple[str, str]]:
    """``(site, action_kind)`` per rule line in a chaos seed string.

    Mirrors ``chaos.schedule.FaultRule.parse`` just enough to name the
    site and the action kind: rules split on newlines/";", comments
    and blanks skipped, site = first token (":<method>" stripped),
    action = the last ``action=`` token's kind (its ":<arg>" may
    contain anything).  Only dotted sites are returned — the grammar
    unit tests deliberately use sites like ``"a"`` that exist nowhere.
    """
    out: List[Tuple[str, str]] = []
    for raw in re.split(r"[;\n]", text):
        rule = raw.strip()
        if not rule or rule.startswith("#") or " action=" not in rule:
            continue
        site = rule.split()[0].split(":")[0]
        if not _SITE_RE.match(site):
            continue
        idx = rule.rfind(" action=")
        kind = rule[idx + len(" action="):].split(":")[0].split(",")[0]
        kind = kind.split()[0] if kind.split() else kind
        out.append((site, kind))
    return out


# --------------------------------------------------------------------------
# per-module fact extraction
# --------------------------------------------------------------------------

class ModuleFacts:
    """Everything one module contributes to the repo registries."""

    def __init__(self, path: str) -> None:
        self.path = path
        # (env name, line, strict) — strict=True for actual read sites
        # (environ.get / getenv / _env_* helper / environ["X"] loads);
        # strict=False for any other env-shaped string literal (the
        # loose "referenced somewhere" set that keeps doc rows alive).
        self.env_refs: List[Tuple[str, int, bool]] = []
        # (family, kind, labels|None, lo, hi, var|None, line)
        self.metric_decls: List[Tuple[str, str, Optional[Tuple[str, ...]],
                                      int, int, Optional[str], int]] = []
        # (var, mutator, label kwargs, line)
        self.metric_uses: List[Tuple[str, str, Tuple[str, ...], int]] = []
        self.rpc_calls: List[Tuple[str, int]] = []
        self.rpc_handlers: List[Tuple[str, int]] = []
        self.chaos_fires: List[Tuple[str, int]] = []
        self.chaos_seeds: List[Tuple[str, str, int]] = []
        # entry_token producer arity (sig-row list length), if defined
        self.token_producer: Optional[Tuple[int, int]] = None  # (arity, line)
        # token_fields consumers: (func name, max subscript index, line)
        self.token_consumers: List[Tuple[str, int, int]] = []
        self.entry_sig_fields: List[Tuple[str, int]] = []
        self.known_actions: Optional[Set[str]] = None
        self.config_envs: List[Tuple[str, int]] = []


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_name(func: ast.AST) -> str:
    """Terminal name of a call target (``a.b.c(...)`` -> ``c``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _is_environ_ish(node: ast.AST) -> bool:
    """``os.environ`` / ``environ`` / ``env`` / ``base_env`` — the
    receivers env reads go through in this repo."""
    name = None
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    return name in ("environ", "env", "base_env", "os")


def _resolve_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _resolve_int(node.operand)
        return -inner if inner is not None else None
    return None


def _str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = [_const_str(e) for e in node.elts]
        if all(v is not None for v in vals):
            return tuple(vals)  # type: ignore[arg-type]
    return None


class _Extractor(ast.NodeVisitor):
    def __init__(self, facts: ModuleFacts, is_config: bool) -> None:
        self.f = facts
        self.is_config = is_config
        self._func_stack: List[str] = []
        # inside a ``from_env`` body, ``_env_*`` helper calls are the
        # validated-config layer even outside config.py itself
        self._from_env_depth = 0

    # -- helpers ----------------------------------------------------------

    def _note_env(self, name: Optional[str], line: int,
                  strict: bool) -> None:
        if name and _ENV_RE.match(name):
            self.f.env_refs.append((name, line, strict))

    def _handler_keys(self, node: ast.AST, line: int) -> None:
        if isinstance(node, ast.Dict):
            for k in node.keys:
                key = _const_str(k) if k is not None else None
                if key:
                    self.f.rpc_handlers.append((key, line))

    # -- generic fact sweeps ----------------------------------------------

    def visit_Constant(self, node: ast.Constant) -> None:
        if isinstance(node.value, str):
            v = node.value
            if _ENV_RE.match(v):
                self.f.env_refs.append((v, node.lineno, False))
            if " action=" in v or v.lstrip().startswith("action="):
                for site, kind in parse_seed_rules(v):
                    self.f.chaos_seeds.append((site, kind, node.lineno))

    def visit_JoinedStr(self, node: ast.JoinedStr) -> None:
        # f-string chaos seeds ("... action=delay:{d}"): parse the
        # constant skeleton with the holes blanked out
        parts = [p.value if isinstance(p, ast.Constant)
                 and isinstance(p.value, str) else "0"
                 for p in node.values]
        text = "".join(parts)
        if " action=" in text:
            for site, kind in parse_seed_rules(text):
                self.f.chaos_seeds.append((site, kind, node.lineno))
        self.generic_visit(node)

    # -- assignments ------------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        var = None
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            var = node.targets[0].id
        if isinstance(node.value, ast.Call):
            self._maybe_metric_decl(node.value, var)
        if var == "KNOWN_ACTIONS":
            vals = None
            v = node.value
            if isinstance(v, ast.Call) and _call_name(v.func) == "frozenset" \
                    and v.args:
                vals = _str_tuple(v.args[0])
            else:
                vals = _str_tuple(v)
            if vals:
                self.f.known_actions = set(vals)
        self.generic_visit(node)

    # -- calls ------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        # env reads: os.environ.get / environ.get / os.getenv
        if name in ("get", "getenv", "pop", "setdefault") \
                and isinstance(node.func, ast.Attribute) \
                and _is_environ_ish(node.func.value) and node.args:
            self._note_env(_const_str(node.args[0]), node.lineno, True)
        # env reads through validated helpers (_env_int & friends)
        elif name.startswith("_env") and node.args:
            env = _const_str(node.args[0])
            self._note_env(env, node.lineno, True)
            if env and _ENV_RE.match(env) \
                    and (self.is_config or self._from_env_depth):
                self.f.config_envs.append((env, node.lineno))
        # metric family declaration outside an assignment (assignment
        # forms were already captured, with the target var, from
        # visit_Assign — the _hvd_decl_done marker prevents doubles)
        if name in ("counter", "gauge", "histogram") \
                and not getattr(node, "_hvd_decl_done", False):
            self._maybe_metric_decl(node, None)
        # metric mutators
        if name in ("inc", "set", "observe") \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name):
            labels = tuple(sorted(
                kw.arg for kw in node.keywords
                if kw.arg and kw.arg not in _VALUE_KWARGS))
            self.f.metric_uses.append(
                (node.func.value.id, name, labels, node.lineno))
        # RPC clients
        if name in ("json_request", "request") and len(node.args) >= 3:
            m = _const_str(node.args[2])
            if m:
                self.f.rpc_calls.append((m, node.lineno))
        elif name == "_call" and isinstance(node.func, ast.Attribute) \
                and node.args:
            m = _const_str(node.args[0])
            if m:
                self.f.rpc_calls.append((m, node.lineno))
        # RPC handler tables
        if name == "JsonRpcServer" and node.args:
            self._handler_keys(node.args[0], node.lineno)
        elif name == "add_handlers" and node.args:
            self._handler_keys(node.args[0], node.lineno)
        # chaos fire sites
        if name == "fire" and isinstance(node.func, ast.Attribute) \
                and node.args:
            site = _const_str(node.args[0])
            if site:
                self.f.chaos_fires.append((site, node.lineno))
        self.generic_visit(node)

    def _maybe_metric_decl(self, call: ast.Call, var: Optional[str]) -> None:
        kind = _call_name(call.func)
        if kind not in ("counter", "gauge", "histogram"):
            return
        if not call.args:
            return
        fam = _const_str(call.args[0])
        if not fam:
            return
        call._hvd_decl_done = True  # type: ignore[attr-defined]
        labels: Optional[Tuple[str, ...]] = ()
        lo, hi = _HIST_LO, _HIST_HI
        # positional: (name, help, labels, lo, hi)
        if len(call.args) >= 3:
            labels = _str_tuple(call.args[2])
        if len(call.args) >= 4:
            lo = _resolve_int(call.args[3]) if _resolve_int(
                call.args[3]) is not None else lo
        if len(call.args) >= 5:
            hi = _resolve_int(call.args[4]) if _resolve_int(
                call.args[4]) is not None else hi
        for kw in call.keywords:
            if kw.arg == "labels":
                labels = _str_tuple(kw.value)
            elif kw.arg == "lo":
                v = _resolve_int(kw.value)
                lo = v if v is not None else lo
            elif kw.arg == "hi":
                v = _resolve_int(kw.value)
                hi = v if v is not None else hi
        self.f.metric_decls.append(
            (fam, kind, labels, lo, hi, var, call.lineno))

    # -- subscripts (environ["X"] loads and stores) -----------------------

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if _is_environ_ish(node.value):
            env = _const_str(node.slice)
            strict = isinstance(node.ctx, ast.Load)
            self._note_env(env, node.lineno, strict)
        self.generic_visit(node)

    # -- defs: handler factories, token producers/consumers, EntrySig -----

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._function(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._function(node)

    def _function(self, node) -> None:
        if node.name.endswith("handlers"):
            # only THIS function's returns — the nested per-method
            # handler defs return payload dicts, not handler tables
            for sub in _walk_own(node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    self._handler_keys(sub.value, sub.lineno)
        if node.name == "entry_token":
            arity = 0
            for sub in ast.walk(node):
                if isinstance(sub, ast.List) and len(sub.elts) >= 4:
                    arity = max(arity, len(sub.elts))
            if arity:
                self.f.token_producer = (arity, node.lineno)
        calls_token_fields = any(
            isinstance(sub, ast.Call)
            and _call_name(sub.func) == "token_fields"
            for sub in ast.walk(node))
        if calls_token_fields:
            max_idx = -1
            at_line = node.lineno
            for sub in ast.walk(node):
                if isinstance(sub, ast.Subscript):
                    idx = _resolve_int(sub.slice)
                    if idx is not None and idx > max_idx:
                        max_idx, at_line = idx, sub.lineno
            if max_idx >= 0:
                self.f.token_consumers.append((node.name, max_idx, at_line))
        if node.name == "from_env":
            self._from_env_depth += 1
            try:
                self.generic_visit(node)
            finally:
                self._from_env_depth -= 1
        else:
            self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if node.name == "EntrySig":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    self.f.entry_sig_fields.append(
                        (stmt.target.id, stmt.lineno))
        self.generic_visit(node)


def _walk_own(func) -> Iterable[ast.AST]:
    """Walk a function's body WITHOUT descending into nested function
    or class definitions."""
    stack: List[ast.AST] = list(func.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def extract_module_facts(tree: ast.Module, path: str) -> ModuleFacts:
    facts = ModuleFacts(path)
    is_config = os.path.basename(path) == "config.py"
    _Extractor(facts, is_config).visit(tree)
    return facts


# --------------------------------------------------------------------------
# repo root + artifact discovery
# --------------------------------------------------------------------------

def find_repo_root(paths: Sequence[str]) -> Optional[str]:
    """Nearest ancestor of the first analyzed path that holds the port's
    package (``horovod_tpu_torch/__init__.py``); falls back to the
    directory holding this package when none of the inputs live inside
    one."""
    candidates = list(paths) or [os.getcwd()]
    for p in candidates:
        d = os.path.abspath(p)
        if os.path.isfile(d):
            d = os.path.dirname(d)
        for _ in range(40):
            if os.path.isfile(os.path.join(d, PACKAGE, "__init__.py")):
                return d
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    own = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.isfile(os.path.join(own, PACKAGE, "__init__.py")):
        return own
    return None


_SKIP_DIRS = {"__pycache__", ".git", "build", "dist", "node_modules",
              ".pytest_cache", ".hypothesis", "related"}


def _scan_files(root: str) -> List[str]:
    """The port's scan set under ``root``: its package and its tests."""
    out: List[str] = []
    for base, dirs, files in os.walk(os.path.join(root, PACKAGE)):
        dirs[:] = sorted(d for d in dirs
                         if d not in _SKIP_DIRS and not d.startswith("."))
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.join(base, f))
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        out += [os.path.join(tests, f) for f in sorted(os.listdir(tests))
                if f.endswith(".py")
                and f.startswith(("test_torch_", "torch_"))]
    return out


def _read(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


# --------------------------------------------------------------------------
# the repo-wide registry view
# --------------------------------------------------------------------------

class RepoContracts:
    """Merged registries + doc/native artifacts for one repo root."""

    def __init__(self, root: Optional[str]) -> None:
        self.root = root
        self.modules: Dict[str, ModuleFacts] = {}
        self.sources: Dict[str, str] = {}
        self.is_test: Dict[str, bool] = {}
        self.is_example: Dict[str, bool] = {}
        # docs/env.md (none in the port: SKIPPED)
        self.env_doc_rows: List[Tuple[str, int]] = []   # table rows
        self.env_doc_any: Set[str] = set()              # any backtick
        self.chaos_doc_sites: List[Tuple[str, int]] = []
        self.env_doc_path: Optional[str] = None
        # docs/metrics.md
        self.metric_doc_rows: List[Tuple[str, int]] = []
        self.metric_doc_path: Optional[str] = None
        # native/core.cpp parse_sig attrs
        self.cpp_sig_attrs: List[Tuple[str, int]] = []
        self.cpp_path: Optional[str] = None

    # -- module ingestion -------------------------------------------------

    def add_module(self, path: str, source: str, tree: ast.Module) -> None:
        apath = os.path.abspath(path)
        rel = (os.path.relpath(apath, self.root)
               if self.root else os.path.basename(apath))
        self.modules[apath] = extract_module_facts(tree, path)
        self.sources[apath] = source
        self.is_test[apath] = rel.split(os.sep)[0] in ("tests", "test")
        self.is_example[apath] = "examples" in rel.split(os.sep)

    # -- artifact ingestion -----------------------------------------------

    def load_artifacts(self) -> None:
        """The port's own artifacts: its native core under the package
        (the docs tables are JAX's and stay unread: :data:`SKIPPED`)."""
        if not self.root:
            return
        cand = os.path.join(self.root, PACKAGE, "native", "core.cpp")
        text = _read(cand)
        if text is not None:
            self.cpp_path = cand
            self._parse_cpp(text)

    def _parse_env_doc(self, text: str) -> None:
        for table in parse_md_tables(text):
            for lineno, cells in table:
                if not cells:
                    continue
                name = _first_backticked(cells[0])
                if name and _ENV_RE.match(name):
                    self.env_doc_rows.append((name, lineno))
        in_chaos = False
        seen_sites: Set[str] = set()
        for lineno, line in enumerate(text.splitlines(), start=1):
            if line.startswith("## "):
                in_chaos = "chaos" in line.lower()
            for tok in _BACKTICK_RE.findall(line):
                tok = tok.strip()
                # prose documents boolean knobs as `HOROVOD_X=0` — the
                # value tail is not part of the name
                env_tok = tok.split("=", 1)[0]
                if _ENV_RE.match(env_tok):
                    self.env_doc_any.add(env_tok)
                # chaos site grammar: dotted lower_snake tokens in the
                # chaos section only; file names (`bench.py`) and
                # module paths (`horovod_tpu.chaos`) do not qualify
                if in_chaos and " " not in tok and _SITE_RE.match(tok) \
                        and tok.rsplit(".", 1)[1] not in (
                            "py", "cc", "cpp", "md", "sh", "json", "h") \
                        and not tok.startswith(("horovod_tpu.",
                                                f"{PACKAGE}.")) \
                        and tok not in seen_sites:
                    seen_sites.add(tok)
                    self.chaos_doc_sites.append((tok, lineno))

    def _parse_metric_doc(self, text: str) -> None:
        for table in parse_md_tables(text):
            for lineno, cells in table:
                if not cells:
                    continue
                name = _first_backticked(cells[0])
                if name and re.match(r"^hvd_[a-z0-9_]+$", name):
                    self.metric_doc_rows.append((name, lineno))

    def _parse_cpp(self, text: str) -> None:
        # restrict to the parse_sig function body: from its definition
        # to the next line starting with "}" at column 0
        lines = text.splitlines()
        start = None
        for i, line in enumerate(lines):
            if "parse_sig" in line and "(" in line and ";" not in line:
                start = i
                break
        if start is None:
            return
        attr_re = re.compile(
            r'(?:get_(?:str|ll|bool|opt_double)_attr|'
            r'PyObject_GetAttrString)\s*\(\s*\w+\s*,\s*"(\w+)"')
        depth = 0
        opened = False
        for i in range(start, len(lines)):
            for m in attr_re.finditer(lines[i]):
                self.cpp_sig_attrs.append((m.group(1), i + 1))
            depth += lines[i].count("{") - lines[i].count("}")
            if "{" in lines[i]:
                opened = True
            if opened and depth <= 0:
                break

    # -- merged registry accessors ----------------------------------------

    def _iter_mods(self, tests: Optional[bool] = None
                   ) -> Iterable[Tuple[str, ModuleFacts]]:
        for path, facts in sorted(self.modules.items()):
            if tests is not None and self.is_test[path] != tests:
                continue
            yield path, facts

    def config_envs(self) -> Dict[str, Tuple[str, int]]:
        out: Dict[str, Tuple[str, int]] = {}
        for path, facts in self._iter_mods():
            for name, line in facts.config_envs:
                out.setdefault(name, (path, line))
        return out

    def env_reads(self, strict: bool) -> Dict[str, List[Tuple[str, int]]]:
        out: Dict[str, List[Tuple[str, int]]] = {}
        for path, facts in self._iter_mods():
            for name, line, s in facts.env_refs:
                if strict and not s:
                    continue
                out.setdefault(name, []).append((path, line))
        return out

    def metric_decls(self) -> List[Tuple[str, str, Optional[Tuple[str, ...]],
                                         int, int, Optional[str],
                                         str, int]]:
        out = []
        for path, facts in self._iter_mods():
            base = os.path.basename(path)
            parent = os.path.basename(os.path.dirname(path))
            # the registry/factory layer declares nothing itself
            if parent == "metrics" and base in ("registry.py",
                                                "__init__.py"):
                continue
            for fam, kind, labels, lo, hi, var, line in facts.metric_decls:
                out.append((fam, kind, labels, lo, hi, var, path, line))
        return out

    def rpc_methods(self) -> Tuple[Dict[str, List[Tuple[str, int]]],
                                   Dict[str, List[Tuple[str, int]]]]:
        calls: Dict[str, List[Tuple[str, int]]] = {}
        handlers: Dict[str, List[Tuple[str, int]]] = {}
        for path, facts in self._iter_mods():
            for m, line in facts.rpc_calls:
                calls.setdefault(m, []).append((path, line))
            for m, line in facts.rpc_handlers:
                handlers.setdefault(m, []).append((path, line))
        return calls, handlers

    def chaos(self) -> Tuple[Dict[str, List[Tuple[str, int]]],
                             Dict[str, List[Tuple[str, int]]],
                             List[Tuple[str, str, str, int]], Set[str]]:
        """``(all_fires, pkg_fires, seeds, actions)``: tests fire ad-hoc
        sites to unit-test the schedule machinery, so only PACKAGE fire
        sites define the documented-site contract — but a seed aimed at
        a test-fired site is still live (not inert)."""
        fires: Dict[str, List[Tuple[str, int]]] = {}
        pkg_fires: Dict[str, List[Tuple[str, int]]] = {}
        seeds: List[Tuple[str, str, str, int]] = []
        actions: Optional[Set[str]] = None
        for path, facts in self._iter_mods():
            for site, line in facts.chaos_fires:
                fires.setdefault(site, []).append((path, line))
                if not self.is_test[path]:
                    pkg_fires.setdefault(site, []).append((path, line))
            for site, kind, line in facts.chaos_seeds:
                seeds.append((site, kind, path, line))
            if facts.known_actions is not None:
                actions = facts.known_actions
        return fires, pkg_fires, seeds, (actions or set(_DEFAULT_ACTIONS))


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

def _rel(repo: RepoContracts, path: str) -> str:
    if repo.root:
        try:
            return os.path.relpath(path, repo.root)
        except ValueError:
            pass
    return path


def _emit_for(repo: RepoContracts, path: str, code: str) -> bool:
    """Should a finding anchored at ``path`` be reported?  Test files
    only anchor HVD305 (inert chaos seeds ARE a test-suite bug; ad-hoc
    env reads and local handler tables are not)."""
    # finding paths are repo-root-relative, NOT cwd-relative
    base = repo.root or os.getcwd()
    if repo.is_test.get(os.path.abspath(os.path.join(base, path)), False):
        return code == "HVD305"
    return True


def check_repo(repo: RepoContracts) -> List[Finding]:
    findings: List[Finding] = []
    findings += _check_env(repo)
    findings += _check_metrics(repo)
    findings += _check_rpc(repo)
    findings += _check_chaos(repo)
    findings += _check_token(repo)
    findings = [f for f in findings if _emit_for(repo, f.path, f.code)]
    # per-file suppression comments apply to contract findings too
    # (finding paths are repo-root-relative, NOT cwd-relative)
    base = repo.root or os.getcwd()
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(
            os.path.abspath(os.path.join(base, f.path)), []).append(f)
    out: List[Finding] = []
    for apath, fs in by_path.items():
        src = repo.sources.get(apath)
        if src is not None:
            fs = apply_suppressions(fs, iter_suppressions(src))
        out.extend(fs)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return out


def _check_env(repo: RepoContracts) -> List[Finding]:
    out: List[Finding] = []
    config = repo.config_envs()
    documented = repo.env_doc_any
    strict_reads = repo.env_reads(strict=True)
    loose_refs = repo.env_reads(strict=False)
    if repo.env_doc_path is not None:
        # HVD300: undocumented, unvalidated env read
        for name in sorted(strict_reads):
            if name in config or name in documented:
                continue
            for path, line in strict_reads[name]:
                out.append(Finding(
                    "HVD300", _rel(repo, path), line, 0,
                    f"env var '{name}' is read here but has no validated "
                    f"config.py row and no docs/env.md entry"))
        # HVD301a: config row undocumented
        for name in sorted(config):
            if name not in documented:
                path, line = config[name]
                out.append(Finding(
                    "HVD301", _rel(repo, path), line, 0,
                    f"config.py validates '{name}' but docs/env.md does "
                    f"not document it"))
        # HVD301b: doc table row nothing reads
        doc_rel = _rel(repo, repo.env_doc_path)
        for name, line in repo.env_doc_rows:
            if name not in loose_refs and name not in config:
                out.append(Finding(
                    "HVD301", doc_rel, line, 0,
                    f"docs/env.md documents '{name}' but no code "
                    f"references it"))
    return out


def _check_metrics(repo: RepoContracts) -> List[Finding]:
    out: List[Finding] = []
    decls = repo.metric_decls()
    declared = {d[0] for d in decls}
    doc_names = {n for n, _ in repo.metric_doc_rows}
    if repo.metric_doc_path is not None:
        # HVD302: created-but-undocumented / documented-but-never-created
        seen: Set[str] = set()
        for fam, kind, _labels, _lo, _hi, _var, path, line in decls:
            if fam in doc_names or fam in seen:
                continue
            seen.add(fam)
            out.append(Finding(
                "HVD302", _rel(repo, path), line, 0,
                f"metric family '{fam}' ({kind}) is created here but "
                f"docs/metrics.md does not list it"))
        doc_rel = _rel(repo, repo.metric_doc_path)
        for fam, line in repo.metric_doc_rows:
            if fam not in declared:
                out.append(Finding(
                    "HVD302", doc_rel, line, 0,
                    f"docs/metrics.md lists metric family '{fam}' but no "
                    f"code creates it"))
    # HVD303: one histogram family, two different edge sets
    edges: Dict[str, Tuple[int, int, str, int]] = {}
    for fam, kind, _labels, lo, hi, _var, path, line in decls:
        if kind != "histogram":
            continue
        prev = edges.get(fam)
        if prev is None:
            edges[fam] = (lo, hi, path, line)
        elif (lo, hi) != prev[:2]:
            out.append(Finding(
                "HVD303", _rel(repo, path), line, 0,
                f"histogram family '{fam}' declared here with edges "
                f"lo={lo}, hi={hi} but with lo={prev[0]}, hi={prev[1]} at "
                f"{_rel(repo, prev[2])}:{prev[3]} — the job-level merge "
                f"raises on mismatched buckets"))
    # HVD307: mutator labels outside the family's declared labels
    for path, facts in repo._iter_mods():
        by_var: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        for fam, _kind, labels, _lo, _hi, var, _line in facts.metric_decls:
            if var is not None and labels is not None:
                by_var[var] = (fam, labels)
        for var, mut, kwargs, line in facts.metric_uses:
            decl = by_var.get(var)
            if decl is None:
                continue
            fam, labels = decl
            extra = [k for k in kwargs if k not in labels]
            for k in extra:
                out.append(Finding(
                    "HVD307", _rel(repo, path), line, 0,
                    f"label '{k}' passed to {var}.{mut}() is not among "
                    f"family '{fam}' declared labels {list(labels)} — the "
                    f"registry silently drops unknown labels"))
    return out


def _check_rpc(repo: RepoContracts) -> List[Finding]:
    out: List[Finding] = []
    calls, handlers = repo.rpc_methods()
    for m in sorted(calls):
        if m in handlers:
            continue
        for path, line in calls[m]:
            out.append(Finding(
                "HVD304", _rel(repo, path), line, 0,
                f"RPC method '{m}' is requested here but registered in no "
                f"JsonRpcServer/add_handlers table anywhere in the repo"))
    for m in sorted(handlers):
        if m in calls:
            continue
        for path, line in handlers[m]:
            out.append(Finding(
                "HVD304", _rel(repo, path), line, 0,
                f"RPC handler '{m}' is registered here but no client ever "
                f"requests it"))
    return out


def _check_chaos(repo: RepoContracts) -> List[Finding]:
    out: List[Finding] = []
    fires, pkg_fires, seeds, actions = repo.chaos()
    documented = {s for s, _ in repo.chaos_doc_sites}
    # HVD305: inert seeds + unknown actions (any file, tests included —
    # an inert seed IS a test-suite bug)
    for site, kind, path, line in seeds:
        if site not in fires:
            out.append(Finding(
                "HVD305", _rel(repo, path), line, 0,
                f"chaos seed targets site '{site}' which no code path "
                f"fires — the rule can never inject (inert seed)"))
        if kind not in actions:
            out.append(Finding(
                "HVD305", _rel(repo, path), line, 0,
                f"chaos seed uses unknown action '{kind}' (known: "
                f"{', '.join(sorted(actions))})"))
    if repo.env_doc_path is not None:
        doc_rel = _rel(repo, repo.env_doc_path)
        for site in sorted(pkg_fires):
            if site not in documented:
                path, line = pkg_fires[site][0]
                out.append(Finding(
                    "HVD305", _rel(repo, path), line, 0,
                    f"chaos site '{site}' is fired here but docs/env.md's "
                    f"chaos site list omits it"))
        for site, line in sorted(repo.chaos_doc_sites):
            if site not in pkg_fires:
                out.append(Finding(
                    "HVD305", doc_rel, line, 0,
                    f"docs/env.md documents chaos site '{site}' but no "
                    f"code fires it"))
    return out


def _check_token(repo: RepoContracts) -> List[Finding]:
    out: List[Finding] = []
    # the framework producer: any non-test, non-example module defining
    # entry_token (the antipatterns fixture ships a deliberately-short
    # producer that must never pair with real consumers)
    framework: Optional[Tuple[int, str, int]] = None
    for path, facts in repo._iter_mods(tests=False):
        if repo.is_example.get(path, False):
            continue
        if facts.token_producer is not None:
            arity, line = facts.token_producer
            framework = (arity, path, line)
            break
    for path, facts in repo._iter_mods():
        producer = facts.token_producer
        if producer is not None:
            prod = (producer[0], path, producer[1])
        else:
            prod = framework
        if prod is None:
            continue
        arity, ppath, _pline = prod
        for func, max_idx, line in facts.token_consumers:
            if max_idx >= arity:
                out.append(Finding(
                    "HVD306", _rel(repo, path), line, 0,
                    f"{func}() reads sig field [{max_idx}] but the "
                    f"entry_token producer in {_rel(repo, ppath)} emits "
                    f"only {arity} fields [0..{arity - 1}]"))
    # EntrySig dataclass <-> native core.cpp parse_sig attr parity
    sig_fields: List[Tuple[str, str, int]] = []
    for path, facts in repo._iter_mods(tests=False):
        for name, line in facts.entry_sig_fields:
            sig_fields.append((name, path, line))
    if sig_fields and repo.cpp_sig_attrs and repo.cpp_path:
        py_names = {n for n, _p, _l in sig_fields}
        cpp_names = {n for n, _l in repo.cpp_sig_attrs}
        cpp_rel = _rel(repo, repo.cpp_path)
        for name, path, line in sig_fields:
            if name not in cpp_names:
                out.append(Finding(
                    "HVD306", _rel(repo, path), line, 0,
                    f"EntrySig field '{name}' is not parsed by "
                    f"{cpp_rel}'s parse_sig — the native planner would "
                    f"ignore a negotiated field"))
        seen: Set[str] = set()
        for name, line in repo.cpp_sig_attrs:
            if name not in py_names and name not in seen:
                seen.add(name)
                out.append(Finding(
                    "HVD306", cpp_rel, line, 0,
                    f"native parse_sig reads attr '{name}' which EntrySig "
                    f"does not define — the extension would fail at "
                    f"runtime"))
    return out


# --------------------------------------------------------------------------
# engine entry points
# --------------------------------------------------------------------------

def build_repo(inputs: Sequence[Tuple[str, str, Optional[ast.Module]]],
               include_skipped: bool = False,
               parse=None) -> RepoContracts:
    """Assemble the repo-wide registry view.

    ``inputs`` are the explicitly-analyzed modules as
    ``(path, source, tree)``; the canonical scan set under the repo
    root is added automatically (honoring ``# hvdlint: skip-file``).
    ``parse`` is the shared content-keyed AST cache hook
    (``cli._parse_cached``); plain ``ast.parse`` when absent.
    """
    if parse is None:
        def parse(path, source):           # pragma: no cover - default
            try:
                return ast.parse(source, filename=path)
            except SyntaxError:
                return None
    root = find_repo_root([p for p, _s, _t in inputs])
    repo = RepoContracts(root)
    seen: Set[str] = set()
    for path, source, tree in inputs:
        apath = os.path.abspath(path)
        if apath in seen:
            continue
        seen.add(apath)
        if not include_skipped and file_skipped(source):
            continue
        if tree is None:
            tree = parse(path, source)
        if tree is not None:
            repo.add_module(path, source, tree)
    if root:
        for path in _scan_files(root):
            apath = os.path.abspath(path)
            if apath in seen:
                continue
            seen.add(apath)
            source = _read(path)
            if source is None or file_skipped(source):
                continue
            tree = parse(path, source)
            if tree is not None:
                repo.add_module(path, source, tree)
    repo.load_artifacts()
    return repo


def check_files(inputs: Sequence[Tuple[str, str, Optional[ast.Module]]],
                include_skipped: bool = False,
                parse=None) -> List[Finding]:
    """The contracts engine: repo-wide extraction + all HVD300s."""
    repo = build_repo(inputs, include_skipped=include_skipped, parse=parse)
    return check_repo(repo)


# --------------------------------------------------------------------------
# stable JSON registry emission (--contracts-json)
# --------------------------------------------------------------------------

def registries(repo: RepoContracts) -> dict:
    """The extracted registries as one schema-stable dict (sorted keys,
    sorted entries) — the machine-readable knob/metric/RPC/chaos
    inventory downstream controllers consume."""
    config = repo.config_envs()
    strict = repo.env_reads(strict=True)
    documented = repo.env_doc_any
    env_names = sorted(set(config) | set(strict)
                       | {n for n, _ in repo.env_doc_rows})
    env = [{"name": n,
            "validated": n in config,
            "documented": n in documented
            or n in {d for d, _ in repo.env_doc_rows},
            "read_sites": len(strict.get(n, []))}
           for n in env_names]
    fams: Dict[str, dict] = {}
    for fam, kind, labels, lo, hi, _var, _path, _line in \
            repo.metric_decls():
        entry = fams.setdefault(fam, {
            "name": fam, "type": kind,
            "labels": sorted(labels or ()),
            "documented": fam in {n for n, _ in repo.metric_doc_rows},
        })
        if kind == "histogram":
            entry["lo"], entry["hi"] = lo, hi
    calls, handlers = repo.rpc_methods()
    rpc = [{"name": m,
            "handlers": len(handlers.get(m, [])),
            "call_sites": len(calls.get(m, []))}
           for m in sorted(set(calls) | set(handlers))]
    fires, pkg_fires, seeds, actions = repo.chaos()
    chaos = {
        "sites": sorted(set(pkg_fires)),
        "documented_sites": sorted({s for s, _ in repo.chaos_doc_sites}),
        "actions": sorted(actions),
        "seeded_sites": sorted({s for s, _k, _p, _l in seeds}),
    }
    return {
        "analyzer_version": ANALYZER_VERSION,
        "root": repo.root,
        "env": env,
        "metrics": [fams[k] for k in sorted(fams)],
        "rpc": rpc,
        "chaos": chaos,
        "skipped": dict(sorted(SKIPPED.items())),
    }
