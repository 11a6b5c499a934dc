"""Findings baseline: a ratchet so CI fails only on *new* findings.

Counterpart: ``horovod_tpu/analysis/baseline.py``.  The port's own
baseline, ``horovod_tpu_torch/analysis/baseline.json`` (:data:`DEFAULT`),
records the accepted findings of the port's tree (near-empty by policy —
every real race gets fixed or suppressed inline with a justification),
each entry with a ``reason`` that says why it is accepted.  ``--baseline FILE`` subtracts baselined findings
from a run; ``--baseline FILE --update-baseline`` rewrites the file from
the current findings (the explicit ratchet step, reviewed in the diff).

Entries match on a **fingerprint** — ``v<analyzer> | code | path |
message with digit runs collapsed`` — so line-number drift from
unrelated edits does not invalidate the baseline, while a genuinely new
finding (different attribute, class, or rule) never matches.  Each
fingerprint carries a count: the baseline tolerates at most that many
occurrences.

Fingerprints and the file itself are keyed on
:data:`report.ANALYZER_VERSION`: a baseline recorded by an older rule
engine is **refused** (loud ``--update-baseline`` prompt), never
silently matched — an engine upgrade that reclassifies or renumbers
findings must re-ratchet explicitly, in a reviewed diff.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from .report import ANALYZER_VERSION, Finding

_DIGITS = re.compile(r"\d+")

#: The directory holding the port's package (a checkout with or without
#: its ``.git``): baselined paths are relative to it.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The port's own baseline file.
DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "baseline.json")


def _canonical_path(path: str) -> str:
    """One spelling per file: relative to the directory holding the
    port's package, with forward slashes, for files under it; absolute
    otherwise — so the same finding fingerprints identically whether
    hvdlint was invoked with absolute paths, from a subdirectory, or
    from a checkout without ``.git``."""
    p = os.path.abspath(path)
    root = _REPO_ROOT
    if p == root or p.startswith(root + os.sep):
        p = os.path.relpath(p, root)
    return p.replace("\\", "/")


def fingerprint(finding: Finding) -> str:
    path = _canonical_path(finding.path)
    return (f"v{ANALYZER_VERSION}|{finding.code}|{path}|"
            f"{_DIGITS.sub('#', finding.message)}")


def load(path: str) -> Dict[str, int]:
    """fingerprint -> tolerated occurrence count.

    Raises ``ValueError`` when the baseline was recorded by a different
    analyzer generation: its entries describe what an *older* rule
    engine found, and matching them against this engine's output could
    silently swallow real new findings (or report baselined ones)."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    recorded = int(data.get("analyzer_version", 0))
    if recorded != ANALYZER_VERSION:
        raise ValueError(
            f"baseline recorded by analyzer version {recorded}, this is "
            f"version {ANALYZER_VERSION} — re-ratchet with "
            f"--baseline {path} --update-baseline and review the diff")
    out: Dict[str, int] = {}
    for entry in data.get("findings", []):
        fp = entry["fingerprint"]
        out[fp] = out.get(fp, 0) + int(entry.get("count", 1))
    return out


def reasons(path: str) -> Dict[str, str]:
    """fingerprint -> the ``reason`` recorded beside it ('' if none)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return {e["fingerprint"]: str(e.get("reason", ""))
            for e in data.get("findings", [])}


def save(path: str, findings: Iterable[Finding]) -> int:
    """Write the baseline for ``findings``; returns the entry count.  An
    entry keeps the ``reason`` the file already gave its fingerprint; a
    new one gets an empty reason, which the port's tests refuse until
    someone writes why the finding is accepted."""
    why = reasons(path)
    counts = Counter()
    meta: Dict[str, Tuple[str, str]] = {}
    for f in findings:
        fp = fingerprint(f)
        counts[fp] += 1
        meta.setdefault(fp, (f.code, _canonical_path(f.path)))
    entries = [{"code": meta[fp][0], "path": meta[fp][1],
                "count": n, "fingerprint": fp,
                "reason": why.get(fp, "")}
               for fp, n in sorted(counts.items())]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "analyzer_version": ANALYZER_VERSION,
                   "findings": entries}, f, indent=2, sort_keys=False)
        f.write("\n")
    return len(entries)


def apply(findings: List[Finding], allowed: Dict[str, int]
          ) -> Tuple[List[Finding], int]:
    """(new findings, count suppressed by the baseline)."""
    remaining = dict(allowed)
    new: List[Finding] = []
    suppressed = 0
    for f in findings:
        fp = fingerprint(f)
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
            suppressed += 1
        else:
            new.append(f)
    return new, suppressed
