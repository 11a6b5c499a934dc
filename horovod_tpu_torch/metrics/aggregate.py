"""Driver-side aggregation: scrape every worker, serve one merged view.

The registry's histograms carry fixed log2 bucket edges declared with
the metric (``registry.log2_edges``), so per-worker series are
bucket-identical and merge by summing counts bucket-wise — the property
that makes a job-level p99 exact instead of an average of per-worker
quantiles.  Merge rules:

* **counter**: summed across workers per label set.
* **histogram**: ``_bucket``/``_sum``/``_count`` summed across workers
  per label set; mismatched ``le`` sets raise (a version-skewed worker
  must surface, not silently corrupt the tails).
* **gauge**: per-worker spread — ``{agg="min",worker=k}`` /
  ``{agg="max",worker=k}`` (each naming the owning worker, so a single
  scrape answers "which worker is the straggler") plus ``{agg="sum"}``.

``scrape`` GETs a worker's ``/metrics`` route (``JsonRpcServer`` serves
it unauthenticated — exposition is read-only); unreachable workers are
reported as a comment line in the merged output rather than failing the
whole scrape.

Counterpart: ``horovod_tpu/metrics/aggregate.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .registry import _escape, _fmt

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]'
                       r'|\\.)*)"')


_UNESCAPE_RE = re.compile(r"\\(.)")


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an ASCENDING-sorted sequence — the
    one definition every bench's p50/p99 means (tools/bench_control,
    bench_serve, the serving example all delegate here so 'p99' cannot
    silently diverge between the gates CI pins)."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _unescape(value: str) -> str:
    # single left-to-right scan: sequential str.replace corrupts values
    # where a literal backslash precedes an 'n' or quote (the escaped
    # form '\\n' must collapse to '\'+'n', never to a newline)
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), value)


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Parse text exposition into
    ``{family: {"type": t, "samples": [(name, labels, value), ...]}}``
    where histogram ``_bucket``/``_sum``/``_count`` samples are grouped
    under their family name.  Raises ValueError on malformed sample
    lines — the CI scrape doubles as a format check."""
    families: Dict[str, dict] = {}
    typed: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                typed[parts[2]] = parts[3]
                families.setdefault(
                    parts[2], {"type": parts[3], "samples": []})
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line: {line!r}")
        name = m.group("name")
        labels = {lm.group("k"): _unescape(lm.group("v"))
                  for lm in _LABEL_RE.finditer(m.group("labels") or "")}
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else float(raw)
        fam = name
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and name[:-len(sfx)] in typed:
                fam = name[:-len(sfx)]
                break
        families.setdefault(
            fam, {"type": typed.get(fam, "untyped"), "samples": []})
        families[fam]["samples"].append((name, labels, value))
    return families


def _series_key(labels: Dict[str, str],
                drop: Tuple[str, ...] = ()) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, v) for k, v in labels.items()
                        if k not in drop))


def merge(per_worker: Dict[str, Dict[str, dict]]) -> Dict[str, dict]:
    """Merge ``{worker: parse_prometheus(...)}`` into one family dict
    (same shape as ``parse_prometheus`` output)."""
    merged: Dict[str, dict] = {}
    names = sorted({n for fams in per_worker.values() for n in fams})
    for name in names:
        types = {fams[name]["type"]
                 for fams in per_worker.values() if name in fams}
        if len(types) > 1:
            raise ValueError(
                f"family {name!r} has conflicting types across workers: "
                f"{sorted(types)}")
        kind = types.pop()
        out: List[Tuple[str, Dict[str, str], float]] = []
        if kind == "gauge":
            # per-label-set spread over workers, owner-attributed
            by_series: Dict = {}
            for worker, fams in sorted(per_worker.items()):
                for sname, labels, value in fams.get(
                        name, {"samples": []})["samples"]:
                    by_series.setdefault(
                        _series_key(labels), []).append((worker, value))
            for key, vals in sorted(by_series.items()):
                base = dict(key)
                mn = min(vals, key=lambda wv: wv[1])
                mx = max(vals, key=lambda wv: wv[1])
                out.append((name, dict(base, agg="min",
                                       worker=str(mn[0])), mn[1]))
                out.append((name, dict(base, agg="max",
                                       worker=str(mx[0])), mx[1]))
                out.append((name, dict(base, agg="sum"),
                            sum(v for _, v in vals)))
        else:
            # counters, histogram components, untyped: sum per label set
            sums: Dict = {}
            le_sets: Dict = {}
            for worker, fams in sorted(per_worker.items()):
                for sname, labels, value in fams.get(
                        name, {"samples": []})["samples"]:
                    if kind == "histogram" and sname.endswith("_bucket"):
                        le_sets.setdefault(worker, set()).add(
                            labels.get("le"))
                    key = (sname, _series_key(labels))
                    if key in sums:
                        sums[key] = (sums[key][0], sums[key][1] + value)
                    else:
                        sums[key] = (dict(labels), value)
            if len({frozenset(s) for s in le_sets.values()}) > 1:
                raise ValueError(
                    f"histogram {name!r} has mismatched bucket edges "
                    f"across workers; cannot merge bucket-wise")

            def _order(kv):
                (sname, key), (labels, _) = kv
                le = labels.get("le")
                le_v = (float("inf") if le == "+Inf"
                        else float(le) if le is not None else -1.0)
                rest = tuple(i for i in key if i[0] != "le")
                return (sname, rest, le_v)

            for (sname, _), (labels, value) in sorted(
                    sums.items(), key=_order):
                out.append((sname, labels, value))
        merged[name] = {"type": kind, "samples": out}
    return merged


def render(families: Dict[str, dict],
           comments: Tuple[str, ...] = ()) -> str:
    """Render a (merged) family dict back to text exposition format."""
    lines: List[str] = [f"# {c}" for c in comments]
    for name in sorted(families):
        fam = families[name]
        lines.append(f"# TYPE {name} {fam['type']}")
        for sname, labels, value in fam["samples"]:
            val = "+Inf" if value == float("inf") else _fmt(value)
            if labels:
                body = ",".join(
                    f'{k}="{_escape(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{sname}{{{body}}} {val}")
            else:
                lines.append(f"{sname} {val}")
    return "\n".join(lines) + "\n"


def scrape(addr: str, port: int, route: str = "metrics",
           timeout: float = 2.0) -> str:
    """One worker's exposition route (``jobscrape.http_get``)."""
    from .jobscrape import http_get
    return http_get(addr, port, route, timeout)


def scrape_and_merge(endpoints: Dict[str, Tuple[str, int]],
                     timeout: float = 2.0) -> str:
    """Scrape every ``{worker: (addr, port)}`` endpoint and render one
    merged job-level exposition.  Unreachable workers become comment
    lines, never a failed scrape.  Workers are scraped in parallel so
    the route's latency is one timeout, not timeouts × dead workers —
    mid-churn (when half the endpoints are corpses) is exactly when
    this view matters, and a serial scrape would blow the caller's own
    scrape deadline then.  The fan-out is ``jobscrape.fan_out``."""
    def _fetch(worker, addr, port):
        return parse_prometheus(scrape(addr, port, timeout=timeout))

    from .jobscrape import fan_out
    per_worker, failed = fan_out(endpoints, _fetch, budget=timeout + 1.0)
    comments: List[str] = [f"worker {w} unreachable: {e}"
                           for w, e in failed.items()]
    comments.insert(0, f"aggregated over {len(per_worker)} worker(s)")
    return render(merge(per_worker), comments=tuple(comments))
