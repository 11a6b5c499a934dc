"""Typed metric registry: Counter / Gauge / Histogram with bounded label
sets and fixed log2 bucket edges.

Reference analog: the stack's counters so far (engine ``stats()``,
controller KV counters, chaos ``FaultSchedule.stats()``) are ad-hoc dicts
read in-process only.  This registry is the single quantitative layer
OptiReduce-style tail analysis needs (PAPERS.md arXiv:2310.06993 — tail
latency, not the mean, governs cloud allreduce throughput): histograms
carry *fixed* log2 bucket edges declared with the metric, so every worker
in a job produces bucket-identical series and the driver can merge them
by summing bucket-wise — no rebinning, no information loss at the tails.

Concurrency: one lock per metric family.  The hot paths (``inc``,
``observe``) do a dict lookup + float add under that lock; instrumented
call sites additionally guard on :data:`horovod_tpu_torch.metrics.ACTIVE` so a
disabled registry costs one false branch (hvdchaos discipline).

Label discipline: a family declares its label names at creation; series
are bounded at :data:`MAX_SERIES` distinct label-value combinations —
the overflow combination collapses into a single ``other`` series
instead of growing memory forever (tensor-name-like unbounded labels are
a misuse; use bounded sets like method/op/rule).

Counterpart: ``horovod_tpu/metrics/registry.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.  One addition: a family's ``max_series`` may be
raised past :data:`MAX_SERIES` where its label set is bounded by a plan
(the health plane's per-bucket families: the 1B Llama's plan has 66
buckets).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Distinct label-value combinations per family before collapsing to
#: the ``other`` overflow series.
MAX_SERIES = 64

#: The label-values key of the overflow series.
OVERFLOW = "other"


def _label_key(label_names: Sequence[str], labels: Dict[str, str]
               ) -> Tuple[str, ...]:
    return tuple(str(labels.get(n, "")) for n in label_names)


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    if v == int(v) and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def log2_edges(lo: int, hi: int) -> Tuple[float, ...]:
    """Bucket upper bounds ``2**lo .. 2**hi`` (inclusive).  Fixed at
    declaration so histograms from every worker merge bucket-wise."""
    if hi <= lo:
        raise ValueError(f"log2 edge range must satisfy hi > lo "
                         f"({lo}, {hi})")
    return tuple(2.0 ** e for e in range(lo, hi + 1))


class _Metric:
    """Common family machinery: label binding + bounded child table."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.max_series = MAX_SERIES
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child(self, labels: Dict[str, str]):
        key = _label_key(self.label_names, labels)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self.max_series:
                key = (OVERFLOW,) * len(self.label_names)
                child = self._children.get(key)
                if child is not None:
                    return child
            child = self._new_child()
            self._children[key] = child
        return child

    def _new_child(self):
        raise NotImplementedError

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        """Label dict + a CONSISTENT SNAPSHOT per child, taken under the
        family lock — a scrape racing an observe() must never expose a
        histogram whose _count disagrees with its +Inf bucket."""
        with self._lock:
            return [(dict(zip(self.label_names, key)),
                     self._snapshot_child(child))
                    for key, child in sorted(self._children.items())]

    def _snapshot_child(self, child):
        return list(child)


class Counter(_Metric):
    """Monotonically increasing count (Prometheus counter)."""

    kind = "counter"

    def _new_child(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._child(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            child = self._children.get(
                _label_key(self.label_names, labels))
            return child[0] if child else 0.0


class Gauge(_Metric):
    """Point-in-time value (Prometheus gauge)."""

    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def set(self, value: float, **labels):
        with self._lock:
            self._child(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        with self._lock:
            self._child(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            child = self._children.get(
                _label_key(self.label_names, labels))
            return child[0] if child else 0.0


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_edges: int):
        self.counts = [0] * (n_edges + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Distribution with fixed log2 bucket edges (Prometheus histogram).

    ``lo``/``hi`` are base-2 exponents: edges are ``2**lo .. 2**hi``
    plus the implicit ``+Inf``.  Identical exponents on every worker ⇒
    bucket-wise mergeable by the driver aggregator.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Sequence[str],
                 lo: int = -17, hi: int = 6):
        super().__init__(name, help, label_names)
        self.lo, self.hi = lo, hi
        self.edges = log2_edges(lo, hi)

    def _new_child(self):
        return _HistChild(len(self.edges))

    def _snapshot_child(self, child):
        snap = _HistChild(0)
        snap.counts = list(child.counts)
        snap.sum = child.sum
        snap.count = child.count
        return snap

    def observe(self, value: float, **labels):
        i = bisect.bisect_left(self.edges, value)
        with self._lock:
            child = self._child(labels)
            child.counts[i] += 1
            child.sum += value
            child.count += 1

    def child(self, **labels) -> Optional[_HistChild]:
        with self._lock:
            return self._children.get(
                _label_key(self.label_names, labels))


class MetricRegistry:
    """Process-wide family table.  ``counter``/``gauge``/``histogram``
    are get-or-create and idempotent; re-declaring a name with a
    different type or label set raises (two call sites disagreeing on a
    family is a bug, not a merge)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "Dict[str, _Metric]" = {}

    def _declare(self, cls, name, help, labels, **kwargs) -> _Metric:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (type(fam) is not cls
                        or fam.label_names != tuple(labels)):
                    raise ValueError(
                        f"metric {name!r} re-declared as {cls.kind}"
                        f"{tuple(labels)} but exists as {fam.kind}"
                        f"{fam.label_names}")
                if cls is Histogram and (fam.lo, fam.hi) != (
                        kwargs.get("lo", -17), kwargs.get("hi", 6)):
                    # disagreeing bucket edges would silently land
                    # observations in the wrong fixed edges — the exact
                    # cross-worker mismatch merge() hard-errors on
                    raise ValueError(
                        f"histogram {name!r} re-declared with edges "
                        f"2^{kwargs.get('lo', -17)}..2^"
                        f"{kwargs.get('hi', 6)} but exists with "
                        f"2^{fam.lo}..2^{fam.hi}")
                return fam
            fam = cls(name, help, labels, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), lo: int = -17,
                  hi: int = 6) -> Histogram:
        return self._declare(Histogram, name, help, labels, lo=lo, hi=hi)

    def families(self) -> List[_Metric]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    # -- exposition ----------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in fam.series():
                base = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in labels.items())
                if isinstance(fam, Histogram):
                    cum = 0
                    for edge, n in zip(fam.edges, child.counts):
                        cum += n
                        le = (f'{base},le="{_fmt(edge)}"' if base
                              else f'le="{_fmt(edge)}"')
                        out.append(
                            f"{fam.name}_bucket{{{le}}} {cum}")
                    cum += child.counts[-1]
                    le = (f'{base},le="+Inf"' if base else 'le="+Inf"')
                    out.append(f"{fam.name}_bucket{{{le}}} {cum}")
                    sfx = f"{{{base}}}" if base else ""
                    out.append(f"{fam.name}_sum{sfx} {_fmt(child.sum)}")
                    out.append(f"{fam.name}_count{sfx} {child.count}")
                else:
                    sfx = f"{{{base}}}" if base else ""
                    out.append(f"{fam.name}{sfx} {_fmt(child[0])}")
        return "\n".join(out) + "\n"

    def to_dict(self) -> dict:
        """JSON-snapshot form (HOROVOD_METRICS_DUMP / engine.stats())."""
        out = {}
        for fam in self.families():
            series = []
            for labels, child in fam.series():
                if isinstance(fam, Histogram):
                    series.append({"labels": labels,
                                   "buckets": list(child.counts),
                                   "sum": child.sum,
                                   "count": child.count})
                else:
                    series.append({"labels": labels, "value": child[0]})
            entry = {"type": fam.kind, "series": series}
            if isinstance(fam, Histogram):
                entry["le"] = list(fam.edges)
            out[fam.name] = entry
        return out
