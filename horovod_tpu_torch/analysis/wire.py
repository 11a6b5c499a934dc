"""Ring-model wire-byte accounting over recorded collective schedules.

Counterpart: ``horovod_tpu/analysis/wire.py``.  "How many bytes does one
step move per worker?" answered from the collective schedule
``analysis/schedule.py`` records while the port's step runs: per-
collective transmit bytes under the standard ring algorithms, summed
over a schedule, plus the primitive-count summary.

The model is the textbook ring cost, not a profile: psum (allreduce)
moves ``2(n-1)/n`` of the payload per worker, reduce-scatter /
all_to_all ``(n-1)/n`` of the *input*, all_gather ``(n-1)/n`` of the
*output*.  Collectives over axes absent from ``axis_sizes`` (e.g. a tp
axis when only dp is being accounted) contribute zero; ``axis_filter``
restricts to one hop (e.g. only the DCN axis of a hierarchical
reduction).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

_AVAL_RE = re.compile(r"^(\w+)\[([\dx]*)\]$")


def aval_nbytes(aval: str) -> int:
    """Bytes of one ``dtype[axb...]`` aval string from a schedule record
    (widths from the fusion planner's table — unknown dtypes raise)."""
    from ..ops.fusion import dtype_nbytes
    m = _AVAL_RE.match(aval)
    if not m:
        raise ValueError(f"unparseable aval {aval!r}")
    dims = [int(d) for d in m.group(2).split("x")] if m.group(2) else []
    numel = 1
    for d in dims:
        numel *= d
    return numel * dtype_nbytes(m.group(1))


def ring_transmit_bytes(record, axis_sizes: Dict[str, int],
                        axis_filter: Optional[str] = None,
                        strict: bool = False) -> int:
    """Per-worker transmit bytes of one collective under the standard
    ring algorithms (see module docstring).  ``record`` is an
    ``analysis.schedule.CollectiveRecord``.

    ``pmax``/``pmin`` cost like ``psum`` (a combining allreduce moves
    the same bytes whatever the combiner) — they used to fall into the
    conservative unknown-prim fallback, which overstated the
    tail-reduce's pmin membership-agreement round ~2x.  ``strict=True``
    RAISES on a primitive the model doesn't know instead of guessing
    ``in_bytes``: byte-conservation gates
    must fail loudly when a schedule grows a collective the accounting
    silently mis-prices.

    With ``axis_filter`` the collective is priced as the filtered
    axis's HOP of a hierarchical factoring: ``n`` is that axis's size
    alone and the operand bytes are what cross it.  A psum over
    ``(data, model)`` filtered at ``data`` used to be priced with
    ``n = data*model`` — charging the model-hop bytes to the data
    (DCN) filter and over-counting the spec-aware sharded schedules,
    whose psum operands are model-axis SHARDS that only ever ride the
    data hop (the record's aval is the shard, so the operand bytes are
    already right; only the ``n`` factoring was not)."""
    axes = [a for a in record.axes if a in axis_sizes]
    if axis_filter is not None and axis_filter not in axes:
        return 0
    n = 1
    if axis_filter is not None:
        n = axis_sizes[axis_filter]
    else:
        for a in axes:
            n *= axis_sizes[a]
    if n <= 1:
        return 0
    in_bytes = sum(aval_nbytes(a) for a in record.inputs)
    out_bytes = sum(aval_nbytes(a) for a in record.outputs)
    if record.prim in ("psum", "pmax", "pmin"):
        return (2 * (n - 1) * in_bytes) // n
    if record.prim in ("psum_scatter", "reduce_scatter", "all_to_all"):
        return ((n - 1) * in_bytes) // n
    if record.prim == "all_gather":
        return ((n - 1) * out_bytes) // n
    if strict:
        raise ValueError(
            f"no ring-cost model for collective {record.prim!r} "
            f"(index {record.index}, axes {record.axes}): add one to "
            f"analysis.wire.ring_transmit_bytes before trusting a "
            f"byte-conservation gate over this schedule")
    return in_bytes  # conservative for anything unexpected


def schedule_transmit_bytes(schedule, axis_sizes=None,
                            axis_filter: Optional[str] = None,
                            strict: bool = False) -> int:
    """Total per-worker ring-model transmit bytes of a traced
    :class:`~.schedule.Schedule` (default ``axis_sizes``: the
    schedule's own axis_env).  ``strict=True`` raises on primitives
    the ring model doesn't cover (see :func:`ring_transmit_bytes`)."""
    sizes = dict(axis_sizes if axis_sizes is not None
                 else schedule.axis_env)
    return sum(ring_transmit_bytes(r, sizes, axis_filter, strict=strict)
               for r in schedule.records)


def schedule_prim_counts(schedule) -> Dict[str, int]:
    """Collective primitive -> count over a traced schedule (the
    one-line schedule summary the bench A/B tables print)."""
    counts: Dict[str, int] = {}
    for r in schedule.records:
        counts[r.prim] = counts.get(r.prim, 0) + 1
    return counts


#: Short alias (the name the bench tables/docs use).
prim_counts = schedule_prim_counts


def trace_transmit_bytes(fn, example_args: Sequence,
                         axis_env: Sequence[Tuple[str, int]],
                         axis_filter: Optional[str] = None,
                         entry: str = "wire") -> int:
    """Run ``fn(*example_args)`` with the schedule recorder armed and
    return its per-worker ring-model transmit bytes in one call (JAX:
    traces ``fn`` instead; the port records the collectives it issues)."""
    from . import recorder
    from .schedule import CollectiveRecord, Schedule
    with recorder.recording() as rec:
        fn(*example_args)
    sched = Schedule(entry=entry, axis_env=list(axis_env),
                     records=[CollectiveRecord.from_dict(r)
                              for r in rec.records])
    return schedule_transmit_bytes(sched, dict(axis_env), axis_filter)
