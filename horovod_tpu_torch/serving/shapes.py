"""Bucketed batch/sequence shapes: the no-recompile contract of serving.

A forward prepares each input shape once (JAX compiles it; the port's
eager forward allocates its buffers, and a captured graph would be
captured), and preparing in the serving hot path is a p99 outlier.
Serving therefore admits only a SMALL FIXED SET of shapes: every
micro-batch is padded up to the smallest ``(batch, seq)`` bucket that
fits, so after one warmup pass over the buckets every request finds its
bucket prepared (``hvd_serve_recompiles_total`` staying 0 is a gated
invariant of ``chip_smoke.py``'s ``serve`` phase).

The cost of padding is wasted FLOPs (padding ratio rides
``hvd_serve_batch_fill_ratio``); the buckets are the knob trading that
waste against the buckets held (``HOROVOD_SERVE_SEQ_BUCKETS``,
``HOROVOD_SERVE_BATCH_BUCKETS`` — docs/env.md).

Counterpart: ``horovod_tpu/serving/shapes.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def parse_buckets(spec: str, name: str) -> Tuple[int, ...]:
    """Parse a comma-separated ascending positive int list (the
    HOROVOD_SERVE_*_BUCKETS grammar).  Raises ValueError on anything
    else — a typo'd bucket table must fail at config time, not pad
    every request to a nonsense shape."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            v = int(part)
        except ValueError:
            raise ValueError(
                f"{name} must be comma-separated integers, got "
                f"{spec!r}") from None
        if v <= 0:
            raise ValueError(f"{name} entries must be positive, got {v}")
        if out and v <= out[-1]:
            raise ValueError(
                f"{name} must be strictly ascending, got {spec!r}")
        out.append(v)
    if not out:
        raise ValueError(f"{name} must name at least one bucket, "
                         f"got {spec!r}")
    return tuple(out)


def parse_mp_axes(spec: str) -> Tuple[str, int]:
    """Parse the ``HOROVOD_SERVE_MP_AXES`` grammar: ``""`` (DP-only,
    returns ``("", 1)``) or ``name:degree`` with degree >= 2 — e.g.
    ``model:2``.  One axis for now; the grammar leaves room for a
    comma list when serving grows a second mesh dimension."""
    spec = (spec or "").strip()
    if not spec:
        return "", 1
    if "," in spec:
        raise ValueError(
            f"HOROVOD_SERVE_MP_AXES supports a single axis for now, "
            f"got {spec!r}")
    name, sep, degree = spec.partition(":")
    name = name.strip()
    if not sep or not name:
        raise ValueError(
            f"HOROVOD_SERVE_MP_AXES must be 'name:degree' (e.g. "
            f"'model:2') or empty, got {spec!r}")
    try:
        d = int(degree.strip())
    except ValueError:
        raise ValueError(
            f"HOROVOD_SERVE_MP_AXES degree must be an integer, got "
            f"{spec!r}") from None
    if d < 2:
        raise ValueError(
            f"HOROVOD_SERVE_MP_AXES degree must be >= 2 (omit the "
            f"variable for DP-only serving), got {spec!r}")
    return name, d


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """One compiled shape: ``batch`` padded rows of ``seq`` tokens,
    served over an ``mp``-way model-parallel mesh slice (``mp=1`` is
    the single-chip/DP-only case — the default everywhere)."""
    batch: int
    seq: int
    mp: int = 1

    @property
    def key(self) -> str:
        """Bounded metric-label form (``b4xs64``; ``b4xs64xm2`` when
        model-parallel — the unsliced form stays byte-stable so
        existing dashboards keep their labels)."""
        base = f"b{self.batch}xs{self.seq}"
        return base if self.mp == 1 else f"{base}xm{self.mp}"


class ShapeBuckets:
    """The admitted shape set: ``batch_buckets`` x ``seq_buckets``,
    optionally x ``mp_degrees`` — the mesh dimension of the bucket
    table.  The mesh degree is a COMPILE-TIME shape exactly like batch
    and seq: a pmap over a different device count is a different
    executable, so admitting it must be as deliberate as admitting a
    new sequence bucket (``HOROVOD_SERVE_MP_AXES`` — docs/env.md)."""

    def __init__(self, batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 seq_buckets: Sequence[int] = (32, 64, 128),
                 mp_degrees: Sequence[int] = (1,)):
        self.batch_buckets = parse_buckets(
            ",".join(str(b) for b in batch_buckets), "batch buckets")
        self.seq_buckets = parse_buckets(
            ",".join(str(s) for s in seq_buckets), "seq buckets")
        self.mp_degrees = parse_buckets(
            ",".join(str(m) for m in mp_degrees), "mp degrees")

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @property
    def max_seq(self) -> int:
        return self.seq_buckets[-1]

    @property
    def max_mp(self) -> int:
        return self.mp_degrees[-1]

    def __len__(self) -> int:
        return (len(self.batch_buckets) * len(self.seq_buckets)
                * len(self.mp_degrees))

    def seq_bucket(self, seq_len: int) -> int:
        """Smallest seq bucket holding ``seq_len`` tokens.  Raises on
        overflow: an over-long request is REJECTED at admission (the
        alternative — compiling a fresh shape for it — is exactly the
        recompile tail this module exists to prevent)."""
        for s in self.seq_buckets:
            if seq_len <= s:
                return s
        raise ValueError(
            f"request length {seq_len} exceeds the largest seq bucket "
            f"{self.seq_buckets[-1]}; widen HOROVOD_SERVE_SEQ_BUCKETS")

    def batch_bucket(self, n_rows: int) -> int:
        """Smallest batch bucket holding ``n_rows`` rows (n_rows must
        not exceed the cap — the admission queue's batch cap is
        ``max_batch``)."""
        for b in self.batch_buckets:
            if n_rows <= b:
                return b
        raise ValueError(
            f"batch of {n_rows} exceeds the largest batch bucket "
            f"{self.batch_buckets[-1]} (admission cap bug)")

    def bucket(self, n_rows: int, seq_len: int,
               mp: int = 1) -> ShapeBucket:
        if mp not in self.mp_degrees:
            raise ValueError(
                f"mp degree {mp} not in the admitted mesh dimension "
                f"{self.mp_degrees}; widen HOROVOD_SERVE_MP_AXES")
        return ShapeBucket(self.batch_bucket(n_rows),
                           self.seq_bucket(seq_len), mp)

    def pad_batch(self, rows: Sequence[np.ndarray], seq: int,
                  pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Right-pad ``rows`` (1-D int arrays, each <= ``seq`` long) into
        the ``(batch_bucket(len(rows)), seq)`` shape.  Returns
        ``(tokens [B, seq], lengths [B])`` with pad rows' length 0 rows
        present as all-pad (length clamped to 1 so downstream per-row
        gathers at ``length - 1`` stay in bounds; pad-row outputs are
        discarded by the dispatcher)."""
        b = self.batch_bucket(len(rows))
        tokens = np.full((b, seq), pad_id, dtype=np.int32)
        lengths = np.ones((b,), dtype=np.int32)
        for i, row in enumerate(rows):
            row = np.asarray(row, dtype=np.int32).reshape(-1)
            if row.size > seq:
                raise ValueError(
                    f"row {i} length {row.size} > seq bucket {seq}")
            n = max(int(row.size), 1)
            tokens[i, :row.size] = row
            lengths[i] = n
        return tokens, lengths
