"""Numerics taps: per-bucket gradient stats, the cross-replica divergence
sentinel, and the ``collective.corrupt`` chaos site.

Counterpart: ``horovod_tpu/health/taps.py``, where these are reductions
inside the compiled step, delivered through ``jax.debug.callback``.
Here they run eagerly on the bucket buffers of ``optim/distributed.py``:
each tap's stats stay on the buffer's device as 0-d tensors, and
:meth:`HealthTaps.emit` stacks them and copies them to the host ONCE an
update (one sync a step, not one a bucket).  Stats are taken on the
**local, pre-reduction** buffer, before its collective is issued on the
stream: after the sum every replica sees the same NaN, before it only
the contributing rank does — which is what makes ``(worker, bucket)``
attribution possible at all.

The **divergence sentinel** checksums the parameter buckets (as they
stood when ``update`` was called) and the optimizer state — one float
sum plus one bit-pattern xor each — and allgathers the ``[2, n]``
checksum payload over the transform's process set every
``HOROVOD_HEALTH_CHECK_EVERY`` updates.  Replicas whose row disagrees
are convicted by the evaluator with bucket attribution.  The checksums
are taken leaf by leaf and combined (the xor of per-leaf xors IS the
xor of the concatenation; the sums differ from a concatenation's only
in summation order, which every replica shares), so no bucket or
optimizer state is ever copied whole.

``collective.corrupt`` (chaos site): deterministic NaN / scale-garbage
injection into a chosen bucket on a chosen rank —
``collective.corrupt bucket=1 nth=1 action=nan:2`` NaNs rank 2's
contribution to bucket 1.  Every rank consults the site at the same
buckets in the same order (the plan is the same everywhere), so
predicates count updates a bucket; only the target rank corrupts its
own contribution.  Integer lanes are left alone.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import chaos as _chaos

#: Profiler range around each tap's reductions: a profiled step's
#: device ms of this name is the taps' cost.
TAPS_RANGE = "hvd.health.taps"


# ---------------------------------------------------------------------------
# per-buffer reductions
# ---------------------------------------------------------------------------

def bucket_stats(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(l2, max_abs, nonfinite) of one flat bucket buffer as 0-d tensors
    on its device: fp32 accumulation over the fp32-widened buffer, the
    nonfinite lanes zeroed for the l2 and the max.  Four passes over the
    buffer (the finite count, the zeroing, the two norms), not JAX's
    where/square/abs chain, which XLA fuses and eager torch would not."""
    f = buf.reshape(-1).float()
    nonfinite = f.numel() - torch.isfinite(f).sum(dtype=torch.int32)
    safe = torch.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
    l2 = torch.linalg.vector_norm(safe)
    max_abs = (torch.linalg.vector_norm(safe, float("inf")) if f.numel()
               else torch.zeros((), dtype=torch.float32, device=f.device))
    return l2, max_abs, nonfinite


def _xor_reduce(bits: torch.Tensor) -> torch.Tensor:
    """The xor of every element of a 1-D int32 tensor, as a 0-d int32
    tensor: torch has no xor reduction, so the vector is folded in
    halves (an odd tail element xors into the first lane) until one
    lane is left."""
    if bits.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=bits.device)
    while bits.numel() > 1:
        half = bits.numel() // 2
        folded = torch.bitwise_xor(bits[:half], bits[half:2 * half])
        if bits.numel() % 2:
            folded[:1] = torch.bitwise_xor(folded[:1], bits[2 * half:])
        bits = folded
    return bits.reshape(())


def checksum_flat(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float sum, bit-pattern xor) of a buffer as 0-d tensors on its
    device: the fp32 sum, and the xor of the fp32-widened bit patterns
    (fp32 as it is, bf16 widened exactly) as int32, whose bits are JAX's
    uint32 — any single-bit divergence between replicas flips it."""
    f = buf.reshape(-1).float().contiguous()
    return torch.sum(f), _xor_reduce(f.view(torch.int32))


def checksum_leaves(leaves) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`checksum_flat` of the concatenation of ``leaves`` without
    building it: the fp32 sum of the leaves' sums and the xor of their
    xors (exactly the concatenation's xor)."""
    sums, xors = [], []
    for leaf in leaves:
        s, x = checksum_flat(leaf)
        sums.append(s)
        xors.append(x)
    return torch.stack(sums).sum(), _xor_reduce(torch.stack(xors))


# ---------------------------------------------------------------------------
# collective.corrupt: deterministic NaN / scale-garbage injection
# ---------------------------------------------------------------------------

def _corrupt_target(act) -> Tuple[int, float]:
    """(rank, factor) of a fired corrupt action.  ``nan:R`` → rank R's
    lanes become NaN; ``scale:R[,F]`` → rank R's lanes × F (default
    1e6 — large enough that the explosion verdict fires against any
    warm baseline).  Malformed args default to rank 0."""
    arg = act.arg or ""
    if act.kind == "nan":
        try:
            return int(arg or 0), float("nan")
        except ValueError:
            return 0, float("nan")
    rank_s, _, fac_s = arg.partition(",")
    try:
        rank = int(rank_s or 0)
    except ValueError:
        rank = 0
    try:
        factor = float(fac_s) if fac_s else 1e6
    except ValueError:
        factor = 1e6
    return rank, factor


def _fire_corrupt(bucket: int, name: str):
    act = _chaos.fire("collective.corrupt", bucket=bucket, name=name,
                      _defer=("nan", "scale"))
    if act is None or act.kind not in ("nan", "scale"):
        return None
    return _corrupt_target(act)


def chaos_corrupt(buf: torch.Tensor, rank: int, bucket: int,
                  name: str) -> torch.Tensor:
    """The transform's injection point: consult the ``collective.corrupt``
    site for this bucket and, when a rule fires and ``rank`` (this
    process's rank in the reducing set) is its target, return this
    rank's contribution corrupted (a new buffer; ``buf`` is untouched).
    Callers guard on ``chaos.ACTIVE`` (one false branch)."""
    target = _fire_corrupt(bucket, name)
    if target is None or not buf.is_floating_point() \
            or target[0] != rank:
        return buf
    return buf * torch.tensor(target[1], dtype=buf.dtype,
                              device=buf.device)


def chaos_corrupt_eager(tensors: List, rank: int, bucket: int,
                        name: str) -> List:
    """The engine's injection point (one consult a fused bucket): this
    process's floating contributions corrupted iff its ``rank`` is the
    target; integer tensors pass through."""
    target = _fire_corrupt(bucket, name)
    if target is None or target[0] != rank:
        return tensors
    return [t * torch.tensor(target[1], dtype=t.dtype, device=t.device)
            if torch.is_tensor(t) and t.is_floating_point() else t
            for t in tensors]


# ---------------------------------------------------------------------------
# host deliveries
# ---------------------------------------------------------------------------

def _deliver_stats(names, step, replica, l2s, maxes, nonf, res):
    from . import ACTIVE, evaluator
    if not ACTIVE:
        return   # HOROVOD_HEALTH=0 at run time silences armed taps
    ev = evaluator()
    step_i, rep_i = int(step), int(replica)
    for b, name in enumerate(names):
        ev.ingest_bucket(step_i, rep_i, b, name, float(l2s[b]),
                         float(maxes[b]), int(nonf[b]))
        # -1.0 is the "no residual for this bucket" sentinel; a NaN norm
        # is NOT absent — it is the terminal drift state and must reach
        # the evaluator
        if not res[b] == -1.0:
            ev.ingest_residual(step_i, rep_i, b, float(res[b]), name=name)


def _deliver_checksums(names, step, replica, gathered):
    from . import ACTIVE, evaluator
    if not ACTIVE:
        return
    g = np.asarray(gathered, dtype=np.float32)     # [world, 2, n]
    sums = g[:, 0, :]
    xors = np.ascontiguousarray(g[:, 1, :]).view(np.uint32)
    evaluator().ingest_checksums(int(step), int(replica), list(names),
                                 sums.tolist(), xors.tolist())


#: The last emission's host cost: ``{"buckets", "emit_host_ms"}`` (the
#: stack, the one device→host copy and the evaluator's ingestion).
LAST_EMIT: dict = {}


# ---------------------------------------------------------------------------
# the per-update tap context the distributed transform threads through
# ---------------------------------------------------------------------------

class HealthTaps:
    """Collects one update's per-bucket observations as device scalars
    and delivers them with ONE device→host copy (:meth:`emit`), plus the
    sentinel's allgather on its cadence.

    ``worker`` is this process's rank in the transform's process set,
    ``step`` the update counter (``_DistState.count``); ``check_every``
    is the sentinel cadence and ``cadence_step`` the counter it divides
    (default ``step``; with gradient accumulation the caller passes the
    BOUNDARY ordinal ``count // k``).  ``process_set`` is the set the
    sentinel gathers over (its size 1: no sentinel)."""

    def __init__(self, worker: int, step: int, check_every: int = 32,
                 cadence_step: Optional[int] = None, process_set=None):
        self.worker = int(worker)
        self.step = int(step)
        self.cadence_step = (self.step if cadence_step is None
                             else int(cadence_step))
        self.check_every = max(int(check_every), 1)
        self.process_set = process_set
        self._names: List[str] = []
        self._rows: List[Optional[torch.Tensor]] = []
        self._res: List[Optional[torch.Tensor]] = []
        self._param_sums = None

    # -- observation hooks (called inside the fused bucket loops) ------------

    def observe_bucket(self, bucket_id: int, name: str, buf: torch.Tensor):
        """Stats over one bucket's LOCAL flat gradient buffer (called
        with the pre-reduction buffer, before its collective)."""
        with torch.profiler.record_function(TAPS_RANGE):
            l2, max_abs, nonfinite = bucket_stats(buf)
            row = torch.stack([l2.double(), max_abs.double(),
                               nonfinite.double()])
        # buckets arrive in plan order; pad any gap, each padded slot
        # named by its OWN index (see emit: a pad is never delivered
        # under a real bucket's name)
        while len(self._names) <= bucket_id:
            self._names.append(str(len(self._names)))
            self._rows.append(None)
            self._res.append(None)
        self._names[bucket_id] = str(name)
        self._rows[bucket_id] = row

    def observe_residual(self, bucket_id: int, buf: Optional[torch.Tensor]):
        """l2 norm of a quantized bucket's NEW error-feedback residual
        (flat, this rank's carried quantization error)."""
        if buf is None or bucket_id >= len(self._names):
            return
        with torch.profiler.record_function(TAPS_RANGE):
            f = buf.reshape(-1).float()
            self._res[bucket_id] = torch.sqrt(torch.sum(torch.square(f)))

    def observe_staleness(self, bucket_id: int, name: str, counters,
                          cap: int):
        """Per-cross-group substitution counters of a stale tail bucket,
        delivered at once (they are host integers already); ``bucket_id``
        keeps two stale buckets' saturation conditions apart."""
        from . import ACTIVE, evaluator
        if not ACTIVE:
            return
        evaluator().ingest_staleness(self.step, str(name),
                                     [int(c) for c in counters], int(cap),
                                     bucket=int(bucket_id))

    # -- emission ------------------------------------------------------------

    def emit(self):
        """Deliver the collected bucket stats: one stack, one device→host
        copy, then the evaluator's ingestion on the host."""
        if not self._names:
            return
        t0 = time.perf_counter()
        dev = next((r.device for r in self._rows if r is not None),
                   torch.device("cpu"))
        zero = torch.zeros(3, dtype=torch.float64, device=dev)
        none = torch.full((), -1.0, dtype=torch.float64, device=dev)
        rows = torch.stack([
            torch.cat([r if r is not None else zero,
                       (x.double() if x is not None else none).reshape(1)])
            for r, x in zip(self._rows, self._res)]).cpu().numpy()
        _deliver_stats(tuple(self._names), self.step, self.worker,
                       rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3])
        LAST_EMIT.clear()
        LAST_EMIT.update(buckets=len(self._names),
                         emit_host_ms=1e3 * (time.perf_counter() - t0))

    # -- the divergence sentinel ---------------------------------------------

    def _sentinel_due(self) -> bool:
        ps = self.process_set
        return (ps is not None and ps.size() > 1
                and self.cadence_step % self.check_every == 0)

    def checksum_params(self, bucket_leaves_fn: Callable):
        """The parameter half of the sentinel, taken BEFORE the update is
        applied (the transform updates the parameters in place; JAX
        checksums them as ``update`` received them): ``bucket_leaves_fn``
        is a thunk returning ``(name, leaves)`` a planned bucket, called
        only on the cadence."""
        if not self._sentinel_due():
            return
        names, sums, xors = [], [], []
        for name, leaves in bucket_leaves_fn():
            s, x = checksum_leaves(leaves)
            names.append(str(name))
            sums.append(s)
            xors.append(x)
        self._param_sums = (names, sums, xors)

    def sentinel(self, opt_leaves_fn: Optional[Callable] = None):
        """The rest of the sentinel, after the update: one aggregate
        checksum of the optimizer state's tensors (``opt_leaves_fn``, a
        thunk; None under ``sharded_update``, whose state is 1/N a rank by
        design), then one allgather of the ``[2, n]`` payload over the
        process set and the comparison on the host.  No-op off the
        cadence and at a set of one (a replica cannot desync from
        itself)."""
        if not self._sentinel_due() or self._param_sums is None:
            return
        from ..ops import collectives
        names, sums, xors = (list(v) for v in self._param_sums)
        self._param_sums = None
        if opt_leaves_fn is not None:
            leaves = [t for t in opt_leaves_fn()
                      if torch.is_tensor(t) and t.numel()]
            if leaves:
                s, x = checksum_leaves(leaves)
                names.append("opt_state")
                sums.append(s)
                xors.append(x)
        if not names:
            return
        dev = sums[0].device
        payload = torch.stack([
            torch.stack([s.float() for s in sums]),
            torch.stack([x.to(dev) for x in xors]).view(torch.float32)])
        gathered = collectives.all_gather_flat(payload.reshape(-1),
                                               self.process_set)
        g = gathered.reshape(self.process_set.size(), 2,
                             len(names)).cpu().numpy()
        _deliver_checksums(tuple(names), self.step, self.worker, g)
