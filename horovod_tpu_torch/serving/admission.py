"""Continuous micro-batching: the admission queue of the serving plane.

Requests are tensors with deadlines, so coalescing IS the engine's
fusion problem restated: the training cycle loop batches asynchronously
submitted gradients into deterministic fused buckets under a byte cap
and a cycle-time window; the admission queue batches asynchronously
submitted requests into micro-batches under a batch cap and an
admission tick.  The mapping is literal — each pending request becomes
an :class:`~horovod_tpu_torch.ops.fusion.EntrySig` (one unit-sized entry, its
seq-length bucket riding the ``layer`` key so shape classes never mix)
and the SAME ``plan_fusion`` planner the engine dispatches with decides
the batches: the byte threshold becomes the batch cap
(``unit_bytes * max_batch``), and the cycle tick becomes the admission
tick.

Batches bind LATE: requests stay pending until a worker pull calls
:meth:`AdmissionQueue.take`, which plans the pending set THEN and hands
out one dispatchable bucket — full, or aged past one tick.  Binding at
submit/tick time instead would freeze batch composition before the
worker is ready and fragment a backlog into stale under-filled batches
(the first bench run measured exactly that: 1-row batches at 3x load).

Deadline semantics (docs/serving.md): a request whose deadline expires
while still queued is failed at admission (outcome ``expired``) instead
of wasting a batch slot on an answer nobody is waiting for; dispatched
requests always complete (a late answer is still an answer — the
latency histograms, not a drop, record the miss).

Counterpart: ``horovod_tpu/serving/admission.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..ops.fusion import EntrySig, plan_fusion
from .shapes import ShapeBuckets

#: Planner unit: every request is one unit-sized EntrySig, so the
#: engine's byte threshold maps exactly onto the batch cap.
_UNIT_BYTES = 4  # one int32 "element" per request


@dataclasses.dataclass(eq=False)
class ServeRequest:
    """One admitted request: a token row plus its latency contract.

    Identity semantics (``eq=False``): dataclass equality would compare
    the ndarray field — ambiguous-truth ValueError for two same-id
    requests (an idempotent client resubmit) — and no caller wants
    value equality on a request."""
    id: str
    tokens: np.ndarray            # 1-D int32
    arrival: float                # time.monotonic at submit
    deadline: Optional[float]     # absolute monotonic, None = no bound
    seq_bucket: int               # padded seq class (shapes.seq_bucket)
    seq: int = 0                  # admission ordinal (FIFO identity)


@dataclasses.dataclass
class Batch:
    """One planned micro-batch, bound at pull time."""
    batch_id: int
    seq_bucket: int
    requests: List[ServeRequest]
    planned_at: float


class AdmissionQueue:
    """Thread-safe pending set + pull-time micro-batch planner.

    Synchronization is EXTERNAL: the owner (the serving plane) passes
    its own Condition so a ``submit`` wakes parked ``serve_pull``
    long-polls directly; standalone (unit tests) the queue makes its
    own.  ``max_batch`` is mutable (``set_max_batch``) so one plane can
    run the sequential baseline (cap 1) and the batched path through
    the same code — the cap is read once per plan.
    """

    def __init__(self, buckets: ShapeBuckets, tick_s: float,
                 on_expired: Optional[Callable[[ServeRequest], None]]
                 = None,
                 max_batch: Optional[int] = None,
                 cv: Optional[threading.Condition] = None):
        self.buckets = buckets
        self.tick_s = max(float(tick_s), 0.0)
        self._on_expired = on_expired
        self._max_batch = int(max_batch or buckets.max_batch)
        if self._max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self._max_batch}")
        self._cv = cv if cv is not None else threading.Condition()
        self._pending: List[ServeRequest] = []
        self._seq = 0
        self._batch_id = 0
        # counters (plane stats / hvd_serve_* families)
        self.submitted = 0
        self.requeued = 0
        self.expired = 0
        self.batches_planned = 0

    def set_max_batch(self, max_batch: int):
        if max_batch < 1 or max_batch > self.buckets.max_batch:
            raise ValueError(
                f"max_batch must be in [1, {self.buckets.max_batch}], "
                f"got {max_batch}")
        with self._cv:
            self._max_batch = int(max_batch)

    # -- submission ---------------------------------------------------------
    def submit(self, req: ServeRequest):
        """Admit one request (seq-bucket overflow raises ValueError —
        the caller rejects the request, never grows the shape set)."""
        req.seq_bucket = self.buckets.seq_bucket(int(req.tokens.size))
        with self._cv:
            req.seq = self._seq
            self._seq += 1
            self._pending.append(req)
            self.submitted += 1
            self._cv.notify_all()

    def requeue(self, requests: Sequence[ServeRequest]):
        """Return dispatched-but-unserved requests to the queue (worker
        loss / elastic re-form).  They keep their original admission
        ordinal, so the planner's FIFO order puts them back at the
        FRONT of their shape class — re-queued, not demoted."""
        if not requests:
            return
        with self._cv:
            self._pending.extend(requests)
            self.requeued += len(requests)
            self._cv.notify_all()

    def depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def has_pending(self) -> bool:
        with self._cv:
            return bool(self._pending)

    # -- planning -----------------------------------------------------------
    def _plan(self, pending: List[ServeRequest]) -> List[List[int]]:
        """The engine's planner over the pending requests.

        One unit-sized allreduce-shaped EntrySig per request: the seq
        bucket rides ``layer`` (entries with different layer keys never
        fuse — the same never-mix-shapes property the overlapped
        dispatch path bought with it), the zero-padded admission
        ordinal rides ``name`` (plan_fusion sorts by name within a
        bucket key, so planning order IS arrival order), and the byte
        threshold ``_UNIT_BYTES * max_batch`` caps every batch at
        ``max_batch`` rows.
        """
        entries = [EntrySig(
            name=f"{r.seq:012d}", op_type="allreduce", reduce_op="sum",
            dtype="int32", shape=(1,), process_set_id=0, stacked=False,
            layer=r.seq_bucket) for r in pending]
        return plan_fusion(entries, _UNIT_BYTES * self._max_batch)

    def sweep_expired(self, now: Optional[float] = None) -> int:
        """Fail queued requests whose deadline passed (the plane's
        reaper calls this so deadlines fire even with no worker
        pulling)."""
        now = time.monotonic() if now is None else now
        with self._cv:
            dead = [r for r in self._pending
                    if r.deadline is not None and now > r.deadline]
            if not dead:
                return 0
            dead_ids = {id(r) for r in dead}   # object identity, never
            self._pending = [r for r in self._pending  # ndarray __eq__
                             if id(r) not in dead_ids]
            self.expired += len(dead)
        if self._on_expired is not None:
            for r in dead:
                self._on_expired(r)
        return len(dead)

    def take(self, now: Optional[float] = None) -> Optional[Batch]:
        """Bind and return ONE dispatchable micro-batch, or None.

        Plans the CURRENT pending set and picks, among buckets that are
        full or whose oldest member has aged one tick, the one with the
        oldest member — FIFO across shape classes, so a busy class
        cannot starve a quiet one.  Everything else stays pending and
        re-plans on the next take (late binding)."""
        now = time.monotonic() if now is None else now
        self.sweep_expired(now)
        with self._cv:
            if not self._pending:
                return None
            cap = self._max_batch
            plan = self._plan(self._pending)
            best = None
            best_oldest = None
            for bucket in plan:
                oldest = min(self._pending[i].arrival for i in bucket)
                if len(bucket) < cap and now - oldest < self.tick_s:
                    continue   # partial and still inside its window
                if best is None or oldest < best_oldest:
                    best, best_oldest = bucket, oldest
            if best is None:
                return None
            picked = [self._pending[i] for i in best]
            taken = set(best)
            self._pending = [r for i, r in enumerate(self._pending)
                             if i not in taken]
            self._batch_id += 1
            self.batches_planned += 1
            return Batch(batch_id=self._batch_id,
                         seq_bucket=picked[0].seq_bucket,
                         requests=picked, planned_at=now)

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"submitted": self.submitted,
                    "requeued": self.requeued,
                    "expired": self.expired,
                    "batches_planned": self.batches_planned,
                    "depth": len(self._pending)}
