"""Driver-side serving plane: admission, leases, results, stragglers.

The control plane built for elastic training (keep-alive RPC, epoch
re-forms, blacklists, merged metrics) is already a serving fleet
manager — this module adds the data path.  Clients POST
``serve_submit``; the admission queue micro-batches
(:mod:`.admission`); workers long-poll ``serve_pull`` and report with
``serve_push``; clients long-poll ``serve_result``.  Every hop rides
:func:`~horovod_tpu_torch.runner.rpc.json_request` — the same HMAC-signed
keep-alive connection pool as the rest of the control plane.

Loss-free elasticity: every dispatched batch holds a LEASE.  A lease is
released by the worker's push, requeued by ``worker_gone`` (the elastic
driver's reaper and re-form path call it — docs/serving.md), or
requeued by the lease reaper at ``lease_s`` (the backstop for silent
worker death when no driver is watching).  Requeued requests keep
their admission ordinal, so they rejoin the FRONT of their shape
class: kill-worker-mid-traffic loses zero requests, the
``tools/bench_serve.py`` gate.

Tail protection: per-worker service-time EWMAs (fed by every push)
rotate a chronic straggler out of the pull rotation once its EWMA
crosses ``straggler_factor`` x the median of its peers — the serving
analog of the gradient plane's straggler blacklist (OptiReduce's
prescription applied to the product metric itself).

Counterpart: ``horovod_tpu/serving/plane.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import metrics as _metrics
from ..config import Config
from .admission import AdmissionQueue, Batch, ServeRequest
from .shapes import ShapeBuckets

logger = logging.getLogger("horovod_tpu_torch")

# -- metric families (docs/metrics.md; sites guard on _metrics.ACTIVE) --------
# serve-latency histograms use lo=-13 (≈0.12 ms): the 2^-10 floor of
# hvd_tail_lateness_seconds cannot separate a 0.3 ms from a 0.9 ms
# request (both land under the ~0.98 ms edge) — pinned in
# tests/test_serving.py
_m_requests = _metrics.counter(
    "hvd_serve_requests_total",
    "Serving requests by outcome (completed / expired / rejected)",
    labels=("outcome",))
_m_requeued = _metrics.counter(
    "hvd_serve_requeued_total",
    "Dispatched requests returned to the admission queue, by cause",
    labels=("reason",))
_m_batches = _metrics.counter(
    "hvd_serve_batches_total",
    "Micro-batches dispatched, by padded shape bucket",
    labels=("bucket",))
_m_fill = _metrics.histogram(
    "hvd_serve_batch_fill_ratio",
    "Live rows / padded batch capacity of each dispatched micro-batch",
    lo=-4, hi=0)
_m_depth = _metrics.gauge(
    "hvd_serve_queue_depth", "Requests waiting in the admission queue")
_m_admission = _metrics.histogram(
    "hvd_serve_admission_latency_seconds",
    "Submit -> micro-batch dispatch wait (the batching window cost)",
    lo=-13, hi=7)
_m_e2e = _metrics.histogram(
    "hvd_serve_e2e_latency_seconds",
    "Submit -> result completion, driver-side clock", lo=-13, hi=7)
_m_workers = _metrics.gauge(
    "hvd_serve_workers", "Serving workers by pull-rotation state",
    labels=("state",))

#: Completed-but-unfetched results kept before dropping the oldest (a
#: client that never fetches must not grow driver memory forever).
_RESULT_CACHE = 4096

#: Completed-request ids remembered for requeue/late-push dedup.  The
#: dedup window only has to outlive a lease (the longest a stale
#: sibling can still push), so an LRU bound keeps a job-lifetime plane
#: at constant memory — like _RESULT_CACHE beside it.
_COMPLETED_CACHE = 4 * _RESULT_CACHE

#: Cap on one serve_pull/serve_result long-poll hold.
_MAX_HOLD_S = 30.0


class _Lease:
    __slots__ = ("batch", "worker", "t_dispatch", "expires")

    def __init__(self, batch: Batch, worker: str, t_dispatch: float,
                 expires: float):
        self.batch = batch
        self.worker = worker
        self.t_dispatch = t_dispatch
        self.expires = expires


class _WorkerState:
    __slots__ = ("ewma", "observations", "rotated", "rotated_at",
                 "metrics_port", "last_pull", "kv")

    def __init__(self):
        self.ewma = 0.0
        self.observations = 0
        self.rotated = False
        self.rotated_at: Optional[float] = None
        self.metrics_port: Optional[int] = None
        self.last_pull = 0.0
        # last paged-KV ledger the worker rode along on serve_push
        # (None for dense-cache workers)
        self.kv: Optional[dict] = None


#: Rotation noise floor (seconds): a worker is never rotated while its
#: service EWMA sits under this, however fast its peers are — on a
#: lightly loaded fleet the peer median approaches zero and scheduler
#: jitter alone would otherwise evict healthy workers.
_STRAGGLER_MIN_S = 0.05


class ServingPlane:
    """The driver-side serving data plane (one per job).

    Construction defaults resolve from the validated ``HOROVOD_SERVE_*``
    environment contract (config.py / docs/env.md); keyword arguments
    override per instance.  ``start()`` is implicit; ``close()`` stops
    the admission tick and the lease reaper and makes every parked
    ``serve_pull`` return ``{"stop": true}`` so workers drain.
    """

    def __init__(self, cfg: Optional[Config] = None,
                 tick_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 seq_buckets: Optional[str] = None,
                 batch_buckets: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 lease_s: Optional[float] = None,
                 straggler_factor: Optional[float] = None):
        cfg = cfg or Config.from_env()
        from .shapes import parse_buckets, parse_mp_axes
        seq = parse_buckets(seq_buckets or cfg.serve_seq_buckets,
                            "HOROVOD_SERVE_SEQ_BUCKETS")
        cap = int(max_batch if max_batch is not None
                  else cfg.serve_max_batch)
        batches = parse_buckets(
            batch_buckets or cfg.serve_batch_buckets
            or ",".join(str(b) for b in _default_batch_buckets(cap)),
            "HOROVOD_SERVE_BATCH_BUCKETS")
        if batches[-1] < cap:
            raise ValueError(
                f"largest batch bucket {batches[-1]} < batch cap {cap}: "
                f"the cap must be a servable shape")
        self.mp_axis, mp_degree = parse_mp_axes(cfg.serve_mp_axes)
        self.buckets = ShapeBuckets(
            batches, seq,
            mp_degrees=(1,) if mp_degree == 1 else (1, mp_degree))
        self.deadline_s = (deadline_ms if deadline_ms is not None
                           else cfg.serve_deadline_ms) / 1000.0
        self.lease_s = float(lease_s if lease_s is not None
                             else cfg.serve_lease_s)
        self.straggler_factor = float(
            straggler_factor if straggler_factor is not None
            else cfg.serve_straggler_factor)
        self._cv = threading.Condition()
        self._leases: Dict[int, _Lease] = {}
        self._workers: Dict[str, _WorkerState] = {}
        self._done: "OrderedDict[str, dict]" = OrderedDict()
        self._completed_ids: "OrderedDict[str, None]" = OrderedDict()
        self._closed = False
        self.completed = 0
        self.rotations = 0
        # the queue shares the plane's Condition: a submit wakes parked
        # serve_pull long-polls directly, and batches bind at pull time
        # (late binding — see admission.py)
        self._queue = AdmissionQueue(
            self.buckets,
            tick_s=(tick_ms if tick_ms is not None
                    else cfg.serve_tick_ms) / 1000.0,
            on_expired=self._on_expired, max_batch=cap, cv=self._cv)
        self._reaper = threading.Thread(
            target=self._reap_leases, name="hvd-serve-leases", daemon=True)
        self._reaper.start()
        from . import register as _register
        _register("plane", self)

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        from . import unregister as _unregister
        _unregister(self)

    def set_max_batch(self, max_batch: int):
        """Runtime batch-cap change (the sequential-baseline switch the
        bench A/B uses; cap 1 = one request per forward)."""
        self._queue.set_max_batch(max_batch)

    # -- admission ----------------------------------------------------------
    def submit(self, tokens, request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> str:
        """Admit one request; returns its id.  Raises ValueError when
        the request cannot be served inside the shape buckets."""
        rid = request_id or uuid.uuid4().hex
        arr = np.asarray(tokens, dtype=np.int32).reshape(-1)
        now = time.monotonic()
        dl = deadline_s if deadline_s is not None else self.deadline_s
        req = ServeRequest(
            id=rid, tokens=arr, arrival=now,
            deadline=(now + dl) if dl and dl > 0 else None,
            seq_bucket=0)
        try:
            self._queue.submit(req)
        except ValueError:
            if _metrics.ACTIVE:
                _m_requests.inc(outcome="rejected")
            raise
        if _metrics.ACTIVE:
            _m_depth.set(self._queue.depth())
        return rid

    def _on_expired(self, req: ServeRequest):
        if _metrics.ACTIVE:
            _m_requests.inc(outcome="expired")
            _m_depth.set(self._queue.depth())
        self._finish(req.id, {"done": True, "expired": True,
                              "latency_s": round(
                                  time.monotonic() - req.arrival, 6)})

    # -- worker data path ---------------------------------------------------
    def _worker(self, wid: str) -> _WorkerState:
        w = self._workers.get(wid)
        if w is None:
            w = self._workers[wid] = _WorkerState()
            self._update_worker_gauges()
        return w

    def pull(self, worker: str, wait_s: float = 5.0,
             metrics_port: Optional[int] = None) -> dict:
        """One worker long-poll: parks up to ``wait_s`` for a ready
        micro-batch.  Rotated workers get ``{"empty", "rotated"}`` so a
        straggler drains its in-flight work but receives no more."""
        deadline = time.monotonic() + min(max(wait_s, 0.0), _MAX_HOLD_S)
        with self._cv:
            w = self._worker(worker)
            w.last_pull = time.monotonic()
            if metrics_port is not None:
                w.metrics_port = int(metrics_port)
            while True:
                if self._closed:
                    return {"stop": True}
                if w.rotated:
                    return {"empty": True, "rotated": True}
                batch = self._queue.take()
                if batch is not None:
                    now = time.monotonic()
                    self._leases[batch.batch_id] = _Lease(
                        batch, worker, now, now + self.lease_s)
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"empty": True}
                # pending-but-inside-its-tick: re-check at the tick so
                # an aging partial batch dispatches on time; otherwise
                # park until a submit notifies
                self._cv.wait(min(remaining, self._queue.tick_s or
                                  remaining)
                              if self._queue.has_pending()
                              else remaining)
        rows = [r.tokens for r in batch.requests]
        tokens, lengths = self.buckets.pad_batch(rows, batch.seq_bucket)
        now = time.monotonic()
        if _metrics.ACTIVE:
            shape = self.buckets.bucket(len(rows), batch.seq_bucket)
            _m_batches.inc(bucket=shape.key)
            _m_fill.observe(len(rows) / shape.batch)
            for r in batch.requests:
                _m_admission.observe(now - r.arrival)
            _m_depth.set(self._queue.depth())
        return {
            "batch_id": batch.batch_id,
            "seq": batch.seq_bucket,
            "rows": len(rows),
            "tokens": tokens.tolist(),
            "lengths": lengths.tolist(),
            "ids": [r.id for r in batch.requests],
            # per-request age at dispatch: the worker adds its service
            # time so the per-worker latency histogram (merged at
            # /metrics/job) covers the queue wait without sharing a
            # clock with the driver
            "age_s": [round(now - r.arrival, 6) for r in batch.requests],
        }

    def push(self, worker: str, batch_id: int, outputs: List,
             service_s: float = 0.0, kv: Optional[dict] = None) -> dict:
        """Worker batch completion.  A push for an unknown lease (the
        batch was requeued after this worker was declared gone, and a
        sibling already served it) is acknowledged and dropped —
        first completion wins."""
        with self._cv:
            lease = self._leases.pop(int(batch_id), None)
            if kv is not None and worker in self._workers:
                # KV ledger ride-along: stored even on a stale push
                # (the residency snapshot is real either way)
                self._workers[worker].kv = dict(kv)
        if lease is None:
            return {"ok": True, "stale": True}
        now = time.monotonic()
        for i, req in enumerate(lease.batch.requests):
            out = outputs[i] if i < len(outputs) else None
            latency = now - req.arrival
            if _metrics.ACTIVE:
                _m_requests.inc(outcome="completed")
                _m_e2e.observe(latency)
            self._finish(req.id, {"done": True, "output": out,
                                  "worker": worker,
                                  "latency_s": round(latency, 6)})
        with self._cv:
            self.completed += len(lease.batch.requests)
        # scored on the DRIVER-side dispatch->push wall, not the
        # worker's self-reported service time: the score feeds an
        # eviction decision, so it must not trust the evictee's clock
        self._score_worker(worker, now - lease.t_dispatch)
        return {"ok": True}

    def _finish(self, rid: str, result: dict):
        with self._cv:
            if rid in self._completed_ids:
                return   # first completion won (requeue + late sibling)
            self._completed_ids[rid] = None
            while len(self._completed_ids) > _COMPLETED_CACHE:
                self._completed_ids.popitem(last=False)
            self._done[rid] = result
            while len(self._done) > _RESULT_CACHE:
                self._done.popitem(last=False)
            self._cv.notify_all()

    def result(self, rid: str, wait_s: float = 0.0) -> dict:
        """Client result fetch (long-poll).  Fetch consumes the result."""
        deadline = time.monotonic() + min(max(wait_s, 0.0), _MAX_HOLD_S)
        with self._cv:
            while True:
                res = self._done.pop(rid, None)
                if res is not None:
                    return res
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return {"done": False}
                self._cv.wait(remaining)

    def drain(self, wait_s: float = 0.0) -> dict:
        """Fan-in result fetch: long-poll until ANY results are ready,
        then consume and return all of them — one parked call instead
        of one per request, for clients tracking many ids (the bench's
        open-loop collector; a gateway multiplexing users)."""
        deadline = time.monotonic() + min(max(wait_s, 0.0), _MAX_HOLD_S)
        with self._cv:
            while True:
                if self._done:
                    out, self._done = dict(self._done), OrderedDict()
                    return {"results": out}
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return {"results": {}}
                self._cv.wait(remaining)

    # -- elasticity ---------------------------------------------------------
    def worker_gone(self, worker) -> int:
        """Requeue every lease held by ``worker`` (elastic reaper /
        re-form hook) and drop its pull-rotation state — a dead
        worker's stale EWMA must not drag the straggler peer median,
        and churn must not accrete ghost worker entries.  Returns the
        number of requests requeued."""
        with self._cv:
            if self._workers.pop(str(worker), None) is not None:
                self._update_worker_gauges()
        return self._requeue_leases(
            lambda lease: lease.worker == str(worker), "worker_gone")

    def retain_workers(self, live) -> int:
        """Re-form hook: requeue leases of every worker NOT in ``live``
        (the new epoch's membership) — in-flight requests of preempted
        workers are re-queued, not dropped — and drop departed
        workers' rotation state (see :meth:`worker_gone`)."""
        keep = {str(w) for w in live}
        with self._cv:
            gone = [wid for wid in self._workers if wid not in keep]
            for wid in gone:
                del self._workers[wid]
            if gone:
                self._update_worker_gauges()
        return self._requeue_leases(
            lambda lease: lease.worker not in keep, "reform")

    def _requeue_leases(self, pred, reason: str) -> int:
        with self._cv:
            gone = [bid for bid, lease in self._leases.items()
                    if pred(lease)]
            requests: List[ServeRequest] = []
            for bid in gone:
                requests.extend(self._leases.pop(bid).batch.requests)
            requests = [r for r in requests
                        if r.id not in self._completed_ids]
        if requests:
            self._queue.requeue(requests)
            if _metrics.ACTIVE:
                _m_requeued.inc(len(requests), reason=reason)
                _m_depth.set(self._queue.depth())
            logger.warning("serving: requeued %d in-flight requests "
                           "(%s)", len(requests), reason)
        return len(requests)

    def _reap_leases(self):
        while True:
            with self._cv:
                if self._closed:
                    return
                self._cv.wait(timeout=max(self.lease_s / 4, 0.05))
                if self._closed:
                    return
            now = time.monotonic()
            n = self._requeue_leases(
                lambda lease: now > lease.expires, "lease_expired")
            if n and _metrics.RECORDING:
                _metrics.event("serve.lease_expired", requeued=n)
            # deadlines must fire even with no worker pulling
            self._queue.sweep_expired(now)

    # -- straggler rotation -------------------------------------------------
    def _score_worker(self, wid: str, service_s: float):
        """EWMA the worker's batch service time; rotate it out of the
        pull rotation when it is ``straggler_factor`` x slower than the
        median of its active peers (>= 3 observations, >= 2 active
        workers, and never the last active worker)."""
        if service_s <= 0:
            return
        rotated = None
        with self._cv:
            w = self._worker(wid)
            w.ewma = (service_s if w.observations == 0
                      else 0.7 * w.ewma + 0.3 * service_s)
            w.observations += 1
            if (self.straggler_factor > 0 and not w.rotated
                    and w.observations >= 3
                    and w.ewma > _STRAGGLER_MIN_S):
                peers = sorted(
                    p.ewma for k, p in self._workers.items()
                    if k != wid and not p.rotated and p.observations >= 1)
                if peers and w.ewma > (self.straggler_factor
                                       * peers[len(peers) // 2]):
                    w.rotated = True
                    w.rotated_at = time.monotonic()
                    self.rotations += 1
                    rotated = (w.ewma, peers[len(peers) // 2])
                    self._update_worker_gauges()
                    self._cv.notify_all()   # wake its parked pull
        if rotated is not None:
            logger.warning(
                "serving: worker %s rotated out as straggler (ewma "
                "%.3fs vs peer median %.3fs x factor %.1f)", wid,
                rotated[0], rotated[1], self.straggler_factor)
            if _metrics.RECORDING:
                _metrics.event("serve.straggler_rotated", worker=wid,
                               ewma=round(rotated[0], 4))

    def _update_worker_gauges(self):
        if _metrics.ACTIVE:
            _m_workers.set(sum(1 for w in self._workers.values()
                               if not w.rotated), state="active")
            _m_workers.set(sum(1 for w in self._workers.values()
                               if w.rotated), state="rotated")

    def worker_endpoints(self, addr: str = "127.0.0.1"
                         ) -> Dict[str, Tuple[str, int]]:
        """``{worker: (addr, metrics_port)}`` of workers that announced
        a metrics port on pull — the /metrics/job-shaped merge input."""
        with self._cv:
            return {wid: (addr, w.metrics_port)
                    for wid, w in self._workers.items()
                    if w.metrics_port}

    # -- RPC surface --------------------------------------------------------
    def rpc_handlers(self) -> Dict[str, "callable"]:
        """The serving data path as JsonRpcServer handlers — attach to
        the elastic driver's control server
        (``ElasticDriver.attach_serving``) or host standalone."""
        def serve_submit(payload):
            reqs = payload.get("requests")
            if reqs is None:
                reqs = [payload]
            ids = []
            for r in reqs:
                try:
                    ids.append(self.submit(
                        r["tokens"], request_id=r.get("id"),
                        deadline_s=(r["deadline_ms"] / 1000.0
                                    if r.get("deadline_ms") is not None
                                    else None)))
                except ValueError as e:
                    ids.append(None)
                    logger.warning("serving: rejected request: %s", e)
            return {"ok": True, "ids": ids}

        def serve_pull(payload):
            return self.pull(str(payload["worker"]),
                             wait_s=float(payload.get("wait_s", 5.0)),
                             metrics_port=payload.get("metrics_port"))

        def serve_push(payload):
            return self.push(str(payload["worker"]),
                             int(payload["batch_id"]),
                             payload.get("outputs") or [],
                             service_s=float(
                                 payload.get("service_s", 0.0)),
                             kv=payload.get("kv"))

        def serve_result(payload):
            return self.result(str(payload["id"]),
                               wait_s=float(payload.get("wait_s", 0.0)))

        def serve_drain(payload):
            return self.drain(wait_s=float(payload.get("wait_s", 0.0)))

        return {"serve_submit": serve_submit, "serve_pull": serve_pull,
                "serve_push": serve_push, "serve_result": serve_result,
                "serve_drain": serve_drain}

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        q = self._queue.stats()
        with self._cv:
            workers = {
                wid: {"ewma_s": round(w.ewma, 6),
                      "observations": w.observations,
                      "rotated": w.rotated,
                      "rotated_at": w.rotated_at,
                      "kv": w.kv}
                for wid, w in sorted(self._workers.items())}
            kv_totals = None
            ledgers = [w.kv for w in self._workers.values() if w.kv]
            if ledgers:
                kv_totals = {
                    k: sum(int(led.get(k, 0)) for led in ledgers)
                    for k in ("in_use", "cached", "free", "reuse_hits",
                              "bytes_in_use", "bytes_capacity")}
            return {
                "queue": q,
                "completed": self.completed,
                "in_flight": sum(len(le.batch.requests)
                                 for le in self._leases.values()),
                "leases": len(self._leases),
                "leased_workers": sorted({le.worker for le
                                          in self._leases.values()}),
                "rotations": self.rotations,
                "workers": workers,
                "kv": kv_totals,
                "buckets": {
                    "batch": list(self.buckets.batch_buckets),
                    "seq": list(self.buckets.seq_buckets),
                    "mp": list(getattr(self.buckets, "mp_degrees", (1,)))},
            }


def _default_batch_buckets(cap: int) -> List[int]:
    """Powers of two up to ``cap`` (cap itself always included)."""
    out = []
    b = 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out
