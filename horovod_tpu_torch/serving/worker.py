"""Worker-side serving loop: pull a micro-batch, run the bucketed forward,
push the outputs.

Pure data parallelism: every worker owns a full replica and serves its
batches independently — the forward NEVER negotiates a collective, so
a straggling or dying worker stalls only its own leases, which the plane requeues.  The pull is a long-poll
over the keep-alive RPC pool (one parked request, not a poll tick —
the control-plane watch transport's shape applied to the data path).

Per-request latency is observed HERE, per worker: the pulled batch
carries each request's age at dispatch (driver clock) and the worker
adds its own service time — no cross-host clock needed — feeding
``hvd_serve_request_latency_seconds`` on this worker's ``GET /metrics``,
which the driver's ``GET /metrics/job`` merges bucket-wise into the
job-level p50/p99.

Counterpart: ``horovod_tpu/serving/worker.py``.  ``ServingWorker`` is
copied.  ``BucketedForward`` keeps its contract and its ``stats()`` keys
for an eager forward, which has no compile to count: a shape outside the
buckets raises, a bucket's first call allocates its device buffers (its
"compile"), ``warmup()`` runs every bucket once, and ``recompiles``
counts a bucket prepared again after it was seen.  ``MeshSlicedForward``
(model-parallel serving) waits for ROADMAP.md A6.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .. import chaos as _chaos
from .. import metrics as _metrics
from ..runner.rpc import json_request

logger = logging.getLogger("horovod_tpu_torch")

# -- metric families (docs/metrics.md; sites guard on _metrics.ACTIVE) --------
_m_latency = _metrics.histogram(
    "hvd_serve_request_latency_seconds",
    "Per-request serving latency (queue age at dispatch + worker "
    "service time).  lo=-13: sub-ms requests must resolve — the "
    "2^-10 tail-lateness floor cannot (tests/test_serving.py)",
    lo=-13, hi=7)
_m_forward = _metrics.histogram(
    "hvd_serve_forward_seconds",
    "Wall time of one bucketed batched forward", lo=-13, hi=4)
_m_recompiles = _metrics.counter(
    "hvd_serve_recompiles_total",
    "Buckets prepared again after they were seen (their buffers "
    "allocated anew) — steady-state serving must keep this at 0")
_m_cache_size = _metrics.gauge(
    "hvd_serve_compile_cache_size",
    "Shape buckets whose device buffers the serving forward holds")


class BucketedForward:
    """A forward restricted to the admitted shape buckets.

    ``fn(bufs) -> tensor`` reads the micro-batch from ``bufs``, the
    bucket's device buffers: ``bufs["tokens"]`` [B, S] and
    ``bufs["lengths"]`` [B] (int64, copied in from the host arrays of
    each call), plus whatever ``prepare((B, S))`` allocated for the
    bucket (a dense KV cache, say).  The buffers are allocated on a
    bucket's first call and reused by every later one, as JAX reuses a
    bucket's compiled program.  Calls outside the bucket set raise; a
    bucket prepared again after it was seen (its buffers were dropped)
    counts in ``recompiles`` and ``hvd_serve_recompiles_total``, the
    steady-state invariant.
    """

    def __init__(self, fn: Callable, buckets=None, device: DeviceLike = None,
                 prepare: Optional[Callable] = None):
        self._fn = fn
        self._prepare = prepare
        self._buckets = buckets
        self.device = resolve_device(device)
        self._bufs: Dict[Tuple[int, int], dict] = {}
        self._seen: set = set()
        self.calls = 0
        self.compiles = 0
        self.recompiles = 0

    def _check_bucket(self, shape):
        if self._buckets is None:
            return
        b, s = shape
        if (b not in self._buckets.batch_buckets
                or s not in self._buckets.seq_buckets):
            raise ValueError(
                f"forward called outside the shape buckets: {shape} "
                f"not in {self._buckets.batch_buckets} x "
                f"{self._buckets.seq_buckets} (every recompile is a "
                f"p99 outlier)")

    def _bucket(self, shape, inputs: Dict[str, np.ndarray]) -> dict:
        """The bucket's buffers, prepared on its first call."""
        bufs = self._bufs.get(shape)
        if bufs is not None:
            return bufs
        bufs = {name: torch.empty(np.shape(a), dtype=torch.long,
                                  device=self.device)
                for name, a in inputs.items()}
        if self._prepare is not None:
            bufs.update(self._prepare(shape))
        self._bufs[shape] = bufs
        self.compiles += 1
        if shape in self._seen:
            self.recompiles += 1
            if _metrics.ACTIVE:
                _m_recompiles.inc()
            logger.warning("serving: prepared already-seen shape %s "
                           "again", shape)
        self._seen.add(shape)
        if _metrics.ACTIVE:
            _m_cache_size.set(len(self._bufs))
        return bufs

    def _run(self, shape, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """Copy the host arrays into the bucket's buffers, run ``fn``,
        and return its output on the host (shared by the paged
        subclass, whose inputs add the block tables)."""
        bufs = self._bucket(shape, inputs)
        for name, a in inputs.items():
            bufs[name].copy_(torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int64)))
        out = self._fn(bufs)
        self.calls += 1
        return out.cpu().numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out)

    def __call__(self, tokens: np.ndarray, lengths: np.ndarray):
        shape = tuple(np.shape(tokens))
        self._check_bucket(shape)
        return self._run(shape, {"tokens": tokens, "lengths": lengths})

    def warmup(self) -> int:
        """Run every admitted shape bucket once up front (the deploy-time
        preparation real serving does): after this, preparing a bucket
        is by definition a recompile — the gated invariant.  Returns the
        number of shapes prepared."""
        if self._buckets is None:
            return 0
        n = 0
        for b in self._buckets.batch_buckets:
            for s in self._buckets.seq_buckets:
                if (b, s) not in self._seen:
                    self(np.zeros((b, s), np.int32),
                         np.ones((b,), np.int32))
                    n += 1
        return n

    def stats(self) -> Dict[str, int]:
        return {"calls": self.calls, "compiles": self.compiles,
                "recompiles": self.recompiles,
                "shapes_seen": len(self._seen)}


class MeshSlicedForward(BucketedForward):
    """Llama decode over a model-parallel mesh slice: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "model-parallel serving (MeshSlicedForward, "
            "HOROVOD_SERVE_MP_AXES) is not ported yet (ROADMAP.md A6)")


class ServingWorker:
    """Pull-loop worker: ``serve_pull`` -> forward -> ``serve_push``.

    ``forward`` maps ``(tokens [B, S] int32, lengths [B] int32)`` to an
    output array whose leading dim is B (a :class:`BucketedForward` or
    any callable).  Runs on a daemon thread (``start()``); exits when
    the plane replies ``{"stop"}`` or ``stop()`` is called.  Transport
    failures back off and retry — mid-re-form the driver is briefly
    unreachable and the worker must ride it out, not die.
    """

    def __init__(self, addr: str, port: int, forward: Callable,
                 worker_id: str = "0", wait_s: float = 5.0,
                 secret=None, metrics_port: Optional[int] = None,
                 warmup: bool = False):
        self.addr = addr
        self.port = port
        self.forward = forward
        self.worker_id = str(worker_id)
        self.wait_s = float(wait_s)
        self._secret = secret
        self._metrics_port = metrics_port
        self._warmup = warmup
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches = 0
        self.rows = 0
        self.pulls = 0
        from . import register as _register
        _register("worker", self)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self.run, name=f"hvd-serve-worker-{self.worker_id}",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout)

    def run(self):
        try:
            if self._warmup:
                # pre-compile the shape set BEFORE the first pull:
                # compile latency must never ride a request (it would
                # both blow that request's p99 and pollute this
                # worker's straggler score with a one-time cost)
                wu = getattr(self.forward, "warmup", None)
                if callable(wu):
                    n = wu()
                    logger.info("serving worker %s warmed %d shapes",
                                self.worker_id, n)
            while not self._stop.is_set():
                if not self._serve_once():
                    break
        finally:
            from . import unregister as _unregister
            _unregister(self)

    # -- one pull/forward/push round ----------------------------------------
    def _serve_once(self) -> bool:
        try:
            payload = {"worker": self.worker_id, "wait_s": self.wait_s}
            if self._metrics_port:
                payload["metrics_port"] = self._metrics_port
            batch = json_request(
                self.addr, self.port, "serve_pull", payload,
                timeout=self.wait_s + 10.0, secret=self._secret,
                retries=0)
        except Exception:  # noqa: BLE001 - driver mid-re-form/gone
            logger.debug("serve_pull failed; backing off", exc_info=True)
            if self._stop.wait(0.2):
                return False
            return True
        if batch.get("stop"):
            return False
        if batch.get("empty"):
            if batch.get("rotated"):
                # rotated out of the pull rotation: stay alive (the
                # operator may clear the rotation) but stop hammering
                self._stop.wait(0.5)
            return True
        self.pulls += 1
        tokens = np.asarray(batch["tokens"], np.int32)
        lengths = np.asarray(batch["lengths"], np.int32)
        n_rows = int(batch["rows"])
        t0 = time.monotonic()
        if _chaos.ACTIVE:
            # serve.batch: deterministic per-worker service faults
            # (delay = a straggling replica the rotation must catch;
            # error/crash = a dying worker whose lease must requeue).
            # Inside the service clock: an injected slow forward must
            # look slow to the latency histogram and the plane's
            # straggler score, exactly like a real one
            _chaos.fire("serve.batch", worker=self.worker_id,
                        batch=batch["batch_id"], rows=n_rows)
        if getattr(self.forward, "wants_rows", False):
            # paged forward: pad rows must not allocate KV blocks
            out = self.forward(tokens, lengths, n_rows=n_rows)
        else:
            out = self.forward(tokens, lengths)
        service = time.monotonic() - t0
        self.batches += 1
        self.rows += n_rows
        if _metrics.ACTIVE:
            _m_forward.observe(service)
            for age in batch["age_s"][:n_rows]:
                _m_latency.observe(float(age) + service)
        outputs = np.asarray(out)[:n_rows].tolist()
        push = {"worker": self.worker_id,
                "batch_id": batch["batch_id"],
                "outputs": outputs,
                "service_s": round(service, 6)}
        kv = getattr(self.forward, "kv_summary", None)
        if callable(kv):
            # paged-KV ledger rides the push: the plane's
            # GET /serve/stats shows per-worker block residency without
            # a second scrape path
            push["kv"] = kv()
        try:
            json_request(
                self.addr, self.port, "serve_push", push,
                timeout=10.0, secret=self._secret, idempotent=False)
        except Exception:  # noqa: BLE001 - lease reaper covers the loss
            logger.warning("serve_push failed; plane will requeue the "
                           "lease", exc_info=True)
        return True

    def stats(self) -> dict:
        out = {"worker": self.worker_id, "pulls": self.pulls,
               "batches": self.batches, "rows": self.rows}
        fwd_stats = getattr(self.forward, "stats", None)
        if callable(fwd_stats):
            out["forward"] = fwd_stats()
        return out
