"""hvdserve: the elastic inference serving plane.

Data-parallel batched inference under the existing control plane: a
driver-side admission queue continuously micro-batches incoming
requests (the engine's ``plan_fusion``/cycle-tick machinery with batch
caps for byte caps and the admission tick for the cycle time —
:mod:`.admission`), pads them to a small fixed set of shape buckets so
steady-state serving never recompiles (:mod:`.shapes`), and hands them
to workers over a ``serve_submit``/``serve_pull``/``serve_push`` RPC
data path on the keep-alive pool (:mod:`.plane`, :mod:`.worker`).
Elastic re-form requeues in-flight requests instead of dropping them,
and per-worker service-time EWMAs rotate chronic stragglers out of the
pull rotation — p99 under churn is the product metric (OptiReduce,
arXiv:2310.06993, applied to serving itself).

Observability: ``hvd_serve_*`` metric families (docs/metrics.md) with
per-worker request-latency histograms merged bucket-wise at the
driver's ``GET /metrics/job``; ``engine.stats()["serving"]``
(docs/observability.md) summarizes whatever serving components live in
this process.  Docs: docs/serving.md; env contract: docs/env.md
``HOROVOD_SERVE_*``; gates on the card: ``chip_smoke.py``'s ``serve``
phase.

This module stays import-light (``engine.stats()`` probes it on every
call): heavy submodules load lazily via attribute access.

Counterpart: ``horovod_tpu/serving/__init__.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import threading
from typing import Dict, List

_lock = threading.Lock()
_components: Dict[str, List] = {"plane": [], "worker": []}

__all__ = [
    "AdmissionQueue", "Batch", "BucketedForward", "ServeRequest",
    "ServingPlane", "ServingWorker", "ShapeBucket", "ShapeBuckets",
    "register", "stats", "unregister",
]

_LAZY = {
    "AdmissionQueue": ("admission", "AdmissionQueue"),
    "Batch": ("admission", "Batch"),
    "ServeRequest": ("admission", "ServeRequest"),
    "ServingPlane": ("plane", "ServingPlane"),
    "ServingWorker": ("worker", "ServingWorker"),
    "BucketedForward": ("worker", "BucketedForward"),
    "ShapeBucket": ("shapes", "ShapeBucket"),
    "ShapeBuckets": ("shapes", "ShapeBuckets"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    mod = importlib.import_module(f".{target[0]}", __name__)
    return getattr(mod, target[1])


def register(kind: str, component) -> None:
    """Track a live plane/worker so ``stats()`` (and through it
    ``engine.stats()["serving"]``) can see it."""
    with _lock:
        _components.setdefault(kind, []).append(component)


def unregister(component) -> None:
    with _lock:
        for comps in _components.values():
            if component in comps:
                comps.remove(component)


def stats() -> dict:
    """Serving stats of THIS process: the plane's queue/lease/worker
    view when a driver-side plane lives here, per-worker pull/forward
    counters when serving workers do.  ``{}`` when neither — the shape
    ``engine.stats()`` keys ``"serving"`` on."""
    with _lock:
        planes = list(_components.get("plane", ()))
        workers = list(_components.get("worker", ()))
    out: dict = {}
    if planes:
        out["plane"] = planes[-1].stats()
    if workers:
        out["workers"] = [w.stats() for w in workers]
    return out
