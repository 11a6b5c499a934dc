"""hvdhealth: training-health telemetry — numerics taps, a cross-replica
divergence sentinel, and a job health verdict.

Counterpart: ``horovod_tpu/health/__init__.py``, copied and adapted to
the port's world model (one process a device, no stacked mode: the
worker an observation names is this process's rank).  The port's data
plane is deliberately lossy (the block-scaled int8/fp8 wire with error
feedback, the bounded and stale tail rounds); this package watches the
**values** that go through it.  Four layers:

* **numerics taps** (:mod:`.taps`) — per-bucket gradient stats (l2,
  max-abs, nonfinite count; the residual norm under a quantized wire;
  staleness counters under ``tail_policy=stale``) over the flat bucket
  buffers of ``optim/distributed.py`` (kept on the device and copied to
  the host once a step) and at the engine's fused dispatch;
* **divergence sentinel** — per-bucket param/opt-state checksums
  (float sum + bit-pattern xor) allgathered every
  ``HOROVOD_HEALTH_CHECK_EVERY`` steps and compared across the replicas;
* **evaluator** (:mod:`.evaluate`) — edge-triggered verdicts
  (nonfinite, grad explosion vs EWMA, loss spike, residual drift,
  replica desync, staleness saturation, SLO breach) with (worker,
  bucket, step) attribution, feeding metric families, the flight
  recorder, and the ``on_unhealthy`` hook;
* **job exposition** — the worker's ``health_pull`` RPC, ``GET
  /health`` on every ``JsonRpcServer`` and the elastic driver's ``GET
  /health/job`` merging per-worker verdicts into ONE job verdict,
  printed by ``python -m horovod_tpu_torch.health``.

Hot-path discipline: the monitoring plane guards on ``health.ACTIVE`` —
one attribute load and a false branch under ``HOROVOD_HEALTH=0``.  The
transform's taps are opt-in (``HOROVOD_HEALTH_TAPS=1`` or
``DistributedGradientTransform(health=True)``), and ``HOROVOD_HEALTH=0``
silences a tap-armed transform's deliveries at run time.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

from .evaluate import HealthEvaluator, Verdict  # noqa: F401

logger = logging.getLogger("horovod_tpu_torch")

ENV_ENABLE = "HOROVOD_HEALTH"
ENV_TAPS = "HOROVOD_HEALTH_TAPS"
ENV_CHECK_EVERY = "HOROVOD_HEALTH_CHECK_EVERY"
ENV_GRAD_FACTOR = "HOROVOD_HEALTH_GRAD_FACTOR"
ENV_LOSS_FACTOR = "HOROVOD_HEALTH_LOSS_FACTOR"
ENV_RESIDUAL_FACTOR = "HOROVOD_HEALTH_RESIDUAL_FACTOR"

#: Sentinel: resolve the RPC signing secret from the environment (the
#: driver default); ``secret=None`` for unauthenticated test servers.
_ENV = object()


def _env_on(name: str, default: bool = True, environ=os.environ) -> bool:
    from ..config import _env_bool  # one truthy grammar codebase-wide
    return _env_bool(name, default, environ)


#: Hot-path guard (one false branch when HOROVOD_HEALTH=0): gates the
#: engine's dispatch taps, the transform taps' host deliveries, and the
#: evaluator's exposition.
ACTIVE = _env_on(ENV_ENABLE)

_EVALUATOR: Optional[HealthEvaluator] = None
_EV_LOCK = threading.Lock()


def _env_float(name: str, default: float) -> float:
    # import-time degrade (metrics/tracing precedent: a malformed env
    # value must not kill `import horovod_tpu_torch`) — but WARN, and
    # note that Config.from_env validates the same variable loudly
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        logger.warning("invalid %s=%r; using %g (hvd.init() would "
                       "reject it)", name, os.environ.get(name), default)
        return default


def _thresholds():
    """(grad, loss, residual) verdict factors: the validated runtime
    Config when one is live (so programmatic Config values are
    honored, like health_taps/check_every), else the raw env with the
    same > 1 bar applied (a bar at or below the baseline would fire on
    every step — Config.from_env refuses it; a direct-env evaluator
    must not accept it either)."""
    try:
        from .. import runtime
        cfg = runtime._state().config
    except Exception:  # noqa: BLE001 - importable without runtime
        cfg = None
    if cfg is not None:
        return (cfg.health_grad_factor, cfg.health_loss_factor,
                cfg.health_residual_factor)
    out = []
    for name, default in ((ENV_GRAD_FACTOR, 10.0),
                          (ENV_LOSS_FACTOR, 4.0),
                          (ENV_RESIDUAL_FACTOR, 4.0)):
        v = _env_float(name, default)
        if v <= 1.0:
            logger.warning("%s=%r is <= 1 (would fire every step); "
                           "using the default %g", name, v, default)
            v = default
        out.append(v)
    return tuple(out)


def evaluator() -> HealthEvaluator:
    """The process-wide evaluator (what ``health_pull`` serves).
    Created lazily with the config/env-configured thresholds."""
    global _EVALUATOR
    with _EV_LOCK:
        if _EVALUATOR is None:
            grad, loss, residual = _thresholds()
            _EVALUATOR = HealthEvaluator(
                grad_factor=grad, loss_factor=loss,
                residual_factor=residual)
        return _EVALUATOR


def swap_evaluator(ev: HealthEvaluator) -> HealthEvaluator:
    """Replace the default evaluator, returning the old one (tests:
    isolates a scenario's verdicts; every delivery path resolves the
    module default per call, so the swap takes effect immediately)."""
    global _EVALUATOR
    with _EV_LOCK:
        old, _EVALUATOR = _EVALUATOR, ev
    return old if old is not None else ev


def check_every(environ=os.environ) -> int:
    """Divergence-sentinel cadence (``HOROVOD_HEALTH_CHECK_EVERY``,
    steps; default 32, floored at 1)."""
    try:
        return max(int(environ.get(ENV_CHECK_EVERY, "32") or 32), 1)
    except ValueError:
        logger.warning("invalid %s=%r; using 32 (hvd.init() would "
                       "reject it)", ENV_CHECK_EVERY,
                       environ.get(ENV_CHECK_EVERY))
        return 32


#: Engine tap sampling cadence (HOROVOD_HEALTH_CHECK_EVERY — the
#: sentinel's knob doubles here): the engine tap costs a device→host
#: copy of its stats, so it observes cycles 1, 1+N, 1+2N, ... instead
#: of every dispatch.  The transform's taps observe every update.
#: Refreshed in init_from_env; 1 = observe every dispatch.
SAMPLE_EVERY = check_every()


def taps_default(environ=os.environ) -> bool:
    """Whether the transform's taps default ON for transforms built
    without an explicit ``health=`` (``HOROVOD_HEALTH_TAPS``, default 0 —
    the taps add reductions and a host copy to every update, so they are
    an opt-in like HOROVOD_SHARDED_UPDATE; the master HOROVOD_HEALTH=0
    vetoes)."""
    return ACTIVE and _env_on(ENV_TAPS, False, environ)


def enable():
    global ACTIVE
    ACTIVE = True


def disable():
    global ACTIVE
    ACTIVE = False


def note_loss(value, step: Optional[int] = None):
    """Feed one training-loss observation into the loss-spike check
    (the user training loop's one-line hook)."""
    if ACTIVE:
        evaluator().note_loss(value, step=step)


def on_unhealthy(callback):
    """Register ``callback(verdict_dict)`` fired on every NEW verdict
    (edge-triggered).  Replaces any previous hook; pass None to clear."""
    evaluator().on_unhealthy = callback


def set_identity(process: Optional[int] = None,
                 host: Optional[str] = None):
    ev = evaluator()
    if process is not None:
        ev.process = int(process)
    if host:
        ev.host = str(host)


def init_from_env(environ=os.environ):
    """Apply the HOROVOD_HEALTH* contract (called from ``hvd.init()``;
    idempotent across elastic re-inits — verdict history survives, a
    post-mortem scrape wants it)."""
    global ACTIVE, SAMPLE_EVERY
    ACTIVE = _env_on(ENV_ENABLE, environ=environ)
    SAMPLE_EVERY = check_every(environ)
    with _EV_LOCK:
        live = _EVALUATOR
    if live is not None:
        # an evaluator created before init() (module-level dispatch)
        # picks up the now-live validated Config thresholds; verdict
        # history is deliberately untouched
        live.grad_factor, live.loss_factor, live.residual_factor = \
            _thresholds()


# ---------------------------------------------------------------------------
# engine tap (ops/engine.py dispatch; guarded on health.ACTIVE)
# ---------------------------------------------------------------------------

def engine_observe(step: int, bucket_id: int, name: str, tensors,
                   process: int):
    """Numerics tap over one fused engine dispatch's LOCAL input tensors
    (this process's pre-collective contribution); ``step`` is the engine
    cycle count — the eager path's step analog — and ``process`` this
    process's rank, the worker the observation names.  The stats are
    reduced on the tensors' device and copied to the host once (the
    engine thread pays that sync, sampled at the call site, never the
    submitter); HOROVOD_HEALTH=0 removes the call entirely (engine
    guard)."""
    import torch

    from .taps import bucket_stats
    floats = [t.reshape(-1) for t in tensors
              if torch.is_tensor(t) and t.is_floating_point()]
    if not floats:
        return
    stats = [torch.stack([s.float() for s in bucket_stats(t)])
             for t in floats]
    rows = torch.stack(stats).cpu().double()   # [n, (l2, max, nonf)]
    l2_sq = float((rows[:, 0] ** 2).sum())
    max_abs = float(rows[:, 1].max())
    nonf = int(rows[:, 2].sum())
    evaluator().ingest_bucket(int(step), int(process), int(bucket_id),
                              str(name), l2_sq ** 0.5, max_abs, nonf)


def note_staleness(name: str, counters, cap: int):
    """The tail round's staleness feed (``ops/collectives.tail_round``
    guards on health.ACTIVE)."""
    ev = evaluator()
    ev.ingest_staleness(max(ev._last_step, 0), name,
                        [int(c) for c in counters], cap)


# ---------------------------------------------------------------------------
# exposition: health_pull RPC, GET /health, GET /health/job
# ---------------------------------------------------------------------------

def pull_handler(payload):
    """``JsonRpcServer`` POST handler over the CURRENT evaluator
    (resolved per call so ``swap_evaluator`` takes effect).  The
    payload carries ``enabled``: a worker running HOROVOD_HEALTH=0
    ingests nothing and its snapshot is VACUOUSLY healthy — the job
    merge must be able to tell that from a monitored healthy worker."""
    return local_health()


def local_health() -> dict:
    """This process's snapshot (``GET /health`` on any server and the
    ``health_pull`` reply)."""
    snap = evaluator().snapshot()
    snap["enabled"] = ACTIVE
    return snap


def merge_job_health(workers: Dict[str, dict],
                     unreachable: Optional[Dict[str, str]] = None
                     ) -> dict:
    """Merge per-worker ``health_pull`` snapshots into ONE job verdict.

    ``healthy`` = every scraped worker healthy and nothing unreachable;
    ``unhealthy`` = at least one ACTIVE (currently-firing) condition
    somewhere — historical verdicts ride the merged ``verdicts`` list
    (each with its source ``worker_id``) as evidence but do NOT hold
    the job unhealthy after the condition cleared, or a single
    transient spike would stick the verdict forever; ``degraded`` = no
    active conditions but some workers were unreachable (the view is
    partial — mid-churn, exactly when it matters)."""
    unreachable = dict(unreachable or {})
    merged_verdicts = []
    counts: Dict[str, int] = {}
    active = 0
    unmonitored = []
    stragglers: Dict[str, float] = {}
    for wid in sorted(workers):
        snap = workers[wid]
        if not snap.get("enabled", True):
            # HOROVOD_HEALTH=0 on that worker: its snapshot is
            # vacuously healthy and must not feed a confident verdict
            unmonitored.append(wid)
        active += len(snap.get("active", ()) or ())
        if not snap.get("healthy", True):
            # belt and braces: a snapshot from an older worker without
            # the active list still drives the verdict
            active = max(active, 1)
        for v in snap.get("verdicts", ()):
            vv = dict(v, worker_id=wid)
            merged_verdicts.append(vv)
            counts[v.get("kind", "?")] = counts.get(
                v.get("kind", "?"), 0) + 1
        for proc, score in (snap.get("straggler_scores") or {}).items():
            # per-peer observations: merge by max across reporters
            stragglers[proc] = max(stragglers.get(proc, 0.0),
                                   float(score))
    if active:
        verdict = "unhealthy"
    elif unreachable or unmonitored:
        # partial view: dead endpoints, or workers whose monitoring is
        # off — "healthy" would be indistinguishable from a genuinely
        # monitored healthy job
        verdict = "degraded"
    else:
        verdict = "healthy"
    merged_verdicts.sort(key=lambda v: (v.get("step", -1),
                                        v.get("wall", 0.0)))
    return {
        "verdict": verdict,
        "scraped": len(workers),
        "workers": {w: {"healthy": workers[w].get("healthy", True),
                        "host": workers[w].get("host", ""),
                        "process": workers[w].get("process", -1),
                        "active": len(workers[w].get("active", ())),
                        "last_step": workers[w].get("last_step", -1)}
                    for w in sorted(workers)},
        "unreachable": {w: str(e)
                        for w, e in sorted(unreachable.items())},
        "unmonitored": unmonitored,
        "verdicts": merged_verdicts,
        "counts": counts,
        "straggler_scores": stragglers,
        "wall": round(time.time(), 3),
    }


def scrape_job_health(endpoints: Dict[str, Tuple[str, int]],
                      timeout: float = 2.0, secret=_ENV) -> dict:
    """Scrape every ``{worker: (addr, port)}`` ``health_pull`` endpoint
    in parallel and merge into one job verdict.  Unreachable workers
    degrade to ``unreachable`` entries, never a failed scrape (the
    shared-deadline fan-out is the unified
    ``metrics.jobscrape.fan_out`` engine; the healthy→degraded verdict
    demotion stays in ``merge_job_health``)."""
    from ..metrics import jobscrape
    from ..runner.rpc import json_request
    kw = {} if secret is _ENV else {"secret": secret}

    def _fetch(worker, addr, port):
        return json_request(addr, port, "health_pull", {},
                            timeout=timeout, retries=0, **kw)

    workers, failed = jobscrape.fan_out(
        endpoints, _fetch, budget=timeout + 1.0,
        wedged="health scrape timed out", name="health")
    return merge_job_health(workers, unreachable=failed)


def render_job_health(job: dict, top: int = 16) -> str:
    """The doctor's verdict table over a merged job-health object."""
    lines = [f"job health: {job['verdict'].upper()}  "
             f"({job.get('scraped', 0)} worker(s) scraped, "
             f"{len(job.get('unreachable') or {})} unreachable)"]
    for w, info in sorted((job.get("workers") or {}).items()):
        state = "ok" if info.get("healthy", True) else "UNHEALTHY"
        lines.append(
            f"  worker {w:<4s} host={info.get('host', '')!s:<12s} "
            f"process={info.get('process', -1)} "
            f"step={info.get('last_step', -1)} {state}")
    for w, err in sorted((job.get("unreachable") or {}).items()):
        lines.append(f"  worker {w:<4s} UNREACHABLE: {err}")
    for w in job.get("unmonitored") or ():
        lines.append(f"  worker {w:<4s} MONITORING OFF "
                     f"(HOROVOD_HEALTH=0 — snapshot vacuously healthy)")
    verdicts = job.get("verdicts") or []
    if verdicts:
        lines.append(f"verdicts ({len(verdicts)}; newest last):")
        lines.append(f"  {'step':>6s}  {'kind':<20s} {'worker':>6s} "
                     f"{'bucket':>6s}  detail")
        for v in verdicts[-top:]:
            lines.append(
                f"  {v.get('step', -1):>6d}  {v.get('kind', '?'):<20s} "
                f"{str(v.get('worker', '?')):>6s} "
                f"{str(v.get('bucket', '-')):>6s}  "
                f"{v.get('detail', '')}")
    else:
        lines.append("verdicts: none")
    scores = job.get("straggler_scores") or {}
    if scores:
        worst = max(scores, key=scores.get)
        lines.append(
            "straggler EWMA (stall inspector, seconds): "
            + " ".join(f"p{p}={s:.3f}" for p, s in sorted(
                scores.items())) + f"  [worst: p{worst}]")
    return "\n".join(lines)


def routes_json() -> str:
    """``GET /health`` body (used by metrics.get_routes)."""
    return json.dumps(local_health(), separators=(",", ":"))
