"""hvdmetrics: unified metrics registry, exposition, and flight recorder.

The stack can trace a job (timeline, merged profiler) and detect a stuck
one (stall inspector); this package lets it *measure* one — counters and
log2-bucketed latency histograms for the engine cycle loop, negotiation
rounds, RPC transport, elastic lifecycle, stall warnings, and chaos
injections — and keeps a crash flight recorder so a dead worker leaves a
black-box recording instead of just a stack trace.

Four exposition paths:

* ``engine.stats()["metrics"]`` — in-process snapshot dict;
* Prometheus text format + ``/healthz`` via GET routes every
  :class:`~horovod_tpu_torch.runner.rpc.JsonRpcServer` serves (drivers and
  workers are scrapeable wherever they already listen; a standalone
  server via ``HOROVOD_METRICS_PORT``);
* ``HOROVOD_METRICS_DUMP=path`` — periodic JSON snapshots;
* the elastic driver's ``/metrics/job`` — every worker scraped and
  merged (histograms summed bucket-wise, gauges as per-worker
  min/max/sum) so one scrape answers "which worker is the straggler".

Hot-path discipline (hvdchaos precedent): every instrumented site
guards on the module flags —

    ``if _metrics.ACTIVE: _m_foo.inc()``        (registry)
    ``if _metrics.RECORDING: _metrics.event(...)``  (flight recorder)

— one attribute load and a false branch when disabled
(``HOROVOD_METRICS=0`` / ``HOROVOD_FLIGHT_RECORDER=0``).  Env table:
docs/env.md; metric families and dump formats: docs/metrics.md.

Beside them, every server's ``/health`` (this process's training-health
snapshot, ``health/``) and ``/timeseries`` (its windowed-delta ring,
``metrics/timeseries.py``, whose sampler and SLO watchdog start here at
``hvd.init()`` and stop at shutdown).

Counterpart: ``horovod_tpu/metrics/__init__.py``, copied.  A per-rank
dump file takes the port runtime's rank when it is initialized, else
``HOROVOD_RANK``.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

from . import aggregate  # noqa: F401  (re-export for driver/tests)
from .flight import DEFAULT_CAPACITY, FlightRecorder
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricRegistry, log2_edges)

logger = logging.getLogger("horovod_tpu_torch")

ENV_ENABLE = "HOROVOD_METRICS"
ENV_PORT = "HOROVOD_METRICS_PORT"
ENV_DUMP = "HOROVOD_METRICS_DUMP"
ENV_DUMP_INTERVAL = "HOROVOD_METRICS_DUMP_INTERVAL_S"
ENV_FLIGHT = "HOROVOD_FLIGHT_RECORDER"
ENV_FLIGHT_CAP = "HOROVOD_FLIGHT_RECORDER_CAPACITY"
ENV_FLIGHT_PATH = "HOROVOD_FLIGHT_RECORDER_PATH"

#: Events from a crashed worker attached to its FAILURE report (and
#: logged by the driver).
FAILURE_REPORT_EVENTS = 200


def _env_on(name: str, default: bool = True, environ=os.environ) -> bool:
    from ..config import _env_bool  # one truthy grammar codebase-wide
    return _env_bool(name, default, environ)


#: Registry hot-path guard (one false branch when disabled).
ACTIVE = _env_on(ENV_ENABLE)
#: Flight-recorder hot-path guard.
RECORDING = _env_on(ENV_FLIGHT)

def _env_capacity() -> int:
    # runs at import of horovod_tpu itself — a malformed value must
    # degrade, never kill the import
    try:
        return int(os.environ.get(ENV_FLIGHT_CAP, "")
                   or DEFAULT_CAPACITY)
    except ValueError:
        logger.warning("invalid %s=%r; using %d", ENV_FLIGHT_CAP,
                       os.environ.get(ENV_FLIGHT_CAP), DEFAULT_CAPACITY)
        return DEFAULT_CAPACITY


_REGISTRY = MetricRegistry()
_FLIGHT = FlightRecorder(capacity=_env_capacity())
_T0 = time.monotonic()


def registry() -> MetricRegistry:
    """The process-wide default registry (instrumented modules declare
    their families here at import)."""
    return _REGISTRY


def counter(name: str, help: str = "", labels=()) -> Counter:
    return _REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels=()) -> Gauge:
    return _REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels=(), lo: int = -17,
              hi: int = 6) -> Histogram:
    return _REGISTRY.histogram(name, help, labels, lo=lo, hi=hi)


def enable():
    global ACTIVE
    ACTIVE = True


def disable():
    global ACTIVE
    ACTIVE = False


def snapshot() -> dict:
    """The ``engine.stats()["metrics"]`` payload."""
    if not ACTIVE:
        return {"enabled": False}
    return {"enabled": True, "families": _REGISTRY.to_dict()}


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


# -- flight recorder ----------------------------------------------------------

def flight_recorder() -> FlightRecorder:
    return _FLIGHT


def event(kind: str, /, **fields):
    """Record a structured event (call sites guard on RECORDING).
    Fields colliding with the envelope keys (kind/seq/t/wall) are
    stored with a trailing underscore."""
    if RECORDING:
        _FLIGHT.record(kind, **fields)


def flight_events(limit: Optional[int] = None):
    return _FLIGHT.events(limit)


#: Automatic (failure-path) dumps to STDERR are capped per process: a
#: fatal that repeats every cycle must not bury the log under copies of
#: the same ring.  File dumps (ENV_FLIGHT_PATH) and operator-triggered
#: SIGUSR1 dumps are never capped.
_AUTO_STDERR_DUMP_LIMIT = 5
_auto_stderr_dumps = 0


def flight_dump(reason: str, limit: Optional[int] = None,
                force: bool = False) -> int:
    """Dump the ring to ``HOROVOD_FLIGHT_RECORDER_PATH`` (else stderr).
    No-op when recording is disabled."""
    global _auto_stderr_dumps
    if not RECORDING:
        return 0
    path = os.environ.get(ENV_FLIGHT_PATH)
    if not path and not force:
        if _auto_stderr_dumps >= _AUTO_STDERR_DUMP_LIMIT:
            return 0
        _auto_stderr_dumps += 1
    return _FLIGHT.dump(reason, path=path or None, limit=limit)


def _on_sigusr1(signum, frame):  # pragma: no cover - signal delivery
    flight_dump("SIGUSR1", force=True)


def install_signal_handler() -> bool:
    """SIGUSR1 → flight dump.  Main-thread only (signal module rule);
    returns False where that is not possible (e.g. engine threads,
    embedded interpreters)."""
    try:
        signal.signal(signal.SIGUSR1, _on_sigusr1)
        return True
    except (ValueError, AttributeError, OSError):
        return False


# -- exposition services (periodic JSON dump + standalone HTTP) ---------------

_dump_thread: Optional[threading.Thread] = None
_dump_stop: Optional[threading.Event] = None
_http_server = None


def _write_snapshot(path: str):
    blob = json.dumps(
        {"wall": round(time.time(), 3), "pid": os.getpid(),
         "uptime_s": round(time.monotonic() - _T0, 3),
         "metrics": _REGISTRY.to_dict()},
        separators=(",", ":"))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(blob + "\n")
    os.replace(tmp, path)


def _dump_loop(path: str, interval: float, stop: threading.Event):
    while not stop.wait(interval):
        try:
            _write_snapshot(path)
        except Exception:  # noqa: BLE001 - snapshotting must not kill jobs
            logger.debug("metrics dump failed", exc_info=True)
    try:                       # final snapshot on shutdown
        _write_snapshot(path)
    except Exception:  # noqa: BLE001
        logger.debug("final metrics dump failed", exc_info=True)


def healthz() -> dict:
    return {"status": "ok", "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - _T0, 3),
            "metrics_enabled": ACTIVE,
            "flight_recorder": RECORDING}


def get_routes() -> Dict[str, "callable"]:
    """Default GET routes every JsonRpcServer serves: ``/metrics``
    (Prometheus text format), ``/healthz`` (JSON liveness), ``/trace``
    (this process's span buffer as a Chrome trace, the one-worker slice
    of the driver's ``/trace/job``), ``/health`` (this process's
    training-health snapshot, the slice of the driver's ``/health/job``;
    NOT ``/healthz``, which is liveness) and ``/timeseries`` (this
    process's windowed metric-delta ring, the slice of
    ``/timeseries/job``).  Each route returns ``(status, content_type,
    body)``."""
    def _metrics_route():
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                render_prometheus())

    def _healthz_route():
        return (200, "application/json", json.dumps(healthz()))

    def _trace_route():
        from .. import tracing  # lazy: tracing pulls no metrics state
        return (200, "application/json",
                json.dumps(tracing.local_trace(), separators=(",", ":")))

    def _health_route():
        from .. import health  # lazy: health imports this package
        return (200, "application/json", health.routes_json())

    def _timeseries_route():
        from . import timeseries  # lazy: timeseries imports this package
        return (200, "application/json",
                json.dumps(timeseries.local_payload(),
                           separators=(",", ":")))

    return {"metrics": _metrics_route, "healthz": _healthz_route,
            "trace": _trace_route, "health": _health_route,
            "timeseries": _timeseries_route}


def _rank_and_size(environ) -> Tuple[int, int]:
    """This process's rank and the world size: the port runtime's when
    it is initialized, else ``HOROVOD_RANK`` / ``HOROVOD_SIZE`` (a
    launcher sets them before ``hvd.init()`` runs)."""
    from .. import runtime
    if runtime.is_initialized():
        return runtime.rank(), runtime.size()
    try:
        return (int(environ.get("HOROVOD_RANK", "0")),
                int(environ.get("HOROVOD_SIZE", "1")))
    except ValueError:
        return 0, 1


def init_from_env(environ=os.environ):
    """Apply the HOROVOD_METRICS* / HOROVOD_FLIGHT_RECORDER* contract
    (called from ``hvd.init()``; idempotent across re-inits):

    * refresh the ACTIVE / RECORDING flags from the environment,
    * install the SIGUSR1 dump handler (best effort),
    * start the periodic JSON dump thread (``HOROVOD_METRICS_DUMP``),
    * start a standalone scrape server (``HOROVOD_METRICS_PORT``),
    * start the time-series sampler and the SLO watchdog
      (``HOROVOD_TIMESERIES*`` / ``HOROVOD_SLO``).
    """
    global ACTIVE, RECORDING, _dump_thread, _dump_stop, _http_server
    ACTIVE = _env_on(ENV_ENABLE, environ=environ)
    RECORDING = _env_on(ENV_FLIGHT, environ=environ)
    from . import timeseries  # lazy: timeseries imports this package
    timeseries.init_from_env(environ)
    if RECORDING:
        # only claim SIGUSR1 when a dump would actually be written — a
        # disabled recorder must not clobber an app's own handler
        # (e.g. SLURM preemption checkpointing) with a no-op
        install_signal_handler()
    dump_path = environ.get(ENV_DUMP)
    if dump_path and _dump_thread is None:
        # launchers propagate HOROVOD_* to every worker: per-rank suffix
        # so 8 ranks don't atomically clobber one snapshot file
        rank, size = _rank_and_size(environ)
        if size > 1:
            dump_path = f"{dump_path}.{rank}"
        try:
            interval = float(environ.get(ENV_DUMP_INTERVAL, "30"))
        except ValueError:
            interval = 30.0
        # Event.wait(<=0) returns immediately: a zero/negative interval
        # would busy-spin the dump thread; clamp instead of crashing
        interval = max(interval, 0.05)
        _dump_stop = threading.Event()
        _dump_thread = threading.Thread(
            target=_dump_loop, args=(dump_path, interval, _dump_stop),
            name="hvd-metrics-dump", daemon=True)
        _dump_thread.start()
    port = environ.get(ENV_PORT)
    if port and _http_server is None:
        from ..runner.rpc import JsonRpcServer
        try:
            _http_server = JsonRpcServer({}, port=int(port), secret=None)
            logger.info("metrics exposition on :%d (/metrics, /healthz)",
                        _http_server.port)
        except (OSError, ValueError):
            # a bad port or a taken port degrades observability; it
            # must never kill the job at init
            logger.warning("could not serve metrics on port %r", port,
                           exc_info=True)


def stop_exposition():
    """Stop the dump thread (flushing one last snapshot), the
    time-series sampler, and the standalone scrape server.  Safe to call
    repeatedly."""
    global _dump_thread, _dump_stop, _http_server
    from . import timeseries  # lazy: timeseries imports this package
    timeseries.stop_sampler()
    if _dump_stop is not None:
        _dump_stop.set()
        if _dump_thread is not None:
            _dump_thread.join(timeout=5)
        _dump_thread, _dump_stop = None, None
    if _http_server is not None:
        try:
            _http_server.close()
        except Exception:  # noqa: BLE001 - teardown best effort
            logger.debug("metrics server close failed", exc_info=True)
        _http_server = None
