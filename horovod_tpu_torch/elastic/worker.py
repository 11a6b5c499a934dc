"""Worker-side elastic services: assignment fetch + host-update listener.

Counterpart: ``horovod_tpu/elastic/worker.py``, over the port's
``runner/rpc.py``.  Reference parity: ``horovod/runner/elastic/worker.py``
(``WorkerNotificationService`` / ``WorkerNotificationManager``): each
worker runs a small RPC server whose address it registers with the
driver; the driver pushes ``hosts_updated`` events there, and the next
``state.commit()`` surfaces them as ``HostsUpdatedInterrupt``.
``fetch_assignment`` is the rendezvous re-query (SURVEY.md §3.5): after a
reset, the worker asks the driver for its place in the *current* epoch
instead of trusting the spawn env vars.

The port's addition: a ``hosts_updated`` push names the epoch it
announces and the ranks of the previous epoch whose processes died.  The
listener drops a push for an epoch this worker already joined (it would
raise a spurious ``HostsUpdatedInterrupt`` after the reset that absorbed
it), and tells the runtime which peers are gone, so a negotiation round
waiting on a SIGKILLed peer fails at once instead of at its deadline
(``runtime.note_superseded``).  The JAX package gets that bound from the
coordination service's heartbeat.

The listener's server also serves ``recovery_push``/``recovery_pull`` for
the process's installed ``RecoveryAgent`` (``elastic/recovery.py``),
``trace_pull`` (the driver's ``GET /trace/job``) and ``health_pull`` (its
``GET /health/job``), as the JAX worker's does; a FAILURE report carries
the flight recorder's last events and the last time-series windows.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from typing import Optional

from .. import chaos as _chaos
from .. import metrics as _metrics
from ..runner.rpc import JsonRpcServer, json_request

logger = logging.getLogger("horovod_tpu_torch")

_m_rendezvous = _metrics.counter(
    "hvd_elastic_rendezvous_epochs_total",
    "Epoch assignments this worker accepted")
_m_reforms = _metrics.counter(
    "hvd_elastic_reform_requests_total",
    "Re-form requests this worker sent after collective failures")


class HostUpdateResult:
    ADDED = 1
    REMOVED = 2
    MIXED = 3


def _driver_endpoint():
    addr = os.environ.get("HOROVOD_ELASTIC_DRIVER_ADDR")
    port = os.environ.get("HOROVOD_ELASTIC_DRIVER_PORT")
    if not addr or not port:
        return None
    return addr, int(port)


def worker_id() -> Optional[int]:
    wid = os.environ.get("HOROVOD_ELASTIC_WORKER_ID")
    return int(wid) if wid is not None else None


_last_epoch = -1


def fetch_assignment(min_epoch: Optional[int] = None,
                     timeout: float = 600.0) -> Optional[dict]:
    """Ask the driver for this worker's current-epoch assignment.

    Blocks (polling) until the driver publishes an epoch ``>= min_epoch``
    (default: newer than the last one this worker saw) that includes this
    worker.  Returns None when not running under the elastic driver;
    raises RuntimeError if the worker has been removed from the job.
    """
    global _last_epoch
    ep = _driver_endpoint()
    wid = worker_id()
    if ep is None or wid is None:
        return None
    want = _last_epoch + 1 if min_epoch is None else min_epoch
    deadline = time.monotonic() + timeout
    while True:
        try:
            if _chaos.ACTIVE:
                _chaos.fire("worker.poll", worker_id=wid, min_epoch=want)
            # retries=0: this loop IS the retry policy (deadline-bounded
            # polling)
            reply = json_request(ep[0], ep[1], "assignment",
                                 {"worker_id": wid, "min_epoch": want},
                                 retries=0)
        except Exception:  # noqa: BLE001 - transient RPC failure (driver
            # busy re-forming / network blip): the deadline absorbs it
            logger.debug("assignment poll failed; retrying", exc_info=True)
            reply = {}
        if reply.get("removed"):
            raise RuntimeError(
                "this worker was removed from the elastic job "
                f"(worker_id={wid})")
        if reply.get("ready"):
            _last_epoch = reply["epoch"]
            if _metrics.ACTIVE:
                _m_rendezvous.inc()
            if _metrics.RECORDING:
                _metrics.event("elastic.assignment", worker_id=wid,
                               epoch=reply["epoch"],
                               rank=reply.get("rank"),
                               size=reply.get("size"))
            return reply
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no elastic assignment for worker {wid} within {timeout}s")
        time.sleep(reply.get("retry_after", 0.5))


def request_reform():
    """Ask the driver to re-form the job under a fresh epoch (called on a
    collective failure that kills no process — without this, every worker
    would wait out the full assignment timeout for an epoch bump that
    never comes).  Best effort."""
    ep = _driver_endpoint()
    wid = worker_id()
    if ep is None or wid is None:
        return
    if _metrics.ACTIVE:
        _m_reforms.inc()
    if _metrics.RECORDING:
        _metrics.event("elastic.reform_requested", worker_id=wid,
                       seen_epoch=_last_epoch)
    try:
        json_request(ep[0], ep[1], "request_reform",
                     {"worker_id": wid, "seen_epoch": _last_epoch},
                     timeout=10.0, retries=1)
    except Exception:  # noqa: BLE001
        logger.debug("reform request failed", exc_info=True)


def record_running():
    """Tell the driver this worker finished rendezvous and is training.

    The driver uses this to tell real host failures (worker was running,
    then died → blacklist accounting) from rendezvous churn (a worker that
    dies while forming an epoch — the respawn IS the recovery, and must
    not consume blacklist or reset budget).  Best effort.
    """
    ep = _driver_endpoint()
    wid = worker_id()
    if ep is None or wid is None:
        return
    if _metrics.RECORDING:
        _metrics.event("elastic.running_reported", worker_id=wid,
                       epoch=_last_epoch)
    try:
        if _chaos.ACTIVE:
            _chaos.fire("worker.running", worker_id=wid,
                        epoch=_last_epoch)
        # carry the epoch this worker rendezvoused into so the driver can
        # drop reports that raced with a newer re-form
        json_request(ep[0], ep[1], "running",
                     {"worker_id": wid, "epoch": _last_epoch},
                     timeout=5.0)
    except Exception:  # noqa: BLE001
        logger.debug("running report failed", exc_info=True)


def report_straggler(process: int, score: float):
    """Report a chronically slow peer to the elastic driver (best effort);
    the driver counts it as a SOFT host failure toward the blacklist."""
    ep = _driver_endpoint()
    wid = worker_id()
    if ep is None or wid is None:
        return
    if _metrics.RECORDING:
        _metrics.event("elastic.straggler_reported", worker_id=wid,
                       process=int(process), score=round(float(score), 3))
    try:
        json_request(ep[0], ep[1], "straggler",
                     {"worker_id": wid, "process": int(process),
                      "score": float(score), "epoch": _last_epoch},
                     timeout=5.0, idempotent=False)
    except Exception:  # noqa: BLE001 - scoring must not fail training
        logger.debug("straggler report failed", exc_info=True)


def record_result(status: str):
    """Report this worker's terminal state to the driver (best effort)."""
    ep = _driver_endpoint()
    wid = worker_id()
    if ep is None or wid is None:
        return
    payload = {"worker_id": wid, "status": status,
               "hostname": os.environ.get("HOROVOD_HOSTNAME",
                                          socket.gethostname())}
    if status != "SUCCESS" and _metrics.RECORDING:
        # the black box: the driver logs the last events of a crashed
        # worker
        payload["flight"] = _metrics.flight_events(
            limit=_metrics.FAILURE_REPORT_EVENTS)
    if status != "SUCCESS":
        from ..metrics import timeseries as _timeseries
        if _timeseries.ACTIVE:
            # ...and the trend lines: what the worker's rates looked like
            # before it died (none when the sampler never ran)
            windows = _timeseries.report_windows()
            if windows:
                payload["timeseries"] = windows
    try:
        # idempotent=False: a retried FAILURE report must not count the
        # host failure twice; bounded: a dying worker's best-effort goodbye
        json_request(ep[0], ep[1], "result", payload,
                     timeout=5.0, idempotent=False)
    except Exception:  # noqa: BLE001 - driver may already be gone
        logger.debug("result report failed", exc_info=True)


class WorkerNotificationManager:
    """In-worker listener the driver pushes host updates to."""

    def __init__(self):
        from .. import health as _health
        from .. import tracing as _tracing
        from . import recovery as _recovery
        self._listeners = []
        # trace_pull: the driver's GET /trace/job pulls this worker's span
        # buffer (and its clock-offset probes) over the RPC transport
        # every other control-plane call rides; health_pull the same shape
        # for the training-health verdicts.  recovery_push /
        # recovery_pull: the checkpointless-recovery plane — peers land
        # redundancy frames here and a rejoining worker pulls its lost
        # tiles back (elastic/recovery.py)
        self._server = JsonRpcServer(
            {"hosts_updated": self._on_update,
             "trace_pull": _tracing.pull_handler,
             "health_pull": _health.pull_handler,
             "recovery_push": _recovery.push_handler,
             "recovery_pull": _recovery.pull_handler})
        self._registered = False

    def init(self):
        """Register this worker's listener address with the driver — the
        address the DRIVER's host can route back to (NIC-aware, same
        selection as the launcher's rendezvous address)."""
        from ..runner.network import local_service_addr, routable_source_addr
        from ..runner.spawn import is_local
        ep = _driver_endpoint()
        wid = worker_id()
        if ep is None or wid is None or self._registered:
            return
        try:
            addr = local_service_addr(ep[0], is_local)
        except ValueError:
            # HOROVOD_NETWORK_INTERFACE names a NIC this host doesn't
            # have: fall back to the route toward the driver
            logger.warning("notification endpoint interface resolution "
                           "failed; using route-based detection",
                           exc_info=True)
            addr = routable_source_addr(ep[0]) or socket.gethostname()
        json_request(ep[0], ep[1], "register_notification",
                     {"worker_id": wid, "addr": addr,
                      "port": self._server.port})
        self._registered = True

    def _on_update(self, payload):
        epoch = payload.get("epoch")
        if epoch is not None and epoch <= _last_epoch:
            # this worker already rendezvoused into that epoch: the reset
            # that got it there absorbed the update
            return {"ok": True, "stale": True}
        if epoch is not None:
            from .. import runtime
            runtime.note_superseded(int(epoch), payload.get("lost", ()))
        ts = payload.get("timestamp", time.time())
        res = payload.get("res", HostUpdateResult.MIXED)
        for listener in list(self._listeners):
            listener.on_hosts_updated(ts, res)
        return {"ok": True}

    def register_listener(self, state):
        self._listeners.append(state)

    def remove_listener(self, state):
        if state in self._listeners:
            self._listeners.remove(state)

    def close(self):
        self._server.close()
