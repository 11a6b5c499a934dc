"""The elastic driver: discovery polling, worker lifecycle, notifications.

Counterpart: ``horovod_tpu/elastic/driver.py``, whose decisions this keeps:
epochs and rank assignment, the epoch release gate, the blacklist (churn
before ``running`` does not count), min/max np, the reaper, the lifecycle
events and ``attach_serving``.  Reference parity:
``horovod/runner/elastic/driver.py`` ``ElasticDriver`` + ``rendezvous.py``
(SURVEY.md §3.5, §5.3): poll the host-discovery script;
on a membership delta recompute rank assignments, notify live workers (they
raise ``HostsUpdatedInterrupt`` at the next commit), spawn workers on new
hosts; on worker failure count it against the host and blacklist repeat
offenders; hold below ``min_np``, cap at ``max_np``.

The port's rendezvous: each epoch forms afresh around a new
``torch.distributed.TCPStore`` that the epoch's rank 0 hosts at
``coordinator_addr:coordinator_port(epoch)`` (``runtime.init`` pulls the
epoch assignment via ``fetch_assignment``).  The driver only has to hand
out consistent assignments and bump the epoch.  A store per epoch needs
no driver-hosted KV store and no sweep of dead epochs' keys (the JAX
package's ``runner/kv.py`` and ``_prune_dead_epoch_keys``).  Every
job-level GET view delegates to the job scraper
(``metrics/jobscrape.py``): ``metrics/job``, ``trace/job``,
``recovery/stats`` and, once a serving plane attaches, ``serve/stats``.

Checkpointless recovery (``elastic/recovery.py``): the driver serves the
``recovery_plan`` RPC (each rank's notification endpoint, where its
agent takes pushes and pulls) and ``recovery_note`` (a delivered push or
a finished rebuild, the latter emitted as ``worker_rebuilt``), holds the
:class:`~horovod_tpu_torch.elastic.recovery.RecoveryDirectory` they feed,
prunes it on a worker's death and at every re-form, and serves it at GET
``recovery/stats`` through the job scraper.

Two additions beyond the reference (the JAX package's, kept):

* **Epoch release gate** — a fresh epoch's assignment is withheld until
  every member has polled for it once.  Fresh spawns poll only after their
  (slow) torch import and CUDA start, so the gate collapses rendezvous
  skew from seconds to one poll interval; survivors' formation clocks no
  longer expire while newcomers are importing.
* **Lifecycle events** — ``epoch_applied`` / ``epoch_released`` /
  ``worker_running`` / ``epoch_formed`` / ``worker_exit`` / ``job_done`` /
  ``below_min`` / ``worker_rebuilt`` are observable via
  :meth:`ElasticDriver.add_listener` and
  :meth:`ElasticDriver.wait_event`, so tests and tooling synchronize on
  the exact transition they need instead of wall-clock windows.

The port adds the epoch and the lost ranks to the ``hosts_updated`` push
(``elastic/worker.py``).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
from typing import Dict, List, Optional

from .. import chaos as _chaos
from .. import metrics as _metrics
from ..metrics import jobscrape as _jobscrape
from ..runner import spawn
from ..runner import secret as _secret
from ..runner.hosts import HostInfo, assign_slots
from ..runner.rpc import JsonRpcServer, json_request
from . import registration
from .discovery import HostDiscovery, HostDiscoveryScript
from .worker import HostUpdateResult

logger = logging.getLogger("horovod_tpu_torch")

# -- metric families (docs/metrics.md; sites guard on _metrics.ACTIVE) --------
_m_epochs = _metrics.counter(
    "hvd_elastic_epochs_total", "Rendezvous epochs applied by the driver")
_m_epoch_dur = _metrics.histogram(
    "hvd_elastic_epoch_duration_seconds",
    "Epoch apply → every member running", lo=-7, hi=10)
_m_blacklist = _metrics.gauge(
    "hvd_elastic_blacklist_size", "Hosts currently blacklisted")
_m_restarts = _metrics.counter(
    "hvd_elastic_worker_restarts_total",
    "Worker respawns by cause (churn = rendezvous death, failure = "
    "post-running death)", labels=("kind",))
_m_discovery_failures = _metrics.counter(
    "hvd_elastic_discovery_failures_total",
    "Host-discovery poll failures absorbed by the driver")
_m_stragglers = _metrics.counter(
    "hvd_elastic_straggler_reports_total",
    "Straggler reports received, by disposition (counted = fed the "
    "blacklist as a soft failure)", labels=("disposition",))

DEFAULT_DISCOVERY_INTERVAL = float(
    os.environ.get("HOROVOD_ELASTIC_DISCOVERY_INTERVAL", "1.0"))


class _Worker:
    def __init__(self, worker_id: int, slot, proc: spawn.WorkerProcess,
                 epoch: int):
        self.worker_id = worker_id
        self.slot = slot
        self.proc = proc
        self.epoch = epoch
        self.expected_exit = False
        # True once the worker reported it finished rendezvous ("running"
        # RPC).  Deaths before that are re-rendezvous churn — the respawn
        # is the recovery — so they must not consume blacklist or reset
        # budget.
        self.started = False


class ElasticDriver:
    def __init__(self, discovery: HostDiscovery, command: List[str],
                 min_np: int = 1, max_np: Optional[int] = None,
                 port: int = 29410,
                 discovery_interval: float = DEFAULT_DISCOVERY_INTERVAL,
                 blacklist_threshold: int = 3,
                 start_timeout: float = 600.0,
                 reset_limit: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None,
                 verbose: bool = False,
                 network_interface: Optional[str] = None,
                 straggler_blacklist_score: Optional[float] = None):
        self.discovery = discovery
        self.command = list(command)
        self.min_np = min_np
        self.max_np = max_np
        self.port = port
        self.interval = discovery_interval
        self.start_timeout = start_timeout
        self.reset_limit = reset_limit
        self.extra_env = dict(env or {})
        self.verbose = verbose
        self.network_interface = network_interface
        self.registry = registration.WorkerStateRegistry(blacklist_threshold)
        # straggler-score bar (HOROVOD_TAIL_BLACKLIST_SCORE): reports at
        # or above it count as SOFT host failures toward the same
        # blacklist crashes feed — a chronically slow host rotates out
        # before it dies outright.  Debounced per (host, epoch): one
        # soft failure per epoch however many peers report the host.
        if straggler_blacklist_score is None:
            try:
                straggler_blacklist_score = float(os.environ.get(
                    "HOROVOD_TAIL_BLACKLIST_SCORE", "0") or 0.0)
            except ValueError:
                straggler_blacklist_score = 0.0
        self.straggler_blacklist_score = straggler_blacklist_score
        self._straggler_counted: set = set()   # (host, epoch) debounce
        # hosts_updated pushes are retried: a lost notification leaves an
        # incumbent training on the stale epoch until its own collective
        # failure detection fires — the leader-join flake (see
        # tests/test_chaos.py leader-join regression).  Kept small so a
        # genuinely dead worker can't stall the re-form loop for long.
        self.notify_retries = 2

        self._lock = threading.Lock()
        # serializes discover→apply sequences: concurrent reform requests
        # (every worker reports the same collective failure at once, and
        # the RPC server handles them concurrently) and the monitor thread
        # must not each pass the epoch debounce and double-bump the epoch
        # with two different coordinator ports.  RLock: _apply_hosts also
        # takes it so every call site is covered.
        self._reform_lock = threading.RLock()
        self._epoch = -1
        self._assignment: Dict[int, dict] = {}   # worker_id → assignment
        self._workers: Dict[int, _Worker] = {}   # live workers by id
        self._notif: Dict[int, tuple] = {}       # worker_id → (addr, port)
        # serving plane (attach_serving): worker deaths and re-forms
        # requeue its in-flight leases so mid-traffic churn loses zero
        # requests (docs/serving.md)
        self._serving = None
        # checkpointless-recovery directory: who holds redundancy for
        # whom, fed by workers' recovery_note RPCs and pruned on
        # worker_gone / re-form like the serving rotation state
        from .recovery import RecoveryDirectory
        self._recovery = RecoveryDirectory()
        # ranks of the epoch just replaced whose processes had died: the
        # hosts_updated push names them, so survivors stop waiting on them
        self._lost_ranks: List[int] = []
        self._next_worker_id = 0
        self._hosts: Dict[str, int] = {}
        self._shutdown = False
        self._reset_count = 0
        self._job_done = False   # a worker's train fn returned successfully
        self._last_progress = time.monotonic()
        # epoch release gate: a fresh epoch's assignment is withheld until
        # every member has polled for it once (fresh spawns poll only after
        # their torch import finishes), so all members start forming the
        # epoch within one poll interval of each other instead of skewed by
        # seconds of import time.  Without this, survivors' formation
        # clocks expire while newcomers are still importing.
        self._gate_members: set = set()
        self._gate_polled: set = set()
        self._gate_deadline = 0.0
        self._gate_open = True
        # latched once per epoch: a retried/duplicated 'running' report
        # must not re-form the epoch (double epoch_formed emission and
        # an inflated second duration observation)
        self._epoch_formed = False
        # observable lifecycle: (event, info) log + condition for waiters
        # (tests and tooling wait on precise events instead of wall-clock
        # windows); callbacks in _listeners fire on every event
        self._listeners: list = []
        self._event_cv = threading.Condition()
        # bounded log with a global base index: a long-lived driver with
        # periodic churn must not grow memory forever; waiters use global
        # indices so trimming never shifts what "since" means
        self._events: list = []
        self._events_base = 0
        self._events_cap = 4096
        # listener callbacks run on a dedicated dispatch thread, never in
        # the hot control-plane paths (_emit fires inside RPC handlers and
        # under _reform_lock; a slow observer must not delay an assignment
        # reply or stall the reform path).  Bounded like _events: a
        # BLOCKED observer degrades to dropped-oldest delivery, never to
        # unbounded driver memory
        self._listener_q: "queue.Queue" = queue.Queue(
            maxsize=self._events_cap)
        self._listener_thread: Optional[threading.Thread] = None
        # mint the per-job control-plane secret BEFORE the server starts:
        # workers inherit it through the spawn env, and every RPC in both
        # directions is HMAC-verified (upstream runner request signing)
        os.environ.setdefault(_secret.SECRET_ENV, _secret.make_secret_key())
        self._epoch_t0 = time.monotonic()
        # every job-level GET view delegates to the job scraper: the
        # per-plane merge and degrade rules stay in their planes; the
        # driver supplies the live endpoints and the recovery view
        self._scraper = _jobscrape.JobScraper(
            self._scrape_endpoints,
            recovery_stats=lambda: self._recovery.stats())
        self._server = JsonRpcServer({
            "assignment": self._handle_assignment,
            "result": self._handle_result,
            "running": self._handle_running,
            "register_notification": self._handle_register_notification,
            "request_reform": self._handle_request_reform,
            "straggler": self._handle_straggler,
            "recovery_plan": self._handle_recovery_plan,
            "recovery_note": self._handle_recovery_note,
        }, port=self.port, get_routes=self._scraper.routes())

    def _scrape_endpoints(self):
        # re-snapshotted under the lock on EVERY scrape: a re-form
        # mid-scrape must see the new fleet, not a stale copy
        with self._lock:
            return {str(wid): ep for wid, ep in self._notif.items()}

    # --- serving plane -----------------------------------------------------

    def attach_serving(self, plane):
        """Attach a :class:`~horovod_tpu_torch.serving.plane.ServingPlane`:
        its ``serve_*`` data path joins this driver's control server
        (same port, same HMAC discipline, same keep-alive pool), and
        the driver's lifecycle feeds its elasticity — a reaped worker's
        leases requeue immediately (``worker_gone``) and a re-form
        requeues the leases of every worker that left the epoch
        (``retain_workers``), so mid-traffic churn re-queues in-flight
        requests instead of dropping them."""
        self._serving = plane
        self._server.add_handlers(plane.rpc_handlers())
        self._server.add_get_routes(
            self._scraper.serving_routes(lambda: self._serving.stats()))
        self._emit("serving_attached")

    # --- lifecycle events --------------------------------------------------

    def add_listener(self, callback):
        """Register ``callback(event: str, info: dict)`` fired on every
        lifecycle event (``epoch_applied``, ``epoch_released``,
        ``worker_running``, ``epoch_formed``, ``worker_exit``,
        ``job_done``, ``below_min``).  Callbacks run on a dedicated
        dispatch thread in emission order; a slow callback delays later
        callbacks, never the driver."""
        with self._lock:   # exactly one dispatch thread, ever
            self._listeners.append(callback)
            if self._listener_thread is None:
                self._listener_thread = threading.Thread(
                    target=self._listener_loop, name="hvd-elastic-events",
                    daemon=True)
                self._listener_thread.start()

    def _listener_loop(self):
        while True:
            event, info = self._listener_q.get()
            if event is None:   # flush marker: info is an Event to set
                info.set()
                continue
            # snapshot under the same lock add_listener appends under: an
            # unguarded list() can observe the append mid-resize (HVD113)
            with self._lock:
                listeners = list(self._listeners)
            for cb in listeners:
                try:
                    cb(event, info)
                except Exception:  # noqa: BLE001 - observer must not
                    # kill the dispatch thread
                    logger.debug("lifecycle listener failed",
                                 exc_info=True)

    def flush_listeners(self, timeout: float = 10.0) -> bool:
        """Block until every event emitted so far has been delivered to
        the callbacks (the dispatch thread is asynchronous; terminal
        events like ``job_done`` would otherwise race driver exit)."""
        with self._lock:   # guarded like add_listener's write (HVD113)
            if self._listener_thread is None:
                return True
        done = threading.Event()
        self._listener_q.put((None, done))
        return done.wait(timeout)

    def _emit(self, event: str, **info):
        # flight-recorder bridge: the driver's lifecycle IS the elastic
        # event stream a post-mortem needs (epoch churn before a crash)
        if _metrics.RECORDING:
            _metrics.event(f"elastic.{event}", **info)
        with self._lock:   # see _listener_loop: reads take the guard too
            has_listeners = bool(self._listeners)
        if has_listeners:
            while True:
                try:
                    self._listener_q.put_nowait((event, info))
                    break
                except queue.Full:   # drop-oldest, keep the fresh event
                    try:
                        self._listener_q.get_nowait()
                    except queue.Empty:
                        pass
        with self._event_cv:
            self._events.append((event, info))
            if len(self._events) > self._events_cap:
                drop = len(self._events) - self._events_cap
                del self._events[:drop]
                self._events_base += drop
            self._event_cv.notify_all()

    def wait_event(self, event: str, timeout: float, match=None,
                   since: int = 0) -> tuple:
        """Block until an ``event`` with ``match(info)`` true has been
        emitted at log index >= ``since``; returns ``(index, info)``.
        Raises TimeoutError with the full event log on expiry."""
        deadline = time.monotonic() + timeout
        with self._event_cv:
            while True:
                lo = max(since - self._events_base, 0)
                for i in range(lo, len(self._events)):
                    ev, info = self._events[i]
                    if ev == event and (match is None or match(info)):
                        return self._events_base + i, info
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    tail = self._events[lo:][-50:]
                    raise TimeoutError(
                        f"no {event!r} event within {timeout}s; "
                        f"log tail={tail}")
                self._event_cv.wait(remaining)

    # --- rpc handlers ------------------------------------------------------

    def _handle_assignment(self, payload):
        wid = int(payload["worker_id"])
        min_epoch = int(payload.get("min_epoch", 0))
        if _chaos.ACTIVE:
            # delay = a slow assignment reply; error/drop = a reply the
            # worker's poll loop must absorb
            _chaos.fire("elastic.assignment", worker_id=wid,
                        min_epoch=min_epoch)
        release = None
        with self._lock:
            if self._epoch < min_epoch:
                return {"ready": False, "retry_after": 0.2}
            asg = self._assignment.get(wid)
            if asg is None:
                return {"removed": True}
            if not self._gate_open:
                self._gate_polled.add(wid)
                if self._gate_polled >= self._gate_members:
                    self._gate_open = True
                    release = "all_polled"
                elif time.monotonic() > self._gate_deadline:
                    # straggler fallback: a member that died pre-poll is
                    # re-formed by the reaper anyway; don't hold the rest
                    # hostage past the formation window
                    self._gate_open = True
                    release = "deadline"
                else:
                    return {"ready": False, "retry_after": 0.2}
                # registration starts at release, not at epoch apply —
                # restart the formation clock so the stall window measures
                # rendezvous, not the imports the gate just absorbed
                self._last_progress = time.monotonic()
            reply = dict(asg, ready=True, epoch=self._epoch)
            epoch = self._epoch
        if release is not None:
            self._emit("epoch_released", epoch=epoch, reason=release)
        return reply

    def _handle_result(self, payload):
        wid = int(payload["worker_id"])
        with self._lock:
            w = self._workers.get(wid)
            expected = ((w is not None and w.expected_exit)
                        or wid not in self._assignment)
        if payload["status"] == registration.FAILURE and expected:
            # a worker removed by scale-down errors out on its way down;
            # that is not a host failure and must not feed the blacklist
            return {"ok": True}
        if payload["status"] == registration.FAILURE:
            # black-box playback: a crashed worker's FAILURE report
            # carries the last events of its flight recorder — log them
            # so "worker 3 died" comes with what led there
            flight = payload.get("flight") or []
            if flight:
                tail = "\n".join(
                    "  " + json.dumps(ev, separators=(",", ":"))
                    for ev in flight)
                logger.warning(
                    "worker %d FAILURE flight recorder (last %d "
                    "events):\n%s", wid, len(flight), tail)
            windows = payload.get("timeseries") or []
            if windows:
                from ..metrics import timeseries as _timeseries
                logger.warning(
                    "worker %d FAILURE time-series (last %d "
                    "window(s)):\n%s", wid, len(windows),
                    _timeseries.render_windows(windows))
        self.registry.record_result(wid, payload["status"],
                                    payload.get("hostname"))
        if _metrics.ACTIVE:
            _m_blacklist.set(len(self.registry.blacklisted_hosts()))
        if payload["status"] == registration.SUCCESS and not expected:
            # the training function returned: the job is complete — peers
            # stop at the same step, so don't re-form on their way out
            with self._lock:
                self._job_done = True
            self._emit("job_done", worker_id=wid)
        return {"ok": True}

    def _handle_request_reform(self, payload):
        """A worker hit a collective failure with no process exit and no
        discovery delta (transient transport error): re-form the
        current host set under a fresh epoch so re-rendezvous can proceed.
        Debounced on the epoch the requester last saw."""
        seen = int(payload.get("seen_epoch", -1))
        with self._reform_lock:
            # re-check the debounce inside the reform lock: only one
            # reform per observed epoch may run
            with self._lock:
                if self._epoch > seen or self._job_done:
                    return {"ok": True, "epoch": self._epoch}
            hosts = self._discover_or_current("reform request")
            if self._total_slots(hosts) >= self.min_np:
                self._apply_hosts(hosts, HostUpdateResult.MIXED)
        with self._lock:
            return {"ok": True, "epoch": self._epoch}

    def _handle_straggler(self, payload):
        """A worker's stall inspector reports a chronically slow peer
        (straggler EWMA past HOROVOD_TAIL_BLACKLIST_SCORE).  The
        process rank maps to its host through the current assignment;
        at-or-above-bar reports count ONE soft failure per (host,
        epoch) toward the blacklist — the host rotates out at the
        normal threshold without ever crashing."""
        rank = int(payload["process"])
        score = float(payload.get("score", 0.0))
        with self._lock:
            epoch = self._epoch
            host = None
            for wid, asg in self._assignment.items():
                if asg.get("rank") == rank:
                    w = self._workers.get(wid)
                    host = w.slot.hostname if w is not None else None
                    break
        if host is None:
            if _metrics.ACTIVE:
                _m_stragglers.inc(disposition="unknown_rank")
            return {"ok": False, "error": f"no live worker at rank {rank}"}
        bar = self.straggler_blacklist_score
        if bar is None or bar <= 0:
            # feature disabled on THIS driver (HOROVOD_TAIL_BLACKLIST_
            # SCORE unset/0): never count — a worker launched with the
            # var set must not feed a blacklist its driver disabled
            if _metrics.ACTIVE:
                _m_stragglers.inc(disposition="disabled")
            return {"ok": True, "counted": False}
        if score < bar:
            if _metrics.ACTIVE:
                _m_stragglers.inc(disposition="below_bar")
            return {"ok": True, "counted": False}
        with self._lock:
            key = (host, epoch)
            if key in self._straggler_counted:
                if _metrics.ACTIVE:
                    _m_stragglers.inc(disposition="debounced")
                return {"ok": True, "counted": False}
            self._straggler_counted.add(key)
        self.registry.record_soft_failure(host)
        if _metrics.ACTIVE:
            _m_stragglers.inc(disposition="counted")
            _m_blacklist.set(len(self.registry.blacklisted_hosts()))
        logger.warning(
            "straggler report: host %s (rank %d) score %.3fs >= %.3fs; "
            "soft failure %d/%d toward blacklist", host, rank, score,
            bar or 0.0, self.registry.failure_count(host),
            self.registry.blacklist_threshold)
        self._emit("straggler_reported", host=host, rank=rank,
                   score=round(score, 3), epoch=epoch,
                   failures=self.registry.failure_count(host),
                   blacklisted=self.registry.is_blacklisted(host))
        return {"ok": True, "counted": True,
                "blacklisted": self.registry.is_blacklisted(host)}

    def _handle_running(self, payload):
        wid = int(payload["worker_id"])
        epoch = int(payload.get("epoch", -1))
        formed = None
        with self._lock:
            w = self._workers.get(wid)
            # ignore a late report from a previous epoch: the worker was
            # re-pinned and must re-rendezvous before it counts as started
            if w is not None and epoch == w.epoch:
                w.started = True
                self._last_progress = time.monotonic()
                members = {m.worker_id: m for m in self._workers.values()
                           if not m.expected_exit}
                if (epoch == self._epoch and not self._epoch_formed
                        and all(wid_ in members
                                and members[wid_].started
                                for wid_ in self._assignment)):
                    # duration captured under the SAME lock that proved
                    # this epoch formed: a concurrent _apply_hosts for a
                    # newer epoch resets _epoch_t0 and would record ~0
                    self._epoch_formed = True
                    formed = (epoch, len(self._assignment),
                              time.monotonic() - self._epoch_t0)
        self._emit("worker_running", worker_id=wid, epoch=epoch)
        if formed is not None:
            if _metrics.ACTIVE:
                _m_epoch_dur.observe(formed[2])
            self._emit("epoch_formed", epoch=formed[0], size=formed[1])
        return {"ok": True}

    def _handle_register_notification(self, payload):
        with self._lock:
            self._notif[int(payload["worker_id"])] = (
                payload["addr"], int(payload["port"]))
        return {"ok": True}

    def _handle_recovery_plan(self, payload):
        """Current peer map for the checkpointless-recovery plane: a
        worker asks where its ring neighbor / parity peers listen
        (their notification servers double as the tile push/pull
        endpoints).  Peers missing from the map simply have not
        registered yet — the agent re-polls under its pull deadline."""
        with self._lock:
            peers = {}
            wids = {}
            for wid, asg in self._assignment.items():
                ep = self._notif.get(wid)
                if ep is None:
                    continue
                peers[str(asg["rank"])] = [ep[0], int(ep[1])]
                wids[str(asg["rank"])] = int(wid)
            return {"ok": True, "epoch": self._epoch,
                    "size": len(self._assignment),
                    "peers": peers, "wids": wids}

    def _handle_recovery_note(self, payload):
        """A worker reports a delivered redundancy push (or a completed
        rebuild): the directory is what lets a driver log say how a
        worker was rebuilt, and what gets pruned on churn."""
        res = self._recovery.note(payload)
        if payload.get("kind") == "rebuilt":
            self._emit("worker_rebuilt",
                       worker_id=int(payload.get("src_worker", -1)),
                       rank=int(payload.get("src_rank", -1)),
                       epoch=int(payload.get("epoch", -1)),
                       step=int(payload.get("step", -1)),
                       source=payload.get("source", ""),
                       seconds=round(float(payload.get("seconds", 0.0)),
                                     6))
        return res

    # --- assignment / spawn ------------------------------------------------

    def _discover(self) -> Dict[str, int]:
        hosts = self.discovery.find_available_hosts_and_slots()
        return {h: s for h, s in hosts.items()
                if not self.registry.is_blacklisted(h)}

    def _discover_or_current(self, context: str) -> Dict[str, int]:
        """Discover hosts; on a transient discovery flake fall back to the
        current set instead of crashing the driver."""
        try:
            return self._discover()
        except Exception:  # noqa: BLE001 - discovery flake
            if _metrics.ACTIVE:
                _m_discovery_failures.inc()
            logger.warning("host discovery failed (%s)", context,
                           exc_info=True)
            with self._lock:
                return dict(self._hosts)

    def _total_slots(self, hosts: Dict[str, int]) -> int:
        return sum(hosts.values())

    def _resolve_addrs(self, slots) -> tuple:
        """(coordinator addr, {hostname: driver RPC addr}) for an epoch.

        NIC-aware (``--network-interface`` / HOROVOD_NETWORK_INTERFACE /
        route toward the first remote host — multi-NIC hosts can't trust
        ``gethostname()``).  Called BEFORE ``self._lock`` is
        taken: route lookups can hit DNS, and a slow resolver must not
        stall the RPC handlers; one lookup per distinct hostname."""
        from ..runner.network import coordinator_addr, local_service_addr
        coord = coordinator_addr([s.hostname for s in slots],
                                 spawn.is_local,
                                 interface=self.network_interface)
        driver_addrs = {h: local_service_addr(
            h, spawn.is_local, interface=self.network_interface)
            for h in {s.hostname for s in slots}}
        return coord, driver_addrs

    def _epoch_port(self) -> int:
        # fresh port per epoch: the new epoch's rank 0 hosts its TCPStore
        # there, never colliding with a half-closed predecessor
        return self.port + 1 + (self._epoch % 512)

    def _apply_hosts(self, hosts: Dict[str, int], update_res: int):
        """Recompute assignments for a new host set and reconcile workers.
        Caller must NOT hold ``self._lock`` (``self._reform_lock`` is
        taken here and is reentrant)."""
        self._reform_lock.acquire()
        try:
            self._apply_hosts_locked(hosts, update_res)
        finally:
            self._reform_lock.release()

    def _apply_hosts_locked(self, hosts: Dict[str, int], update_res: int):
        np_ = self._total_slots(hosts)
        if self.max_np is not None:
            np_ = min(np_, self.max_np)
        host_infos = [HostInfo(h, s) for h, s in hosts.items()]
        slots = assign_slots(host_infos, np_)
        # address resolution (possible DNS) stays OUTSIDE self._lock
        coord_addr, driver_addrs = self._resolve_addrs(slots)
        with self._lock:
            self._epoch += 1
            self._epoch_t0 = time.monotonic()
            self._hosts = dict(hosts)
            # the new epoch gets a fresh rendezvous window: churn deaths
            # are tolerated until start_timeout from THIS re-form, not
            # from the last 'running' report hours ago
            self._last_progress = time.monotonic()
            coord_port = self._epoch_port()
            # the previous epoch's ranks whose processes are gone (reaped,
            # or dead and not yet reaped): survivors must stop waiting on
            # them at once
            self._lost_ranks = sorted(
                asg["rank"] for wid, asg in self._assignment.items()
                if wid not in self._workers
                or self._workers[wid].proc.popen.poll() is not None)
            # keep existing workers on their host where possible: workers
            # are pinned to (hostname, local slot index).  A worker whose
            # process has already died must NOT be re-pinned — the new
            # epoch would wait on a corpse — and is left un-"expected" so
            # the reaper still accounts for its death (blacklist vs churn)
            by_hostslot = {
                (w.slot.hostname, w.slot.local_rank): w
                for w in self._workers.values()
                if not w.expected_exit and w.proc.popen.poll() is None}
            new_assignment: Dict[int, dict] = {}
            to_spawn = []
            assigned_wids = set()
            for slot in slots:
                w = by_hostslot.get((slot.hostname, slot.local_rank))
                if w is not None:
                    wid = w.worker_id
                    w.slot = slot
                    w.epoch = self._epoch
                    # must re-rendezvous into this epoch; deaths before the
                    # fresh "running" report are churn, not host failures
                    w.started = False
                else:
                    wid = self._next_worker_id
                    self._next_worker_id += 1
                    to_spawn.append((wid, slot))
                assigned_wids.add(wid)
                new_assignment[wid] = {
                    "rank": slot.rank, "size": slot.size,
                    "local_rank": slot.local_rank,
                    "local_size": slot.local_size,
                    "cross_rank": slot.cross_rank,
                    "cross_size": slot.cross_size,
                    "coordinator_addr": coord_addr,
                    "coordinator_port": coord_port,
                }
            for w in self._workers.values():
                if (w.worker_id not in assigned_wids
                        and w.proc.popen.poll() is None):
                    w.expected_exit = True
            self._assignment = new_assignment
            epoch = self._epoch
            notify = [(wid, ep) for wid, ep in self._notif.items()
                      if wid in assigned_wids]
            # arm the release gate for this epoch: hold assignment until
            # every member has polled once (or the formation window ends)
            self._gate_members = set(assigned_wids)
            self._gate_polled = set()
            self._gate_open = not assigned_wids
            self._gate_deadline = time.monotonic() + self.start_timeout
            self._epoch_formed = False
            # the straggler debounce is per (host, epoch): entries from
            # epochs before this re-form can never match again — prune
            # them (mirroring the serving rotation-state prune) so
            # periodic churn cannot accrete the set forever
            self._straggler_counted = {
                (h, e) for (h, e) in self._straggler_counted
                if e >= self._epoch}
        if self._serving is not None:
            # re-form mid-traffic: leases of workers that left the new
            # epoch's membership are requeued, not dropped; survivors
            # keep theirs (their processes keep serving through the
            # re-form)
            self._serving.retain_workers(assigned_wids)
        # recovery directory: drop tile entries whose source OR holder
        # left the epoch — a departed worker's ghost versions must not
        # shadow a live peer's fresher push after the re-form
        self._recovery.retain_workers(assigned_wids)
        if self.verbose:
            print(f"elastic: epoch {epoch} — {np_} slots on "
                  f"{list(hosts)}", file=sys.stderr)
        for wid, slot in to_spawn:
            self._spawn_worker(wid, slot, coord_addr, coord_port, epoch,
                               driver_addrs[slot.hostname])
        if _metrics.ACTIVE:
            _m_epochs.inc()
        self._notify_workers(notify, update_res)
        self._emit("epoch_applied", epoch=epoch, size=np_,
                   hosts=dict(hosts),
                   spawned=[wid for wid, _ in to_spawn])

    def _spawn_worker(self, wid: int, slot, coord_addr, coord_port, epoch,
                      driver_addr: str):
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update({
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_ELASTIC_WORKER_ID": str(wid),
            # the RPC server runs on this machine; driver_addr was
            # resolved (NIC-aware, once per host) by _resolve_addrs
            "HOROVOD_ELASTIC_DRIVER_ADDR": driver_addr,
            "HOROVOD_ELASTIC_DRIVER_PORT": str(self.port),
            "HOROVOD_HOSTNAME": slot.hostname,
        })
        if self.network_interface:
            # workers resolve their notification endpoint with the same
            # interface selection as the driver (docs/env.md contract);
            # the explicit flag OVERRIDES an inherited env var — only a
            # user-supplied worker env (extra_env) may pin a different
            # interface for workers
            from ..runner.network import ENV_INTERFACE
            if ENV_INTERFACE not in self.extra_env:
                env[ENV_INTERFACE] = self.network_interface
        # keep member and driver formation clocks in phase: a member
        # forming a stale epoch waits until its init timeout before it
        # re-fetches its assignment, so that timeout must not outlast the
        # driver's formation window (user-set values win)
        env.setdefault("HOROVOD_ELASTIC_INIT_TIMEOUT",
                       str(max(5, int(self.start_timeout))))
        if _chaos.ACTIVE:
            _chaos.fire("elastic.spawn", worker_id=wid,
                        hostname=slot.hostname, rank=slot.rank,
                        epoch=epoch)
        proc = self._launch(slot, coord_addr, coord_port, env)
        with self._lock:
            self._workers[wid] = _Worker(wid, slot, proc, epoch)
        self.registry.record_ready(wid, slot.hostname)

    def _launch(self, slot, coord_addr, coord_port, env):
        """Process creation seam (tests substitute a stub)."""
        return spawn.spawn_workers(
            [slot], self.command, coord_addr, coord_port,
            prefix_output=True, base_env=env)[0]

    def _notify_workers(self, targets, update_res: int):
        """Push ``hosts_updated`` to every registered worker, in
        parallel.  Retried (notify_retries, jittered backoff): a lost
        push strands the worker on the stale epoch until its own failure
        detection — the leader-join flake.  Parallel + a short
        per-attempt timeout keep the worst case (black-holed workers
        that swallow packets without RST) bounded by ONE retry chain,
        not one per worker — this runs under _reform_lock, and a slow
        push here would stall reform requests and the monitor."""
        ts = time.time()
        with self._lock:
            epoch, lost = self._epoch, list(self._lost_ranks)

        def push(wid, addr, port):
            try:
                # idempotent=False: a lost-REPLY retry must not deliver
                # the update twice — a duplicate landing after the
                # worker's reset would re-arm its host-message queue and
                # trigger a spurious HostsUpdatedInterrupt
                json_request(addr, port, "hosts_updated",
                             {"timestamp": ts, "res": update_res,
                              "epoch": epoch, "lost": lost},
                             timeout=2.0, retries=self.notify_retries,
                             idempotent=False)
            except Exception:  # noqa: BLE001 - worker may be mid-restart
                logger.warning("could not notify worker %d of host "
                               "update; relying on its failure detection",
                               wid, exc_info=True)

        threads = [threading.Thread(target=push, args=(wid, addr, port),
                                    name=f"hvd-notify-{wid}", daemon=True)
                   for wid, (addr, port) in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # --- monitoring loop ---------------------------------------------------

    def _host_delta(self, new: Dict[str, int]) -> Optional[int]:
        with self._lock:
            cur = dict(self._hosts)
        if new == cur:
            return None
        added = any(h not in cur or s > cur[h] for h, s in new.items())
        removed = any(h not in new or s < cur[h] for h, s in cur.items())
        if added and removed:
            return HostUpdateResult.MIXED
        return (HostUpdateResult.ADDED if added
                else HostUpdateResult.REMOVED)

    def run(self) -> int:
        # wait for enough capacity to start; a transient discovery flake
        # here must not crash the driver before the job ever forms — the
        # start_timeout already bounds how long we keep trying
        deadline = time.monotonic() + self.start_timeout
        while True:
            try:
                hosts = self._discover()
            except Exception:  # noqa: BLE001 - startup discovery flake
                if _metrics.ACTIVE:
                    _m_discovery_failures.inc()
                logger.warning("host discovery failed (startup); "
                               "retrying", exc_info=True)
                hosts = {}
            if self._total_slots(hosts) >= self.min_np:
                break
            if time.monotonic() > deadline:
                print(f"elastic: timed out below min_np={self.min_np}",
                      file=sys.stderr)
                return 1
            time.sleep(self.interval)
        with self._lock:
            self._last_progress = time.monotonic()
        self._apply_hosts(hosts, HostUpdateResult.ADDED)

        try:
            return self._monitor()
        finally:
            # deliver any queued terminal events (job_done/worker_exit)
            # before the daemon dispatch thread dies with the process
            self.flush_listeners()
            self._server.close()

    def _monitor(self) -> int:
        last_poll = 0.0
        done_since = None
        while True:
            now = time.monotonic()
            with self._lock:
                job_done = self._job_done
            if job_done:
                if done_since is None:
                    done_since = now
                elif now - done_since > 60.0:
                    # stragglers stuck in teardown; the job itself finished
                    logger.warning("terminating straggler workers")
                    self._terminate_all()
                    return 0
            if not job_done and now - last_poll >= self.interval:
                last_poll = now
                hosts = self._discover_or_current("monitor poll")
                with self._reform_lock:
                    # delta computed INSIDE the reform lock: a concurrent
                    # request_reform may have just applied this same host
                    # set, and re-applying would double-bump the epoch and
                    # spuriously consume reset budget
                    delta = self._host_delta(hosts)
                    if delta is not None:
                        if self._total_slots(hosts) < self.min_np:
                            print("elastic: below min_np; waiting for hosts",
                                  file=sys.stderr)
                            with self._lock:
                                self._hosts = dict(hosts)  # keep watching
                            self._emit("below_min",
                                       slots=self._total_slots(hosts))
                        else:
                            self._reset_count += 1
                            if (self.reset_limit is not None
                                    and self._reset_count > self.reset_limit):
                                print("elastic: reset limit exceeded",
                                      file=sys.stderr)
                                self._terminate_all()
                                return 1
                            self._apply_hosts(hosts, delta)

            exit_code = self._reap_workers()
            if exit_code is not None:
                return exit_code
            time.sleep(0.1)

    def _reap_workers(self) -> Optional[int]:
        """Handle worker exits; return a final exit code when the job is
        done (all workers succeeded, or failure is unrecoverable)."""
        with self._lock:
            live = list(self._workers.values())
        respawn_needed = False
        counted_failure = False
        for w in live:
            rc = w.proc.popen.poll()
            if rc is None:
                continue
            with self._lock:
                self._workers.pop(w.worker_id, None)
                self._notif.pop(w.worker_id, None)
            if self._serving is not None:
                # any exit (failure, churn, scale-down drain) releases
                # the worker's in-flight serving leases back into the
                # admission queue — zero lost requests under churn
                self._serving.worker_gone(w.worker_id)
            # prune the dead worker's recovery-directory entries (as
            # source and as holder): the replacement's rebuild must see
            # only redundancy that actually survives on live peers
            self._recovery.worker_gone(w.worker_id)
            if w.expected_exit:
                self._emit("worker_exit", worker_id=w.worker_id, rc=rc,
                           kind="expected")
                continue
            if rc == 0 or self.registry.state(
                    w.worker_id) == registration.SUCCESS:
                # a worker that reported SUCCESS before exiting finished
                # its training fn — a messy teardown (e.g. a store that
                # closed under it) must not count as a host failure
                self.registry.record_result(
                    w.worker_id, registration.SUCCESS)
                self._emit("worker_exit", worker_id=w.worker_id, rc=rc,
                           kind="success")
            elif not w.started:
                # died before completing rendezvous (a stale epoch's
                # formation, a dead rank 0's store) — the respawn is the
                # recovery, so don't feed the blacklist or the reset budget
                logger.info("worker %d on %s died during rendezvous "
                            "(rc=%d); respawning", w.worker_id,
                            w.slot.hostname, rc)
                respawn_needed = True
                if _metrics.ACTIVE:
                    _m_restarts.inc(kind="churn")
                self._emit("worker_exit", worker_id=w.worker_id, rc=rc,
                           kind="churn")
            else:
                self.registry.record_result(
                    w.worker_id, registration.FAILURE, w.slot.hostname)
                logger.warning("worker %d on %s exited rc=%d",
                               w.worker_id, w.slot.hostname, rc)
                respawn_needed = True
                counted_failure = True
                if _metrics.ACTIVE:
                    _m_restarts.inc(kind="failure")
                    _m_blacklist.set(
                        len(self.registry.blacklisted_hosts()))
                self._emit("worker_exit", worker_id=w.worker_id, rc=rc,
                           kind="failure")

        with self._lock:
            n_live = sum(1 for w in self._workers.values()
                         if not w.expected_exit)
            job_done = self._job_done
        if job_done:
            if n_live == 0:
                return 0
            return None  # let the remaining workers drain
        if respawn_needed:
            with self._lock:
                stalled = (time.monotonic() - self._last_progress
                           > self.start_timeout)
            if not counted_failure and stalled:
                # pure rendezvous churn with no worker EVER reaching
                # running state for start_timeout: the job cannot form
                print("elastic: no worker completed rendezvous within "
                      f"{self.start_timeout}s", file=sys.stderr)
                self._terminate_all()
                return 1
            hosts = self._discover_or_current("respawn")
            if self._total_slots(hosts) < self.min_np:
                if n_live == 0:
                    print("elastic: no capacity left above failures",
                          file=sys.stderr)
                    return 1
            else:
                if counted_failure:
                    # reset budget is consumed by real failures only,
                    # not by re-rendezvous churn respawns
                    self._reset_count += 1
                    if (self.reset_limit is not None
                            and self._reset_count > self.reset_limit):
                        self._terminate_all()
                        return 1
                # re-form the job without the failed worker's process;
                # a replacement is spawned if its host still has capacity
                self._apply_hosts(hosts, HostUpdateResult.MIXED)
            return None
        if n_live == 0:
            # everyone exited voluntarily: success iff no failures recorded
            return 0
        return None

    def _terminate_all(self):
        with self._lock:
            live = list(self._workers.values())
        for w in live:
            try:
                w.proc.popen.terminate()
            except Exception:  # noqa: BLE001
                pass


def run_elastic_launcher(args) -> int:
    """Entry from ``hvdrun-torch --host-discovery-script ...``
    (launch.py)."""
    discovery = HostDiscoveryScript(args.host_discovery_script)
    min_np = args.min_np or args.np or 1
    driver = ElasticDriver(
        discovery, args.command, min_np=min_np, max_np=args.max_np,
        port=args.port, start_timeout=args.start_timeout,
        verbose=args.verbose,
        network_interface=args.network_interface)
    from ..config import _env_bool
    if _env_bool("HOROVOD_SERVE", False):
        # the driver doubles as the serving plane's admission endpoint:
        # workers (whose script runs ServingWorker against
        # HOROVOD_ELASTIC_DRIVER_ADDR/PORT) pull from the same control
        # server clients submit to (docs/serving.md)
        from ..serving.plane import ServingPlane
        driver.attach_serving(ServingPlane())
    return driver.run()
