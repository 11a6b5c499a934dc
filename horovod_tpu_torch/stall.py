"""Stall inspector: collectives stuck in the queue, and stragglers.

Counterpart: ``horovod_tpu/stall.py``, copied, after the reference's
``horovod/common/stall_inspector.cc``: a tensor some ranks submitted and
others have not, for ``HOROVOD_STALL_CHECK_TIME_SECONDS``, is logged with
the ranks the negotiation reports missing.  With the native core loaded
(``core``, from ``hvd.init()``) its ``StallTracker`` keeps the pending and
warned tables, as in the JAX package, and the Python ones stay empty; it
runs with ``shutdown_time=0``, since here the controller aborts (below).

One difference, deliberate: the JAX inspector raises ``StallError`` on its
own process past ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``.  In the port the
negotiation controller aborts instead, on every rank in the same round,
with ``DivergenceError`` (``ops/controller.py``), past its deadline (that
knob, or 300 s); the inspector is the clock that decides it: the engine
asks :meth:`StallInspector.overdue` whether an entry has waited past the
deadline, so there is one clock.

The inspector also keeps a straggler score per rank or host group: an
EWMA of observed arrival lateness, fed by the tail rounds of the
hierarchical allreduce (``ops/collectives.tail_round``) and by the
negotiation (a rank reported missing and later present was late by the
gap).  ``on_straggler`` fires edge-triggered when a score crosses
``HOROVOD_TAIL_BLACKLIST_SCORE``; ``runtime.init`` wires it to the
elastic worker's ``report_straggler``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List

from . import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch")

_m_warnings = _metrics.counter(
    "hvd_stall_warnings_total",
    "Stall-inspector warning batches issued")
_m_straggler = _metrics.gauge(
    "hvd_straggler_score",
    "Per-host straggler score: EWMA of observed collective-arrival "
    "lateness (seconds); feeds the elastic blacklist as a soft failure "
    "past HOROVOD_TAIL_BLACKLIST_SCORE", labels=("process",))
_m_lateness = _metrics.histogram(
    "hvd_tail_lateness_seconds",
    "Observed per-host DCN arrival lateness (every observation the "
    "straggler EWMA ingests, incl. 0.0 on-time rounds)",
    labels=("process",), lo=-10, hi=7)

#: EWMA weight of one observed arrival lateness: a chronically slow host
#: crosses a seconds-scale bar within a handful of rounds, one hiccup
#: decays away.
EWMA_ALPHA = 0.25


class StallInspector:
    def __init__(self, check_time: float = 60.0, disabled: bool = False,
                 blacklist_score: float = 0.0, on_straggler=None, core=None):
        self.check_time = check_time
        self.disabled = disabled or check_time <= 0
        self.blacklist_score = float(blacklist_score)
        self.on_straggler = on_straggler
        self._scores: Dict[int, float] = {}
        self._flagged: set = set()
        # (name, process) -> when the controller first reported the
        # process missing for that tensor (lateness = clear time - this)
        self._missing_since: Dict[tuple, float] = {}
        # guards the tables below: record_enqueue runs on the submitting
        # thread while check() scans on the engine thread
        self._lock = threading.Lock()
        # the pending and warned tables, when there is no native tracker
        self._pending: Dict[str, float] = {}
        self._warned: Dict[str, float] = {}
        # tensor name -> ranks that have not submitted it, reported by
        # the negotiation controller
        self._missing: Dict[str, list] = {}
        self.warnings_issued = 0
        # the native tracker (reference: stall_inspector.cc): it keeps
        # the pending and warned tables in place of the dicts above
        self._native = (core.StallTracker(check_time=check_time,
                                          shutdown_time=0.0)
                        if core is not None and not self.disabled else None)

    def record_enqueue(self, name: str, t: float):
        """Note ``name`` pending since ``t`` (tracked while disabled too:
        it is the clock of the controller's abort)."""
        if self._native is not None:
            self._native.record_enqueue(name, t)
            return
        with self._lock:
            self._pending.setdefault(name, t)

    def record_missing(self, name: str, processes, now: float = None):
        """Record which ranks have not announced ``name`` (from the
        controller's round).  The first round that reports a rank missing
        stamps the time; the round that no longer reports it (or
        :meth:`record_complete`) turns the gap into an observed lateness
        for the straggler EWMA."""
        if self.disabled:
            return
        now = time.monotonic() if now is None else now
        cleared = []
        with self._lock:
            procs = sorted(set(int(p) for p in processes))
            self._missing[name] = procs
            live = set(procs)
            for p in procs:
                self._missing_since.setdefault((name, p), now)
            for key in [k for k in self._missing_since
                        if k[0] == name and k[1] not in live]:
                cleared.append((key[1], now - self._missing_since.pop(key)))
        for p, lateness in cleared:
            self.note_lateness(p, lateness, now=now)

    def missing_processes(self, name: str) -> List[int]:
        with self._lock:
            return list(self._missing.get(name, []))

    def missing_since(self, name: str, process: int):
        """When ``process`` was first reported missing for ``name`` (None
        if it is not missing now)."""
        with self._lock:
            return self._missing_since.get((name, int(process)))

    def note_lateness(self, process: int, lateness_s: float,
                      now: float = None):
        """Feed one observed arrival lateness (seconds; 0.0 = on time)
        into ``process``'s straggler EWMA; fires ``on_straggler``
        edge-triggered past ``blacklist_score``, re-armed once the score
        decays below half the bar."""
        if self.disabled:
            return
        p = int(process)
        fire = None
        with self._lock:
            score = self._scores.get(p, 0.0)
            score += EWMA_ALPHA * (max(float(lateness_s), 0.0) - score)
            self._scores[p] = score
            if self.blacklist_score > 0:
                if score >= self.blacklist_score and p not in self._flagged:
                    self._flagged.add(p)
                    fire = score
                elif (score < self.blacklist_score / 2.0
                      and p in self._flagged):
                    self._flagged.discard(p)
        if _metrics.ACTIVE:
            _m_straggler.set(score, process=str(p))
            _m_lateness.observe(max(float(lateness_s), 0.0),
                                process=str(p))
        if fire is not None and self.on_straggler is not None:
            # outside the lock: the hook may call the elastic driver
            try:
                self.on_straggler(p, fire)
            except Exception:  # noqa: BLE001 - must not fail the dispatch
                logger.warning("straggler report hook failed",
                               exc_info=True)

    def straggler_scores(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._scores)

    def record_complete(self, name: str, now: float = None):
        now = time.monotonic() if now is None else now
        cleared = []
        with self._lock:
            self._missing.pop(name, None)
            # a rank still missing when the tensor completes arrived last:
            # its lateness is the whole missing -> complete gap
            for key in [k for k in self._missing_since if k[0] == name]:
                cleared.append((key[1], now - self._missing_since.pop(key)))
            if self._native is not None:
                self._native.record_complete(name)
            else:
                self._warned.pop(name, None)
                self._pending.pop(name, None)
        for p, lateness in cleared:
            self.note_lateness(p, lateness, now=now)

    def overdue(self, name: str, bar_s: float, now: float = None) -> bool:
        """Whether ``name`` has been pending longer than ``bar_s``: the
        engine then flags its round, and the controller raises
        ``DivergenceError`` on every rank if the round still finds it
        missing."""
        now = time.monotonic() if now is None else now
        if self._native is not None:
            t0 = self._native.pending_since(name)
        else:
            with self._lock:
                t0 = self._pending.get(name)
        return t0 is not None and now - t0 > bar_s

    def check(self, now: float = None):
        """Scan the pending tensors and warn on stalls (once per engine
        cycle; reference: CheckForStalledTensors)."""
        if self.disabled:
            return
        now = time.monotonic() if now is None else now
        if self._native is not None:
            # the tracker marks what it returns as warned
            stalled, _ = self._native.check(now)
        else:
            with self._lock:
                stalled = [(name, now - t0)
                           for name, t0 in self._pending.items()
                           if now - t0 > self.check_time
                           and name not in self._warned]
                for name, _ in stalled:
                    self._warned[name] = now
        self._warn(stalled)

    def describe(self, name: str, age: float) -> str:
        missing = self.missing_processes(name)
        if missing:
            return f"{name} ({age:.0f}s; missing on ranks {missing})"
        return f"{name} ({age:.0f}s)"

    def _warn(self, stalled):
        if not stalled:
            return
        with self._lock:
            self.warnings_issued += 1
        if _metrics.ACTIVE:
            _m_warnings.inc()
        if _metrics.RECORDING:
            _metrics.event("stall.warning",
                           tensors=[n for n, _ in stalled])
        names = ", ".join(self.describe(n, a) for n, a in stalled)
        logger.warning(
            "One or more tensors were submitted to be reduced/gathered "
            "but were not dispatched for over %.0f seconds: [%s]. "
            "Ranks listed as missing have not announced the tensor in "
            "negotiation.", self.check_time, names)
