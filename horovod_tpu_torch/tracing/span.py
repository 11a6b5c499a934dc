"""Per-worker span records: the raw material of the job-wide trace.

Counterpart: ``horovod_tpu/tracing/span.py``, copied (it imports no jax).

A :class:`SpanBuffer` is a bounded ring of closed spans, each tagged
with the negotiation round id and elastic epoch of the cycle it
belongs to — the correlation key that lets the driver line spans up
ACROSS workers without any shared clock (the round id advances in
lockstep on every member of a negotiation group; OptiReduce's
observation is that *which host's which phase* gated a round is the
question per-process timelines cannot answer, arXiv:2310.06993).

Timestamps are seconds on the buffer's own ``clock`` (default
``time.monotonic`` — per-host, arbitrary epoch).  The driver-side
merger (:mod:`.merge`) estimates each host's clock offset from RPC
request/response timestamps and maps every span onto its own clock;
nothing here needs wall-clock time or NTP.

Hot-path discipline (as in ``metrics``): instrumented sites guard
on ``tracing.ACTIVE`` so a disabled tracer costs one false branch;
``add()`` itself is a dict build + deque append under a lock.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

#: Spans kept per worker (ring; oldest dropped).  HOROVOD_TRACE_BUFFER.
DEFAULT_CAPACITY = 4096

#: Span categories the critical-path analyzer orders a round's DAG by
#: (submit → negotiate → fuse → dispatch → dcn); other categories
#: (``cycle`` envelope, trace-time ``overlap`` staging) ride the merged
#: trace but are not on the round path.
PHASES = ("submit", "negotiate", "fuse", "dispatch", "dcn")


class SpanBuffer:
    """Bounded ring of closed spans plus the identity/context tags the
    job-wide merge needs (host, process rank, elastic epoch, current
    negotiation round)."""

    def __init__(self, capacity: Optional[int] = None,
                 host: Optional[str] = None, process: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        # a malformed capacity (0, negative) degrades to the default —
        # this constructor runs at package import, and deque(maxlen=-1)
        # raising there would turn one bad env var into a failed
        # `import horovod_tpu`
        capacity = int(capacity or DEFAULT_CAPACITY)
        self.capacity = capacity if capacity > 0 else DEFAULT_CAPACITY
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: "deque" = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0
        self.host = host or (os.environ.get("HOROVOD_HOSTNAME")
                             or socket.gethostname())
        self.process = int(process)
        self._epoch = 0
        self._round = -1
        self._cycle = -1
        self._group = ""

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        """The buffer's clock.  Instrumentation sites stamp spans with
        this (NOT ``time.monotonic()`` directly) so tests can inject a
        skewed per-host clock and exercise the offset estimation the
        production path relies on."""
        return self._clock()

    # -- identity / context ---------------------------------------------------
    def set_identity(self, process: Optional[int] = None,
                     host: Optional[str] = None,
                     epoch: Optional[int] = None):
        with self._lock:
            if process is not None:
                self.process = int(process)
            if host:
                self.host = str(host)
            if epoch is not None:
                self._epoch = int(epoch)

    def set_context(self, round: Optional[int] = None,
                    cycle: Optional[int] = None,
                    epoch: Optional[int] = None,
                    group: Optional[str] = None):
        """Tag subsequent spans with the current negotiation round id /
        engine cycle / elastic epoch / negotiation group key.  Round
        ids are PER GROUP sequence numbers, so ``group`` disambiguates
        them when a job runs subset process sets alongside the global
        one ("" = no controller round — cycle-count correlation).
        Called by the engine thread once per cycle; spans recorded from
        other threads (e.g. trace-time overlap staging) pass an
        explicit ``round=-1`` instead of trusting this cycle-scoped
        state."""
        with self._lock:
            if round is not None:
                self._round = int(round)
            if cycle is not None:
                self._cycle = int(cycle)
            if epoch is not None:
                self._epoch = int(epoch)
            if group is not None:
                self._group = str(group)

    # -- recording ------------------------------------------------------------
    def add(self, cat: str, name: str, t0: float, t1: float,
            round: Optional[int] = None, group: Optional[str] = None,
            **args):
        """Record one closed span.  ``round=None``/``group=None``
        inherit the current context; args must be JSON-serializable
        (they ride the scrape reply verbatim)."""
        with self._lock:
            self._seq += 1
            if len(self._spans) >= self.capacity:
                self.dropped += 1
            self._spans.append({
                "seq": self._seq, "cat": str(cat), "name": str(name),
                "t0": float(t0), "t1": float(t1),
                "round": self._round if round is None else int(round),
                "group": self._group if group is None else str(group),
                "epoch": self._epoch, "cycle": self._cycle,
                "args": args,
            })

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def set_capacity(self, capacity: int):
        """Resize the ring in place (elastic re-init with a changed
        ``HOROVOD_TRACE_BUFFER``), keeping the newest spans and every
        identity/context tag.  Non-positive values degrade to the
        default (see ``__init__``)."""
        capacity = int(capacity)
        if capacity <= 0:
            capacity = DEFAULT_CAPACITY
        with self._lock:
            if capacity == self.capacity:
                return
            self.capacity = capacity
            self._spans = deque(self._spans, maxlen=capacity)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- scraping -------------------------------------------------------------
    def snapshot(self) -> Dict:
        """The scrape payload: identity + a copy of the ring + ``now``
        sampled on this buffer's clock (the merger's probe replies use
        the same field, so span timestamps and offset estimates are on
        one clock by construction)."""
        with self._lock:
            spans: List[Dict] = [dict(s) for s in self._spans]
            return {"host": self.host, "process": self.process,
                    "epoch": self._epoch, "dropped": self.dropped,
                    "capacity": self.capacity, "now": self.now(),
                    "spans": spans}

    def pull_handler(self):
        """A ``JsonRpcServer`` POST handler serving this buffer:
        ``{"probe": true}`` returns just ``now`` (clock-offset probe,
        kept tiny so the RTT bound stays tight); anything else returns
        the full :meth:`snapshot`."""
        def handle(payload):
            if isinstance(payload, dict) and payload.get("probe"):
                with self._lock:   # identity may be re-set at re-init
                    host, process = self.host, self.process
                # the clock sample deliberately comes LAST, outside the
                # lock: the probe's RTT bound covers the sample point,
                # and a lock wait inside the bracket only widens it
                return {"now": self.now(), "host": host,
                        "process": process}
            return self.snapshot()
        return handle
