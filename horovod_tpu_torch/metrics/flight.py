"""Crash flight recorder: a bounded ring of recent structured events.

When a worker dies today the only artifact is a stack trace; the events
that *led* there — elastic epoch churn, RPC retries, chaos injections,
stall warnings, engine state transitions — are gone.  This ring keeps
the last N of them (cheap: one deque append per low-frequency event)
and dumps them:

* on ``StallError`` (stall inspector aborts, controller peer-wait
  aborts),
* on a fatal engine-thread exception,
* on ``SIGUSR1`` (operator-triggered black-box read of a live process),
* attached to a worker's FAILURE report so the elastic driver logs the
  last events of a crashed worker.

Dump format (``HOROVOD_FLIGHT_RECORDER_PATH``, else stderr): one header
JSON line ``{"flight_recorder": ..., "reason": ..., "events": N}``
followed by one JSON object per event in recording order, each
``{"seq": n, "t": monotonic_s, "wall": unix_s, "kind": ..., **fields}``.
Dumps append, so a stall dump and a later crash dump of the same
process coexist in one file.

Counterpart: ``horovod_tpu/metrics/flight.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger("horovod_tpu_torch")

DEFAULT_CAPACITY = 512


def _jsonable(value):
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return repr(value)


class FlightRecorder:
    """Thread-safe bounded event ring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._seq = 0
        self._dumps = 0

    def record(self, kind: str, /, **fields):
        ev = {"kind": str(kind)}
        for k, v in fields.items():
            if k in ("kind", "seq", "t", "wall"):
                k += "_"   # reserved envelope keys; keep the field
            ev[k] = _jsonable(v)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            ev["t"] = round(time.monotonic(), 6)
            ev["wall"] = round(time.time(), 3)
            self._ring.append(ev)

    def events(self, limit: Optional[int] = None) -> List[Dict]:
        """Most recent ``limit`` events, oldest first."""
        with self._lock:
            evs = list(self._ring)
        return evs[-limit:] if limit else evs

    def clear(self):
        with self._lock:
            self._ring.clear()

    @property
    def dumps(self) -> int:
        with self._lock:   # written under the lock in dump() (HVD113)
            return self._dumps

    def dump(self, reason: str, path: Optional[str] = None,
             limit: Optional[int] = None) -> int:
        """Write the ring to ``path`` (append) or stderr; returns the
        number of events written.  Never raises: this runs on failure
        paths where a second error would mask the first."""
        evs = self.events(limit)
        header = {"flight_recorder": "horovod_tpu_torch", "reason": reason,
                  "pid": os.getpid(), "wall": round(time.time(), 3),
                  "events": len(evs)}
        try:
            lines = [json.dumps(header, separators=(",", ":"))]
            lines += [json.dumps(ev, separators=(",", ":"))
                      for ev in evs]
            blob = "\n".join(lines) + "\n"
            if path:
                with open(path, "a") as f:
                    f.write(blob)
            else:
                # leading newline: stderr may be mid-line (e.g. a test
                # runner's progress dots) — never splice into it
                sys.stderr.write("\n" + blob)
                sys.stderr.flush()
            with self._lock:
                self._dumps += 1
            return len(evs)
        except Exception:  # noqa: BLE001 - never mask the primary failure
            logger.debug("flight recorder dump failed", exc_info=True)
            return 0
