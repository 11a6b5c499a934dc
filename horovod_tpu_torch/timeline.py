"""Chrome-trace timeline of per-tensor collective lifecycles.

Counterpart: ``horovod_tpu/timeline.py``, copied.  After the reference's
``horovod/common/timeline.cc``: every tensor's journey is recorded as
Chrome trace events (open the file in ``chrome://tracing`` or Perfetto):
NEGOTIATE_<OP> → QUEUED → MEMCPY_IN_FUSION_BUFFER → <OP> → DONE.  A
writer thread drains an event queue, so the engine's hot path only
enqueues.  The thread serialises each event; with the native core
loaded (``core``, from ``hvd.init()``) it hands the JSON to the core's
``TimelineWriter``, whose own C++ thread does the file I/O (the
reference's TimelineWriter), else it writes the file itself.
``HOROVOD_TIMELINE`` enables it;
``HOROVOD_TIMELINE_MARK_CYCLES=1`` adds one instant event per background
cycle; ``hvd.start_timeline``/``stop_timeline`` reopen and close it at
run time.

The timeline covers the framework layer (negotiation, queueing, fusion);
``torch.profiler`` traces the kernels and NCCL/gloo calls themselves.
Both are trace-event JSON, so they merge in Perfetto.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import List, Optional

#: Distinct tensor lanes per incarnation (file).  Past the cap, new names
#: share one "overflow" lane (tid 0) instead of growing the table without
#: bound under unbounded user-named streams.
MAX_TENSOR_TIDS = 4096


class Timeline:
    def __init__(self, path: Optional[str], mark_cycles: bool = False,
                 core=None):
        self._path = None
        self._core = core
        self._native = None     # core.TimelineWriter of the open file
        self._mark_cycles = mark_cycles
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._file = None
        self._first = True
        self._t0 = time.monotonic()
        self._tensor_tids = {}
        self._next_tid = 1
        self._overflow_named = False
        self._lock = threading.Lock()
        if path:
            self.reopen(path, mark_cycles)

    @property
    def enabled(self) -> bool:
        return self._path is not None

    def reopen(self, path: str, mark_cycles: bool = False):
        self.close()
        self._path = path
        self._mark_cycles = mark_cycles
        if self._core is not None:
            self._native = self._core.TimelineWriter(path)
        else:
            self._file = open(path, "w")
            self._file.write("[\n")
        self._first = True
        # per-incarnation tid table: the thread_name metadata events live
        # in the previous file, so names re-register (and re-emit their
        # metadata) on first use in the new one
        with self._lock:
            self._tensor_tids = {}
            self._next_tid = 1
            self._overflow_named = False
        self._thread = threading.Thread(
            target=self._writer_loop, name="hvd-timeline", daemon=True)
        self._thread.start()

    def close(self):
        if self._file is None and self._native is None:
            return
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._native is not None:
            # drains the native queue, writes the JSON tail, closes
            self._native.close()
            self._native = None
        if self._file is not None:
            self._file.write("\n]\n")
            self._file.close()
            self._file = None
        self._path = None

    # -- event API (called from the engine) ---------------------------------
    def _ts_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    def _tid(self, name: str) -> int:
        with self._lock:
            tid = self._tensor_tids.get(name)
            if tid is None:
                if len(self._tensor_tids) >= MAX_TENSOR_TIDS:
                    # bounded per incarnation: overflow names share the
                    # cycle-marker lane, named once
                    if not self._overflow_named:
                        self._overflow_named = True
                        self._emit({"name": "thread_name", "ph": "M",
                                    "pid": 0, "tid": 0,
                                    "args": {"name": "overflow"}})
                    return 0
                tid = self._next_tid
                self._next_tid += 1
                self._tensor_tids[name] = tid
                self._emit({"name": "thread_name", "ph": "M", "pid": 0,
                            "tid": tid, "args": {"name": name}})
            return tid

    def negotiate_start(self, name: str, op_type: str):
        """Open the NEGOTIATE span at submission; it stays open until the
        entry makes a cycle's agreed dispatch set (``negotiate_end``): the
        queue wait plus the negotiation rounds it sat through."""
        if not self.enabled:
            return
        tid = self._tid(name)
        self._emit({"name": f"NEGOTIATE_{op_type.upper()}", "ph": "B",
                    "pid": 0, "tid": tid, "ts": self._ts_us()})

    def negotiate_end(self, name: str):
        """Close the NEGOTIATE span and open QUEUED (dispatch imminent)."""
        if not self.enabled:
            return
        tid = self._tid(name)
        ts = self._ts_us()
        self._emit({"name": "", "ph": "E", "pid": 0, "tid": tid, "ts": ts})
        self._emit({"name": "QUEUED", "ph": "B", "pid": 0, "tid": tid,
                    "ts": ts})

    def activity_start(self, names: List[str], activity: str,
                       args: Optional[dict] = None):
        """``args`` (JSON-serializable) ride the opening "B" event."""
        if not self.enabled:
            return
        for name in names:
            tid = self._tid(name)
            self._emit({"name": "QUEUED", "ph": "E", "pid": 0, "tid": tid,
                        "ts": self._ts_us()})
            ev = {"name": activity, "ph": "B", "pid": 0, "tid": tid,
                  "ts": self._ts_us()}
            if args:
                ev["args"] = args
            self._emit(ev)

    def activity_transition(self, names: List[str], activity: str,
                            args: Optional[dict] = None):
        if not self.enabled:
            return
        for name in names:
            tid = self._tid(name)
            ts = self._ts_us()
            self._emit({"name": "", "ph": "E", "pid": 0, "tid": tid,
                        "ts": ts})
            ev = {"name": activity, "ph": "B", "pid": 0, "tid": tid,
                  "ts": ts}
            if args:
                ev["args"] = args
            self._emit(ev)

    def activity_end(self, names: List[str]):
        if not self.enabled:
            return
        for name in names:
            self._emit({"name": "", "ph": "E", "pid": 0,
                        "tid": self._tid(name), "ts": self._ts_us()})

    def end(self, name: str):
        """Mark the tensor's lifecycle complete (reference: DONE state)."""
        if not self.enabled:
            return
        self._emit({"name": "DONE", "ph": "i", "pid": 0,
                    "tid": self._tid(name), "ts": self._ts_us(), "s": "t"})

    def cycle_mark(self, cycle: int):
        if not self.enabled or not self._mark_cycles:
            return
        self._emit({"name": "CYCLE_START", "ph": "i", "pid": 0, "tid": 0,
                    "ts": self._ts_us(), "s": "g",
                    "args": {"cycle": cycle}})

    def _emit(self, event: dict):
        if self._native is not None or self._file is not None:
            self._queue.put(event)

    def _writer_loop(self):
        while True:
            ev = self._queue.get()
            if ev is None:
                return
            s = json.dumps(ev)
            native, f = self._native, self._file
            if native is not None:
                native.write(s)  # a no-op once the writer closed
                continue
            if f is None:
                return  # closed out from under us (join timed out)
            prefix = "" if self._first else ",\n"
            self._first = False
            try:
                f.write(prefix + s)
            except ValueError:
                return  # file closed
