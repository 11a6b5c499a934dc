"""Job-wide distributed tracing: clock-aligned merged timelines and
critical-path attribution.

Counterpart: ``horovod_tpu/tracing/__init__.py``.  The per-rank
``HOROVOD_TIMELINE`` (``timeline.py``) answers "what did MY process do";
this package answers the multi-host question: *which host's which phase
gated each round*.

* Every rank keeps a bounded ring of span records
  (:class:`~.span.SpanBuffer`) for its engine cycles, negotiation rounds,
  fusion planning, per-bucket dispatches, tail rounds (deadline and
  excluded hosts) and the overlap plan's staging, each tagged with the
  negotiation round id and elastic epoch: the correlation key that works
  without a global clock.
* The elastic driver's ``GET /trace/job`` (``metrics/jobscrape.py``)
  pulls every worker's buffer over the RPC transport, estimates each
  host's clock offset from the request and reply timestamps (the
  midpoint method, its RTT/2 error bound recorded on every span) and
  returns ONE Chrome-trace JSON with one ``pid`` per host
  (:mod:`.merge`).  ``GET /trace`` on any server is this process's view.
* ``python -m horovod_tpu_torch.tracing`` (hvdtrace, :mod:`.critical`)
  walks each round's spans (submit → negotiate → fuse → dispatch → dcn)
  and attributes the round's time to the gating (host, phase), a
  per-host gating-fraction table.

The port adds the training step's own spans (:mod:`.steps`): a ``step``
envelope a call of the data-parallel Llama and BERT steps with its
``forward``, ``backward``, ``exchange`` and ``optimizer`` phases, the
step's ``wait_ms``, ``queue_ms`` and ``gc_ms``, and one ``gc`` span a
Python collection of the older generations; the engine's spans of a
step's entries carry its id.

One clock with the device trace: spans stay on ``time.monotonic`` (the
merge's offsets rely on it), and the buffer keeps an anchor, a
``(monotonic, time.time_ns())`` pair sampled at ``hvd.init()``, that maps
a span onto the Unix-epoch clock of ``torch.profiler``'s events
(``SpanBuffer.unix_ns``).  ``hvd.stop_profiler()`` appends the ring's
spans of the capture's interval to the Chrome trace it writes
(:func:`profile_events`), so the engine thread's spans sit beside the
kernels.  While a torch profiler records on a thread (or
``hvd.start_profiler``'s every-thread capture runs), the step's sites and
the engine's dispatch open ``record_function`` ranges (``hvd.step``,
``hvd.forward``, ``hvd.backward``, ``hvd.exchange``, ``hvd.optimizer``,
``hvd.<op>[<tensors>]``), so a capture labels the device's idle
stretches by the program's phase.

Every instrumented site guards on ``tracing.ACTIVE``: one attribute load
and a false branch under ``HOROVOD_TRACE=0``.  The knobs keep the JAX
package's names and meanings: ``HOROVOD_TRACE`` (default on),
``HOROVOD_TRACE_BUFFER`` (spans kept, default 4096) and
``HOROVOD_TRACE_PROBES`` (clock probes a scrape, default 3).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import critical, merge  # noqa: F401  (re-export for driver/tools)
from .span import DEFAULT_CAPACITY, PHASES, SpanBuffer  # noqa: F401

ENV_ENABLE = "HOROVOD_TRACE"
ENV_CAPACITY = "HOROVOD_TRACE_BUFFER"
ENV_PROBES = "HOROVOD_TRACE_PROBES"


def _env_on(name: str, default: bool = True, environ=os.environ) -> bool:
    from ..config import _env_bool  # one truthy grammar package-wide
    return _env_bool(name, default, environ)


def _env_capacity(environ=os.environ) -> int:
    try:
        return int(environ.get(ENV_CAPACITY, "") or DEFAULT_CAPACITY)
    except ValueError:
        return DEFAULT_CAPACITY


def probes(environ=os.environ) -> int:
    """Clock probes a scrape (``HOROVOD_TRACE_PROBES``, default 3; more
    probes tighten the min-RTT offset bound at scrape cost)."""
    try:
        return max(int(environ.get(ENV_PROBES, "3")), 1)
    except ValueError:
        return 3


#: Hot-path guard (one false branch when HOROVOD_TRACE=0).
ACTIVE = _env_on(ENV_ENABLE)

_BUFFER = SpanBuffer(capacity=_env_capacity())


def buffer() -> SpanBuffer:
    """The process-wide default span buffer (what ``trace_pull``
    serves)."""
    return _BUFFER


def swap_buffer(buf: SpanBuffer) -> SpanBuffer:
    """Replace the default buffer, returning the old one (tests: isolates
    a scenario's spans; sites read the module default per call)."""
    global _BUFFER
    old, _BUFFER = _BUFFER, buf
    return old


def now() -> float:
    """The default buffer's clock (sites stamp spans with this, so tests
    can inject skewed clocks)."""
    return _BUFFER.now()


def span(cat: str, name: str, t0: float, t1: float,
         round: Optional[int] = None, group: Optional[str] = None,
         **args):
    """Record one closed span into the default buffer (call sites guard
    on ``tracing.ACTIVE``)."""
    if ACTIVE:
        _BUFFER.add(cat, name, t0, t1, round=round, group=group, **args)


def set_context(round: Optional[int] = None, cycle: Optional[int] = None,
                epoch: Optional[int] = None,
                group: Optional[str] = None):
    _BUFFER.set_context(round=round, cycle=cycle, epoch=epoch,
                        group=group)


def set_identity(process: Optional[int] = None, host: Optional[str] = None,
                 epoch: Optional[int] = None):
    _BUFFER.set_identity(process=process, host=host, epoch=epoch)


def pull_handler(payload):
    """``JsonRpcServer`` POST handler over the CURRENT default buffer
    (resolved per call, so ``swap_buffer`` takes effect)."""
    return _BUFFER.pull_handler()(payload)


def local_trace() -> dict:
    """This process's buffer as a Chrome trace (``GET /trace``)."""
    return merge.local_trace(_BUFFER)


def enable():
    global ACTIVE
    ACTIVE = True


def disable():
    global ACTIVE
    ACTIVE = False


def init_from_env(environ=os.environ):
    """Apply the HOROVOD_TRACE* contract (called from ``hvd.init()``;
    idempotent across elastic re-inits): refresh the ACTIVE flag and
    resize the default buffer if the capacity changed (the newest spans
    are kept: a re-init mid-job must not drop the history a post-mortem
    scrape wants)."""
    global ACTIVE
    ACTIVE = _env_on(ENV_ENABLE, environ=environ)
    _BUFFER.set_capacity(_env_capacity(environ))


#: Chrome-trace thread ids of the appended span lanes start here, above
#: any OS thread id or device stream the profiler writes
_LANE_TID = 1_000_000_000


def profile_events(t_lo: float, t_hi: float, base_ns: int,
                   pid: int) -> List[Dict]:
    """The default buffer's spans that lie within ``[t_lo, t_hi]`` (its
    clock), rendered by :func:`merge.chrome_trace` (one lane a category,
    each span under its own name and category) and moved onto a
    profiler's time base: microseconds after ``base_ns`` on the
    Unix-epoch clock, under ``pid``."""
    steps.flush_gc()
    snap = _BUFFER.snapshot()
    snap["spans"] = [s for s in snap["spans"]
                     if t_lo <= s["t0"] and s["t1"] <= t_hi]
    if not snap["spans"]:
        return []
    first = min(s["t0"] for s in snap["spans"])
    shift_us = (_BUFFER.unix_ns(first) - base_ns) / 1e3
    events: List[Dict] = []
    for e in merge.chrome_trace({"local": (snap, 0.0, 0.0)})["traceEvents"]:
        if e["ph"] == "M" and e["name"] == "process_name":
            continue
        e = dict(e, pid=pid, tid=_LANE_TID + e["tid"])
        if e["ph"] == "X":
            e["ts"] += shift_us
        events.append(e)
    return events


from . import steps  # noqa: E402  (reads ACTIVE, now and span above)
from .steps import phase, profiler_range, step  # noqa: E402,F401
