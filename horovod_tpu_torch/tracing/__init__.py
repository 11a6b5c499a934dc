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

Every instrumented site guards on ``tracing.ACTIVE``: one attribute load
and a false branch under ``HOROVOD_TRACE=0``.  The knobs keep the JAX
package's names and meanings: ``HOROVOD_TRACE`` (default on),
``HOROVOD_TRACE_BUFFER`` (spans kept, default 4096) and
``HOROVOD_TRACE_PROBES`` (clock probes a scrape, default 3).
"""

from __future__ import annotations

import os
from typing import Optional

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
