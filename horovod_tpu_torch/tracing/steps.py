"""Step-phase spans, the collector's pauses and the profiler's ranges.

The port's own: the JAX package compiles a step into one program, so it
has no host phases to time.  A step the port assembles
(``training.make_llama_train_step``'s data-parallel ``step_fn``,
``models.bert.make_dp_finetune_step``'s ``step_fn`` and ``grads_fn``)
runs inside :class:`step`, and its phases inside :class:`phase`:

* ``step`` (category ``step``): the envelope, one a call.  Its args:
  ``step``, a sequence id; ``profiled``, whether a torch profiler was
  recording on the step's thread when it began; and the step's own
  ``wait_ms`` (host time the submitting threads spent blocked in
  ``Handle.synchronize``/``wait``), ``queue_ms`` (the engine's enqueue to
  drain, the interval its ``submit`` spans cover) and ``gc_ms`` (Python's
  collections), each the change of a cumulative counter over the step.
* ``forward`` (the loss), ``backward`` (``autograd.grad`` or
  ``.backward()``), ``exchange`` (the engine submission to the last handle
  synchronised) and ``optimizer`` (``opt.step()`` and ``zero_grad``, the
  ZeRO gather): category ``step``, arg ``parent`` the step's id.  A phase
  opened outside a step, or inside another phase, records nothing.
* ``gc`` (category ``gc``): one a collection of generation 1 or 2, args
  ``generation``, ``collected`` and, inside a step, ``step``, from the
  ``gc.callbacks`` hook that ``hvd.init()`` installs under
  ``HOROVOD_TRACE`` (:func:`install`).  The hook times every collection
  into ``gc_ms``; the young generation's, a few hundred a step at a
  fraction of a millisecond each, get no span of their own, as they would
  push the window's steps out of the ring.  The hook may fire inside the
  buffer's lock, so it only queues its record; steps and
  :func:`uninstall` move the queue into the buffer (:func:`flush_gc`).

The engine stamps each entry submitted inside a step with the step's id
(:data:`CURRENT`) and gives its ``submit``, ``cycle``, ``fuse`` and
``dispatch`` spans that ``step`` arg.  While a torch profiler records on
the calling thread (``torch.autograd._profiler_enabled()``), each of these
sites also opens a ``record_function`` range (``hvd.step``,
``hvd.forward``, ``hvd.backward``, ``hvd.exchange``, ``hvd.optimizer``),
whatever ``HOROVOD_TRACE`` says; so does every thread while
``hvd.start_profiler``'s capture runs (:data:`PROFILING`: it records
every thread, and under it that call reads false).  Off the profiler a
site costs that one call.  Spans are recorded from the step's thread with ``round=-1``: the
engine's cycle-scoped round does not describe them.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools

import torch

from .. import tracing as _tracing

#: the open step's id, -1 outside a step (the engine stamps it on entries)
CURRENT = -1
_ids = itertools.count()
_phase_open = False
#: set while ``hvd.start_profiler``'s every-thread capture runs
PROFILING = False
#: the runtime's engine while it is initialized (its wait and queue
#: counters); None otherwise
_engine = None
#: seconds of Python's collections the hook has timed
_gc_s = 0.0
_gc_t0 = 0.0
_gc_pending: "collections.deque" = collections.deque()
_NULL = contextlib.nullcontext()


def profiler_range(name: str):
    """A ``record_function`` range named ``name`` while a torch profiler
    records on this thread or ``hvd.start_profiler``'s capture runs;
    otherwise a context that does nothing."""
    if PROFILING or torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def _counters():
    wait_s, queue_s = (_engine.exchange_s() if _engine is not None
                       else (0.0, 0.0))
    return wait_s, queue_s, _gc_s


class step:
    """``with step():`` around one training step: the ``step`` span and
    ``hvd.step`` range; ``id`` and ``profiled`` once entered."""

    __slots__ = ("id", "profiled", "_outer", "_rng", "_t0", "_c0")

    def __enter__(self):
        global CURRENT
        self.id = next(_ids)
        self._outer, CURRENT = CURRENT, self.id
        self._rng = profiler_range("hvd.step")
        self._rng.__enter__()
        self.profiled = self._rng is not _NULL
        self._t0 = None
        if _tracing.ACTIVE:
            self._c0 = _counters()
            self._t0 = _tracing.now()
        return self

    def __exit__(self, *exc):
        global CURRENT
        try:
            if self._t0 is not None:
                t1 = _tracing.now()
                wait_ms, queue_ms, gc_ms = (
                    1e3 * (b - a) for a, b in zip(self._c0, _counters()))
                flush_gc()
                _tracing.span("step", "step", self._t0, t1, round=-1,
                              group="", step=self.id,
                              profiled=self.profiled, wait_ms=wait_ms,
                              queue_ms=queue_ms, gc_ms=gc_ms)
        finally:
            self._rng.__exit__(*exc)
            CURRENT = self._outer
        return False


class phase:
    """``with phase(name):`` around one phase of the open step: a span in
    category ``step`` and an ``hvd.<name>`` range."""

    __slots__ = ("name", "_parent", "_rng", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _phase_open
        self._parent = CURRENT
        if self._parent < 0 or _phase_open:
            self._parent = -1
            return self
        _phase_open = True
        self._rng = profiler_range("hvd." + self.name)
        self._rng.__enter__()
        self._t0 = _tracing.now() if _tracing.ACTIVE else None
        return self

    def __exit__(self, *exc):
        global _phase_open
        if self._parent < 0:
            return False
        try:
            if self._t0 is not None:
                _tracing.span("step", self.name, self._t0, _tracing.now(),
                              round=-1, group="", parent=self._parent)
        finally:
            self._rng.__exit__(*exc)
            _phase_open = False
        return False


# -- the collector ------------------------------------------------------------

def _on_gc(stage: str, info: dict) -> None:
    global _gc_t0, _gc_s
    if not _tracing.ACTIVE:   # disabled after hvd.init(): nothing to keep
        return
    if stage == "start":
        _gc_t0 = _tracing.now()
        return
    t1 = _tracing.now()
    _gc_s += t1 - _gc_t0
    if info["generation"] > 0:
        _gc_pending.append((_gc_t0, t1, info["generation"],
                            info["collected"], CURRENT))


def flush_gc() -> None:
    """Record the queued collections as ``gc`` spans."""
    while _gc_pending:
        try:
            t0, t1, gen, collected, sid = _gc_pending.popleft()
        except IndexError:
            return
        extra = {"step": sid} if sid >= 0 else {}
        _tracing.span("gc", f"gen{gen}", t0, t1, round=-1, group="",
                      generation=gen, collected=collected, **extra)


def install(engine) -> None:
    """At ``hvd.init()``: the engine whose counters steps read, the
    buffer's clock anchor, and under ``HOROVOD_TRACE`` the collector
    hook (once)."""
    global _engine
    _engine = engine
    _tracing.buffer().set_anchor()
    if _tracing.ACTIVE and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def uninstall() -> None:
    """At ``hvd.shutdown()``: the hook removed, its queue recorded."""
    global _engine
    _engine = None
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    flush_gc()
