"""The collective engine: tensor queue, background cycle loop, async handles.

Counterpart: ``horovod_tpu/ops/engine.py`` (``TensorTableEntry``,
``Handle``, ``CollectiveEngine``), after the reference's
``BackgroundThreadLoop``/``RunLoopOnce``.  Callers submit entries from any
thread; the background thread drains the queue once per cycle
(``HOROVOD_CYCLE_TIME``), negotiates with the peer ranks which entries are
ready everywhere (``ops/controller.py``), plans them into fused buckets
(``ops/fusion.py``) and dispatches each bucket through the process set's
``torch.distributed`` group (``ops/collectives.py``).  Every collective of
the runtime, barriers and object collectives included, goes through here,
so all ranks issue them in one order.

On a CUDA device the engine runs its collectives on a stream of its own:
``submit`` records an event on the caller's current stream, which the
engine's stream waits on before it reads an input, and the engine records
a completion event that :meth:`Handle.synchronize` makes the caller's
current stream wait on.  The host blocks only where the caller reads a
result on the host.  Inputs and outputs cross streams through
``record_stream``, so the caching allocator never hands their memory to
another stream while the other one still uses it.

The engine calls the timeline (``timeline.py``: a NEGOTIATE span from
submission to the agreed dispatch set, then each bucket's activities),
the stall inspector (``stall.py``: enqueue and completion of every entry,
a check each cycle; its clock flags the negotiation rounds of overdue
entries) and, under ``HOROVOD_AUTOTUNE``, the parameter manager
(``autotune.py``: the fusion threshold, cycle time, response cache,
hierarchical and quantized-wire switches read each cycle, scored by each
cycle's bytes and seconds) at the JAX engine's hook points, and records
the JAX engine's metric families under the same names and labels.  In a
job of more than one rank the tuned parameters ride the global process
set's negotiation rounds (keys ``t``, ``c``, ``ca``, ``hi``, ``cp``):
every rank applies the point rank 0's tuner published, in the same cycle.

A Sum or Average allreduce over a set with a hierarchy
(``runtime.ProcessSet.hier_shape``) takes the hierarchical path under
``HOROVOD_HIERARCHICAL_ALLREDUCE`` (or the tuned switch), with the
quantized wire (``HOROVOD_COMPRESSION``) on its cross stage only unless
``HOROVOD_COMPRESSION_DCN_ONLY=0``, and the straggler policy
(``HOROVOD_TAIL_POLICY``) on that stage; an allgather of equal sizes takes
the hierarchical path under ``HOROVOD_HIERARCHICAL_ALLGATHER``.

Each fused allreduce passes the ``collective.corrupt`` chaos site and,
under ``HOROVOD_HEALTH`` (every ``HOROVOD_HEALTH_CHECK_EVERY``-th cycle,
the first always), the training-health tap over this rank's contribution
(``health.engine_observe``); ``stats()`` carries the health and
time-series summaries.

Under ``HOROVOD_TRACE`` (``tracing/``) the engine records the JAX engine's
spans: a ``cycle`` envelope for each drained batch, the ``submit`` phase
(the earliest entry's enqueue to the drain), ``fuse`` (the plan) and one
``dispatch`` a bucket, each tagged with the cycle's negotiation round and
group.  While ``hvd.start_profiler`` runs, each dispatch is also a
``torch.profiler.record_function`` range named after its bucket
(``hvd.<op>[<tensors>]``, JAX's ``TraceAnnotation``), so the ranges and
the collectives' CUDA kernels land in one trace.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import chaos as _chaos
from .. import health as _health
from .. import metrics as _metrics
from .. import tracing as _tracing
from ..exceptions import HorovodInternalError, HorovodTpuError
from ..runtime import ReduceOp
from . import collectives
from .controller import NegotiationResult, entry_token, token_fields
from .fusion import EntrySig, dtype_name, get_planner

logger = logging.getLogger("horovod_tpu_torch")

# -- metric families (the JAX engine's; sites guard on _metrics.ACTIVE) ------
_m_cycles = _metrics.counter(
    "hvd_engine_cycles_total", "Background cycles that drained entries")
_m_cycle_dur = _metrics.histogram(
    "hvd_cycle_duration_seconds",
    "Wall time of one drain→negotiate→dispatch cycle", lo=-17, hi=6)
_m_tensors = _metrics.counter(
    "hvd_engine_tensors_total", "Tensor signatures processed")
_m_bytes = _metrics.counter(
    "hvd_engine_bytes_reduced_total", "Payload bytes through dispatches")
_m_dispatch_tensors = _metrics.histogram(
    "hvd_dispatch_tensors", "Tensors per fused dispatch",
    labels=("op",), lo=0, hi=12)
_m_dispatch_bytes = _metrics.histogram(
    "hvd_dispatch_bytes", "Payload bytes per fused dispatch",
    labels=("op",), lo=6, hi=31)
_m_fusion_util = _metrics.histogram(
    "hvd_fusion_utilization_ratio",
    "Fused allreduce bucket bytes / fusion threshold", lo=-14, hi=1)
_m_plan_cache = _metrics.counter(
    "hvd_response_cache_total",
    "Fusion-plan (response) cache lookups", labels=("result",))
_m_wire_bytes = _metrics.counter(
    "hvd_wire_bytes_total",
    "Collective payload bytes at the wire format the fused dispatch "
    "applied (quantized formats count 1-byte lanes + fp32 block scales)",
    labels=("format",))
_m_wire_ratio = _metrics.gauge(
    "hvd_wire_compression_ratio",
    "Raw payload bytes / wire bytes of the last quantized fused dispatch",
    labels=("format",))

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _row_key(token: str, k: int, i: int) -> str:
    """Round ``aux`` key of tensor ``i`` of the ``k``-th entry with
    ``token`` (the same on every rank, whatever its submission order)."""
    return f"{hashlib.sha1(token.encode()).hexdigest()[:12]}.{k}.{i}"


class TensorTableEntry:
    """One pending collective submission (reference: TensorTableEntry).

    ``inplace`` entries write their results into ``tensors`` (the ``*_``
    forms); the others return new tensors.
    """

    __slots__ = ("name", "op_type", "tensors", "process_set", "reduce_op",
                 "prescale", "postscale", "root_rank", "splits", "group_id",
                 "inplace", "handle", "enqueue_time", "ready", "peer_rows",
                 "wire_format", "tail_policy")

    def __init__(self, name, op_type, tensors, process_set,
                 reduce_op=ReduceOp.AVERAGE, prescale=None, postscale=None,
                 root_rank=0, splits=None, group_id=-1, inplace=False,
                 wire_format="none", tail_policy="strict"):
        self.name = name
        self.op_type = op_type
        self.tensors = list(tensors)
        self.process_set = process_set
        self.reduce_op = reduce_op
        self.prescale = prescale
        self.postscale = postscale
        self.root_rank = root_rank
        self.splits = splits
        self.group_id = group_id
        self.inplace = inplace
        # the job's requested quantized wire format (HOROVOD_COMPRESSION)
        # and straggler policy (HOROVOD_TAIL_POLICY), stamped at
        # submission; sigs() narrows them where they cannot apply.  They
        # ride the signatures, so buckets never mix them and a rank that
        # configured another value is a detected divergence
        self.wire_format = wire_format
        self.tail_policy = tail_policy
        self.handle: Optional[Handle] = None
        self.enqueue_time = 0.0
        self.ready = None             # CUDA event on the submitter's stream
        # Allgatherv: per-tensor dim-0 sizes of every member, agreed by
        # negotiation
        self.peer_rows: Optional[Dict[int, List[int]]] = None

    # the JAX package's EntrySig fields that the port does not vary keep
    # their defaults: stacked False, spec "replicated"
    def sigs(self) -> List[EntrySig]:
        from ..compression import quantizable
        summable = (self.op_type == "allreduce"
                    and self.reduce_op in (ReduceOp.SUM, ReduceOp.AVERAGE))
        tail = self.tail_policy if summable else "strict"
        return [EntrySig(
            name=self.name if len(self.tensors) == 1 else f"{self.name}.{i}",
            op_type=self.op_type, reduce_op=self.reduce_op,
            dtype=dtype_name(t.dtype), shape=tuple(t.shape),
            process_set_id=self.process_set.process_set_id,
            stacked=False, group_id=self.group_id,
            prescale=None if self.prescale is None else float(self.prescale),
            postscale=(None if self.postscale is None
                       else float(self.postscale)),
            wire_format=(self.wire_format if summable and quantizable(t.dtype)
                         else "none"),
            tail_policy=tail)
            for i, t in enumerate(self.tensors)]


class Handle:
    """Async completion handle (reference: handle_manager.cc).

    ``synchronize()`` waits until the engine has dispatched the collective,
    then orders the caller's current CUDA stream after it and returns the
    result; ``poll()`` is true once the result is complete on the device.
    """

    def __init__(self, name: str, single: bool):
        self.name = name
        self._single = single
        self._event = threading.Event()
        self._result: Optional[Tuple[torch.Tensor, ...]] = None
        self._done = None             # CUDA event of the engine's stream
        self._exc: Optional[BaseException] = None

    def _resolve(self, result, done=None):
        self._result, self._done = tuple(result), done
        self._event.set()

    def _fail(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    def poll(self) -> bool:
        return self._event.is_set() and (self._done is None
                                         or self._done.query())

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def synchronize(self):
        self._event.wait()
        if self._exc is not None:
            if isinstance(self._exc, HorovodTpuError):
                raise self._exc
            raise HorovodInternalError(str(self._exc)) from self._exc
        res = self._result
        if self._done is not None and res:
            stream = torch.cuda.current_stream(res[0].device)
            stream.wait_event(self._done)
            for t in res:
                t.record_stream(stream)
        return res[0] if self._single else list(res)


class CollectiveEngine:
    """Background cycle loop draining the tensor queue into fused
    dispatches (reference: BackgroundThreadLoop + RunLoopOnce)."""

    def __init__(self, cfg, device: torch.device, backend: str, controller,
                 timeline, stall_inspector, autotuner=None):
        self.cfg = cfg
        self.device = device
        self.backend = backend
        self._controller = controller
        self.timeline = timeline
        self.stall = stall_inspector
        self.autotuner = autotuner
        # the tuned parameters the last global round agreed (rank 0's
        # tuner's point), applied by every rank; None before the first
        self._negotiated_params: Optional[dict] = None
        self._last_threshold = cfg.fusion_threshold_bytes
        self._cycle_started: Optional[float] = None
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._queue: List[TensorTableEntry] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._plan_fn, self._cache = get_planner(cfg)
        self._cycle_count = 0
        self._group_counter = 0
        self._name_counter = 0
        self._cycle_active = False
        self._submit_gen = 0
        self._pace_s = 0.02
        self._tensors = 0
        self._buckets = 0
        self._bytes = 0
        self._dispatch_s = 0.0    # host time planning and issuing buckets
        self._executes = 0        # cycles that planned a dispatch set
        # set by hvd.start_profiler/stop_profiler: each dispatch is then a
        # torch.profiler range
        self.profiling = False
        # device timing of allreduce phases (pack / reduce / unpack): off
        # unless a caller sets ``time_device``; read by device_ms()
        self.time_device = False
        self._marks: List[Tuple[str, object]] = []

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        with self._cv:
            self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="hvd-background", daemon=True)
        self._thread.start()

    def stop(self):
        if _metrics.RECORDING:
            _metrics.event("engine.stop", cycles=self._cycle_count)
        if self._controller is not None:
            # tell peers mid-negotiation we are gone
            self._controller.leave()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            stuck, self._queue = self._queue, []
        for e in stuck:
            e.handle._fail(HorovodInternalError("engine shut down"))
        if self._stream is not None:
            self._stream.synchronize()
        if self._controller is not None:
            # the last round's keys stay until the ranks meet at shutdown
            # (runtime.shutdown, then Controller.release)
            self._controller.cleanup_keys()

    # -- submission ---------------------------------------------------------
    def auto_name(self, prefix: str) -> str:
        """Stable call-site-derived auto names: ``prefix.file:line`` of the
        first frame outside the package, identical on every rank running
        the same script."""
        f = sys._getframe(1)
        while f is not None:
            fn = f.f_code.co_filename
            if not os.path.abspath(fn).startswith(_PKG_DIR):
                return f"{prefix}.{os.path.basename(fn)}:{f.f_lineno}"
            f = f.f_back
        with self._lock:
            self._name_counter += 1
            return f"{prefix}.noname.{self._name_counter}"

    def next_group_id(self) -> int:
        with self._lock:
            self._group_counter += 1
            return self._group_counter

    def submit(self, entries: Union[TensorTableEntry,
                                    Sequence[TensorTableEntry]]):
        """Queue one entry (returns its handle) or a list of entries, which
        join the queue at once, so one cycle drains them together (returns
        their handles)."""
        single = isinstance(entries, TensorTableEntry)
        entries = [entries] if single else list(entries)
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        now = time.monotonic()
        for e in entries:
            for t in e.tensors:
                if t.device != self.device:
                    raise ValueError(
                        f"{e.name}: tensor on {t.device}, but the runtime "
                        f"runs on {self.device} over {self.backend}")
            # a grouped entry always resolves to a list, even of one
            e.handle = Handle(e.name, single=(len(e.tensors) == 1
                                              and e.group_id == -1))
            e.wire_format = self.cfg.compression
            e.tail_policy = self.cfg.tail_policy
            e.enqueue_time, e.ready = now, ready
        handles = [e.handle for e in entries]
        if self._controller is not None and self._controller.joined:
            for e in entries:
                e.handle._fail(HorovodInternalError(
                    "collective submitted after join(); join() must be the "
                    "last collective of the epoch"))
            return handles[0] if single else handles
        for e in entries:
            self.timeline.negotiate_start(e.name, e.op_type)
            self.stall.record_enqueue(e.name, e.enqueue_time)
        with self._cv:
            if self._stop:
                for e in entries:
                    e.handle._fail(HorovodInternalError("engine is shut down"))
            else:
                self._queue.extend(entries)
                self._submit_gen += 1
                self._cv.notify_all()
        return handles[0] if single else handles

    # -- the tuned parameters -----------------------------------------------
    def _negotiating(self) -> bool:
        return self._controller is not None and self._controller.enabled

    def _tuned(self, key: str, local, default):
        """A tuned parameter: the round-agreed value in a job of more than
        one rank (``default`` before the first round), the local tuner's
        at one rank, ``default`` without a tuner."""
        if self.autotuner is None:
            return default
        if self._negotiating():
            if self._negotiated_params is not None:
                return self._negotiated_params.get(key, default)
            return default
        return local()

    def _cycle_time_s(self) -> float:
        cfg_ms = max(self.cfg.cycle_time_ms, 0.0)
        at = self.autotuner
        return float(self._tuned(
            "c", at and at.current_cycle_time_ms, cfg_ms)) / 1000.0

    def _fusion_threshold(self) -> int:
        at = self.autotuner
        return int(self._tuned("t", at and at.current_fusion_threshold,
                               self.cfg.fusion_threshold_bytes))

    def _cache_enabled(self) -> bool:
        at = self.autotuner
        return bool(self._tuned("ca", at and at.current_cache_enabled,
                                True))

    def _hierarchical_enabled(self) -> bool:
        at = self.autotuner
        return bool(self._tuned("hi", at and at.current_hierarchical,
                                self.cfg.hierarchical_allreduce))

    def _compression_enabled(self) -> bool:
        """Whether the tuned switch lets the configured quantized wire
        format apply this cycle (the tuner may turn a lossy wire off, never
        on)."""
        if self.cfg.compression == "none":
            return False
        at = self.autotuner
        return bool(self._tuned("cp", at and at.current_compression, True))

    def _tuned_params(self) -> dict:
        at = self.autotuner
        return {"t": at.current_fusion_threshold(),
                "c": at.current_cycle_time_ms(),
                "ca": at.current_cache_enabled(),
                "hi": at.current_hierarchical(),
                "cp": at.current_compression()}

    # -- the bucket's effective properties ------------------------------------
    def _hier(self, ps) -> bool:
        return ps.size() > 1 and self._hierarchical_enabled() \
            and ps.hier_shape() is not None

    def _bucket_wire_format(self, first: EntrySig, ps) -> str:
        """The wire format one fused dispatch applies: the bucket's
        negotiated format, gated by the tuned switch, by a set of one rank
        (nothing sent) and, under HOROVOD_COMPRESSION_DCN_ONLY, by the
        hierarchical path (a flat set has no cross stage to restrict it
        to)."""
        fmt = first.wire_format
        if fmt == "none" or not self._compression_enabled() \
                or ps.size() <= 1:
            return "none"
        if self.cfg.compression_dcn_only and not self._hier(ps):
            return "none"
        return fmt

    def _bucket_tail_policy(self, first: EntrySig, ps) -> str:
        """The straggler policy of one fused dispatch: the bucket's
        negotiated policy on the hierarchical path, which has the cross
        stage it applies to; strict elsewhere."""
        if first.tail_policy == "strict" or not self._hier(ps):
            return "strict"
        return first.tail_policy

    # -- the loop -----------------------------------------------------------
    def _loop(self):
        if self._stream is not None:
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    return
            # the cycle clock starts before the batching window, so the
            # tuner's score pays for the window it tunes
            self._cycle_started = time.monotonic()
            cycle_s = self._cycle_time_s()
            if cycle_s > 0:
                time.sleep(cycle_s)   # let the cycle window fill
            try:
                self.run_cycle_once()
            except Exception:  # noqa: BLE001 - the thread must live
                # run_cycle_once failed the cycle's handles; entries queued
                # since belong to the next cycle
                logger.exception("background cycle failed")

    def run_cycle_once(self):
        """One coordination cycle (reference: RunLoopOnce)."""
        with self._lock:
            entries, self._queue = self._queue, []
            self._cycle_active = bool(entries)
        if not entries:
            self.stall.check()
            return
        t_cycle = (self._cycle_started if self._cycle_started is not None
                   else time.monotonic())
        try:
            self._run_cycle(entries)
        except Exception as exc:  # noqa: BLE001
            # fail the drained entries' handles (requeued ones stay live)
            with self._lock:
                queued = {id(q) for q in self._queue}
            for e in entries:
                if id(e) not in queued and not e.handle._event.is_set():
                    # a failed entry is no longer pending
                    self.stall.record_complete(e.name)
                    e.handle._fail(exc)
            if _metrics.RECORDING:
                _metrics.event("engine.fatal", cycle=self._cycle_count,
                               error=str(exc))
            raise
        finally:
            if _metrics.ACTIVE:
                _m_cycles.inc()
                _m_cycle_dur.observe(time.monotonic() - t_cycle)
            if _tracing.ACTIVE:
                # the envelope span (not on a round's critical path): one a
                # drained batch; t_cycle is on time.monotonic, so its age
                # is carried onto the buffer's clock
                t1 = _tracing.now()
                _tracing.span("cycle", f"cycle{self._cycle_count}",
                              t1 - (time.monotonic() - t_cycle), t1,
                              entries=len(entries))
            with self._cv:
                self._cycle_active = False
                self._cv.notify_all()

    def _run_cycle(self, entries: List[TensorTableEntry]):
        self._cycle_count += 1
        t_drain = t_drain_mono = 0.0
        ctl_on = self._controller is not None and self._controller.enabled
        if _tracing.ACTIVE:
            t_drain, t_drain_mono = _tracing.now(), time.monotonic()
            # without negotiation every rank drains in lockstep, so the
            # cycle count correlates across ranks (group ""); with it a
            # cycle stays off the round path until its round is agreed
            _tracing.set_context(round=-1 if ctl_on else self._cycle_count,
                                 cycle=self._cycle_count, group="")
        self.timeline.cycle_mark(self._cycle_count)
        if ctl_on:
            with self._lock:
                gen0 = self._submit_gen
            entries, res = self._negotiate(entries)
            if _tracing.ACTIVE and res is not None and res.seq >= 0:
                # the agreed (group, round) tags this cycle's later spans
                _tracing.set_context(round=res.seq, group=res.group)
            if not entries:
                self.stall.check()
                # nothing common this round: pace the retry, but wake at
                # once on a new submission
                with self._cv:
                    if self._submit_gen == gen0 and not self._stop:
                        self._cv.wait(timeout=self._pace_s)
                return
        if _tracing.ACTIVE and entries:
            # the submit phase: the earliest agreed entry's enqueue to the
            # drain, its age carried onto the buffer's clock
            age = t_drain_mono - min(e.enqueue_time for e in entries)
            _tracing.span("submit", f"cycle{self._cycle_count}",
                          t_drain - age, t_drain, entries=len(entries))
        self._execute(entries)

    # -- cross-process negotiation (reference: ComputeResponseList) ---------
    def _negotiate(self, entries: List[TensorTableEntry]):
        """Agree with the peer ranks on this cycle's dispatch set, per
        process set's member group.  Returns the entries every member is
        ready for, plus zero contributions synthesized while joined
        (requeuing the rest), and the round that tags the cycle's spans:
        the global group's, else the last group's (None without one)."""
        ctl = self._controller
        dispatch: List[TensorTableEntry] = []
        requeued: List[TensorTableEntry] = []
        tag = None
        groups: Dict[Tuple[int, ...], List[TensorTableEntry]] = {}
        for e in entries:
            procs = tuple(e.process_set.ranks)
            if len(procs) <= 1:
                dispatch.append(e)
            else:
                groups.setdefault(procs, []).append(e)
        now = time.monotonic()
        world = tuple(range(ctl.world))
        for procs in sorted(groups):
            grp = groups[procs]
            tokens = [entry_token(e) for e in grp]
            # Allgatherv row counts ride the round; keys carry an
            # occurrence index so duplicate tokens pair instance k with
            # every peer's instance k
            rows, occ = {}, {}
            for e, t in zip(grp, tokens):
                if e.op_type == "allgather":
                    k = occ[t] = occ.get(t, -1) + 1
                    for i, x in enumerate(e.tensors):
                        rows[_row_key(t, k, i)] = int(x.shape[0])
            # the stall inspector's clock decides which entries are overdue
            stalled = any(self.stall.overdue(e.name, ctl.deadline_s, now)
                          for e in grp)
            # the tuned parameters ride the global group's round: only the
            # leader (rank 0) publishes, every member applies the agreed
            # point in this cycle
            params = (self._tuned_params()
                      if self.autotuner is not None and procs == world
                      and ctl.rank == procs[0] else None)
            res = ctl.negotiate(tokens, procs,
                                aux={"rw": rows} if rows else None,
                                stalled=stalled, params=params)
            if tag is None or procs == world:
                tag = res
            if res.params is not None:
                self._negotiated_params = res.params
            if rows:
                self._agree_rows(grp, tokens, procs, res)
            counts = dict(res.counts)
            for e, t in zip(grp, tokens):
                if counts.get(t, 0) > 0:
                    counts[t] -= 1
                    dispatch.append(e)
                else:
                    requeued.append(e)
            if ctl.joined:
                for t, k in counts.items():
                    dispatch.extend(self._synthesize(t) for _ in range(k))
        if requeued:
            with self._cv:
                self._queue[:0] = requeued
                self._cv.notify_all()
        return dispatch, tag

    @staticmethod
    def _agree_rows(grp, tokens, procs, res: NegotiationResult):
        """Each allgather entry's per-member dim-0 sizes from the round."""
        occ = {}
        for e, t in zip(grp, tokens):
            if e.op_type != "allgather":
                continue
            k = occ[t] = occ.get(t, -1) + 1
            rows = {}
            for i in range(len(e.tensors)):
                sizes = []
                for p in procs:
                    pub = res.aux.get(p, {}).get("rw", {})
                    sizes.append(pub.get(_row_key(t, k, i)))
                if all(s is not None for s in sizes):
                    rows[i] = [int(s) for s in sizes]
            e.peer_rows = rows or None

    def _synthesize(self, token: str) -> TensorTableEntry:
        """A zero contribution for a peer collective this joined rank did
        not submit (reference: JoinOp zero tensors)."""
        from .. import runtime
        fields = token_fields(token)
        sigs = fields["s"]
        op_type = sigs[0][1]
        ps = runtime._state().process_set_table.get(sigs[0][5])
        if op_type == "broadcast":
            if ps.ranks[fields["r"]] == runtime._state().rank:
                raise HorovodInternalError(
                    "join(): this rank is the broadcast root for "
                    f"'{sigs[0][0]}' but has joined")
        elif op_type not in ("allreduce", "barrier"):
            raise HorovodInternalError(
                f"join(): cannot zero-fill op '{op_type}' for tensor "
                f"'{sigs[0][0]}' (supported with uneven inputs: allreduce, "
                f"broadcast, barrier)")
        # zeros made on the engine's stream, which reads them next
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            tensors = [torch.zeros(tuple(s[4]), dtype=getattr(torch, s[3]),
                                   device=self.device) for s in sigs]
        entry = TensorTableEntry(
            name=sigs[0][0].rsplit(".", 1)[0] if len(sigs) > 1
            else sigs[0][0],
            op_type=op_type, tensors=tensors, process_set=ps,
            reduce_op=sigs[0][2], prescale=sigs[0][8], postscale=sigs[0][9],
            root_rank=fields["r"], splits=fields["sp"],
            group_id=self.next_group_id() if len(sigs) > 1 else -1,
            # the peers' negotiated wire format and tail policy (token
            # fields 10 and 11)
            wire_format=next((s[10] for s in sigs if s[10] != "none"),
                             "none"),
            tail_policy=next((s[11] for s in sigs if s[11] != "strict"),
                             "strict"))
        entry.handle = Handle(entry.name, single=len(tensors) == 1
                              and entry.group_id == -1)
        entry.enqueue_time = time.monotonic()
        self.timeline.negotiate_start(entry.name, op_type)
        return entry

    def join(self) -> int:
        """Answer joined negotiation rounds until every rank has joined
        (reference: JoinOp loop); returns the last joiner's rank."""
        from .. import runtime
        ctl = self._controller
        # join is ordered after every earlier submission of this rank
        with self._cv:
            while self._queue or self._cycle_active:
                self._cv.wait(timeout=0.25)
        ctl.set_joined(True)
        world = tuple(runtime._state().global_process_set.ranks)
        try:
            while True:
                with self._lock:
                    if self._queue:
                        raise HorovodInternalError(
                            "collective submitted after join()")
                res = ctl.negotiate([], world)
                if res.all_joined:
                    return res.last_joiner
                dispatch = [self._synthesize(t)
                            for t, k in res.counts.items() for _ in range(k)]
                if dispatch:
                    self._execute(dispatch)
                else:
                    time.sleep(max(self.cfg.cycle_time_ms, 1.0) / 1000.0)
        finally:
            ctl.set_joined(False)

    # -- planned dispatch ---------------------------------------------------
    def _execute(self, entries: List[TensorTableEntry]):
        t0 = time.perf_counter()
        sigs: List[EntrySig] = []
        owner: List[int] = []   # sig index -> entry index
        base: List[int] = []    # entry index -> first sig index
        for idx, e in enumerate(entries):
            base.append(len(sigs))
            for s in e.sigs():
                sigs.append(s)
                owner.append(idx)
            # the negotiation span closes when the entry makes the cycle's
            # agreed dispatch set
            self.timeline.negotiate_end(e.name)
        use_cache = self._cache_enabled()
        threshold = self._fusion_threshold()
        if threshold != self._last_threshold:
            # cached plans were built at the previous threshold
            self._cache.clear()
            self._last_threshold = threshold
        t_fuse = _tracing.now() if _tracing.ACTIVE else 0.0
        plan = self._cache.get(sigs) if use_cache else None
        cached = plan is not None
        if _metrics.ACTIVE and use_cache:
            _m_plan_cache.inc(result="hit" if cached else "miss")
        if plan is None:
            plan = self._plan_fn(sigs, threshold)
            if use_cache:
                self._cache.put(sigs, plan)
        if _tracing.ACTIVE:
            _tracing.span("fuse", f"plan[{len(sigs)}]", t_fuse,
                          _tracing.now(), buckets=len(plan), cached=cached)
        # the tuner's clock: from the cycle's start, batching window
        # included, when the background loop set it
        t_tune, self._cycle_started = (
            self._cycle_started if self._cycle_started is not None
            else time.monotonic()), None

        results: dict = {}
        done = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                for ev in {id(e.ready): e.ready for e in entries
                           if e.ready is not None}.values():
                    self._stream.wait_event(ev)
                for e in entries:
                    for t in e.tensors:
                        t.record_stream(self._stream)
                self._dispatch_all(entries, sigs, owner, base, plan, results)
                done = torch.cuda.Event()
                done.record(self._stream)
        else:
            self._dispatch_all(entries, sigs, owner, base, plan, results)

        failed = False
        for idx, e in enumerate(entries):
            outs, exc = [], None
            for si in range(base[idx], base[idx] + len(e.tensors)):
                r = results.get(si)
                if isinstance(r, BaseException):
                    exc = r
                else:
                    outs.append(r)
            self.stall.record_complete(e.name)
            self.timeline.end(e.name)
            if exc is not None:
                failed = True
                e.handle._fail(exc)
            else:
                e.handle._resolve(outs, done)
        nbytes = sum(s.nbytes for s in sigs)
        with self._lock:
            self._executes += 1
            self._tensors += len(sigs)
            self._buckets += len(plan)
            self._bytes += nbytes
            self._dispatch_s += time.perf_counter() - t0
        if not failed:
            if _metrics.ACTIVE:
                _m_bytes.inc(nbytes)
                _m_tensors.inc(len(sigs))
            # in a job of more than one rank only the leader's tuner
            # learns: the others run the agreed point, not their own
            if self.autotuner is not None and (
                    not self._negotiating() or self._controller.rank == 0):
                self.autotuner.record_cycle(nbytes,
                                            time.monotonic() - t_tune)
        self.stall.check()

    def _dispatch_all(self, entries, sigs, owner, base, plan, results):
        for bucket_id, bucket in enumerate(plan):
            try:
                self._dispatch_bucket(entries, sigs, owner, base, bucket,
                                      results, bucket_id)
            except Exception as exc:  # noqa: BLE001 - surface per entry
                logger.exception("collective dispatch failed")
                for si in bucket:
                    results[si] = exc

    def _mark(self, op: str):
        if not (self.time_device and self._stream is not None):
            return None

        def mark(phase: str):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self._marks.append((phase, ev))
        return mark

    def _account(self, first: EntrySig, bucket, sigs, ps, eff: str,
                 hier: bool) -> None:
        """The dispatch metric families of one bucket; wire bytes at the
        format each stage applies (on the hierarchical path only the
        cross stage's 1/local_size of the payload is quantized)."""
        op_type = first.op_type
        nbytes = sum(sigs[si].nbytes for si in bucket)
        _m_dispatch_tensors.observe(len(bucket), op=op_type)
        _m_dispatch_bytes.observe(nbytes, op=op_type)
        if op_type == "allreduce" and self._last_threshold > 0:
            _m_fusion_util.observe(nbytes / self._last_threshold)
        if eff == "none":
            _m_wire_bytes.inc(nbytes, format=first.dtype)
            return
        from ..compression import resolve_wire_format
        wfmt = resolve_wire_format(eff, self.cfg.compression_block_size)
        total = sum(sigs[si].numel for si in bucket)
        q_numel = -(-total // ps.hier_shape()[1]) if hier else total
        wire = wfmt.wire_nbytes(q_numel)
        raw_q = (q_numel * nbytes) // max(total, 1)
        _m_wire_bytes.inc(wire, format=eff)
        if nbytes > raw_q:
            _m_wire_bytes.inc(nbytes - raw_q, format=first.dtype)
        _m_wire_ratio.set(raw_q / max(wire, 1), format=eff)

    def _dispatch_bucket(self, entries, sigs, owner, base, bucket, results,
                         bucket_id: int):
        first = sigs[bucket[0]]
        op_type = first.op_type
        e0 = entries[owner[bucket[0]]]
        ps = e0.process_set
        # the bucket's effective properties, resolved once for the
        # dispatch, the metrics and the timeline
        summable = op_type == "allreduce" and first.reduce_op in (
            ReduceOp.SUM, ReduceOp.AVERAGE)
        hier = summable and self._hier(ps)
        eff = self._bucket_wire_format(first, ps) if summable else "none"
        tail = self._bucket_tail_policy(first, ps) if summable else "strict"
        if _metrics.ACTIVE:
            self._account(first, bucket, sigs, ps, eff, hier)
        names = [sigs[si].name for si in bucket]
        self.timeline.activity_start(names, "MEMCPY_IN_FUSION_BUFFER")
        self.timeline.activity_transition(
            names, op_type.upper(), args={"wire_format": eff,
                                          "tail_policy": tail,
                                          "hierarchical": hier})
        t_disp = _tracing.now() if _tracing.ACTIVE else 0.0
        # under hvd.start_profiler the dispatch is a profiler range (JAX's
        # TraceAnnotation), beside the CUDA kernels it launches
        rng = (torch.profiler.record_function(f"hvd.{op_type}[{len(bucket)}]")
               if self.profiling else contextlib.nullcontext())
        with rng:
            self._dispatch_inner(entries, sigs, owner, base, bucket,
                                 results, ps, e0, eff, hier, tail,
                                 bucket_id)
        if _tracing.ACTIVE:
            _tracing.span("dispatch", first.name, t_disp, _tracing.now(),
                          op=op_type, tensors=len(bucket),
                          bytes=sum(sigs[si].nbytes for si in bucket),
                          wire_format=eff, tail_policy=tail,
                          hierarchical=hier)
        self.timeline.activity_end(names)

    def _dispatch_inner(self, entries, sigs, owner, base, bucket, results,
                        ps, e0, eff, hier, tail, bucket_id: int):
        first = sigs[bucket[0]]
        op_type = first.op_type

        def tensor(si):
            return entries[owner[si]].tensors[si - base[owner[si]]]

        if op_type == "allreduce":
            wire = None
            if eff != "none":
                from ..compression import resolve_wire_format
                wire = resolve_wire_format(eff,
                                           self.cfg.compression_block_size)
            tensors = [tensor(si) for si in bucket]
            rank = ps.rank()
            if _chaos.ACTIVE:
                # collective.corrupt: this process's contribution to the
                # fused bucket, NaN'd or scaled when it is the target
                from ..health.taps import chaos_corrupt_eager
                bad = chaos_corrupt_eager(tensors, rank, bucket_id,
                                          first.name)
                if e0.inplace:
                    # an in-place reduce keeps the caller's tensors
                    for t, b in zip(tensors, bad):
                        if b is not t:
                            t.copy_(b)
                else:
                    tensors = bad
            if _health.ACTIVE and (
                    (self._cycle_count - 1) % _health.SAMPLE_EVERY == 0):
                # the numerics tap over the LOCAL contribution, sampled
                # at the HOROVOD_HEALTH_CHECK_EVERY cadence (the first
                # cycle always): it pays a device→host copy of the stats.
                # The cycle count is the engine's step analog
                _health.engine_observe(self._cycle_count, bucket_id,
                                       first.name, tensors, rank)
            outs = collectives.allreduce_arrays(
                tensors, ps, op=first.reduce_op,
                prescale_factor=e0.prescale, postscale_factor=e0.postscale,
                inplace=e0.inplace, mark=self._mark(op_type), wire=wire,
                hierarchical=hier, tail_policy=tail,
                tail_names=tuple(sigs[si].name for si in bucket))
            results.update(zip(bucket, outs))
            return
        hier_ag = (op_type == "allgather" and ps.size() > 1
                   and self.cfg.hierarchical_allgather
                   and ps.hier_shape() is not None)
        for si in bucket:
            e = entries[owner[si]]
            x = tensor(si)
            if op_type == "allgather":
                rows = (e.peer_rows or {}).get(si - base[owner[si]])
                if hier_ag and (rows is None or len(set(rows)) == 1):
                    results[si] = collectives.hierarchical_allgather(x, ps)
                else:
                    results[si] = collectives.allgather_array(x, ps, rows)
            elif op_type == "broadcast":
                results[si] = collectives.broadcast_array(
                    x, e.root_rank, ps, inplace=e.inplace)
            elif op_type == "alltoall":
                results[si] = collectives.alltoall_array(x, ps, e.splits)
            elif op_type == "reducescatter":
                results[si] = collectives.reducescatter_array(
                    x, ps, e.reduce_op)
            elif op_type == "barrier":
                collectives.barrier(ps, self.device)
                results[si] = x
            else:
                raise HorovodInternalError(f"unknown op type {op_type}")

    # -- introspection ------------------------------------------------------
    def device_ms(self) -> Dict[str, float]:
        """Device milliseconds of each allreduce phase (pack, reduce,
        unpack) since the last call, from the events recorded while
        ``time_device`` was set; waits for the engine's stream."""
        with self._lock:
            marks, self._marks = self._marks, []
        out = {"pack": 0.0, "reduce": 0.0, "unpack": 0.0}
        if self._stream is None or not marks:
            return out
        self._stream.synchronize()
        for (phase, ev), (_, nxt) in zip(marks, marks[1:]):
            if phase in out:
                out[phase] += ev.elapsed_time(nxt)
        return out

    def stats(self) -> dict:
        with self._lock:
            out = {"cycles": self._cycle_count, "executes": self._executes,
                   "tensors": self._tensors,
                   "buckets": self._buckets, "bytes": self._bytes,
                   "dispatch_ms": 1e3 * self._dispatch_s,
                   "cache": self._cache.stats(),
                   "metrics": _metrics.snapshot()}
        if self._controller is not None:
            out["negotiation"] = self._controller.stats()
        if not self.stall.disabled:
            # which peer is chronically late, in seconds of arrival lag
            out["stall"] = {
                "straggler_scores": self.stall.straggler_scores(),
                "warnings_issued": self.stall.warnings_issued}
        if self.autotuner is not None:
            out["autotune"] = {
                "fusion_threshold_bytes": self._fusion_threshold(),
                "cycle_time_ms": self._cycle_time_s() * 1000.0,
                "cache_enabled": self._cache_enabled(),
                "hierarchical": self._hierarchical_enabled(),
                "compression": self._compression_enabled(),
                "tuned": self.autotuner.tuned,
                "retunes": self.autotuner.retunes,
                "negotiated": self._negotiated_params is not None}
        if _health.ACTIVE:
            # the training-health verdict summary (the full snapshot is
            # GET /health and the health_pull RPC)
            out["health"] = _health.evaluator().summary()
        from ..metrics import timeseries as _timeseries
        if _timeseries.ACTIVE:
            # the time-series sampler: knobs, ring occupancy, last-window
            # rates (the windows are GET /timeseries)
            out["timeseries"] = _timeseries.summary()
        # the serving summary, present only while a ServingPlane or
        # ServingWorker lives in this process (the serving package is
        # import-light: it loads its submodules lazily)
        from .. import serving
        serving_stats = serving.stats()
        if serving_stats:
            out["serving"] = serving_stats
        return out
