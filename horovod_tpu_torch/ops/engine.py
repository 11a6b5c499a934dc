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

Left out until ROADMAP.md A9: metrics, timeline, stall inspector and
autotune hooks.
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

from ..exceptions import HorovodInternalError, HorovodTpuError
from ..runtime import ReduceOp
from . import collectives
from .controller import NegotiationResult, entry_token, token_fields
from .fusion import EntrySig, dtype_name, get_planner

logger = logging.getLogger("horovod_tpu_torch")

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
                 "wire_format")

    def __init__(self, name, op_type, tensors, process_set,
                 reduce_op=ReduceOp.AVERAGE, prescale=None, postscale=None,
                 root_rank=0, splits=None, group_id=-1, inplace=False):
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
        # the job's quantized wire format (HOROVOD_COMPRESSION), stamped at
        # submission; it rides the signature, so buckets never mix formats
        self.wire_format = "none"
        self.handle: Optional[Handle] = None
        self.enqueue_time = 0.0
        self.ready = None             # CUDA event on the submitter's stream
        # Allgatherv: per-tensor dim-0 sizes of every member, agreed by
        # negotiation
        self.peer_rows: Optional[Dict[int, List[int]]] = None

    # the JAX package's EntrySig fields that the port does not vary yet
    # keep their defaults: stacked False, tail "strict", spec "replicated"
    def sigs(self) -> List[EntrySig]:
        return [EntrySig(
            name=self.name if len(self.tensors) == 1 else f"{self.name}.{i}",
            op_type=self.op_type, reduce_op=self.reduce_op,
            dtype=dtype_name(t.dtype), shape=tuple(t.shape),
            process_set_id=self.process_set.process_set_id,
            stacked=False, group_id=self.group_id,
            prescale=None if self.prescale is None else float(self.prescale),
            postscale=(None if self.postscale is None
                       else float(self.postscale)),
            wire_format=self.wire_format)
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

    def __init__(self, cfg, device: torch.device, backend: str,
                 controller=None):
        self.cfg = cfg
        self.device = device
        self.backend = backend
        self._controller = controller
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
            e.wire_format = self._wire_format(e)
            e.enqueue_time, e.ready = now, ready
        handles = [e.handle for e in entries]
        if self._controller is not None and self._controller.joined:
            for e in entries:
                e.handle._fail(HorovodInternalError(
                    "collective submitted after join(); join() must be the "
                    "last collective of the epoch"))
            return handles[0] if single else handles
        with self._cv:
            if self._stop:
                for e in entries:
                    e.handle._fail(HorovodInternalError("engine is shut down"))
            else:
                self._queue.extend(entries)
                self._submit_gen += 1
                self._cv.notify_all()
        return handles[0] if single else handles

    def _wire_format(self, e: TensorTableEntry) -> str:
        """The quantized wire format of an entry: HOROVOD_COMPRESSION for a
        Sum or Average allreduce of float tensors when
        HOROVOD_COMPRESSION_DCN_ONLY=0 (the JAX engine's rule on a flat
        mesh, which has no cross-host stage to restrict it to), else
        "none"."""
        from ..compression import quantizable
        fmt = getattr(self.cfg, "compression", "none")
        if (fmt == "none" or getattr(self.cfg, "compression_dcn_only", True)
                or e.op_type != "allreduce"
                or e.reduce_op not in (ReduceOp.SUM, ReduceOp.AVERAGE)
                or not all(quantizable(t.dtype) for t in e.tensors)):
            return "none"
        return fmt

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
            cycle_s = max(self.cfg.cycle_time_ms, 0.0) / 1000.0
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
            return
        try:
            self._run_cycle(entries)
        except Exception as exc:  # noqa: BLE001
            # fail the drained entries' handles (requeued ones stay live)
            with self._lock:
                queued = {id(q) for q in self._queue}
            for e in entries:
                if id(e) not in queued and not e.handle._event.is_set():
                    e.handle._fail(exc)
            raise
        finally:
            with self._cv:
                self._cycle_active = False
                self._cv.notify_all()

    def _run_cycle(self, entries: List[TensorTableEntry]):
        self._cycle_count += 1
        if self._controller is not None and self._controller.enabled:
            with self._lock:
                gen0 = self._submit_gen
            entries = self._negotiate(entries)
            if not entries:
                # nothing common this round: pace the retry, but wake at
                # once on a new submission
                with self._cv:
                    if self._submit_gen == gen0 and not self._stop:
                        self._cv.wait(timeout=self._pace_s)
                return
        self._execute(entries)

    # -- cross-process negotiation (reference: ComputeResponseList) ---------
    def _negotiate(self, entries: List[TensorTableEntry]
                   ) -> List[TensorTableEntry]:
        """Agree with the peer ranks on this cycle's dispatch set, per
        process set's member group.  Returns the entries every member is
        ready for, plus zero contributions synthesized while joined;
        requeues the rest."""
        ctl = self._controller
        dispatch: List[TensorTableEntry] = []
        requeued: List[TensorTableEntry] = []
        groups: Dict[Tuple[int, ...], List[TensorTableEntry]] = {}
        for e in entries:
            procs = tuple(e.process_set.ranks)
            if len(procs) <= 1:
                dispatch.append(e)
            else:
                groups.setdefault(procs, []).append(e)
        now = time.monotonic()
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
            stalled = any(now - e.enqueue_time > ctl.deadline_s for e in grp)
            res = ctl.negotiate(tokens, procs,
                                aux={"rw": rows} if rows else None,
                                stalled=stalled)
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
        return dispatch

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
            group_id=self.next_group_id() if len(sigs) > 1 else -1)
        entry.handle = Handle(entry.name, single=len(tensors) == 1
                              and entry.group_id == -1)
        entry.enqueue_time = time.monotonic()
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
        plan = self._cache.get(sigs)
        if plan is None:
            plan = self._plan_fn(sigs, self.cfg.fusion_threshold_bytes)
            self._cache.put(sigs, plan)

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

        for idx, e in enumerate(entries):
            outs, exc = [], None
            for si in range(base[idx], base[idx] + len(e.tensors)):
                r = results.get(si)
                if isinstance(r, BaseException):
                    exc = r
                else:
                    outs.append(r)
            if exc is not None:
                e.handle._fail(exc)
            else:
                e.handle._resolve(outs, done)
        with self._lock:
            self._tensors += len(sigs)
            self._buckets += len(plan)
            self._bytes += sum(s.nbytes for s in sigs)
            self._dispatch_s += time.perf_counter() - t0

    def _dispatch_all(self, entries, sigs, owner, base, plan, results):
        for bucket in plan:
            try:
                self._dispatch_bucket(entries, sigs, owner, base, bucket,
                                      results)
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

    def _dispatch_bucket(self, entries, sigs, owner, base, bucket, results):
        first = sigs[bucket[0]]
        op_type = first.op_type
        e0 = entries[owner[bucket[0]]]
        ps = e0.process_set

        def tensor(si):
            return entries[owner[si]].tensors[si - base[owner[si]]]

        if op_type == "allreduce":
            wire = None
            if first.wire_format != "none" and ps.size() > 1:
                from ..compression import resolve_wire_format
                wire = resolve_wire_format(first.wire_format,
                                           self.cfg.compression_block_size)
            outs = collectives.allreduce_arrays(
                [tensor(si) for si in bucket], ps, op=first.reduce_op,
                prescale_factor=e0.prescale, postscale_factor=e0.postscale,
                inplace=e0.inplace, mark=self._mark(op_type), wire=wire)
            results.update(zip(bucket, outs))
            return
        for si in bucket:
            e = entries[owner[si]]
            x = tensor(si)
            if op_type == "allgather":
                rows = (e.peer_rows or {}).get(si - base[owner[si]])
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
            out = {"cycles": self._cycle_count, "tensors": self._tensors,
                   "buckets": self._buckets, "bytes": self._bytes,
                   "dispatch_ms": 1e3 * self._dispatch_s,
                   "cache": self._cache.stats()}
        if self._controller is not None:
            out["negotiation"] = self._controller.stats()
        # the serving summary, present only while a ServingPlane or
        # ServingWorker lives in this process (the serving package is
        # import-light: it loads its submodules lazily)
        from .. import serving
        serving_stats = serving.stats()
        if serving_stats:
            out["serving"] = serving_stats
        return out
