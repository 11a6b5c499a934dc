"""Core runtime: initialization, topology, process sets, global state.

Counterpart: ``horovod_tpu/runtime.py``.  The JAX package maps a Horovod
worker onto a TPU chip and drives many chips from one process; the port is
classic Horovod, one process per GPU: ``rank()`` and ``size()`` count
processes, and each process owns one device.

The topology comes from the launcher's environment (``HOROVOD_RANK``,
``HOROVOD_SIZE``, ``HOROVOD_LOCAL_RANK``, ``HOROVOD_LOCAL_SIZE``,
``HOROVOD_CROSS_RANK``, ``HOROVOD_CROSS_SIZE``,
``HOROVOD_GLOO_RENDEZVOUS_ADDR`` and ``HOROVOD_GLOO_RENDEZVOUS_PORT``): rank
0 hosts a ``torch.distributed.TCPStore`` there, which carries the process
group's rendezvous and the controller's negotiation rounds.  Without that
environment ``init`` makes a world of one on an in-process store.

Under the elastic driver (``HOROVOD_ELASTIC=1`` with the driver's
address) the topology and the rendezvous come from the driver's epoch
assignment instead (``elastic/worker.fetch_assignment``), retried until
``HOROVOD_ELASTIC_START_TIMEOUT``: each epoch forms around a store of its
own that the epoch's rank 0 hosts on the epoch's port, within
``HOROVOD_ELASTIC_INIT_TIMEOUT``.  Its teardown waits for no peer the
driver reported dead.

The collectives run over one ``torch.distributed`` process group per
process set: NCCL on ``cuda:<local_rank>`` by default, gloo with
``init(device="cpu")``.  ``HOROVOD_CONTROLLER=gloo`` puts CUDA tensors
through gloo, which is how two ranks can share one card (NCCL refuses two
ranks on one device).  Every collective of every set goes through the
background engine (``ops/engine.py``), so the ranks issue them in one
negotiated order.

A process set whose ranks group by host (``HOROVOD_LOCAL_*`` and
``HOROVOD_CROSS_*``: two or more hosts of equal size, ranks numbered host
by host) has a hierarchy (:meth:`ProcessSet.hier_shape`): a group per
host of its local ranks and a cross group per local rank, made at the
set's registration, which the hierarchical allreduce and allgather run
over (``ops/collectives.py``).  ``init`` also builds the timeline
(``HOROVOD_TIMELINE``), the stall inspector and, under
``HOROVOD_AUTOTUNE``, the parameter manager, and starts the metrics'
exposition (``metrics.init_from_env``).  It first loads the native core
(``native/``, built at first use) unless ``HOROVOD_TPU_NATIVE_CORE=0``,
and hands it to the engine's planner, the controller's decision, the
timeline's writer and the stall inspector's tracker; a failed build
raises there.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import DeviceLike
from .config import Config
from .exceptions import NotInitializedError

logger = logging.getLogger("horovod_tpu_torch")

#: how long a process group waits in one collective, and the bound of a
#: negotiation round, when HOROVOD_STALL_SHUTDOWN_TIME_SECONDS is 0
DEFAULT_TIMEOUT_S = 300.0


def _env_seconds(name: str, default: float) -> float:
    return float(os.environ.get(name) or default)


# Reduction op enums, mirroring the reference's hvd.Sum/Average/Adasum/Min/Max
class ReduceOp:
    AVERAGE = "average"
    SUM = "sum"
    ADASUM = "adasum"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"
    BAND = "band"
    BOR = "bor"
    BXOR = "bxor"


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


class SubGroup:
    """One stage's group of a hierarchical collective: the ranks of one
    host (local) or of one local rank on every host (cross).  It answers
    what the collectives ask of a process set (``group``, ``ranks``,
    ``size()``, ``rank()``).  ``axis`` names the axis a hierarchy's group
    spans, as the JAX package names it (``hvd_local``, ``workers``) for
    the schedule recorder; a mesh's groups leave it None (one group can
    be two meshes' axes)."""

    def __init__(self, ranks: Sequence[int], group,
                 axis: Optional[str] = None):
        self.ranks = list(ranks)
        self.group = group
        self.axis = axis

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        return self.ranks.index(_state().rank)


class ProcessSet:
    """A subset of ranks with its own process group.

    ``ranks`` are global ranks into ``hvd.size()``.  Every rank of the
    world registers every set (``torch.distributed.new_group`` is
    collective over the world), in the same order.  ``_hier_shape``, when
    a test sets it, forces the hierarchy's ``(cross, local)`` shape over
    the set's ranks in order.
    """

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(int(r) for r in ranks) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        self.group = None   # the torch ProcessGroup (None if excluded)
        self._hier_shape: Optional[Tuple[int, int]] = None
        # shape -> (this rank's local SubGroup, its cross SubGroup)
        self._hier_groups: Dict[Tuple[int, int], Tuple] = {}
        self._hier_detected: Optional[Tuple[int, int]] = None

    def initialized(self) -> bool:
        return self.process_set_id is not None

    def size(self) -> int:
        self._check()
        return len(self.ranks)

    def included(self) -> bool:
        self._check()
        return _state().rank in self.ranks

    def rank(self) -> int:
        """This process's rank within the set (-1 if excluded)."""
        self._check()
        me = _state().rank
        return self.ranks.index(me) if me in self.ranks else -1

    def hier_shape(self) -> Optional[Tuple[int, int]]:
        """``(cross_size, local_size)`` of the set's hierarchy, or None
        (reference: ``ProcessSet.hier_shape``): None unless the set's
        ranks fall on two or more hosts of equal size, numbered host by
        host."""
        if self._hier_shape is not None:
            return self._hier_shape
        self._check()
        return self._hier_detected

    def hier_groups(self):
        """This rank's ``(local, cross)`` :class:`SubGroup` pair of the
        hierarchy.  Groups of a shape the test hook forced are made at
        first use, which every member reaches in the same negotiated
        dispatch."""
        shape = self.hier_shape()
        if shape is None:
            raise ValueError(f"{self} has no hierarchy")
        if shape not in self._hier_groups:
            self._hier_groups[shape] = _make_hier_groups(self.ranks, shape)
        return self._hier_groups[shape]

    def _check(self):
        if not self.initialized():
            raise NotInitializedError("ProcessSet")

    def __repr__(self):
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


def _detect_hier(ranks: Sequence[int], hosts: Optional[Sequence[int]]
                 ) -> Optional[Tuple[int, int]]:
    """``(n_hosts, per_host)`` when ``ranks`` (sorted) run host by host
    through two or more hosts of equal size; ``hosts[r]`` is rank ``r``'s
    host (its cross rank), None when the launcher gave no hierarchy."""
    if hosts is None or not ranks:
        return None
    runs: List[int] = []
    seen = set()
    prev = None
    for r in ranks:
        h = hosts[r]
        if h != prev:
            if h in seen:
                return None   # a host's ranks are not contiguous
            seen.add(h)
            runs.append(0)
            prev = h
        runs[-1] += 1
    if len(runs) < 2 or len(set(runs)) != 1:
        return None
    return len(runs), runs[0]


def _make_hier_groups(ranks: Sequence[int], shape: Tuple[int, int]):
    """Every local and cross group of ``ranks`` under ``shape``, made by
    every rank in the same order (``torch.distributed.new_group`` is
    collective over the world); returns this rank's pair."""
    n_cross, n_local = shape
    me = _state().rank
    local = cross = None
    for g in range(n_cross):
        members = list(ranks[g * n_local:(g + 1) * n_local])
        group = dist.new_group(members)
        if me in members:
            local = SubGroup(members, group, axis="hvd_local")
    for i in range(n_local):
        members = list(ranks[i::n_local])
        group = dist.new_group(members)
        if me in members:
            cross = SubGroup(members, group, axis="workers")
    return local, cross


class ProcessSetTable:
    """Registry of process sets (reference: ProcessSetTable)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[int, ProcessSet] = {}
        self._next_id = 0
        #: groups made outside any set (a ParallelMesh's axis lines), by
        #: member ranks, so a second mesh over the same lines reuses them
        self.subgroups: Dict[Tuple[int, ...], SubGroup] = {}

    def register(self, ps: ProcessSet, world: int) -> int:
        ranks = ps.ranks if ps.ranks is not None else list(range(world))
        if any(r < 0 or r >= world for r in ranks):
            raise ValueError(f"process set ranks {ranks} out of range for "
                             f"{world} ranks")
        with self._lock:
            for existing in self._table.values():
                if existing.ranks == ranks:
                    raise ValueError(
                        f"A process set with ranks {existing.ranks} already "
                        f"exists (id={existing.process_set_id})")
            set_id = self._next_id
            self._next_id += 1
        # the global set is the default group; a subset needs its own,
        # created by every rank of the world
        group = (dist.group.WORLD if ps.ranks is None
                 else dist.new_group(ranks))
        hier = _detect_hier(ranks, _state().hosts)
        with self._lock:
            ps.ranks = ranks
            ps.process_set_id = set_id
            ps.group = group if _state().rank in ranks else None
            ps._hier_detected = hier
            ps._hier_groups = {}
            self._table[set_id] = ps
        if hier is not None:
            ps.hier_groups()
        return set_id

    def remove(self, set_id: int):
        with self._lock:
            if set_id == 0:
                raise ValueError("cannot remove the global process set")
            if set_id not in self._table:
                raise ValueError(f"no process set with id {set_id}")
            ps = self._table.pop(set_id)
        if ps.group is not None:
            dist.destroy_process_group(ps.group)
        for pair in ps._hier_groups.values():
            for sub in pair:
                if sub is not None:
                    dist.destroy_process_group(sub.group)
        ps.process_set_id, ps.group = None, None
        ps._hier_groups = {}

    def get(self, set_id: int) -> ProcessSet:
        with self._lock:
            return self._table[set_id]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._table)

    def clear(self):
        with self._lock:
            for ps in self._table.values():
                ps.process_set_id, ps.group = None, None
                # a caller may still hold a SubGroup: none may keep a
                # group, and with it rank 0's store, alive past shutdown
                for pair in ps._hier_groups.values():
                    for sub in pair:
                        if sub is not None:
                            sub.group = None
                ps._hier_groups = {}
            self._table.clear()
            self._next_id = 0
            for sub in self.subgroups.values():
                sub.group = None
            self.subgroups.clear()


class _RuntimeState:
    """Singleton global state (reference: HorovodGlobalState)."""

    def __init__(self):
        self.initialized = False
        self.config: Optional[Config] = None
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.device: Optional[torch.device] = None
        self.backend: Optional[str] = None
        self.store = None
        self.namespace = ""
        self.epoch: Optional[int] = None   # the elastic driver's epoch
        # each rank's host (cross rank), when the launcher's local and
        # cross sizes factor the world; None without a hierarchy
        self.hosts: Optional[List[int]] = None
        self.process_set_table = ProcessSetTable()
        self.global_process_set: Optional[ProcessSet] = None
        self.engine = None          # ops.engine.CollectiveEngine
        self.timeline = None        # timeline.Timeline
        self.stall_inspector = None  # stall.StallInspector
        self.autotuner = None       # autotune.ParameterManager
        self._init_lock = threading.Lock()


_STATE = _RuntimeState()
_INIT_GENERATION = 0  # survives shutdown(); processes re-init in lockstep
_ATEXIT_REGISTERED = False
_LAST_INIT_DEVICE: DeviceLike = None  # the device the last init() was given


def last_init_device() -> DeviceLike:
    """The ``device`` argument of the last :func:`init`: what an elastic
    re-initialization passes again."""
    return _LAST_INIT_DEVICE


def _state() -> _RuntimeState:
    return _STATE


def _require_init() -> _RuntimeState:
    if not _STATE.initialized:
        raise NotInitializedError()
    return _STATE


def timeout_s(cfg: Config) -> float:
    """The bound of one collective and of one negotiation round:
    HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, or :data:`DEFAULT_TIMEOUT_S`."""
    return (cfg.stall_shutdown_time if cfg.stall_shutdown_time > 0
            else DEFAULT_TIMEOUT_S)


def _resolve_device(device: DeviceLike, local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hvd.init() runs on a CUDA device by default and none is "
            "visible; pass device=\"cpu\" to run on the CPU over gloo")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no CUDA device of its own "
            f"({torch.cuda.device_count()} visible); NCCL cannot run two "
            f"ranks on one device: pass device= and HOROVOD_CONTROLLER=gloo "
            f"to share one")
    return torch.device("cuda", local_rank)


def _backend(cfg: Config, device: torch.device) -> str:
    choice = (cfg.controller or "").lower()
    if choice not in ("", "gloo", "nccl"):
        raise ValueError(f"HOROVOD_CONTROLLER must be gloo or nccl in the "
                         f"port, got {cfg.controller!r}")
    if device.type == "cpu":
        if choice == "nccl":
            raise ValueError("HOROVOD_CONTROLLER=nccl needs a CUDA device")
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return choice or "nccl"


def init(comm=None, process_sets: Optional[Sequence[ProcessSet]] = None,
         device: DeviceLike = None):
    """Initialize the runtime (reference: horovod_init).

    ``device`` is this process's device: by default ``cuda:<local_rank>``
    (raising when there is none), ``"cpu"`` for gloo on CPU tensors.
    ``comm`` is accepted for API compatibility; only ``None`` is supported.
    ``process_sets`` are created at init, in order, on every rank.
    """
    global _INIT_GENERATION, _ATEXIT_REGISTERED, _LAST_INIT_DEVICE
    with _STATE._init_lock:
        if _STATE.initialized:
            return
        if comm is not None:
            raise ValueError("init(comm=...) is not supported; use "
                             "process_sets for sub-groups")
        if dist.is_initialized():
            raise RuntimeError(
                "torch.distributed's default process group already exists; "
                "hvd.init() creates and owns it")
        # the first torch.optim optimizer imports dynamo; imported while a
        # default group exists, dynamo's distributed modules keep that
        # group, and with it rank 0's store and port, alive past shutdown,
        # so a later init could not listen again
        import torch._dynamo  # noqa: F401
        cfg = Config.from_env()
        _setup_logging(cfg)
        # the native control-plane core, built at first use; a failed
        # build raises here, before any group forms
        # (HOROVOD_TPU_NATIVE_CORE=0 runs the Python planner, decision,
        # timeline writer and stall tracker instead)
        core = None
        if cfg.use_native_core:
            from .native import loader
            core = loader.load()
        _LAST_INIT_DEVICE = device
        if cfg.elastic:
            rank, size, local_rank, dev, backend, store, epoch = \
                _elastic_form(cfg, device)
        else:
            rank, size, local_rank, dev, backend = _topology(cfg, device)
            store, epoch = _form(cfg, rank, size, dev, backend,
                                 timeout_s(cfg)), None

        _INIT_GENERATION += 1
        st = _STATE
        st.config = cfg
        st.rank, st.size = rank, size
        st.local_rank = local_rank
        st.local_size = (cfg.local_size if cfg.local_size is not None
                         else size)
        st.cross_rank = cfg.cross_rank if cfg.cross_rank is not None else 0
        st.cross_size = cfg.cross_size if cfg.cross_size is not None else 1
        st.device, st.backend, st.store = dev, backend, store
        st.epoch = epoch
        # controller keys are namespaced per incarnation, so init →
        # shutdown → init never reads an earlier incarnation's rounds:
        # elastic re-forms by the driver's epoch, plain re-inits by
        # generations counted in lockstep
        st.namespace = (f"e{epoch}" if epoch is not None
                        else f"g{_INIT_GENERATION}")
        st.hosts = _gather_hosts(st)
        st.process_set_table.clear()
        st.global_process_set = ProcessSet(None)
        st.process_set_table.register(st.global_process_set, size)
        for ps in process_sets or ():
            st.process_set_table.register(ps, size)
        from .ops import collectives
        collectives.reset_tail_state()

        from . import metrics
        metrics.init_from_env()
        if metrics.RECORDING:
            metrics.event("runtime.init", rank=rank, size=size)
        # the tracing identity: spans carry this rank, its host and the
        # elastic epoch, so the driver's /trace/job gives one pid a host
        # and lines rounds up across incarnations
        from . import tracing
        tracing.init_from_env()
        tracing.set_identity(process=rank,
                             host=os.environ.get("HOROVOD_HOSTNAME") or None,
                             epoch=epoch if epoch is not None else 0)
        # the training-health evaluator's identity: verdicts carry this
        # rank and host for the driver's /health/job merge; the history
        # survives elastic re-inits (a post-mortem scrape wants it)
        from . import health
        health.init_from_env()
        health.set_identity(process=rank,
                            host=os.environ.get("HOROVOD_HOSTNAME") or None)
        _make_tools(st, cfg, core)
        from .ops.controller import Controller
        from .ops.engine import CollectiveEngine
        controller = Controller(
            cfg, dist.PrefixStore(f"hvdctl/{st.namespace}", store), rank,
            size, deadline_s=timeout_s(cfg), stall=st.stall_inspector,
            core=core)
        controller.superseded_grace_s = _env_seconds(
            "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT", 10.0)
        st.engine = CollectiveEngine(
            cfg, dev, backend, controller, timeline=st.timeline,
            stall_inspector=st.stall_inspector, autotuner=st.autotuner,
            core=core)
        st.engine.start()
        # the step spans' counters, the span clock's anchor to the
        # profiler's epoch clock and, under HOROVOD_TRACE, the collector
        # hook
        tracing.steps.install(st.engine)
        st.initialized = True
        if not _ATEXIT_REGISTERED:
            atexit.register(shutdown)
            _ATEXIT_REGISTERED = True
        if epoch is not None:
            # rendezvous complete: the driver now counts a death of this
            # worker as a real host failure, not re-rendezvous churn
            from .elastic.worker import record_running
            record_running()
        logger.info("horovod_tpu_torch initialized: rank %d of %d on %s "
                    "over %s%s", rank, size, dev, backend,
                    "" if epoch is None else f", elastic epoch {epoch}")


def _gather_hosts(st: _RuntimeState) -> Optional[List[int]]:
    """Every rank's host (cross rank) when the launcher's local and cross
    sizes factor the world into two or more hosts; else None.  The ranks
    exchange their (local, cross) ranks once, so every rank sees the same
    layout and makes the same groups."""
    if not (st.size > 1 and st.cross_size >= 2
            and st.local_size * st.cross_size == st.size):
        return None
    pairs: List = [None] * st.size
    dist.all_gather_object(pairs, (st.local_rank, st.cross_rank))
    return [int(c) for _, c in pairs]


def _make_tools(st: _RuntimeState, cfg: Config, core) -> None:
    """The timeline, the stall inspector (its straggler scores wired to
    the elastic driver's blacklist) and, under HOROVOD_AUTOTUNE, the
    parameter manager (reference: ``runtime.py``'s observability
    subsystems); ``core`` is the native core (or None)."""
    from .stall import StallInspector
    from .timeline import Timeline
    st.timeline = Timeline(cfg.timeline_path,
                           mark_cycles=cfg.timeline_mark_cycles, core=core)

    def report_straggler(process, score):
        # a no-op outside the elastic driver (no endpoint exported)
        from .elastic import worker
        worker.report_straggler(process, score)

    st.stall_inspector = StallInspector(
        check_time=cfg.stall_check_time, disabled=cfg.stall_check_disable,
        blacklist_score=cfg.tail_blacklist_score,
        on_straggler=report_straggler, core=core)
    st.autotuner = None
    if cfg.autotune:
        from .autotune import ParameterManager
        # without a hierarchy the tuner's hierarchical switch is inert
        st.autotuner = ParameterManager(
            cfg, hier_available=st.global_process_set.hier_shape()
            is not None)


def _topology(cfg: Config, device: DeviceLike):
    """(rank, size, local rank, device, backend) from ``cfg``."""
    size = cfg.size if cfg.size is not None else 1
    rank = cfg.rank if cfg.rank is not None else 0
    if not 0 <= rank < size:
        raise ValueError(f"HOROVOD_RANK={rank} is outside "
                         f"HOROVOD_SIZE={size}")
    local_rank = cfg.local_rank if cfg.local_rank is not None else rank
    dev = _resolve_device(device, local_rank)
    return rank, size, local_rank, dev, _backend(cfg, dev)


def _form(cfg: Config, rank: int, size: int, dev: torch.device,
          backend: str, limit_s: float):
    """The store (rank 0's ``TCPStore``, or an in-process one at size 1)
    and the default process group over it; returns the store."""
    timeout = datetime.timedelta(seconds=limit_s)
    if size > 1:
        if not cfg.rendezvous_addr or cfg.rendezvous_port is None:
            raise ValueError(
                "HOROVOD_SIZE > 1 needs HOROVOD_GLOO_RENDEZVOUS_ADDR and "
                "HOROVOD_GLOO_RENDEZVOUS_PORT (rank 0 hosts the store)")
        store = dist.TCPStore(cfg.rendezvous_addr, cfg.rendezvous_port,
                              size, rank == 0, timeout=timeout)
    else:
        store = dist.HashStore()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=size,
        timeout=timeout, device_id=dev if backend == "nccl" else None)
    return store


def _elastic_form(cfg: Config, device: DeviceLike):
    """Join the elastic driver's current epoch (the JAX package's elastic
    rendezvous loop, ``horovod_tpu/runtime.py``): take rank, size, local
    and cross ranks and the store's address and port from the epoch's
    assignment and form the world, at most HOROVOD_ELASTIC_INIT_TIMEOUT
    an attempt; a failed attempt fetches the latest assignment again,
    until HOROVOD_ELASTIC_START_TIMEOUT.  Rank 0 that cannot listen on
    the epoch's port asks the driver for a new epoch (a new port).
    Without the driver's address the launcher's environment decides, as
    without HOROVOD_ELASTIC.  Returns :func:`_topology`'s tuple, the
    store and the epoch (None without the driver)."""
    from .elastic import worker
    deadline = time.monotonic() + _env_seconds(
        "HOROVOD_ELASTIC_START_TIMEOUT", 600.0)
    limit_s = min(timeout_s(cfg), _env_seconds(
        "HOROVOD_ELASTIC_INIT_TIMEOUT", 60.0))
    attempt = 0
    while True:
        # the first attempt wants an epoch newer than the last one this
        # worker saw (a re-form guarantees the bump); retries accept the
        # latest published epoch, whatever it is
        asg = worker.fetch_assignment(
            min_epoch=None if attempt == 0 else max(worker._last_epoch, 0),
            timeout=max(deadline - time.monotonic(), 1.0))
        if asg is not None:
            cfg.rank, cfg.size = asg["rank"], asg["size"]
            cfg.local_rank, cfg.local_size = (asg["local_rank"],
                                              asg["local_size"])
            cfg.cross_rank, cfg.cross_size = (asg["cross_rank"],
                                              asg["cross_size"])
            cfg.rendezvous_addr = asg["coordinator_addr"]
            cfg.rendezvous_port = asg["coordinator_port"]
            cfg.num_processes, cfg.process_id = asg["size"], asg["rank"]
        topo = _topology(cfg, device)
        rank, size, _, dev, backend = topo
        try:
            store = _form(cfg, rank, size, dev, backend, limit_s)
        except RuntimeError as e:
            # a peer that never came (it died, or formed another epoch),
            # or a port someone else holds
            if asg is None or time.monotonic() > deadline:
                raise
            if dist.is_initialized():
                dist.destroy_process_group()
            attempt += 1
            logger.warning("elastic rendezvous into epoch %d failed (%s); "
                           "fetching the assignment again", asg["epoch"], e)
            if rank == 0 and "address already in use" in str(e).lower():
                worker.request_reform()
            continue
        return (*topo, store, None if asg is None else asg["epoch"])


def note_superseded(epoch: int, lost: Sequence[int] = ()) -> None:
    """The elastic driver applied ``epoch``; ``lost`` are the ranks of the
    epoch before it whose processes died.  If this runtime belongs to an
    older epoch, its negotiation rounds stop waiting for the lost ranks at
    once and for the others after HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT, and
    its teardown waits for no lost rank.  Called from the worker's
    notification thread; takes no runtime lock."""
    st = _STATE
    engine = st.engine
    ctl = engine._controller if engine is not None else None
    if (not st.initialized or st.epoch is None or st.epoch >= epoch
            or ctl is None):
        return
    ctl.mark_superseded(lost if st.epoch == epoch - 1 else ())


def shutdown():
    """Tear down the runtime (reference: horovod_shutdown).

    Every rank meets the others at a barrier first, at most as long as one
    collective may take.  Under the elastic driver the process group goes
    before the barrier, so a peer blocked in a collective with this rank
    fails at once; the barrier waits for no rank the driver reported
    dead and at most HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT; and each epoch's
    store has a port of its own, so no rank waits for rank 0's store to
    close."""
    with _STATE._init_lock:
        st = _STATE
        if not st.initialized:
            return
        ctl = st.engine._controller if st.engine is not None else None
        elastic = st.epoch is not None
        # a client rank keeps its connection until rank 0's server is
        # gone: returning earlier, a re-init could reach the old server
        client = (st.store if st.size > 1 and st.rank != 0 and not elastic
                  else None)
        try:
            from . import metrics
            if metrics.RECORDING:
                metrics.event("runtime.shutdown")
            metrics.stop_exposition()
            if _PROFILER:
                stop_profiler()
            from . import tracing
            tracing.steps.uninstall()
            if st.engine is not None:
                st.engine.stop()
            if st.timeline is not None:
                st.timeline.close()
            if elastic:
                # the sets hold the groups: with them gone, destroying
                # closes the sockets, and a peer blocked in a collective
                # with this rank fails at once
                st.global_process_set = None
                st.process_set_table.clear()
                dist.destroy_process_group()
            if st.size > 1:
                _shutdown_barrier(st, ctl, _env_seconds(
                    "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT", 10.0)
                    if elastic else timeout_s(st.config))
        finally:
            if ctl is not None:
                ctl.release()
            if dist.is_initialized():
                dist.destroy_process_group()
            st.initialized = False
            st.engine = None
            st.store = None
            st.epoch = None
            st.hosts = None
            st.autotuner = None
            st.global_process_set = None
            st.process_set_table.clear()
            if client is not None:
                _await_server_close(client, timeout_s(st.config))


def _shutdown_barrier(st: _RuntimeState, ctl, limit_s: float):
    """Wait until every rank has reached shutdown, at most ``limit_s``: a
    rank may still be reading the last negotiation round, whose keys and
    rank 0's store must outlive it.  Ranks the elastic driver reported
    dead are not waited for."""
    key = f"hvd_shutdown/{st.namespace}"
    try:
        st.store.add(key, 1)
        deadline = time.monotonic() + limit_s
        while (st.store.add(key, 0) < st.size - len(ctl.lost if ctl
                                                       else ())
               and time.monotonic() < deadline):
            time.sleep(0.005)
    except (RuntimeError, dist.DistError):  # a peer's store may be gone
        logger.debug("shutdown barrier failed", exc_info=True)


def _await_server_close(client, limit_s: float) -> None:
    """Poll rank 0's store through ``client`` until its server has closed
    (bounded by ``limit_s``)."""
    deadline = time.monotonic() + limit_s
    try:
        while time.monotonic() < deadline:
            client.check(["hvd_shutdown/closed"])
            time.sleep(0.005)
        logger.warning("rank 0's store still answers %.0f s after shutdown",
                       limit_s)
    except (RuntimeError, dist.DistError):
        pass    # closed: the next init cannot reach the old server


def is_initialized() -> bool:
    """Reference: hvd.is_initialized()."""
    return _STATE.initialized


def start_timeline(file_path: str, mark_cycles: bool = False):
    """Write the timeline to ``file_path`` from now on (reference:
    hvd.start_timeline); an open timeline closes first."""
    _require_init().timeline.reopen(file_path, mark_cycles=mark_cycles)


def stop_timeline():
    """Close the timeline's file (reference: hvd.stop_timeline)."""
    _require_init().timeline.close()


#: the running ``start_profiler`` capture: ``[profile, logdir, start]``
#: (``start`` on the span buffer's clock)
_PROFILER: list = []


def start_profiler(logdir: str):
    """Start a ``torch.profiler`` capture of the host and, on a CUDA
    device, the card (JAX ``hvd.start_profiler`` over ``jax.profiler``).
    Until :func:`stop_profiler` each engine dispatch is a
    ``record_function`` range named after its bucket
    (``hvd.<op>[<tensors>]``) and each phase of a training step one named
    after the phase (``hvd.step``, ``hvd.forward``, ...), so the ranges
    and the kernels land in one trace, ranges from the engine's thread
    included (the profiler is asked to record every thread); the span
    ring's spans join the trace at :func:`stop_profiler`."""
    from . import tracing
    st = _require_init()
    if _PROFILER:
        raise RuntimeError("start_profiler: a capture is already running; "
                           "call stop_profiler() first")
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if st.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        cfg = None   # a torch without it records the caller's thread only
    prof = profile(activities=acts, experimental_config=cfg)
    prof.start()
    _PROFILER[:] = [prof, logdir, tracing.now()]
    tracing.steps.PROFILING = True


def stop_profiler() -> str:
    """Stop the capture and write it to
    ``<logdir>/hvd_profile.rank<r>.<pid>.json`` (a Chrome trace that
    Perfetto and ``chrome://tracing`` load), with the span ring's spans of
    the capture's interval appended under their own names on the trace's
    own time base (its ``baseTimeNanoseconds`` where it has one), one
    lane a category; returns the path."""
    import json
    from . import tracing
    st = _require_init()
    if not _PROFILER:
        raise RuntimeError("stop_profiler: no capture is running; call "
                           "start_profiler(logdir) first")
    prof, logdir, t_lo = _PROFILER
    del _PROFILER[:]
    tracing.steps.PROFILING = False
    prof.stop()
    t_hi = tracing.now()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"hvd_profile.rank{st.rank}.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(tracing.profile_events(
        t_lo, t_hi, int(trace.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


# --- topology accessors (reference: horovod/common/basics.py) ---------------

def size() -> int:
    """Number of processes (one GPU each)."""
    return _require_init().size


def rank() -> int:
    return _require_init().rank


def local_size() -> int:
    return _require_init().local_size


def local_rank() -> int:
    return _require_init().local_rank


def cross_size() -> int:
    return _require_init().cross_size


def cross_rank() -> int:
    return _require_init().cross_rank


def is_homogeneous() -> bool:
    """Reference: horovod_is_homogeneous — equal local sizes on all hosts
    (the launcher's env contract sets one local size for every host)."""
    st = _require_init()
    return st.local_size * st.cross_size == st.size


def device() -> torch.device:
    """This process's device (the port's addition)."""
    return _require_init().device


# --- feature queries (reference: basics.py) ---------------------------------

def mpi_threads_supported() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def gloo_enabled() -> bool:
    return _STATE.initialized and _STATE.backend == "gloo"


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def rocm_built() -> bool:
    return torch.version.hip is not None


def xla_built() -> bool:
    return False


def tpu_built() -> bool:
    return False


# --- process set API (reference: horovod/common/process_sets.py) ------------

def _get_global_process_set() -> ProcessSet:
    return _require_init().global_process_set


def add_process_set(ps_or_ranks) -> ProcessSet:
    """Create a process set at runtime (reference: hvd.add_process_set);
    every rank must call it, in the same order."""
    st = _require_init()
    ps = (ps_or_ranks if isinstance(ps_or_ranks, ProcessSet)
          else ProcessSet(ps_or_ranks))
    st.process_set_table.register(ps, st.size)
    return ps


def remove_process_set(ps: ProcessSet) -> bool:
    st = _require_init()
    if not ps.initialized():
        return False
    st.process_set_table.remove(ps.process_set_id)
    return True


def get_process_set_ids_and_ranks() -> Dict[int, List[int]]:
    st = _require_init()
    return {i: list(st.process_set_table.get(i).ranks)
            for i in st.process_set_table.ids()}


def get_process_set_by_id(set_id: int) -> ProcessSet:
    """Resolve a registered process set by its id (counterpart:
    ``horovod_tpu/runtime.py`` ``get_process_set_by_id``; reference:
    process_set.cc lookups): the TF op bridge carries the id through an
    op attribute."""
    st = _require_init()
    try:
        return st.process_set_table.get(set_id)
    except KeyError:
        raise ValueError(
            f"process set id {set_id} is not registered (removed, or "
            "from a previous init?) — compiled graphs carrying the id "
            "must not outlive remove_process_set") from None


def _setup_logging(cfg: Config):
    level = {
        "trace": logging.DEBUG, "debug": logging.DEBUG,
        "info": logging.INFO, "warning": logging.WARNING,
        "error": logging.ERROR, "fatal": logging.CRITICAL,
        "off": logging.CRITICAL,
    }.get(cfg.log_level.lower(), logging.WARNING)
    fmt = ("%(asctime)s %(name)s %(levelname)s: %(message)s"
           if cfg.log_timestamp else "%(name)s %(levelname)s: %(message)s")
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(fmt))
    logger.handlers[:] = [handler]
    logger.setLevel(level)
