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

The collectives run over one ``torch.distributed`` process group per
process set: NCCL on ``cuda:<local_rank>`` by default, gloo with
``init(device="cpu")``.  ``HOROVOD_CONTROLLER=gloo`` puts CUDA tensors
through gloo, which is how two ranks can share one card (NCCL refuses two
ranks on one device).  Every collective of every set goes through the
background engine (``ops/engine.py``), so the ranks issue them in one
negotiated order.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import DeviceLike
from .config import Config
from .exceptions import NotInitializedError

logger = logging.getLogger("horovod_tpu_torch")

#: how long a process group waits in one collective, and the bound of a
#: negotiation round, when HOROVOD_STALL_SHUTDOWN_TIME_SECONDS is 0
DEFAULT_TIMEOUT_S = 300.0


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


class ProcessSet:
    """A subset of ranks with its own process group.

    ``ranks`` are global ranks into ``hvd.size()``.  Every rank of the
    world registers every set (``torch.distributed.new_group`` is
    collective over the world), in the same order.
    """

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(int(r) for r in ranks) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        self.group = None   # the torch ProcessGroup (None if excluded)

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

    def _check(self):
        if not self.initialized():
            raise NotInitializedError("ProcessSet")

    def __repr__(self):
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


class ProcessSetTable:
    """Registry of process sets (reference: ProcessSetTable)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[int, ProcessSet] = {}
        self._next_id = 0

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
        with self._lock:
            ps.ranks = ranks
            ps.process_set_id = set_id
            ps.group = group if _state().rank in ranks else None
            self._table[set_id] = ps
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
        ps.process_set_id, ps.group = None, None

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
            self._table.clear()
            self._next_id = 0


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
        self.process_set_table = ProcessSetTable()
        self.global_process_set: Optional[ProcessSet] = None
        self.engine = None          # ops.engine.CollectiveEngine
        self._init_lock = threading.Lock()


_STATE = _RuntimeState()
_INIT_GENERATION = 0  # survives shutdown(); processes re-init in lockstep
_ATEXIT_REGISTERED = False


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
    global _INIT_GENERATION, _ATEXIT_REGISTERED
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
        size = cfg.size if cfg.size is not None else 1
        rank = cfg.rank if cfg.rank is not None else 0
        if not 0 <= rank < size:
            raise ValueError(f"HOROVOD_RANK={rank} is outside "
                             f"HOROVOD_SIZE={size}")
        local_rank = cfg.local_rank if cfg.local_rank is not None else rank
        dev = _resolve_device(device, local_rank)
        backend = _backend(cfg, dev)
        timeout = datetime.timedelta(seconds=timeout_s(cfg))
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
        # controller keys are namespaced per incarnation, so init →
        # shutdown → init never reads an earlier incarnation's rounds
        st.namespace = f"g{_INIT_GENERATION}"
        st.process_set_table.clear()
        st.global_process_set = ProcessSet(None)
        st.process_set_table.register(st.global_process_set, size)
        for ps in process_sets or ():
            st.process_set_table.register(ps, size)

        from .ops.controller import Controller
        from .ops.engine import CollectiveEngine
        controller = Controller(
            cfg, dist.PrefixStore(f"hvdctl/{st.namespace}", store), rank,
            size, deadline_s=timeout_s(cfg))
        st.engine = CollectiveEngine(cfg, dev, backend, controller)
        st.engine.start()
        st.initialized = True
        if not _ATEXIT_REGISTERED:
            atexit.register(shutdown)
            _ATEXIT_REGISTERED = True
        logger.info("horovod_tpu_torch initialized: rank %d of %d on %s "
                    "over %s", rank, size, dev, backend)


def shutdown():
    """Tear down the runtime (reference: horovod_shutdown)."""
    with _STATE._init_lock:
        st = _STATE
        if not st.initialized:
            return
        ctl = st.engine._controller if st.engine is not None else None
        # a client rank keeps its connection until rank 0's server is
        # gone: returning earlier, a re-init could reach the old server
        client = st.store if st.size > 1 and st.rank != 0 else None
        try:
            if st.engine is not None:
                st.engine.stop()
            if st.size > 1:
                _shutdown_barrier(st)
        finally:
            if ctl is not None:
                ctl.release()
            dist.destroy_process_group()
            st.initialized = False
            st.engine = None
            st.store = None
            st.global_process_set = None
            st.process_set_table.clear()
            if client is not None:
                _await_server_close(client, timeout_s(st.config))


def _shutdown_barrier(st: _RuntimeState):
    """Wait until every rank has reached shutdown, at most as long as one
    collective may take: a rank may still be reading the last negotiation
    round, whose keys and rank 0's store must outlive it."""
    key = f"hvd_shutdown/{st.namespace}"
    try:
        st.store.add(key, 1)
        deadline = time.monotonic() + timeout_s(st.config)
        while (st.store.add(key, 0) < st.size
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
