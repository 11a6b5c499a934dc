"""Public collective API on torch tensors: allreduce, allgather, broadcast,
alltoall, reducescatter, their async and grouped forms, and handles.

Counterpart: ``horovod_tpu/api.py`` and the tensor functions of
``horovod_tpu/torch/__init__.py``, after ``horovod/torch/mpi_ops.py``: the
same surface (sync and ``_async`` forms, ``grouped_*`` forms,
``synchronize``/``poll``/``wait``, ``join``, ``barrier``, the object
collectives) with the same defaults (``op=Average``, call-site tensor
names, prescale/postscale factors, compression) and the same ops
(``op=Adasum`` included).  Every call goes through the background
engine, which negotiates and fuses it.

Differences from the JAX package, all deliberate: each rank passes its own
tensor and gets its own result (one process per GPU: no stacked
``worker_values`` arrays), so a rank's reducescatter result is already its
own slice; and the in-place ``*_`` forms write the result into the tensor
passed.
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence

import torch

from . import runtime
from .compression import Compression
from .ops.engine import Handle, TensorTableEntry
from .runtime import ReduceOp, _require_init


def _engine():
    return _require_init().engine


def _ps(process_set):
    if process_set is None:
        return runtime._get_global_process_set()
    if not process_set.initialized():
        raise ValueError("process set is not initialized")
    if not process_set.included():
        raise ValueError(f"rank {runtime.rank()} is not a member of "
                         f"{process_set}")
    return process_set


def _resolve_op(average: Optional[bool], op: Optional[str]) -> str:
    # Reference: horovod/torch/mpi_ops.py handle_average_backwards_compatibility
    if average is not None and op is not None:
        raise ValueError("The average and op arguments cannot both be set; "
                         "use op alone.")
    if op is None:
        return ReduceOp.AVERAGE if (average is None or average) \
            else ReduceOp.SUM
    return op


def _scale(factor) -> Optional[float]:
    return None if factor == 1.0 else float(factor)


def _submit(op_type, tensors, prefix, name, process_set, grouped=False,
            **kw) -> Handle:
    eng = _engine()
    return eng.submit(TensorTableEntry(
        name=name or eng.auto_name(prefix), op_type=op_type,
        tensors=tensors, process_set=_ps(process_set),
        group_id=eng.next_group_id() if grouped else -1, **kw))


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None) -> Handle:
    """Asynchronous allreduce; returns a handle for :func:`synchronize`."""
    return _submit("allreduce", [tensor], "allreduce", name, process_set,
                   reduce_op=_resolve_op(average, op),
                   prescale=_scale(prescale_factor),
                   postscale=_scale(postscale_factor))


def allreduce(tensor, average=None, name=None, compression=Compression.none,
              op=None, prescale_factor=1.0, postscale_factor=1.0,
              process_set=None):
    """Blocking allreduce (reference default: average)."""
    wire, ctx = compression.compress(tensor)
    handle = allreduce_async(wire, average, name, op, prescale_factor,
                             postscale_factor, process_set)
    return compression.decompress(handle.synchronize(), ctx)


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None) -> Handle:
    """In-place async allreduce: the result is written into ``tensor``,
    which :func:`synchronize` returns."""
    return _submit("allreduce", [tensor], "allreduce", name, process_set,
                   reduce_op=_resolve_op(average, op),
                   prescale=_scale(prescale_factor),
                   postscale=_scale(postscale_factor), inplace=True)


def _allreduce_each_async_(tensors: Sequence, names: Sequence[str],
                           op=None, postscale_factor=1.0,
                           process_set=None) -> List[Handle]:
    """One in-place allreduce per tensor, submitted to the engine at once so
    one cycle plans them into fused buckets together (the train step's
    gradient plane)."""
    eng, ps, rop = _engine(), _ps(process_set), _resolve_op(None, op)
    return eng.submit([TensorTableEntry(
        name=n, op_type="allreduce", tensors=[t], process_set=ps,
        reduce_op=rop, postscale=_scale(postscale_factor), inplace=True)
        for t, n in zip(tensors, names)])


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    """In-place allreduce; returns ``tensor``."""
    return allreduce_async_(tensor, average, name, op, prescale_factor,
                            postscale_factor, process_set).synchronize()


def grouped_allreduce_async(tensors: Sequence, average=None, name=None,
                            op=None, prescale_factor=1.0,
                            postscale_factor=1.0, process_set=None) -> Handle:
    """Grouped allreduce: the tensors fuse atomically (reference:
    group_table.cc all-or-nothing semantics)."""
    return _submit("allreduce", list(tensors), "grouped_allreduce", name,
                   process_set, grouped=True,
                   reduce_op=_resolve_op(average, op),
                   prescale=_scale(prescale_factor),
                   postscale=_scale(postscale_factor))


def grouped_allreduce(tensors: Sequence, average=None, name=None,
                      compression=Compression.none, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=None) -> List:
    wires, ctxs = zip(*[compression.compress(t) for t in tensors]) \
        if tensors else ((), ())
    handle = grouped_allreduce_async(wires, average, name, op,
                                     prescale_factor, postscale_factor,
                                     process_set)
    return [compression.decompress(r, c)
            for r, c in zip(handle.synchronize(), ctxs)]


def grouped_allreduce_async_(tensors: Sequence, average=None, name=None,
                             op=None, prescale_factor=1.0,
                             postscale_factor=1.0,
                             process_set=None) -> Handle:
    return _submit("allreduce", list(tensors), "grouped_allreduce", name,
                   process_set, grouped=True,
                   reduce_op=_resolve_op(average, op),
                   prescale=_scale(prescale_factor),
                   postscale=_scale(postscale_factor), inplace=True)


def grouped_allreduce_(tensors: Sequence, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=None) -> List:
    return grouped_allreduce_async_(tensors, average, name, op,
                                    prescale_factor, postscale_factor,
                                    process_set).synchronize()


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------

def allgather_async(tensor, name=None, process_set=None) -> Handle:
    return _submit("allgather", [tensor], "allgather", name, process_set)


def allgather(tensor, name=None, process_set=None):
    """Every rank's tensor concatenated along dim 0, in rank order; the
    ranks may contribute different dim-0 sizes."""
    return allgather_async(tensor, name, process_set).synchronize()


def grouped_allgather_async(tensors: Sequence, name=None,
                            process_set=None) -> Handle:
    return _submit("allgather", list(tensors), "grouped_allgather", name,
                   process_set, grouped=True)


def grouped_allgather(tensors: Sequence, name=None, process_set=None) -> List:
    return grouped_allgather_async(tensors, name, process_set).synchronize()


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------

def broadcast_async(tensor, root_rank: int, name=None,
                    process_set=None) -> Handle:
    return _submit("broadcast", [tensor], "broadcast", name, process_set,
                   root_rank=root_rank)


def broadcast(tensor, root_rank: int, name=None, process_set=None):
    """Rank ``root_rank``'s tensor (rank within the process set) on every
    rank."""
    return broadcast_async(tensor, root_rank, name, process_set).synchronize()


def broadcast_async_(tensor, root_rank: int, name=None,
                     process_set=None) -> Handle:
    return _submit("broadcast", [tensor], "broadcast", name, process_set,
                   root_rank=root_rank, inplace=True)


def broadcast_(tensor, root_rank: int, name=None, process_set=None):
    """In-place broadcast: the root's value is written into ``tensor``."""
    return broadcast_async_(tensor, root_rank, name,
                            process_set).synchronize()


def broadcast_object(obj, root_rank: int = 0, name=None, process_set=None):
    """Pickle ``obj`` on the root and return it on every rank (reference:
    broadcast_object: the payload's size, then the payload, as tensors)."""
    ps = _ps(process_set)
    name = name or _engine().auto_name("broadcast_object")
    dev = runtime.device()
    payload = None
    if ps.rank() == root_rank:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8).to(dev)
    n = torch.tensor([0 if payload is None else payload.numel()],
                     dtype=torch.int64, device=dev)
    n = int(broadcast_(n, root_rank, f"{name}.size", process_set).item())
    if payload is None:
        payload = torch.empty(n, dtype=torch.uint8, device=dev)
    data = broadcast_(payload, root_rank, f"{name}.data", process_set)
    if ps.rank() == root_rank:
        return obj
    return pickle.loads(data.cpu().numpy().tobytes())


def allgather_object(obj, name=None, process_set=None) -> List:
    """Pickle ``obj`` on every rank; returns the objects by rank within the
    process set (reference: allgather_object)."""
    _ps(process_set)
    name = name or _engine().auto_name("allgather_object")
    dev = runtime.device()
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(dev)
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                   device=dev), f"{name}.size", process_set)
    data = allgather(payload, f"{name}.data", process_set).cpu()
    out, offset = [], 0
    for n in sizes.tolist():
        out.append(pickle.loads(data[offset:offset + n].numpy().tobytes()))
        offset += n
    return out


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------

def alltoall_async(tensor, splits=None, name=None, process_set=None) -> Handle:
    ps = _ps(process_set)
    if splits is not None:
        splits = [int(s) for s in splits]
        if len(splits) != ps.size():
            raise ValueError(f"splits must have one entry per rank "
                             f"({ps.size()}), got {len(splits)}")
    return _submit("alltoall", [tensor], "alltoall", name, process_set,
                   splits=splits)


def alltoall(tensor, splits=None, name=None, process_set=None):
    """Rows ``splits[j]`` of ``tensor`` go to rank ``j`` (MPI_Alltoallv,
    with one ``splits`` on every rank, as in the JAX package)."""
    return alltoall_async(tensor, splits, name, process_set).synchronize()


# ---------------------------------------------------------------------------
# reducescatter
# ---------------------------------------------------------------------------

def _rs_op(op):
    rop = _resolve_op(None, op)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"reducescatter supports Sum and Average, got {rop}")
    return rop


def reducescatter_async(tensor, op=None, name=None,
                        process_set=None) -> Handle:
    return _submit("reducescatter", [tensor], "reducescatter", name,
                   process_set, reduce_op=_rs_op(op))


def reducescatter(tensor, op=None, name=None, process_set=None):
    """The reduction of every rank's tensor; rank ``i`` of the set gets
    the ``i``-th of ``size`` equal slices of dim 0."""
    return reducescatter_async(tensor, op, name, process_set).synchronize()


def grouped_reducescatter_async(tensors: Sequence, op=None, name=None,
                                process_set=None) -> Handle:
    return _submit("reducescatter", list(tensors), "grouped_reducescatter",
                   name, process_set, grouped=True, reduce_op=_rs_op(op))


def grouped_reducescatter(tensors: Sequence, op=None, name=None,
                          process_set=None) -> List:
    return grouped_reducescatter_async(tensors, op, name,
                                       process_set).synchronize()


# ---------------------------------------------------------------------------
# handle management / sync primitives
# ---------------------------------------------------------------------------

def synchronize(handle: Handle):
    """Wait for an async handle's result (reference: hvd.synchronize)."""
    return handle.synchronize()


def poll(handle: Handle) -> bool:
    """Non-blocking completion test (reference: hvd.poll)."""
    return handle.poll()


def wait(handle: Handle, timeout: Optional[float] = None) -> bool:
    return handle.wait(timeout)


def barrier(process_set=None):
    """Block until every rank of the process set reaches the barrier
    (reference: BarrierOp), negotiated and dispatched like any collective."""
    token = torch.zeros(1, device=runtime.device())
    _submit("barrier", [token], "barrier", None, process_set).synchronize()


def join(device: int = -1) -> int:
    """Signal that this rank has no more collectives this epoch.

    Reference: hvd.join (JoinOp) — ranks with uneven batch counts finish:
    while joined, this rank keeps answering negotiation rounds and
    contributes zeros to the others' allreduces until every rank has
    joined.  Returns the last rank to join.  ``device`` is accepted for
    API compatibility and ignored.
    """
    st = _require_init()
    if st.engine._controller is not None and st.engine._controller.enabled:
        return st.engine.join()
    return st.size - 1
