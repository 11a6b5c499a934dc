"""TensorFlow framework adapter over the port's engine (counterpart:
``horovod_tpu/tensorflow/__init__.py``).

Reference parity: ``horovod/tensorflow/__init__.py`` (SURVEY.md §2.2,
§3.3 TF analog) — ``DistributedGradientTape``, ``DistributedOptimizer``
(legacy-style wrapper), ``broadcast_variables``, tensor collectives, and
the aggregation knobs (``backward_passes_per_step`` via local
accumulation).

The boundary: a TF tensor's numpy value becomes a torch tensor on the
runtime's device (``runtime._state().device``), goes through the port's
``api`` like any other frontend's, and comes back to TF in its own dtype
(bfloat16 crosses as a 16-bit view; ``_xla_bridge.to_torch``).  Inside
``tf.function`` a collective reaches the engine through ``tf.py_function``
or, at world > 1, through the registered op bridge (``_xla_bridge``,
``native/tf_xla_ops.cc``), whose XLA kernels keep the collectives alive
under ``tf.function(jit_compile=True)``.

One process is one rank here, so "one process" means ``size() == 1``
(the JAX package keys it on ``cross_size()``, its process count; the
port's ``cross_size()`` counts hosts).  At world 1 a collective traced
into a graph lowers to plain TF ops — the identity, scaled by the
factors: a Sum of one, an allgather of one, an alltoall to oneself — so
``tf.function(jit_compile=True)`` compiles without the bridge.  At world
> 1 the ``py_function`` ops carry ``requires_jit_compile_False_see_docs_
adapters_md`` in their names, so the error XLA raises on them names the
way out.  Eager calls always go through the engine.
"""

from __future__ import annotations

import os
import weakref
from typing import List, Optional, Sequence

import numpy as np

try:
    import tensorflow as tf
except ImportError as _exc:
    raise ImportError(
        "horovod_tpu_torch.tensorflow needs the tensorflow package, which "
        "is not installed here; PyTorch training takes "
        "`import horovod_tpu_torch.torch as hvd` (or `import "
        "horovod_tpu_torch as hvd`) instead") from _exc

from .. import api as _api
from .. import runtime as _runtime
from ..compression import Compression
from ..exceptions import HorovodInternalError  # noqa: F401
from ..runtime import (Adasum, Average, ReduceOp, Sum,  # noqa: F401
                       init, is_initialized, shutdown, rank, size,
                       local_rank, local_size, cross_rank, cross_size,
                       mpi_threads_supported, mpi_built, mpi_enabled,
                       gloo_built, gloo_enabled, nccl_built, cuda_built,
                       rocm_built, xla_built, tpu_built,
                       ProcessSet, add_process_set, remove_process_set)
from . import _xla_bridge
from ._xla_bridge import TfXlaBridgeError, to_numpy, to_torch

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "Average", "Sum", "Adasum",
    "allreduce", "grouped_allreduce", "allgather", "grouped_allgather",
    "reducescatter", "grouped_reducescatter", "broadcast",
    "broadcast_variables", "broadcast_object", "allgather_object",
    "alltoall", "join",
    "barrier", "rank_op", "size_op", "local_rank_op", "local_size_op",
    "DistributedGradientTape", "DistributedOptimizer",
    "Compression", "ProcessSet", "add_process_set", "remove_process_set",
]


# Reference: horovod/tensorflow/xla_mpi_ops.cc kept collectives alive
# under XLA compilation via CustomCall.  Here: a world of one lowers its
# collectives to plain TF ops at trace time, and a larger world reaches
# the engine through the op bridge's XLA kernels; the py_function ops,
# which XLA cannot compile, carry a self-documenting name so the
# "unsupported op" error names the fix (jit_compile=False, or the
# bridge) and the doc (docs/adapters.md) instead of a bare EagerPyFunc.
_XLA_FENCE = "requires_jit_compile_False_see_docs_adapters_md"

# dtypes the custom-op bridge's kernels support
_BRIDGE_DTYPES = (tf.float32, tf.float64, tf.float16, tf.int32, tf.int64,
                  tf.bfloat16)
# the agreement rounds' answers by process-set id, for one init: True
# (every member has the bridge), False (one has it off) or the error
_bridge_consensus: dict = {}
_bridge_consensus_generation = None


def _psid(process_set) -> int:
    return -1 if process_set is None else int(process_set.process_set_id)


def _bridge_agreed(process_set=None) -> bool:
    """Whether EVERY member process takes the bridge.

    The bridge and py_function paths submit structurally different work
    (per-dtype grouped ops with suffixed names vs one group), so the
    members must agree.  One engine round over the call's process set at
    first use shares each member's :func:`_xla_bridge.status` (cached per
    set and init): all ``ok`` takes the bridge; one ``off``
    (``HOROVOD_TF_XLA_OPS=0``, which may differ between processes) keeps
    every member on py_function; one ``failed`` makes every member raise
    the same :class:`TfXlaBridgeError`, naming the failed ranks and
    ending with the first one's error, so no rank waits on a collective
    its peers submit another way."""
    global _bridge_consensus_generation
    _runtime._require_init()
    if _bridge_consensus_generation != _runtime._INIT_GENERATION:
        _bridge_consensus.clear()
        _bridge_consensus_generation = _runtime._INIT_GENERATION
    key = _psid(process_set)
    if key not in _bridge_consensus:
        answers = _api.allgather_object(_xla_bridge.status(),
                                        name=f"tfxla.bridge.ok.{key}",
                                        process_set=process_set)
        members = (process_set.ranks if process_set is not None
                   else list(range(size())))
        failed = [(m, text) for m, (state, text) in zip(members, answers)
                  if state == "failed"]
        if failed:
            tail = "\n".join(failed[0][1].strip().splitlines()[-20:])
            _bridge_consensus[key] = TfXlaBridgeError(
                f"the TF op bridge failed to build or load on rank(s) "
                f"{[m for m, _ in failed]} of {members}, so every member "
                f"raises rather than wait on a collective its peers "
                f"submit another way. Set HOROVOD_TF_XLA_OPS=0 on every "
                f"process for the py_function path (which "
                f"jit_compile=True cannot compile). Rank {failed[0][0]}'s "
                f"error ends:\n{tail}")
        else:
            _bridge_consensus[key] = all(state == "ok"
                                         for state, _ in answers)
    agreed = _bridge_consensus[key]
    if isinstance(agreed, TfXlaBridgeError):
        raise agreed
    return agreed


def _f32_exact(v: float) -> bool:
    return float(np.float32(v)) == float(v)


def _bridge(dtypes, process_set=None, scales=()):
    """The registered custom-op library when it serves this call
    (reference: mpi_ops.cc registered ops + xla_mpi_ops.cc CustomCall —
    collectives that survive ``tf.function(jit_compile=True)``).

    None (the py_function path) at world 1, whose graphs lower to plain
    TF ops, for dtypes outside the kernel table, and for scale factors
    f32 cannot hold exactly (they ride f32 op attrs, as upstream's op
    def has them; py_function forwards the full double).  Process-set
    scoped calls carry the registered set id through the op attr.  The
    members agree on the path first (:func:`_bridge_agreed`)."""
    if process_set is not None and not process_set.initialized():
        return None
    if not is_initialized() or size() <= 1:
        return None
    for dt in dtypes:
        if dt not in _BRIDGE_DTYPES:
            return None
    for v in scales:
        if not _f32_exact(v):
            return None
    if not _bridge_agreed(process_set):
        return None
    return _xla_bridge


def _n_workers(process_set) -> int:
    return process_set.size() if process_set is not None else size()


def _graph_singleproc() -> bool:
    """Tracing a tf.function in a world of one?  (Eager calls keep the
    engine path for timeline/stats; a larger world always does.)"""
    if tf.executing_eagerly():
        return False
    return is_initialized() and size() == 1


def _scaled(x, factor: float):
    return x if factor == 1.0 else x * tf.cast(factor, x.dtype)


# the name of the last collective op added to each graph being traced
# (a name, not the op, which would keep its graph alive)
_LAST_COLLECTIVE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _in_order(make, *args, **kwargs):
    """``make(*args, **kwargs)``, which adds one collective op, run after
    the previous collective of the same graph.  A rank blocks a TF
    executor thread in each collective until its peers submit theirs, so
    the collectives of one graph must run in the order they were traced,
    the same on every rank; TF would otherwise pick any ready op first (a
    pool of one thread on ``OMP_NUM_THREADS=1`` then waits forever)."""
    if tf.executing_eagerly():
        return make(*args, **kwargs)
    graph = tf.compat.v1.get_default_graph()
    prev = _LAST_COLLECTIVE.get(graph)
    with tf.control_dependencies(
            [] if prev is None else [graph.get_operation_by_name(prev)]):
        out = make(*args, **kwargs)
    _LAST_COLLECTIVE[graph] = (out[0] if isinstance(out, (list, tuple))
                               else out).op.name
    return out


def _py_op(fn, inputs, Tout, name: str):
    """``fn`` as a py_function op named after the fence, in trace order."""
    return _in_order(tf.py_function, fn, inputs, Tout=Tout,
                     name=f"{name}__{_XLA_FENCE}")


def _allreduce_sparse_many(slices, name, rop, process_set):
    """Sparse allreduce for a LIST of tf.IndexedSlices: every tensor's
    values+indices gather in ONE atomic group (a single negotiated
    round for all sparse gradients — the same one-round design as the
    dense grouped path).  Duplicate indices sum implicitly when the
    slices are applied (reference: hvd.tensorflow's IndexedSlices
    handling); each rank's nonzero count may differ — the ragged
    gathers ride the engine's Allgatherv."""
    if rop not in (Sum, Average):
        raise ValueError(
            f"sparse allreduce supports Sum and Average, got {rop}")
    flat = []
    for sl in slices:
        flat.append(tf.convert_to_tensor(sl.values))
        flat.append(tf.convert_to_tensor(sl.indices))
    gathered = grouped_allgather(flat, name=name, process_set=process_set)
    n = _n_workers(process_set)
    out = []
    for k, sl in enumerate(slices):
        vals, idx = gathered[2 * k], gathered[2 * k + 1]
        if rop == Average:
            vals = vals / tf.cast(n, vals.dtype)
        out.append(tf.IndexedSlices(vals, idx, sl.dense_shape))
    return out


def _allreduce_sparse(sl, name, rop, process_set):
    return _allreduce_sparse_many([sl], name, rop, process_set)[0]


def _resolve(average, op):
    if average is not None and op is not None:
        raise ValueError("The average and op arguments cannot both be set")
    return op if op is not None else (
        Average if (average is None or average) else Sum)


def allreduce(tensor, average=None, name=None, op=None,
              compression=Compression.none, prescale_factor=1.0,
              postscale_factor=1.0, process_set=None):
    """Allreduce a tf.Tensor or tf.IndexedSlices (works eagerly and
    inside ``tf.function``; sparse slices reduce via ragged allgather)."""
    rop = _resolve(average, op)
    if isinstance(tensor, tf.IndexedSlices):
        # reference parity: scale factors / compression are rejected for
        # sparse inputs, never silently dropped
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "prescale/postscale factors are not supported for "
                "tf.IndexedSlices")
        if compression is not Compression.none:
            raise ValueError(
                "compression is not supported for tf.IndexedSlices")
        return _allreduce_sparse(tensor, name or "tfsparse", rop,
                                 process_set)
    nm = name or f"tfallreduce.{tensor.shape.rank}d"
    wire_dtype = tensor.dtype
    if compression is not Compression.none and tensor.dtype in (
            tf.float32, tf.float64):
        wire = tf.cast(tensor, tf.bfloat16
                       if compression is Compression.bf16 else tf.float16)
        reduced = allreduce(wire, op=rop, name=nm,
                            prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor,
                            process_set=process_set)
        return tf.cast(reduced, wire_dtype)

    if _graph_singleproc():
        # a reduction over one rank: pure TF ops, XLA-compilable under
        # jit_compile=True
        return _scaled(_scaled(tensor, prescale_factor), postscale_factor)

    br = _bridge([tensor.dtype], process_set,
                 scales=(prescale_factor, postscale_factor))
    if br is not None:
        return _in_order(
            br.ops().horovod_torch_collective, tensor, kind="allreduce",
            tensor_name=br.sanitize_name(nm), reduce_op=rop,
            prescale=prescale_factor, postscale=postscale_factor,
            nproc=_n_workers(process_set),
            process_set_id=_psid(process_set))

    def _np_op(x):
        return to_numpy(_api.allreduce(
            to_torch(x.numpy()), name=nm, op=rop,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set))

    out = _py_op(_np_op, [tensor], tensor.dtype, "HorovodAllreduce")
    out.set_shape(tensor.shape)
    return out


def grouped_allreduce(tensors: Sequence, average=None, name=None, op=None,
                      compression=Compression.none, prescale_factor=1.0,
                      postscale_factor=1.0, process_set=None) -> List:
    """Allreduce a list of tensors as ONE atomic fusion group: one
    negotiated round and one (or few) fused dispatches instead of a
    synchronous engine round-trip per tensor (reference:
    hvd.grouped_allreduce / group_table.cc)."""
    rop = _resolve(average, op)
    nm = name or "tfgrouped"

    if compression is not Compression.none:
        wire_dt = (tf.bfloat16 if compression is Compression.bf16
                   else tf.float16)
        comp = [t.dtype in (tf.float32, tf.float64) for t in tensors]
        wires = [tf.cast(t, wire_dt) if c else t
                 for t, c in zip(tensors, comp)]
        outs = grouped_allreduce(
            wires, op=rop, name=nm, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)
        return [tf.cast(o, t.dtype) if c else o
                for o, t, c in zip(outs, tensors, comp)]

    if _graph_singleproc():
        return [_scaled(_scaled(t, prescale_factor), postscale_factor)
                for t in tensors]

    br = _bridge([t.dtype for t in tensors], process_set,
                 scales=(prescale_factor, postscale_factor))
    if br is not None and tensors:
        # one variadic op per dtype (the engine's fusion buckets are
        # per-dtype anyway — SURVEY §2.1 fusion buffer); deterministic
        # dtype order so every process negotiates the same groups
        out: List = [None] * len(tensors)
        by_dtype: dict = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype.name, []).append(i)
        for dt_name in sorted(by_dtype):
            idxs = by_dtype[dt_name]
            outs = _in_order(
                br.ops().horovod_torch_grouped_allreduce,
                [tensors[i] for i in idxs],
                tensor_name=br.sanitize_name(f"{nm}.{dt_name}"),
                reduce_op=rop, prescale=prescale_factor,
                postscale=postscale_factor,
                process_set_id=_psid(process_set))
            for i, o in zip(idxs, outs):
                out[i] = o
        return out

    def _np_op(*xs):
        outs = _api.grouped_allreduce([to_torch(x.numpy()) for x in xs],
                                      name=nm, op=rop,
                                      prescale_factor=prescale_factor,
                                      postscale_factor=postscale_factor,
                                      process_set=process_set)
        return [to_numpy(o) for o in outs]

    outs = _py_op(_np_op, list(tensors),
                  [t.dtype for t in tensors], "HorovodGroupedAllreduce")
    outs = _as_output_list(outs, len(tensors))
    for o, t in zip(outs, tensors):
        o.set_shape(t.shape)
    return outs


def _as_output_list(outs, n: int) -> List:
    """``tf.py_function`` with a single-element ``Tout`` returns a bare
    tensor, not a 1-list — zipping it against the inputs would iterate
    its ELEMENTS.  Normalize to a list of ``n`` tensors."""
    if n == 1 and not isinstance(outs, (list, tuple)):
        return [outs]
    return list(outs)


def _set_gather_shape(out, inp):
    """Gathered outputs keep the input shape with an unknown leading dim
    (the rank-count concat axis)."""
    shape = inp.shape.as_list()
    if shape:
        shape[0] = None
    out.set_shape(shape)
    return out


def grouped_allgather(tensors: Sequence, name=None,
                      process_set=None) -> List:
    """Allgather a list of tensors as one atomic fusion group
    (reference: hvd.grouped_allgather)."""
    nm = name or "tfgroupedallgather"

    if _graph_singleproc():
        return [tf.identity(t) for t in tensors]

    def _np_op(*xs):
        outs = _api.grouped_allgather([to_torch(x.numpy()) for x in xs],
                                      name=nm, process_set=process_set)
        return [to_numpy(o) for o in outs]

    outs = _py_op(_np_op, list(tensors),
                  [t.dtype for t in tensors], "HorovodGroupedAllgather")
    outs = _as_output_list(outs, len(tensors))
    return [_set_gather_shape(o, t) for o, t in zip(outs, tensors)]


def allgather(tensor, name=None, process_set=None):
    nm = name or "tfallgather"

    if _graph_singleproc():
        return tf.identity(tensor)   # an allgather of one

    # uniform shapes only via the bridge: the XLA lowering needs the
    # n*dim0 output shape statically, and no single process can verify
    # its peers' row counts at trace time.  Eager calls therefore skip
    # the bridge entirely (the engine path handles ragged Allgatherv);
    # graph-mode ragged inputs fail actionably in the dispatch.
    if not tf.executing_eagerly() and tensor.shape.rank \
            and tensor.shape[0] is not None:
        br = _bridge([tensor.dtype], process_set)
        if br is not None:
            return _in_order(
                br.ops().horovod_torch_collective, tensor, kind="allgather",
                tensor_name=br.sanitize_name(nm),
                nproc=_n_workers(process_set),
                process_set_id=_psid(process_set))

    def _np_op(x):
        return to_numpy(_api.allgather(to_torch(x.numpy()), name=nm,
                                       process_set=process_set))

    out = _py_op(_np_op, [tensor], tensor.dtype, "HorovodAllgather")
    return _set_gather_shape(out, tensor)


def _set_rs_shape(out, inp, n: int):
    """Reducescatter outputs keep the input shape with dim 0 divided by
    the rank count (unknown-rank inputs stay unknown, mirroring
    allreduce's behavior on them)."""
    if inp.shape.rank is None:
        return out
    shape = inp.shape.as_list()
    if shape:
        shape[0] = (shape[0] // n) if shape[0] is not None else None
    out.set_shape(shape)
    return out


def _rs_validate(rop, tensor, n: int):
    """Mode-independent argument validation (the engine raises the same
    errors at submission — the answer cannot depend on eager vs graph)."""
    if rop not in (Sum, Average):
        raise ValueError(
            f"reducescatter supports Sum and Average, got {rop}")
    d0 = tensor.shape[0] if tensor.shape.rank else None
    if d0 is not None and int(d0) % n:
        raise ValueError(
            f"reducescatter dim-0 {int(d0)} not divisible by {n}")


def reducescatter(tensor, op=None, name=None, process_set=None):
    """Reduce across ranks, keep this rank's dim-0 slice (reference:
    hvd.tensorflow reducescatter)."""
    rop = op if op is not None else Average
    nm = name or "tfreducescatter"
    n = _n_workers(process_set)
    _rs_validate(rop, tensor, n)

    if _graph_singleproc():
        return tf.identity(tensor)   # one rank keeps every row

    if tensor.shape.rank and tensor.shape[0] is not None:
        br = _bridge([tensor.dtype], process_set)
        if br is not None:
            return _in_order(
                br.ops().horovod_torch_collective, tensor,
                kind="reducescatter",
                tensor_name=br.sanitize_name(nm), reduce_op=rop, nproc=n,
                process_set_id=_psid(process_set))

    def _np_op(x):
        return to_numpy(_api.reducescatter(to_torch(x.numpy()), op=rop,
                                           name=nm, process_set=process_set))

    out = _py_op(_np_op, [tensor], tensor.dtype, "HorovodReducescatter")
    return _set_rs_shape(out, tensor, n)


def grouped_reducescatter(tensors: Sequence, op=None, name=None,
                          process_set=None) -> List:
    """Reducescatter a list of tensors as one atomic fusion group
    (reference: hvd.grouped_reducescatter)."""
    rop = op if op is not None else Average
    nm = name or "tfgroupedreducescatter"
    n = _n_workers(process_set)
    for t in tensors:
        _rs_validate(rop, t, n)

    if _graph_singleproc():
        return [tf.identity(t) for t in tensors]

    def _np_op(*xs):
        outs = _api.grouped_reducescatter(
            [to_torch(x.numpy()) for x in xs], op=rop, name=nm,
            process_set=process_set)
        return [to_numpy(o) for o in outs]

    outs = _py_op(_np_op, list(tensors), [t.dtype for t in tensors],
                  "HorovodGroupedReducescatter")
    outs = _as_output_list(outs, len(tensors))
    return [_set_rs_shape(o, t, n) for o, t in zip(outs, tensors)]


def broadcast(tensor, root_rank: int = 0, name=None, process_set=None):
    nm = name or "tfbroadcast"

    if _graph_singleproc():
        return tf.identity(tensor)   # the only rank is the root

    br = _bridge([tensor.dtype], process_set)
    if br is not None:
        return _in_order(
            br.ops().horovod_torch_collective, tensor, kind="broadcast",
            tensor_name=br.sanitize_name(nm),
            root_rank=root_rank, nproc=_n_workers(process_set),
            process_set_id=_psid(process_set))

    def _np_op(x):
        return to_numpy(_api.broadcast(to_torch(x.numpy()), root_rank,
                                       name=nm, process_set=process_set))

    out = _py_op(_np_op, [tensor], tensor.dtype, "HorovodBroadcast")
    out.set_shape(tensor.shape)
    return out


def alltoall(tensor, splits=None, name=None, process_set=None):
    """Rows ``splits[j]`` of ``tensor`` go to rank ``j`` (dim 0 split
    evenly without ``splits``); returns the rows this rank receives.
    ``splits`` may be a list or a tensor."""
    nm = name or "tfalltoall"

    if splits is not None and not tf.is_tensor(splits):
        sp = np.asarray(splits)
        n_ = _n_workers(process_set)
        # same validation the engine applies at dispatch (api.py), so
        # the answer cannot depend on the compilation mode
        if sp.ndim != 1 or sp.shape[0] != n_:
            raise ValueError(
                f"splits must have one entry per rank ({n_}), got "
                f"{sp.shape[0] if sp.ndim == 1 else sp.shape}")
        d0 = tensor.shape[0] if tensor.shape.rank else None
        if d0 is not None and int(sp.sum()) != int(d0):
            raise ValueError(f"splits {sp.tolist()} do not sum to dim 0 "
                             f"({int(d0)})")
    if _graph_singleproc():
        return tf.identity(tensor)   # every row to oneself

    if splits is None:
        br = _bridge([tensor.dtype], process_set)
        if br is not None:
            return _in_order(
                br.ops().horovod_torch_collective, tensor, kind="alltoall",
                tensor_name=br.sanitize_name(nm),
                nproc=_n_workers(process_set),
                process_set_id=_psid(process_set))

    def _np_op(x, *sp):
        res = _api.alltoall(
            to_torch(x.numpy()),
            splits=(np.asarray(sp[0]).tolist() if sp else splits),
            name=nm, process_set=process_set)
        return to_numpy(res)

    inputs = [tensor, splits] if tf.is_tensor(splits) else [tensor]
    out = _py_op(_np_op, inputs, tensor.dtype, "HorovodAlltoall")
    return _set_gather_shape(out, tensor)


def rank_op(name=None):
    """Graph-mode rank (reference: hvd.tensorflow rank_op)."""
    return tf.constant(rank(), name=name or "horovod_rank")


def size_op(name=None):
    return tf.constant(size(), name=name or "horovod_size")


def local_rank_op(name=None):
    return tf.constant(local_rank(), name=name or "horovod_local_rank")


def local_size_op(name=None):
    return tf.constant(local_size(), name=name or "horovod_local_size")


def join(device: int = -1) -> int:
    return _api.join(device)


def barrier(process_set=None):
    return _api.barrier(process_set)


def broadcast_object(obj, root_rank: int = 0, name=None, process_set=None):
    return _api.broadcast_object(obj, root_rank, name, process_set)


def allgather_object(obj, name=None, process_set=None):
    return _api.allgather_object(obj, name, process_set)


def broadcast_variables(variables, root_rank: int = 0, process_set=None):
    """Assign every variable its value on ``root_rank`` (reference:
    hvd.broadcast_variables — used at train start so all ranks agree)."""
    for i, v in enumerate(variables):
        name = f"bv.{getattr(v, 'name', i)}"
        v.assign(broadcast(tf.convert_to_tensor(v), root_rank, name=name,
                           process_set=process_set))


def _split_sparse(grads, sparse_as_dense: bool, compression):
    """(dense indices, dense gradients, sparse indices, sparse slices) of
    ``grads``, Nones skipped; ``sparse_as_dense`` densifies the slices."""
    dense_idx, dense, sparse_idx, sparse_sl = [], [], [], []
    for i, g in enumerate(grads):
        if g is None:
            continue
        if isinstance(g, tf.IndexedSlices):
            if sparse_as_dense:
                g = tf.convert_to_tensor(g)  # densify (reference knob)
            elif compression is not Compression.none:
                raise ValueError(
                    "compression is not supported for sparse gradients; "
                    "pass sparse_as_dense=True to densify them")
            else:
                sparse_idx.append(i)
                sparse_sl.append(g)
                continue
        dense_idx.append(i)
        dense.append(g)
    return dense_idx, dense, sparse_idx, sparse_sl


_BPPS_SPARSE = ("backward_passes_per_step > 1 accumulates gradients "
                "densely; pass sparse_as_dense=True to accept the dense "
                "materialization of sparse gradients")


class DistributedGradientTape:
    """Gradient tape wrapper whose ``gradient()`` allreduces each gradient.

    Reference: ``hvd.DistributedGradientTape(tape)`` (SURVEY §3.3 TF
    analog) — wraps an existing ``tf.GradientTape``; every other method
    delegates to it.  ``backward_passes_per_step > 1`` accumulates
    locally and reduces every N-th call (gradients summed over passes,
    averaged over ranks).
    """

    def __init__(self, tape: Optional[tf.GradientTape] = None,
                 compression=Compression.none, op=Average,
                 gradient_predivide_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 persistent: bool = False, sparse_as_dense: bool = False,
                 process_set=None):
        self._wrapped = tape if tape is not None else tf.GradientTape(
            persistent=persistent)
        self._compression = compression
        self._op = op
        self._sparse_as_dense = bool(sparse_as_dense)
        if gradient_predivide_factor != 1.0 and op != Average:
            raise ValueError(
                "gradient_predivide_factor requires op == Average")
        self._prescale = (1.0 / gradient_predivide_factor
                          if gradient_predivide_factor != 1.0 else 1.0)
        self._postscale = gradient_predivide_factor
        self._bpps = int(backward_passes_per_step)
        self._pass = 0
        self._acc: Optional[List] = None
        self._process_set = process_set

    def __getattr__(self, name):
        return getattr(self._wrapped, name)

    def __enter__(self):
        self._wrapped.__enter__()
        return self

    def __exit__(self, *exc):
        return self._wrapped.__exit__(*exc)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._wrapped.gradient(target, sources, output_gradients)
        self._pass += 1
        if self._bpps > 1:
            if not self._sparse_as_dense and any(
                    isinstance(g, tf.IndexedSlices) for g in grads):
                raise ValueError(_BPPS_SPARSE)
            if self._acc is None:
                self._acc = [tf.zeros_like(g) if g is not None else None
                             for g in grads]
            self._acc = [a + g if g is not None else a
                         for a, g in zip(self._acc, grads)]
            if self._pass % self._bpps != 0:
                return [None if g is None else tf.zeros_like(g)
                        for g in grads]
            grads, self._acc = self._acc, None
        # ONE grouped submission for every dense gradient: a single
        # negotiated round + fused dispatch instead of a synchronous
        # engine round-trip per gradient
        dense_idx, dense, sparse_idx, sparse_sl = _split_sparse(
            grads, self._sparse_as_dense, self._compression)
        out: List = [None] * len(grads)
        if sparse_sl:  # ONE ragged-gather round for all sparse grads
            for i, r in zip(sparse_idx, _allreduce_sparse_many(
                    sparse_sl, "tape.sparse", self._op,
                    self._process_set)):
                out[i] = r
        reduced = grouped_allreduce(
            dense, op=self._op, name="tape.grads",
            compression=self._compression,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale,
            process_set=self._process_set) if dense else []
        for i, r in zip(dense_idx, reduced):
            out[i] = r
        return out


def _var_key(v):
    """A hashable key of a variable: ``tf.Variable.ref()``; a Keras 3
    variable has no ``ref``, and its identity serves."""
    return v.ref() if hasattr(v, "ref") else id(v)


def DistributedOptimizer(optimizer, name=None,
                         compression=Compression.none, op=Average,
                         backward_passes_per_step: int = 1,
                         sparse_as_dense: bool = False,
                         process_set=None):
    """Wrap a ``keras.optimizers.Optimizer``: gradients are allreduced
    before being applied (reference: hvd.DistributedOptimizer for TF2 —
    an ``apply_gradients`` interceptor)."""
    base = optimizer.__class__

    class _Dist(base):  # noqa: D401 - dynamic wrapper
        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            gv = list(grads_and_vars)
            if backward_passes_per_step > 1:
                return self._hvd_accumulate_apply(gv, args, kwargs)
            # one grouped round for all dense gradients (see
            # DistributedGradientTape.gradient)
            dense_idx, dense, sparse_idx, sparse_sl = _split_sparse(
                [g for g, _v in gv], sparse_as_dense, compression)
            reduced = list(gv)
            if sparse_sl:  # one ragged-gather round for all sparse
                for i, r in zip(sparse_idx, _allreduce_sparse_many(
                        sparse_sl, "opt.sparse", op, process_set)):
                    reduced[i] = (r, gv[i][1])
            outs = grouped_allreduce(
                dense, op=op, name="opt.grads", compression=compression,
                process_set=process_set) if dense else []
            for i, r in zip(dense_idx, outs):
                reduced[i] = (r, reduced[i][1])
            return base.apply_gradients(self, reduced, *args, **kwargs)

        def _hvd_accumulate_apply(self, gv, args, kwargs):
            """Local gradient accumulation: reduce + apply every N-th
            call (reference: backward_passes_per_step via the TF
            LocalGradientAggregationHelper — variable-backed counter and
            accumulators so keras's tf.function-compiled train steps
            count correctly)."""
            if not sparse_as_dense and any(
                    isinstance(g, tf.IndexedSlices)
                    for g, _v in gv if g is not None):
                raise ValueError(_BPPS_SPARSE)
            gv = [(tf.convert_to_tensor(g)
                   if isinstance(g, tf.IndexedSlices) else g, v)
                  for g, v in gv]
            if not hasattr(self, "_hvd_bpps_counter"):
                self._hvd_bpps_counter = tf.Variable(
                    0, trainable=False, dtype=tf.int64,
                    name="hvd_bpps_counter")
                self._hvd_bpps_acc = {}
            idxs = [i for i, (g, _v) in enumerate(gv) if g is not None]
            for i in idxs:
                # keyed by VARIABLE, not position: one optimizer may
                # serve several apply_gradients call shapes (GAN nets,
                # freeze schedules) — upstream's aggregation helper
                # keys by variable for the same reason
                key = _var_key(gv[i][1])
                if key not in self._hvd_bpps_acc:
                    self._hvd_bpps_acc[key] = tf.Variable(
                        tf.zeros_like(gv[i][0]), trainable=False,
                        name=f"hvd_bpps_acc_{len(self._hvd_bpps_acc)}")
                self._hvd_bpps_acc[key].assign_add(gv[i][0])
            self._hvd_bpps_counter.assign_add(1)

            def _apply():
                accs = [self._hvd_bpps_acc[_var_key(gv[i][1])]
                        for i in idxs]
                outs = grouped_allreduce(
                    [a.value() for a in accs],
                    op=op, name="opt.acc.grads", compression=compression,
                    process_set=process_set) if idxs else []
                reduced = [(o, gv[i][1]) for o, i in zip(outs, idxs)]
                base.apply_gradients(self, reduced, *args, **kwargs)
                for a in accs:
                    a.assign(tf.zeros_like(a))
                return tf.constant(True)

            return tf.cond(
                tf.equal(self._hvd_bpps_counter % backward_passes_per_step,
                         0),
                _apply, lambda: tf.constant(False))

    _Dist.__name__ = base.__name__
    optimizer.__class__ = _Dist
    return optimizer


from . import elastic  # noqa: E402,F401 - hvd.elastic namespace

__all__ += ["elastic"]


# Load the op bridge BEFORE the first TF op executes: TF materializes
# its XLA compilation-kernel registry once, and op libraries loaded
# after that point lose their XlaOpKernel registrations (jit_compile
# would then fail with "no registered kernel ... compatible"; the
# reference loaded mpi_lib at import for the same reason).  Only a world
# of more than one rank needs it (HOROVOD_SIZE, or the launcher's
# HOROVOD_NUM_PROCESSES); a failure is kept for the agreement round,
# where every member raises it.
if _xla_bridge.enabled() and (
        os.environ.get("HOROVOD_NUM_PROCESSES", "1") not in ("", "1") or
        os.environ.get("HOROVOD_SIZE", "1") not in ("", "1")):
    _xla_bridge.status()
