"""The distributed optimizer: planned gradient buckets, ZeRO tiles, the
quantized wire with error feedback, accumulation and overlapped dispatch.

Counterpart: ``horovod_tpu/optim/distributed.py`` (after
``horovod/torch/optimizer.py``).  The JAX package reduces a gradient pytree
inside its compiled step: the leaves, sorted by path, are planned into
buckets by the engine's own ``plan_fusion`` and each bucket is reduced with
one collective.  Here the same plan runs eagerly: :func:`fused_reduce_tree`
and :func:`fused_reduce_scatter_tree` issue one ``torch.distributed``
collective a bucket (``ops/collectives.py``) on the process set's group, in
plan order, from the caller's thread.  Like the JAX in-jit path they do not
negotiate: every rank runs the same plan in the same order.

:func:`DistributedGradientTransform` is the optax transformation's
counterpart.  It takes the factory of the inner optimizer (called with the
tensors it updates, like ``make_llama_train_step``'s ``optimizer``);
``init(params)`` builds a :class:`_DistState` and ``update(grads, state,
params)`` reduces the gradients and runs the inner optimizer, which updates
the parameters in place (the JAX transform returns updates instead).  Its
options:

* ``sharded_update`` (``HOROVOD_SHARDED_UPDATE``; ZeRO, arXiv:2004.13336):
  each bucket is reduce-scattered, the inner optimizer and its state live
  on this rank's 1/N flat tiles of the parameters, and the updated tiles
  are all-gathered back into the parameters.
* ``wire_format`` (``HOROVOD_COMPRESSION``, ``HOROVOD_COMPRESSION_BLOCK_SIZE``):
  block-scaled int8/fp8 buckets with this rank's quantization error
  carried in ``_DistState.residual`` and added back before the next
  quantization.
* ``backward_passes_per_step``: gradients accumulate locally and the
  reduction and update run on every k-th call.
* ``overlap`` (``HOROVOD_OVERLAP``): the layer-aware plan of
  ``optim/overlap.py``, whose buckets the model's grad taps dispatch during
  the backward pass.

:func:`DistributedOptimizer` wraps a ``torch.optim`` optimizer the
reference's way (per-parameter hooks, ``synchronize()``, ``step()``); its
buckets come from the transform's plan.

``op=Adasum`` combines the whole gradient vector at once, the leaves in
``(dtype, index)`` order (JAX ``fused_reduce_tree``'s Adasum branch), not
one bucket at a time: per-bucket Adasum is another function.  Under
``HOROVOD_HIERARCHICAL_ALLREDUCE``, on a process set with a hierarchy,
each full-width bucket of :func:`fused_reduce_tree` is reduced in three
stages with ``HOROVOD_TAIL_POLICY`` on the cross stage and its own stale
state (``ops/collectives.hierarchical_allreduce``; JAX
``fused_tail_reduce_tree``).

``recovery`` (checkpointless recovery, ``elastic/recovery.py``): after
the update of every ``recovery.every``-th accumulation boundary the
transform hands the boundary ordinal, this rank and
:func:`recovery_payload` of its state (the inner optimizer's state, the
error-feedback residual and ``count``) to
``elastic.recovery.deliver_boundary`` (JAX: an in-jit tap through
``jax.debug.callback``); off-cadence boundaries copy nothing to the host.
A replacement worker installs the pulled frame into a fresh ``init``
with :func:`restore_dist_state`.

``param_specs`` (the spec plan, :class:`SpecPlan`; JAX's mesh-axis-aware
plane): over a ``parallel.mesh.ParallelMesh`` the gradient plane factors
into the data axis (the mesh's ``dp``) times the model axes
(``model_axes``; default: the axes the specs name plus
``HOROVOD_MODEL_AXES``).  Each leaf's canonical spec rides its
``EntrySig``, so differently sharded leaves never share a bucket, and a
bucket sums over each axis of (data + model axes) minus its spec's axes,
one collective over that axis's group of the mesh; ``op=Average`` divides
by the product of all those axes' sizes (the batch is taken to be sharded
over all of them).  The contract, JAX's: a leaf's gradient arrives summed
over its spec's axes and partial over the rest.  Under ``sharded_update``
the ZeRO tiles run over the data axis within each model-shard group; with
a wire format only the data-axis hop quantizes.

``health`` (``HOROVOD_HEALTH_TAPS``, vetoed by ``HOROVOD_HEALTH=0``; the
training-health plane, ``health/``): each bucket's LOCAL flat gradient
is tapped (l2, max-abs, nonfinite count) before its collective is
issued, the error-feedback residual's norm under a wire format, the
substitution counters of a stale tail bucket; the stats stay on the
device and reach the host evaluator in one copy an update.  Every
``health_check_every``-th update the divergence sentinel checksums the
parameter buckets (before the update, which is in place here) and the
optimizer state, allgathers them over the process set and convicts a
replica whose checksums disagree.  It refuses ``overlap`` and
``param_specs``, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from contextlib import contextmanager
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import api, runtime
from .. import tracing as _tracing
from ..analysis import recorder as _rec
from ..compression import Compression, quantizable, resolve_wire_format
from ..ops import collectives
from ..ops.fusion import (BucketLayout, EntrySig, canonicalize_spec,
                          dtype_name, plan_bucket_layouts, plan_fusion,
                          spec_axes)
from ..runtime import Average, ReduceOp
from ..tree import tree_leaves, tree_map, tree_paths


# ---------------------------------------------------------------------------
# trees, plans and flat buffers
# ---------------------------------------------------------------------------

def _tree_leaves_sorted(tree):
    """Leaves in path-sorted order (the controller's total order on tensor
    names): ``(leaves, names, order)``, ``order[pos]`` being the
    :func:`tree_leaves` index of the ``pos``-th sorted leaf."""
    leaves, names = tree_leaves(tree), tree_paths(tree)
    order = sorted(range(len(leaves)), key=names.__getitem__)
    return [leaves[i] for i in order], [names[i] for i in order], order


def _restore_order(sorted_leaves, order):
    out = [None] * len(order)
    for pos, i in enumerate(order):
        out[i] = sorted_leaves[pos]
    return out


def _unflatten(layout, sorted_leaves):
    """A tree shaped like ``layout.skeleton`` from path-sorted leaves."""
    it = iter(_restore_order(sorted_leaves, layout.order))
    return tree_map(lambda _: next(it), layout.skeleton)


def _resolve_threshold(threshold_bytes: Optional[int]) -> int:
    if threshold_bytes is not None:
        return threshold_bytes
    cfg = runtime._state().config
    return (cfg.fusion_threshold_bytes if cfg is not None
            else 64 * 1024 * 1024)


def _plan_buckets(leaves, names, op, prescale_factor, postscale_factor,
                  threshold_bytes, wire_format: str = "none", specs=None):
    """Leaves become EntrySigs named by their sorted paths (with their
    canonical ``specs`` under a spec plan), and the engine's
    ``plan_fusion`` decides the buckets: the plan every rank computes."""
    sigs = [EntrySig(name=names[i], op_type="allreduce", reduce_op=str(op),
                     dtype=dtype_name(leaves[i].dtype),
                     shape=tuple(leaves[i].shape), process_set_id=0,
                     stacked=False, prescale=prescale_factor,
                     postscale=postscale_factor,
                     wire_format=(wire_format if quantizable(leaves[i].dtype)
                                  else "none"),
                     spec=specs[i] if specs is not None else "replicated")
            for i in range(len(leaves))]
    return plan_fusion(sigs, threshold_bytes), sigs


def _bucket_flat(parts: Sequence[torch.Tensor], padded_numel: int,
                 pad: bool = True) -> torch.Tensor:
    """A bucket's leaves as one flat buffer, zero-padded to
    ``padded_numel``: a view of the leaf itself when the bucket is one
    contiguous leaf needing no padding, else a new buffer."""
    numel = sum(p.numel() for p in parts)
    if len(parts) == 1 and parts[0].is_contiguous() \
            and (numel == padded_numel or not pad):
        return parts[0].view(-1)
    flat = [p.reshape(-1) for p in parts]
    if pad and padded_numel > numel:
        flat.append(parts[0].new_zeros(padded_numel - numel))
    return torch.cat(flat)


def _split_into(buf: torch.Tensor, parts: Sequence[torch.Tensor]) -> None:
    """Copy ``buf``'s leading elements into ``parts`` in order (nothing to
    copy when ``buf`` is a view of the only part)."""
    if len(parts) == 1 and buf.data_ptr() == parts[0].data_ptr() \
            and buf.dtype == parts[0].dtype:
        return
    off = 0
    for p in parts:
        p.copy_(buf[off:off + p.numel()].view(p.shape))
        off += p.numel()


@torch.no_grad()
def _tile_of(parts: Sequence[torch.Tensor], bl: BucketLayout,
             rank: int) -> torch.Tensor:
    """A copy of elements ``[rank·shard, (rank+1)·shard)`` of the bucket's
    padded flat buffer, read from the leaves without building it."""
    lo, hi = rank * bl.shard_numel, (rank + 1) * bl.shard_numel
    out = parts[0].new_zeros(bl.shard_numel)
    off = 0
    for p, sz in zip(parts, bl.sizes):
        a, b = max(lo, off), min(hi, off + sz)
        if a < b:
            out[a - lo:b - lo] = p.reshape(-1)[a - off:b - off]
        off += sz
    return out


def _allreduce_flat_(buf: torch.Tensor, ps, op: str, prescale: float,
                     postscale: float, compression=Compression.none) -> None:
    """In place: ``buf`` × prescale, summed over ``ps`` (through the cast
    compressor, if any), divided by the set's size for Average, ×
    postscale (JAX ``fused_reduce_tree``'s full-width bucket)."""
    if prescale != 1.0:
        collectives._scale_(buf, prescale)
    wire, ctx = compression.compress(buf)
    if _rec.ARMED:
        _rec.reduce("sum", ps, wire)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=collectives._group(ps))
    if wire is not buf:
        buf.copy_(compression.decompress(wire, ctx))
    if op == ReduceOp.AVERAGE and ps.size() > 1:   # x / 1 is x
        collectives._average_(buf, ps.size())
    if postscale != 1.0:
        collectives._scale_(buf, postscale)


def _check_wire(fmt, compression, op):
    if fmt is None:
        return
    if compression not in (None, Compression.none):
        raise ValueError(
            "wire_format and compression are two definitions of the same "
            "wire: pick the block-scaled quantized format OR the cast "
            "compressor, not both")
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"wire_format quantization supports op=Average/Sum, got "
            f"{op!r}: Adasum operates on exact local gradients and "
            f"min/max are not expressible as a quantize-accumulate "
            f"staging")


def _check_adasum(fmt, compression):
    """JAX ``fused_reduce_tree``'s refusals of Adasum's wire."""
    if fmt is not None:
        raise ValueError(
            "wire_format quantization is not supported with "
            "op=Adasum: the recursive pairwise dot products operate "
            "on the exact local gradients and are not expressible as "
            "a quantize-exchange-accumulate staging — use "
            "op=Average/Sum with a wire format, or Adasum full-width")
    if compression not in (None, Compression.none):
        raise ValueError(
            "compression is not supported with op=Adasum: the "
            "recursive pairwise dot products operate on the exact "
            "local gradients, and silently skipping the compressor "
            "would diverge from the psum path's wire format — use "
            "op=Average/Sum with compression, or Adasum uncompressed")


@torch.no_grad()
def _adasum_tree_(leaves, ps, prescale_factor, postscale_factor) -> None:
    """In place: the Adasum of the whole gradient vector, the leaves in
    ``(dtype, index)`` order, concatenated (promoted to a common dtype),
    combined over ``ps`` and written back (JAX ``fused_reduce_tree``'s
    Adasum branch)."""
    from ..ops.adasum import adasum_flat
    dorder = sorted(range(len(leaves)),
                    key=lambda i: (dtype_name(leaves[i].dtype), i))
    flat = torch.cat([leaves[i].reshape(-1) for i in dorder])
    if prescale_factor != 1.0:
        flat = flat * prescale_factor
    red = adasum_flat(flat, ps)
    if postscale_factor != 1.0:
        red = red * postscale_factor
    off = 0
    for i in dorder:
        sz = leaves[i].numel()
        leaves[i].copy_(red[off:off + sz].view(leaves[i].shape))
        off += sz


def _hier_tail(ps, op, compression) -> Optional[str]:
    """The tail policy of the hierarchical bucket reduce, or None for the
    flat one: HOROVOD_HIERARCHICAL_ALLREDUCE on a set with a hierarchy,
    for a Sum or Average without the cast compressor."""
    cfg = _config()
    if (cfg is None or not cfg.hierarchical_allreduce or ps.size() <= 1
            or ps.hier_shape() is None
            or op not in (ReduceOp.SUM, ReduceOp.AVERAGE)
            or compression not in (None, Compression.none)):
        return None
    return cfg.tail_policy


def _residual_leaves(residual, leaves):
    """Path-sorted fp32 error-feedback leaves aligned with ``leaves``
    (None: zeros, no error carried yet)."""
    if residual is None:
        return [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                for x in leaves]
    r_leaves = _tree_leaves_sorted(residual)[0]
    if len(r_leaves) != len(leaves):
        raise ValueError(
            f"error-feedback residual tree has {len(r_leaves)} leaves for "
            f"{len(leaves)} gradient leaves: carry the residual from the "
            f"previous step's return on the same tree")
    return r_leaves


# ---------------------------------------------------------------------------
# the spec plan: buckets over the axes of a ParallelMesh
# ---------------------------------------------------------------------------

def _axis_group(mesh, axis: str):
    """``axis``'s group of ``mesh`` (a ``runtime.SubGroup``); for an axis
    of size 1, this rank alone, over which the flat collectives are the
    identity."""
    g = mesh.group(axis)
    return (g if g is not None
            else runtime.SubGroup([runtime._state().rank], None))


class SpecPlan(NamedTuple):
    """The mesh-axis plan of one spec-aware transform (JAX ``SpecPlan``).

    ``by_name`` maps a leaf's dotted path (``tree.tree_paths``) to its
    canonical spec (``ops.fusion.canonicalize_spec``); ``model_axes`` are
    the parameter-sharding axes beside ``data_axis``; ``mesh`` is the
    ``ParallelMesh`` whose groups the buckets reduce over.  The contract:
    a leaf's gradient arrives summed over every axis its spec shards over
    and partial over the rest, so a bucket sums over ``(data_axis,) +
    model_axes`` minus its spec's axes, and an ``op=Average`` divides by
    the product of all their sizes (:meth:`global_size`)."""
    by_name: Any
    model_axes: Tuple[str, ...]
    data_axis: str
    mesh: Any = None

    def specs_for(self, names):
        """The canonical spec of each (path-sorted) gradient leaf."""
        out = []
        for n in names:
            spec = self.by_name.get(n)
            if spec is None:
                raise ValueError(
                    f"param_specs has no entry for gradient leaf {n}: the "
                    f"spec tree must be congruent with the gradient and "
                    f"parameter tree (every leaf needs a spec, () for a "
                    f"replicated one)")
            out.append(spec)
        return out

    def _resolve(self, axis: str) -> str:
        """The mesh axis ``axis`` names (``ep`` aliased onto dp names
        dp)."""
        return self.mesh._resolve(axis) if self.mesh is not None else axis

    def shard_axes(self, spec: str) -> set:
        """The mesh axes a leaf with canonical ``spec`` is sharded over."""
        return {self._resolve(a) for a in spec_axes(spec)}

    def reduce_axes(self, spec: str) -> Tuple[str, ...]:
        """The axes a bucket with canonical ``spec`` sums over."""
        shard = self.shard_axes(spec)
        return tuple(a for a in (self.data_axis,) + self.model_axes
                     if a not in shard)

    def check(self, sharded: bool, fmt) -> None:
        """Refuse what the plan cannot run: under ``sharded`` (ZeRO) a
        leaf sharded over the data axis, whose gradient arrives reduced
        and sharded, leaving no axis to tile over; with a wire format
        ``fmt``, a data axis of size 1 (only the data hop quantizes)."""
        if sharded:
            for nm, spec in sorted(self.by_name.items()):
                if self.data_axis in self.shard_axes(spec):
                    raise ValueError(
                        f"sharded_update with param_specs: leaf {nm} is "
                        f"sharded over the data axis {self.data_axis!r} "
                        f"itself; its gradient arrives fully reduced and "
                        f"sharded, leaving no axis to ZeRO-tile over; use "
                        f"sharded_update=False for spec trees naming the "
                        f"data axis")
        if fmt is not None and self.mesh is not None \
                and self.mesh.axis_size(self.data_axis) == 1:
            raise ValueError(
                f"wire_format with param_specs quantizes the data axis "
                f"{self.data_axis!r}, which has size 1 on this mesh")

    def global_size(self) -> int:
        """The global batch degree: the product of the mesh's sizes of
        the data axis and the model axes."""
        if self.mesh is None:
            raise ValueError("SpecPlan.global_size needs the ParallelMesh "
                             "(make_spec_plan(..., mesh=pmesh))")
        n = 1
        for a in (self.data_axis,) + self.model_axes:
            n *= self.mesh.axis_size(a)
        return n

    def sum_over(self, buf: torch.Tensor, axes) -> torch.Tensor:
        """``buf`` summed over each of ``axes`` in turn, one all-reduce
        over the axis's group of the mesh (counted in
        ``parallel.axis.BYTES``); an axis of size 1 is the identity."""
        from ..parallel import axis as ax
        for a in axes:
            g = self.mesh.group(a)
            if g is not None:
                buf = ax._all_reduce(buf, g, a)
        return buf


def _spec_items(tree, prefix: str = ""):
    """``(dotted path, spec)`` of every leaf of a spec tree, in
    ``tree.tree_paths`` order: dicts and lists are nodes, and a spec (a
    tuple of per-dim entries, None or a string) is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [x for k, v in items
            for x in _spec_items(v, f"{prefix}.{k}" if prefix else str(k))]


def make_spec_plan(param_specs, data_axis: str = "dp", model_axes=None,
                   mesh=None) -> SpecPlan:
    """A :class:`SpecPlan` from a spec tree congruent with the parameters
    (``models.llama.param_specs``' per-dim tuples; JAX
    ``make_spec_plan``).

    ``model_axes`` defaults to the axes the specs name plus the validated
    ``HOROVOD_MODEL_AXES`` (the runtime's config, else the environment),
    sorted by name, without the data axis.  A spec may name the data axis
    (an FSDP leaf arrives fully reduced, its bucket runs no collective);
    ``model_axes`` may not.  ``mesh`` resolves the axes to groups and
    sizes, and an alias of the data axis (``ep`` on a mesh without one)
    to the data axis.

    The contract counts every rank of the model axes as a batch shard.
    A tp axis is not one (its ranks share one loss, and every leaf's
    gradient arrives complete): pass ``model_axes=()`` for the Llama, so
    that every bucket sums over the data axis alone."""
    resolve = mesh._resolve if mesh is not None else (lambda a: a)
    by_name = {path: canonicalize_spec(spec)
               for path, spec in _spec_items(param_specs)}
    if model_axes is None:
        axes = set()
        for spec in by_name.values():
            axes.update(spec_axes(spec))
        cfg = _config()
        cfg_axes = (cfg.model_axes if cfg is not None
                    else os.environ.get("HOROVOD_MODEL_AXES", ""))
        axes.update(a.strip() for a in cfg_axes.split(",") if a.strip())
        model_axes = tuple(sorted(a for a in axes
                                  if resolve(a) != resolve(data_axis)))
    else:
        model_axes = tuple(model_axes)
        if any(resolve(a) == resolve(data_axis) for a in model_axes):
            raise ValueError(
                f"model_axes {model_axes} must not contain the data axis "
                f"{data_axis!r}: the data axis is the one the transform "
                f"itself reduces over")
    if mesh is not None:
        unknown = [a for a in (data_axis,) + model_axes
                   if resolve(a) not in mesh.axis_names]
        if unknown:
            raise ValueError(
                f"axes {unknown} are not axes of the mesh "
                f"{mesh.axis_names}: the spec plan reduces over the "
                f"mesh's groups")
    return SpecPlan(by_name=by_name, model_axes=model_axes,
                    data_axis=data_axis, mesh=mesh)


# ---------------------------------------------------------------------------
# replicated buckets
# ---------------------------------------------------------------------------

def _tap_bucket(buf: torch.Tensor, ps, bucket_id: int, name: str,
                health) -> torch.Tensor:
    """A bucket's local buffer before its collective: corrupted at the
    ``collective.corrupt`` chaos site when a rule targets this rank (a
    new buffer, so the leaves keep their values until the reduced ones
    land), then tapped by ``health``."""
    from .. import chaos as _chaos
    if _chaos.ACTIVE:
        from ..health.taps import chaos_corrupt
        buf = chaos_corrupt(buf, ps.rank(), bucket_id, name)
    if health is not None:
        health.observe_bucket(bucket_id, name, buf)
    return buf


def fused_reduce_tree(grads, process_set=None, op: str = ReduceOp.AVERAGE,
                      threshold_bytes: Optional[int] = None,
                      compression=Compression.none,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      wire_format=None, residual=None, spec_plan=None,
                      health=None):
    """Reduce a gradient tree over the process set, one collective a
    planned bucket, in place: returns ``grads`` with every leaf reduced.

    ``wire_format`` quantizes each bucket of float leaves
    (``ops.collectives.quantized_allreduce``) with error feedback:
    ``residual`` is the grads-shaped fp32 tree of this rank's carried
    error (None = zeros) and the return becomes ``(grads,
    new_residual)``; buckets of other dtypes carry their residual
    unchanged.  ``op=Adasum`` combines the whole vector, refusing a wire
    format or a compressor; the full-width buckets of a Sum or Average
    take the hierarchical path under HOROVOD_HIERARCHICAL_ALLREDUCE.

    ``spec_plan`` (a :class:`SpecPlan`) reduces over its mesh's axis
    groups instead of ``process_set``: each bucket sums over the data and
    model axes its spec does not shard over, and Average divides by the
    global batch degree; with a wire format only the data-axis hop
    quantizes, a replicated bucket's model hops running full-width first.

    ``health`` (a ``health.taps.HealthTaps``) taps each bucket's local
    buffer before its collective (and the ``collective.corrupt`` chaos
    site corrupts it there), the new residual under a wire format, and a
    stale tail bucket's substitution counters; not with ``spec_plan`` or
    Adasum.
    """
    fmt = resolve_wire_format(wire_format)
    leaves, names, order = _tree_leaves_sorted(grads)
    if not leaves:
        return grads if fmt is None else (grads, residual)
    if spec_plan is not None:
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            raise ValueError(
                f"spec-aware reduction (param_specs) supports op=Average/"
                f"Sum, got {op!r}: the per-bucket axis-set factoring relies "
                f"on sum linearity")
        _check_wire(fmt, compression, op)
        spec_plan.check(False, fmt)
        return _spec_reduce_tree(grads, leaves, names, order, spec_plan, op,
                                 _resolve_threshold(threshold_bytes),
                                 compression, prescale_factor,
                                 postscale_factor, fmt, residual)
    ps = api._ps(process_set)
    if op == ReduceOp.ADASUM:
        _check_adasum(fmt, compression)
        _adasum_tree_(leaves, ps, prescale_factor, postscale_factor)
        return grads
    _check_wire(fmt, compression, op)
    tail = _hier_tail(ps, op, compression)
    buckets, sigs = _plan_buckets(leaves, names, op, prescale_factor,
                                  postscale_factor,
                                  _resolve_threshold(threshold_bytes),
                                  wire_format=fmt.name if fmt else "none")
    res = _residual_leaves(residual, leaves) if fmt is not None else None
    for bucket_id, bucket in enumerate(buckets):
        if _rec.ARMED:
            _rec.set_bucket(bucket_id)
        parts = [leaves[i] for i in bucket]
        numel = sum(p.numel() for p in parts)
        buf = _tap_bucket(_bucket_flat(parts, numel), ps, bucket_id,
                          names[bucket[0]], health)
        if fmt is not None and sigs[bucket[0]].wire_format != "none":
            if prescale_factor != 1.0:
                buf = buf * torch.tensor(prescale_factor).to(buf.dtype)
            red, nres = collectives.quantized_allreduce(
                buf, ps, fmt, op=op, error_feedback=True,
                residual=_bucket_flat([res[i] for i in bucket], numel))
            if health is not None:
                health.observe_residual(bucket_id, nres)
            if postscale_factor != 1.0:
                collectives._scale_(red, postscale_factor)
            _split_into(red, parts)
            for i, piece in zip(bucket, nres.split(
                    [leaves[i].numel() for i in bucket])):
                res[i] = piece.view(leaves[i].shape)
        elif tail is not None:
            if prescale_factor != 1.0:
                collectives._scale_(buf, prescale_factor)
            hook = None
            if health is not None and tail == "stale":
                def hook(counters, cap, _b=bucket_id,
                         _n=names[bucket[0]]):
                    health.observe_staleness(_b, _n, counters, cap)
            red = collectives.hierarchical_allreduce(
                buf, ps, op, tail_policy=tail,
                tail_names=tuple(names[i] for i in bucket),
                staleness_hook=hook)
            if postscale_factor != 1.0:
                collectives._scale_(red, postscale_factor)
            _split_into(red, parts)
        else:
            _allreduce_flat_(buf, ps, op, prescale_factor, postscale_factor,
                             compression)
            _split_into(buf, parts)
    if _rec.ARMED:
        _rec.set_bucket(None)
    if fmt is None:
        return grads
    it = iter(_restore_order(res, order))
    return grads, tree_map(lambda _: next(it), grads)


@torch.no_grad()
def _spec_reduce_tree(grads, leaves, names, order, sp: SpecPlan, op,
                      threshold, compression, prescale, postscale, fmt,
                      residual):
    """:func:`fused_reduce_tree` under a spec plan (JAX's spec branch)."""
    buckets, sigs = _plan_buckets(leaves, names, op, prescale, postscale,
                                  threshold,
                                  wire_format=fmt.name if fmt else "none",
                                  specs=sp.specs_for(names))
    global_n = sp.global_size()
    data = sp.data_axis
    res = _residual_leaves(residual, leaves) if fmt is not None else None
    for bucket_id, bucket in enumerate(buckets):
        if _rec.ARMED:
            _rec.set_bucket(bucket_id)
        parts = [leaves[i] for i in bucket]
        numel = sum(p.numel() for p in parts)
        buf = _bucket_flat(parts, numel)
        if prescale != 1.0:
            buf = buf * torch.tensor(prescale).to(buf.dtype)
        r_axes = sp.reduce_axes(sigs[bucket[0]].spec)
        if fmt is not None and sigs[bucket[0]].wire_format != "none" \
                and data in r_axes:
            # the model hops run full-width (the replicated buckets hold
            # the small leaves); only the data hop quantizes
            buf = sp.sum_over(buf, [a for a in r_axes if a != data])
            from ..parallel import axis as ax
            ax._count(data, "all_reduce", buf)
            red, nres = collectives.quantized_allreduce(
                buf, sp.mesh.group(data), fmt, op=op, error_feedback=True,
                residual=_bucket_flat([res[i] for i in bucket], numel),
                denom=global_n)
            for i, piece in zip(bucket, nres.split(
                    [leaves[i].numel() for i in bucket])):
                res[i] = piece.view(leaves[i].shape)
        else:
            wire, ctx = compression.compress(buf)
            red = compression.decompress(sp.sum_over(wire, r_axes), ctx)
            if op == ReduceOp.AVERAGE:
                # a bucket sharded over every axis (an FSDP leaf over the
                # data axis) ran no collective: only the division applies
                red = red / global_n
        if postscale != 1.0:
            collectives._scale_(red, postscale)
        _split_into(red, parts)
    if _rec.ARMED:
        _rec.set_bucket(None)
    if fmt is None:
        return grads
    it = iter(_restore_order(res, order))
    return grads, tree_map(lambda _: next(it), grads)


# ---------------------------------------------------------------------------
# ZeRO: reduce-scattered buckets and tiles
# ---------------------------------------------------------------------------

class ShardedLayout(NamedTuple):
    """Slice metadata of reduce-scattered buckets: the tree's structure,
    the path-sort permutation, the sorted leaves' shapes, and each planned
    bucket's padded flat layout (``ops.fusion.BucketLayout``)."""
    skeleton: Any
    order: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    buckets: Tuple[BucketLayout, ...]

    def fingerprint(self) -> Tuple:
        return (self.shapes, self.buckets)


def _sharded_layout(tree, shards: int, op, prescale_factor,
                    postscale_factor, threshold_bytes, align: int = 1,
                    spec_plan=None):
    """The ``plan_fusion`` buckets of ``tree``, each padded to a multiple
    of ``shards`` (times ``align``: a quantized wire needs block-aligned
    tiles); under a ``spec_plan`` keyed by spec too, each bucket the local
    model shard's, tiled over the data axis.  Returns ``(sorted_leaves,
    sorted_names, layout)``."""
    leaves, names, order = _tree_leaves_sorted(tree)
    buckets, sigs = _plan_buckets(
        leaves, names, op, prescale_factor, postscale_factor,
        threshold_bytes,
        specs=spec_plan.specs_for(names) if spec_plan is not None else None)
    return leaves, names, ShardedLayout(
        skeleton=tree_map(lambda _: None, tree), order=tuple(order),
        shapes=tuple(tuple(x.shape) for x in leaves),
        buckets=tuple(plan_bucket_layouts(sigs, buckets, shards,
                                          align=align)))


def shard_tree_like(tree, layout: ShardedLayout, process_set=None):
    """This rank's flat tile of each bucket of ``tree`` (e.g. the
    parameters) under ``layout``: the tensors the sharded state lives on.
    ``process_set`` may also be an axis group of a mesh."""
    leaves = _tree_leaves_sorted(tree)[0]
    ps = (process_set if isinstance(process_set, runtime.SubGroup)
          else api._ps(process_set))
    rank = ps.rank()
    return tuple(_tile_of([leaves[i] for i in bl.indices], bl, rank)
                 for bl in layout.buckets)


def fused_reduce_scatter_tree(grads, process_set=None,
                              op: str = ReduceOp.AVERAGE,
                              threshold_bytes: Optional[int] = None,
                              compression=Compression.none,
                              prescale_factor: float = 1.0,
                              postscale_factor: float = 1.0,
                              wire_format=None, residual=None,
                              spec_plan=None, health=None):
    """Reduce-scatter a gradient tree: each rank keeps its 1/N tile of
    every planned bucket.  Returns ``(tiles, layout)``, the tiles fully
    scaled and averaged; with a ``wire_format`` the scatter is quantized
    with error feedback (``residual`` as in :func:`fused_reduce_tree`) and
    the return is ``(tiles, layout, new_residual)``, the buckets padded to
    a multiple of ``size × block_size``.

    Under a ``spec_plan`` each bucket is the local model shard's, tiled
    over the data axis's group (per-rank state total/(model × data) plus
    padding): a replicated bucket first sums over the model axes, a
    model-sharded one scatters over the data axis alone, and Average
    divides by the global batch degree.  A spec naming the data axis is
    refused: such a gradient arrives reduced and sharded, leaving no axis
    to scatter over.  ``health`` taps as in :func:`fused_reduce_tree`
    (the local padded bucket, the new residual)."""
    if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(
            f"fused_reduce_scatter_tree supports op=Average/Sum, got "
            f"{op!r}: Adasum and min/max reductions are not expressible "
            f"as a reduce-scatter of bucket tiles")
    fmt = resolve_wire_format(wire_format)
    _check_wire(fmt, compression, op)
    sp = spec_plan
    if sp is not None:
        sp.check(True, fmt)
    ps = (_axis_group(sp.mesh, sp.data_axis) if sp is not None
          else api._ps(process_set))
    n = ps.size()
    leaves, names, layout = _sharded_layout(
        grads, n, op, prescale_factor, postscale_factor,
        _resolve_threshold(threshold_bytes),
        align=fmt.block_size if fmt else 1, spec_plan=sp)
    specs = sp.specs_for(names) if sp is not None else None
    global_n = sp.global_size() if sp is not None else n
    res = _residual_leaves(residual, leaves) if fmt is not None else None
    tiles = []
    for bucket_id, bl in enumerate(layout.buckets):
        if _rec.ARMED:
            _rec.set_bucket(bucket_id)
        parts = [leaves[i] for i in bl.indices]
        buf = _bucket_flat(parts, bl.padded_numel)
        if sp is None:
            buf = _tap_bucket(buf, ps, bucket_id, names[bl.indices[0]],
                              health)
        if prescale_factor != 1.0:
            buf = buf * torch.tensor(prescale_factor).to(buf.dtype)
        if sp is not None:
            # a replicated bucket's model hops first; a model-sharded one
            # arrives summed over its spec's axes
            buf = sp.sum_over(buf, [a for a in sp.reduce_axes(
                specs[bl.indices[0]]) if a != sp.data_axis])
            if n > 1:
                from ..parallel import axis as ax
                ax._count(sp.data_axis, "psum_scatter", buf)
        if fmt is not None:
            rbuf = _bucket_flat([res[i] for i in bl.indices],
                                bl.padded_numel).float()
            tile, nres = collectives.quantized_sum_scatter(
                buf.float() + rbuf, ps, fmt, error_feedback=True)
            if health is not None:
                health.observe_residual(bucket_id, nres)
            tile = tile.to(buf.dtype)
            off = 0
            for i, sz in zip(bl.indices, bl.sizes):
                res[i] = nres[off:off + sz].view(leaves[i].shape)
                off += sz
        else:
            wire, ctx = compression.compress(buf)
            tile = compression.decompress(
                collectives.reduce_scatter_flat(wire, ps), ctx)
        if op == ReduceOp.AVERAGE and (sp is not None or n > 1):
            tile = tile / global_n
        if postscale_factor != 1.0:
            collectives._scale_(tile, postscale_factor)
        tiles.append(tile)
    if _rec.ARMED:
        _rec.set_bucket(None)
    if fmt is None:
        return tuple(tiles), layout
    return tuple(tiles), layout, _unflatten(layout, res)


def sharded_tile_layout(tree, shards: int, op: str = ReduceOp.AVERAGE,
                        threshold_bytes: Optional[int] = None,
                        align: int = 1, spec_plan=None) -> ShardedLayout:
    """The ZeRO bucket and tile layout of ``tree`` over ``shards`` ranks,
    from shapes and dtypes alone (``meta`` tensors will do): per-rank
    sharded state is priced exactly from ``buckets[i].shard_numel``.
    Under a ``spec_plan`` ``tree`` holds the local model shards and the
    buckets are keyed by spec (the spec-aware transform's layout)."""
    return _sharded_layout(tree, shards, op, 1.0, 1.0,
                           _resolve_threshold(threshold_bytes),
                           align=align, spec_plan=spec_plan)[2]


def all_gather_sharded_tree(tiles, layout: ShardedLayout, process_set=None,
                            out=None):
    """The full tree from every rank's tiles: one all-gather a bucket, then
    unpad and split.  With ``out`` (a tree like the planned one) the values
    are copied into its leaves and ``out`` is returned."""
    if len(tiles) != len(layout.buckets):
        raise ValueError(
            f"got {len(tiles)} shard(s) for a layout of "
            f"{len(layout.buckets)} bucket(s): the shards and the layout "
            f"come from different plans (e.g. a stale layout after a "
            f"fusion-threshold change)")
    ps = api._ps(process_set)
    dst = _tree_leaves_sorted(out)[0] if out is not None else None
    pieces: List[Optional[torch.Tensor]] = [None] * len(layout.shapes)
    for b, (bl, tile) in enumerate(zip(layout.buckets, tiles)):
        if _rec.ARMED:
            _rec.set_bucket(b)
        full = collectives.all_gather_flat(tile, ps)
        if dst is not None:
            _split_into(full, [dst[i] for i in bl.indices])
            continue
        off = 0
        for i, sz in zip(bl.indices, bl.sizes):
            pieces[i] = full[off:off + sz].view(layout.shapes[i])
            off += sz
    if _rec.ARMED:
        _rec.set_bucket(None)
    return out if out is not None else _unflatten(layout, pieces)


@torch.no_grad()
def _step_tiles(opt, p_tiles, g_tiles, layout, params, ps) -> None:
    """The 1/N update: refresh this rank's parameter tiles from
    ``params`` (the caller may have changed them since the last gather),
    step ``opt`` over them with ``g_tiles`` as gradients, and all-gather
    the updated tiles back into ``params``."""
    sorted_p = _tree_leaves_sorted(params)[0]
    for t, g, bl in zip(p_tiles, g_tiles, layout.buckets):
        t.copy_(_tile_of([sorted_p[i] for i in bl.indices], bl, ps.rank()))
        t.grad = g
    opt.step()
    for t in p_tiles:
        t.grad = None
    for b, (bl, t) in enumerate(zip(layout.buckets, p_tiles)):
        if _rec.ARMED:
            _rec.set_bucket(b)
        _split_into(collectives.all_gather_flat(t, ps),
                    [sorted_p[i] for i in bl.indices])
    if _rec.ARMED:
        _rec.set_bucket(None)


# ---------------------------------------------------------------------------
# the transform
# ---------------------------------------------------------------------------

def _config():
    return runtime._state().config


def _sharded_update_default() -> bool:
    """HOROVOD_SHARDED_UPDATE, from the runtime's config or the env."""
    from ..config import _env_bool
    cfg = _config()
    return (cfg.sharded_update if cfg is not None
            else _env_bool("HOROVOD_SHARDED_UPDATE", False))


def _overlap_default() -> bool:
    """HOROVOD_OVERLAP, from the runtime's config or the env."""
    from ..config import _env_bool
    cfg = _config()
    return (cfg.overlap if cfg is not None
            else _env_bool("HOROVOD_OVERLAP", False))


def _health_taps_default() -> bool:
    """HOROVOD_HEALTH_TAPS (vetoed by HOROVOD_HEALTH), from the runtime's
    config or the env: the taps are an opt-in, and an explicit
    ``health=`` wins over it either way."""
    cfg = _config()
    if cfg is not None:
        return cfg.health and cfg.health_taps
    from .. import health as _h
    return _h.taps_default()


def _health_check_every_default() -> int:
    """HOROVOD_HEALTH_CHECK_EVERY (updates), from the runtime's config or
    the env."""
    cfg = _config()
    if cfg is not None:
        return cfg.health_check_every
    from .. import health as _h
    return _h.check_every()


def _sentinel_bucket_leaves(target, plan_like, op, prescale_factor,
                            postscale_factor, threshold_bytes):
    """``(name, leaves)`` per fusion bucket of ``target``, bucketed by the
    plan of ``plan_like`` (the GRADIENT tree), so that the sentinel's
    checksums line up with the taps' bucket ids (JAX
    ``_sentinel_bucket_flats``, without the concatenation)."""
    t_leaves = _tree_leaves_sorted(target)[0]
    p_leaves, p_names, _ = _tree_leaves_sorted(plan_like)
    buckets, _ = _plan_buckets(p_leaves, p_names, op, prescale_factor,
                               postscale_factor,
                               _resolve_threshold(threshold_bytes))
    return [(p_names[b[0]], [t_leaves[i] for i in b]) for b in buckets]


def _wire_format_default():
    """(HOROVOD_COMPRESSION, HOROVOD_COMPRESSION_BLOCK_SIZE).
    HOROVOD_COMPRESSION_DCN_ONLY is not read here, as in the JAX package:
    the transform carries its quantization error in its state, which is
    what makes quantizing its whole reduction safe."""
    cfg = _config()
    if cfg is not None:
        return cfg.compression, cfg.compression_block_size
    return (os.environ.get("HOROVOD_COMPRESSION", "none") or "none",
            int(os.environ.get("HOROVOD_COMPRESSION_BLOCK_SIZE", 0) or 0)
            or None)


@dataclasses.dataclass
class _DistState:
    """The transform's state (JAX ``_DistState``): the inner optimizer,
    the accumulator of ``backward_passes_per_step``, the call counter and
    the error-feedback residual; under ``sharded_update`` also this rank's
    parameter tiles, which the inner optimizer updates, and their layout.
    ``params`` is the parameter tree ``init`` was given."""
    inner: Any
    acc: Any
    count: int
    residual: Any = None
    tiles: Optional[Tuple[torch.Tensor, ...]] = None
    layout: Any = None
    params: Any = None


# ---------------------------------------------------------------------------
# checkpointless recovery: the boundary snapshot and its restore
# ---------------------------------------------------------------------------

def _inner_state(opt) -> dict:
    """The inner optimizer's state as ``{"inner/<index>/<key>": value}``,
    in the order every rank agrees on: parameter index (over the parameter
    groups, in order), then sorted state key.  Values are tensors or
    Python scalars (e.g. ``AdamWLP``'s step count)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    return {f"inner/{i}/{key}": st[key]
            for i, st in enumerate(opt.state.get(p, {}) for p in params)
            for key in sorted(st) if st[key] is not None}


def _state_values(state: _DistState) -> dict:
    """``{name: value}`` of what the recovery frame protects: ``count``,
    the inner optimizer's state (this rank's ZeRO tiles' under
    ``sharded_update``) and the error-feedback residual.  The accumulator
    is left out: it is zero at every boundary."""
    out = {"count": state.count, **_inner_state(state.inner)}
    if state.residual is not None:
        out.update({f"residual/{i}": leaf for i, leaf in
                    enumerate(tree_leaves(state.residual))})
    return out


def _numpy_dtype(t: torch.Tensor):
    """numpy's dtype for ``t``'s, or raw bytes of its item size (``V2``
    for bfloat16) where numpy has none: the frame stays bit-exact."""
    try:
        return torch.empty((), dtype=t.dtype).numpy().dtype
    except TypeError:
        return np.dtype(f"V{t.element_size()}")


def _to_numpy(v) -> np.ndarray:
    if not torch.is_tensor(v):
        return np.asarray(v)
    t = v.detach().cpu().contiguous()
    dt = _numpy_dtype(t)
    if dt.kind == "V":
        return t.reshape(-1).view(torch.uint8).numpy().view(dt).reshape(
            t.shape)
    return t.numpy().copy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr``'s bytes as a tensor of ``like``'s dtype, shape and device."""
    raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(
        np.uint8).copy())
    return raw.view(like.dtype).reshape(like.shape).to(like.device)


def recovery_payload(state: _DistState) -> dict:
    """The ``{name: numpy array}`` snapshot the recovery tap hands to
    ``elastic.recovery.deliver_boundary`` for ``state``: ``count``, the
    inner optimizer's state (``inner/<param index>/<key>``; this rank's
    ZeRO tiles' under ``sharded_update``) and the error-feedback residual
    (``residual/<leaf>``).  bfloat16 tensors travel as their raw bytes."""
    return {n: _to_numpy(v) for n, v in _state_values(state).items()}


def _expected_values(state: _DistState) -> dict:
    """What a payload must hold for ``state``: its own values, with the
    inner optimizer's lazily made state materialized on a copy of it (one
    step on zero gradients), as a fresh ``init`` holds none yet."""
    opt = state.inner
    params = [p for g in opt.param_groups for p in g["params"]]
    if any(p not in opt.state for p in params):
        opt = copy.deepcopy(opt)
        with torch.no_grad():
            for g in opt.param_groups:
                for p in g["params"]:
                    p.grad = torch.zeros_like(p)
        opt.step()
    return _state_values(dataclasses.replace(state, inner=opt))


def restore_dist_state(state: _DistState, payload) -> _DistState:
    """Install a recovered snapshot into ``state``, a fresh ``init`` of
    the SAME transform on the SAME parameters, and return it.

    The restore is bit-exact: every name the state needs must be in the
    payload with its shape and dtype (a re-form that resized the fleet
    changes the tile layout), else ``ValueError``.  The accumulator is
    zeroed, as at every boundary."""
    if "count" not in payload:
        raise ValueError("recovered payload is missing the step counter")
    want = _expected_values(state)
    got = {}
    for name, like in want.items():
        if name == "count":
            continue
        if name not in payload:
            raise ValueError(
                f"recovered payload is missing {name} — snapshot taken by "
                f"a different transform configuration?")
        arr = np.asarray(payload[name])
        if torch.is_tensor(like):
            dtype, shape = _numpy_dtype(like), tuple(like.shape)
        else:
            dtype, shape = np.asarray(like).dtype, ()
        if arr.shape != shape or arr.dtype != dtype:
            raise ValueError(
                f"recovered {name} is {arr.dtype}{arr.shape}, expected "
                f"{dtype}{shape} — the tile layout changed (e.g. the fleet "
                f"was resized); checkpointless recovery covers "
                f"replacement-at-same-size re-forms only")
        got[name] = (_from_numpy(arr, like) if torch.is_tensor(like)
                     else type(like)(arr.item()))
    got["count"] = int(np.asarray(payload["count"]))
    _install(state, got)
    for a in (tree_leaves(state.acc) if state.acc is not None else []):
        a.zero_()
    return state


@torch.no_grad()
def _install(state: _DistState, values: dict, exact: bool = False) -> None:
    """Set ``values`` (named as :func:`_state_values` names them) into
    ``state`` in place: into the live tensors where they exist, else as
    copies.  ``exact`` also drops the inner optimizer's state that
    ``values`` does not name (a commit taken before it existed)."""
    opt = state.inner
    params = [p for g in opt.param_groups for p in g["params"]]
    if exact:
        for i, p in enumerate(params):
            st = opt.state.get(p)
            for key in [k for k in (st or ()) if f"inner/{i}/{k}" not in
                        values]:
                del st[key]
            if p in opt.state and not opt.state[p]:
                del opt.state[p]
    leaves = (tree_leaves(state.residual) if state.residual is not None
              else [])
    for name, value in values.items():
        if name == "count":
            state.count = int(value)
            continue
        kind, idx = name.split("/")[:2]
        if kind == "residual":
            leaves[int(idx)].copy_(value)
            continue
        key = name.split("/", 2)[2]
        st = opt.state[params[int(idx)]]
        if torch.is_tensor(value) and torch.is_tensor(st.get(key)):
            st[key].copy_(value)
        else:
            st[key] = value.clone() if torch.is_tensor(value) else value


def _snapshot_dist(state: _DistState) -> dict:
    """A copy of ``state``'s per-rank values on their devices (an elastic
    commit): what :func:`_state_values` names, and the accumulator."""
    snap = {n: (v.detach().clone() if torch.is_tensor(v)
                else copy.deepcopy(v))
            for n, v in _state_values(state).items()}
    snap["acc"] = (None if state.acc is None else
                   tree_map(lambda a: a.detach().clone(), state.acc))
    return snap


@torch.no_grad()
def _restore_dist(state: _DistState, snap: dict) -> None:
    """Put a :func:`_snapshot_dist` copy back into ``state`` in place."""
    _install(state, {n: v for n, v in snap.items() if n != "acc"},
             exact=True)
    for a, b in zip(tree_leaves(state.acc), tree_leaves(snap["acc"])):
        if a is not None:
            a.copy_(b)


def _varying(t, axis: str):
    """The per-dim spec of a leaf varying over ``axis``: dim 0 over it
    (``()`` for a scalar, which has no dim to carry it)."""
    nd = t.dim() if torch.is_tensor(t) else 0
    return (axis,) + (None,) * (nd - 1) if nd else ()


def state_partition_specs(state: _DistState, axis_name: str = "dp",
                          sharded_update: bool = False) -> _DistState:
    """Per-dim specs (``models.llama.param_specs``' form) of a
    :class:`_DistState`'s per-rank values (JAX ``state_partition_specs``):
    a ``_DistState`` whose fields hold specs.

    The accumulator of ``backward_passes_per_step`` and the error-feedback
    residual hold this rank's own values, so they vary over ``axis_name``;
    under ``sharded_update`` the inner optimizer's non-scalar state lives
    on this rank's tiles and varies over it too (as do the tiles); the
    rest (the inner state otherwise, scalars, ``count``) is replicated.
    ``inner`` maps the inner optimizer's state as the recovery frame names
    it (``"inner/<parameter index>/<key>"``), as it holds it now (a
    ``torch.optim`` optimizer makes its state at the first step)."""
    inner = {name: (_varying(v, axis_name) if sharded_update else ())
             for name, v in _inner_state(state.inner).items()}

    def varying(tree):
        return (None if tree is None else
                tree_map(lambda t: _varying(t, axis_name), tree))

    return _DistState(
        inner=inner, acc=varying(state.acc), count=(),
        residual=varying(state.residual),
        tiles=(None if state.tiles is None else
               tuple(_varying(t, axis_name) for t in state.tiles)))


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params=None) ->
    state``, the parameters updated in place.  ``update`` is ``reduce``
    then ``apply``: ``reduce(grads, state)`` returns the reduced gradient
    leaves (tree order), or this rank's tiles under ``sharded_update``;
    ``apply(reduced, state)`` runs the inner optimizer with them."""
    init: Callable
    update: Callable
    reduce: Callable
    apply: Callable


def DistributedGradientTransform(
        inner: Optional[Callable[[List[torch.Tensor]],
                                 torch.optim.Optimizer]] = None,
        op: str = ReduceOp.AVERAGE,
        process_set=None,
        backward_passes_per_step: int = 1,
        compression=Compression.none,
        prescale_factor: float = 1.0,
        postscale_factor: float = 1.0,
        threshold_bytes: Optional[int] = None,
        sharded_update: Optional[bool] = None,
        wire_format: Optional[str] = None,
        wire_block_size: Optional[int] = None,
        overlap: Optional[bool] = None,
        overlap_layers: str = "layers",
        health: Optional[bool] = None,
        health_check_every: Optional[int] = None,
        param_specs=None,
        model_axes: Optional[Tuple[str, ...]] = None,
        recovery=None,
        mesh=None) -> GradientTransformation:
    """Reduce gradients over the process set, then run ``inner``.

    ``inner`` is called with the tensors to update: the parameter leaves,
    or under ``sharded_update`` this rank's flat tiles of them.  Each
    ``update`` reduces ``grads`` (a tree like the parameters) by the
    transform's plan, sets the reduced gradients (or tiles) as the
    ``.grad`` of those tensors, steps ``inner`` and, sharded, all-gathers
    the updated tiles back into the parameters.  See the module docstring
    for the options; their defaults come from ``HOROVOD_SHARDED_UPDATE``,
    ``HOROVOD_COMPRESSION`` (+ ``_BLOCK_SIZE``) and ``HOROVOD_OVERLAP``.
    ``recovery`` (a ``RecoveryAgent``, whose ``every`` sets the cadence)
    arms the boundary snapshot; it refuses ``overlap``.
    Under ``overlap`` a wire format quantizes without error feedback and
    the residual stays None, as in the JAX package.

    ``param_specs`` (a spec tree congruent with the parameters, per-dim
    tuples as ``models.llama.param_specs`` gives them; default: the
    ``param_specs`` of ``mesh``, else of the innermost entered
    ``ParallelMesh``, as ``with pmesh.with_param_specs(specs):`` sets
    them) makes the plane spec-aware over ``mesh`` (default: the entered
    mesh): its ``dp`` axis is the data axis, ``model_axes`` are axes of
    it too, and the buckets reduce over their groups (the module
    docstring); the ``process_set`` does not apply.  It composes with ``sharded_update``
    (which refuses a spec naming the data axis), ``wire_format`` and
    ``overlap``; it needs op Average or Sum and refuses ``health``.

    ``health`` (default ``HOROVOD_HEALTH_TAPS``, vetoed by
    ``HOROVOD_HEALTH=0``) arms the numerics taps and the divergence
    sentinel (the module docstring), every ``health_check_every``-th
    update (default ``HOROVOD_HEALTH_CHECK_EVERY``; >= 1); with it armed
    ``count`` advances on every update, and under
    ``backward_passes_per_step=k`` the taps fire at the boundary only,
    the cadence dividing the boundary ordinal ``count // k``.  It refuses
    ``overlap`` and ``param_specs``.
    """
    if param_specs is None:
        # the mesh context is the no-plumbing path: a transform built
        # inside `with pmesh.with_param_specs(specs):` gets the spec tree
        from ..parallel.mesh import current_mesh
        m = mesh if mesh is not None else current_mesh()
        if m is not None and m.param_specs is not None:
            param_specs, mesh = m.param_specs, m
    sp = None
    if param_specs is not None:
        if mesh is None:
            from ..parallel.mesh import current_mesh
            mesh = current_mesh()
        if mesh is None:
            raise ValueError(
                "param_specs requires a ParallelMesh (mesh=, or a transform "
                "built inside `with pmesh:`): the spec-aware reduction "
                "factors the mesh into data x model axes and reduces over "
                "their groups; a process set's tensors are full-width "
                "(spec 'replicated') by construction")
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            raise ValueError(
                f"param_specs supports op=Average/Sum, got {op!r}")
        if health:
            raise ValueError(
                "health=True is not supported with param_specs yet: the "
                "divergence sentinel's checksum gather assumes ONE "
                "replication group, but a model-sharded leaf's checksums "
                "legitimately differ across model shards")
        if process_set is not None:
            raise ValueError(
                "param_specs reduces over the mesh's axis groups: pass "
                "mesh=, not process_set")
        sp = make_spec_plan(param_specs, "dp", model_axes, mesh=mesh)
    if inner is None:
        raise ValueError(
            "DistributedGradientTransform needs the inner optimizer's "
            "factory (called with the tensors it updates)")
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError(f"backward_passes_per_step must be >= 1, got {k}")
    sharded = (bool(sharded_update) if sharded_update is not None
               else _sharded_update_default())
    if sharded and op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(
            f"sharded_update supports op=Average/Sum, got {op!r}")
    if wire_format is None:
        env_fmt, env_block = _wire_format_default()
        fmt = resolve_wire_format(env_fmt,
                                  wire_block_size or env_block or None)
    else:
        fmt = resolve_wire_format(wire_format, wire_block_size)
    _check_wire(fmt, compression, op)
    if sp is not None:
        sp.check(sharded, fmt)
    ov = bool(overlap) if overlap is not None else _overlap_default()
    ov_plan = None
    if ov:
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            raise ValueError(
                f"overlap supports op=Average/Sum, got {op!r}: Adasum's "
                f"recursive pairwise reduction needs every gradient at "
                f"once and cannot dispatch per-layer")
        if compression not in (None, Compression.none):
            raise ValueError(
                "overlap does not support the cast compressor: use "
                "wire_format for a quantized wire (feedback-free under "
                "overlap) or no compression")
        from . import overlap as _ov
        ov_plan = _ov.OverlapPlan(
            process_set=None, op=op, threshold_bytes=threshold_bytes,
            prescale=prescale_factor, postscale=postscale_factor,
            sharded=sharded, fmt=fmt, k=k, layers_key=overlap_layers,
            spec_plan=sp)
    if health and ov_plan is not None:
        raise ValueError(
            "health=True is not supported with overlap=True: the "
            "overlapped buckets dispatch inside the backward pass and "
            "never materialize a boundary buffer to tap — use the "
            "trace/metrics plane for overlapped steps, or disable one")
    hl_enabled = (bool(health) if health is not None
                  else (ov_plan is None and sp is None
                        and _health_taps_default()))
    hl_every = 1
    if hl_enabled:
        hl_every = (int(health_check_every)
                    if health_check_every is not None
                    else _health_check_every_default())
        if hl_every < 1:
            raise ValueError(
                f"health_check_every must be >= 1, got {hl_every}")
    if recovery is not None and ov_plan is not None:
        raise ValueError(
            "recovery is not supported with overlap=True: overlapped "
            "steps dispatch buckets inside the backward scan and never "
            "materialize the boundary state in one place to snapshot — "
            "disable one of the two")
    rc_every = (max(int(getattr(recovery, "every", 1)), 1)
                if recovery is not None else 1)
    kw = dict(op=op, threshold_bytes=threshold_bytes,
              prescale_factor=prescale_factor,
              postscale_factor=postscale_factor)

    def _data_ps():
        """The group the tiles and the data hop run over: the data axis's
        of the mesh under a spec plan, else the process set."""
        return (_axis_group(sp.mesh, sp.data_axis) if sp is not None
                else api._ps(process_set))

    def _emit_recovery(boundary_ord: int, state: _DistState) -> None:
        """The cadence-gated boundary snapshot: the host copy happens only
        on the cadence."""
        if boundary_ord % rc_every:
            return
        from ..elastic import recovery as _recovery
        _recovery.deliver_boundary(boundary_ord,
                                   api._ps(process_set).rank(),
                                   recovery_payload(state))

    def init_fn(params) -> _DistState:
        ps = _data_ps()
        leaves = tree_leaves(params)
        acc = tree_map(torch.zeros_like, params) if k > 1 else None
        residual = (tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
            if fmt is not None and ov_plan is None else None)
        tiles = layout = None
        if ov_plan is not None:
            from . import overlap as _ov
            ov_plan.process_set = ps
            sorted_leaves, layout = _ov.build_layout(
                params, ov_plan, ps.size() if sharded else 1)
            ov_plan.layout = layout
            ov_plan.index = {id(x): i for i, x in enumerate(sorted_leaves)}
            if sharded:
                tiles = _ov.carve_tiles(params, ov_plan, layout)[0]
        elif sharded:
            _, _, layout = _sharded_layout(
                params, ps.size(), op, prescale_factor, postscale_factor,
                _resolve_threshold(threshold_bytes),
                align=fmt.block_size if fmt else 1, spec_plan=sp)
            tiles = shard_tree_like(params, layout, ps)
        opt = inner(list(tiles) if sharded else leaves)
        return _DistState(inner=opt, acc=acc, count=0, residual=residual,
                          tiles=tiles, layout=layout, params=params)

    def apply_fn(reduced, state: _DistState, keep_grads: bool = False):
        if sharded:
            _step_tiles(state.inner, state.tiles, reduced, state.layout,
                        state.params, _data_ps())
            return
        params = tree_leaves(state.params)
        for p, g in zip(params, reduced):
            p.grad = g
        state.inner.step()
        if not keep_grads:
            for p in params:
                p.grad = None

    def _check_layout(layout, state: _DistState):
        if layout.fingerprint() != state.layout.fingerprint():
            raise ValueError(
                "sharded_update requires gradients and params to share one "
                "bucket layout, but they plan differently (dtype or "
                "structure divergence between the gradient tree and the "
                "param tree)")

    def _reduce(grads, state: _DistState, taps=None):
        red_kw = dict(kw, process_set=process_set, spec_plan=sp,
                      health=taps)
        if sharded:
            if fmt is not None:
                tiles, layout, state.residual = fused_reduce_scatter_tree(
                    grads, wire_format=fmt, residual=state.residual,
                    **red_kw)
            else:
                tiles, layout = fused_reduce_scatter_tree(
                    grads, compression=compression, **red_kw)
            _check_layout(layout, state)
            return list(tiles)
        if fmt is not None:
            grads, state.residual = fused_reduce_tree(
                grads, wire_format=fmt, residual=state.residual, **red_kw)
        else:
            grads = fused_reduce_tree(grads, compression=compression,
                                      **red_kw)
        return tree_leaves(grads)

    def _ov_reduce(grads, state: _DistState, pending, extra_acc=None):
        """The overlapped plan's reduction: the dispatch's buckets when
        the taps fired (``pending``), else the same plan run here; with
        ``extra_acc`` (the accumulated micro-steps of k > 1, reduced here)
        folded in as ``(R(acc) + R(grads)) / k``."""
        from . import overlap as _ov
        if sharded:
            red = (pending.finish() if pending is not None
                   else list(_ov.scatter_tiles(grads, ov_plan,
                                               state.layout)[0]))
            acc = (None if extra_acc is None else
                   _ov.scatter_tiles(extra_acc, ov_plan, state.layout)[0])
        else:
            red = (_restore_order(pending.finish(), state.layout.order)
                   if pending is not None else
                   tree_leaves(_ov.reduce_full(grads, ov_plan,
                                               state.layout)))
            acc = (None if extra_acc is None else tree_leaves(
                _ov.reduce_full(extra_acc, ov_plan, state.layout)))
        if acc is not None:
            red = [(a + g) / k for a, g in zip(acc, red)]
        return red

    def reduce_fn(grads, state: _DistState):
        if ov_plan is not None:
            return _ov_reduce(grads, state, ov_plan.consume())
        return _reduce(grads, state)

    def _health_step(grads, state: _DistState, params, cadence_step: int):
        """One reduce and apply with the health taps armed: the buckets
        tapped before their collectives, the sentinel's parameter
        checksums taken before the in-place update and its optimizer-state
        checksum and gather after it, then one delivery to the host."""
        from ..health.taps import HealthTaps
        ps = api._ps(process_set)
        taps = HealthTaps(ps.rank(), state.count, hl_every,
                          cadence_step=cadence_step, process_set=ps)
        reduced = _reduce(grads, state, taps)
        taps.checksum_params(lambda: _sentinel_bucket_leaves(
            params if params is not None else state.params, grads, **kw))
        apply_fn(reduced, state)
        # under sharded_update the inner state is 1/N a rank by design:
        # only the replicated parameters are compared
        taps.sentinel(None if sharded else
                      lambda: list(_inner_state(state.inner).values()))
        taps.emit()

    def update_fn(grads, state: _DistState, params=None) -> _DistState:
        if params is not None and len(tree_leaves(params)) != \
                len(tree_leaves(state.params)):
            raise ValueError("update() got another parameter tree than "
                             "init()")
        if k == 1:
            if hl_enabled or recovery is not None:
                # the sentinel and recovery cadences need a step counter:
                # with either tap armed, count advances every update
                state.count += 1
            if hl_enabled:
                _health_step(grads, state, params, state.count)
            else:
                # inside a training step, its exchange and optimizer
                # phases (tracing.steps; nothing outside one)
                with _tracing.phase("exchange"):
                    reduced = reduce_fn(grads, state)
                with _tracing.phase("optimizer"):
                    apply_fn(reduced, state)
            if recovery is not None:
                _emit_recovery(state.count, state)
            return state
        state.count += 1
        boundary = state.count % k == 0
        if ov_plan is not None:
            pending = ov_plan.consume()
            if boundary:
                apply_fn(_ov_reduce(grads, state, pending,
                                    extra_acc=state.acc), state)
                for a in tree_leaves(state.acc):
                    a.zero_()
            elif pending is not None:
                raise ValueError(
                    "overlap: grad taps fired on a step that does not "
                    "complete the accumulation; pass count=state.count "
                    "to overlapped_backprop")
            else:
                for a, g in zip(tree_leaves(state.acc), tree_leaves(grads)):
                    a.add_(g)
            return state
        for a, g in zip(tree_leaves(state.acc), tree_leaves(grads)):
            a.add_(g)
        if boundary:
            for a in tree_leaves(state.acc):
                a.div_(k)
            if hl_enabled:
                # taps at the boundary only (the micro-steps accumulate
                # locally); the sentinel cadence divides the BOUNDARY
                # ordinal, not the micro-step counter
                _health_step(state.acc, state, params, state.count // k)
            else:
                apply_fn(_reduce(state.acc, state), state)
            for a in tree_leaves(state.acc):
                a.zero_()
            if recovery is not None:
                # the cadence divides the BOUNDARY ordinal, not the
                # micro-step counter
                _emit_recovery(state.count // k, state)
        return state

    if ov_plan is not None:
        from . import overlap as _ov
        _ov.register_transform(update_fn, ov_plan)
    return GradientTransformation(init_fn, update_fn, reduce_fn, apply_fn)


# ---------------------------------------------------------------------------
# the torch optimizer wrapper and the broadcasts
# ---------------------------------------------------------------------------

def broadcast_parameters(params, root_rank: int = 0, process_set=None):
    """Broadcast parameters from ``root_rank`` to every rank, in place.

    ``params`` is a ``state_dict()`` or an iterable of ``(name, tensor)``
    pairs such as ``model.named_parameters()``.
    """
    items = list(params.items()) if hasattr(params, "items") else list(params)
    handles = [api.broadcast_async_(p.data, root_rank, name=f"bp.{name}",
                                    process_set=process_set)
               for name, p in items if torch.is_tensor(p)]
    for h in handles:
        h.synchronize()


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set=None):
    """Install ``root_rank``'s optimizer state on every rank (the other
    ranks may hold none before their first ``step()``)."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("broadcast_optimizer_state does not support LBFGS")
    state = api.broadcast_object(optimizer.state_dict(), root_rank,
                                 name="opt_state", process_set=process_set)
    optimizer.load_state_dict(state)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Methods grafted onto a dynamic subclass of the wrapped optimizer's
    class (the reference's trick, so ``isinstance`` checks keep working)."""

    def _hvd_init(self, named_parameters, compression,
                  backward_passes_per_step, op, gradient_predivide_factor,
                  process_set, threshold_bytes, sharded_update, wire_format,
                  wire_block_size, overlap, overlap_layers):
        if gradient_predivide_factor != 1.0 and op != Average:
            raise ValueError(
                "gradient_predivide_factor requires op == Average")
        self._bpps = int(backward_passes_per_step)
        self._should_synchronize = True
        named = list(named_parameters) if named_parameters is not None \
            else []
        names_only = [nm for nm, _ in named]
        dup = {n for n in names_only if names_only.count(n) > 1}
        if dup:
            raise ValueError(f"duplicate parameter names: {sorted(dup)}")
        by_param = {p: nm for nm, p in named}
        # deterministic group-order names for the rest: the same on every
        # rank running the same model, which the static plan requires
        for gi, group in enumerate(self.param_groups):
            for pi, p in enumerate(group["params"]):
                by_param.setdefault(p, f"group{gi}.param{pi}")
        self._named = {by_param[p]: p for g in self.param_groups
                       for p in g["params"] if p.requires_grad}
        ps = api._ps(process_set)
        self._process_set = ps
        # the plan is the transform's, built over the named parameters;
        # its inner optimizer is this one's base step, or the base class
        # over this rank's tiles
        sharded = (bool(sharded_update) if sharded_update is not None
                   else _sharded_update_default())
        if sharded and len(self.param_groups) != 1:
            raise ValueError("sharded_update needs one parameter group: "
                             "its state lives on flat tiles of all of them")
        base = self._hvd_base
        inner = ((lambda tiles: base(tiles, **self.defaults)) if sharded
                 else (lambda _leaves: _BaseStep(self)))
        self._tx = DistributedGradientTransform(
            inner, op=op, process_set=ps, compression=compression,
            prescale_factor=1.0 / gradient_predivide_factor,
            postscale_factor=gradient_predivide_factor,
            threshold_bytes=threshold_bytes, sharded_update=sharded,
            wire_format=wire_format, wire_block_size=wire_block_size,
            overlap=overlap, overlap_layers=overlap_layers)
        self._dist = self._tx.init(self._named)
        self._plan = None
        if overlap or (overlap is None and _overlap_default()):
            from . import overlap as _ov
            self._plan = _ov.plan_for(self._tx)
        self._dispatch = None
        self._reduced = None
        self._passes = {p: 0 for p in self._named.values()}
        self._hook_refs = [p.register_post_accumulate_grad_hook(
            self._make_hook(nm)) for nm, p in self._named.items()]

    def _make_hook(self, name):
        def hook(param):
            self._passes[param] += 1
            if self._plan is None or self._passes[param] % self._bpps:
                return
            # overlapped dispatch: the gradient joins its bucket, which
            # goes out once its leaves are in and its turn has come
            from . import overlap as _ov
            if self._dispatch is None:
                self._dispatch = _ov._Dispatch(self._plan)
            self._dispatch.arrive([self._plan.index[id(param)]],
                                  [param.grad])
        return hook

    def synchronize(self):
        """Reduce the gradients by the plan, in place into ``p.grad``
        (reference: synchronize); under ``sharded_update`` this rank's
        reduced tiles are kept for ``step()`` instead."""
        if self._reduced is not None:
            return
        grads = {nm: (p.grad if p.grad is not None else
                      torch.zeros_like(p))
                 for nm, p in self._named.items()}
        if self._dispatch is not None:
            self._plan._pending, self._dispatch = self._dispatch, None
        self._reduced = self._tx.reduce(grads, self._dist)

    @contextmanager
    def skip_synchronize(self):
        """Wrap ``step()`` when ``synchronize()`` was called by hand (e.g.
        before gradient clipping)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            self.synchronize()
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._tx.apply(self._reduced, self._dist, keep_grads=True)
        self._reduced = None
        for p in self._passes:
            self._passes[p] = 0
        return loss

    def zero_grad(self, *args, **kwargs):
        if self._dispatch is not None:
            raise AssertionError(
                "zero_grad called with allreduces in flight; call "
                "optimizer.step() (or synchronize()) first")
        return self._hvd_base.zero_grad(self, *args, **kwargs)


class _BaseStep:
    """The wrapped optimizer's own ``step`` as the transform's inner
    optimizer (the transform sets ``p.grad`` to the reduced gradients)."""

    def __init__(self, opt):
        self._opt = opt

    def step(self):
        return self._opt._hvd_base.step(self._opt)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op=Average,
                         gradient_predivide_factor: float = 1.0,
                         process_set=None,
                         threshold_bytes: Optional[int] = None,
                         sharded_update: Optional[bool] = None,
                         wire_format: Optional[str] = None,
                         wire_block_size: Optional[int] = None,
                         overlap: Optional[bool] = None,
                         overlap_layers: str = "layers"):
    """Wrap a torch optimizer with cross-rank gradient averaging.

    The gradients are reduced by the :func:`DistributedGradientTransform`
    plan over the named parameters (``threshold_bytes``, ``sharded_update``,
    ``wire_format``/``wire_block_size`` and ``overlap``/``overlap_layers`` as
    there): in ``step()`` (or ``synchronize()``), or with ``overlap``,
    bucket by bucket from the parameters' post-accumulate hooks as the
    backward pass produces them.  ``backward_passes_per_step`` lets that
    many backward passes accumulate into ``p.grad`` before a reduction;
    ``gradient_predivide_factor`` divides before the sum and multiplies
    after.  Under ``sharded_update`` the wrapped optimizer's class and
    hyper-parameters step this rank's flat tiles (one parameter group), and
    ``p.grad`` keeps the local gradients.
    """
    base = optimizer.__class__
    cls = type(base.__name__, (base,), dict(_DistributedOptimizer.__dict__))
    optimizer.__class__ = cls
    optimizer._hvd_base = base
    optimizer._hvd_init(named_parameters, compression,
                        backward_passes_per_step, op,
                        gradient_predivide_factor, process_set,
                        threshold_bytes, sharded_update, wire_format,
                        wire_block_size, overlap, overlap_layers)
    return optimizer
