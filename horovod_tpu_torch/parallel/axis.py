"""Collectives over a named axis of the current mesh, with their gradients.

Counterpart: what ``lax`` does inside ``shard_map`` in the JAX package
(``psum``, ``pmax``, ``all_gather``, ``all_to_all``, ``ppermute``,
``psum_scatter``, ``axis_index``).  Each differentiable form is a
``torch.autograd.Function`` whose backward is the JAX transpose:
``ppermute`` the reverse rotation, ``all_to_all`` the inverse exchange,
tiled ``all_gather`` this rank's slice of the cotangent (or, as
``all_gather_scatter``, the reduce-scatter JAX transposes it to),
``psum_scatter`` the tiled all-gather; ``pmax`` carries no gradient.

JAX's ``check_vma`` inserts the transposes of replicated-meets-sharded
products itself; eager autograd cannot, so the model places Megatron's
pair (:func:`copy_to`, :func:`reduce_from`) where JAX's varying-axis
rules put them: ``copy_to`` (identity forward, all-reduce backward) on a
replicated value before it meets a sharded one, ``reduce_from``
(all-reduce forward, identity backward, JAX's ``psum``) after a
row-parallel product.

The axis resolves through :func:`parallel.mesh.current_mesh` when the
forward runs; an axis of size 1 is the identity.  Over gloo, CUDA tensors
go through host memory.  :data:`BYTES` counts the payload bytes one rank
hands each axis, by collective (``"tp.all_reduce"``, ``"sp.ppermute"``,
...).  Every ``torch.distributed`` call reports to the schedule recorder
first (``analysis/recorder.py``), named by its axis.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from ..analysis import recorder as _rec
from .mesh import current_mesh

#: payload bytes this rank handed each axis since :func:`reset_bytes`, by
#: ``"<axis>.<collective>"``
BYTES: Dict[str, int] = {}


def reset_bytes() -> None:
    BYTES.clear()


def _mesh():
    m = current_mesh()
    if m is None:
        raise ValueError(
            "a collective over a named mesh axis needs a ParallelMesh "
            "context: run the forward inside `with pmesh:`")
    return m


def axis_size(name: str) -> int:
    """The size of axis ``name`` of the current mesh."""
    return _mesh().axis_size(name)


def axis_index(name: str) -> int:
    """This rank's coordinate on axis ``name`` (JAX ``lax.axis_index``)."""
    return _mesh().axis_index(name)


def _group(name: str):
    return _mesh().group(name)


def _count(name: str, op: str, t: torch.Tensor) -> None:
    key = f"{name}.{op}"
    BYTES[key] = BYTES.get(key, 0) + t.numel() * t.element_size()


def _host(t: torch.Tensor, g) -> bool:
    """True when ``t`` must go through host memory: a CUDA tensor over
    gloo."""
    return t.is_cuda and dist.get_backend(g.group) == "gloo"


def _all_reduce(x: torch.Tensor, g, name: str, op=dist.ReduceOp.SUM):
    _count(name, "all_reduce", x)
    if _rec.ARMED:
        _rec.reduce(op, g, x, axis=name)
    if _host(x, g):
        t = x.detach().cpu()
        dist.all_reduce(t, op=op, group=g.group)
        return t.to(x.device)
    t = x.detach().contiguous().clone()
    dist.all_reduce(t, op=op, group=g.group)
    return t


def _gather(x: torch.Tensor, g, name: str, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    _count(name, "all_gather", x)
    n = g.size()
    src = (x.detach().cpu() if _host(x, g)
           else x.detach().contiguous()).reshape(-1)
    out = src.new_empty(n * src.numel())
    if _rec.ARMED:
        shape = list(x.shape) or [1]
        shape[dim if x.dim() else 0] *= n
        _rec.gather(g, x, x.new_empty(shape, device="meta"), dim=dim,
                    axis=name)
    dist.all_gather_into_tensor(out, src, group=g.group)
    parts = out.to(x.device).view((n,) + tuple(x.shape)).unbind(0)
    return torch.cat(parts, dim=dim) if x.dim() else torch.stack(parts)


def _exchange(x: torch.Tensor, g, name: str, split_axis: int,
              concat_axis: int):
    """Chunk ``j`` of ``x`` along ``split_axis`` goes to rank ``j``; the
    received chunks are concatenated along ``concat_axis`` in source
    order."""
    n = g.size()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks of {name!r}")
    _count(name, "all_to_all", x)
    chunks = torch.stack(x.detach().chunk(n, dim=split_axis))
    src = chunks.cpu() if _host(x, g) else chunks.contiguous()
    out = torch.empty_like(src)
    if _rec.ARMED:
        shape = list(x.shape)
        shape[split_axis] //= n
        shape[concat_axis] *= n
        _rec.exchange(g, x, x.new_empty(shape, device="meta"),
                      split=split_axis, concat=concat_axis, axis=name)
    dist.all_to_all_single(out, src, group=g.group)
    return torch.cat(list(out.to(x.device).unbind(0)), dim=concat_axis)


def _permute(x: torch.Tensor, g, name: str, perm):
    """``perm``'s ``(src, dst)`` pairs over the axis: this rank's ``x``
    goes to each ``dst`` it is the ``src`` of; a rank no pair sends to
    gets zeros (JAX ``ppermute``)."""
    me = g.rank()
    src = x.detach().cpu() if _host(x, g) else x.detach().contiguous()
    out = torch.zeros_like(src)
    if _rec.ARMED:
        _rec.permute(g, x, x, perm, axis=name)
    reqs = []
    for s, d in perm:
        if s == me:
            _count(name, "ppermute", x)
            reqs.append(dist.isend(src, g.ranks[d], group=g.group))
        if d == me:
            reqs.append(dist.irecv(out, g.ranks[s], group=g.group))
    for r in reqs:
        r.wait()
    return out.to(x.device)


def _scatter_sum(x: torch.Tensor, g, name: str, dim: int):
    """The sum over the axis of ``x``; rank ``i`` keeps the ``i``-th of
    ``n`` slices along ``dim``."""
    n = g.size()
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks of {name!r}")
    _count(name, "psum_scatter", x)
    chunks = torch.stack(x.detach().chunk(n, dim=dim))
    src = (chunks.cpu() if _host(x, g) else chunks.contiguous()).view(-1)
    out = src.new_empty(src.numel() // n)
    if _rec.ARMED:
        shape = list(x.shape)
        shape[dim] //= n
        _rec.scatter(g, x, x.new_empty(shape, device="meta"), dim=dim,
                     axis=name)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=g.group)
    return out.to(x.device).view(chunks.shape[1:])


def _slice(x: torch.Tensor, g, dim: int):
    n = x.shape[dim] // g.size()
    return x.narrow(dim, g.rank() * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, name):
        ctx.g, ctx.name = g, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.g, ctx.name), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, name):
        return _all_reduce(x, g, name)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, name, dim):
        ctx.g, ctx.dim = g, dim
        return _gather(x, g, name, dim)

    @staticmethod
    def backward(ctx, dy):
        return _slice(dy, ctx.g, ctx.dim), None, None, None


class _AllGatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, name, dim):
        ctx.args = (g, name, dim)
        return _gather(x, g, name, dim)

    @staticmethod
    def backward(ctx, dy):
        return _scatter_sum(dy, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, name, split_axis, concat_axis):
        ctx.args = (g, name, concat_axis, split_axis)
        return _exchange(x, g, name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, dy):
        return _exchange(dy, *ctx.args), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, name, perm):
        ctx.args = (g, name, [(d, s) for s, d in perm])
        return _permute(x, g, name, perm)

    @staticmethod
    def backward(ctx, dy):
        return _permute(dy, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, name, dim):
        ctx.args = (g, name, dim)
        return _scatter_sum(x, g, name, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, *ctx.args), None, None, None


def copy_to(x: torch.Tensor, name) -> torch.Tensor:
    """Identity forward, all-reduce over ``name`` backward (Megatron's
    ``copy_to_tensor_model_parallel_region``; JAX's implicit pvary):
    before a product of a replicated ``x`` with a sharded weight."""
    g = _group(name) if name is not None else None
    return x if g is None else _CopyTo.apply(x, g, name)


def reduce_from(x: torch.Tensor, name) -> torch.Tensor:
    """All-reduce over ``name`` forward, identity backward (JAX
    ``lax.psum`` of a varying value; Megatron's
    ``reduce_from_tensor_model_parallel_region``)."""
    g = _group(name) if name is not None else None
    return x if g is None else _ReduceFrom.apply(x, g, name)


psum = reduce_from


def pmax(x: torch.Tensor, name: str) -> torch.Tensor:
    """The elementwise maximum over ``name``; no gradient (JAX uses it
    under ``stop_gradient`` only)."""
    g = _group(name)
    return x.detach() if g is None else _all_reduce(x, g, name,
                                                    dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, name: str, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` in rank order (``tiled``) or
    stacked on a new leading dim; the backward keeps this rank's slice of
    the cotangent."""
    g = _group(name)
    if not tiled:
        x = x.unsqueeze(0)
        dim = 0
    return x if g is None else _AllGather.apply(x, g, name, dim)


def all_gather_scatter(x: torch.Tensor, name: str,
                       dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` in rank order, with JAX's
    transpose of a tiled ``all_gather``: the backward reduce-scatters the
    cotangent (each rank's comes from its own data, as under FSDP), where
    :func:`all_gather` keeps this rank's slice of a cotangent every rank
    holds alike."""
    g = _group(name)
    return x if g is None else _AllGatherScatter.apply(x, g, name, dim)


def all_to_all(x: torch.Tensor, name: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """JAX ``lax.all_to_all(..., tiled=True)``: chunk ``j`` of
    ``split_axis`` to rank ``j``, received chunks concatenated along
    ``concat_axis``; the backward is the inverse exchange."""
    g = _group(name)
    return x if g is None else _AllToAll.apply(x, g, name, split_axis,
                                               concat_axis)


def ppermute(x: torch.Tensor, name: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """JAX ``lax.ppermute``; the backward sends the cotangent back along
    the reversed pairs."""
    g = _group(name)
    return x if g is None else _PPermute.apply(x, g, name,
                                               [tuple(p) for p in perm])


def psum_scatter(x: torch.Tensor, name: str,
                 scatter_dimension: int = 0) -> torch.Tensor:
    """JAX ``lax.psum_scatter(..., tiled=True)``; the backward is the
    tiled all-gather."""
    g = _group(name)
    return x if g is None else _PsumScatter.apply(x, g, name,
                                                  scatter_dimension)
