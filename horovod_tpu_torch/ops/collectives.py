"""Eager collectives over ``torch.distributed``: the data plane.

Counterpart: the eager array functions of ``horovod_tpu/ops/collectives.py``
(``allreduce_arrays``, ``allgather_array``, ``broadcast_array``,
``alltoall_array``, ``reducescatter_array``).  The JAX package runs each as
a compiled ``shard_map`` program over the process set's mesh; here each is
one ``torch.distributed`` call on the process set's group, NCCL on CUDA
tensors or gloo.  The engine (``ops/engine.py``) is the only caller: it
calls them from its own thread, on its own CUDA stream, in the order the
ranks negotiated.

Every rank passes its own tensor and gets its own result (one process per
GPU).  The reference's fusion buffer is :func:`allreduce_arrays`: pack a
bucket into one flat buffer, reduce it once, unpack.  A bucket of one
contiguous tensor reduced in place skips both copies.

Not here yet: the quantized, tail-policy and hierarchical paths and Adasum
(ROADMAP.md A5), and the in-graph ``*_p`` forms (A5, A6).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..runtime import ReduceOp

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,   # summed, then divided by n
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.BAND: dist.ReduceOp.BAND,
    ReduceOp.BOR: dist.ReduceOp.BOR,
    ReduceOp.BXOR: dist.ReduceOp.BXOR,
}


def _scale_(t: torch.Tensor, factor: float) -> None:
    """``t *= factor`` with the factor first cast to ``t``'s dtype, as the
    JAX package applies ``x * factor.astype(x.dtype)``."""
    t.mul_(torch.tensor(factor, dtype=torch.float32).to(t.dtype).item())


def _average_(t: torch.Tensor, n: int) -> None:
    """Divide a sum over ``n`` ranks: true division for floating dtypes,
    floor division for integers (the JAX package's ``r // n``)."""
    if t.is_floating_point() or t.is_complex():
        t.div_(n)
    else:
        t.div_(n, rounding_mode="floor")


def _group(ps):
    if ps.group is None:
        raise ValueError(f"this rank is not a member of {ps}")
    return ps.group


def allreduce_arrays(tensors: Sequence[torch.Tensor], ps,
                     op: str = ReduceOp.AVERAGE,
                     prescale_factor: Optional[float] = None,
                     postscale_factor: Optional[float] = None,
                     inplace: bool = False,
                     mark: Optional[Callable[[str], None]] = None
                     ) -> List[torch.Tensor]:
    """Fused allreduce of one bucket (tensors of one dtype) over ``ps``.

    ``inplace`` writes the results into ``tensors`` and returns them;
    otherwise the results are views of one new flat buffer.  ``mark``, when
    given, is called with ``"pack"``, ``"reduce"`` and ``"unpack"`` as each
    phase begins and with ``"end"`` after the last (the engine's device
    timing).
    """
    if op == ReduceOp.ADASUM:
        raise NotImplementedError("Adasum is not ported yet (ROADMAP.md A5)")
    if op not in _DIST_OPS:
        raise ValueError(f"unsupported reduce op: {op}")
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("a fused allreduce takes tensors of one dtype")
    group = _group(ps)
    mark = mark or (lambda phase: None)
    mark("pack")
    direct = inplace and len(tensors) == 1 and tensors[0].is_contiguous()
    if direct:
        flat = tensors[0].view(-1)
    elif len(tensors) == 1:
        flat = tensors[0].reshape(-1).clone()
    else:
        flat = torch.cat([t.reshape(-1) for t in tensors])
    if prescale_factor is not None:
        _scale_(flat, prescale_factor)
    mark("reduce")
    dist.all_reduce(flat, op=_DIST_OPS[op], group=group)
    mark("unpack")
    if op == ReduceOp.AVERAGE:
        _average_(flat, ps.size())
    if postscale_factor is not None:
        _scale_(flat, postscale_factor)
    if direct:
        outs = list(tensors)
    else:
        outs = [v.view(t.shape) for v, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]
        if inplace:
            torch._foreach_copy_(list(tensors), outs)
            outs = list(tensors)
    mark("end")
    return outs


def allgather_array(x: torch.Tensor, ps,
                    rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order.

    ``rows`` are the ranks' dim-0 sizes as the negotiation agreed them
    (Allgatherv); uneven ones are padded to the largest for one uniform
    gather and sliced back.
    """
    if x.dim() == 0:
        raise ValueError("allgather needs a tensor of at least one dim")
    group = _group(ps)
    n = ps.size()
    rows = [int(r) for r in rows] if rows is not None else [x.shape[0]] * n
    mx = max(rows)
    x = x.contiguous()
    if x.shape[0] < mx:
        x = torch.cat([x, x.new_zeros((mx - x.shape[0],) + x.shape[1:])])
    outs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(outs, x, group=group)
    return torch.cat([o[:r] for o, r in zip(outs, rows)])


def broadcast_array(x: torch.Tensor, root_rank: int, ps,
                    inplace: bool = False) -> torch.Tensor:
    """Rank ``root_rank`` (within ``ps``)'s ``x`` on every rank."""
    if not 0 <= root_rank < ps.size():
        raise ValueError(f"root_rank {root_rank} outside the process set "
                         f"of {ps.size()} ranks")
    out = x if inplace and x.is_contiguous() else x.contiguous().clone()
    dist.broadcast(out, src=ps.ranks[root_rank], group=_group(ps))
    if out is not x and inplace:
        x.copy_(out)
        return x
    return out


def alltoall_array(x: torch.Tensor, ps,
                   splits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Rows ``splits[j]`` of ``x`` (in order) go to rank ``j``; each rank
    receives its chunk from every rank, concatenated in rank order.

    As in the JAX package, ``splits`` is part of the negotiated signature,
    so every rank passes the same splits: rank ``j`` receives
    ``n * splits[j]`` rows.  Without splits dim 0 splits evenly.
    """
    n = ps.size()
    if splits is None:
        if x.shape[0] % n:
            raise ValueError(
                f"alltoall dim-0 size {x.shape[0]} not divisible by {n} "
                f"ranks; pass explicit splits")
        splits = [x.shape[0] // n] * n
    splits = [int(s) for s in splits]
    if len(splits) != n:
        raise ValueError(f"splits must have length {n}")
    if sum(splits) != x.shape[0]:
        raise ValueError(f"splits {splits} do not sum to dim 0 "
                         f"({x.shape[0]})")
    recv = [splits[ps.rank()]] * n
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                           input_split_sizes=splits, group=_group(ps))
    return out


def reducescatter_array(x: torch.Tensor, ps,
                        op: str = ReduceOp.AVERAGE) -> torch.Tensor:
    """The reduction of every rank's ``x``; rank ``i`` keeps rows
    ``[i·d0/n, (i+1)·d0/n)`` of dim 0."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"reducescatter unsupported op {op}")
    n = ps.size()
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"reducescatter dim-0 {tuple(x.shape)[:1]} not "
                         f"divisible by {n}")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=_group(ps))
    if op == ReduceOp.AVERAGE:
        _average_(out, n)
    return out


def barrier(ps, device: torch.device) -> None:
    """Block the ranks of ``ps`` until all have reached it (NCCL needs the
    device the barrier's token lives on)."""
    if dist.get_backend(_group(ps)) == "nccl":
        dist.barrier(group=ps.group, device_ids=[device.index])
    else:
        dist.barrier(group=ps.group)
