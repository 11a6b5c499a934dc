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

The distributed optimizer's planned buckets (``optim/distributed.py``,
``optim/overlap.py``) call the flat forms below directly, in their static
plan order, as the JAX package's in-jit ``*_p`` forms run inside the
compiled step: :func:`reduce_scatter_flat`, :func:`all_gather_flat` and
the quantized staging (JAX ``quantized_sum_scatter_p``,
``quantized_all_gather_p``, ``quantized_allreduce_p``).  Over gloo, CUDA
tensors of these flat forms travel through host memory.  Synchronized
batch norm (``ops/sync_batch_norm.py``) sums its statistics with
:func:`allreduce_sum`, as the JAX package's ``lax.psum`` inside the step.

Not here yet: the tail-policy and hierarchical paths and Adasum (ROADMAP.md
A5), and the model-parallel forms (A6).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..compression import WireFormat, dequantize_blocks, quantize_blocks
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
                     mark: Optional[Callable[[str], None]] = None,
                     wire: Optional[WireFormat] = None
                     ) -> List[torch.Tensor]:
    """Fused allreduce of one bucket (tensors of one dtype) over ``ps``.

    ``inplace`` writes the results into ``tensors`` and returns them;
    otherwise the results are views of one new flat buffer.  ``mark``, when
    given, is called with ``"pack"``, ``"reduce"`` and ``"unpack"`` as each
    phase begins and with ``"end"`` after the last (the engine's device
    timing).  ``wire`` quantizes the bucket (Sum or Average only, no error
    feedback: the eager path carries no state), as the JAX engine does.
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
    if wire is not None:
        flat.copy_(quantized_allreduce(flat, ps, wire, op=op)[0])
    else:
        dist.all_reduce(flat, op=_DIST_OPS[op], group=group)
    mark("unpack")
    if op == ReduceOp.AVERAGE and wire is None:
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


def allreduce_sum(x: torch.Tensor, ps) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``ps``, as a new tensor, on the
    calling thread (JAX ``lax.psum`` inside a program; the engine is not
    involved): for collectives inside a model's forward or backward."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(ps))
    return out


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


# ---------------------------------------------------------------------------
# flat forms of the planned buckets, and the quantized staging
# ---------------------------------------------------------------------------

def _on_wire(x: torch.Tensor) -> torch.Tensor:
    """fp8 payloads travel as bytes: not every backend reduces or moves
    the fp8 dtypes."""
    return x.view(torch.uint8) if x.element_size() == 1 \
        and x.is_floating_point() else x


def _run_flat(fn, out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``fn(out, inp, group=group)``; over gloo a CUDA pair goes through
    host memory."""
    if inp.is_cuda and dist.get_backend(group) == "gloo":
        host = out.cpu()
        fn(host, inp.cpu(), group=group)
        out.copy_(host)
    else:
        fn(out, inp, group=group)


def reduce_scatter_flat(buf: torch.Tensor, ps) -> torch.Tensor:
    """The sum over the ranks of a 1-D ``buf`` whose length divides by
    the set's size; rank ``i`` gets the ``i``-th slice (JAX
    ``psum_scatter(..., tiled=True)``)."""
    n = ps.size()
    out = buf.new_empty(buf.numel() // n)
    _run_flat(lambda o, i, group: dist.reduce_scatter_tensor(
        o, i, op=dist.ReduceOp.SUM, group=group),
        out, buf.contiguous(), _group(ps))
    return out


def all_gather_flat(tile: torch.Tensor, ps) -> torch.Tensor:
    """Every rank's 1-D ``tile`` concatenated in rank order (JAX
    ``all_gather(..., tiled=True)``)."""
    out = tile.new_empty(tile.numel() * ps.size())
    _run_flat(lambda o, i, group: dist.all_gather_into_tensor(
        _on_wire(o), _on_wire(i), group=group),
        out, tile.contiguous(), _group(ps))
    return out


def _all_to_all_flat(x: torch.Tensor, ps) -> torch.Tensor:
    """Equal 1-D chunks: chunk ``j`` of every rank goes to rank ``j``."""
    out = torch.empty_like(x)
    _run_flat(lambda o, i, group: dist.all_to_all_single(
        _on_wire(o), _on_wire(i), group=group),
        out, x.contiguous(), _group(ps))
    return out


def quantized_sum_scatter(flat: torch.Tensor, ps, fmt: WireFormat,
                          error_feedback: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Reduce-scatter of a quantized 1-D buffer with fp32 accumulation
    (JAX ``quantized_sum_scatter_p``).

    ``flat`` is this rank's contribution, its length a multiple of
    ``size * fmt.block_size`` (callers pad with zeros).  Every rank's
    quantized tile of this rank's slice, and its scales, arrive by one
    all-to-all each and are dequantized and summed in fp32.  Returns the
    fp32 sum tile and, with ``error_feedback``, this rank's quantization
    error ``flat - dequantize(quantize(flat))`` (else None).
    """
    n = ps.size()
    q, s = quantize_blocks(flat, fmt)
    residual = None
    if error_feedback:
        residual = flat.float() - dequantize_blocks(q, s, fmt)
    qx = _all_to_all_flat(q, ps)
    sx = _all_to_all_flat(s, ps)
    deq = dequantize_blocks(qx, sx, fmt).reshape(n, -1)
    return deq.sum(dim=0), residual


def quantized_all_gather(tile: torch.Tensor, ps,
                         fmt: WireFormat) -> torch.Tensor:
    """All-gather of a quantized 1-D tile (length a multiple of
    ``fmt.block_size``): every rank dequantizes the same payloads, its own
    included, so the fp32 result is bit-identical everywhere.  No error
    feedback: the tile is already reduced and the same on every rank (JAX
    ``quantized_all_gather_p``)."""
    q, s = quantize_blocks(tile, fmt)
    return dequantize_blocks(all_gather_flat(q, ps), all_gather_flat(s, ps),
                             fmt)


def quantized_allreduce(x: torch.Tensor, ps, fmt: WireFormat,
                        op: str = ReduceOp.SUM,
                        residual: Optional[torch.Tensor] = None,
                        error_feedback: bool = False,
                        denom: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sum or average of ``x`` over ``ps`` with a quantized wire: the
    sum-scatter and gather stages above, padded to a multiple of
    ``size * fmt.block_size`` (JAX ``quantized_allreduce_p``).

    ``residual`` (fp32, ``x``'s shape) is this rank's carried
    error-feedback term, added before quantization; with
    ``error_feedback`` the new one is returned.  Average divides the
    scattered tile by ``denom`` (default: the set's size) before the
    gather quantizes it.  Returns ``(reduced, new_residual_or_None)``,
    ``reduced`` in ``x``'s shape and dtype.
    """
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"quantized allreduce supports op=Sum/Average, got {op!r}")
    n = ps.size()
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    total = flat.numel()
    if residual is not None:
        flat = flat + residual.reshape(-1).float()
    pad = (-total) % (n * fmt.block_size)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    tile, new_res = quantized_sum_scatter(flat, ps, fmt,
                                          error_feedback=error_feedback)
    if op == ReduceOp.AVERAGE:
        tile = tile / (n if denom is None else denom)
    red = quantized_all_gather(tile, ps, fmt)[:total]
    if new_res is not None:
        new_res = new_res[:total].reshape(shape)
    return red.reshape(shape).to(dtype), new_res
