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

Adasum (``ops/adasum.py``) reduces a bucket by one all-gather and a
combining tree.  A process set with a hierarchy
(``runtime.ProcessSet.hier_shape``) reduces a bucket in three stages
(:func:`hierarchical_allreduce`, JAX ``_hier_allreduce_fn``): a
reduce-scatter within each host, the cross-host reduction of the chunk,
an all-gather within each host; under a quantized wire only the cross
stage is quantized.  The cross stage takes a straggler policy
(``HOROVOD_TAIL_POLICY``, :data:`TAIL_POLICIES`): each dispatch runs one
:func:`tail_round`, which decides from the ``collective.dcn`` chaos site
which hosts made ``HOROVOD_TAIL_DEADLINE_MS`` and waits accordingly, and
:func:`tail_cross_reduce` does the policy's arithmetic (JAX
``tail_allreduce_p``) after the ranks agree on the mask with an
allreduce-MIN over the whole set.  :func:`hierarchical_allgather` gathers
within each host, then across hosts.

The in-step forms :func:`allreduce_p`, :func:`allgather_p`,
:func:`broadcast_p`, :func:`alltoall_p` and :func:`reducescatter_p` (JAX's
traceable ``*_p`` for use inside ``shard_map``) run over a named axis of
the current ``ParallelMesh`` through ``parallel/axis.py``, differentiable
where JAX's are.

Every ``torch.distributed`` call here reports to the schedule recorder
first (``analysis/recorder.py``; one flag test when it is not armed).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import chaos as _chaos
from .. import metrics as _metrics
from ..analysis import recorder as _rec
from .. import tracing as _tracing
from ..compression import (WireFormat, dequantize_blocks, dequantize_sum,
                           quantization_error, quantize_blocks)
from ..config import TAIL_POLICIES
from ..runtime import ReduceOp

_m_tail_rounds = _metrics.counter(
    "hvd_tail_rounds_total",
    "DCN tail rounds of the hierarchical reduce, by effective policy",
    labels=("policy",))

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
                     wire: Optional[WireFormat] = None,
                     hierarchical: bool = False,
                     tail_policy: str = "strict",
                     tail_names: Sequence[str] = ("allreduce",)
                     ) -> List[torch.Tensor]:
    """Fused allreduce of one bucket (tensors of one dtype) over ``ps``.

    ``inplace`` writes the results into ``tensors`` and returns them;
    otherwise the results are views of one new flat buffer.  ``mark``, when
    given, is called with ``"pack"``, ``"reduce"`` and ``"unpack"`` as each
    phase begins and with ``"end"`` after the last (the engine's device
    timing).  ``wire`` quantizes the bucket (Sum or Average only, no error
    feedback: the eager path carries no state), as the JAX engine does.
    Adasum combines the bucket's vector (``ops/adasum.py``).

    ``hierarchical`` (a Sum or Average over a set with a hierarchy) runs
    :func:`hierarchical_allreduce`: ``wire`` then quantizes its cross
    stage only, and ``tail_policy`` is that stage's straggler policy;
    ``tail_names`` are the bucket's tensor names, which name its tail
    rounds and key its stale state.
    """
    if op not in _DIST_OPS and op != ReduceOp.ADASUM:
        raise ValueError(f"unsupported reduce op: {op}")
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("a fused allreduce takes tensors of one dtype")
    if hierarchical and op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"a hierarchical allreduce sums; got op {op!r}")
    mark = mark or (lambda phase: None)
    if op == ReduceOp.ADASUM:
        from .adasum import adasum_arrays
        mark("reduce")
        outs = adasum_arrays(tensors, ps, prescale_factor, postscale_factor)
        if inplace:
            torch._foreach_copy_(list(tensors), outs)
            outs = list(tensors)
        mark("end")
        return outs
    group = _group(ps)
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
    if hierarchical:
        flat.copy_(hierarchical_allreduce(flat, ps, op, wire=wire,
                                          tail_policy=tail_policy,
                                          tail_names=tail_names))
    elif wire is not None:
        flat.copy_(quantized_allreduce(flat, ps, wire, op=op)[0])
    else:
        if _rec.ARMED:
            _rec.note(_rec.PRIM_OF_OP[op], ps, [flat], [flat],
                      bucket=_rec.engine_bucket(), axis_index_groups=None)
        dist.all_reduce(flat, op=_DIST_OPS[op], group=group)
    mark("unpack")
    if op == ReduceOp.AVERAGE and wire is None and not hierarchical:
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
    if _rec.ARMED:
        _rec.reduce("sum", ps, out)
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
    if _rec.ARMED:
        _rec.gather(ps, x, x.new_empty((n * mx,) + tuple(x.shape[1:]),
                                       device="meta"))
    dist.all_gather(outs, x, group=group)
    return torch.cat([o[:r] for o, r in zip(outs, rows)])


def hierarchical_allgather(x: torch.Tensor, ps) -> torch.Tensor:
    """Every rank's ``x`` (one dim-0 size on every rank) concatenated in
    rank order, in two stages: within each host, then across hosts (JAX
    ``_hier_allgather_fn``; HOROVOD_HIERARCHICAL_ALLGATHER)."""
    if x.dim() == 0:
        raise ValueError("allgather needs a tensor of at least one dim")
    local, cross = ps.hier_groups()
    host = all_gather_flat(x.contiguous().view(-1), local)
    return all_gather_flat(host, cross).view(
        (-1,) + tuple(x.shape[1:]))


def broadcast_array(x: torch.Tensor, root_rank: int, ps,
                    inplace: bool = False) -> torch.Tensor:
    """Rank ``root_rank`` (within ``ps``)'s ``x`` on every rank."""
    if not 0 <= root_rank < ps.size():
        raise ValueError(f"root_rank {root_rank} outside the process set "
                         f"of {ps.size()} ranks")
    out = x if inplace and x.is_contiguous() else x.contiguous().clone()
    if _rec.ARMED:
        _rec.broadcast(ps, out, root_rank)
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
    if _rec.ARMED:
        _rec.exchange(ps, x, out)
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
    if _rec.ARMED:
        _rec.scatter(ps, x, out)
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
    if n == 1:
        return buf.clone()
    out = buf.new_empty(buf.numel() // n)
    if _rec.ARMED:
        _rec.scatter(ps, buf, out)
    _run_flat(lambda o, i, group: dist.reduce_scatter_tensor(
        o, i, op=dist.ReduceOp.SUM, group=group),
        out, buf.contiguous(), _group(ps))
    return out


def all_gather_flat(tile: torch.Tensor, ps) -> torch.Tensor:
    """Every rank's 1-D ``tile`` concatenated in rank order (JAX
    ``all_gather(..., tiled=True)``)."""
    if ps.size() == 1:
        return tile.clone()
    out = tile.new_empty(tile.numel() * ps.size())
    if _rec.ARMED:
        _rec.gather(ps, tile, out)
    _run_flat(lambda o, i, group: dist.all_gather_into_tensor(
        _on_wire(o), _on_wire(i), group=group),
        out, tile.contiguous(), _group(ps))
    return out


def _all_to_all_flat(x: torch.Tensor, ps) -> torch.Tensor:
    """Equal 1-D chunks: chunk ``j`` of every rank goes to rank ``j``."""
    out = torch.empty_like(x)
    if _rec.ARMED:
        _rec.exchange(ps, x, out)
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
        residual = quantization_error(flat, q, s, fmt)
    qx = _all_to_all_flat(q, ps)
    sx = _all_to_all_flat(s, ps)
    return dequantize_sum(qx, sx, fmt, n), residual


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


# ---------------------------------------------------------------------------
# the hierarchical allreduce and its tail-tolerant cross stage
# ---------------------------------------------------------------------------

#: Per-bucket stale state: ``(prev, staleness)``, the previous round's
#: agreed per-host chunks ``[n_cross, chunk]`` and the consecutive
#: substitution counters (int32 ``[n_cross]``), keyed by the bucket's
#: signature and tensor names (JAX ``_TAIL_STATE``).  Cleared at
#: ``hvd.init()``.
_TAIL_STATE: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

#: The latest tail rounds, oldest first: ``name``, ``policy``, the
#: ``excluded`` host groups, the planned ``wait_s`` and the ``seconds``
#: the round took on the wall clock.  Cleared at ``hvd.init()``.
TAIL_ROUNDS: "collections.deque[dict]" = collections.deque(maxlen=4096)


def reset_tail_state() -> None:
    _TAIL_STATE.clear()
    TAIL_ROUNDS.clear()


def _check_policy(tail_policy: str) -> None:
    if tail_policy not in TAIL_POLICIES:
        raise ValueError(f"tail_policy must be one of {TAIL_POLICIES}, "
                         f"got {tail_policy!r}")


def plan_tail_round(name: str, tail_policy: str, n_groups: int,
                    deadline_s: float, max_staleness: int = 0,
                    staleness=None, stall=None, group_ranks=None):
    """Decide one cross-host tail round: which host groups count, and how
    long the round waits on the wall clock (JAX ``plan_tail_round``; pure,
    it does not sleep).

    A group's lateness comes from the ``collective.dcn`` chaos site
    (``action=delay:<s>``: its contribution arrives that late;
    ``action=drop``: never this round); without a schedule every group is
    on time.  ``strict`` waits out the slowest group and raises
    ``ChaosConnectionError`` on a drop; ``bounded`` and ``stale`` exclude
    (mask 0) the groups later than ``deadline_s`` and then wait the
    deadline, except that under ``stale`` a group whose ``staleness`` has
    reached ``max_staleness`` is waited out.  Each group's lateness (a
    drop counts as the deadline) feeds ``stall.note_lateness`` for every
    rank of ``group_ranks[g]`` (default: the group index itself).

    Returns ``(present, wait_s, lateness)``: the float32 mask, the wait
    and the per-group lateness.
    """
    _check_policy(tail_policy)
    lateness = [0.0] * n_groups
    dropped = [False] * n_groups
    if _chaos.ACTIVE:
        for g in range(n_groups):
            act = _chaos.fire("collective.dcn", name=name, group=g,
                              policy=tail_policy,
                              _defer=("delay", "drop"))
            if act is None:
                continue
            if act.kind == "delay":
                lateness[g] = act.arg_float(0.05)
            elif act.kind == "drop":
                dropped[g] = True
    present = np.ones((n_groups,), np.float32)
    if tail_policy == "strict":
        if any(dropped):
            raise _chaos.ChaosConnectionError(
                f"chaos: DCN contribution of groups "
                f"{[g for g in range(n_groups) if dropped[g]]} dropped "
                f"at collective.dcn ({name})")
        wait_s = max(lateness) if lateness else 0.0
    else:
        waited = []
        deadline_fired = False
        for g in range(n_groups):
            late = float("inf") if dropped[g] else lateness[g]
            at_cap = (tail_policy == "stale" and staleness is not None
                      and int(staleness[g]) >= max_staleness)
            if late > deadline_s and not at_cap:
                present[g] = 0.0
                deadline_fired = True
            else:
                # waited out: on time, or stale-capped (the cap beats a
                # drop: the round blocks until the host answers)
                waited.append(min(late, deadline_s)
                              if not at_cap else lateness[g])
        wait_s = max(waited) if waited else 0.0
        if deadline_fired:
            wait_s = max(wait_s, deadline_s)
    if stall is not None:
        for g in range(n_groups):
            obs = (max(lateness[g], deadline_s) if dropped[g]
                   else lateness[g])
            for r in (group_ranks[g] if group_ranks is not None else (g,)):
                stall.note_lateness(r, obs)
    return present, wait_s, lateness


def tail_round(name: str, tail_policy: str, n_groups: int,
               deadline_s: float, max_staleness: int = 0,
               staleness=None, stall=None, group_ranks=None,
               feed_health: bool = True):
    """One cross-host tail round: plan it (:func:`plan_tail_round`), feed
    a ``stale`` round's substitution counters to the training-health
    plane (``health.note_staleness``; unless ``feed_health`` is False,
    when the caller's taps observe them), wait the planned time, count
    it (``hvd_tail_rounds_total{policy}``), record it in
    :data:`TAIL_ROUNDS` and, under ``HOROVOD_TRACE``, as a ``dcn`` span
    (the phase the critical path pivots on: the policy, the deadline, the
    excluded host groups and each group's lateness), and return the
    mask."""
    t0 = time.monotonic()
    t_span = _tracing.now() if _tracing.ACTIVE else 0.0
    present, wait_s, lateness = plan_tail_round(
        name, tail_policy, n_groups, deadline_s,
        max_staleness=max_staleness, staleness=staleness, stall=stall,
        group_ranks=group_ranks)
    if tail_policy == "stale" and staleness is not None and feed_health:
        # counters AT the cap mean that group's staleness budget is spent
        # (one false branch when HOROVOD_HEALTH=0)
        from .. import health as _health
        if _health.ACTIVE:
            _health.note_staleness(name, staleness, max_staleness)
    if _metrics.ACTIVE:
        _m_tail_rounds.inc(policy=tail_policy)
    if wait_s > 0:
        time.sleep(wait_s)
    excluded = [g for g in range(n_groups) if present[g] == 0.0]
    TAIL_ROUNDS.append({
        "name": name, "policy": tail_policy, "excluded": excluded,
        "wait_s": float(wait_s), "seconds": time.monotonic() - t0})
    if _tracing.ACTIVE:
        _tracing.span(
            "dcn", name, t_span, _tracing.now(), policy=tail_policy,
            deadline_s=float(deadline_s), wait_s=round(float(wait_s), 6),
            excluded=excluded,
            lateness=[round(float(v), 6) for v in lateness])
    return present


def _tail_params():
    """(deadline_s, max_staleness, stall inspector) from the runtime."""
    from .. import runtime
    st = runtime._state()
    cfg = st.config
    deadline_s = cfg.tail_deadline_ms / 1000.0 if cfg is not None else 0.25
    max_stal = cfg.tail_max_staleness if cfg is not None else 4
    return deadline_s, max_stal, st.stall_inspector


def _agree_min(mask: torch.Tensor, ps, device: torch.device) -> torch.Tensor:
    """The elementwise minimum of every rank's ``mask`` over ``ps``: a
    host counts only if every rank has it (JAX ``pmin`` over both
    axes)."""
    group = _group(ps)
    t = (mask.to(device) if dist.get_backend(group) == "nccl"
         else mask.clone())
    if _rec.ARMED:
        # one agreement over the whole set: both axes of its hierarchy
        hier = getattr(ps, "hier_shape", lambda: None)()
        _rec.reduce("min", ps, t, axis=("workers", "hvd_local")
                    if hier is not None else None)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t.cpu()


def _sum_over(chunk: torch.Tensor, cross, wire: Optional[WireFormat]
              ) -> torch.Tensor:
    """The sum of ``chunk`` over ``cross``, full width or quantized."""
    if wire is not None:
        return quantized_allreduce(chunk, cross, wire, op=ReduceOp.SUM)[0]
    out = chunk.clone()
    if _rec.ARMED:
        _rec.reduce("sum", cross, out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(cross))
    return out


def _gather_rows(chunk: torch.Tensor, cross, wire: Optional[WireFormat]
                 ) -> torch.Tensor:
    """Every host's ``chunk`` as the rows of ``[n_cross, len]``, full width
    or through the quantized wire (each row as its host quantized it)."""
    n = cross.size()
    if wire is None:
        return all_gather_flat(chunk, cross).view(n, -1)
    pad = (-chunk.numel()) % wire.block_size
    padded = (torch.cat([chunk, chunk.new_zeros(pad)]) if pad else chunk)
    q, s = quantize_blocks(padded, wire)
    deq = dequantize_blocks(all_gather_flat(q, cross),
                            all_gather_flat(s, cross), wire).view(n, -1)
    return deq[:, :chunk.numel()].to(chunk.dtype)


def tail_cross_reduce(chunk: torch.Tensor, cross, tail_policy: str,
                      present=None, agree=None, prev=None, staleness=None,
                      max_staleness: int = 0,
                      wire: Optional[WireFormat] = None):
    """The sum of ``chunk`` over the cross group ``cross`` under a
    straggler policy (the eager counterpart of JAX ``tail_allreduce_p``).

    ``present`` is the round's float32 mask over the cross group; it is
    first agreed over ``agree`` (the whole process set) as an
    allreduce-MIN, so every rank sums the same contributions.

    * ``strict``: the plain (or quantized) sum; ``present`` is ignored.
    * ``bounded``: this host's contribution is zeroed when it is masked,
      the rest summed and multiplied by n/k when k < n hosts are present;
      an all-ones round is bit for bit ``strict``.
    * ``stale``: the chunks are all-gathered, a missing host's row is its
      ``prev`` row, hosts at ``max_staleness`` count as present, and the
      counters of the substituted hosts advance.

    Returns ``(reduced, new_prev, new_staleness)``; the state is None
    except under ``stale``.
    """
    _check_policy(tail_policy)
    if tail_policy == "strict":
        return _sum_over(chunk, cross, wire), None, None
    n = cross.size()
    if present is None:
        raise ValueError(
            f"tail_policy={tail_policy!r} needs a participation mask "
            f"(present=[{n}] floats; all ones = no deadline fired)")
    m = torch.as_tensor(np.asarray(present, np.float32))
    if agree is not None:
        m = _agree_min(m, agree, chunk.device)
    if tail_policy == "bounded":
        own = float(m[cross.rank()])
        red = _sum_over(chunk * torch.tensor(own).to(chunk.dtype), cross,
                        wire)
        k = float(m.sum())
        if k < n:
            # the n/k correction in fp32, cast to the dtype (JAX: a full
            # round skips it, so it stays bit for bit strict)
            _scale_(red, float(torch.tensor(float(n)) /
                               torch.tensor(max(k, 1.0))))
        return red, None, None
    if prev is None or staleness is None:
        raise ValueError(
            "tail_policy='stale' carries per-bucket state: pass prev "
            f"([{n}, len(chunk)] previous-round chunks) and staleness "
            f"(int32 [{n}]), zeros on the first round")
    staleness = torch.as_tensor(staleness, dtype=torch.int32)
    if max_staleness >= 0:
        m = torch.where(staleness >= max_staleness, torch.ones_like(m), m)
    rows = _gather_rows(chunk, cross, wire)
    keep = (m > 0).to(chunk.device)[:, None]
    eff = torch.where(keep, rows, prev.to(chunk.dtype))
    new_staleness = torch.where(m > 0, torch.zeros_like(staleness),
                                staleness + 1)
    return eff.sum(dim=0), eff, new_staleness


def hierarchical_allreduce(flat: torch.Tensor, ps, op: str = ReduceOp.SUM,
                           wire: Optional[WireFormat] = None,
                           tail_policy: str = "strict",
                           tail_names: Sequence[str] = ("allreduce",),
                           staleness_hook=None) -> torch.Tensor:
    """Sum or average of a 1-D ``flat`` over ``ps`` in three stages (JAX
    ``_hier_allreduce_fn``, after NCCLHierarchicalAllreduce): zero-padded
    to a multiple of the host size, reduce-scattered within each host; the
    chunk reduced across hosts (quantized when ``wire`` is given, under
    ``tail_policy``, one :func:`tail_round` a call, which also runs under
    ``strict`` when chaos or metrics are on); all-gathered within each
    host, unpadded, divided by the set's size for Average.  Returns a new
    tensor of ``flat``'s length and dtype.

    ``tail_names`` are the bucket's tensor names: the first names the tail
    round, all of them key the bucket's ``stale`` state, with its
    signature.  ``staleness_hook(counters, cap)``, when given, receives a
    ``stale`` round's new substitution counters in place of the tail
    round's own health feed (the transform's taps).
    """
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"a hierarchical allreduce sums; got op {op!r}")
    _check_policy(tail_policy)
    n_cross, n_local = ps.hier_shape()
    local, cross = ps.hier_groups()
    total = flat.numel()
    pad = (-total) % n_local
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunk = reduce_scatter_flat(flat, local)
    deadline_s, max_stal, stall = _tail_params()
    groups = [ps.ranks[g * n_local:(g + 1) * n_local]
              for g in range(n_cross)]
    name = tail_names[0]
    if tail_policy == "strict":
        if _chaos.ACTIVE or _metrics.ACTIVE:
            # strict rounds observe injected arrival delays too (they wait
            # them out) and count toward the round metric
            tail_round(name, "strict", n_cross, deadline_s, stall=stall,
                       group_ranks=groups)
        chunk = _sum_over(chunk, cross, wire)
    elif tail_policy == "bounded":
        present = tail_round(name, "bounded", n_cross, deadline_s,
                             stall=stall, group_ranks=groups)
        chunk = tail_cross_reduce(chunk, cross, "bounded", present, ps,
                                  wire=wire)[0]
    else:
        key = (ps.process_set_id, tuple(ps.ranks), op, str(flat.dtype),
               total, None if wire is None else (wire.name,
                                                 wire.block_size),
               tuple(tail_names))
        state = _TAIL_STATE.get(key)
        if state is None:
            state = (chunk.new_zeros((n_cross, chunk.numel())),
                     torch.zeros((n_cross,), dtype=torch.int32))
        present = tail_round(name, "stale", n_cross, deadline_s,
                             max_staleness=max_stal,
                             staleness=state[1].tolist(), stall=stall,
                             group_ranks=groups,
                             feed_health=staleness_hook is None)
        chunk, prev, stal = tail_cross_reduce(
            chunk, cross, "stale", present, ps, prev=state[0],
            staleness=state[1], max_staleness=max_stal, wire=wire)
        _TAIL_STATE[key] = (prev, stal)
        if staleness_hook is not None:
            staleness_hook(stal.tolist(), max_stal)
    red = all_gather_flat(chunk, local)[:total]
    if op == ReduceOp.AVERAGE:
        _average_(red, ps.size())
    return red


# ---------------------------------------------------------------------------
# in-step forms over a named axis of the current mesh (JAX's *_p)
# ---------------------------------------------------------------------------

def allreduce_p(x: torch.Tensor, axis_name: str,
                op: str = ReduceOp.AVERAGE) -> torch.Tensor:
    """The reduction of ``x`` over mesh axis ``axis_name`` (JAX
    ``allreduce_p``): Sum and Average (and Adasum, as a sum) through the
    differentiable ``psum``, Min and Max without a gradient, Product by a
    gather."""
    from ..parallel import axis as ax
    n = ax.axis_size(axis_name)
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        r = ax.psum(x, axis_name)
        if op == ReduceOp.AVERAGE:
            r = (r / n if r.is_floating_point()
                 else torch.div(r, n, rounding_mode="floor"))
        return r
    if op in (ReduceOp.MIN, ReduceOp.MAX):
        g = ax._group(axis_name)
        return x.detach() if g is None else ax._all_reduce(
            x, g, axis_name, _DIST_OPS[op])
    if op == ReduceOp.PRODUCT:
        return torch.prod(ax.all_gather(x, axis_name, tiled=False), dim=0)
    raise ValueError(f"unsupported reduce op: {op}")


def allgather_p(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Every rank's ``x`` along dim 0 in rank order (a 0-d ``x`` gives
    ``[n]``)."""
    from ..parallel import axis as ax
    g = ax.all_gather(x, axis_name, tiled=False)
    return g.reshape((-1,) + tuple(g.shape[2:])) if x.dim() else g


def broadcast_p(x: torch.Tensor, root_rank: int,
                axis_name: str) -> torch.Tensor:
    """Rank ``root_rank``'s ``x`` on every rank of the axis, as the sum of
    the root's value and everyone else's zeros."""
    from ..parallel import axis as ax
    keep = ax.axis_index(axis_name) == root_rank
    return ax.psum(x if keep else torch.zeros_like(x), axis_name)


def alltoall_p(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Chunk ``j`` of dim 0 to rank ``j``, received in rank order."""
    from ..parallel import axis as ax
    return ax.all_to_all(x, axis_name, split_axis=0, concat_axis=0)


def reducescatter_p(x: torch.Tensor, axis_name: str,
                    op: str = ReduceOp.AVERAGE) -> torch.Tensor:
    """The sum (or average) over the axis; rank ``i`` keeps slice ``i`` of
    dim 0."""
    from ..parallel import axis as ax
    out = ax.psum_scatter(x, axis_name, scatter_dimension=0)
    if op == ReduceOp.AVERAGE:
        out = out / ax.axis_size(axis_name)
    return out
