"""Synchronized batch normalization over a process set, as functions.

Counterpart: ``horovod_tpu/ops/sync_batch_norm.py``.  The batch statistics
come from local sums and one cross-rank sum of the stacked ``[sum,
sq_sum]`` pair.  JAX's autodiff derives the backward pass there because
the transpose of ``psum`` is ``psum``; here the sum is one
``torch.autograd.Function`` whose backward sums the cotangent over the same
ranks, and autograd derives the rest.  fp32 statistics whatever the
activation dtype.

The JAX package's conventions hold, not ``torch.nn.BatchNorm``'s (for
those, :class:`horovod_tpu_torch.SyncBatchNorm`): ``momentum`` is the decay
of the old running value, the running variance takes the biased batch
variance, and the count is the local count times the set's size.  The
statistics are over every axis but the channels, which are axis 1 (the
port's NCHW layout) where JAX keeps them last.  ``process_set`` takes the
place of JAX's ``axis_name``: ``None`` normalizes over the local batch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import collectives


class _AllreduceSum(torch.autograd.Function):
    """``lax.psum`` over a process set: the sum forward, and the sum of the
    cotangent backward (psum's transpose)."""

    @staticmethod
    def forward(ctx, x, ps):
        ctx.ps = ps
        return collectives.allreduce_sum(x, ps)

    @staticmethod
    def backward(ctx, g):
        return collectives.allreduce_sum(g, ctx.ps), None


def sync_batch_stats(x: torch.Tensor, axes: Sequence[int] = (0, 2, 3),
                     process_set=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance of ``x`` over ``axes``, synchronized across
    ``process_set`` (one sum of the stacked ``[sum, sq_sum]`` pair).

    Returns fp32 ``(mean, var)`` shaped like the remaining axes.
    """
    x32 = x.float()
    axes = tuple(axes)
    local = torch.stack([x32.sum(axes), (x32 * x32).sum(axes)])
    count = x.numel() / local[0].numel()
    if process_set is not None:
        local = _AllreduceSum.apply(local, process_set)
        count = count * process_set.size()
    s, sq = local
    mean = s / count
    var = sq / count - mean * mean
    return mean, var


def sync_batch_norm(x: torch.Tensor, scale, bias, running_mean, running_var,
                    process_set=None, train: bool = True,
                    momentum: float = 0.9, eps: float = 1e-5):
    """Batch-normalize ``x`` (``[B, C, ...]``, statistics over all but axis
    1).

    Train mode computes the statistics over the set's batch and returns
    updated running statistics; eval mode normalizes with the running
    statistics and returns them unchanged.

    Returns ``(y, new_running_mean, new_running_var)``: y in x's dtype and
    the running statistics in fp32, detached from the graph.
    """
    axes = (0,) + tuple(range(2, x.dim()))
    if train:
        mean, var = sync_batch_stats(x, axes, process_set)
        with torch.no_grad():
            new_mean = momentum * running_mean + (1.0 - momentum) * mean
            new_var = momentum * running_var + (1.0 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var + eps) * scale.float()
    y = ((x.float() - mean.view(shape)) * inv.view(shape)
         + bias.float().view(shape))
    return y.to(x.dtype), new_mean, new_var
