"""``hvd.SyncBatchNorm``: a ``_BatchNorm`` drop-in with statistics over
every rank.

Counterpart: the JAX package's torch adapter,
``horovod_tpu/torch/sync_batch_norm.py`` (reference:
``horovod/torch/sync_batch_norm.py``).  Per-rank sums, squared sums and
counts are combined with one engine allreduce in the forward pass, and the
hand-written backward reduces its two input-gradient terms with one more,
so small per-rank batches train as one large batch would.  torch's
conventions hold here, as in ``torch.nn.BatchNorm*``: ``momentum`` is the
weight of the new value (``None``: a cumulative average), the running
variance is unbiased, and ``affine=False`` and
``track_running_stats=False`` work.  The functional form with the JAX
package's conventions is ``ops/sync_batch_norm.py``.
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from . import runtime
from .api import allreduce


def _allreduce_sum(t: torch.Tensor, name: str) -> torch.Tensor:
    return allreduce(t, op=runtime.Sum, name=name)


def _affine(y, weight, bias):
    if weight is not None:
        y = y * weight[None, :, None]
    if bias is not None:
        y = y + bias[None, :, None]
    return y


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                eps, momentum, training):
        use_batch_stats = training or running_mean is None
        if not use_batch_stats:
            mean, var = running_mean, running_var
            inv = torch.rsqrt(var + eps)
        else:
            C = x.shape[1]
            # fp32 statistics whatever the activation dtype; the count
            # row takes red's dtype and device
            red = x.transpose(0, 1).reshape(C, -1).to(torch.float32)
            local = torch.stack([red.sum(1), (red * red).sum(1),
                                 red.new_full((C,), float(red.shape[1]))])
            tot = _allreduce_sum(local, "sbn.stats")
            count = tot[2]
            mean = tot[0] / count
            var = tot[1] / count - mean * mean           # biased
            inv = torch.rsqrt(var + eps)
            if training and running_mean is not None:
                n = count[0]
                unbiased = var * n / (n - 1) if n > 1 else var
                # the statistics are fp32; the running buffers keep their
                # own dtype (half() modules have fp16 buffers)
                running_mean.mul_(1 - momentum).add_(
                    (momentum * mean).to(running_mean.dtype))
                running_var.mul_(1 - momentum).add_(
                    (momentum * unbiased).to(running_var.dtype))

        ctx.save_for_backward(
            x, weight if weight is not None else torch.ones(0),
            mean, inv,
            count if use_batch_stats else torch.tensor(0.0))
        # gradients flow through the statistics whenever batch statistics
        # were used (training, or eval without running statistics)
        ctx.use_batch_stats = use_batch_stats
        ctx.has_weight = weight is not None
        ctx.has_bias = bias is not None
        y = (x - mean[None, :, None]) * inv[None, :, None]
        return _affine(y, weight, bias).to(x.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, mean, inv, count = ctx.saved_tensors
        C = x.shape[1]
        xhat = (x - mean[None, :, None]) * inv[None, :, None]
        g = grad_out
        scale = inv[None, :, None]
        if ctx.has_weight:
            scale = scale * weight[None, :, None]
        grad_weight = ((g * xhat).transpose(0, 1).reshape(C, -1).sum(1)
                       .to(weight.dtype) if ctx.has_weight else None)
        grad_bias = (g.transpose(0, 1).reshape(C, -1).sum(1)
                     .to(weight.dtype) if ctx.has_bias else None)
        if not ctx.use_batch_stats:
            return ((g * scale).to(x.dtype), grad_weight, grad_bias, None,
                    None, None, None, None)
        # local reductions over batch and space, then one cross-rank sum
        local = torch.stack([
            g.transpose(0, 1).reshape(C, -1).sum(1),            # Σg
            (g * xhat).transpose(0, 1).reshape(C, -1).sum(1),   # Σg·x̂
        ])
        tot = _allreduce_sum(local, "sbn.grads")
        sum_g = tot[0] / count
        sum_gx = tot[1] / count
        gx = scale * (g - sum_g[None, :, None]
                      - xhat * sum_gx[None, :, None])
        return (gx.to(x.dtype), grad_weight, grad_bias, None, None, None,
                None, None)


class SyncBatchNorm(_BatchNorm):
    """Drop-in ``nn.BatchNorm*`` with cross-rank statistics (reference:
    ``hvd.SyncBatchNorm``); needs ``hvd.init()``."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {x.dim()}D")

    def forward(self, x):
        self._check_input_dim(x)
        orig_shape = x.shape
        if x.dim() == 2:
            x = x[:, :, None]
        elif x.dim() > 3:
            x = x.reshape(x.shape[0], x.shape[1], -1)

        # momentum=None: cumulative moving average (torch's semantics)
        momentum = self.momentum
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
            if momentum is None:
                momentum = 1.0 / float(self.num_batches_tracked)
        elif momentum is None:
            momentum = 0.0

        if runtime.size() == 1 and self.training:
            # one rank: plain batch norm is the same and cheaper
            out = torch.nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, True, momentum, self.eps)
            return out.reshape(orig_shape)
        out = _SyncBatchNormFn.apply(
            x, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, momentum, self.training)
        return out.reshape(orig_shape)
