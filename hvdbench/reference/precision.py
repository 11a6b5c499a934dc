"""The lower-precision control's matrix product.

The references compute with ``torch.matmul`` in fp32.  :class:`Fp8Matmul`
is the control's: both operands of every product, forward and
backward, are rounded to fp8 e4m3 with one scale a tensor (its largest
magnitude onto e4m3's largest finite value, 448), and the product of the
rounded values is summed in fp32, as an fp8 tensor-core product would.
fp8 is the precision below bf16, the compute precision the benchmark's
configurations state.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to e4m3 under a per-tensor scale, in fp32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # broadcast batch dims of b (a weight shared over the batch) sum out
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db


class Fp8Matmul:
    """The control's product (see the module docstring)."""

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Product.apply(a, b)
