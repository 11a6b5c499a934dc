"""Mixture-of-Experts layer with expert parallelism (the ep mesh axis).

Counterpart: ``horovod_tpu/models/moe.py``.  GShard/Switch top-k routing
with a static capacity (overflow tokens drop), dispatch and combine as
one-hot einsums, and the experts sharded over the ``ep`` axis (by default
aliased onto dp) with two tiled all-to-alls per layer carrying tokens to
their experts and back (``parallel/axis.py``, whose backward exchange
sums each expert's gradient over the ep ranks).  Under tp the experts'
SwiGLU is column/row sharded like the dense MLP.

The einsums and the expert products are ``torch.einsum``: the JAX package
computes them outside any Pallas kernel, and the routing keeps its
arithmetic order (k sequential top-1 picks, a float one-hot cumsum plus
the running counts), so ``dispatch`` matches it bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..parallel import axis as ax


def init_moe_layer_params(gen: torch.Generator, n_layers: int, d_model: int,
                          d_ff: int, n_experts: int,
                          param_dtype=torch.float32, device=None
                          ) -> List[Dict[str, torch.Tensor]]:
    """Each layer's MoE params, drawn from ``gen`` layer by layer: the
    router ``[D, E]`` and the experts' SwiGLU ``we_gate``/``we_up
    [E, D, F]`` and ``we_down [E, F, D]``, normal over sqrt(fan-in)."""
    D, F_, E = d_model, d_ff, n_experts

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=param_dtype)
        return w.mul_(fan_in ** -0.5)

    return [{"router": norm((D, E), D),
             "we_gate": norm((E, D, F_), D),
             "we_up": norm((E, D, F_), D),
             "we_down": norm((E, F_, D), F_)} for _ in range(n_layers)]


def _top_k_dispatch(gates, k: int, capacity: int):
    """Dispatch and combine tensors from gate probabilities ``[N, E]``:
    ``(dispatch [N, E, C] one-hot, combine [N, E, C] weighted, aux)``.

    k sequential top-1 picks, each with its own position-in-expert cumsum
    offset by the earlier picks' counts; the combine weights normalized
    over the picked experts; the Switch Transformer load-balance loss."""
    N, E = gates.shape
    dt = gates.dtype
    remaining = gates
    counts = torch.zeros((E,), dtype=torch.int32, device=gates.device)
    dispatch = gates.new_zeros((N, E, capacity))
    combine = gates.new_zeros((N, E, capacity))
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                     # [N]
        onehot = F.one_hot(idx, E).to(dt)                         # [N, E]
        pos = (torch.cumsum(onehot, dim=0) - onehot
               + counts[None, :]) * onehot                        # [N, E]
        keep = (pos < capacity) * onehot
        slot = pos.sum(-1).to(torch.int64)
        # a dropped token's slot may lie past C (JAX's one_hot gives zeros
        # there; torch's refuses it): clamp, then keep's zero clears it
        pos_oh = (F.one_hot(slot.clamp(max=capacity - 1), capacity).to(dt)
                  * keep.sum(-1, keepdim=True))                   # [N, C]
        d = keep[:, :, None] * pos_oh[:, None, :]                 # [N, E, C]
        dispatch = dispatch + d
        combine = combine + d * (gates * onehot).sum(
            -1, keepdim=True)[:, :, None]
        counts = counts + onehot.sum(0).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9)
    frac_tokens = dispatch.sum(dim=(0, 2)) / torch.clamp(dispatch.sum(),
                                                          min=1.0)
    frac_probs = gates.mean(dim=0)
    aux = (frac_tokens * frac_probs).sum() * E
    return dispatch, combine, aux


def moe_layer(x, lp, cfg, par):
    """One MoE sublayer.  ``x [B, Tl, D]``; ``lp`` this layer's params
    with the experts already ep-local (``[E_local, D, F]`` ...).  Returns
    ``(y [B, Tl, D], aux)``."""
    B, Tl, D = x.shape
    N = B * Tl
    E = cfg.n_experts
    ep_ax = par.ep_axis
    ep = ax.axis_size(ep_ax) if ep_ax is not None else 1
    El = lp["we_gate"].shape[0]           # experts held by this rank
    if El * ep != E:
        raise ValueError(f"experts {E} != ep({ep}) * local({El})")
    capacity = int(math.ceil(cfg.expert_top_k * N / E * cfg.capacity_factor))

    tokens = x.reshape(N, D)
    logits = tokens @ lp["router"].to(x.dtype)                    # [N, E]
    gates = torch.softmax(logits.float(), dim=-1)
    dispatch, combine, aux = _top_k_dispatch(gates, cfg.expert_top_k,
                                             capacity)
    dispatch = dispatch.to(x.dtype)
    # the combine weights (tp-replicated) meet the tp-partial expert
    # outputs: their gradient sums over tp
    combine = ax.copy_to(combine.to(x.dtype), par.tp_axis)

    slots = torch.einsum("nec,nd->ecd", dispatch, tokens)          # [E, C, D]
    if ep_ax is not None and ep > 1:
        # experts → their owning rank; each expert gets ep*C slots
        slots = ax.all_to_all(slots, ep_ax, split_axis=0, concat_axis=1)
    slots = ax.copy_to(slots, par.tp_axis)
    gate = F.silu(torch.einsum("ecd,edf->ecf", slots,
                               lp["we_gate"].to(x.dtype)))
    up = torch.einsum("ecd,edf->ecf", slots, lp["we_up"].to(x.dtype))
    out = torch.einsum("ecf,efd->ecd", gate * up, lp["we_down"].to(x.dtype))
    if ep_ax is not None and ep > 1:
        out = ax.all_to_all(out, ep_ax, split_axis=1, concat_axis=0)
    y = torch.einsum("ecd,nec->nd", out, combine)
    # the experts' FFNs are tp column/row sharded too: the row reduction
    y = ax.reduce_from(y, par.tp_axis)
    return y.reshape(B, Tl, D), aux.float()
