"""Plain fp32 reference of a Llama-architecture decoder with a tied head.

It follows the published description of the architecture (Hugging Face
``LlamaForCausalLM``, which SmolLM2 uses): token embedding; per layer
RMSNorm, bias-free q/k/v projections, rotary position embedding on q and
k (``rotate_half`` over the two halves of each head, inverse frequencies
``theta ** (-2i / head_dim)``), causal softmax attention with kv heads
shared over their query groups, the output projection and the residual,
then RMSNorm, the SwiGLU MLP (``down(silu(gate(x)) * up(x))``) and the
residual; the final RMSNorm; logits through the embedding table (tied),
and the mean next-token cross-entropy.  No dropout (SmolLM2's is 0).

Everything is fp32.  Memory: each layer is checkpointed (its input saved,
the rest recomputed in the backward pass), attention runs in causal blocks
of queries (keys past a block's end are not computed), and the head in
blocks of rows, each recomputed in the backward pass.

Weights use the harness's layout (``families/llama.py``): ``[in, out]``
matrices applied as ``x @ w``, ``embed`` ``[V, D]``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: query rows a causal attention block covers
Q_BLOCK = 512
#: token rows a head block covers
HEAD_ROWS = 4096


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """``x`` ``[B, T, H, Dh]`` rotated by position along T."""
    B, T, H, Dh = x.shape
    half = Dh // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], -1)
    return x * cos + rotated * sin


def causal_attention(q, k, v, mm: Matmul):
    """``q`` ``[B, H, T, Dh]``, ``k``/``v`` ``[B, Hkv, T, Dh]`` → ``[B, H, T,
    Dh]``: exact softmax attention under the causal mask, in blocks of
    ``Q_BLOCK`` query rows, each against the keys up to its end."""
    B, H, T, Dh = q.shape
    g = H // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    scale = Dh ** -0.5
    outs = []
    for s in range(0, T, Q_BLOCK):
        e = min(s + Q_BLOCK, T)
        scores = mm(q[:, :, s:e], k[:, :, :e].transpose(-1, -2)) * scale
        rows = torch.arange(s, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        outs.append(mm(torch.softmax(scores, dim=-1), v[:, :, :e]))
    return torch.cat(outs, dim=2)


def block(x, lp: Dict[str, torch.Tensor], cfg: Dict, mm: Matmul):
    B, T, D = x.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = D // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    a = rmsnorm(x, lp["attn_norm"], eps)
    q = rope(mm(a, lp["wq"]).view(B, T, H, Dh), theta)
    k = rope(mm(a, lp["wk"]).view(B, T, Hkv, Dh), theta)
    v = mm(a, lp["wv"]).view(B, T, Hkv, Dh)
    o = causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), mm)
    x = x + mm(o.transpose(1, 2).reshape(B, T, H * Dh), lp["wo"])
    m = rmsnorm(x, lp["mlp_norm"], eps)
    gated = torch.nn.functional.silu(mm(m, lp["w_gate"])) * mm(m, lp["w_up"])
    return x + mm(gated, lp["w_down"])


def _head_losses(h, embed, targets, mm: Matmul):
    logits = mm(h, embed.t())
    return torch.nn.functional.cross_entropy(logits, targets,
                                             reduction="sum")


def loss(params: Dict, tokens, targets, cfg: Dict,
         mm: Matmul = torch.matmul):
    """Mean next-token cross-entropy of ``tokens`` ``[B, T]`` against
    ``targets`` ``[B, T]``."""
    x = params["embed"][tokens]
    for lp in params["layers"]:
        x = checkpoint(block, x, lp, cfg, mm, use_reentrant=False)
    h = rmsnorm(x, params["final_norm"], cfg["rms_norm_eps"])
    D = h.shape[-1]
    h, y = h.reshape(-1, D), targets.reshape(-1)
    total = h.new_zeros(())
    for s in range(0, h.shape[0], HEAD_ROWS):
        total = total + checkpoint(_head_losses, h[s:s + HEAD_ROWS],
                                   params["embed"], y[s:s + HEAD_ROWS], mm,
                                   use_reentrant=False)
    return total / h.shape[0]

