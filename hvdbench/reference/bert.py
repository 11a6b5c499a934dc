"""Plain fp32 reference of BERT-base with a sequence-classification head.

It follows Devlin et al. (arXiv:1810.04805) and google-research/bert's
``modeling.py``: word, position and token-type embeddings summed, then
LayerNorm; per layer (post-LN) self-attention with biased q/k/v and output
projections, the residual and LayerNorm, then the feed-forward
(``gelu`` in the tanh form ``modeling.py`` uses) with biases, the residual
and LayerNorm; the pooler (tanh of a dense layer on the [CLS] token) and a
linear classifier; mean cross-entropy over the labels.  Departures: no
dropout (the comparison needs a deterministic step), every token type 0,
no padding mask (every sequence is full).

Everything is fp32; each layer is checkpointed.  Weights use the
harness's layout (``families/bert.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def layernorm(x, w, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def block(x, lp: Dict[str, torch.Tensor], cfg: Dict, mm: Matmul):
    B, T, D = x.shape
    H = cfg["num_attention_heads"]
    Dh = D // H
    eps = cfg["layer_norm_eps"]

    def heads(t):
        return t.view(B, T, H, Dh).transpose(1, 2)

    q = heads(mm(x, lp["wq"]) + lp["bq"])
    k = heads(mm(x, lp["wk"]) + lp["bk"])
    v = heads(mm(x, lp["wv"]) + lp["bv"])
    p = torch.softmax(mm(q, k.transpose(-1, -2)) * Dh ** -0.5, dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(B, T, D)
    x = layernorm(x + mm(o, lp["wo"]) + lp["bo"], lp["attn_norm_w"],
                  lp["attn_norm_b"], eps)
    f = mm(gelu(mm(x, lp["w_in"]) + lp["b_in"]), lp["w_out"]) + lp["b_out"]
    return layernorm(x + f, lp["mlp_norm_w"], lp["mlp_norm_b"], eps)


def loss(params: Dict, tokens, labels, cfg: Dict,
         mm: Matmul = torch.matmul):
    """Mean classification cross-entropy of ``tokens`` ``[B, T]`` against
    ``labels`` ``[B]``."""
    B, T = tokens.shape
    eps = cfg["layer_norm_eps"]
    pos = torch.arange(T, device=tokens.device)
    x = (params["word_embed"][tokens] + params["pos_embed"][pos][None]
         + params["type_embed"][torch.zeros_like(tokens)])
    x = layernorm(x, params["embed_norm_w"], params["embed_norm_b"], eps)
    for lp in params["layers"]:
        x = checkpoint(block, x, lp, cfg, mm, use_reentrant=False)
    pooled = torch.tanh(mm(x[:, 0], params["pooler_w"]) + params["pooler_b"])
    logits = mm(pooled, params["cls_w"]) + params["cls_b"]
    return torch.nn.functional.cross_entropy(logits, labels)

