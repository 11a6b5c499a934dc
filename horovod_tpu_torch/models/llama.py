"""Llama-3-style decoder in PyTorch.

Counterpart: ``horovod_tpu/models/llama.py``.  bf16 activations over fp32
master weights, fp32 RMSNorm statistics and softmax, GQA with RoPE and a
SwiGLU MLP, attention through the flash kernels.

Parameters keep the JAX package's layout at the public surface: weights
are ``[in, out]`` and applied as ``x @ w``, ``embed`` is ``[V, D]`` and
tied to the head as ``h @ embed.T``, ``final_norm`` is ``[D]``.  Where the
JAX tree stacks the layers on a leading ``[L, ...]`` axis for ``lax.scan``,
``params["layers"]`` here is a list of per-layer dicts, so each layer's
gradient lands in its own tensor (``convert.py`` splits and restacks).

This slice is the dense, data-parallel model; ``fused_xent=True`` takes
the loss through the fused cross-entropy kernels.  Each layer's weights and
the root leaves pass through the grad taps of ``optim/overlap.py``, the
identity unless an overlapped step arms them.  What it does not cover
raises ``NotImplementedError`` naming its ROADMAP.md item: MoE
(``n_experts > 0``) and tensor/sequence/pipeline/expert parallel axes
(including ``vocab_parallel`` over tp).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import DeviceLike, resolve_device
from ..ops import fused_xent
from ..optim.overlap import grad_tap, tap_root
from ..parallel.ring_attention import ring_attention

_log = logging.getLogger("horovod_tpu_torch")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: Any = torch.bfloat16       # activation / compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True
    # "full" recomputes each block in the backward pass; "dots" saves the
    # matmul outputs and recomputes only the elementwise work
    remat_policy: str = "dots"
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # > 0: cross-entropy in sequence chunks of this many tokens, each
    # chunk's logits recomputed in the backward pass; 0 = one-shot
    loss_chunk: int = 0
    # the last k layers run without rematerialization
    remat_skip_layers: int = 0
    fused_xent: bool = False
    vocab_parallel: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def tiny(vocab: int = 256, seq: int = 128) -> LlamaConfig:
    """Test-scale config: same code paths, toy sizes."""
    return LlamaConfig(vocab_size=vocab, d_model=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, d_ff=128, max_seq_len=seq,
                       dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    """Which mesh axes the forward pass should use (None = off)."""
    dp_axis: Optional[str] = None
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    pp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    attn: str = "ring"            # "ring" | "ulysses" | "local"


def check_slice(cfg: LlamaConfig, par: ParallelSpec = ParallelSpec()) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mixture of experts (n_experts > 0) is not ported yet "
            "(ROADMAP.md A6, models/moe.py)")
    if cfg.vocab_parallel and par.tp_axis is not None:
        raise NotImplementedError(
            "vocab_parallel over tp is not ported yet (ROADMAP.md A6)")
    for axis in ("tp_axis", "sp_axis", "pp_axis", "ep_axis"):
        if getattr(par, axis) is not None:
            raise NotImplementedError(
                f"{axis}={getattr(par, axis)!r}: tensor, sequence, pipeline "
                f"and expert parallelism are not ported yet (ROADMAP.md A6)")
    if par.attn == "ulysses":
        raise NotImplementedError(
            "Ulysses attention is not ported yet (ROADMAP.md A6)")


def init_params(cfg: LlamaConfig, seed: int = 0, tp: int = 1,
                device: DeviceLike = None) -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (default: the CUDA device; raises without one)."""
    if tp != 1:
        raise NotImplementedError(
            "tensor-parallel parameters are not ported yet (ROADMAP.md A6)")
    check_slice(cfg)
    device = resolve_device(device)
    D, H, Hkv, Dh, F_, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.d_ff, cfg.n_layers,
                               cfg.vocab_size)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=cfg.param_dtype)
        return w.mul_(fan_in ** -0.5)

    def ones(n):
        return torch.ones((n,), device=device, dtype=cfg.param_dtype)

    embed = norm((V, D), D)
    layers = [{
        "attn_norm": ones(D),
        "wq": norm((D, H * Dh), D),
        "wk": norm((D, Hkv * Dh), D),
        "wv": norm((D, Hkv * Dh), D),
        "wo": norm((H * Dh, D), H * Dh),
        "mlp_norm": ones(D),
        "w_gate": norm((D, F_), D),
        "w_up": norm((D, F_), D),
        "w_down": norm((F_, D), F_),
    } for _ in range(L)]
    return {"embed": embed, "layers": layers, "final_norm": ones(D)}


def _embed_lookup(embed, tokens, cfg: LlamaConfig):
    return F.embedding(tokens, embed.to(cfg.dtype))


def _rmsnorm(x, w, eps):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w.to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding; x ``[B, T, H, D]``, positions ``[B, T]``."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # [B, T, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _attention(x, lp, cfg: LlamaConfig, par: ParallelSpec, positions):
    B, T, _ = x.shape
    Dh = cfg.head_dim
    Hl = lp["wq"].shape[-1] // Dh
    Hkvl = lp["wk"].shape[-1] // Dh
    q = (x @ lp["wq"].to(x.dtype)).view(B, T, Hl, Dh)
    k = (x @ lp["wk"].to(x.dtype)).view(B, T, Hkvl, Dh)
    v = (x @ lp["wv"].to(x.dtype)).view(B, T, Hkvl, Dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = ring_attention(q, k, v, par.sp_axis, causal=True)
    return o.reshape(B, T, Hl * Dh) @ lp["wo"].to(x.dtype)


def _mlp(x, lp):
    gate = F.silu(x @ lp["w_gate"].to(x.dtype))
    up = x @ lp["w_up"].to(x.dtype)
    return (gate * up) @ lp["w_down"].to(x.dtype)


def ffn(pre, lp, cfg: LlamaConfig, par: ParallelSpec):
    """The post-attention FFN sublayer; returns ``(y, aux_loss)``, the aux
    loss 0 for the dense MLP (MoE is refused by :func:`check_slice`)."""
    return _mlp(pre, lp), pre.new_zeros((), dtype=torch.float32)


def block(x, lp, cfg: LlamaConfig, par: ParallelSpec, positions):
    """One transformer block; returns ``(x, aux_loss)``."""
    x = x + _attention(_rmsnorm(x, lp["attn_norm"], cfg.norm_eps),
                       lp, cfg, par, positions)
    y, aux = ffn(_rmsnorm(x, lp["mlp_norm"], cfg.norm_eps), lp, cfg, par)
    return x + y, aux


def _save_matmuls(ctx, op, *args, **kwargs):
    # the "dots" policy: keep matmul outputs, recompute the rest
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _rematerialized(fn, policy: str):
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _save_matmuls))


def _layer_stack(h, layers, cfg: LlamaConfig, par: ParallelSpec, positions):
    body = block
    if cfg.remat:
        if cfg.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{cfg.remat_policy!r}")
        body = _rematerialized(block, cfg.remat_policy)
    aux = h.new_zeros((), dtype=torch.float32)
    n = len(layers)
    # the last k layers run without rematerialization: their activations
    # are saved, and they are the first to run backward
    k = min(cfg.remat_skip_layers, n) if cfg.remat else 0
    for i, lp in enumerate(layers):
        # Each layer's weights are tapped (the identity outside an armed
        # optim.overlap.overlapped_backprop), then cast to the compute
        # dtype, inside the loop but outside the checkpointed block: a
        # recompute does not cast again, and autograd, which runs ready
        # nodes by descending sequence number, reaches each layer's casts
        # right after that layer's backward instead of after every layer's
        # (casts made before the loop would all wait for layer 0).
        lp = {n: w.to(cfg.dtype) for n, w in grad_tap(lp).items()}
        h, aux_l = (body if i < n - k else block)(h, lp, cfg, par, positions)
        aux = aux + aux_l
    return h, aux


def hidden(params, tokens, cfg: LlamaConfig, par: ParallelSpec = ParallelSpec(),
           n_microbatches: int = 0):
    """Token ids ``[B, T]`` → final-norm hidden states ``[B, T, D]``."""
    del n_microbatches  # pipeline parallelism is refused by check_slice
    check_slice(cfg, par)
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device,
                             dtype=torch.int32)[None, :].expand(B, T)
    h = _embed_lookup(params["embed"], tokens, cfg)
    h, aux = _layer_stack(h, params["layers"], cfg, par, positions)
    return _rmsnorm(h, params["final_norm"], cfg.norm_eps), aux


def forward(params, tokens, cfg: LlamaConfig, par: ParallelSpec = ParallelSpec(),
            n_microbatches: int = 0):
    """Token ids → ``(logits [B, T, V], aux)`` through the tied head."""
    h, aux = hidden(params, tokens, cfg, par, n_microbatches)
    return h @ params["embed"].T.to(h.dtype), aux


def _chunk_losses(hc, w, tc):
    logits = (hc @ w.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tc[..., None].long())[..., 0]
    return (lse - tgt).sum()


def _chunked_xent(h, w_embed, targets, chunk: int):
    """Mean cross-entropy without materializing full logits: each chunk of
    ``chunk`` tokens computes its ``[B, chunk, V]`` logits, reduces them to
    ``lse - target`` and recomputes them in the backward pass."""
    B, T, _ = h.shape
    w = w_embed.to(h.dtype)
    total = h.new_zeros((), dtype=torch.float32)
    for c in range(0, T, chunk):
        total = total + checkpoint(_chunk_losses, h[:, c:c + chunk], w,
                                   targets[:, c:c + chunk],
                                   use_reentrant=False)
    return total / (B * T)


@functools.lru_cache(maxsize=None)
def _warn_unchunked(chunk: int, T: int) -> None:
    # once per shape, as the JAX package warns once per trace
    _log.warning(
        "loss_chunk=%d does not divide the local sequence length %d; "
        "falling back to one-shot cross-entropy — the full [B, T, V] "
        "logits WILL be materialized", chunk, T)


def _oneshot_xent(h, w_embed, targets):
    """Mean cross-entropy through the full ``[B, T, V]`` logits."""
    logits = h @ w_embed.T.to(h.dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def loss_fn(params, tokens, targets, cfg: LlamaConfig,
            par: ParallelSpec = ParallelSpec(), n_microbatches: int = 0):
    """Mean next-token cross-entropy over the local tokens.

    Keeps the JAX dispatch order: vocab-parallel (refused here with tp),
    then the fused kernels, then chunked, then one-shot.  With
    ``fused_xent`` on and ``HOROVOD_FUSED_XENT`` not 0, inputs the fused
    kernels do not take fall through on the CPU, as in JAX, and raise on
    the card.
    """
    # the leaves outside the layer stack, tapped as one (the identity
    # outside an armed optim.overlap.overlapped_backprop): the tied
    # embedding's lookup and head add into one cotangent
    params = tap_root(params)
    h, _ = hidden(params, tokens, cfg, par, n_microbatches)
    w = params["embed"]
    if cfg.fused_xent and fused_xent.enabled():
        reason = fused_xent.unsupported_reason(h, w, targets)
        if reason is None:
            return fused_xent.fused_xent_mean(h, w, targets)
        if h.device.type == "cuda":
            raise ValueError(
                f"the fused cross-entropy kernels do not take this input: "
                f"{reason}; set HOROVOD_FUSED_XENT=0 to run the chunked or "
                f"one-shot loss on the card")
    T = h.shape[1]
    if cfg.loss_chunk > 0 and T % cfg.loss_chunk == 0:
        return _chunked_xent(h, w, targets, cfg.loss_chunk)
    if cfg.loss_chunk > 0:
        _warn_unchunked(cfg.loss_chunk, T)
    return _oneshot_xent(h, w, targets)


def count_params(cfg: LlamaConfig) -> int:
    D, H, Hkv, Dh, F_, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.d_ff, cfg.n_layers,
                               cfg.vocab_size)
    per_layer = (2 * D + D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
                 + 3 * D * F_)
    return V * D + L * per_layer + D
