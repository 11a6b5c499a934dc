"""Llama-3-style decoder in PyTorch.

Counterpart: ``horovod_tpu/models/llama.py``.  bf16 activations over fp32
master weights, fp32 RMSNorm statistics and softmax, GQA with RoPE, a
SwiGLU MLP or a mixture of experts (``models/moe.py``), attention through
the flash kernels.

Parameters keep the JAX package's layout at the public surface: weights
are ``[in, out]`` and applied as ``x @ w``, ``embed`` is ``[V, D]`` and
tied to the head as ``h @ embed.T``, ``final_norm`` is ``[D]``.  Where the
JAX tree stacks the layers on a leading ``[L, ...]`` axis for ``lax.scan``,
``params["layers"]`` here is a list of per-layer dicts, so each layer's
gradient lands in its own tensor (``convert.py`` splits and restacks).

Parallelism follows a ``ParallelSpec`` of mesh axis names, run inside the
mesh's context (``with pmesh:``; ``parallel/axis.py`` finds the groups
there): Megatron tensor parallelism over tp (column-parallel
wq/wk/wv/w_gate/w_up and the experts' we_gate/we_up, row-parallel
wo/w_down/we_down, one all-reduce after each row-parallel product, and
the vocabulary of the tied embedding sharded over tp with
``vocab_parallel``), ring or Ulysses attention over sp, experts over ep.
Each rank holds its slice of the params (:func:`param_specs`,
``convert.llama_shard_params``).  ``fused_xent=True`` takes the loss
through the fused cross-entropy kernels.  Each layer's weights and the
root leaves pass through the grad taps of ``optim/overlap.py``, the
identity unless an overlapped step arms them.  Over a pp axis the layer
list is cut by stage (stage s holds layers ``[s·L/pp, (s+1)·L/pp)``) and
the stack runs through ``parallel/pipeline.py``'s GPipe loop in
``n_microbatches`` microbatches.
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
from ..parallel import axis as ax
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses import ulysses_attention
from . import moe as moe_mod

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


def llama3_8b() -> LlamaConfig:
    """Llama-3-8B geometry (the BASELINE config-4 target)."""
    return LlamaConfig()


# BASELINE config-4 mesh: dp16 x tp4
LLAMA8B_TP = 4
LLAMA8B_DP = 16


def llama3_8b_train_cfg(seq: int = 4096) -> LlamaConfig:
    """Config 4's training configuration: vocab-parallel embedding and
    head, chunk-1024 cross-entropy, full remat."""
    return dataclasses.replace(
        llama3_8b(), vocab_parallel=True, loss_chunk=1024, remat=True,
        remat_policy="full", max_seq_len=seq)


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
    """Raise ``ValueError`` for an attention mode the model does not
    have."""
    del cfg
    if par.attn not in ("ring", "ulysses", "local"):
        raise ValueError(f"attn must be 'ring', 'ulysses' or 'local', got "
                         f"{par.attn!r}")


def init_params(cfg: LlamaConfig, seed: int = 0, tp: int = 1,
                device: DeviceLike = None) -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (default: the CUDA device; raises without one).  With
    ``tp > 1`` they are still the FULL params, as in the JAX package:
    ``convert.llama_shard_params`` takes a rank's slice.  On the
    ``"meta"`` device the tree holds the shapes alone."""
    D, H, Hkv, Dh, F_, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.d_ff, cfg.n_layers,
                               cfg.vocab_size)
    if H % tp or Hkv % tp or F_ % tp:
        raise ValueError(
            f"heads({H})/kv_heads({Hkv})/d_ff({F_}) must divide tp={tp}")
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=cfg.param_dtype)
        return w.mul_(fan_in ** -0.5)

    def ones(n):
        return torch.ones((n,), device=device, dtype=cfg.param_dtype)

    embed = norm((V, D), D)
    moe = cfg.n_experts > 0
    layers = [{
        "attn_norm": ones(D),
        "wq": norm((D, H * Dh), D),
        "wk": norm((D, Hkv * Dh), D),
        "wv": norm((D, Hkv * Dh), D),
        "wo": norm((H * Dh, D), H * Dh),
        "mlp_norm": ones(D),
        **({} if moe else {
            "w_gate": norm((D, F_), D),
            "w_up": norm((D, F_), D),
            "w_down": norm((F_, D), F_)}),
    } for _ in range(L)]
    if moe:
        for lp, extra in zip(layers, moe_mod.init_moe_layer_params(
                gen, L, D, F_, cfg.n_experts, cfg.param_dtype, device)):
            lp.update(extra)
    return {"embed": embed, "layers": layers, "final_norm": ones(D)}


def param_specs(par: ParallelSpec, cfg: Optional[LlamaConfig] = None):
    """Each leaf's mesh axes, dim by dim (a tuple of axis names or None;
    ``()`` for a replicated leaf), over the port's tree: the JAX package's
    PartitionSpecs with the stacked layer dim (pp) dropped from each
    layer's leaves: a pp axis cuts ``params["layers"]``'s list instead
    (:func:`leaf_axes`).  Column-parallel weights shard their output dim over
    tp, row-parallel ones their input dim; the experts shard their expert
    dim over ep; the embedding's vocab dim over tp with vocab_parallel."""
    tp = par.tp_axis
    embed = ((tp, None) if cfg is not None and cfg.vocab_parallel
             and tp is not None else ())
    layer = {"attn_norm": (None,), "wq": (None, tp), "wk": (None, tp),
             "wv": (None, tp), "wo": (tp, None), "mlp_norm": (None,)}
    if cfg is not None and cfg.n_experts > 0:
        ep = par.ep_axis
        layer.update({"router": (None, None), "we_gate": (ep, None, tp),
                      "we_up": (ep, None, tp), "we_down": (ep, tp, None)})
    else:
        layer.update({"w_gate": (None, tp), "w_up": (None, tp),
                      "w_down": (tp, None)})
    n = cfg.n_layers if cfg is not None else 1
    return {"embed": embed, "layers": [dict(layer) for _ in range(n)],
            "final_norm": ()}


def leaf_axes(specs: Dict, path: str, par: ParallelSpec) -> set:
    """The mesh axes the leaf at ``path`` is sharded over: its spec's, and
    the pp axis for a layer leaf (the list is cut by stage)."""
    axes = {a for a in leaf_spec(specs, path) if a is not None}
    if par.pp_axis is not None and path.startswith("layers."):
        axes.add(par.pp_axis)
    return axes


def leaf_spec(specs: Dict, path: str):
    """The spec of the leaf at the dotted ``path`` (``tree.tree_paths``)
    of a :func:`param_specs` tree."""
    node = specs
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _vp_active(cfg: LlamaConfig, par: ParallelSpec) -> bool:
    return cfg.vocab_parallel and par.tp_axis is not None


def _embed_lookup(embed, tokens, cfg: LlamaConfig,
                  par: ParallelSpec = ParallelSpec()):
    """Token embedding; with vocab_parallel this rank holds rows
    ``[i·V/tp, (i+1)·V/tp)``: out-of-shard tokens contribute zero and one
    all-reduce over tp assembles the rows."""
    w = embed.to(cfg.dtype)
    if not _vp_active(cfg, par):
        return F.embedding(tokens, w)
    Vl = w.shape[0]
    local = tokens - ax.axis_index(par.tp_axis) * Vl
    inside = (local >= 0) & (local < Vl)
    rows = F.embedding(local.clamp(0, Vl - 1), w)
    rows = rows * inside[..., None].to(w.dtype)
    return ax.reduce_from(rows, par.tp_axis)


def _vp_chunk_losses(h, w, targets, par: ParallelSpec):
    """Sum of ``lse - target_logit`` over one sequence chunk against a
    tp-sharded vocabulary: local partial logits ``[B, c, V/tp]``, the
    logsumexp by a max (no gradient) and a sum over tp, the target logit
    by a masked sum over tp."""
    Vl = w.shape[0]
    h = ax.copy_to(h, par.tp_axis)
    logits_l = (h @ w.T).float()                        # [B, c, V/tp]
    m = ax.pmax(logits_l.detach().amax(-1), par.tp_axis)
    sumexp = ax.reduce_from(torch.exp(logits_l - m[..., None]).sum(-1),
                            par.tp_axis)
    lse = m + torch.log(sumexp)
    local = targets.long() - ax.axis_index(par.tp_axis) * Vl
    inside = (local >= 0) & (local < Vl)
    tgt_l = logits_l.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    tgt = ax.reduce_from(tgt_l * inside.float(), par.tp_axis)
    return (lse - tgt).sum()


def _vocab_parallel_xent(h, embed, targets, par: ParallelSpec,
                         chunk: int = 0):
    """Mean cross-entropy over a tp-sharded vocabulary; with ``chunk``
    dividing the local sequence, the partial logits are tiled over
    sequence chunks, each recomputed in the backward pass."""
    w = embed.to(h.dtype)
    B, T, _ = h.shape
    if chunk <= 0 or T % chunk:
        return _vp_chunk_losses(h, w, targets, par) / (B * T)
    total = h.new_zeros((), dtype=torch.float32)
    for c in range(0, T, chunk):
        total = total + checkpoint(_vp_chunk_losses, h[:, c:c + chunk], w,
                                   targets[:, c:c + chunk], par,
                                   use_reentrant=False)
    return total / (B * T)


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
    """One attention sublayer on tp-local heads and the sp-local
    sequence."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    # local head counts under tp (the weights arrive sharded)
    Hl = lp["wq"].shape[-1] // Dh
    Hkvl = lp["wk"].shape[-1] // Dh
    x = ax.copy_to(x, par.tp_axis)
    q = (x @ lp["wq"].to(x.dtype)).view(B, T, Hl, Dh)
    k = (x @ lp["wk"].to(x.dtype)).view(B, T, Hkvl, Dh)
    v = (x @ lp["wv"].to(x.dtype)).view(B, T, Hkvl, Dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if par.attn == "ulysses":
        o = ulysses_attention(q, k, v, par.sp_axis, causal=True)
    else:
        o = ring_attention(q, k, v, par.sp_axis, causal=True)
    o = o.reshape(B, T, Hl * Dh) @ lp["wo"].to(x.dtype)
    return ax.reduce_from(o, par.tp_axis)  # row-parallel reduction


def _mlp(x, lp, par: ParallelSpec = ParallelSpec()):
    x = ax.copy_to(x, par.tp_axis)
    gate = F.silu(x @ lp["w_gate"].to(x.dtype))
    up = x @ lp["w_up"].to(x.dtype)
    return ax.reduce_from((gate * up) @ lp["w_down"].to(x.dtype),
                          par.tp_axis)


def ffn(pre, lp, cfg: LlamaConfig, par: ParallelSpec):
    """The post-attention FFN sublayer, dense SwiGLU or MoE routing;
    returns ``(y, aux_loss)``, the aux loss 0 for the dense MLP: the one
    dispatch point of the training block and the KV-cache decode."""
    if cfg.n_experts > 0:
        return moe_mod.moe_layer(pre, lp, cfg, par)
    return _mlp(pre, lp, par), pre.new_zeros((), dtype=torch.float32)


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


def _layer_stack(h, layers, cfg: LlamaConfig, par: ParallelSpec, positions,
                 gather=None):
    """The decoder blocks over ``layers``; ``gather(lp)`` (FSDP's) makes
    each layer's full weights from its shards inside the layer's
    (rematerialized) block, so only that layer is resident unsharded and
    a recompute gathers again."""
    def cast(lp):
        return {n: w.to(cfg.dtype) for n, w in lp.items()}

    run = block
    if gather is not None:
        def run(x, lp, cfg, par, positions):
            return block(x, cast(gather(lp)), cfg, par, positions)
    body = run
    if cfg.remat:
        if cfg.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{cfg.remat_policy!r}")
        body = _rematerialized(run, cfg.remat_policy)
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
        # (casts made before the loop would all wait for layer 0).  Under
        # FSDP the gather and the cast run inside the block.
        lp = grad_tap(lp)
        if gather is None:
            lp = cast(lp)
        h, aux_l = (body if i < n - k else run)(h, lp, cfg, par, positions)
        aux = aux + aux_l
    return h, aux


def hidden(params, tokens, cfg: LlamaConfig, par: ParallelSpec = ParallelSpec(),
           n_microbatches: int = 0, gather=None):
    """Token ids ``[B, Tl]`` (batch over dp, sequence over sp) →
    final-norm hidden states ``[B, Tl, D]`` and the summed MoE aux loss.
    With ``par.pp_axis``, ``n_microbatches`` must divide B and the stage's
    layers run through the GPipe loop; the aux is then the stages' sum
    averaged over the microbatches, as in the JAX package.  ``gather``
    as in :func:`_layer_stack`."""
    check_slice(cfg, par)
    B, T = tokens.shape
    sp_idx = ax.axis_index(par.sp_axis) if par.sp_axis is not None else 0
    pos = (torch.arange(T, device=tokens.device, dtype=torch.int32)
           + sp_idx * T)[None, :]
    h = _embed_lookup(params["embed"], tokens, cfg, par)
    if par.pp_axis is not None:
        from ..parallel.pipeline import pipeline_apply
        if n_microbatches <= 0:
            raise ValueError("pipeline parallelism needs n_microbatches > 0")
        if B % n_microbatches:
            raise ValueError(f"batch {B} not divisible by "
                             f"n_microbatches={n_microbatches}")
        mb = B // n_microbatches
        # positions are a function of the sp shard alone: every
        # microbatch shares them
        pos_mb = pos.expand(mb, T)

        def stage_fn(stage_layers, x):
            return _layer_stack(x, stage_layers, cfg, par, pos_mb)

        out, aux = pipeline_apply(
            stage_fn, params["layers"],
            h.reshape(n_microbatches, mb, *h.shape[1:]),
            axis_name=par.pp_axis, with_aux=True)
        h = out.reshape(h.shape)
    else:
        h, aux = _layer_stack(h, params["layers"], cfg, par,
                              pos.expand(B, T), gather)
    return _rmsnorm(h, params["final_norm"], cfg.norm_eps), aux


def forward(params, tokens, cfg: LlamaConfig, par: ParallelSpec = ParallelSpec(),
            n_microbatches: int = 0):
    """Token ids → ``(logits [B, T, V], aux)`` through the tied head; with
    vocab_parallel the tp shards' logits are gathered in vocab order."""
    h, aux = hidden(params, tokens, cfg, par, n_microbatches)
    if _vp_active(cfg, par):
        logits = ax.copy_to(h, par.tp_axis) @ params["embed"].T.to(h.dtype)
        return ax.all_gather(logits, par.tp_axis, dim=-1), aux
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
            par: ParallelSpec = ParallelSpec(), n_microbatches: int = 0,
            gather=None):
    """Mean next-token cross-entropy over the local tokens, plus the MoE
    load-balance loss (the caller averages over the data axes).

    Keeps the JAX dispatch order: vocab-parallel, then the fused kernels,
    then chunked, then one-shot.  With ``fused_xent`` on and
    ``HOROVOD_FUSED_XENT`` not 0, inputs the fused kernels do not take
    fall through on the CPU, as in JAX, and raise on the card.
    """
    # the leaves outside the layer stack, tapped as one (the identity
    # outside an armed optim.overlap.overlapped_backprop): the tied
    # embedding's lookup and head add into one cotangent
    params = tap_root(params)
    h, aux = hidden(params, tokens, cfg, par, n_microbatches, gather)
    loss = _xent(h, params["embed"], targets, cfg, par)
    if cfg.n_experts > 0:
        loss = loss + cfg.aux_loss_coef * aux / cfg.n_layers
    return loss


def _xent(h, w, targets, cfg: LlamaConfig, par: ParallelSpec):
    T = h.shape[1]
    if _vp_active(cfg, par):
        if cfg.loss_chunk > 0 and T % cfg.loss_chunk:
            _warn_unchunked(cfg.loss_chunk, T)
        return _vocab_parallel_xent(h, w, targets, par, chunk=cfg.loss_chunk)
    if cfg.fused_xent and fused_xent.enabled():
        reason = fused_xent.unsupported_reason(h, w, targets)
        if reason is None:
            return fused_xent.fused_xent_mean(h, w, targets)
        if h.device.type == "cuda":
            raise ValueError(
                f"the fused cross-entropy kernels do not take this input: "
                f"{reason}; set HOROVOD_FUSED_XENT=0 to run the chunked or "
                f"one-shot loss on the card")
    if cfg.loss_chunk > 0 and T % cfg.loss_chunk == 0:
        return _chunked_xent(h, w, targets, cfg.loss_chunk)
    if cfg.loss_chunk > 0:
        _warn_unchunked(cfg.loss_chunk, T)
    return _oneshot_xent(h, w, targets)


def count_params(cfg: LlamaConfig) -> int:
    D, H, Hkv, Dh, F_, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.d_ff, cfg.n_layers,
                               cfg.vocab_size)
    per_layer = 2 * D + D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
    if cfg.n_experts > 0:
        per_layer += D * cfg.n_experts + 3 * cfg.n_experts * D * F_
    else:
        per_layer += 3 * D * F_
    return V * D + L * per_layer + D
