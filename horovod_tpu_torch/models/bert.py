"""BERT-style bidirectional encoder in PyTorch: BASELINE.md config 3
(BERT fine-tune with the distributed optimizer).

Counterpart: ``horovod_tpu/models/bert.py``.  bf16 activations over fp32
master weights, fp32 LayerNorm (post-LN, eps 1e-12) and softmax, the tanh
GELU.  Unmasked attention is non-causal ``local_attention``, so on the
card it runs through the flash kernels (head_dim 64 at BERT's widths);
padded batches take the dense masked path in plain PyTorch, as in JAX (the
kernels have no mask operand).

Parameters keep the JAX package's names and ``[in, out]`` weights applied
as ``x @ w``; where the JAX tree stacks the layers on a leading ``[L, ...]``
axis for ``lax.scan``, ``params["layers"]`` here is a list of per-layer
dicts, as in the port's Llama (``convert.py`` splits and restacks).  With
``cfg.remat`` each block is checkpointed under Llama's "dots" policy
(``llama._save_matmuls``): the matmul outputs are saved and the rest,
attention included, is recomputed in the backward pass, as JAX's
``dots_with_no_batch_dims_saveable`` does.  Each layer's weights pass
through ``grad_tap`` and the other leaves through ``tap_root``, the
identity outside an armed ``overlapped_backprop``.

Tensor and sequence parallelism follow a ``ParallelSpec`` run inside the
mesh's context (``with pmesh:``), as in the port's Llama: Megatron tp
(column-parallel q/k/v and ``w_in`` with their biases, row-parallel
``wo``/``w_out``; ``copy_to`` before the column products and one
all-reduce after each row product, where JAX's ``check_vma`` puts its
transposes) on tp-local heads, and non-causal ring attention over sp
(``parallel/ring_attention.py``, its tiles through the flash kernels).
Each rank holds its slice of the params (:func:`param_specs`,
``convert.bert_shard_params``).  BERT has no pipeline or expert layout:
a pp or ep axis raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .. import DeviceLike, api, resolve_device, runtime, tracing
from ..optim.overlap import grad_tap, tap_root
from ..parallel import axis as ax
from ..parallel.mesh import ParallelMesh
from ..parallel.ring_attention import local_attention, ring_attention
from ..training import TrainStep, resolve_mesh, sum_scaled_, trainable_leaves
from ..tree import tree_leaves, tree_map, tree_paths
from .llama import ParallelSpec, _rematerialized


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    num_labels: int = 2           # the fine-tune classification head
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_base(num_labels: int = 2) -> BertConfig:
    """BERT-Base geometry (the BASELINE config-3 target)."""
    return BertConfig(num_labels=num_labels)


def bert_large(num_labels: int = 2) -> BertConfig:
    return BertConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
                      num_labels=num_labels)


def tiny(vocab: int = 256, seq: int = 64, num_labels: int = 2) -> BertConfig:
    """Test-scale config: same code paths, toy sizes."""
    return BertConfig(vocab_size=vocab, d_model=64, n_layers=2, n_heads=4,
                      d_ff=128, max_seq_len=seq, num_labels=num_labels,
                      dtype=torch.float32)


#: ``optax.adamw(5e-5)``, the fine-tune optimizer of the JAX package's
#: BERT bench and examples (optax's weight decay 1e-4, not torch's 0.01)
finetune_optimizer = functools.partial(torch.optim.AdamW, lr=5e-5,
                                       weight_decay=1e-4, eps=1e-8)


def _refuse(par: ParallelSpec) -> None:
    """BERT's layouts are dp, tp and sp (the JAX model reads no other
    axis); a pp or ep axis raises rather than being ignored."""
    for axis in ("pp_axis", "ep_axis"):
        if getattr(par, axis) is not None:
            raise ValueError(
                f"{axis}={getattr(par, axis)!r}: BERT has no pipeline or "
                f"expert-parallel layout (its layouts are dp, tp and sp)")


def init_params(cfg: BertConfig, seed: int = 0, tp: int = 1,
                device: DeviceLike = None) -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (default: the CUDA device; raises without one).  With
    ``tp > 1`` they are still the FULL params, as in the JAX package:
    ``convert.bert_shard_params`` takes a rank's slice."""
    D, H, Dh, F_, L, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                          cfg.n_layers, cfg.vocab_size)
    if H % tp or F_ % tp:
        raise ValueError(f"heads({H})/d_ff({F_}) must divide tp={tp}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=cfg.param_dtype)
        return w.mul_(fan_in ** -0.5)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=cfg.param_dtype)

    def ones(n):
        return torch.ones((n,), device=device, dtype=cfg.param_dtype)

    word = norm((V, D), D)
    layers = [{
        "attn_norm_w": ones(D), "attn_norm_b": zeros(D),
        "wq": norm((D, H * Dh), D), "bq": zeros(H * Dh),
        "wk": norm((D, H * Dh), D), "bk": zeros(H * Dh),
        "wv": norm((D, H * Dh), D), "bv": zeros(H * Dh),
        "wo": norm((H * Dh, D), H * Dh), "bo": zeros(D),
        "mlp_norm_w": ones(D), "mlp_norm_b": zeros(D),
        "w_in": norm((D, F_), D), "b_in": zeros(F_),
        "w_out": norm((F_, D), F_), "b_out": zeros(D),
    } for _ in range(L)]
    return {
        "word_embed": word,
        "pos_embed": norm((cfg.max_seq_len, D), D),
        "type_embed": norm((cfg.type_vocab_size, D), D),
        "embed_norm_w": ones(D),
        "embed_norm_b": zeros(D),
        "layers": layers,
        "pooler_w": norm((D, D), D),
        "pooler_b": zeros(D),
        "cls_w": norm((D, cfg.num_labels), D),
        "cls_b": zeros(cfg.num_labels),
    }


def param_specs(par: ParallelSpec, cfg: Optional[BertConfig] = None):
    """Each leaf's mesh axes, dim by dim (``()`` for a replicated leaf),
    over the port's tree: the JAX package's PartitionSpecs (megatron
    layout) with the stacked layer dim dropped.  Column-parallel q/k/v
    and ``w_in`` shard their output dim over tp, their biases with them;
    row-parallel ``wo``/``w_out`` shard their input dim."""
    tp = par.tp_axis
    layer = {
        "attn_norm_w": (None,), "attn_norm_b": (None,),
        "wq": (None, tp), "bq": (tp,), "wk": (None, tp), "bk": (tp,),
        "wv": (None, tp), "bv": (tp,), "wo": (tp, None), "bo": (None,),
        "mlp_norm_w": (None,), "mlp_norm_b": (None,),
        "w_in": (None, tp), "b_in": (tp,), "w_out": (tp, None),
        "b_out": (None,)}
    n = cfg.n_layers if cfg is not None else 1
    return {"word_embed": (), "pos_embed": (), "type_embed": (),
            "embed_norm_w": (), "embed_norm_b": (),
            "layers": [dict(layer) for _ in range(n)],
            "pooler_w": (), "pooler_b": (), "cls_w": (), "cls_b": ()}


def _layernorm(x, w, b, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _dense_masked_attention(q, k, v, mask, scale):
    """Dense path for padded batches; mask ``[B, Tk]`` (1 = attend)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask[:, None, None, :].bool(), s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _attention(x, lp, cfg: BertConfig, par: ParallelSpec, mask):
    """Attention on tp-local heads and the sp-local sequence."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    H = lp["wq"].shape[-1] // Dh          # tp-local heads
    x = ax.copy_to(x, par.tp_axis)
    q = (x @ lp["wq"] + lp["bq"]).view(B, T, H, Dh)
    k = (x @ lp["wk"] + lp["bk"]).view(B, T, H, Dh)
    v = (x @ lp["wv"] + lp["bv"]).view(B, T, H, Dh)
    scale = Dh ** -0.5
    if mask is not None:
        o = _dense_masked_attention(q, k, v, mask, scale)
    elif par.sp_axis is not None:
        o = ring_attention(q, k, v, par.sp_axis, causal=False,
                           sm_scale=scale)
    else:
        o = local_attention(q, k, v, causal=False, sm_scale=scale)
    o = ax.reduce_from(o.reshape(B, T, H * Dh) @ lp["wo"], par.tp_axis)
    return o + lp["bo"]


def _mlp(x, lp, par: ParallelSpec):
    x = ax.copy_to(x, par.tp_axis)
    h = F.gelu(x @ lp["w_in"] + lp["b_in"], approximate="tanh")
    return ax.reduce_from(h @ lp["w_out"], par.tp_axis) + lp["b_out"]


def block(x, lp, cfg: BertConfig, par: ParallelSpec, mask):
    """One post-LN encoder block (BERT's layout: the residual, then the
    LayerNorm); ``lp`` already in the compute dtype."""
    x = _layernorm(x + _attention(x, lp, cfg, par, mask), lp["attn_norm_w"],
                   lp["attn_norm_b"], cfg.norm_eps)
    return _layernorm(x + _mlp(x, lp, par), lp["mlp_norm_w"],
                      lp["mlp_norm_b"], cfg.norm_eps)


def encode(params, tokens, cfg: BertConfig,
           par: ParallelSpec = ParallelSpec(), token_types=None, mask=None):
    """Token ids ``[B, T]`` -> hidden states ``[B, T, D]``, the sequence
    this rank's block over sp.  ``mask``: optional ``[B, T]`` 0/1
    attention mask for padded batches (the dense path; it refuses sp)."""
    _refuse(par)
    if mask is not None and par.sp_axis is not None:
        raise ValueError("attention masks require unsharded sequence "
                         "(pad-free batches for the sp path)")
    B, T = tokens.shape
    sp_idx = ax.axis_index(par.sp_axis) if par.sp_axis is not None else 0
    positions = torch.arange(T, device=tokens.device) + sp_idx * T
    h = F.embedding(tokens, params["word_embed"].to(cfg.dtype))
    h = h + F.embedding(positions, params["pos_embed"].to(cfg.dtype))[None]
    tt = token_types if token_types is not None else torch.zeros_like(tokens)
    h = h + F.embedding(tt, params["type_embed"].to(cfg.dtype))
    h = _layernorm(h, params["embed_norm_w"], params["embed_norm_b"],
                   cfg.norm_eps)
    body = _rematerialized(block, "dots") if cfg.remat else block
    for lp in params["layers"]:
        # tapped, then cast, inside the loop (see llama._layer_stack)
        lp = {n: w.to(cfg.dtype) for n, w in grad_tap(lp).items()}
        h = body(h, lp, cfg, par, mask)
    return h


def classify(params, tokens, cfg: BertConfig,
             par: ParallelSpec = ParallelSpec(), token_types=None, mask=None):
    """Sequence-classification logits ``[B, num_labels]`` (pooled [CLS])."""
    h = encode(params, tokens, cfg, par, token_types, mask)
    cls = h[:, 0, :]
    pooled = torch.tanh(cls @ params["pooler_w"].to(cls.dtype)
                        + params["pooler_b"].to(cls.dtype))
    return (pooled @ params["cls_w"].to(pooled.dtype)
            + params["cls_b"].to(pooled.dtype)).float()


def loss_fn(params, tokens, labels, cfg: BertConfig,
            par: ParallelSpec = ParallelSpec(), token_types=None, mask=None):
    """Mean classification cross-entropy over the local batch (the step
    averages it over dp)."""
    # the leaves outside the layer stack, tapped as one (the stack is
    # tapped per layer in encode); the identity outside overlapped_backprop
    params = tap_root(params)
    logits = classify(params, tokens, cfg, par, token_types, mask)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0].mean()


def make_dp_finetune_step(cfg: BertConfig, optimizer: Callable,
                          reduce_grads: bool = False,
                          pmesh: Optional[ParallelMesh] = None,
                          device: DeviceLike = None):
    """The data-parallel fine-tune step: per-rank loss and gradients by
    ``loss.backward()``, the optimizer's step, the loss averaged over dp.
    Returns a :class:`horovod_tpu_torch.training.TrainStep` whose
    ``step_fn(params, opt_state, tokens, labels)`` returns ``(params,
    opt_state, loss)``.

    ``optimizer`` is a factory called with the list of parameters
    (:data:`finetune_optimizer` matches ``optax.adamw(5e-5)``).
    ``reduce_grads=True`` averages the gradients over dp through the
    engine, with the loss in the same submission (Sum, postscale 1/dp);
    leave it False when the optimizer reduces them itself
    (``hvd.DistributedOptimizer``).  The mesh is ``MeshConfig(dp=
    hvd.size())`` when the runtime is initialized, else one device:
    ``device``, or the CUDA device when None.  Each call of ``step_fn``
    and ``grads_fn`` records a ``step`` span with its phases
    (``tracing.steps``).
    """
    pmesh = resolve_mesh(pmesh, device)
    device = pmesh.devices[0]
    ps, dp = pmesh.process_set, pmesh.config.dp
    par = ParallelSpec(dp_axis="dp" if dp > 1 else None)

    def average(params, grads, loss):
        # dp averages the per-rank mean losses: one submission by leaf
        # path, the loss in a gradient bucket
        if ps is not None:
            sum_scaled_(grads + [loss], [f"grad.{p}" for p in tree_paths(
                params)] + ["loss"], ps, 1.0 / dp)

    def grads_fn(params, tokens, labels):
        """The loss and gradients of a step, averaged over dp."""
        with tracing.step():
            with tracing.phase("forward"):
                loss = loss_fn(params, tokens, labels, cfg)
            with tracing.phase("backward"):
                grads = list(torch.autograd.grad(loss, tree_leaves(params)))
            loss = loss.detach()
            average(params, grads, loss)
        it = iter(grads)
        return loss, tree_map(lambda _: next(it), params)

    def step_fn(params, opt_state, tokens, labels):
        with tracing.step():
            with tracing.phase("forward"):
                loss = loss_fn(params, tokens, labels, cfg)
            with tracing.phase("backward"):
                loss.backward()
            loss = loss.detach()
            if reduce_grads:
                average(params, [p.grad for p in tree_leaves(params)], loss)
            elif ps is not None:
                with tracing.phase("exchange"):
                    loss = api.allreduce(loss, op=runtime.Average,
                                         name="loss", process_set=ps)
            with tracing.phase("optimizer"):
                opt_state.step()
                opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    def opt_init(params):
        return optimizer(trainable_leaves(params))

    def init_fn(seed: int = 0):
        params = init_params(cfg, seed, device=device)
        return params, opt_init(params)

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     grads_fn=grads_fn, par=par, mesh=pmesh, device=device)


def count_params(cfg: BertConfig) -> int:
    D, H, Dh, F_, L, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                          cfg.n_layers, cfg.vocab_size)
    per_layer = 4 * (D * H * Dh + H * Dh) + 2 * D * F_ + F_ + D + 4 * D
    emb = V * D + cfg.max_seq_len * D + cfg.type_vocab_size * D + 2 * D
    head = D * D + D + D * cfg.num_labels + cfg.num_labels
    return emb + L * per_layer + head
