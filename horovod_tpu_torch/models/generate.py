"""Autoregressive decoding with a KV cache for the Llama family.

Counterpart: ``horovod_tpu/models/generate.py``.  The cache is a static
``[L, B, max_len, Hkv, D]`` pair of tensors (the paged pool:
``[L, n_blocks, block, Hkv, D]``) that the forward writes IN PLACE, where
JAX threads a new buffer through ``lax.scan`` and donates the old one;
the decode loop is a Python loop over token positions, where JAX scans.
Attention over the cache masks invalid (future or unwritten) positions
instead of slicing, so every matmul keeps the shapes of its bucket.

The eager decode step is paced by the host, which issues its torch
calls one by one, so a forward computes what every layer shares once: the
rotary tables of its positions (``llama._rope``'s arithmetic, bit for
bit) and the attention mask; the weights are cast once, when a
serving forward is built (:func:`cast_params`); and the decode runs in
inference mode, which spares each call autograd's bookkeeping.

Decode runs none of the port's kernels: ``_cached_attention`` is the JAX
package's plain einsums (XLA fuses them there), so plain PyTorch is its
counterpart.  Parameters keep the port's layout (``models/llama.py``):
a list of per-layer dicts, ``[in, out]`` weights, the head tied to
``embed``.

Sampling (``temperature > 0``) draws from a ``torch.Generator``; JAX's
``jax.random.categorical`` stream cannot be reproduced in torch, so the
port's samples agree with JAX's in law, not token for token.  MoE decode
(``n_experts > 0``) raises naming ROADMAP.md A6, as the training
forward does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from .llama import LlamaConfig, ParallelSpec, _rmsnorm, check_slice, ffn

#: the mask's logit: its probability underflows to exactly 0 in fp32
_MASKED = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # [L, B, max_len, Hkv, D]
    v: torch.Tensor       # [L, B, max_len, Hkv, D]
    length: int           # tokens written so far


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device: DeviceLike = None) -> KVCache:
    """A zeroed dense cache on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


class PagedKVCache(NamedTuple):
    """A POOL of fixed-size cache blocks shared by all rows.

    Rows own logical sequences of pool blocks through a per-row
    block-index table ``[B, M]`` (``serving/paging.py``'s allocator hands
    the ids out).  Row ``b``'s logical position ``p`` lives in physical
    slot ``tables[b, p // block] * block + p % block``.
    """
    k: torch.Tensor       # [L, n_blocks, block, Hkv, D]
    v: torch.Tensor       # [L, n_blocks, block, Hkv, D]

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]


def init_paged_kv_cache(cfg: LlamaConfig, n_blocks: int, block_size: int,
                        dtype=None, device: DeviceLike = None) -> PagedKVCache:
    """A zeroed block pool on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    dtype = dtype or cfg.dtype
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def _cast(w, cfg: LlamaConfig):
    """``w`` in the compute dtype; a weight already in it is returned
    without a torch call (the host paces the decode)."""
    return w if w.dtype == cfg.dtype else w.to(cfg.dtype)


def cast_params(params: Dict, cfg: LlamaConfig) -> Dict:
    """Every leaf in the compute dtype, cast once.

    JAX casts the fp32 layers and the embedding to ``cfg.dtype`` inside
    each jitted call; a serving forward holds its weights frozen, so the
    port casts them when it is built and every ``.to(cfg.dtype)`` of the
    decode path is then a no-op: the same values, without re-reading the
    fp32 weights at every decode step."""
    def leaf(w):
        return w.to(cfg.dtype) if w.is_floating_point() else w
    return {"embed": leaf(params["embed"]),
            "layers": [{n: leaf(w) for n, w in lp.items()}
                       for lp in params["layers"]],
            "final_norm": leaf(params["final_norm"])}


def _rope_tables(positions, cfg: LlamaConfig):
    """The cos and sin of ``llama._rope`` at ``positions`` [B, T], each
    ``[B, T, 1, Dh/2]``: computed once a forward, shared by every layer's
    q and k."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (-torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs          # [B, T, Dh/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x, rope):
    """``llama._rope(x, positions, theta)`` from its tables, bit for bit;
    x ``[B, T, H, Dh]``."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _mask(positions, max_len: int):
    """``[B, 1, 1, T, max_len]``: True at the cache slots past each query
    position (causal and bounds at once), the slots attention masks."""
    slot = torch.arange(max_len, device=positions.device)
    return slot[None, None, None, None, :] > positions[:, None, None, :, None]


def _project_kv(x, lp, cfg: LlamaConfig, rope):
    B, T, _ = x.shape
    Dh = cfg.head_dim
    Hkv = cfg.n_kv_heads
    k = (x @ lp["wk"]).view(B, T, Hkv, Dh)
    v = (x @ lp["wv"]).view(B, T, Hkv, Dh)
    return _apply_rope(k, rope), v


def _cached_attention(x, lp, cfg: LlamaConfig, k_cache, v_cache, rope,
                      masked):
    """Attention of x's tokens against the cache prefix + x itself.

    ``x``: [B, T, D] new tokens, ``rope`` the tables of their absolute
    positions, ``masked`` their :func:`_mask`; ``k_cache/v_cache``:
    [B, max_len, Hkv, D] with the new k/v already written; ``lp`` the
    layer's weights in ``x``'s dtype.  Masks in fp32, then casts the
    probabilities to the compute dtype before the ``v`` product, in JAX's
    order: a masked slot's probability is exactly 0 whatever the slot
    holds.
    """
    B, T, _ = x.shape
    Dh = cfg.head_dim
    H = cfg.n_heads
    Hkv = cfg.n_kv_heads
    g = H // Hkv
    q = _apply_rope((x @ lp["wq"]).view(B, T, H, Dh), rope)
    # grouped GQA product against the un-repeated cache (repeating it
    # would multiply the bytes of this bandwidth-bound phase by g)
    qg = q.view(B, T, Hkv, g, Dh).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg,
                          k_cache.float()) * (Dh ** -0.5)
    scores = scores.masked_fill(masked, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bhgts,bshd->bthgd", probs, v_cache)
    return o.reshape(B, T, H * Dh) @ lp["wo"]


def _write_kv(x, lp, cfg: LlamaConfig, k_cache, v_cache, rope, start):
    """Project x to k/v, rope k, write both into the cache at ``start``."""
    k, v = _project_kv(x, lp, cfg, rope)
    T = x.shape[1]
    k_cache[:, start:start + T] = k.to(k_cache.dtype)
    v_cache[:, start:start + T] = v.to(v_cache.dtype)


def _write_kv_rows(x, lp, cfg: LlamaConfig, k_cache, v_cache, rope,
                   positions):
    """Project x to k/v, rope k, write each ROW at its own cache slot.

    The ragged batched decode's write (T == 1): row ``b`` writes at slot
    ``positions[b, 0]``.  Each (row, slot) pair is distinct, so the
    indexed write copies values and is deterministic."""
    k, v = _project_kv(x, lp, cfg, rope)
    rows = torch.arange(x.shape[0], device=x.device)
    slots = positions[:, 0]
    k_cache[rows, slots] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slots] = v[:, 0].to(v_cache.dtype)


def _write_kv_paged(x, lp, cfg: LlamaConfig, kc, vc, rope, positions,
                    tables):
    """Project x to k/v, rope k, scatter through the block-index table.

    ``kc/vc``: [n_blocks, block, Hkv, D], one layer's slice of the pool,
    written in place; ``positions`` [B, T] absolute; ``tables`` [B, M].
    Token ``(b, t)`` lands in flat physical slot
    ``tables[b, positions[b,t] // block] * block + positions % block``.

    Slots may repeat, and which duplicate write wins is unspecified on
    CUDA.  That is harmless for two reasons the callers keep true: rows
    sharing a prefix block write identical values into it (same tokens,
    same absolute positions, same weights), and everything else that
    collides lands in the trash block 0, whose logical positions no row
    ever attends unmasked.
    """
    k, v = _project_kv(x, lp, cfg, rope)
    nb, bs, Hkv, Dh = kc.shape
    phys = torch.gather(tables, 1, positions // bs)            # [B, T]
    slots = (phys * bs + positions % bs).reshape(-1)
    kc.view(nb * bs, Hkv, Dh).index_put_(
        (slots,), k.to(kc.dtype).reshape(-1, Hkv, Dh))
    vc.view(nb * bs, Hkv, Dh).index_put_(
        (slots,), v.to(vc.dtype).reshape(-1, Hkv, Dh))


def _gather_block_view(kc, vc, tables):
    """Each row's logical cache view through its block table:
    ``[n_blocks, block, Hkv, D]`` + ``[B, M]`` → two
    ``[B, M*block, Hkv, D]`` tensors whose position ``s`` is the row's
    absolute position ``s``: the dense layout ``_cached_attention``
    speaks, gathered."""
    _, bs, Hkv, Dh = kc.shape
    B, M = tables.shape
    return (kc[tables].reshape(B, M * bs, Hkv, Dh),
            vc[tables].reshape(B, M * bs, Hkv, Dh))


@torch.inference_mode()
def forward_with_cache(params, tokens, cfg: LlamaConfig, cache,
                       row_starts=None, block_tables=None):
    """Run ``tokens`` [B, T] through the model, extending ``cache``.

    Returns ``(logits [B, T, V], cache)``: the cache's tensors are the
    ones passed in, written in place, with ``length`` advanced.  Serves
    prefill (T = prompt length) and decode (T == 1).

    ``row_starts`` [B] gives each row its OWN absolute position (the
    ragged decode path): row ``b``'s token sits at ``row_starts[b]``,
    its k/v lands at that slot and the mask bounds attention there.
    Decode-only (T must be 1); ``length`` is not advanced, the caller
    tracks per-row lengths.

    ``block_tables`` [B, M] switches the cache to the PAGED layout:
    ``cache`` must be a :class:`PagedKVCache` and every read and write
    goes through the per-row table.  Paged prefill starts at position 0;
    paged decode takes ``row_starts``.  Parity with the dense path is
    bitwise at ``max_len == M * block_size``.
    """
    check_slice(cfg)
    par = ParallelSpec()  # the decode path is single-shard per replica
    B, T = tokens.shape
    paged = block_tables is not None
    if paged != isinstance(cache, PagedKVCache):
        raise TypeError(
            "block_tables and PagedKVCache come together: got "
            f"tables={'yes' if paged else 'no'} with "
            f"{type(cache).__name__} (dense KVCache takes no table; the "
            f"paged pool is unusable without one)")
    start = 0 if paged else cache.length
    if row_starts is None:
        positions = (torch.arange(T, device=tokens.device) + start
                     ).expand(B, T)
    else:
        if T != 1:
            raise ValueError(
                f"row_starts is decode-only (T == 1), got T={T}: ragged "
                f"prefill right-pads and uses the default path")
        positions = row_starts.to(torch.long)[:, None]
    if paged:
        block_tables = block_tables.to(torch.long)
        if block_tables.shape[0] != B:
            raise ValueError(
                f"block_tables rows {block_tables.shape[0]} != batch {B}")
    elif row_starts is None and start + T > cache.k.shape[2]:
        raise ValueError(f"cache of {cache.k.shape[2]} slots cannot take "
                         f"{T} tokens at position {start}")
    rope = _rope_tables(positions, cfg)
    width = (block_tables.shape[1] * cache.block_size if paged
             else cache.k.shape[2])
    masked = _mask(positions, width)
    h = F.embedding(tokens.to(torch.long), _cast(params["embed"], cfg))
    for i, lp in enumerate(params["layers"]):
        lp = {n: _cast(w, cfg) for n, w in lp.items()}
        kc, vc = cache.k[i], cache.v[i]
        attn_in = _rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        if paged:
            _write_kv_paged(attn_in, lp, cfg, kc, vc, rope, positions,
                            block_tables)
            k_view, v_view = _gather_block_view(kc, vc, block_tables)
        elif row_starts is None:
            _write_kv(attn_in, lp, cfg, kc, vc, rope, start)
            k_view, v_view = kc, vc
        else:
            _write_kv_rows(attn_in, lp, cfg, kc, vc, rope, positions)
            k_view, v_view = kc, vc
        h = h + _cached_attention(attn_in, lp, cfg, k_view, v_view, rope,
                                  masked)
        y, _aux = ffn(_rmsnorm(h, lp["mlp_norm"], cfg.norm_eps), lp, cfg,
                      par)
        h = h + y
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = h @ _cast(params["embed"], cfg).T
    if paged:
        return logits, cache
    return logits, KVCache(cache.k, cache.v,
                           start + T if row_starts is None else start)


def _select(logits, generator: Optional[torch.Generator],
            temperature: float, top_k: int):
    """One sampling decision per batch row.  temperature == 0 → greedy
    (the first maximum on a tie, as ``jnp.argmax``)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, _MASKED)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(params, cfg: LlamaConfig, prompt, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, generator: Optional[torch.Generator] = None):
    """Autoregressive decode: prefill the prompt, then one token at a
    time through the cache.

    ``prompt``: [B, T_prompt] token ids on the model's device.  Returns
    [B, max_new_tokens] int64 ids.  ``temperature=0`` is greedy;
    otherwise softmax sampling at that temperature from ``generator``
    (required, on the prompt's device), optionally truncated to the
    ``top_k`` highest logits.
    """
    B, Tp = prompt.shape
    max_len = max_len or (Tp + max_new_tokens)
    if Tp + max_new_tokens > max_len:
        raise ValueError(f"max_len={max_len} < prompt {Tp} + new "
                         f"{max_new_tokens}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a "
                         "torch.Generator (the rng)")
    if max_new_tokens <= 0:
        return torch.zeros((B, 0), dtype=torch.long, device=prompt.device)
    cache = init_kv_cache(cfg, B, max_len, device=prompt.device)
    logits, cache = forward_with_cache(params, prompt, cfg, cache)
    toks = [_select(logits[:, -1, :], generator, temperature, top_k)]
    # max_new_tokens - 1 decode steps: the prefill already chose the
    # first token, and the last chosen token needs no forward
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, toks[-1][:, None], cfg,
                                           cache)
        toks.append(_select(logits[:, -1, :], generator, temperature,
                            top_k))
    return torch.stack(toks, dim=1)


def greedy_generate(params, cfg: LlamaConfig, prompt, max_new_tokens: int,
                    max_len: Optional[int] = None):
    """Greedy decode (temperature-0 :func:`generate`)."""
    return generate(params, cfg, prompt, max_new_tokens, max_len=max_len)


def _last_logits(logits, lengths):
    """Each row's logits at its own last prompt position."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, lengths - 1]


@torch.inference_mode()
def batched_greedy_decode(params, cfg: LlamaConfig, prompts, lengths,
                          max_new_tokens: int,
                          max_len: Optional[int] = None,
                          cache: Optional[KVCache] = None):
    """Greedy decode over a RAGGED batch of right-padded prompts.

    ``prompts``: [B, T] right-padded to a common T (the pad id is
    irrelevant: pad k/v never survives the per-row position mask);
    ``lengths``: [B] true prompt lengths (1 <= lengths <= T).  Returns
    [B, max_new_tokens] ids where row ``b`` continues its own prompt from
    position ``lengths[b]``.  ``cache``, when given, is a
    ``[L, B, max_len]`` cache to reuse (a serving bucket's): every slot a
    row attends is written in this call before it is read, so what an
    earlier call left there reaches no logit.

    The serving micro-batch's correctness floor: each row equals
    :func:`greedy_generate` on that row alone with the same ``max_len``
    (tests/test_torch_generate.py).  Prefill runs the full-width
    forward (positions 0..T-1 are right for every row; pad positions
    deposit garbage k/v), each row's first token comes from its own last
    prompt logit, and decode steps write and attend at per-row positions
    ``lengths + i``, overwriting the pad garbage slot by slot.
    """
    B, T = prompts.shape
    max_len = max_len or (T + max_new_tokens)
    if T + max_new_tokens > max_len:
        raise ValueError(f"max_len={max_len} < padded prompt {T} + new "
                         f"{max_new_tokens}")
    if max_new_tokens <= 0:
        return torch.zeros((B, 0), dtype=torch.long, device=prompts.device)
    lengths = lengths.to(torch.long)
    if cache is None:
        cache = init_kv_cache(cfg, B, max_len, device=prompts.device)
    elif tuple(cache.k.shape[1:3]) != (B, max_len):
        raise ValueError(f"cache of {tuple(cache.k.shape[1:3])} rows x "
                         f"slots, expected {(B, max_len)}")
    cache = KVCache(cache.k, cache.v, 0)
    logits, cache = forward_with_cache(params, prompts, cfg, cache)
    toks = [torch.argmax(_last_logits(logits, lengths), dim=-1)]
    for i in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(
            params, toks[-1][:, None], cfg, cache, row_starts=lengths + i)
        toks.append(torch.argmax(logits[:, -1, :], dim=-1))
    return torch.stack(toks, dim=1)


@torch.inference_mode()
def paged_greedy_decode(params, cfg: LlamaConfig, prompts, lengths,
                        block_tables, cache: PagedKVCache,
                        max_new_tokens: int):
    """:func:`batched_greedy_decode` over a PAGED cache pool.

    ``block_tables`` [B, M] maps each row's logical block ``j``
    (positions ``[j*block, (j+1)*block)``) to a pool block id; rows need
    REAL blocks only up to ``ceil((lengths[b] + max_new_tokens) /
    block)``, and table entries past that may point at the trash block
    0 (their positions lie past every query position the row attends).

    Returns ``(tokens [B, max_new_tokens], cache)``: the pool is written
    in place, so a persistent serving pool keeps its prefix blocks across
    calls.  Each row equals sequential :func:`greedy_generate` on that
    row alone with ``max_len == M * block_size``.
    """
    B, T = prompts.shape
    M = block_tables.shape[1]
    bs = cache.block_size
    if T + max_new_tokens > M * bs:
        raise ValueError(
            f"block table covers {M}x{bs}={M * bs} slots < padded "
            f"prompt {T} + new {max_new_tokens}")
    if max_new_tokens <= 0:
        return (torch.zeros((B, 0), dtype=torch.long,
                            device=prompts.device), cache)
    lengths = lengths.to(torch.long)
    logits, cache = forward_with_cache(params, prompts, cfg, cache,
                                       block_tables=block_tables)
    toks = [torch.argmax(_last_logits(logits, lengths), dim=-1)]
    for i in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(
            params, toks[-1][:, None], cfg, cache, row_starts=lengths + i,
            block_tables=block_tables)
        toks.append(torch.argmax(logits[:, -1, :], dim=-1))
    return torch.stack(toks, dim=1), cache
