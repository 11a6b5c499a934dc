"""Parity of horovod_tpu_torch.models.generate with horovod_tpu.models.generate.

Weights come from the JAX package's ``init_params`` at ``llama.tiny()``
(fp32, 2 layers) and cross as numpy; prompts come from numpy seeds.  Each
case runs the JAX function on CPU jax and its port on CPU torch.

Tolerances: logits at fp32 agree to rtol 1e-5 / atol 1e-5 (sums of 64
products of unit-scale terms in another order differ by ~1e-6), as in
tests/test_torch_llama.py.  Greedy tokens are compared exactly.  On the
CPU, PyTorch's fp32 and bf16 matmuls give a row the same bits whatever
the number of rows beside it, so a batched row is held BITWISE to the
same row decoded alone, as the JAX package holds it
(tests/test_generate.py).  On the card that is not guaranteed (cuBLAS may
pick another kernel for one row); ``chip_smoke.py`` holds it there by the
margin rule instead (ROADMAP.md §C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import generate as jg
from horovod_tpu.models import llama as jl
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import generate as tg
from horovod_tpu_torch.models import llama as tl
from test_torch_llama import jax_params, torch_cfg

JCFG = jl.tiny(vocab=64, seq=64)
TCFG = torch_cfg(JCFG)
CPU = torch.device("cpu")
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """(numpy, jax, torch) parameters of the same tiny model."""
    np_params = jax_params(JCFG, seed=3)
    return (np_params, jax.tree_util.tree_map(jnp.asarray, np_params),
            convert.llama_params_from_numpy(np_params, device="cpu"))


def _ragged(lens, seed, vocab=64):
    rng = np.random.RandomState(seed)
    prompts = np.zeros((len(lens), max(lens)), np.int32)
    rows = []
    for b, n in enumerate(lens):
        row = rng.randint(0, vocab, (n,)).astype(np.int32)
        rows.append(row)
        prompts[b, :n] = row
    return prompts, rows


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def test_cached_forward_matches_full_forward_and_jax(weights):
    """Prefill logits == the full forward's; a decode step at position T
    equals the last position of a length-T+1 full forward; both equal
    the JAX package's cached forward."""
    _, jp, tp = weights
    toks = np.random.RandomState(0).randint(0, 64, (2, 9)).astype(np.int32)
    full, _ = tl.forward(tp, _t(toks), TCFG)
    cache = tg.init_kv_cache(TCFG, 2, 16, device=CPU)
    pre, cache = tg.forward_with_cache(tp, _t(toks[:, :8]), TCFG, cache)
    torch.testing.assert_close(pre, full[:, :8], rtol=RTOL, atol=ATOL)
    step, cache = tg.forward_with_cache(tp, _t(toks[:, 8:9]), TCFG, cache)
    torch.testing.assert_close(step[:, 0], full[:, 8], rtol=RTOL, atol=ATOL)
    assert cache.length == 9

    jc = jg.init_kv_cache(JCFG, 2, 16)
    jpre, jc = jg.forward_with_cache(jp, jnp.asarray(toks[:, :8]), JCFG, jc)
    jstep, _ = jg.forward_with_cache(jp, jnp.asarray(toks[:, 8:9]), JCFG, jc)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=RTOL,
                               atol=ATOL)


def test_cache_is_written_in_place(weights):
    """The port's cache tensors are the ones passed in, written in place
    (JAX threads new buffers): the k/v of every layer equal the JAX
    package's cache after the same prefill."""
    _, jp, tp = weights
    toks = np.random.RandomState(4).randint(0, 64, (2, 6)).astype(np.int32)
    cache = tg.init_kv_cache(TCFG, 2, 8, device=CPU)
    k_ptr = cache.k.data_ptr()
    _, out = tg.forward_with_cache(tp, _t(toks), TCFG, cache)
    assert out.k.data_ptr() == k_ptr and out.k is cache.k
    _, jc = jg.forward_with_cache(jp, jnp.asarray(toks), JCFG,
                                  jg.init_kv_cache(JCFG, 2, 8))
    np.testing.assert_allclose(out.k.numpy(), np.asarray(jc.k), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(jc.v), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed,B,Tp,n_new", [(1, 2, 5, 6), (2, 1, 1, 4),
                                             (3, 3, 12, 9)])
def test_greedy_generate_matches_jax_and_naive_recompute(weights, seed, B,
                                                         Tp, n_new):
    """Cached decode gives the tokens of re-running the full forward over
    the growing sequence, and JAX's greedy_generate's."""
    _, jp, tp = weights
    prompt = np.random.RandomState(seed).randint(0, 64, (B, Tp)).astype(
        np.int32)
    got = tg.greedy_generate(tp, TCFG, _t(prompt), n_new)
    seq, want = _t(prompt), []
    for _ in range(n_new):
        logits, _ = tl.forward(tp, seq, TCFG)
        want.append(torch.argmax(logits[:, -1], dim=-1))
        seq = torch.cat([seq, want[-1][:, None]], dim=1)
    assert torch.equal(got, torch.stack(want, dim=1))
    jgot = jg.greedy_generate(jp, JCFG, jnp.asarray(prompt), n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("lens,n_new,dtype", [
    ((3, 5, 9, 16), 7, torch.float32),
    ((1, 16), 4, torch.float32),
    ((8, 8, 8), 5, torch.float32),
    ((2, 11, 13, 6, 1, 16, 9, 4), 6, torch.float32),
    ((3, 5, 9, 16), 7, torch.bfloat16),
])
def test_batched_ragged_decode_per_row_and_jax(weights, lens, n_new, dtype):
    """The serving micro-batch's floor: a padded ragged batch through
    batched_greedy_decode is BIT-identical per row to greedy_generate on
    that row alone (same max_len), and (fp32) equal to JAX's batch."""
    np_params, jp, _ = weights
    cfg = dataclasses.replace(TCFG, dtype=dtype)
    tp = tg.cast_params(
        convert.llama_params_from_numpy(np_params, device="cpu"), cfg)
    prompts, rows = _ragged(lens, seed=sum(lens))
    max_len = prompts.shape[1] + n_new
    got = tg.batched_greedy_decode(tp, cfg, _t(prompts), _t(lens), n_new,
                                   max_len=max_len)
    for b, row in enumerate(rows):
        alone = tg.greedy_generate(tp, cfg, _t(row[None]), n_new,
                                   max_len=max_len)
        assert torch.equal(got[b], alone[0]), b
    if dtype == torch.float32:
        want = jg.batched_greedy_decode(
            jp, JCFG, jnp.asarray(prompts), jnp.asarray(lens, jnp.int32),
            n_new, max_len=max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_decode_reuses_a_cache_and_ignores_its_contents(weights):
    """A serving bucket's cache is reused across calls: what an earlier
    call (or garbage) left in it reaches no token."""
    _, _, tp = weights
    prompts, _ = _ragged((4, 11, 16), seed=8)
    max_len = 16 + 5
    fresh = tg.batched_greedy_decode(tp, TCFG, _t(prompts), _t((4, 11, 16)),
                                     5, max_len=max_len)
    cache = tg.init_kv_cache(TCFG, 3, max_len, device=CPU)
    cache.k.fill_(3.0)
    cache.v.fill_(-5.0)
    for _ in range(2):
        again = tg.batched_greedy_decode(tp, TCFG, _t(prompts),
                                         _t((4, 11, 16)), 5,
                                         max_len=max_len, cache=cache)
        assert torch.equal(again, fresh)
    with pytest.raises(ValueError, match="rows x slots"):
        tg.batched_greedy_decode(tp, TCFG, _t(prompts), _t((4, 11, 16)), 5,
                                 max_len=max_len + 1, cache=cache)


def test_batched_decode_pad_id_irrelevant(weights):
    """Pad tokens never leak through the per-row masking."""
    _, _, tp = weights
    lens = [4, 11]
    base, _ = _ragged(lens, seed=8)
    base = np.pad(base, ((0, 0), (0, 5)))
    alt = base.copy()
    for b, n in enumerate(lens):
        alt[b, n:] = 63
    outs = [tg.batched_greedy_decode(tp, TCFG, _t(p), _t(lens), 5,
                                     max_len=16 + 5) for p in (base, alt)]
    assert torch.equal(*outs)


def _paged_tables(lens, n_new, bs, M):
    """Private tables: row b's real blocks, then the trash block 0."""
    tables = np.zeros((len(lens), M), np.int64)
    for b, n in enumerate(lens):
        need = -(-(n + n_new) // bs)
        tables[b, :need] = 1 + b * M + np.arange(need)
    return tables


@pytest.mark.parametrize("bs", [1, 2, 4, 8])
def test_paged_decode_per_row_dense_and_jax(weights, bs):
    """paged_greedy_decode through a block pool — ragged lengths, tables
    with trash-block tails — is BIT-identical per row to greedy_generate
    alone at max_len == M * block_size, and equal to JAX's paged decode
    on the same tables."""
    _, jp, tp = weights
    lens = [3, 5, 9, 16]
    n_new = 8
    prompts, rows = _ragged(lens, seed=11)
    M = -(-(prompts.shape[1] + n_new) // bs)
    tables = _paged_tables(lens, n_new, bs, M)
    pool = tg.init_paged_kv_cache(TCFG, 1 + len(lens) * M, bs, device=CPU)
    got, out_pool = tg.paged_greedy_decode(tp, TCFG, _t(prompts), _t(lens),
                                           torch.as_tensor(tables), pool,
                                           n_new)
    assert out_pool.k is pool.k   # written in place, never copied
    for b, row in enumerate(rows):
        alone = tg.greedy_generate(tp, TCFG, _t(row[None]), n_new,
                                   max_len=M * bs)
        assert torch.equal(got[b], alone[0]), b
    jpool = jg.init_paged_kv_cache(JCFG, 1 + len(lens) * M, bs)
    want, jpool = jg.paged_greedy_decode(
        jp, JCFG, jnp.asarray(prompts), jnp.asarray(lens, jnp.int32),
        jnp.asarray(tables, jnp.int32), jpool, n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the real rows' blocks hold the same k/v as JAX's pool
    real = np.unique(tables[tables > 0])
    np.testing.assert_allclose(pool.k[:, real].numpy(),
                               np.asarray(jpool.k)[:, real], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("garbage", [0.0, 7.0, -1e4])
def test_paged_shared_prefix_blocks_and_trash_isolation(weights, garbage):
    """Two rows sharing physical prefix blocks (full prompt-covered blocks
    only) give the fully private run's tokens bit for bit — the duplicate
    prefill writes into a shared block carry identical values, and decode
    never writes one.  Garbage pre-seeded in the trash block reaches no
    row."""
    _, _, tp = weights
    rng = np.random.RandomState(13)
    head = rng.randint(0, 64, (8,))                    # 2 full blocks
    tails = [rng.randint(0, 64, (n,)) for n in (3, 6)]
    lens = [8 + t.size for t in tails]
    T, n_new, bs = max(lens), 6, 4
    M = -(-(T + n_new) // bs)
    prompts = np.zeros((2, T), np.int64)
    for b, t in enumerate(tails):
        prompts[b, :lens[b]] = np.concatenate([head, t])

    def run(shared):
        pool = tg.init_paged_kv_cache(TCFG, 1 + 2 * M, bs, device=CPU)
        pool.k[:, 0] = garbage
        pool.v[:, 0] = -garbage
        tables = np.zeros((2, M), np.int64)
        nxt = 1
        for b, n in enumerate(lens):
            for j in range(-(-(n + n_new) // bs)):
                if shared and j < 2 and b > 0:
                    tables[b, j] = tables[0, j]
                else:
                    tables[b, j] = nxt
                    nxt += 1
        return tg.paged_greedy_decode(tp, TCFG, _t(prompts), _t(lens),
                                      torch.as_tensor(tables), pool,
                                      n_new)[0]

    assert torch.equal(run(shared=True), run(shared=False))


@pytest.mark.parametrize("case", ["generate", "batched", "paged", "prefill"])
def test_overflow_raises(weights, case):
    _, _, tp = weights
    with pytest.raises(ValueError, match="max_len|covers|cannot take"):
        if case == "generate":
            tg.greedy_generate(tp, TCFG, _t(np.zeros((1, 10))), 10,
                               max_len=12)
        elif case == "batched":
            tg.batched_greedy_decode(tp, TCFG, _t(np.zeros((2, 10))),
                                     _t([3, 10]), 10, max_len=12)
        elif case == "paged":
            pool = tg.init_paged_kv_cache(TCFG, 4, 4, device=CPU)
            tg.paged_greedy_decode(tp, TCFG, _t(np.zeros((1, 10))), _t([10]),
                                   _t(np.ones((1, 3))), pool, 4)
        else:
            cache = tg.init_kv_cache(TCFG, 1, 8, device=CPU)
            tg.forward_with_cache(tp, _t(np.zeros((1, 9))), TCFG, cache)


def test_row_starts_is_decode_only_and_tables_need_the_pool(weights):
    _, _, tp = weights
    cache = tg.init_kv_cache(TCFG, 2, 16, device=CPU)
    with pytest.raises(ValueError, match="decode-only"):
        tg.forward_with_cache(tp, _t(np.zeros((2, 3))), TCFG, cache,
                              row_starts=_t([0, 1]))
    with pytest.raises(TypeError, match="come together"):
        tg.forward_with_cache(tp, _t(np.zeros((2, 1))), TCFG, cache,
                              block_tables=_t(np.ones((2, 2))))
    pool = tg.init_paged_kv_cache(TCFG, 4, 4, device=CPU)
    with pytest.raises(TypeError, match="come together"):
        tg.forward_with_cache(tp, _t(np.zeros((2, 1))), TCFG, pool)
    with pytest.raises(ValueError, match="block_tables rows"):
        tg.forward_with_cache(tp, _t(np.zeros((2, 1))), TCFG, pool,
                              block_tables=_t(np.ones((3, 2))))


def test_moe_decode_is_not_ported(weights):
    """MoE decode is ported now (ROADMAP.md A6 item 1): with the experts'
    capacity to spare, the cached prefill and one decode step give the
    full forward's logits, and the JAX package's cached forward's
    (tests/test_torch_moe.py holds the layer itself against JAX)."""
    del weights
    jcfg = dataclasses.replace(JCFG, n_experts=4, expert_top_k=2,
                               capacity_factor=8.0)
    cfg = torch_cfg(jcfg)
    np_params = jax_params(jcfg, seed=5)
    tp = convert.llama_params_from_numpy(np_params, device="cpu")
    toks = np.random.RandomState(3).randint(0, 64, (2, 6))
    full, _ = tl.forward(tp, _t(toks), cfg)
    cache = tg.init_kv_cache(cfg, 2, 8, device=CPU)
    pre, cache = tg.forward_with_cache(tp, _t(toks[:, :5]), cfg, cache)
    step, cache = tg.forward_with_cache(tp, _t(toks[:, 5:6]), cfg, cache)
    torch.testing.assert_close(pre, full[:, :5], rtol=0, atol=2e-4)
    torch.testing.assert_close(step[:, 0], full[:, 5], rtol=0, atol=2e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jcache = jg.init_kv_cache(jcfg, 2, 8)
    jpre, _ = jg.forward_with_cache(jp, jnp.asarray(toks[:, :5]), jcfg,
                                    jcache)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("temperature", [0.3, 1.0, 5.0])
def test_top_k_one_sampling_is_greedy(weights, temperature):
    _, _, tp = weights
    prompt = _t(np.random.RandomState(2).randint(0, 64, (2, 4)))
    greedy = tg.greedy_generate(tp, TCFG, prompt, 5)
    top1 = tg.generate(tp, TCFG, prompt, 5, temperature=temperature,
                       top_k=1, generator=torch.Generator().manual_seed(5))
    assert torch.equal(greedy, top1)
    zero = tg.generate(tp, TCFG, prompt, 5, temperature=0.0,
                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(greedy, zero)


def test_sampling_respects_top_k_and_its_generator(weights):
    """Every sampled first token lies among the prompt's top-k logits;
    the same generator seed gives the same tokens."""
    _, _, tp = weights
    prompt = _t(np.random.RandomState(6).randint(0, 64, (4, 5)))
    logits, _ = tg.forward_with_cache(
        tp, prompt, TCFG, tg.init_kv_cache(TCFG, 4, 5, device=CPU))
    top3 = torch.topk(logits[:, -1], 3, dim=-1).indices
    for seed in range(8):
        s = tg.generate(tp, TCFG, prompt, 3, temperature=2.0, top_k=3,
                        generator=torch.Generator().manual_seed(seed))
        assert (s[:, :1] == top3).any(dim=1).all()
        assert s.min() >= 0 and s.max() < 64
    a, b = (tg.generate(tp, TCFG, prompt, 6, temperature=1.0,
                        generator=torch.Generator().manual_seed(9))
            for _ in range(2))
    assert torch.equal(a, b)


def test_sampling_requires_a_generator(weights):
    _, _, tp = weights
    with pytest.raises(ValueError, match="Generator"):
        tg.generate(tp, TCFG, _t(np.zeros((1, 4))), 2, temperature=0.5)


def test_cast_params_casts_once_to_the_same_values(weights):
    """The serving forwards cast the weights when they are built; the
    decode then gives what per-call casts give."""
    np_params, _, _ = weights
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    fp32 = convert.llama_params_from_numpy(np_params, device="cpu")
    cast = tg.cast_params(fp32, cfg)
    assert cast["embed"].dtype == torch.bfloat16
    assert all(w.dtype == torch.bfloat16
               for lp in cast["layers"] for w in lp.values())
    assert torch.equal(cast["layers"][1]["wq"],
                       fp32["layers"][1]["wq"].to(torch.bfloat16))
    prompt = _t(np.random.RandomState(3).randint(0, 64, (2, 7)))
    assert torch.equal(tg.greedy_generate(fp32, cfg, prompt, 5),
                       tg.greedy_generate(cast, cfg, prompt, 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_tables_reproduce_llama_rope_bit_for_bit(dtype):
    """The decode forward computes the rotary tables once and applies
    them in every layer: bit for bit ``llama._rope``."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 4, 16, generator=g).to(dtype)
    positions = torch.randint(0, 500, (3, 5), generator=g)
    cfg = dataclasses.replace(TCFG, d_model=64, n_heads=4)
    assert torch.equal(tg._apply_rope(x, tg._rope_tables(positions, cfg)),
                       tl._rope(x, positions, cfg.rope_theta))

