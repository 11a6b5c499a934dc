"""Parity of horovod_tpu_torch.serving.paging with horovod_tpu.serving.paging.

The allocator is a copy: each case of tests/test_paging.py is replayed on
the port's ``BlockAllocator``, and a random sequence of grants and
releases runs through both packages' allocators side by side.  The
``PagedDecodeForward`` cases run the port's paged serving forward at
``llama.tiny()`` (fp32) against its dense one and against the JAX
package's, token for token.  Model-parallel serving
(``test_paging.py:207``) runs as rank processes (tests/torch_ranks.py
``mp_serve``) at worlds 2 and 4, bit for bit with the JAX package's
dense and model-parallel decode, its per-chip bytes exactly JAX's.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu.serving import paging as jpaging
from horovod_tpu.serving.shapes import ShapeBuckets as JShapeBuckets
from horovod_tpu_torch import convert
from horovod_tpu_torch.serving.paging import (BlockAllocator, BlocksExhausted,
                                              dense_kv_nbytes,
                                              kv_block_nbytes, row_blocks)
from horovod_tpu_torch.serving.shapes import ShapeBuckets
from test_torch_llama import jax_params, torch_cfg

JCFG = jl.tiny(vocab=64, seq=64)
TCFG = torch_cfg(JCFG)


@pytest.fixture(scope="module")
def np_params():
    return jax_params(JCFG, seed=3)


@pytest.fixture
def params(np_params):
    return convert.llama_params_from_numpy(np_params, device="cpu")


def _toks(seed, n):
    return np.random.RandomState(seed).randint(0, 64, (n,)).astype(
        np.int32)


# -- allocator ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_blocks_and_byte_helpers_exact(dtype):
    assert row_blocks(5, 4, 4) == 3          # ceil(9/4)
    assert row_blocks(8, 4, 4) == 3          # ceil(12/4)
    assert row_blocks(1, 1, 16) == 1
    item = 4 if dtype == torch.float32 else 2
    blk = kv_block_nbytes(TCFG, 4, dtype)
    assert blk == 2 * TCFG.n_layers * 4 * TCFG.n_kv_heads * TCFG.head_dim \
        * item
    dense = dense_kv_nbytes(TCFG, 3, 20, dtype)
    assert dense == 2 * TCFG.n_layers * 3 * 20 * TCFG.n_kv_heads \
        * TCFG.head_dim * item
    assert 3 * row_blocks(16, 4, 4) * blk == dense
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    assert blk == jpaging.kv_block_nbytes(JCFG, 4, jdtype)
    assert dense == jpaging.dense_kv_nbytes(JCFG, 3, 20, jdtype)


def test_allocator_alloc_release_and_reuse_across_requests():
    a = BlockAllocator(n_blocks=12, block_size=4, block_nbytes=10)
    toks = _toks(0, 10)                       # 2 full blocks + tail
    h1 = a.assign(toks, row_blocks(10, 4, 4))  # 4 blocks
    assert len(h1.blocks) == 4 and h1.shared == 0
    assert 0 not in h1.blocks                 # trash never granted
    st = a.stats()
    assert st["in_use"] == 4 and st["fresh"] == 4
    assert st["bytes_in_use"] == 40
    a.release(h1)
    st = a.stats()
    assert st["in_use"] == 0 and st["cached"] == 2
    assert st["free"] == a.capacity - 2
    h2 = a.assign(toks, 4)
    assert h2.shared == 2 and h2.blocks[:2] == h1.blocks[:2]
    assert a.stats()["reuse_hits"] == 2
    a.release(h2)
    h3 = a.assign(_toks(1, 10), 4)
    assert h3.shared == 0
    a.release(h3)


def test_allocator_cow_divergence_shares_head_only():
    a = BlockAllocator(n_blocks=12, block_size=4)
    head = _toks(2, 4)
    p1 = np.concatenate([head, _toks(3, 4)])
    p2 = np.concatenate([head, _toks(4, 4)])  # diverges at block 1
    h1 = a.assign(p1, 3)
    h2 = a.assign(p2, 3)
    assert h2.shared == 1
    assert h2.blocks[0] == h1.blocks[0] and h2.blocks[1] != h1.blocks[1]
    a.release(h1)
    assert a.stats()["in_use"] == 3           # h2's three blocks
    h3 = a.assign(p1, 3)
    assert h3.shared == 2
    a.release(h2)
    a.release(h3)


def test_allocator_exhaustion_rejects_and_rolls_back_atomically():
    a = BlockAllocator(n_blocks=5, block_size=4)   # 4 grantable
    assert a.can_admit(4) and not a.can_admit(5)
    before = a.stats()
    with pytest.raises(BlocksExhausted):
        a.assign(_toks(5, 20), 6)
    after = a.stats()
    assert after["in_use"] == before["in_use"] == 0
    assert after["free"] == before["free"] == 4
    assert after["cached"] == 0 and after["fresh"] == 0
    retry = a.assign(_toks(5, 20)[:16], 4)
    assert retry.shared == 0
    a.release(retry)
    h = a.assign(_toks(6, 4), 4)
    assert len(h.blocks) == 4
    with pytest.raises(BlocksExhausted):
        a.assign(_toks(7, 4), 1)
    a.release(h)


def test_allocator_lru_eviction_under_pressure():
    a = BlockAllocator(n_blocks=5, block_size=4)   # 4 grantable
    pa, pb = _toks(8, 4), _toks(9, 4)
    ha = a.assign(pa, 1)
    hb = a.assign(pb, 1)
    a.release(ha)
    a.release(hb)
    assert a.stats()["cached"] == 2 and a.stats()["free"] == 2
    h = a.assign(_toks(10, 20), 4)
    assert a.stats()["evictions"] == 2
    a.release(h)
    hb2 = a.assign(pb, 1)
    assert hb2.shared == 0                     # b's digest was evicted
    a.release(hb2)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_jax_under_random_traffic(seed):
    """Grants of prompts that share random heads, releases in random
    order and exhaustion under a small pool: the port's allocator grants
    the same blocks and keeps the same ledger as the JAX package's."""
    rng = np.random.RandomState(seed)
    heads = [rng.randint(0, 8, (rng.randint(1, 13),)) for _ in range(3)]
    ours = BlockAllocator(n_blocks=24, block_size=4, block_nbytes=7)
    theirs = jpaging.BlockAllocator(n_blocks=24, block_size=4,
                                    block_nbytes=7)
    live = []
    for _ in range(60):
        if live and rng.rand() < 0.4:
            h0, h1 = live.pop(rng.randint(len(live)))
            ours.release(h0)
            theirs.release(h1)
        else:
            head = heads[rng.randint(len(heads))]
            toks = np.concatenate([head, rng.randint(0, 8, (
                rng.randint(0, 9),))]).astype(np.int32)
            need = row_blocks(toks.size, rng.randint(1, 6), 4)
            try:
                h0 = ours.assign(toks, need)
            except BlocksExhausted:
                with pytest.raises(jpaging.BlocksExhausted):
                    theirs.assign(toks, need)
                continue
            h1 = theirs.assign(toks, need)
            assert (h0.blocks, h0.shared) == (h1.blocks, h1.shared)
            live.append((h0, h1))
        assert ours.stats() == theirs.stats()


# -- PagedDecodeForward -------------------------------------------------------

def _ragged_batch(lens, B, S, seed):
    rng = np.random.RandomState(seed)
    tokens = np.zeros((B, S), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.randint(0, 64, (n,))
    return tokens, np.asarray(list(lens) + [1] * (B - len(lens)), np.int32)


def test_paged_forward_parity_ledger_and_pad_rows(params):
    """The paged serving forward matches the dense one bit for bit on a
    ragged batch (block 4, new 4: equal logical width), pad rows point at
    trash and allocate nothing, and the ledger prices the batch at the
    exact per-row block count, under the dense equivalent."""
    from horovod_tpu_torch.serving.models import (llama_decode_forward,
                                                  paged_llama_decode_forward)
    b = ShapeBuckets(batch_buckets=(1, 2, 4), seq_buckets=(8, 16))
    dense = llama_decode_forward(params, TCFG, 4, b)
    paged = paged_llama_decode_forward(params, TCFG, 4, b, block_size=4)
    assert paged.wants_rows
    lens = [3, 7, 11]
    tokens, lengths = _ragged_batch(lens, 4, 16, seed=21)
    out_d = dense(tokens, lengths)
    out_p = paged(tokens, lengths, n_rows=3)
    np.testing.assert_array_equal(out_d[:3], out_p[:3])
    last = paged.stats()["kv"]["last"]
    exp_blocks = sum(row_blocks(n, 4, 4) for n in lens)
    assert last["rows"] == 3 and last["blocks"] == exp_blocks
    blk = paged.allocator.block_nbytes
    assert blk == kv_block_nbytes(TCFG, 4)
    assert last["bytes_in_use"] == exp_blocks * blk
    assert last["bytes_in_use"] < dense_kv_nbytes(TCFG, 4, 16 + 4)
    st = paged.allocator.stats()
    assert st["in_use"] == 0
    assert st["cached"] == sum(n // 4 for n in lens)
    paged(tokens, lengths, n_rows=3)
    assert paged.allocator.reuse_hits == sum(n // 4 for n in lens)


def test_paged_and_dense_forwards_match_jax(np_params, params):
    """The port's dense and paged serving forwards give the JAX package's
    paged serving forward's tokens on the same ragged batches."""
    from horovod_tpu.serving.models import \
        paged_llama_decode_forward as jpaged_fwd
    from horovod_tpu_torch.serving.models import (llama_decode_forward,
                                                  paged_llama_decode_forward)
    b = ShapeBuckets(batch_buckets=(2, 4), seq_buckets=(16,))
    jb = JShapeBuckets(batch_buckets=(2, 4), seq_buckets=(16,))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    theirs = jpaged_fwd(jp, JCFG, 5, jb, block_size=4)
    dense = llama_decode_forward(params, TCFG, 5, b)
    paged = paged_llama_decode_forward(params, TCFG, 5, b, block_size=4)
    for lens, B, seed in (((16, 2, 9), 4, 1), ((5,), 2, 2)):
        tokens, lengths = _ragged_batch(lens, B, 16, seed)
        want = np.asarray(theirs(tokens, lengths, n_rows=len(lens)))
        got_p = paged(tokens, lengths, n_rows=len(lens))
        got_d = dense(tokens, lengths)
        np.testing.assert_array_equal(got_p[:len(lens)], want[:len(lens)])
        np.testing.assert_array_equal(got_d[:len(lens)], want[:len(lens)])
    assert paged.kv_summary() == theirs.kv_summary()


def test_paged_forward_pool_persists_in_place(params):
    """The pool is two tensors for the forward's life: every call writes
    them in place (no per-call copy), and a repeated prompt's head blocks
    keep the k/v the first call wrote."""
    from horovod_tpu_torch.serving.models import paged_llama_decode_forward
    b = ShapeBuckets(batch_buckets=(1, 2), seq_buckets=(16,))
    paged = paged_llama_decode_forward(params, TCFG, 4, b, block_size=4)
    k, v = paged.pool.k, paged.pool.v
    ptrs = (k.data_ptr(), v.data_ptr())
    tokens, lengths = _ragged_batch((13,), 1, 16, seed=5)
    first = paged(tokens, lengths, n_rows=1)
    head = paged.allocator.assign(tokens[0, :13], 4)
    kept = k[:, list(head.blocks[:3])].clone()
    paged.allocator.release(head)
    again = paged(tokens, lengths, n_rows=1)
    np.testing.assert_array_equal(first, again)
    assert (paged.pool.k.data_ptr(), paged.pool.v.data_ptr()) == ptrs
    assert torch.equal(k[:, list(head.blocks[:3])], kept)
    assert paged.pool_nbytes == k.nbytes + v.nbytes


def test_paged_forward_sizing_guard_rejects_undersized_pool(params):
    from horovod_tpu_torch.serving.models import paged_llama_decode_forward
    b = ShapeBuckets(batch_buckets=(1, 2), seq_buckets=(8, 16))
    worst = 2 * row_blocks(16, 4, 4)
    with pytest.raises(ValueError, match="worst admitted batch"):
        paged_llama_decode_forward(params, TCFG, 4, b, block_size=4,
                                   n_blocks=worst)      # missing trash
    fwd = paged_llama_decode_forward(params, TCFG, 4, b, block_size=4,
                                     n_blocks=1 + worst)
    assert fwd.allocator.capacity == worst
    with pytest.raises(ValueError, match="max_seq_len"):
        paged_llama_decode_forward(params, TCFG, 60, b)


def test_mp_serving_refusals_match_jax(params):
    """What the refusals guard now: mp below 2 raises JAX's message, and
    a seq bucket plus the new tokens beyond max_seq_len raises before
    any rank is asked; without hvd.init() there is one rank."""
    from horovod_tpu.serving.models import mp_llama_decode_forward as jmp
    from horovod_tpu_torch.serving.models import mp_llama_decode_forward
    from horovod_tpu_torch.serving.worker import MeshSlicedForward
    b = ShapeBuckets(batch_buckets=(1,), seq_buckets=(8,))
    with pytest.raises(ValueError) as je:
        jmp(jax_params(JCFG, seed=3), JCFG, 4,
            JShapeBuckets(batch_buckets=(1,), seq_buckets=(8,)), mp=1)
    with pytest.raises(ValueError) as te:
        MeshSlicedForward(params, TCFG, 4, b, mp=1)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="max_seq_len"):
        mp_llama_decode_forward(params, TCFG, 60, b)
    with pytest.raises(ValueError, match="mp=2 needs 2 ranks"):
        mp_llama_decode_forward(params, TCFG, 4, b)


# -- model-parallel serving over rank processes -------------------------------

@pytest.fixture(scope="module")
def mp_ranks(tmp_path_factory, np_params):
    import os
    import torch_ranks
    d = tmp_path_factory.mktemp("mp_serve")
    np.savez(d / "params.npz", embed=np_params["embed"],
             final_norm=np_params["final_norm"],
             **{f"layers.{k}": v for k, v in np_params["layers"].items()})
    tokens, lengths = _mp_batch()
    np.savez(d / "inputs.npz", tokens=tokens, lengths=lengths)
    os.environ["MP_SERVE_DIR"] = str(d)
    return torch_ranks.Worlds(tmp_path_factory, ["mp_serve"])


def _mp_batch():
    """tests/test_paging.py:207's two ragged rows."""
    rng = np.random.RandomState(31)
    tokens = np.zeros((2, 8), np.int32)
    lens = [5, 8]
    for i, L in enumerate(lens):
        tokens[i, :L] = rng.randint(0, 64, (L,))
    return tokens, np.asarray(lens, np.int32)


@pytest.mark.parametrize("world", [2, 4])
def test_mp_forward_parity_and_per_chip_bytes(mp_ranks, np_params, world):
    """tests/test_paging.py:207 over rank processes: the weights sharded
    mp ways and gathered inside each call give JAX's dense and
    model-parallel decode bit for bit, on every rank of the slice, and
    the per-chip bytes are JAX's pricing exactly."""
    import torch_ranks
    from horovod_tpu.serving.models import (llama_decode_forward as jdense,
                                            mp_llama_decode_forward as jmp)
    from horovod_tpu.training import fsdp_param_specs
    jb = JShapeBuckets(batch_buckets=(1, 2), seq_buckets=(8,))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tokens, lengths = _mp_batch()
    dense = jdense(jparams, JCFG, 4, jb)
    want_two = np.asarray(dense(tokens, lengths))
    want_one = np.asarray(dense(tokens[1:], lengths[1:]))
    np.testing.assert_array_equal(
        np.asarray(jmp(jparams, JCFG, 4, jb, mp=2)(tokens, lengths)),
        want_two)
    shapes = jax.eval_shape(lambda: jparams)
    for mp in torch_ranks.MP_SERVE_DEGREES[world]:
        specs = fsdp_param_specs(shapes, mp, axis="hvd_serve_mp")
        exp = 0
        for sh, spec in zip(jax.tree_util.tree_leaves(shapes),
                            jax.tree_util.tree_leaves(
                                specs, is_leaf=lambda x: hasattr(x,
                                                                 "index"))):
            n = sh.size * sh.dtype.itemsize
            exp += n // mp if any(a is not None for a in spec) else n
        for rank, r in enumerate(mp_ranks[world]):
            res = r["mp_serve"][f"mp{mp}"]
            assert res["ranks"] == list(range(rank - rank % mp,
                                              rank - rank % mp + mp))
            np.testing.assert_array_equal(res["two"], want_two)
            np.testing.assert_array_equal(res["one"], want_one)
            st = res["stats"]
            assert st["mp"] == mp
            assert st["per_chip_param_nbytes"] == exp
            assert st["per_chip_param_nbytes"] < st["replica_param_nbytes"]


@pytest.mark.parametrize("world", [2, 4])
def test_mp_forward_serves_through_the_plane(mp_ranks, world):
    """The slice's leader answers the plane's requests through a
    ServingWorker (warm-up included) while the other ranks follow: each
    answer is the row's dense decode, and nothing is prepared twice."""
    runs = [r["mp_serve"]["plane"] for r in mp_ranks[world]]
    want = mp_ranks[world][0]["mp_serve"][f"mp{world}"]
    for i in range(3):
        got = runs[0]["answers"][f"r{i}"]
        assert got is not None
        row = i % 2
        np.testing.assert_array_equal(np.asarray(got),
                                      want["two"][row])
    assert runs[0]["recompiles"] == 0
    for r in runs[1:]:
        assert r["followed"] >= 2     # the warm-up's buckets, then batches


# -- the plane's KV ride-along ------------------------------------------------

def test_plane_serve_stats_carry_worker_kv_ledger(params):
    """A paged worker's kv_summary rides serve_push: the plane's stats
    grow per-worker ``kv`` ledgers and a job-level ``kv`` total."""
    from horovod_tpu_torch.runner.rpc import JsonRpcServer, json_request
    from horovod_tpu_torch.serving.models import paged_llama_decode_forward
    from horovod_tpu_torch.serving.plane import ServingPlane
    from horovod_tpu_torch.serving.worker import ServingWorker
    plane = ServingPlane(tick_ms=1.0, max_batch=2, seq_buckets="8",
                         deadline_ms=0)
    srv = JsonRpcServer(plane.rpc_handlers(), host="127.0.0.1",
                        secret=None)
    w = None
    try:
        fwd = paged_llama_decode_forward(params, TCFG, 4, plane.buckets,
                                         block_size=4)
        w = ServingWorker("127.0.0.1", srv.port, fwd, worker_id="0",
                          wait_s=1.0, secret=None, warmup=True)
        w.start()
        json_request("127.0.0.1", srv.port, "serve_submit",
                     {"id": "r0", "tokens": [3, 5, 7]}, secret=None,
                     timeout=10.0)
        res = json_request("127.0.0.1", srv.port, "serve_result",
                           {"id": "r0", "wait_s": 20.0}, secret=None,
                           timeout=30.0)
        assert res.get("done"), res
        st = plane.stats()
        kv = st["workers"]["0"]["kv"]
        assert kv["block_size"] == 4
        assert kv["bytes_capacity"] == \
            fwd.allocator.capacity * fwd.allocator.block_nbytes
        assert st["kv"]["bytes_capacity"] == kv["bytes_capacity"]
        assert w.stats()["forward"]["recompiles"] == 0
    finally:
        plane.close()
        if w is not None:
            w.stop()
            w.join(10)
            deadline = time.monotonic() + 10
            while w._thread.is_alive() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not w._thread.is_alive()
        srv.close()
