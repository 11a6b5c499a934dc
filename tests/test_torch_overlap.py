"""Overlapped dispatch (``optim/overlap.py``) against the JAX package's.

* The plan: ``plan_bucket_layouts`` and ``plan_dispatch`` over the layer-
  aware entries of the 1B Llama's leaf shapes and of a tiny model, in the
  port (per-layer tensors) and in JAX (stacked ``[L, ...]`` leaves that
  ``build_layout`` expands per layer): the same buckets, each named by its
  (layer, leaf) entries, in the same order, padded alike, dispatched in
  the same order, and no bucket spans two layers.
* The autograd order: in a 4-layer Llama each layer's weights reach their
  gradient hooks right after that layer's backward, and under an armed
  ``overlapped_backprop`` layer L-1's buckets are issued before layer 0's
  backward runs (before the weight cast moved into the layer loop, every
  weight's gradient waited for layer 0).
* The toy model of tests/test_overlap.py (its layers unstacked), at 2 and
  4 gloo ranks (tests/torch_ranks.py ``case_overlap``): armed and unarmed
  (the boundary path) bit for bit equal, plain, sharded, int8 and both;
  ``backward_passes_per_step=2``; and ``DistributedOptimizer``'s hook
  dispatch equal bit for bit to the transform's plan.  Against JAX's
  ``DistributedOptimizer(overlap=True)`` under ``pmap``, both with
  ``adamw_lp(1e-2)`` and fp32 moments: 2e-5 relative, 1e-7 absolute
  (JAX's own tolerance for its overlap trajectories), 1e-4 and 1e-5 with
  int8, where a last-place difference in a gradient can move its element
  one quantization step.
* The context's contract: no nesting, no taps fired → a warning and the
  boundary path, a failed backward commits nothing, every leaf covered by
  exactly one tap.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu.optim import overlap as jov
from horovod_tpu.optim import precision as jprecision
from horovod_tpu.optim.distributed import \
    DistributedOptimizer as JDistributedOptimizer
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.optim import overlap as ov
from horovod_tpu_torch.optim import precision
from horovod_tpu_torch.tree import tree_leaves, tree_map

import torch_ranks as tr

AXIS = "ow"
WORLDS = (2, 4)


# -- the plan ---------------------------------------------------------------

def _jax_plan(**kw):
    return jov.OverlapPlan(**dict(dict(
        axis_name=AXIS, op="average", threshold_bytes=64 * 1024 * 1024,
        prescale=1.0, postscale=1.0, sharded=False, fmt=None, k=1), **kw))


def _port_plan(**kw):
    return ov.OverlapPlan(**dict(dict(
        process_set=None, op="average", threshold_bytes=64 * 1024 * 1024,
        prescale=1.0, postscale=1.0, sharded=False, fmt=None, k=1), **kw))


def _shapes(cfg):
    """JAX's stacked leaf shapes and the port's per-layer meta tensors."""
    jtree = jax.eval_shape(lambda k: jllama.init_params(cfg, k),
                           jax.random.PRNGKey(0))
    ttree = {"embed": None, "final_norm": None, "layers": [
        {} for _ in range(cfg.n_layers)]}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                ttree["layers"][i][keys[1]] = torch.empty(
                    leaf.shape[1:], device="meta", dtype=torch.float32)
        else:
            ttree[keys[0]] = torch.empty(leaf.shape, device="meta",
                                         dtype=torch.float32)
    return jtree, ttree


def _jax_named(layout, names):
    return [[(layout.entries[i].layer, names[layout.entries[i].leaf_pos]
              .rsplit("['", 1)[1].rstrip("']")) for i in bl.indices]
            for bl in layout.buckets]


def _port_named(layout):
    return [[(layout.layers[i], layout.names[i].rsplit(".", 1)[-1])
             for i in bl.indices] for bl in layout.buckets]


CFG_1B = jllama.LlamaConfig(vocab_size=32768, d_model=2048, n_layers=16,
                            n_heads=16, n_kv_heads=8, d_ff=8192,
                            max_seq_len=1024)


@pytest.mark.parametrize("cfg", [CFG_1B, jllama.tiny(vocab=64, seq=32)],
                         ids=["1b", "tiny"])
@pytest.mark.parametrize("kw,shards", [
    ({}, 1),
    ({"sharded": True}, 4),
    ({"fmt": "int8"}, 1),
    ({"sharded": True, "fmt": "int8"}, 2),
    ({"threshold_bytes": 4096}, 1),
], ids=["plain", "sharded", "int8", "int8_sharded", "small_buckets"])
def test_plan_matches_jax(cfg, kw, shards):
    from horovod_tpu import compression as jc
    from horovod_tpu_torch import compression as tc
    jkw, tkw = dict(kw), dict(kw)
    if "fmt" in kw:
        jkw["fmt"] = jc.resolve_wire_format(kw["fmt"])
        tkw["fmt"] = tc.resolve_wire_format(kw["fmt"])
    jtree, ttree = _shapes(cfg)
    jleaves, jlay = jov.build_layout(jtree, _jax_plan(**jkw), shards)
    from horovod_tpu.optim.distributed import _tree_leaves_sorted
    jnames = _tree_leaves_sorted(jtree)[1]
    _, tlay = ov.build_layout(ttree, _port_plan(**tkw), shards)
    assert _port_named(tlay) == _jax_named(jlay, jnames)
    strip = [(bl.sizes, bl.numel, bl.padded_numel, bl.shard_numel)
             for bl in tlay.buckets]
    assert strip == [(bl.sizes, bl.numel, bl.padded_numel, bl.shard_numel)
                     for bl in jlay.buckets]
    assert (tlay.dispatch.order, tlay.dispatch.layers) == \
        (jlay.dispatch.order, jlay.dispatch.layers)
    assert tlay.bucket_wire == jlay.bucket_wire
    for bl in tlay.buckets:
        assert len({tlay.layers[i] for i in bl.indices}) == 1
    # reverse layer order, the root (-1) buckets last
    order = [tlay.dispatch.layers[b] for b in tlay.dispatch.order]
    layered = [x for x in order if x >= 0]
    assert layered == sorted(layered, reverse=True)
    assert order[len(layered):] == [-1] * (len(order) - len(layered))
    if cfg is CFG_1B and kw == {}:
        # 5 buckets a layer (the norms, w_down, w_gate, w_up, the
        # attention projections), embed and final_norm apart
        assert len(tlay.buckets) == 16 * 5 + 2


# -- the autograd order -----------------------------------------------------

def _four_layers():
    return dataclasses.replace(llama.tiny(vocab=64, seq=32), n_layers=4,
                               dtype=torch.bfloat16, remat=False)


def _hooked(monkeypatch, events, token=None):
    """Patch llama.block so every layer's output records its gradient's
    arrival (the moment the next layer's backward is done) with the
    buckets issued so far."""
    orig = llama.block

    def block(x, lp, cfg, par, positions):
        y, aux = orig(x, lp, cfg, par, positions)
        k = sum(1 for e in events if e[0] == "fwd")
        events.append(("fwd", k))
        y.register_hook(lambda g, k=k: events.append(
            ("act", k, list(token.issued) if token else None)))
        return y, aux

    monkeypatch.setattr(llama, "block", block)


def test_each_layer_reaches_its_weights_before_the_previous_layer(
        monkeypatch):
    cfg = _four_layers()
    params = llama.init_params(cfg, 0, device="cpu")
    events = []
    for i, lp in enumerate(params["layers"]):
        for n, w in lp.items():
            w.requires_grad_(True)
            w.register_post_accumulate_grad_hook(
                lambda p, i=i, n=n: events.append(("w", i, n)))
    _hooked(monkeypatch, events)
    toks = torch.randint(0, 64, (2, 32), generator=torch.Generator()
                         .manual_seed(0))
    llama.loss_fn(params, toks, toks.roll(1, 1), cfg).backward()
    bwd = [e for e in events if e[0] != "fwd"]
    act = {e[1]: i for i, e in enumerate(bwd) if e[0] == "act"}
    last_w = {L: max(i for i, e in enumerate(bwd)
                     if e[0] == "w" and e[1] == L) for L in range(4)}
    # every weight of layer L has its gradient before layer L-1's backward
    # begins (marked by the arrival of layer L-1's output gradient... the
    # act hook of layer L-1 fires when layer L's backward is done)
    for L in range(1, 4):
        assert last_w[L] < act[L - 1], bwd


def test_armed_dispatch_issues_the_last_layer_before_layer_0(monkeypatch):
    cfg = _four_layers()
    hvd.init(device="cpu")
    try:
        params = llama.init_params(cfg, 0, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tx = hvd.DistributedGradientTransform(
            precision.adamw_lp(1e-3), overlap=True, threshold_bytes=4096,
            wire_format="none")
        state = tx.init(params)
        layout = ov.plan_for(tx).layout
        events = []
        toks = torch.randint(0, 64, (2, 32), generator=torch.Generator()
                             .manual_seed(0))
        with hvd.overlapped_backprop(tx) as token:
            _hooked(monkeypatch, events, token)
            loss = llama.loss_fn(params, toks, toks.roll(1, 1), cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        assert all(g is None for g in grads)
        layer0 = next(e for e in events if e[:2] == ("act", 0))
        issued_before = {layout.dispatch.layers[b] for b in layer0[2]}
        assert {3, 2, 1} <= issued_before and -1 not in issued_before
        assert 0 not in issued_before
        # every bucket went out, in schedule order
        assert token.issued == list(layout.dispatch.order)
        before = [p.detach().clone() for p in leaves]
        it = iter(grads)
        tx.update(tree_map(lambda _: next(it), params), state, params)
        assert all(not torch.equal(a, b) for a, b in zip(before, leaves))
    finally:
        hvd.shutdown()


# -- the toy at 2 and 4 ranks ----------------------------------------------

class _Worlds(dict):
    def __init__(self, tmp_path_factory):
        super().__init__()
        self._tmp = tmp_path_factory

    def __missing__(self, world):
        self[world] = tr.launch(world, ["overlap"],
                                self._tmp.mktemp(f"overlap{world}"))
        return self[world]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def _jax_toy_loss(params, x):
    params = jov.tap_root(params)
    h = x @ params["embed"]

    def body(h, lp):
        lp = jov.grad_tap(lp)
        return jnp.tanh(h @ lp["w"] + lp["b"]), None

    h, _ = jax.lax.scan(body, h, params["layers"])
    return ((h * params["final_norm"]) ** 2).sum()


def jax_toy(n, xs, **kw):
    """JAX's overlapped toy trajectory (armed, with the count for k > 1)."""
    kw = dict({"wire_format": "none", "wire_block_size": tr.ZBLOCK}, **kw)
    tx = JDistributedOptimizer(
        jprecision.adamw_lp(tr.ZLR, mu_dtype=jnp.float32,
                            nu_dtype=jnp.float32),
        axis_name=AXIS, threshold_bytes=256, overlap=True, **kw)
    k = kw.get("backward_passes_per_step", 1)
    params = jax.tree_util.tree_map(jnp.asarray, tr.toy_params())
    devs = jax.devices()[:n]
    state = jax.pmap(lambda p, _: tx.init(p), axis_name=AXIS,
                     in_axes=(None, 0), devices=devs)(params, np.zeros(n))

    def step(p, s, xb):
        with jov.overlapped_backprop(tx, **({"count": s.count} if k > 1
                                            else {})):
            _, g = jax.value_and_grad(_jax_toy_loss)(p, xb)
        u, ns = tx.update(g, s, p)
        return optax.apply_updates(p, u), ns

    f = jax.pmap(step, axis_name=AXIS, in_axes=(None, 0, 0), devices=devs)
    for X in xs:
        pk, state = f(params, state, jnp.asarray(X))
        params = jax.tree_util.tree_map(lambda a: a[0], pk)
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "w": params["layers"]["w"], "b": params["layers"]["b"]}


def _equal(a, b):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _close(a, b, rtol, atol):
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", sorted(tr.OVERLAP_CONFIGS))
@pytest.mark.parametrize("world", WORLDS)
def test_overlapped_toy_matches_jax(ranks, world, name):
    runs = [r["overlap"] for r in ranks[world]]
    for r in range(world):
        _equal(runs[r][f"{name}.armed"], runs[0][f"{name}.armed"])
    # the taps' in-backprop buckets and the boundary path: one plan
    _equal(runs[0][f"{name}.armed"], runs[0][f"{name}.unarmed"])
    want = jax_toy(world, tr.toy_batches(world, 3, 1),
                   **tr.OVERLAP_CONFIGS[name])
    rtol, atol = (1e-4, 1e-5) if "int8" in name else (2e-5, 1e-7)
    _close(runs[0][f"{name}.armed"], want, rtol, atol)
    if "int8" not in name:
        _close(runs[0][f"{name}.armed"], runs[0]["off"], 2e-5, 1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_overlap_with_accumulation(ranks, world):
    runs = ranks[world][0]["overlap"]
    xs = tr.toy_batches(world, 4, 2)
    want = jax_toy(world, xs, backward_passes_per_step=2)
    for sharded in (False, True):
        _close(runs[f"k2.{sharded}"], runs["k2.off"], 2e-5, 1e-7)
        _close(runs[f"k2.{sharded}"], want, 2e-5, 1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_optimizer_hooks_dispatch_the_plan(ranks, world):
    runs = [r["overlap"] for r in ranks[world]]
    for r in range(world):
        _equal(runs[r]["distopt.True"], runs[0]["distopt.True"])
    # the hooks issue the transform's layer-aware plan, and without
    # overlap step() runs its flat plan: the same reductions, bit for bit
    _equal(runs[0]["distopt.True"], runs[0]["plain.armed"])
    _equal(runs[0]["distopt.False"], runs[0]["off"])


@pytest.mark.parametrize("world", WORLDS)
def test_scatter_place_carve_and_gather_agree(ranks, world):
    """scatter_place writes this rank's tile into zeros, carve_tiles cuts
    it back out, gather_updates rebuilds the summed tree from every
    rank's tiles (op Sum, so the sum over ranks is exact here)."""
    toy = tr.toy_params()
    want = {"embed": toy["embed"] * sum(range(1, world + 1)),
            "final_norm": toy["final_norm"] * sum(range(1, world + 1))}
    for r, res in enumerate(ranks[world]):
        t = res["overlap"]["tiles"]
        for a, b in zip(t["scattered"], t["carved"]):
            np.testing.assert_array_equal(a, b)
        for k, v in want.items():
            np.testing.assert_allclose(t["gathered"][k], v, rtol=1e-6)
        for i, lp in enumerate(t["gathered"]["layers"]):
            np.testing.assert_allclose(
                lp["w"], toy["layers"]["w"][i] * sum(range(1, world + 1)),
                rtol=1e-6)
            np.testing.assert_allclose(
                lp["b"], toy["layers"]["b"][i] * world
                + sum(range(world)), rtol=1e-6, atol=1e-6)


# -- the context's contract -------------------------------------------------

def _toy_setup(**kw):
    params = tr._toy_torch_params()
    tx = hvd.DistributedGradientTransform(
        tr._fp32_adamw_lp(1e-2), threshold_bytes=256, overlap=True,
        wire_format="none", **kw)
    return params, tx, tx.init(params)


def test_context_contract(caplog):
    hvd.init(device="cpu")
    try:
        params, tx, state = _toy_setup()
        leaves = tree_leaves(params)
        x = tr._t(tr.toy_batches(1, 1, 1)[0][0])
        with hvd.overlapped_backprop(tx):
            with pytest.raises(RuntimeError, match="do not nest"):
                with hvd.overlapped_backprop(tx):
                    pass
        # no tap fired: a warning, and the boundary path
        with caplog.at_level(logging.WARNING, "horovod_tpu_torch"):
            with hvd.overlapped_backprop(tx):
                loss = (params["embed"] ** 2).sum()
        assert "no grad taps fired" in caplog.text
        assert ov.plan_for(tx)._pending is None
        # a backward that raises commits nothing
        with pytest.raises(ZeroDivisionError):
            with hvd.overlapped_backprop(tx):
                torch.autograd.grad(tr.toy_loss(params, x), leaves,
                                    allow_unused=True)
                raise ZeroDivisionError
        assert ov.plan_for(tx)._pending is None
        # a tensor that is not a planned leaf cannot be tapped
        with hvd.overlapped_backprop(tx):
            with pytest.raises(ValueError, match="not a leaf"):
                ov.grad_tap({"w": torch.ones(2, requires_grad=True)})
        # a tap that covers only part of the tree: update names the rest
        with hvd.overlapped_backprop(tx):
            lp = ov.grad_tap(params["layers"][0])
            torch.autograd.grad((lp["w"].sum() + lp["b"].sum()),
                                list(params["layers"][0].values()),
                                allow_unused=True)
        with pytest.raises(ValueError, match="never reached"):
            tx.update(tree_map(torch.zeros_like, params), state, params)
        # outside a context the taps are the identity
        assert ov.grad_tap(params["layers"][0]) is params["layers"][0]
        assert ov.tap_root(params) is params
        plain = hvd.DistributedGradientTransform(
            tr._fp32_adamw_lp(1e-2), overlap=False, wire_format="none")
        with pytest.raises(ValueError, match="overlap=True"):
            with hvd.overlapped_backprop(plain):
                pass
        _, tx2, _ = _toy_setup(backward_passes_per_step=2)
        with pytest.raises(ValueError, match="count=state.count"):
            with hvd.overlapped_backprop(tx2):
                pass
        del loss
    finally:
        hvd.shutdown()
