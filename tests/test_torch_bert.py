"""Parity of horovod_tpu_torch.models.bert with horovod_tpu.models.bert.

Weights come from the JAX package's ``init_params`` and cross as numpy
through ``convert.bert_params_from_numpy`` (the stacked layers split into
a list); tokens and labels come from a numpy seed.  ``tiny()`` (fp32,
head_dim 16) takes the blockwise attention path on both sides.  A bf16
model at head_dim 64 and seq 128 takes the flash path: JAX runs its
Pallas kernels in interpret mode, the port the plain versions of its CUDA
kernels.  Over 2 and 4 gloo rank processes the fine-tune step under
``overlapped_backprop`` (the grad taps dispatching each layer's buckets)
equals the plain step.

Tolerances (the reasons of tests/test_torch_llama.py and
tests/test_torch_training.py): fp32 logits, loss and gradients rtol 1e-5 /
atol 1e-6; the masked and truncated inputs atol 1e-5 (the JAX test's);
bf16 loss rtol 2e-3 and each gradient leaf within 4e-2 of its largest
entry (each side lies up to 3e-2 of it from an fp32 run of the same
weights), but for the key biases, whose exact gradient is 0.  The 3-step
AdamW trajectories: losses rtol 1e-5, parameters atol 1e-5 on all but
0.1% of the model's entries and 2·lr per step everywhere (Adam divides a
gradient near 0 by its own root mean square, so its rounding can move
such an entry by up to lr).  The overlapped step reduces the same
gradients in other buckets, and a bucket's gloo sum may add in another
order: the same trajectory rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks as tr
from horovod_tpu.models import bert as jb
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import bert as tb
from horovod_tpu_torch.models.llama import ParallelSpec
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.tree import tree_leaves, tree_paths

WORLDS = (2, 4)
LR = 5e-5


def torch_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = {jnp.float32: torch.float32,
                       jnp.bfloat16: torch.bfloat16}[jcfg.dtype]
    fields["param_dtype"] = torch.float32
    return tb.BertConfig(**fields)


def jax_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jb.init_params(jcfg, jax.random.PRNGKey(seed)))


def batch(jcfg, B, T, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32),
            rng.randint(0, jcfg.num_labels, B).astype(np.int32))


def _flat_jax(tree):
    """JAX tree -> {port path: array}: the stacked layers split by index."""
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(a.shape[0]):
                out[f"layers.{i}.{keys[1]}"] = np.asarray(a[i])
        else:
            out[keys[0]] = np.asarray(a)
    return out


def _flat(tree):
    return {p: t.detach().float().numpy() for p, t in
            zip(tree_paths(tree), tree_leaves(tree))}


def jax_loss_grads(jcfg, np_params, toks, labels, mask=None):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jb.loss_fn(p, jnp.asarray(toks), jnp.asarray(labels),
                             jcfg, jb.ParallelSpec(), mask=mask)))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    return float(loss), _flat_jax(grads)


def torch_loss_grads(tcfg, np_params, toks, labels, mask=None):
    params = convert.bert_params_from_numpy(np_params, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = tb.loss_fn(params, torch.from_numpy(toks).long(),
                      torch.from_numpy(labels).long(), tcfg,
                      mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    grads = {p: t.grad.float().numpy() for p, t in
             zip(tree_paths(params), tree_leaves(params))}
    return loss.item(), grads


TINY = jb.tiny(vocab=64, seq=32, num_labels=3)


@pytest.mark.parametrize("remat", [True, False])
def test_fp32_logits_loss_and_grads_match_jax(remat):
    jcfg = dataclasses.replace(TINY, remat=remat)
    np_params = jax_params(jcfg)
    toks, labels = batch(jcfg, 4, 32)
    jlogits = jb.classify(jax.tree_util.tree_map(jnp.asarray, np_params),
                          jnp.asarray(toks), jcfg, jb.ParallelSpec())
    params = convert.bert_params_from_numpy(np_params, device="cpu")
    tlogits = tb.classify(params, torch.from_numpy(toks).long(),
                          torch_cfg(jcfg))
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    jloss, jg = jax_loss_grads(jcfg, np_params, toks, labels)
    tloss, tg = torch_loss_grads(torch_cfg(jcfg), np_params, toks, labels)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for path, a in jg.items():
        np.testing.assert_allclose(tg[path], a, rtol=1e-5, atol=1e-6,
                                   err_msg=path)


def test_masked_loss_and_grads_match_jax():
    """The dense masked path: two rows padded to 32 from 20 and 9 tokens."""
    np_params = jax_params(TINY, seed=3)
    toks, labels = batch(TINY, 2, 32, seed=4)
    mask = (np.arange(32)[None, :] < np.array([[20], [9]])).astype(np.int32)
    jloss, jg = jax_loss_grads(TINY, np_params, toks, labels, mask)
    tloss, tg = torch_loss_grads(torch_cfg(TINY), np_params, toks, labels,
                                 mask)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for path, a in jg.items():
        np.testing.assert_allclose(tg[path], a, rtol=1e-5, atol=1e-6,
                                   err_msg=path)


def test_bidirectional_not_causal():
    """A late token changes the first position's hidden state."""
    cfg = torch_cfg(TINY)
    params = tb.init_params(cfg, seed=0, device="cpu")
    t1 = torch.ones((1, 32), dtype=torch.long)
    t2 = t1.clone()
    t2[0, 30] = 5
    with torch.no_grad():
        h1, h2 = (tb.encode(params, t, cfg) for t in (t1, t2))
    assert h1.shape == (1, 32, cfg.d_model)
    assert not torch.allclose(h1[0, 0], h2[0, 0])


def test_attention_mask_matches_truncated():
    """Masked padding gives the [CLS] logits of the truncated sequence."""
    cfg = torch_cfg(TINY)
    params = tb.init_params(cfg, seed=0, device="cpu")
    short = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (1, 16)))
    padded = torch.cat([short, torch.zeros((1, 16), dtype=torch.long)], 1)
    mask = torch.cat([torch.ones((1, 16)), torch.zeros((1, 16))], 1).long()
    with torch.no_grad():
        full = tb.classify(params, short, cfg)
        masked = tb.classify(params, padded, cfg, mask=mask)
    np.testing.assert_allclose(masked.numpy(), full.numpy(), atol=1e-5)


def test_bf16_flash_path_matches_jax(monkeypatch):
    """bf16 at head_dim 64, seq 128 (BERT-base's attention shape), remat
    on: the flash kernels' plain versions here, Pallas interpret in JAX."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jcfg = jb.BertConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                         d_ff=256, max_seq_len=128, num_labels=4)
    z = jnp.zeros((2, 128, 2, 64), jnp.bfloat16)
    assert jfa.supported(z, z, z, causal=False)
    q = torch.zeros(2, 128, 2, 64, dtype=torch.bfloat16)
    assert tfa.unsupported_reason(q, q, q) is None
    np_params = jax_params(jcfg)
    toks, labels = batch(jcfg, 2, 128)
    jloss, jg = jax_loss_grads(jcfg, np_params, toks, labels)
    tfa.reset_launches()
    tloss, tg = torch_loss_grads(torch_cfg(jcfg), np_params, toks, labels)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-3)
    for path, a in jg.items():
        if path.endswith(".bk"):
            # a key bias adds q·bk to every score of a row, which the
            # softmax cancels: its exact gradient is 0 and both sides'
            # are bf16 rounding, held below the layer's bq gradient scale
            bq = np.abs(jg[path[:-2] + "bq"]).max()
            assert max(np.abs(a).max(), np.abs(tg[path]).max()) \
                <= 4e-2 * bq, path
            continue
        np.testing.assert_allclose(tg[path], a, rtol=0,
                                   atol=4e-2 * np.abs(a).max(), err_msg=path)
    # the plain versions ran: the counts are of launched kernels only
    assert tfa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}


def _trajectory_close(got, want, steps, lr=LR):
    """Within 1e-5 on all but 0.1% of the model's entries (the key biases,
    whose exact gradient is 0, are such entries throughout), and within
    2·lr a step everywhere."""
    far = 0
    for path, a in want.items():
        diff = np.abs(got[path] - a)
        far += int((diff > 1e-5).sum())
        assert diff.max() <= steps * 2 * lr, (path, diff.max())
    assert far <= 1e-3 * sum(a.size for a in want.values()), far


def test_finetune_step_matches_jax():
    """3 steps of make_dp_finetune_step (reduce_grads=True) against JAX's
    on a one-device dp mesh with optax.adamw(5e-5)."""
    np_params = jax_params(TINY, seed=5)
    batches = [batch(TINY, 8, 32, seed=10 + s) for s in range(3)]
    opt = optax.adamw(LR)
    mesh = jax.make_mesh((1,), ("dp",))
    step = jb.make_dp_finetune_step(TINY, mesh, "dp", opt, reduce_grads=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = opt.init(jparams)
    jlosses = []
    for toks, labels in batches:
        jparams, jstate, loss = step(jparams, jstate, jnp.asarray(toks),
                                     jnp.asarray(labels))
        jlosses.append(float(loss))

    ts = tb.make_dp_finetune_step(torch_cfg(TINY), tb.finetune_optimizer,
                                  reduce_grads=True, device="cpu")
    params = convert.bert_params_from_numpy(np_params, device="cpu")
    opt_state = ts.opt_init(params)
    losses = []
    for toks, labels in batches:
        params, opt_state, loss = ts.step_fn(
            params, opt_state, torch.from_numpy(toks).long(),
            torch.from_numpy(labels).long())
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _trajectory_close(_flat(params), _flat_jax(
        jax.tree_util.tree_map(np.asarray, jparams)), 3)
    # grads_fn: the loss and gradients at the final weights, as JAX's
    loss, grads = ts.grads_fn(params, torch.from_numpy(batches[0][0]).long(),
                              torch.from_numpy(batches[0][1]).long())
    jloss, jg = jax_loss_grads(TINY, convert.bert_params_to_numpy(params),
                               *batches[0])
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for path, g in _flat(grads).items():
        np.testing.assert_allclose(g, jg[path], rtol=1e-5, atol=1e-6,
                                   err_msg=path)


def test_convert_round_trip_and_count_params():
    np_params = jax_params(TINY)
    back = convert.bert_params_to_numpy(
        convert.bert_params_from_numpy(np_params, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(np_params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    cfg = torch_cfg(TINY)
    params = tb.init_params(cfg, seed=0, device="cpu")
    assert _flat(params).keys() == _flat_jax(np_params).keys()
    n = sum(p.numel() for p in tree_leaves(params))
    assert n == tb.count_params(cfg) == jb.count_params(TINY)
    base = tb.bert_base(num_labels=4)
    assert tb.count_params(base) == jb.count_params(jb.bert_base(4))
    assert base.head_dim == 64


def _jax_spec(s):
    return tuple(s)[1:] if len(tuple(s)) > 1 or tuple(s) == (None,) \
        else tuple(s)


@pytest.mark.parametrize("check", ["init_tp", "param_specs", "pp_ep",
                                   "mask_sp"])
def test_tp_sp_refusals_and_specs_match_jax(check):
    """What the slice's refusals guard now: tp init checks divisibility
    with JAX's message; the specs are JAX's PartitionSpecs leaf by leaf
    with the stacked layer dim dropped; pp and ep, which BERT has no
    layout for, raise; a mask with sp raises JAX's message."""
    cfg = torch_cfg(TINY)
    toks = torch.zeros(1, 32, dtype=torch.long)
    if check == "init_tp":
        full = tb.init_params(cfg, seed=3, device="cpu")
        tp2 = tb.init_params(cfg, seed=3, tp=2, device="cpu")
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(full), tree_leaves(tp2)))
        for f in (lambda: tb.init_params(cfg, tp=3, device="cpu"),
                  lambda: jb.init_params(TINY, jax.random.PRNGKey(0), tp=3)):
            with pytest.raises(ValueError,
                               match=r"heads\(4\)/d_ff\(128\) must divide "
                                     r"tp=3"):
                f()
    elif check == "param_specs":
        for tp in ("tp", None):
            jspec = jb.param_specs(jb.ParallelSpec(tp_axis=tp), TINY)
            tspec = tb.param_specs(ParallelSpec(tp_axis=tp), cfg)
            assert len(tspec["layers"]) == TINY.n_layers
            for k, v in jspec.items():
                if k == "layers":
                    for lp in tspec["layers"]:
                        assert sorted(lp) == sorted(v)
                        for n, sp in v.items():
                            assert tuple(sp)[0] is None
                            assert lp[n] == tuple(sp)[1:], (n, lp[n], sp)
                else:
                    assert tspec[k] == tuple(v), k
    elif check == "pp_ep":
        params = tb.init_params(cfg, device="cpu")
        for par in (ParallelSpec(pp_axis="pp"), ParallelSpec(ep_axis="ep")):
            with pytest.raises(ValueError, match="BERT has no pipeline or "
                                                 "expert-parallel layout"):
                tb.encode(params, toks, cfg, par)
    else:
        params = tb.init_params(cfg, device="cpu")
        msg = "attention masks require unsharded sequence"
        with pytest.raises(ValueError, match=msg):
            tb.encode(params, toks, cfg, ParallelSpec(sp_axis="sp"),
                      mask=torch.ones_like(toks))
        with pytest.raises(ValueError, match=msg):
            jb.encode(jax_params(TINY), jnp.zeros((1, 32), jnp.int32), TINY,
                      jb.ParallelSpec(sp_axis="sp"),
                      mask=jnp.ones((1, 32), jnp.int32))


# -- over rank processes ------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory, bert_mp_dir):
    import os
    os.environ["BERT_MP_DIR"] = str(bert_mp_dir)
    return tr.Worlds(tmp_path_factory, ["bert_overlap", "bert_mp"])


BERT_MP_B = 2


@pytest.fixture(scope="module")
def bert_mp_dir(tmp_path_factory):
    """TINY's JAX weights, a batch and the cotangents for the
    model-parallel ranks."""
    import json
    d = tmp_path_factory.mktemp("bert_mp")
    np.savez(d / "weights.npz", **_flat_stacked(jax_params(TINY)))
    rng = np.random.RandomState(7)
    np.savez(d / "inputs.npz",
             toks=rng.randint(0, 64, (BERT_MP_B, 32)).astype(np.int32),
             cot=rng.normal(size=(BERT_MP_B, 32, 64)).astype(np.float32),
             cot_logits=rng.normal(size=(BERT_MP_B, 3)).astype(np.float32))
    fields = {f.name: getattr(TINY, f.name)
              for f in dataclasses.fields(TINY)
              if f.name not in ("dtype", "param_dtype")}
    (d / "bert_mp.json").write_text(json.dumps({"cfg": fields}))
    return d


def _flat_stacked(tree):
    return {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


def _jax_mp_reference(d, with_logits):
    """Single-device JAX: h, logits and the gradients of
    sum(h · cot) (+ sum(logits · cot_logits)), by the port's paths."""
    io = np.load(d / "inputs.npz")
    toks = jnp.asarray(io["toks"])

    def f(p):
        h = jb.encode(p, toks, TINY, jb.ParallelSpec())
        loss = (h * io["cot"]).sum()
        logits = jb.classify(p, toks, TINY, jb.ParallelSpec())
        if with_logits:
            loss = loss + (logits * io["cot_logits"]).sum()
        return loss, (h, logits)

    (_, (h, logits)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jax_params(TINY)))
    return np.asarray(h), np.asarray(logits), _flat_jax(g)


MP_ATOL = 2e-4   # tests/test_bert.py's tp and sp tolerance


@pytest.mark.parametrize("world,name", [(2, "tp2"), (2, "sp2"),
                                        (4, "sp2_tp2")])
def test_tp_and_sp_match_jax(ranks, bert_mp_dir, world, name):
    """tests/test_bert.py:67 and :88 as rank processes: tp 2, sp 2 and
    tp 2 × sp 2 against the unsharded JAX model, the outputs (the
    sequence blocks assembled, the logits where there is no sp) and every
    leaf's gradient (summed over sp, the tp slices assembled along the
    dim param_specs shards), atol 2e-4."""
    mesh = tr.BERT_MP_MESHES[world][name]
    sp, tp = mesh.get("sp", 1), mesh.get("tp", 1)
    res = [r["bert_mp"][name] for r in ranks[world]]
    h, logits, grads = _jax_mp_reference(bert_mp_dir, sp == 1)
    # rank = sp_index * tp + tp_index (tp innermost)
    got_h = np.concatenate([res[i * tp]["h"] for i in range(sp)], axis=1)
    np.testing.assert_allclose(got_h, h, rtol=0, atol=MP_ATOL)
    for r in res:
        assert r["round_trip"]
        if sp == 1:
            np.testing.assert_allclose(r["logits"], logits, rtol=0,
                                       atol=MP_ATOL)
    specs = tb.param_specs(ParallelSpec(tp_axis="tp" if tp > 1 else None),
                           torch_cfg(TINY))
    from horovod_tpu_torch.models.llama import leaf_spec
    for path, want in grads.items():
        parts = [sum(res[i * tp + j]["grads"][path] for i in range(sp))
                 for j in range(tp)]
        dims = [d for d, a in enumerate(leaf_spec(specs, path))
                if a is not None]
        got = np.concatenate(parts, axis=dims[0]) if dims else parts[0]
        for j in range(1, tp):
            if not dims:   # tp-replicated: the same on every tp rank
                np.testing.assert_allclose(parts[j], parts[0], rtol=0,
                                           atol=1e-6, err_msg=path)
        np.testing.assert_allclose(got, want, rtol=0, atol=MP_ATOL,
                                   err_msg=f"{name} {path}")


@pytest.mark.parametrize("world", WORLDS)
def test_overlapped_step_equals_the_plain_step(ranks, world):
    """Each rank: the overlapped step's losses and weights after 3 steps as
    the plain step's; both the same on every rank; and the plain step as
    one process on the global batch."""
    results = [r["bert_overlap"] for r in ranks[world]]
    for res in results:
        np.testing.assert_allclose(res["overlap"]["losses"],
                                   res["plain"]["losses"], rtol=1e-5)
        _trajectory_close(res["overlap"]["params"], res["plain"]["params"],
                          tr.BERT_STEPS)
    for res in results[1:]:
        for kind in ("plain", "overlap"):
            assert res[kind]["losses"] == results[0][kind]["losses"]
            for path, a in results[0][kind]["params"].items():
                np.testing.assert_array_equal(res[kind]["params"][path], a)
    ts = tb.make_dp_finetune_step(tr.bert_cfg(), tb.finetune_optimizer,
                                  reduce_grads=True, device="cpu")
    params, opt_state = ts.init_fn(0)
    losses = []
    for s in range(tr.BERT_STEPS):
        toks, labels = (torch.from_numpy(a) for a in tr.bert_batch(s))
        params, opt_state, loss = ts.step_fn(params, opt_state, toks, labels)
        losses.append(loss.item())
    np.testing.assert_allclose(results[0]["plain"]["losses"], losses,
                               rtol=1e-5)
    _trajectory_close(results[0]["plain"]["params"], _flat(params),
                      tr.BERT_STEPS)
