"""Parity of horovod_tpu_torch.models.llama with horovod_tpu.models.llama.

Weights come from the JAX package's ``init_params`` and cross as numpy
through ``horovod_tpu_torch.convert``; tokens come from a numpy seed.  The
loss and every gradient leaf are compared.

Tolerances: at fp32 both sides compute the same arithmetic in another
order, so loss and gradients agree to rtol 1e-5 / atol 1e-6 (gradient
leaves are ~1e-3..1e-1).  At bf16 every matmul output and activation is
rounded to 8 mantissa bits, at places that differ between XLA and
PyTorch: at the bf16 case below each side's gradient leaves lie up to
2.7e-2 of the leaf's largest entry from an fp32 run of the same weights,
so each leaf is held to 4e-2 of its largest entry and the loss to 2e-3
relative.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.tree import tree_leaves

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def torch_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return tl.LlamaConfig(**fields)


def jax_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))


def batch(vocab, B, T, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, T)).astype(np.int32),
            rng.randint(0, vocab, (B, T)).astype(np.int32))


def jax_loss_grads(jcfg, np_params, toks, tgts):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jl.loss_fn(p, jnp.asarray(toks), jnp.asarray(tgts), jcfg,
                             jl.ParallelSpec())))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def torch_loss_grads(tcfg, np_params, toks, tgts):
    params = convert.llama_params_from_numpy(np_params, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tl.loss_fn(params, torch.from_numpy(toks), torch.from_numpy(tgts),
                      tcfg)
    loss.backward()
    loss = loss.item()
    grads = {"embed": params["embed"].grad,
             "layers": [{n: w.grad for n, w in lp.items()}
                        for lp in params["layers"]],
             "final_norm": params["final_norm"].grad}
    return loss, convert.llama_params_to_numpy(grads)


def assert_grads_close(jg, tg, rtol, atol, rel_to_max=False):
    for path, a in jax.tree_util.tree_leaves_with_path(jg):
        keys = [k.key for k in path]
        b = tg[keys[0]] if len(keys) == 1 else tg[keys[0]][keys[1]]
        if rel_to_max:
            np.testing.assert_allclose(
                b, a, rtol=0, atol=rtol * np.abs(a).max(), err_msg=str(keys))
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=str(keys))


TINY = jl.tiny(vocab=64, seq=64)


@pytest.mark.parametrize("name,over", [
    ("remat_dots", {}),                              # the tiny() default
    ("remat_full_skip1", {"remat_policy": "full", "remat_skip_layers": 1}),
    ("no_remat", {"remat": False}),
    ("chunked_xent", {"loss_chunk": 32}),
])
def test_fp32_loss_and_grads_match_jax(name, over):
    """tiny() at fp32: head_dim 16, so both sides take their blockwise
    attention path."""
    jcfg = dataclasses.replace(TINY, **over)
    np_params = jax_params(jcfg)
    toks, tgts = batch(jcfg.vocab_size, 2, 64)
    jloss, jg = jax_loss_grads(jcfg, np_params, toks, tgts)
    tloss, tg = torch_loss_grads(torch_cfg(jcfg), np_params, toks, tgts)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, err_msg=name)
    assert_grads_close(jg, tg, rtol=1e-5, atol=1e-6)


def test_one_shot_loss_when_chunk_does_not_divide(caplog):
    """loss_chunk 48 does not divide T 64: both sides warn and take the
    one-shot cross-entropy (the main path's branch at seq 1024 with
    loss_chunk 2048)."""
    jcfg = dataclasses.replace(TINY, loss_chunk=48)
    np_params = jax_params(jcfg, seed=2)
    toks, tgts = batch(jcfg.vocab_size, 2, 64, seed=5)
    jloss, jg = jax_loss_grads(jcfg, np_params, toks, tgts)
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        tloss, tg = torch_loss_grads(torch_cfg(jcfg), np_params, toks, tgts)
    assert "does not divide" in caplog.text
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert_grads_close(jg, tg, rtol=1e-5, atol=1e-6)


def test_bf16_flash_path_matches_jax(monkeypatch):
    """bf16 compute at head_dim 64, T 128: JAX runs its Pallas kernels in
    interpret mode, the port the plain versions of its CUDA kernels."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jcfg = jl.LlamaConfig(vocab_size=256, d_model=128, n_layers=2,
                          n_heads=2, n_kv_heads=1, d_ff=256, max_seq_len=128,
                          remat=True, remat_policy="full",
                          remat_skip_layers=1)
    tcfg = torch_cfg(jcfg)
    toks, tgts = batch(jcfg.vocab_size, 2, 128)
    q = torch.zeros(2, 128, 2, 64, dtype=torch.bfloat16)
    assert jfa.supported(jnp.zeros((2, 128, 2, 64), jnp.bfloat16),
                         jnp.zeros((2, 128, 1, 64), jnp.bfloat16),
                         jnp.zeros((2, 128, 1, 64), jnp.bfloat16))
    assert tfa.supported(q, q[:, :, :1], q[:, :, :1])
    np_params = jax_params(jcfg)
    jloss, jg = jax_loss_grads(jcfg, np_params, toks, tgts)
    tloss, tg = torch_loss_grads(tcfg, np_params, toks, tgts)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-3)
    assert_grads_close(jg, tg, rtol=4e-2, atol=0, rel_to_max=True)


def test_forward_logits_match_jax():
    np_params = jax_params(TINY)
    toks, _ = batch(TINY.vocab_size, 2, 64)
    jlogits, _ = jl.forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                            jnp.asarray(toks), TINY, jl.ParallelSpec())
    params = convert.llama_params_from_numpy(np_params, device="cpu")
    tlogits, aux = tl.forward(params, torch.from_numpy(toks), torch_cfg(TINY))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    assert float(aux) == 0.0


def test_convert_round_trip_and_count_params():
    np_params = jax_params(TINY)
    back = convert.llama_params_to_numpy(
        convert.llama_params_from_numpy(np_params, device="cpu"))
    for path, a in jax.tree_util.tree_leaves_with_path(np_params):
        keys = [k.key for k in path]
        b = back[keys[0]] if len(keys) == 1 else back[keys[0]][keys[1]]
        np.testing.assert_array_equal(a, b)
    tcfg = torch_cfg(TINY)
    params = tl.init_params(tcfg, seed=0, device="cpu")
    n = sum(p.numel() for p in tree_leaves(params))
    assert n == tl.count_params(tcfg) == jl.count_params(TINY)
    ported = convert.llama_params_to_numpy(params)
    for path, a in jax.tree_util.tree_leaves_with_path(np_params):
        keys = [k.key for k in path]
        b = ported[keys[0]] if len(keys) == 1 else ported[keys[0]][keys[1]]
        assert a.shape == b.shape and a.dtype == b.dtype, keys


@pytest.mark.parametrize("over,par", [
    ({"n_experts": 4}, tl.ParallelSpec()),
    ({"vocab_parallel": True}, tl.ParallelSpec(tp_axis="tp")),
    ({}, tl.ParallelSpec(sp_axis="sp")),
    ({}, tl.ParallelSpec(pp_axis="pp")),
])
def test_unported_options_name_their_roadmap_item(over, par):
    """Every option is ported: MoE runs on one device; a tp, sp or pp
    axis needs its mesh's context (tests/test_torch_llama_parallel.py
    runs them over rank processes), and a pp axis first needs
    n_microbatches, with JAX's message."""
    cfg = dataclasses.replace(torch_cfg(TINY), **over)
    params = tl.init_params(cfg, device="cpu")
    toks = torch.zeros(1, 64, dtype=torch.long)
    if par.pp_axis is not None:
        with pytest.raises(ValueError, match="pipeline parallelism needs "
                                             "n_microbatches > 0"):
            tl.loss_fn(params, toks, toks, cfg, par)
        with pytest.raises(ValueError, match="ParallelMesh context"):
            tl.loss_fn(params, toks, toks, cfg, par, n_microbatches=1)
    elif par.tp_axis or par.sp_axis:
        with pytest.raises(ValueError, match="ParallelMesh context"):
            tl.loss_fn(params, toks, toks, cfg, par)
    else:
        assert np.isfinite(tl.loss_fn(params, toks, toks, cfg, par).item())
