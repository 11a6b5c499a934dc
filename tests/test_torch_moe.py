"""Parity of horovod_tpu_torch.models.moe with horovod_tpu.models.moe.

The same numpy gates, tokens and weights go through the JAX package's
routing and MoE layer and through the port's, on the CPU.  The layer with
an expert axis and under tp runs over rank processes in
tests/test_torch_llama_parallel.py; MoE decode is in
tests/test_torch_generate.py.

Tolerances: ``dispatch`` is 0/1 from argmax picks and a float cumsum of
one-hots, the same arithmetic on both sides, so it is held bit for bit,
ties and dropped tokens included; ``combine`` and the aux loss come from
the same fp32 gates by a few products and one division, atol 1e-6.  The
layer's output and the loss's gradients at fp32 sum D or F products in
another order: rtol 1e-5 / atol 1e-6, tests/test_torch_llama.py's fp32
tolerances.  The layer's gradients are held to 1e-5 of each leaf's
largest entry: a router column whose terms cancel over the tokens ends
near 1e-7 on both sides, where the rounding of a sum of 32 unit terms
(~2e-6) decides its digits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu.models import moe as jmoe
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models import moe as tmoe
from test_torch_llama import torch_cfg

EXACT_ATOL = 1e-6
GRAD_REL = 1e-5


def _gates(N, E, seed, ties):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(N, E)).astype(np.float32)
    if ties:
        # coarse logits: many rows hold two or more equal maxima
        logits = np.round(logits * 2) / 2
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("N,E,k,capacity,ties", [
    (64, 4, 2, 40, False),    # room for every pick
    (64, 4, 2, 12, False),    # later picks overflow and drop
    (96, 8, 2, 9, True),      # tied gates: argmax takes the first maximum
    (50, 8, 1, 7, True),      # top-1, Switch-style
    (33, 4, 3, 20, True),     # three picks, N not a multiple of E
])
def test_top_k_dispatch_matches_jax(N, E, k, capacity, ties):
    gates = _gates(N, E, seed=N + E, ties=ties)
    jd, jc, ja = jmoe._top_k_dispatch(jnp.asarray(gates), k, capacity)
    td, tc, ta = tmoe._top_k_dispatch(torch.from_numpy(gates), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=EXACT_ATOL)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=0,
                               atol=EXACT_ATOL)
    # a dropped token has no slot: rows of dispatch sum to the picks kept
    assert td.sum(dim=(1, 2)).max().item() <= k
    if capacity < k * N // E:
        assert td.sum().item() < k * N


CFG = dataclasses.replace(jl.tiny(vocab=64, seq=32), n_experts=4,
                          expert_top_k=2)


def _layer(cfg, seed):
    """One layer's MoE params (JAX's init, layer 0) and tokens [2, 16, D]."""
    stacked = jmoe.init_moe_layer_params(
        jax.random.PRNGKey(seed), 1, cfg.d_model, cfg.d_ff, cfg.n_experts)
    lp = {n: np.asarray(w[0]) for n, w in stacked.items()}
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    return lp, x, dy


@pytest.mark.parametrize("capacity_factor", [2.0, 1.25, 0.5])
def test_moe_layer_forward_and_gradients_match_jax(capacity_factor):
    """y, the aux loss, and the gradients of sum(y·dy) + aux with respect
    to the tokens, the router and every expert weight; at 0.5 tokens
    drop."""
    cfg = dataclasses.replace(CFG, capacity_factor=capacity_factor)
    lp, x, dy = _layer(cfg, seed=int(capacity_factor * 8))

    def jloss(x, lp):
        y, aux = jmoe.moe_layer(x, lp, cfg, jl.ParallelSpec())
        return (y * dy).sum() + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), {n: jnp.asarray(w) for n, w in lp.items()})
    tx = torch.tensor(x, requires_grad=True)
    tlp = {n: torch.tensor(w, requires_grad=True) for n, w in lp.items()}
    ty, taux = tmoe.moe_layer(tx, tlp, torch_cfg(cfg), tl.ParallelSpec())
    ((ty * torch.from_numpy(dy)).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    for n, got, want in [("x", tx.grad, jg[0])] + [
            (n, tlp[n].grad, jg[1][n]) for n in lp]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=n)


def test_init_and_count_params_with_experts():
    """The port's MoE params per layer: the router and the experts in the
    JAX package's shapes, drawn from the seed's generator; count_params
    counts them (JAX's counts the dense MLP only)."""
    cfg = torch_cfg(CFG)
    p = tl.init_params(cfg, seed=3, device="cpu")
    jshapes = jax.eval_shape(lambda k: jl.init_params(CFG, k),
                             jax.random.PRNGKey(0))
    assert sorted(p["layers"][0]) == sorted(jshapes["layers"])
    for n, s in jshapes["layers"].items():
        assert tuple(p["layers"][0][n].shape) == s.shape[1:], n
    again = tl.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(p["layers"][1]["we_up"], again["layers"][1]["we_up"])
    n = sum(t.numel() for lp in p["layers"] for t in lp.values()) + \
        p["embed"].numel() + p["final_norm"].numel()
    assert tl.count_params(cfg) == n
    dense = dataclasses.replace(cfg, n_experts=0)
    assert tl.count_params(dense) == jl.count_params(
        dataclasses.replace(CFG, n_experts=0))


def test_moe_loss_adds_the_aux_term_as_jax():
    """loss_fn of a 2-layer MoE model: cross-entropy plus
    aux_loss_coef · aux / n_layers, against JAX's, with its gradients."""
    from test_torch_llama import (assert_grads_close, batch, jax_loss_grads,
                                  jax_params, torch_loss_grads)
    jcfg = dataclasses.replace(CFG, aux_loss_coef=0.5, capacity_factor=2.0)
    np_params = jax_params(jcfg, seed=4)
    toks, tgts = batch(jcfg.vocab_size, 2, 32, seed=6)
    jloss, jg = jax_loss_grads(jcfg, np_params, toks, tgts)
    tloss, tg = torch_loss_grads(torch_cfg(jcfg), np_params, toks, tgts)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert_grads_close(jg, tg, rtol=1e-5, atol=1e-6)
