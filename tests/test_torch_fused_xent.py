"""Parity of horovod_tpu_torch.ops.fused_xent with horovod_tpu.ops.fused_xent.

The same numpy inputs go through both packages: the JAX kernels run in
Pallas interpret mode, the port runs the plain versions of its CUDA kernels
(its wrappers take them on CPU tensors).

Tolerances: at fp32 both sides form the same scores and sums in another
order, so the value agrees to rtol 1e-5 and the gradients to atol 1e-5, as
tests/test_fused_xent.py holds the JAX kernels against their reference;
lse and tgt (|x| <= ~7) to atol 1e-5.  With bf16 hidden states both sides
form the same exact products of bf16 values and sum them in fp32, so the
value still agrees to rtol 1e-5 and dW (fp32) to atol 1e-5.  dh comes back
in bf16: both sides round P − onehot to bf16 before P·W, where a last-bit
difference in a score can move P by one bf16 step, and then round dh to
bf16, so dh is held to 1e-2 of its largest entry (a bf16 step is 2^-8 =
3.9e-3 of the value it rounds).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu.ops import fused_xent as jfx
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import fused_xent as tfx
from test_torch_llama import (assert_grads_close, batch, jax_loss_grads,
                              jax_params, torch_cfg, torch_loss_grads)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jfx, "_INTERPRET", True)


def _inputs(B, T, D, V, seed):
    rng = np.random.RandomState(seed)
    h = (rng.randn(B, T, D) * 0.3).astype(np.float32)
    w = (rng.randn(V, D) * 0.1).astype(np.float32)
    y = rng.randint(0, V, (B, T)).astype(np.int32)
    return h, w, y


def _jax_value_grads(h, w, y, dtype=jnp.float32):
    val, (gh, gw) = jax.value_and_grad(jfx.fused_xent_mean, argnums=(0, 1))(
        jnp.asarray(h, dtype), jnp.asarray(w), jnp.asarray(y))
    assert gh.dtype == dtype and gw.dtype == jnp.float32
    return float(val), np.asarray(gh.astype(jnp.float32)), np.asarray(gw)


def _torch_value_grads(h, w, y, dtype=torch.float32):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = tfx.fused_xent_mean(ht, wt, torch.from_numpy(y))
    loss.backward()
    assert ht.grad.dtype == dtype and wt.grad.dtype == torch.float32
    return loss.item(), ht.grad.float().numpy(), wt.grad.numpy()


SHAPES = [(2, 16, 128, 256), (1, 8, 256, 128), (2, 8, 128, 256)]


@pytest.mark.parametrize("B,T,D,V", SHAPES)
def test_value_matches_jax(B, T, D, V):
    h, w, y = _inputs(B, T, D, V, seed=0)
    want = float(jfx.fused_xent_mean(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(y)))
    got = tfx.fused_xent_mean(torch.from_numpy(h), torch.from_numpy(w),
                              torch.from_numpy(y)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("B,T,D,V", SHAPES)
def test_grads_match_jax(B, T, D, V):
    h, w, y = _inputs(B, T, D, V, seed=1)
    jv, jgh, jgw = _jax_value_grads(h, w, y)
    tv, tgh, tgw = _torch_value_grads(h, w, y)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tgh, jgh, atol=1e-5)
    np.testing.assert_allclose(tgw, jgw, atol=1e-5)


def test_bf16_hidden_matches_jax():
    h, w, y = _inputs(2, 16, 128, 512, seed=2)
    jv, jgh, jgw = _jax_value_grads(h, w, y, jnp.bfloat16)
    tv, tgh, tgw = _torch_value_grads(h, w, y, torch.bfloat16)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tgh, jgh, atol=1e-2 * np.abs(jgh).max())
    np.testing.assert_allclose(tgw, jgw, atol=1e-5)


@pytest.mark.parametrize("B,T,D,V", SHAPES[:2])
def test_forward_lse_and_target_match_jax_blocked(B, T, D, V):
    """The port's flat ``[N]`` lse/tgt against JAX's blocked ``[nr,1,br]``."""
    h, w, y = _inputs(B, T, D, V, seed=3)
    N = B * T
    br, bv = jfx._blocks(N, V)
    jlse, jtgt = jfx._xent_fwd(jnp.asarray(h.reshape(N, D)), jnp.asarray(w),
                               jnp.asarray(y.reshape(N // br, 1, br)), br, bv)
    tlse, ttgt = tfx._xent_fwd(torch.from_numpy(h.reshape(N, D)),
                               torch.from_numpy(w),
                               torch.from_numpy(y.reshape(N)))
    assert tlse.shape == ttgt.shape == (N,)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse).reshape(N),
                               atol=1e-5)
    np.testing.assert_allclose(ttgt.numpy(), np.asarray(jtgt).reshape(N),
                               atol=1e-5)


@pytest.mark.parametrize("h,w,t,ok", [
    ((2, 16, 128), (256, 128), (2, 16), True),
    ((2, 16, 128), (250, 128), (2, 16), False),    # indivisible vocab
    ((2, 16, 120), (256, 120), (2, 16), False),    # D not lane-aligned
    ((1, 5, 128), (256, 128), (1, 5), False),      # no row block divides N
    ((2, 16, 128), (256, 64), (2, 16), False),     # w does not match h
    ((2, 16, 128), (256, 128), (2, 8), False),     # targets do not match h
    ((32, 128), (256, 128), (2, 16), False),       # h is not 3-d
])
def test_supported_agrees_with_jax(h, w, t, ok):
    assert jfx.supported(jnp.zeros(h), jnp.zeros(w),
                         jnp.zeros(t, jnp.int32)) is ok
    args = (torch.zeros(h), torch.zeros(w), torch.zeros(t, dtype=torch.int32))
    assert tfx.supported(*args) is ok
    assert (tfx.unsupported_reason(*args) is None) is ok


@pytest.mark.parametrize("h,V,dtype,match", [
    ((8, 1024, 2048), 32768, torch.bfloat16, None),       # the 1B step
    ((2, 64, 128), 32768, torch.bfloat16, None),
    ((8, 1024, 4096), 32768, torch.bfloat16, "d_model 4096"),
    ((8, 1024, 384), 32768, torch.bfloat16, "d_model 384"),
    ((2, 64, 128), 32768, torch.float32, "torch.bfloat16"),
    ((2, 16, 128), 32768, torch.bfloat16, "multiple of 64"),
    ((2, 64, 128), 32832, torch.bfloat16, "vocab 32832"),
])
def test_kernel_gates(h, V, dtype, match):
    """The gates the CUDA kernels add on the card, stated once for
    unsupported_reason and the launcher."""
    reason = tfx._kernel_reason(h[0] * h[1], h[2], V, dtype)
    if match is None:
        assert reason is None
    else:
        assert match in reason


def test_autograd_matches_one_shot_loss():
    """Port only: the Function's value and gradients against autograd
    through the port's own one-shot loss, at fp32."""
    h, w, y = _inputs(2, 16, 128, 256, seed=4)
    tv, tgh, tgw = _torch_value_grads(h, w, y)
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = tl._oneshot_xent(ht, wt, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(tv, loss.item(), rtol=1e-5)
    np.testing.assert_allclose(tgh, ht.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(tgw, wt.grad.numpy(), atol=1e-5)


def test_wrappers_refuse_other_devices():
    h = torch.empty(64, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfx._xent_fwd(h, torch.empty(128, 128, device="meta"),
                      torch.empty(64, dtype=torch.int32, device="meta"))


FUSED = dataclasses.replace(jl.tiny(vocab=128, seq=32), d_model=128,
                            fused_xent=True, loss_chunk=48)


@pytest.fixture
def spy(monkeypatch):
    calls = []
    real = tfx.fused_xent_mean

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tfx, "fused_xent_mean", counted)
    return calls


def test_llama_loss_fn_fused_matches_jax(spy, caplog):
    """fused_xent=True at tiny(vocab=128, seq=32), d_model 128: both sides
    take the fused branch, silently (loss_chunk 48 does not divide 32, and
    only the one-shot branch warns)."""
    np_params = jax_params(FUSED)
    toks, tgts = batch(FUSED.vocab_size, 4, 32)
    jloss, jg = jax_loss_grads(FUSED, np_params, toks, tgts)
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        tloss, tg = torch_loss_grads(torch_cfg(FUSED), np_params, toks, tgts)
    assert spy == [1]
    assert "does not divide" not in caplog.text
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert_grads_close(jg, tg, rtol=1e-5, atol=2e-5)


def test_fused_xent_off_takes_the_one_shot_loss(spy, monkeypatch):
    """HOROVOD_FUSED_XENT=0: both sides fall through to the one-shot loss."""
    monkeypatch.setenv("HOROVOD_FUSED_XENT", "0")
    cfg = dataclasses.replace(FUSED, loss_chunk=0)
    assert not jfx.supported(jnp.zeros((4, 32, 128)), jnp.zeros((128, 128)),
                             jnp.zeros((4, 32), jnp.int32))
    np_params = jax_params(cfg, seed=1)
    toks, tgts = batch(cfg.vocab_size, 4, 32, seed=2)
    jloss, jg = jax_loss_grads(cfg, np_params, toks, tgts)
    tloss, tg = torch_loss_grads(torch_cfg(cfg), np_params, toks, tgts)
    assert spy == []
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert_grads_close(jg, tg, rtol=1e-5, atol=2e-5)


def test_fused_xent_falls_through_on_cpu_where_jax_does(spy):
    """d_model 64 fails the D % 128 gate on both sides: the chunked loss."""
    cfg = dataclasses.replace(jl.tiny(vocab=128, seq=32), fused_xent=True,
                              loss_chunk=16)
    np_params = jax_params(cfg, seed=3)
    toks, tgts = batch(cfg.vocab_size, 2, 32, seed=4)
    jloss, jg = jax_loss_grads(cfg, np_params, toks, tgts)
    tloss, tg = torch_loss_grads(torch_cfg(cfg), np_params, toks, tgts)
    assert spy == []
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert_grads_close(jg, tg, rtol=1e-5, atol=2e-5)
