"""The port's CUDA kernels (flash attention, fused cross-entropy) against
their plain versions.

Needs a CUDA device (marker ``gpu``; skipped without one, decided in the
``cuda`` fixture).  Imports no jax, so it runs where jax is missing:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances, on bf16 inputs with |q|, |k|, |v|, |dO| ~ N(0, 1): out is
bf16, so within 2e-2 absolute (a few bf16 steps at |out| <= 2); lse is
fp32 from fast exp/log intrinsics and another summation order, within
1e-3; dq, dk and dv are bf16 sums of T products in which the kernels
round P and dS to bf16 (the dkv plain version keeps them fp32), so they
are held to 2e-2 of the largest entry of the plain version's result.
The cross-entropy kernels' lse and tgt are fp32 sums of D bf16 products
in another order (and fast exp/log), within 1e-3; dh = (P − onehot)·W
and dW = (P − onehot)ᵀ·h are fp32 sums in which both sides round
P − onehot to bf16.  Their largest entries come from the onehot term,
which needs no softmax, so the error is held to 2e-2 of the largest
entry of the softmax term alone (P·W, Pᵀ·h): a kernel that drops P errs
by that whole term, one that scales P by 1 + e by e times it.
"""

import dataclasses

import pytest
import torch

from horovod_tpu_torch.models import llama
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import fused_xent as fx
from horovod_tpu_torch.parallel.ring_attention import local_attention

pytestmark = pytest.mark.gpu

OUT_ATOL = 2e-2
LSE_ATOL = 1e-3
GRAD_REL = 2e-2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    return torch.device("cuda")


def _inputs(dev, B, T, Tk, H, Hkv, D, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    return (r(B, H, T, D), r(B, Hkv, Tk, D), r(B, Hkv, Tk, D),
            r(B, H, T, D), r(B, H, T, dtype=torch.float32))


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


CASES = [  # (B, T, Tk, H, Hkv, D, causal)
    (2, 256, 256, 4, 2, 64, True),
    (1, 256, 256, 4, 4, 128, False),
    (1, 192, 192, 4, 1, 128, True),
    (2, 128, 256, 8, 2, 64, False),
    (1, 64, 64, 2, 1, 128, True),      # one 64-row tile: zero fill past T
    (2, 320, 320, 8, 2, 128, True),    # ragged 128-row tiles, g = 4
    (1, 384, 384, 4, 4, 64, False),    # D 64, three full 128-row tiles
]


@pytest.mark.parametrize("B,T,Tk,H,Hkv,D,causal", CASES)
def test_kernels_match_plain_versions(cuda, B, T, Tk, H, Hkv, D, causal):
    q, k, v, do, _ = _inputs(cuda, B, T, Tk, H, Hkv, D)
    scale = D ** -0.5
    fa.reset_launches()
    out, lse = fa._flash_fwd_bhtd(q, k, v, causal, scale)
    ref_out, ref_lse = fa._fwd_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert (out.float() - ref_out.float()).abs().max().item() <= OUT_ATOL
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    delta = (do.float() * ref_out.float()).sum(-1)
    dq = fa._dq(q, k, v, do, ref_lse, delta, causal, scale)
    dk, dv = fa._dkv(q, k, v, do, ref_lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
    assert _rel(dq, fa._dq_reference(q, k, v, do, ref_lse, delta, causal,
                                     scale)) <= GRAD_REL
    rdk, rdv = fa._dkv_reference(q, k, v, do, ref_lse, delta, causal, scale)
    assert _rel(dk, rdk) <= GRAD_REL and _rel(dv, rdv) <= GRAD_REL


def test_autograd_on_the_card_matches_the_cpu(cuda):
    q, k, v, do, dlse = _inputs(cuda, 2, 128, 128, 4, 2, 64, seed=1)
    t = [x.transpose(1, 2).contiguous() for x in (q, k, v, do)]
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.detach().to(dev).requires_grad_() for x in t[:3]]
        out, lse = fa.flash_attention_lse(*leaves, causal=True)
        torch.autograd.backward([out, lse], [t[3].to(dev), dlse.to(dev)])
        grads.append([out.detach(), lse.detach()]
                     + [x.grad for x in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert _rel(a.cpu(), b) <= GRAD_REL


def test_unsupported_inputs_on_the_card_raise(cuda, monkeypatch):
    q = torch.zeros(1, 128, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="HOROVOD_FLASH_ATTENTION=0"):
        local_attention(q, q, q)                          # fp32
    q32 = torch.zeros(1, 128, 4, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="HOROVOD_FLASH_ATTENTION=0"):
        local_attention(q32, q32, q32)                    # head_dim 32
    b = torch.zeros(1, 4, 96, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="HOROVOD_FLASH_ATTENTION=0"):
        fa._flash_fwd_bhtd(b, b, b, True, 0.125)          # 96 % 64
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    fa.reset_launches()
    out = local_attention(q, q, q)
    assert out.shape == q.shape and fa.LAUNCHES["fwd"] == 0


def _xent_inputs(dev, N, V, D, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.randn(N, D, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(V, D, generator=g) * D ** -0.5).to(dev)
    y = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
    return h, w, y


XENT_CASES = [  # (N, V, D)
    (128, 256, 128),
    (256, 384, 2048),
    (192, 512, 512),
    (64, 1024, 256),
    (128, 128, 1024),
]


def _softmax_terms(h, w, lse):
    """The plain (P·W, Pᵀ·h), P rounded to bf16: dh and dW without onehot."""
    p = torch.exp(fx._scores(h, w) - lse[:, None]).to(h.dtype).float()
    return p @ w.to(h.dtype).float(), p.T @ h.float()


def _softmax_rel(a, b, soft):
    """Largest error of ``a`` against ``b`` over the largest entry of the
    softmax term ``soft`` of ``b``."""
    return ((a.float() - b.float()).abs().max() / soft.abs().max()).item()


@pytest.mark.parametrize("N,V,D", XENT_CASES)
def test_xent_kernels_match_plain_versions(cuda, N, V, D):
    h, w, y = _xent_inputs(cuda, N, V, D)
    fx.reset_launches()
    lse, tgt = fx._xent_fwd(h, w, y)
    ref_lse, ref_tgt = fx._fwd_reference(h, w, y)
    dh = fx._dh(h, w, y, ref_lse)
    dw = fx._dw(h, w, y, ref_lse)
    torch.cuda.synchronize()
    assert fx.LAUNCHES == {"xent_fwd": 1, "xent_dh": 1, "xent_dw": 1}
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    assert (tgt - ref_tgt).abs().max().item() <= LSE_ATOL
    soft_dh, soft_dw = _softmax_terms(h, w, ref_lse)
    assert _softmax_rel(dh, fx._dh_reference(h, w, y, ref_lse),
                        soft_dh) <= GRAD_REL
    assert _softmax_rel(dw, fx._dw_reference(h, w, y, ref_lse),
                        soft_dw) <= GRAD_REL


def test_xent_autograd_on_the_card_matches_the_cpu(cuda):
    """dh comes back in bf16, whose rounding of the onehot term is larger
    than the softmax term at D 128, so it is held to its own largest
    entry; dW (fp32) is held to its softmax term's."""
    h, w, y = _xent_inputs(cuda, 128, 256, 128, seed=1)
    out = []
    for dev in (cuda, torch.device("cpu")):
        hl = h.detach().to(dev).view(2, 64, 128).requires_grad_()
        wl = w.detach().to(dev).requires_grad_()
        loss = fx.fused_xent_mean(hl, wl, y.to(dev).view(2, 64))
        loss.backward()
        assert hl.grad.dtype == torch.bfloat16 and wl.grad.dtype == torch.float32
        out.append((loss.detach(), hl.grad, wl.grad))
    torch.cuda.synchronize()
    (gl, gh, gw), (cl, ch, cw) = out
    hc, wc = h.cpu(), w.cpu()
    _, soft_dw = _softmax_terms(hc, wc, fx._fwd_reference(hc, wc, y.cpu())[0])
    assert abs(gl.item() - cl.item()) <= LSE_ATOL
    assert _rel(gh.cpu(), ch) <= GRAD_REL
    assert _softmax_rel(gw.cpu(), cw, soft_dw / 128) <= GRAD_REL


def test_xent_unsupported_inputs_on_the_card_raise(cuda, monkeypatch):
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")  # tiny head_dim 16
    toks = torch.zeros(2, 64, dtype=torch.long, device=cuda)
    for over in ({}, {"d_model": 128}):  # D % 128; fp32 hidden states
        cfg = dataclasses.replace(llama.tiny(vocab=256, seq=64),
                                  fused_xent=True, **over)
        params = llama.init_params(cfg, device=cuda)
        with pytest.raises(ValueError, match="HOROVOD_FUSED_XENT=0"):
            llama.loss_fn(params, toks, toks, cfg)
    monkeypatch.setenv("HOROVOD_FUSED_XENT", "0")
    fx.reset_launches()
    loss = llama.loss_fn(params, toks, toks, cfg)
    assert torch.isfinite(loss).item() and sum(fx.LAUNCHES.values()) == 0
