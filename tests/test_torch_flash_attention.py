"""Parity of the port's flash attention with the JAX package's, on the CPU.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
(as tests/test_flash_attention.py runs them) and through the port's plain
versions of its CUDA kernels, which are what its wrappers run on CPU
tensors.  Inputs are fp32, so both sides compute in fp32 and differ only
in summation order: out and lse are held to atol 1e-5, gradients (one
more product deep, with |dO| ~ 1) to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.parallel.ring_attention import local_attention as jax_local_attention
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import ring_attention as tra

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4

# (B, T, H, Hkv, D, causal): causal and not, Hkv = H and H/2, D 64 and 128
CASES = [
    (1, 256, 2, 2, 64, True),
    (2, 256, 4, 2, 64, True),
    (1, 256, 2, 2, 128, False),
    (1, 256, 4, 2, 128, True),
    (1, 256, 4, 2, 64, False),
]


def _inputs(B, T, H, Hkv, D, seed=0):
    """q, k, v, dO ``[B, H|Hkv, T, D]`` and dlse ``[B, H, T]`` in fp32."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(B, H, T, D).astype(f), rng.randn(B, Hkv, T, D).astype(f),
            rng.randn(B, Hkv, T, D).astype(f), rng.randn(B, H, T, D).astype(f),
            rng.randn(B, H, T).astype(f))


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("B,T,H,Hkv,D,causal", CASES)
def test_plain_kernels_match_jax_pallas(B, T, H, Hkv, D, causal,
                                        monkeypatch):
    """_fwd_reference, _dq_reference and _dkv_reference against the TPU
    kernels, each on the same inputs (lse and delta from the JAX side)."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, do, _ = _inputs(B, T, H, Hkv, D)
    scale = D ** -0.5
    out, lse = jfa._flash_fwd_bhtd(q, k, v, causal, scale)
    dq, dk, dv = jfa._flash_bwd_bhtd(q, k, v, out, lse, jnp.asarray(do),
                                     causal, scale)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    lse_t = torch.from_numpy(np.array(lse).reshape(B, H, T))
    out_t = torch.from_numpy(np.array(out))
    to, tl = tfa._fwd_reference(t[0], t[1], t[2], causal, scale)
    _close(out, to, FWD_ATOL, "out")
    _close(np.asarray(lse).reshape(B, H, T), tl, FWD_ATOL, "lse")
    delta = (t[3] * out_t).sum(-1)
    _close(dq, tfa._dq_reference(*t, lse_t, delta, causal, scale),
           GRAD_ATOL, "dq")
    tdk, tdv = tfa._dkv_reference(*t, lse_t, delta, causal, scale)
    _close(dk, tdk, GRAD_ATOL, "dk")
    _close(dv, tdv, GRAD_ATOL, "dv")


@pytest.mark.parametrize("B,T,H,Hkv,D,causal", [CASES[1], CASES[2]])
def test_flash_attention_lse_autograd_matches_jax(B, T, H, Hkv, D, causal,
                                                  monkeypatch):
    """The public [B, T, H, D] op and its autograd.Function against the
    JAX custom_vjp, with cotangents on both out and lse."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, do, dlse = [np.swapaxes(x, 1, 2) if x.ndim == 4 else x
                         for x in _inputs(B, T, H, Hkv, D, seed=3)]
    (out, lse), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_lse(a, b, c, causal=causal),
        q, k, v)
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    to, tl = tfa.flash_attention_lse(*t, causal=causal)
    torch.autograd.backward([to, tl], [torch.from_numpy(do),
                                       torch.from_numpy(dlse)])
    _close(out, to, FWD_ATOL, "out")
    _close(lse, tl, FWD_ATOL, "lse")
    for name, jg, tt in zip("qkv", jgrads, t):
        _close(jg, tt.grad, GRAD_ATOL, f"d{name}")


def test_cpu_wrappers_launch_no_kernel():
    tfa.reset_launches()
    q, k, v, _, _ = _inputs(1, 128, 2, 1, 64)
    t = [torch.tensor(np.swapaxes(x, 1, 2)).bfloat16().requires_grad_()
         for x in (q, k, v)]
    out = tfa.flash_attention(*t, causal=True)
    out.float().square().sum().backward()
    assert out.shape == (1, 128, 2, 64) and out.dtype == torch.bfloat16
    assert tfa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}


@pytest.mark.parametrize("shape,dtype,env,ok", [
    ((1, 128, 4, 2, 64), torch.bfloat16, {}, True),
    ((1, 128, 4, 4, 128), torch.bfloat16, {}, True),
    ((1, 128, 4, 2, 64), torch.float32, {}, False),        # fp32
    ((1, 128, 4, 2, 32), torch.bfloat16, {}, False),       # head_dim 32
    ((1, 96, 4, 2, 64), torch.bfloat16, {}, False),        # 96 % 64
    ((1, 128, 4, 3, 64), torch.bfloat16, {}, False),       # 3 ∤ 4
    ((1, 128, 4, 2, 64), torch.bfloat16,
     {"HOROVOD_FLASH_ATTENTION": "0"}, False),
    ((1, 256, 4, 2, 64), torch.bfloat16,
     {"HOROVOD_FLASH_BLOCK": "128"}, False),               # tile not built
])
def test_supported_gates(shape, dtype, env, ok, monkeypatch):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    B, T, H, Hkv, D = shape
    q = torch.zeros(B, T, H, D, dtype=dtype)
    k = torch.zeros(B, T, Hkv, D, dtype=dtype)
    assert tfa.supported(q, k, k) is ok


def test_kernel_shapes_reach_the_plain_flash_path(monkeypatch):
    """On the CPU, local_attention sends the shapes the kernels take
    through flash_attention (whose plain versions run there) and the rest
    through the blockwise path."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q = torch.randn(1, 128, 4, 64).bfloat16()
    k = torch.randn(1, 128, 2, 64).bfloat16()
    tra.local_attention(q, k, k)
    assert calls == [1]
    tra.local_attention(q.float(), k.float(), k.float())
    assert calls == [1]
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    tra.local_attention(q, k, k)
    assert calls == [1]


@pytest.mark.parametrize("T,Hkv,blk", [
    (192, 4, 96),    # evenly divided
    (192, 2, 128),   # 192 % 128 → largest divisor 96
    (100, 2, 512),   # one tile
])
def test_blockwise_local_attention_matches_jax(T, Hkv, blk):
    """The blockwise path (fp32, head_dim 32, so no kernel on either side)
    against the JAX package's, values and gradients."""
    rng = np.random.RandomState(1)
    q = rng.randn(1, T, 4, 32).astype(np.float32)
    k = rng.randn(1, T, Hkv, 32).astype(np.float32)
    v = rng.randn(1, T, Hkv, 32).astype(np.float32)
    do = rng.randn(1, T, 4, 32).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jax_local_attention(
        a, b, c, causal=True, block_size=blk), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    to = tra.local_attention(*t, causal=True, block_size=blk)
    to.backward(torch.from_numpy(do))
    _close(out, to, FWD_ATOL, "out")
    for name, jg, tt in zip("qkv", jgrads, t):
        _close(jg, tt.grad, GRAD_ATOL, f"d{name}")


def test_ring_attention_refuses_a_sequence_axis():
    """A sequence axis needs its mesh's context, where the ring finds its
    group (tests/test_torch_parallel.py runs the ring over rank
    processes); an axis of size 1 is local attention."""
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="ParallelMesh context"):
        tra.ring_attention(q, q, q, axis_name="sp")
    with ParallelMesh(MeshConfig(), devices=["cpu"]):
        out = tra.ring_attention(q, q, q, axis_name="sp")
    torch.testing.assert_close(out, tra.local_attention(q, q, q),
                               rtol=0, atol=0)
