"""Helpers of chip_smoke.py that run on the CPU.

The script itself needs a CUDA card; its gates' arithmetic does not.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import fused_xent as fx


def _xent_case(N=512, V=2048, D=128, seed=0):
    """bf16 h, fp32 W and targets as the kernels phase makes them (unit
    variance logits, N/V = 1/4 as at the loss head), with the plain lse."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(N, D, generator=g).to(torch.bfloat16)
    w = torch.randn(V, D, generator=g) * D ** -0.5
    y = torch.randint(0, V, (N,), generator=g, dtype=torch.int32)
    return h, w, y, fx._fwd_reference(h, w, y)[0]


def _gradients(h, w, y, lse, p_scale=1.0, dtype=torch.float32):
    """(dh, dW) with the softmax scaled by ``p_scale``, computed in
    ``dtype`` apart from the bf16 rounding of P − onehot."""
    s = h.to(dtype) @ w.to(h.dtype).to(dtype).T
    p = p_scale * torch.exp(s - lse[:, None].to(dtype))
    p[torch.arange(len(y)), y.long()] -= 1.0
    p = p.to(h.dtype).to(dtype)
    return ((p @ w.to(h.dtype).to(dtype)).float(),
            (p.T @ h.to(dtype)).float())


@pytest.mark.parametrize("grad", [0, 1], ids=["dh", "dw"])
@pytest.mark.parametrize("p_scale", [0.0, 1.05, 0.9])
def test_xent_gradient_gate_fails_a_wrong_softmax(grad, p_scale):
    """The kernels phase's dh/dW gate fails a result that drops P or
    scales it by 5-10%; the onehot term alone would hide both."""
    h, w, y, lse = _xent_case()
    ref = (fx._dh_reference, fx._dw_reference)[grad](h, w, y, lse)
    soft = chip_smoke.softmax_terms(fx, h, w, lse)[grad]
    wrong = _gradients(h, w, y, lse, p_scale)[grad]
    assert chip_smoke.softmax_rel(wrong, ref, soft) > chip_smoke.XENT_GRAD_REL


@pytest.mark.parametrize("grad", [0, 1], ids=["dh", "dw"])
def test_xent_gradient_gate_passes_another_summation(grad):
    """The same gradient from fp64 scores and sums passes the gate."""
    h, w, y, lse = _xent_case(seed=1)
    ref = (fx._dh_reference, fx._dw_reference)[grad](h, w, y, lse)
    soft = chip_smoke.softmax_terms(fx, h, w, lse)[grad]
    other = _gradients(h, w, y, lse, dtype=torch.float64)[grad]
    assert chip_smoke.softmax_rel(other, ref, soft) <= chip_smoke.XENT_GRAD_REL


def test_parity_cosine_is_exact_where_fp32_is_not():
    """The parity gate's cosine over a weight-sized gradient: fp32 sums
    over 2**22 entries err by ~1e-4 (above 1 for equal vectors); the
    gate's fp64 cosine stays within 1e-12."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(2048, 2048) * 1e-3).astype(np.float32))
    fp32 = torch.nn.functional.cosine_similarity(x.flatten(), x.flatten(),
                                                 dim=0).item()
    assert abs(fp32 - 1.0) > 1e-6
    assert abs(chip_smoke.cosine(x, x.clone()) - 1.0) < 1e-12
    y = x + torch.from_numpy(rng.randn(2048, 2048).astype(np.float32)) * 1e-3
    want = float((x.double() * y.double()).sum()
                 / (x.double().norm() * y.double().norm()))
    assert abs(chip_smoke.cosine(x, y) - want) < 1e-12


def test_xent_bound_at_the_1b_loss_head():
    """Operations bound all three kernels at N 8192, V 32768, D 2048:
    1.11 ms for one product, 2.22 ms for two, at 989 TF/s."""
    N, V, D = chip_smoke.XENT_SHAPE
    want = {"xent_fwd": (1.11, 302088192), "xent_dh": (2.22, 369164288),
            "xent_dw": (2.22, 570490880)}
    for kernel, (ms, nbytes) in want.items():
        bound_ms, by, flops, got_bytes = chip_smoke.xent_bound(kernel, N, V, D)
        assert by == "operations" and abs(bound_ms - ms) < 0.01
        assert got_bytes == nbytes
        assert flops == (2 if kernel == "xent_fwd" else 4) * N * V * D


def test_flash_bound_at_the_main_shape():
    """Operations bound the three flash kernels at B 8, T 1024, H 16, Hkv 8,
    D 128, causal: 0.0348 ms for 2 products (fwd), 0.0522 for 3 (dq),
    0.0696 for 4 (dkv), at 989 TF/s."""
    shape = chip_smoke.KERNEL_CASES[0][1]
    assert shape == (8, 1024, 16, 8, 128, True)
    B, T, H, _, D, _ = shape
    pairs = B * H * T * (T + 1) // 2  # score entries the causal mask keeps
    want = {"fwd": (0.0348, 2, 101187584), "dq": (0.0522, 3, 135266304),
            "dkv": (0.0696, 4, 135266304)}
    for kernel, (ms, products, nbytes) in want.items():
        bound_ms, by, flops, got_bytes = chip_smoke.bound(kernel, shape)
        assert by == "operations" and abs(bound_ms - ms) < 1e-4
        assert flops == 2 * products * pairs * D
        assert got_bytes == nbytes
