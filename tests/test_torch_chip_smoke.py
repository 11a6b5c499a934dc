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


# a kernel outside WGMMA_KERNELS, whose spills are reported, not gated
_OTHER = "_ZN12_GLOBAL__N_112other_kernelEPKfPfi"


def _label(kernel):
    """chip_smoke's label of ``(name, template value or None)``."""
    name, value = kernel
    return name if value is None else f"{name}<{value}>"


def _ptxas_report(spilling=None, missing=None):
    """-Xptxas -v lines of every wgmma kernel chip_smoke gates, plus a
    kernel outside them that spills; ``spilling`` names one wgmma kernel
    that spills and ``missing`` one whose lines are absent, each as
    ``(name, template value or None)``."""
    report = {}
    for lib, kernels in chip_smoke.WGMMA_KERNELS.items():
        lines = []
        functions = []
        for tag, lab in chip_smoke.wgmma_labels(kernels).items():
            if missing is not None and lab == _label(missing):
                continue
            # the rest of a mangled name: a template's closing and return
            # type, or a plain kernel's parameters
            rest = ("EEvPKS0_" if "ILi" in tag
                    else "14CUtensorMap_stS0_PKiPfS3_iii")
            functions.append((f"_ZN12_GLOBAL__N_1{tag}{rest}",
                              8 if spilling is not None
                              and lab == _label(spilling) else 0))
        if lib == "fused_xent":
            functions.append((_OTHER, 8))
        for fn, spill in functions:
            lines += [f"ptxas info    : Function properties for {fn}",
                      f"    0 bytes stack frame, {spill} bytes spill stores, "
                      f"{spill} bytes spill loads",
                      "ptxas info    : Used 168 registers"]
        report[lib] = lines
    return report


def test_spill_gate_passes_when_no_wgmma_kernel_spills():
    wgmma, others, problems = chip_smoke.spill_check(_ptxas_report())
    assert problems == []
    # flash fwd/dq/dkv at 2 head dims; xent dh and dW at 5 d_models, fwd
    assert len(wgmma) == 17 and set(wgmma.values()) == {(0, 0)}
    assert wgmma["flash_dq_kernel<64>"] == (0, 0)
    assert wgmma["xent_dh_kernel<2048>"] == (0, 0)
    assert wgmma["xent_fwd_kernel"] == (0, 0)
    # a kernel outside WGMMA_KERNELS: its spill is reported, not gated
    assert others == {_OTHER: (8, 8)}


@pytest.mark.parametrize("spilling", [("flash_dq_kernel", 128),
                                      ("xent_dw_kernel", 2048),
                                      ("flash_fwd_kernel", 64),
                                      ("xent_dh_kernel", 2048),
                                      ("xent_dh_kernel", 128),
                                      ("xent_fwd_kernel", None)])
def test_spill_gate_fails_a_spilling_wgmma_kernel(spilling):
    _, _, problems = chip_smoke.spill_check(_ptxas_report(spilling))
    assert problems == [f"{_label(spilling)} spills 8 bytes of stores and 8 "
                        f"of loads"]


@pytest.mark.parametrize("missing", [("xent_dh_kernel", 2048),
                                     ("xent_fwd_kernel", None),
                                     ("xent_dw_kernel", 512)])
def test_spill_gate_fails_a_missing_wgmma_kernel(missing):
    """A gated kernel absent from the report (not built, or renamed) fails
    the gate as a spill would."""
    _, _, problems = chip_smoke.spill_check(_ptxas_report(missing=missing))
    assert problems == [f"{_label(missing)} is not in the ptxas report of "
                        f"fused_xent"]


def test_spill_gate_fails_a_missing_report():
    report = _ptxas_report()
    report["fused_xent"] = []  # a library whose lines were lost
    _, _, problems = chip_smoke.spill_check(report)
    # the forward, and dh and dW at 5 d_models each
    assert len(problems) == 11 and all("not in the ptxas report" in p
                                       for p in problems)


def test_wgmma_labels_tell_plain_kernels_from_templates():
    """A plain kernel's tag ends its name (<len>nameE), so it cannot match
    a template instance of a longer name, nor the instance tag match it."""
    tags = chip_smoke.wgmma_labels({"k": None, "k_t": (64,)})
    assert tags == {"1kE": "k", "3k_tILi64E": "k_t<64>"}


@pytest.mark.parametrize("d", chip_smoke.XENT_DEPTHS)
@pytest.mark.parametrize("kernel", ["xent_fwd", "xent_dh", "xent_dw"])
def test_xent_depth_rows_are_bound_by_operations(kernel, d):
    """The xent_*_depths lines at d_model 256-1024 (the loss head's N and
    V): each bound is xent_bound's operations term, one product for the
    forward and two for dh and dW at 989 TF/s, above the bytes term."""
    N, V, _ = chip_smoke.XENT_SHAPE
    row = chip_smoke.xent_depth_row(kernel, N, V, d, ms=0.5)
    bound_ms, by, flops, _ = chip_smoke.xent_bound(kernel, N, V, d)
    products = 1 if kernel == "xent_fwd" else 2
    assert by == "operations" and flops == 2 * products * N * V * d
    assert row["bound_ms"] == bound_ms
    assert bound_ms == pytest.approx(
        1e3 * flops / chip_smoke.PEAK_BF16_FLOPS, rel=1e-12)
    assert row["tflops"] == flops / 0.5 / 1e9
    assert row["blocks_per_cluster"] == (2 if kernel == "xent_fwd"
                                         else max(1, d // 256))
