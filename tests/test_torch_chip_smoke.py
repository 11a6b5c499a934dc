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


def test_collectives_phase_passes_on_the_cpu_at_world_one():
    """The card's ``collectives`` phase, rehearsed over gloo on the CPU:
    every check holds and the 64 small tensors share one bucket."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        row = chip_smoke.collectives_phase(hvd, torch.device("cpu"))
    finally:
        hvd.shutdown()
    assert all(all(c.values()) for c in row["checks"].values())
    assert (row["small_tensors"], row["small_buckets"]) == (64, 1)


# -- the A5 phases' gates (train_overlap, train_wire, train_a5_dp2) ---------

_LAUNCHES = {**chip_smoke.EXPECTED_LAUNCHES,
             **{n: 0 for n in chip_smoke.EXPECTED_XENT_LAUNCHES}}
_TRAIN = {"losses": [10.9, 9.9, 8.9, 7.9]}


def _overlap_row(**over):
    row = {"losses": list(_TRAIN["losses"]),
           "launches_per_step": [dict(_LAUNCHES)] * 3,
           "plane": {"buckets": 82, "bucket_layers": [15] * 5 + [-1] * 77,
                     "quantization_error_rel": 0.01},
           "wire_bytes": 2 * 260, "full_width_bytes": 2 * 4 * 256}
    row.update(over)
    return row


def test_overlap_gates_pass_and_fail():
    assert chip_smoke.overlap_problems(_overlap_row(), _TRAIN,
                                       _LAUNCHES) == []
    off = _overlap_row(losses=[10.9, 9.9, 8.9, 7.900001])
    assert "are not train's" in chip_smoke.overlap_problems(
        off, _TRAIN, _LAUNCHES)[0]
    fewer = _overlap_row(launches_per_step=[{**_LAUNCHES, "fwd": 29}] * 3)
    assert len(chip_smoke.overlap_problems(fewer, _TRAIN, _LAUNCHES)) == 3
    none = _overlap_row(plane={"buckets": 0, "bucket_layers": []})
    assert chip_smoke.overlap_problems(none, _TRAIN, _LAUNCHES)


def test_wire_gates_pass_and_fail():
    near = _overlap_row(losses=[10.9, 9.92, 8.93, 7.91])
    assert chip_smoke.wire_problems(near, _TRAIN, _LAUNCHES) == []
    cases = {
        "first loss": _overlap_row(losses=[10.91, 9.92, 8.93, 7.91]),
        "beyond": _overlap_row(losses=[10.9, 9.92, 8.93, 8.2]),
        "quantization error": _overlap_row(plane={
            "buckets": 1, "bucket_layers": [-1],
            "quantization_error_rel": chip_smoke.WIRE_ERROR_REL * 1.01}),
        "wire bytes": _overlap_row(wire_bytes=2 * 4 * 256),
        "non-finite": _overlap_row(losses=[10.9, float("nan"), 8.9, 7.9]),
        "did not fall": _overlap_row(losses=[10.9, 9.9, 8.9, 10.95]),
    }
    for what, row in cases.items():
        bad = chip_smoke.wire_problems(row, _TRAIN, _LAUNCHES)
        assert any(what in b for b in bad), (what, bad)


def test_wire_error_bound_holds_for_int8_blocks():
    """WIRE_ERROR_REL is a bound, not a fit: int8 blocks of 256 of
    heavy-tailed and of one-spike data stay under it."""
    from horovod_tpu_torch import compression
    fmt = compression.resolve_wire_format("int8", 256)
    g = torch.Generator().manual_seed(0)
    for x in (torch.randn(1 << 16, generator=g),
              torch.randn(1 << 16, generator=g) ** 5,
              torch.zeros(1 << 16).index_fill_(0, torch.tensor([7]), 1.0)
              + 1e-3):
        q, s = compression.quantize_blocks(x, fmt)
        err = (x - compression.dequantize_blocks(q, s, fmt)).norm()
        assert err / x.norm() <= chip_smoke.WIRE_ERROR_REL


def _a5_res(**over):
    ok = {"identical_after_step": [True, True],
          "losses": [10.89, 6.93],
          "update_norms": {"embed": (1.0, 1.0)},
          "update_cos": {"embed": 0.999}}
    res = {"dp1": {"losses": [10.89, 6.93], "state_bytes": 1000}}
    for name, _, _ in chip_smoke.A5_VARIANTS:
        res[name] = dict(ok, state_bytes=500 if name == "zero1" else 1000,
                         launches_per_step=[
                             chip_smoke.EXPECTED_A5_LAUNCHES[name]] * 2)
    for name, fields in over.items():
        res[name] = dict(res[name], **fields)
    return res


def test_a5_dp2_gates_pass_and_fail():
    assert chip_smoke.a5_problems(_a5_res()) == []
    # the quantized overlap has its own, wider gates
    wire = {"losses": [10.89, 6.93 * 1.008],
            "update_cos": {"embed": 0.98}}
    assert chip_smoke.a5_problems(_a5_res(overlap_sharded_int8=wire)) == []
    cases = {
        "differ": {"zero1": {"identical_after_step": [True, False]}},
        "launches": {"grad_accum": {"launches_per_step": [
            chip_smoke.EXPECTED_DP2_LAUNCHES] * 2}},
        "loss": {"zero1": {"losses": [10.89, 6.93 * 1.008]}},
        "update norm": {"grad_accum": {"update_norms": {"embed": (1.05,
                                                                  1.0)}}},
        "update cos": {"overlap_sharded_int8": {"update_cos": {
            "embed": 0.96}}},
        "optimizer state": {"zero1": {"state_bytes": 700}},
    }
    for what, over in cases.items():
        bad = chip_smoke.a5_problems(_a5_res(**over))
        assert any(what in b for b in bad), (what, bad)
