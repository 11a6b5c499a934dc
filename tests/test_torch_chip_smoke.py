"""Helpers of chip_smoke.py that run on the CPU.

The script itself needs a CUDA card; its gates' arithmetic does not, and
the elastic_resnet phase runs whole here with workers that train a tiny
ResNet on the CPU.
"""

import json
import pathlib

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


# -- train_hier_dp4 and train_dp_tools --------------------------------------

def _hier_step(name, step, **over):
    late = name in chip_smoke.HIER_LATE and step == 1
    hier = name != "flat"
    rec = {"loss": 10.89 if step == 0 else 6.93, "ms": 1.0,
           "launches": dict(chip_smoke.EXPECTED_DP2_LAUNCHES),
           "buckets": 13, "tail_rounds_counted": 13 if hier else 0,
           "rounds": [{"excluded": [1] if late else [], "wait_s": 0.05,
                       "seconds": 0.06}] * (13 if hier else 0),
           "identical": True, "update_norms": {"embed": (1.0, 1.0)},
           "update_cos": {"embed": 0.999}}
    if step == 0 and name in chip_smoke.HIER_LATE:
        rec["equals_hier_step1"] = True
    rec.update(over)
    return rec


def _hier_res(**over):
    """A train_hier_dp4 result that passes; ``over`` maps a variant to
    {step index: fields} (or "scores" to its straggler scores)."""
    res = {"eager": {"checks": {"sum": True, "bounded": True}},
           "dp1_losses": [10.89, 6.93]}
    for name, _ in chip_smoke.HIER_VARIANTS:
        steps = over.get(name, {})
        res[name] = {"steps": [_hier_step(name, i, **steps.get(i, {}))
                               for i in range(2)],
                     "straggler_scores": steps.get(
                         "scores", {"0": 0.0, "1": 0.0, "2": 0.05,
                                    "3": 0.05})}
    res["adasum"] = {"steps": [_hier_step(
        "adasum", 0, **{"rel_err": 2e-6, **over.get("adasum", {}).get(0,
                                                                    {})})]}
    return res


def test_hier_dp4_gates_pass_and_fail():
    assert chip_smoke.hier_problems(_hier_res()) == []
    # the quantized cross stage has the wire's wider gates; step 2 of the
    # late variants is held to no parity
    assert chip_smoke.hier_problems(_hier_res(
        hier_int8={1: {"loss": 6.93 * 1.008,
                       "update_cos": {"embed": 0.98}}},
        bounded={1: {"loss": 9.0, "update_cos": {"embed": 0.5}}})) == []
    cases = {
        "eager: bounded": {"eager": None},
        "weights differ": {"stale": {1: {"identical": False}}},
        "launches": {"hier": {0: {"launches": {
            **chip_smoke.EXPECTED_DP2_LAUNCHES, "fwd": 1}}}},
        "loss": {"flat": {1: {"loss": 6.93 * 1.008}}},
        "update norm": {"hier": {1: {"update_norms": {"embed": (1.05,
                                                                1.0)}}}},
        "update cos": {"hier_int8": {1: {"update_cos": {"embed": 0.96}}}},
        "tail rounds": {"hier": {0: {"tail_rounds_counted": 12}}},
        "bit for bit": {"bounded": {0: {"equals_hier_step1": False}}},
        "not excluded": {"stale": {1: {"rounds": [
            {"excluded": [1], "wait_s": 0.05, "seconds": 0.01}] * 13}}},
        "step 2 loss": {"bounded": {1: {"loss": float("nan")}}},
        "straggler scores": {"bounded": {"scores": {"0": 0.1, "1": 0.0,
                                                    "2": 0.05,
                                                    "3": 0.05}}},
        "adasum: applied": {"adasum": {0: {"rel_err": 2e-4}}},
    }
    for what, over in cases.items():
        if over.get("eager", 1) is None:
            res = _hier_res()
            res["eager"]["checks"]["bounded"] = False
        else:
            res = _hier_res(**over)
        bad = chip_smoke.hier_problems(res)
        assert any(what in b for b in bad), (what, bad)


def test_plain_adasum_matches_the_port_tree():
    from horovod_tpu_torch.ops import adasum
    g = torch.Generator().manual_seed(0)
    rows = [torch.randn(50, generator=g, dtype=torch.float64)
            for _ in range(3)] + [torch.zeros(50, dtype=torch.float64)]
    torch.testing.assert_close(chip_smoke.plain_adasum(rows),
                               adasum.adasum_tree(rows), rtol=1e-12,
                               atol=0)


def _tools_row(**over):
    tensors = ["grad.a", "grad.b", "loss"]
    life = ["NEGOTIATE_ALLREDUCE", "QUEUED", "MEMCPY_IN_FUSION_BUFFER",
            "ALLREDUCE", "DONE"]
    row = {"steps": 2, "losses": list(_TRAIN["losses"][:2]),
           "launches_per_step": [dict(_LAUNCHES)] * 2, "tensors": tensors,
           "lanes": [{t: life * 2 for t in tensors},
                     {t: list(life) for t in tensors}],
           "cycle_marks": [2, 1],
           "autotune_log": [chip_smoke.AUTOTUNE_HEADER, "1,2,1,1,0,0,5,warmup",
                            "1,2,1,1,0,0,5,sample", "1,2,1,1,0,0,5,sample"]}
    row.update(over)
    return row


def test_tools_gates_pass_and_fail():
    assert chip_smoke.tools_problems(_tools_row(), _TRAIN, _LAUNCHES) == []
    ok = _tools_row()
    cases = {
        "are not train's": {"losses": [10.9, 9.91]},
        "launches": {"launches_per_step": [{**_LAUNCHES, "dq": 15}] * 2},
        "grad.b has 1 ALLREDUCE": {"lanes": [
            dict(ok["lanes"][0], **{"grad.b": [
                x for x in ok["lanes"][0]["grad.b"] if x != "ALLREDUCE"]
                + ["ALLREDUCE"]}), ok["lanes"][1]]},
        "loss has 0 DONE": {"lanes": [ok["lanes"][0], dict(
            ok["lanes"][1], loss=["NEGOTIATE_ALLREDUCE", "ALLREDUCE"])]},
        "cycle marks": {"cycle_marks": [1, 1]},
        "header": {"autotune_log": ["time,score"]
                   + ok["autotune_log"][1:]},
        "2 sample rows": {"autotune_log": ok["autotune_log"][:3]},
    }
    for what, over in cases.items():
        bad = chip_smoke.tools_problems(_tools_row(**over), _TRAIN,
                                        _LAUNCHES)
        assert any(what in b for b in bad), (what, bad)


# -- health_dp's gates -----------------------------------------------------------

#: a tiny Llama for health_dp on the CPU: 16 buckets under a 16 KiB fusion
#: threshold, so HEALTH_BUCKET exists
_HEALTH_TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, max_seq_len=16, loss_chunk=16,
                    remat_skip_layers=0)
_NO_LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}


def _health_row(**edit):
    row = json.loads(json.dumps(_HEALTH_ROW))
    for path, value in edit.items():
        *keys, last = path.split(".")
        node = row
        for k in keys:
            node = node[k]
        node[last] = value(node[last]) if callable(value) else value
    return row


_HEALTH_ROW = None


def test_health_dp_gates_pass_and_fail(monkeypatch, capsys):
    """chip_smoke.py's health_dp at world 1 on the CPU with a tiny Llama:
    its gates pass (losses bitwise with health off and on, the nonfinite
    and grad_explosion verdicts on HEALTH_BUCKET's name, every bucket's
    grad-norm gauge); a row that lacks the nonfinite verdict, whose losses
    are one ulp apart, or that breaks any other gate fails them."""
    global _HEALTH_ROW
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim.precision import adamw_lp
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "16384")
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "60")
    _HEALTH_ROW = chip_smoke.health_dp_phase(
        hvd, fa, llama, training, adamw_lp, torch.device("cpu"),
        over=_HEALTH_TINY, batch=(2, 16), profile=False)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "phase"] == "health_dp"
    assert chip_smoke.health_problems(_health_row(), _NO_LAUNCHES) == []
    assert len(_HEALTH_ROW["on"]["buckets"]) == 16
    ulp = float(np.nextafter(np.float32(_HEALTH_ROW["on"]["losses"][1]),
                             np.float32(0)))
    cases = {
        "no nonfinite verdict": {"nan.verdicts": []},
        "bit for bit": {
            "on.losses": lambda x: [x[0], ulp] + x[2:]},
        "no grad_explosion verdict": {"on.verdicts": []},
        "verdicts on clean updates": {"on.verdicts": lambda v: [
            dict(v[0], step=2)] + v},
        "nonfinite run's chaos rule never fired": {"nan.rule_fired": False},
        "lacks buckets": {"grad_norm_buckets": lambda b: b[1:]},
        "launches per step": {"on.launches_per_step": lambda st: [
            dict(st[0], fwd=1)] + st[1:]},
        "not finite and falling": {"on.losses": lambda x: [
            x[0]] * (len(x) - 1) + [x[-1]]},
    }
    for what, edit in cases.items():
        bad = chip_smoke.health_problems(_health_row(**edit), _NO_LAUNCHES)
        assert any(what in b for b in bad), (what, bad)


# -- the serving phases' gates (decode, serve) --------------------------------

def _logits(seed, shape=(4, 6, 32)):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def test_margin_rule_passes_reordering_and_fails_a_wrong_row():
    """Logits off by less than the tolerance pass, and a flip is allowed
    only at a near tie; another row's logits fail."""
    tol = chip_smoke.BATCH_LOGIT_TOL
    ref = _logits(0)
    noise = (torch.rand(ref.shape, generator=torch.Generator().manual_seed(
        1)) - 0.5) * tol
    bad, stats = chip_smoke.margin_check(ref + noise, ref, tol)
    assert bad == [] and stats["max_abs_logit_diff"] <= tol
    assert not stats["bitwise"] and stats["decided"] > 0
    bad, stats = chip_smoke.margin_check(ref.clone(), ref, tol)
    assert bad == [] and stats["bitwise"]
    # a near tie flipped by a reordering passes, a decided flip fails
    tie = ref.clone()
    top2 = tie[0, 0].topk(2)
    tie[0, 0, top2.indices[1]] = top2.values[0] - tol / 4
    flipped = tie.clone()
    flipped[0, 0, top2.indices[1]] = top2.values[0] + tol / 8
    assert chip_smoke.margin_check(flipped, tie, tol)[0] == []
    wrong = ref.clone()
    wrong[0, 1, ref[0, 1].argmin()] = ref[0, 1].max() + tol / 2
    assert chip_smoke.margin_check(wrong, ref, tol)[0]
    assert chip_smoke.margin_check(ref.flip(0), ref, tol)[0]


@pytest.mark.parametrize("gaps,kind", [
    ([0.0, 0.0, 0.0], "exact"), ([0.0, 0.01, 0.2], "near_tie"),
    ([0.0, 0.3, 0.0], None)])
def test_answer_rule(gaps, kind):
    """An answer whose every token is the sequential run's greedy choice,
    or within the tolerance of it, passes; a token further below fails."""
    problem, got = chip_smoke.answer_problem(gaps,
                                             chip_smoke.BATCH_LOGIT_TOL)
    assert got == kind and (problem is None) == (kind is not None)


def test_answer_gaps_are_zero_for_the_greedy_decode_only():
    """Teacher forced on its own greedy decode, a prompt's gaps are all
    0; on another token sequence some gap is not."""
    from horovod_tpu_torch.models import generate as gen
    from horovod_tpu_torch.models import llama
    cfg = llama.tiny(vocab=64, seq=64)
    params = llama.init_params(cfg, seed=1, device=torch.device("cpu"))
    prompt = torch.as_tensor(np.random.RandomState(0).randint(0, 64, 9))
    greedy = gen.greedy_generate(params, cfg, prompt[None], 6,
                                 max_len=16)[0].tolist()
    assert chip_smoke.answer_gaps(gen, params, cfg, prompt, greedy,
                                  16) == [0.0] * 6
    other = [(t + 1) % 64 for t in greedy]
    assert max(chip_smoke.answer_gaps(gen, params, cfg, prompt, other,
                                      16)) > 0


def test_kv_ledger_and_bucket_gates_on_a_paged_forward():
    """Every batch of a paged forward on the CPU meets the byte ledger
    exactly, shared heads included; a wrong count fails."""
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.serving import paging
    from horovod_tpu_torch.serving.models import paged_llama_decode_forward
    from horovod_tpu_torch.serving.shapes import ShapeBuckets
    cfg = llama.tiny(vocab=64, seq=64)
    params = llama.init_params(cfg, seed=0, device=torch.device("cpu"))
    buckets = ShapeBuckets((2, 4), (16,))
    fwd = chip_smoke._Recorded(paged_llama_decode_forward(
        params, cfg, 4, buckets, block_size=4))
    fwd.warmup()
    after_warmup = fwd.stats()
    rng = np.random.RandomState(0)
    head = rng.randint(0, 64, 8)
    rows = [np.concatenate([head, rng.randint(0, 64, n)]) for n in (3, 7)]
    rows.append(rng.randint(0, 64, 5))
    tokens = np.zeros((4, 16), np.int32)
    for i, r in enumerate(rows):
        tokens[i, :len(r)] = r
    lengths = np.array([len(r) for r in rows] + [1], np.int32)
    fwd(tokens, lengths, n_rows=3)
    batches = fwd.batches[-1:]
    blk = paging.kv_block_nbytes(cfg, 4)
    assert chip_smoke.expected_blocks([r.tolist() for r in rows], 4, 4) == \
        (4 + 5 + 3, 4 + 5 + 3 - 2)
    assert chip_smoke.kv_ledger_problems(batches, 4, 4, blk) == []
    assert chip_smoke.kv_ledger_problems(
        [dict(batches[0], bytes_in_use=batches[0]["bytes_in_use"] + 1)],
        4, 4, blk)
    assert chip_smoke.bucket_problems(after_warmup, fwd.stats(), 2) == []
    assert chip_smoke.bucket_problems(after_warmup, dict(
        fwd.stats(), recompiles=1), 2)
    assert chip_smoke.bucket_problems(after_warmup, fwd.stats(), 3)


def test_serve_run_passes_its_gates_on_the_cpu():
    """The card's ``serve`` phase, rehearsed on the CPU at a tiny size:
    every request answered equal to its sequential decode, no bucket
    prepared again, every batch's KV ledger exact, a head reused."""
    from horovod_tpu_torch.models import generate as gen
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.serving import paging
    cpu = torch.device("cpu")
    cfg = llama.tiny(vocab=64, seq=64)
    params = chip_smoke.serve_params(llama, gen, cfg, cpu)
    prompts = chip_smoke.serve_prompts(64, n=10, lo=2, hi=24, head=8,
                                       every=3)
    row, answers, fwd, batches, after_warmup = chip_smoke.serve_run(
        paging, params, cfg, prompts, 4, 4, (1, 2, 4), (8, 24), 2, 60.0)
    refs = {i: chip_smoke.answer_gaps(
        gen, params, cfg, torch.as_tensor(prompts[i]), a,
        (8 if len(prompts[i]) <= 8 else 24) + 4)
        for i, a in answers.items()}
    bad, kinds = chip_smoke.serve_problems(
        row, answers, refs, fwd, batches, after_warmup, cfg, paging, 4, 4,
        6)
    assert bad == [] and kinds == {"exact": 10, "near_tie": 0}
    assert row["completed"] == 10 and row["reuse_hits"] > 0
    assert sum(b["rows"] for b in batches) == 10


def test_decode_bound_at_the_1b_geometry():
    """A decode step at batch 8 must move the 1B model's bf16 weights
    (2.15 GB) and the k and v of every attended position."""
    from horovod_tpu_torch.models import llama
    cfg = chip_smoke.bench_config(llama)
    b = chip_smoke.decode_bound(cfg, llama.count_params, [128] * 8, 32)
    per_pos = 16 * 8 * 128 * 2 * 2
    assert b["weight_bytes"] == 2 * 1_073_809_408
    mean_kv = sum(8 * (128 + i + 1) * per_pos + 8 * per_pos
                  for i in range(31)) / 31
    assert b["kv_bytes"] == mean_kv
    assert b["bound_ms"] == pytest.approx(
        1e3 * (b["weight_bytes"] + mean_kv) / 3.35e12)


# -- the classifier phases ----------------------------------------------------

def test_flash_bounds_at_bert_shape_are_bytes():
    """At BERT's fine-tune shape (B 512, T 128, 12 heads of 64,
    non-causal) bytes bound all three flash kernels: the forward moves
    q, k, v, o (bf16) and lse (fp32), 405.8 MB, in 0.121 ms at 3.35 TB/s
    against 25.8 GFLOP in 0.026 ms."""
    case = dict(chip_smoke.KERNEL_CASES)["bert"]
    assert case == (512, 128, 12, 12, 64, False)
    want = {"fwd": (0.1211, 405_798_912), "dq": (0.1521, 509_607_936),
            "dkv": (0.1822, 610_271_232)}
    for kernel, (ms, nbytes) in want.items():
        bound_ms, by, flops, got = chip_smoke.bound(kernel, case)
        assert by == "bytes" and got == nbytes
        assert bound_ms == pytest.approx(ms, abs=1e-4)
        assert flops / chip_smoke.PEAK_BF16_FLOPS * 1e3 < bound_ms / 2


def test_mfu_is_six_n_tokens_over_the_peak():
    assert chip_smoke.mfu(109_485_316, 1e5) == pytest.approx(
        6 * 109_485_316 * 1e5 / 989e12)


def test_step_problems():
    ok = {"fwd": 24, "dq": 12}
    assert chip_smoke.step_problems([2.0, 1.5, 1.0], [ok, ok], ok) == []
    assert chip_smoke.step_problems([2.0, float("nan")], [], ok)
    assert chip_smoke.step_problems([2.0, 2.0], [], ok)
    assert chip_smoke.step_problems([2.0, 2.0], [], ok,
                                    falling_from=None) == []
    # the timed steps after an overshooting first step
    assert chip_smoke.step_problems([1.4, 3.5, 2.2, 1.6], [], ok,
                                    falling_from=1) == []
    assert chip_smoke.step_problems([1.4, 3.5, 2.2, 1.6], [], ok)
    assert chip_smoke.step_problems([2.0, 1.0], [dict(ok, dq=11)], ok)


@pytest.mark.parametrize("remat", [True, False])
def test_bert_step_runs_each_flash_kernel_as_train_bert_expects(
        monkeypatch, remat):
    """The fine-tune step at head_dim 64 and seq 128 calls the flash
    forward twice a layer with remat (the block's recompute) and once
    without, dq and dK/dV once a layer: EXPECTED_BERT_LAUNCHES at
    bert_base's 12 layers.  On the CPU the wrappers run their plain
    versions, so their calls are counted here."""
    import dataclasses
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.ops import flash_attention as fa
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for kernel, name in (("fwd", "_flash_fwd_bhtd"), ("dq", "_dq"),
                         ("dkv", "_dkv")):
        def counted(*a, _f=getattr(fa, name), _k=kernel, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(fa, name, counted)
    cfg = dataclasses.replace(chip_smoke.bert_config(bert), vocab_size=256,
                              d_model=128, n_heads=2, d_ff=256, n_layers=2,
                              remat=remat)
    ts = bert.make_dp_finetune_step(cfg, bert.finetune_optimizer,
                                    device="cpu")
    params, opt_state = ts.init_fn(0)
    toks = torch.zeros((2, chip_smoke.BERT_SEQ), dtype=torch.long)
    ts.step_fn(params, opt_state, toks, toks[:, 0])
    L = cfg.n_layers
    assert calls == {"fwd": (2 if remat else 1) * L, "dq": L, "dkv": L}
    assert fa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}
    full = chip_smoke.bert_config(bert)
    assert full.remat and chip_smoke.EXPECTED_BERT_LAUNCHES == {
        "fwd": 2 * full.n_layers, "dq": full.n_layers,
        "dkv": full.n_layers, "xent_fwd": 0, "xent_dh": 0, "xent_dw": 0}


def _dp2_result():
    return {"loss": 6.9, "loss_dp1": 6.9001, "identical_after_step": True,
            "update_norms": {"stem": (1.0, 1.001), "stage0.0.conv0": (0.0,
                                                                      0.0)},
            "update_cos": {"stem": 0.9999, "stage0.0.conv0": 0.0},
            "state_rel": {"stem_bn.mean": 1e-3}}


def test_resnet_dp2_problems():
    """The gates of train_resnet_dp2: a leaf whose update is exactly 0 at
    dp 1 (behind a zero-initialized scale) passes only as an exact 0."""
    assert chip_smoke.resnet_dp2_problems(_dp2_result()) == []
    for change in ({"identical_after_step": False}, {"loss": 7.0},
                   {"update_norms": {"stem": (1.1, 1.0)}},
                   {"update_norms": {"stem": (1e-9, 0.0)}},
                   {"update_cos": {"stem": 0.98}},
                   {"state_rel": {"stem_bn.var": 0.02}}):
        assert chip_smoke.resnet_dp2_problems(
            dict(_dp2_result(), **change)), change


def test_cosine_problems():
    a = torch.arange(1.0, 101.0)
    norms, cos, bad = chip_smoke.cosine_problems(
        {"same": (a, a.clone()), "scaled": (a * 1.05, a),
         "turned": (a.flip(0), a)})
    assert cos["same"] == pytest.approx(1.0)
    assert [b.split()[1] for b in bad] == ["scaled:", "turned:"]


def test_parse_clocks():
    assert chip_smoke.parse_clocks("1980, 2619, 312.45") == {
        "sm_mhz": 1980.0, "mem_mhz": 2619.0, "power_w": 312.45}
    assert chip_smoke.parse_clocks("1755, 2619, [N/A]")["power_w"] is None


# --- elastic_resnet's gates -------------------------------------------------

def _digest(v):
    return {"params": [float(v), f"p{v}"], "bn": [1.0, "b"],
            "momentum": [0.0, "m"]}


def test_digest_problems_groups_by_epoch_and_step():
    recs = [{"kind": "sync", "epoch": 2, "step": 3, "rank": r,
             "digest": _digest(1)} for r in (0, 1)]
    recs += [{"kind": "commit", "epoch": 0, "step": 3, "rank": 0,
              "digest": _digest(1)},
             {"kind": "commit", "epoch": 0, "step": 3, "rank": 1,
              "digest": _digest(2)},
             {"kind": "commit", "epoch": 4, "step": 6, "rank": 0,
              "digest": _digest(2)}]
    assert chip_smoke.digest_problems(recs, "sync") == []
    bad = chip_smoke.digest_problems(recs, "commit")
    assert len(bad) == 1 and "epoch 0 step 3" in bad[0]
    assert "[0, 1]" in bad[0]


def test_tree_digest_orders_leaves_by_path_and_sees_one_bit():
    a = {"x": torch.arange(4.0), "y": {"z": torch.ones(2, 2)}}
    b = {"y": {"z": torch.ones(2, 2)}, "x": torch.arange(4.0)}
    assert chip_smoke.tree_digest(a) == chip_smoke.tree_digest(b)
    c = {"x": torch.arange(4.0), "y": {"z": torch.ones(2, 2)}}
    c["x"].view(torch.int32)[0] ^= 1          # one bit of one leaf
    assert chip_smoke.tree_digest(c)[1] != chip_smoke.tree_digest(a)[1]
    assert chip_smoke.tree_digest(a)[0] == 10.0


def _step(epoch, idx):
    return {"kind": "step", "data_epoch": epoch, "indices": idx}


def test_sampler_problems():
    whole = [_step(0, list(range(0, 5))), _step(0, list(range(5, 10))),
             _step(1, [3, 4])]
    assert chip_smoke.sampler_problems(whole, 10) == []
    twice = whole + [_step(1, [4, 7])]
    assert chip_smoke.sampler_problems(twice, 10) == [
        "data epoch 1: 1 indices taken twice"]
    dropped = [_step(0, list(range(0, 9))), _step(1, [0])]
    assert chip_smoke.sampler_problems(dropped, 10) == [
        "data epoch 0 ended with 9 of 10 indices"]


def _events(*seq):
    out, t = [], 0.0
    for name, epoch, size in seq:
        t += 1.5
        out.append((name, {"epoch": epoch, "size": size, "t": t}))
    return out


def test_transition_problems_and_reform_seconds():
    ev = _events(("epoch_applied", 0, 2), ("epoch_formed", 0, 2),
                 ("epoch_applied", 1, 2), ("epoch_applied", 2, 2),
                 ("epoch_formed", 2, 2), ("epoch_applied", 3, 1),
                 ("epoch_formed", 3, 1))
    bad, reform = chip_smoke.transition_problems(ev, [2, 2, 1])
    assert bad == [] and reform == [1.5, 1.5, 1.5]
    bad, _ = chip_smoke.transition_problems(ev, [2, 2, 1, 2])
    assert bad == ["epochs formed at sizes [2, 2, 1], expected "
                   "[2, 2, 1, 2]"]
    wrong = _events(("epoch_applied", 0, 3), ("epoch_formed", 0, 2))
    bad, reform = chip_smoke.transition_problems(wrong, [2])
    assert bad == ["epoch 0 formed at size 2 without its epoch_applied "
                   "at that size"] and reform == []


_REHEARSAL = '''
import sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke
from horovod_tpu_torch.models import resnet
torch.cuda.synchronize = lambda *a: None
torch.cuda.max_memory_allocated = lambda *a: 0
_cfg = resnet.ResNetConfig
resnet.ResNetConfig = lambda variant=50, **kw: _cfg(
    variant=18, num_classes=10, width=8, dtype=torch.float32)
chip_smoke.RESNET_IMG = 32


def batch(b, img, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, 3, img, img), generator=g),
            torch.randint(0, 10, (b,), generator=g))


chip_smoke.resnet_batch = batch
sys.exit(chip_smoke.elastic_child(torch.device("cpu"), sys.argv[2]))
'''


def test_chip_smoke_elastic_phase_on_the_cpu(tmp_path, capsys):
    """chip_smoke.py's elastic_resnet, whole, with workers that run a
    tiny fp32 ResNet-18 on the CPU: the reference run under the static
    launcher, the kill in rank 1's backward pass, the shrink and the
    growth, and every gate of the phase (transitions, digests, the exact
    restore, steps 4-6 bit for bit, the sampler, GET /health/job and
    /timeseries/job with the SLO rule's verdict)."""
    wrapper = tmp_path / "worker.py"
    wrapper.write_text(_REHEARSAL.format(
        root=str(pathlib.Path(__file__).resolve().parents[1])))
    chip_smoke.elastic_resnet_phase(worker_script=wrapper)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "elastic_resnet"
    assert [size for _, size in row["formed"]] == [2, 2, 1, 2]
    assert row["steps_reexecuted"] == 1 and row["recover_s"] > 0
    assert len(row["step_ms_size1"]) == 2
    # the health and time-series scrapes at the pause of step 6
    hj = row["health_job"]
    assert hj["verdict"] == "healthy" and hj["scraped"] == 2
    assert {v["rule"] for v in hj["slo_verdicts"]} == {
        chip_smoke.ELASTIC_SLO}
    assert chip_smoke.health_job_problems(
        hj, [int(w) for w in hj["workers"]]) == []
    assert chip_smoke.health_job_problems(
        dict(hj, verdict="unhealthy"), [int(w) for w in hj["workers"]])


# --- recover_resnet's and hvd_run's gates -----------------------------------

def _recover_records(**edit):
    """Canned records of a recover_resnet run that passes its gates: rank
    1 rebuilt (epoch 0, step 3), rank 0 restored its commit of step 3,
    steps 4-6 of both ranks equal the reference's.  ``edit`` replaces the
    rebuilt record's fields (``tile``, ``version``, ``time_count``) or
    one step's (``weights_5``: rank 0's weight digest of step 5)."""
    w = {"x": torch.linspace(-1, 1, 8)}
    ref = [{"kind": "step", "rank": r, "step": s, "loss": 1.0 + s / 8,
            "weights": chip_smoke.tree_digest(w), "bn": [1.0, "b"],
            "tile": [f"t{r}{s}", True]}
           for r in (0, 1) for s in range(3, 7)]
    recs = [dict(r) for r in ref if r["step"] >= 4]
    recs.append({"kind": "restore", "rank": 0, "step": 3})
    rebuilt = {"kind": "rebuilt", "rank": 1, "version": [0, 3],
               "tile": ["t13", True], "time_count": 1}
    rebuilt.update({k: v for k, v in edit.items()
                    if k in ("tile", "version", "time_count")})
    recs.append(rebuilt)
    if "weights_5" in edit:
        next(r for r in recs if r["kind"] == "step" and r["rank"] == 0
             and r["step"] == 5)["weights"] = edit["weights_5"]
    return recs, ref


def test_recover_problems_pass_on_a_good_run():
    recs, ref = _recover_records()
    stats = {"rebuilds": [{"src_rank": 1, "step": 3}]}
    assert chip_smoke.recover_problems(recs, ref, stats) == []


def test_recover_problems_fail_canned_bad_records():
    stats = {"rebuilds": [{"src_rank": 1}]}
    bad = chip_smoke.recover_problems(*_recover_records(version=[0, 2]),
                                      stats)
    assert any("rebuilt version [0, 2]" in b for b in bad)
    bad = chip_smoke.recover_problems(*_recover_records(
        tile=["t13", False]), stats)
    assert "the rebuilt tile is all zeros" in bad
    bad = chip_smoke.recover_problems(*_recover_records(
        tile=["t03", True]), stats)
    assert len(bad) == 1 and "not the reference rank 1's" in bad[0]
    flipped = {"x": torch.linspace(-1, 1, 8)}
    flipped["x"].view(torch.int32)[3] ^= 1    # one bit of the weights
    bad = chip_smoke.recover_problems(*_recover_records(
        weights_5=chip_smoke.tree_digest(flipped)), stats)
    assert len(bad) == 1 and bad[0].startswith("rank 0 step 5: weights")
    bad = chip_smoke.recover_problems(*_recover_records(), {"rebuilds": []})
    assert bad == ["recovery/stats lists no rebuild of rank 1: "
                   "{'rebuilds': []}"]
    bad = chip_smoke.recover_problems(*_recover_records(time_count=0),
                                      stats)
    assert bad == ["hvd_recovery_time_seconds count 0"]
    recs, ref = _recover_records()
    assert chip_smoke.recover_problems(
        [r for r in recs if r["kind"] != "rebuilt"], ref, stats) == \
        ["0 rebuilds recorded"]


def _hvd_run_res(**over):
    name = "NVIDIA H100 80GB HBM3"
    res = {"run2": [(0, 2, [1.0] * 4, name), (1, 2, [1.0] * 4, name)],
           "run1": [(0, 1, [0.0] * 4, name)],
           "remote": [(0, 2, [1.0] * 4, name), (1, 2, [1.0] * 4, name)],
           "counts": [[1, 1], [2, 2]], "failure": True}
    res.update(over)
    return res


def test_hvd_run_problems_pass_and_fail():
    assert chip_smoke.hvd_run_problems(_hvd_run_res()) == []
    res = _hvd_run_res()
    bad = chip_smoke.hvd_run_problems(_hvd_run_res(
        run2=res["run2"][::-1]))
    assert bad == ["run(np=2): results in rank order [1, 0]"]
    bad = chip_smoke.hvd_run_problems(_hvd_run_res(
        run1=[(0, 1, [1.0] * 4, "x")]))
    assert len(bad) == 1 and "run(np=1): rank 0 got size 1" in bad[0]
    assert chip_smoke.hvd_run_problems(_hvd_run_res(
        counts=[[1, 1], [1, 1]])) == [
        "the executor's counter read [[1, 1], [1, 1]]"]
    assert chip_smoke.hvd_run_problems(_hvd_run_res(failure=False)) == [
        "a failing function did not raise RuntimeError"]


_RECOVER_REHEARSAL = _REHEARSAL.replace(
    "chip_smoke.elastic_child(", "chip_smoke.recover_child(")


def test_chip_smoke_recover_phase_on_the_cpu(tmp_path, capsys):
    """chip_smoke.py's recover_resnet, whole, with workers that run a
    tiny fp32 ResNet-18 on the CPU: the reference run, the kill in rank
    1's backward pass of step 4, the re-form, the replacement's rebuild
    from the survivor, and every gate of the phase."""
    wrapper = tmp_path / "worker.py"
    wrapper.write_text(_RECOVER_REHEARSAL.format(
        root=str(pathlib.Path(__file__).resolve().parents[1])))
    row = chip_smoke.recover_resnet_phase(worker_script=wrapper)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "phase"] == "recover_resnet"
    assert row["rebuilt_version"] == [0, 3]
    assert [size for _, size in row["formed"]] == [2, 2]
    assert 0 < row["priced_tile_bytes"] < row["frame_bytes"]
    assert row["recover_s"] > 0 and row["push_ms"]


# --- the model-parallel phases: the lse case, train_moe, train_tp2_sp2
# and train_moe_ep2 ---------------------------------------------------------

def test_lse_path_gates_pass_and_fail():
    ok = {"out_err": 1e-2, "lse_err": 5e-4, "dq_rel": 1e-2, "dk_rel": 1e-2,
          "dv_rel": 1e-2}
    assert chip_smoke.lse_path_problems(ok) == []
    for key, bad in (("out_err", 0.1), ("lse_err", 2e-3), ("dq_rel", 0.05),
                     ("dv_rel", 1.0)):
        assert chip_smoke.lse_path_problems(dict(ok, **{key: bad}))


def test_lse_autograd_errors_are_small_for_the_plain_path(monkeypatch):
    """lse_autograd_errors on the CPU: flash_attention_lse's plain path and
    its autograd with an lse cotangent against the plain kernels with the
    cotangent folded into delta, at a small ring-tile shape."""
    from horovod_tpu_torch.ops import flash_attention as fa
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    g = torch.Generator().manual_seed(0)
    B, H, Hkv, T, D = 1, 4, 2, 128, 64
    q, do = (torch.randn(B, H, T, D, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, T, D, generator=g).bfloat16()
            for _ in range(2))
    dlse = torch.randn(B, H, T, generator=g)
    for causal in (True, False):
        scale = D ** -0.5
        ref_out, ref_lse = fa._fwd_reference(q, k, v, causal, scale)
        delta = (do.float() * ref_out.float()).sum(-1) - dlse
        args = (q, k, v, do, ref_lse, delta, causal, scale)
        grads = (fa._dq_reference(*args), *fa._dkv_reference(*args))
        errs = chip_smoke.lse_autograd_errors(
            fa, q, k, v, do, dlse, causal, scale, ref_out, ref_lse, grads)
        assert chip_smoke.lse_path_problems(errs) == [], errs
        # the same check without the fold misses dlse's term
        nofold = (do.float() * ref_out.float()).sum(-1)
        wrong = fa._dq_reference(q, k, v, do, ref_lse, nofold, causal,
                                 scale)
        assert chip_smoke.rel(grads[0], wrong) > chip_smoke.GRAD_REL


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_launch_schedule(sp):
    """Rank i of a causal ring runs its diagonal tile and the i earlier
    blocks' (tests/test_torch_parallel.py counts the tiles of the ring
    itself); all ranks together run sp(sp+1)/2 tiles a layer, non-causal
    sp² ."""
    tiles = [chip_smoke.ring_launches(i, sp, 1)["fwd"] for i in range(sp)]
    assert tiles == list(range(1, sp + 1))
    assert sum(tiles) == sp * (sp + 1) // 2
    assert all(chip_smoke.ring_launches(i, sp, 3, causal=False)
               == {"fwd": 3 * sp, "dq": 3 * sp, "dkv": 3 * sp}
               for i in range(sp))
    assert chip_smoke.ring_launches(1, 2, 2) == {"fwd": 4, "dq": 4,
                                                 "dkv": 4}
    assert chip_smoke.ulysses_launches(2) == {"fwd": 2, "dq": 2, "dkv": 2}


def _mp_result():
    ref = [10.9, 9.9, 8.9]
    coords = [{"dp": 0, "pp": 0, "sp": s, "tp": t} for s in (0, 1)
              for t in (0, 1)]

    def run(attn):
        want = [chip_smoke.ring_launches(c["sp"], 2, 2) if attn == "ring"
                else chip_smoke.ulysses_launches(2) for c in coords]
        return {"coords": coords,
                "losses_by_rank": [[10.9005, 9.92, 8.92]] * 4,
                "launches_per_step_by_rank": [[w] * 3 for w in want],
                "dlse_folds_by_rank": ([6, 6, 12, 12] if attn == "ring"
                                       else [0] * 4)}

    return {"losses_world1": ref, "ring": run("ring"),
            "ulysses": run("ulysses")}


def test_mp_gates_pass_and_fail():
    assert chip_smoke.mp_problems(_mp_result()) == []
    assert chip_smoke.loss_gaps([1.1, 2.0], [1.0, 2.0]) == pytest.approx(
        [0.1, 0.0])
    res = _mp_result()
    res["ring"]["losses_by_rank"][3] = [10.9005, 9.92, 8.9200001]
    assert any("differ" in b for b in chip_smoke.mp_problems(res))
    res = _mp_result()
    res["ulysses"]["losses_by_rank"] = [[10.902, 9.92, 8.92]] * 4
    assert any("gaps" in b for b in chip_smoke.mp_problems(res))
    res = _mp_result()
    res["ring"]["losses_by_rank"] = [[10.9005, 9.96, 8.92]] * 4
    assert any("gaps" in b for b in chip_smoke.mp_problems(res))
    res = _mp_result()
    res["ring"]["launches_per_step_by_rank"][2][1] = {"fwd": 2, "dq": 2,
                                                       "dkv": 2}
    assert any("rank 2" in b for b in chip_smoke.mp_problems(res))
    res = _mp_result()
    res["ring"]["dlse_folds_by_rank"] = [0] * 4
    assert any("lse" in b for b in chip_smoke.mp_problems(res))


def _ep_run(losses, kept, world1=(10.9, 9.9, 8.9)):
    return {"losses_world1": list(world1),
            "losses_by_rank": [list(losses)] * 2,
            "kept_by_rank": [list(kept)] * 2, "kept_world1": [1.0] * 6,
            "launches_per_step_by_rank": [[{"fwd": 2, "dq": 2,
                                            "dkv": 2}] * 3] * 2}


def test_ep_gates_pass_and_fail():
    """Every step is held where every pick kept its slot on both sides,
    the first step alone where capacity dropped some."""
    dropless = _ep_run([10.91, 9.94, 8.87], [1.0] * 6)
    dropping = _ep_run([10.91, 9.6, 7.9], [0.85, 0.9, 0.7, 0.6, 0.7, 0.7])

    def res(**variants):
        return {"variants": variants}

    assert chip_smoke.ep_problems(res(a=dropping, b=dropless)) == []
    # without a dropless variant no step-by-step gate ran
    assert chip_smoke.ep_problems(res(a=dropping))
    assert chip_smoke.ep_problems(res(b=_ep_run([10.91, 9.96, 8.87],
                                                [1.0] * 6)))
    assert chip_smoke.ep_problems(res(a=_ep_run([10.96, 9.6, 7.9],
                                                [0.9] * 6), b=dropless))
    bad = dict(dropless, losses_by_rank=[[10.91, 9.94, 8.87],
                                         [10.91, 9.94, 8.88]])
    assert chip_smoke.ep_problems(res(b=bad))
    bad = dict(dropless, launches_per_step_by_rank=[
        [{"fwd": 4, "dq": 4, "dkv": 4}] * 3] * 2)
    assert chip_smoke.ep_problems(res(b=bad))


def test_moe_step_runs_each_flash_kernel_as_train_moe_expects(monkeypatch):
    """train_moe's schedule at 4 layers, the last 2 not rematerialized:
    the forward 6 times a step, dq and dK/dV 4; the step at tiny widths
    with head_dim 64 and seq 128, the plain versions' calls counted."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for kernel, name in (("fwd", "_flash_fwd_bhtd"), ("dq", "_dq"),
                         ("dkv", "_dkv")):
        def counted(*a, _f=getattr(fa, name), _k=kernel, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(fa, name, counted)
    import dataclasses
    cfg = dataclasses.replace(
        chip_smoke.bench_config(llama, n_layers=chip_smoke.MOE_LAYERS,
                                **chip_smoke.MOE_OVER),
        vocab_size=256, d_model=128, n_heads=2, n_kv_heads=1, d_ff=128,
        max_seq_len=128)
    ts = training.make_llama_train_step(cfg, device="cpu")
    params, opt_state = ts.init_fn(0)
    toks = torch.zeros((1, 128), dtype=torch.long)
    ts.step_fn(params, opt_state, toks, toks)
    assert calls == chip_smoke.EXPECTED_MOE_LAUNCHES


_MP_REHEARSAL = '''
import dataclasses
import sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa
_bench = chip_smoke.bench_config
chip_smoke.bench_config = lambda llama, **over: dataclasses.replace(
    _bench(llama, **over), vocab_size=512, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, max_seq_len=256)
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
# the plain versions' calls stand for the kernels' launches
for kernel, name in (("fwd", "_flash_fwd_bhtd"), ("dq", "_dq"),
                     ("dkv", "_dkv")):
    def counted(*a, _f=getattr(fa, name), _k=kernel, **k):
        fa.LAUNCHES[_k] += 1
        return _f(*a, **k)
    setattr(fa, name, counted)
child = chip_smoke.mp_child if sys.argv[1] == "--mp-rank" \\
    else chip_smoke.ep_child
sys.exit(child(int(sys.argv[2]), torch.device("cpu")))
'''


def test_chip_smoke_model_parallel_phases_on_the_cpu(tmp_path, capsys,
                                                    monkeypatch):
    """train_tp2_sp2 (four ranks: ring, then Ulysses, then one process on
    the whole batch) and train_moe_ep2 (two ranks, then one process),
    whole, at small widths on the CPU, through every gate of the phases:
    the ranks' losses the same bits, the world-1 gaps, each rank's
    launches on the ring's schedule, the lse folds, the all-to-all bytes
    of the [E, C, D] slots."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # four ranks on few cores
    wrapper = tmp_path / "ranks.py"
    wrapper.write_text(_MP_REHEARSAL.format(
        root=str(pathlib.Path(__file__).resolve().parents[1])))
    mp = chip_smoke.train_tp2_sp2_phase(script=wrapper)
    ep = chip_smoke.train_moe_ep2_phase(script=wrapper)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["phase"] for x in lines] == ["train_tp2_sp2", "train_moe_ep2"]
    assert [n["fwd"] for n in mp["ring"]["launches_by_rank"]] == [6, 6, 12,
                                                                  12]
    assert mp["ring"]["local_batch"] == [chip_smoke.MP_BATCH, 128]
    assert all("tp.all_reduce" in b and "sp.ppermute" in b
               for b in mp["ring"]["host_bytes_per_step_by_rank"])
    run = ep["variants"]["cf1.25"]
    assert run["capacity"] == 160
    assert run["all_to_all_bytes_per_layer_each_way"] == 8 * 160 * 256 * 2
    # capacity factor 8 leaves a slot for every pick, on both sides
    run = ep["variants"]["cf8"]
    assert min(run["kept_by_rank"][0] + run["kept_world1"]) == 1.0


def test_kernel_cases_hold_the_model_parallel_paths_shapes():
    """The kernels phase checks each flash kernel at the shapes the
    model-parallel phases give it: train_tp2_sp2's ring tile and Ulysses
    attention, and train_moe_ep2's attention."""
    from horovod_tpu_torch.models import llama
    cfg = chip_smoke.bench_config(llama)
    H, Hkv, D, T = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len
    sp, tp = chip_smoke.MP_MESH["sp"], chip_smoke.MP_MESH["tp"]
    cases = dict(chip_smoke.KERNEL_CASES)
    B = chip_smoke.MP_BATCH
    assert cases["lse"] == (B, T // sp, H // tp, Hkv // tp, D, True)
    assert cases["lse_noncausal"] == (B, T // sp, H // tp, Hkv // tp, D,
                                      False)
    assert cases["ulysses"] == (B, T, H // (tp * sp), Hkv // (tp * sp), D,
                                True)
    assert cases["ep"] == (chip_smoke.EP_BATCH, T, H, Hkv, D, True)
    assert set(chip_smoke.MP_CASES) <= set(cases)


def test_bf16_step():
    x = torch.tensor([1.0, 1.5, 0.75, -3.0, 0.0])
    want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 2.0 ** -6,
                         2.0 ** -133])
    assert torch.equal(chip_smoke.bf16_step(x), want)
    # a step up is the next bf16 value; a quarter step rounds back
    for v in (1.0, 0.75, 3.0, 100.0, -5.5):
        t = torch.tensor([v]).bfloat16().float()
        step = chip_smoke.bf16_step(t)
        assert torch.equal((t + step).bfloat16().float() - t, step)
        assert torch.equal((t + step / 4).bfloat16().float(), t)


def test_top_k_picks_are_the_dispatch_picks():
    """top_k_picks gives the experts moe._top_k_dispatch routes each token
    to, in pick order, at a capacity that drops nothing."""
    from horovod_tpu_torch.models import moe
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(64, 8, generator=g).bfloat16()
    picks = chip_smoke.top_k_picks(logits, 2)
    dispatch = moe._top_k_dispatch(torch.softmax(logits.float(), -1), 2,
                                   128)[0]
    chosen = dispatch.sum(-1)
    for n in range(64):
        assert set(chosen[n].nonzero()[:, 0].tolist()) == set(
            picks[n].tolist())
        assert logits[n, picks[n, 0]] >= logits[n, picks[n, 1]]


def test_route_compare_tells_a_near_tie_from_a_wrong_pick():
    """One token's 2nd and 3rd logits a bf16 step apart and swapped on the
    other side: a near-tie.  Ten steps apart and swapped: the rule fails."""
    base = torch.tensor([[3.0, 1.0, 0.5, -1.0],
                         [2.0, 1.0, 0.0, -2.0]]).bfloat16()
    step = chip_smoke.bf16_step(torch.tensor(1.0)).item()
    for gap, ok in ((1, True), (10, False)):
        b = base.clone()
        b[1, 2] = 1.0 - gap * step
        a = b.clone()
        a[1, 1], a[1, 2] = b[1, 2], b[1, 1]
        differ, stats = chip_smoke.route_compare(a, b, 2)
        assert differ.tolist() == [False, True]
        assert stats["differing"] == 1 and stats["gap_steps"] == [gap]
        assert (chip_smoke.route_problems(stats) == []) == ok
    same, stats = chip_smoke.route_compare(base, base, 2)
    assert not same.any() and stats["max_logit_diff_steps"] == 0


def test_chip_smoke_parity_moe_route_on_the_cpu(monkeypatch, capsys):
    """parity_moe_route whole at small widths with the CPU on both sides:
    the same picks, the agreeing tokens' rows and gradients equal."""
    import dataclasses
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models import llama
    monkeypatch.setattr(chip_smoke, "bench_config", lambda _, **over: (
        dataclasses.replace(llama.LlamaConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=256, remat=True, remat_policy="full",
            remat_skip_layers=2), **over)))
    row = chip_smoke.parity_moe_route_phase(llama, convert,
                                            torch.device("cpu"))
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "parity_moe_route" and line["top_k"] == 2
    assert line["layers"] == 1
    assert [x["differing"] for x in line["full_model"]] == [0]
    assert row["agreeing"] == row["tokens"] == 512
    assert row["capacity"] == 160
    assert all(a == b for a, b in row["norms"].values())


def test_parity_moe_route_depth_cut_leaves_its_gates_as_they_were(
        monkeypatch, capsys):
    """parity_moe_route's forward through layer 0 alone gives the gated
    layer-0 numbers of the forward through both layers, exactly: the
    same weights (drawn at 2 layers) and the same input to layer 0."""
    import dataclasses
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models import llama
    base = llama.LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, remat=True, remat_policy="full",
        remat_skip_layers=2)
    cpu = torch.device("cpu")
    rows = []
    for depth in (None, 2):   # the phase's own depth, then both layers
        monkeypatch.setattr(chip_smoke, "bench_config", lambda _, **over: (
            dataclasses.replace(base, **{**over, **(
                {"n_layers": depth} if depth and over.get("n_layers") == 1
                else {})})))
        rows.append(chip_smoke.parity_moe_route_phase(llama, convert, cpu))
        line = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert line["layers"] == (depth or 1)
    assert rows[0] == rows[1]


# -- the pipeline, BERT's tp x sp, FSDP and mp serving ------------------------

def test_pp_launch_schedule():
    """A stage of 8 layers, the last 2 not rematerialized, on 4 live
    microbatches: the forward 4 x 14 times, dq and dkv 4 x 8."""
    assert chip_smoke.pp_launches(8, 4, 2) == {"fwd": 56, "dq": 32,
                                               "dkv": 32}
    assert chip_smoke.pp_launches(1, 4, 2) == {"fwd": 4, "dq": 4, "dkv": 4}


def _pp_result(**over):
    want = chip_smoke.pp_launches(8, chip_smoke.PP_MICRO, 2)
    res = {"layers_per_stage": 8, "remat_skip_layers": 2,
           "losses_by_rank": [[10.9, 9.9001, 8.9002, 7.9]] * 2,
           "launches_per_step_by_rank": [[want] * 3] * 2}
    res.update(over)
    return res


def test_pp_gates_pass_and_fail():
    ref = [10.9, 9.9, 8.9, 7.9]
    assert chip_smoke.pp_problems(_pp_result(), ref) == []
    res = _pp_result(losses_by_rank=[[10.9, 9.9001, 8.9002, 7.9],
                                     [10.9, 9.9001, 8.9002, 7.90001]])
    assert any("differ" in b for b in chip_smoke.pp_problems(res, ref))
    res = _pp_result(losses_by_rank=[[10.91, 9.9, 8.9, 7.9]] * 2)
    assert any("gaps" in b for b in chip_smoke.pp_problems(res, ref))
    res = _pp_result(losses_by_rank=[[10.9, 9.9, 8.9, 11.0]] * 2)
    assert any("fall" in b for b in chip_smoke.pp_problems(res, ref))
    bad = {"fwd": 64, "dq": 32, "dkv": 32}     # fill and drain computed
    res = _pp_result(launches_per_step_by_rank=[
        [bad] * 3, _pp_result()["launches_per_step_by_rank"][1]])
    assert any("stage 0" in b for b in chip_smoke.pp_problems(res, ref))


def _bert_mp_result(**over):
    want = chip_smoke.bert_mp_launches(12, 2, True)
    grads = {
        # a v weight near fp32 on both sides: within 2e-2 of its norm
        "layers.0.wv": {"norm_fp32": 6.0, "err_fp32": 0.01,
                        "err_fp32_world1": 0.004},
        # a deep q weight whose bf16 gradient is noise on both sides
        "layers.11.wq": {"norm_fp32": 0.01, "err_fp32": 0.012,
                         "err_fp32_world1": 0.01},
        # a key bias: exactly 0 in fp32, rounding residue in bf16
        "layers.0.bk": {"norm_fp32": 1e-9, "err_fp32": 1e-4,
                        "err_fp32_world1": 2e-4}}
    res = {"layers": 12, "loss": -0.0889, "loss_world1": -0.0895,
           "loss_fp32": -0.0892, "grads": grads,
           "launches_by_rank": [want] * 4}
    res.update(over)
    return res


def test_bert_mp_gates_pass_and_fail():
    assert chip_smoke.bert_mp_launches(12, 2, True) == {
        "fwd": 48, "dq": 24, "dkv": 24}
    assert chip_smoke.bert_mp_problems(_bert_mp_result()) == []
    res = _bert_mp_result(loss=-0.0850)
    assert any("loss" in b for b in chip_smoke.bert_mp_problems(res))
    res = _bert_mp_result()
    res["grads"]["layers.0.wv"]["err_fp32"] = 0.2
    assert any("layers.0.wv" in b for b in chip_smoke.bert_mp_problems(res))
    res = _bert_mp_result()
    res["grads"]["layers.11.wq"]["err_fp32"] = 0.03
    assert any("layers.11.wq" in b
               for b in chip_smoke.bert_mp_problems(res))
    res = _bert_mp_result()
    res["grads"]["layers.0.bk"]["err_fp32"] = 1e-3
    assert any("bk" in b for b in chip_smoke.bert_mp_problems(res))
    res = _bert_mp_result(launches_by_rank=[{"fwd": 24, "dq": 12,
                                             "dkv": 12}] * 4)
    assert any("launches" in b for b in chip_smoke.bert_mp_problems(res))


def _fsdp_result(**over):
    run = {"losses_by_rank": [[10.9, 9.9004, 8.9]] * 2,
           "launches_per_step_by_rank": [
               [chip_smoke.EXPECTED_FSDP_LAUNCHES] * 3] * 2,
           "param_bytes_by_rank": [1000, 1000],
           "state_bytes_by_rank": [1000, 1000],
           "tile_bytes_by_rank": [0, 0]}
    ov = dict(run, state_bytes_by_rank=[1002, 1002],
              tile_bytes_by_rank=[1002, 1002])
    res = {"variants": {"plain": run, "overlap": ov},
           "losses_world1": [10.9, 9.9, 8.9], "param_bytes_expected": 1000,
           "replica_bytes": 1990, "replica_state_bytes": 1990}
    res.update(over)
    return res


def test_fsdp_gates_pass_and_fail():
    assert chip_smoke.fsdp_problems(_fsdp_result()) == []
    res = _fsdp_result()
    res["variants"]["plain"]["param_bytes_by_rank"] = [1000, 1004]
    assert any("parameter bytes" in b for b in chip_smoke.fsdp_problems(res))
    res = _fsdp_result()
    res["variants"]["overlap"]["state_bytes_by_rank"] = [2004, 2004]
    assert any("optimizer state" in b for b in chip_smoke.fsdp_problems(res))
    res = _fsdp_result(replica_bytes=1000, replica_state_bytes=1000)
    assert any("replica" in b for b in chip_smoke.fsdp_problems(res))
    res = _fsdp_result()
    res["variants"]["overlap"]["losses_by_rank"] = [[10.9, 9.95, 8.9]] * 2
    assert any("gaps" in b for b in chip_smoke.fsdp_problems(res))
    res = _fsdp_result()
    res["variants"]["plain"]["launches_per_step_by_rank"] = [
        [{"fwd": 4, "dq": 4, "dkv": 4}] * 3] * 2
    assert any("launches" in b for b in chip_smoke.fsdp_problems(res))


def _serve_mp_result(**over):
    res = {"requests": 8, "batches": [1, 1, 1, 1, 4],
           "equal_world1": [True] * 5, "ranks_agree": True,
           "stats": {"per_chip_param_nbytes": 600,
                     "replica_param_nbytes": 1000, "recompiles": 0},
           "per_chip_expected": 600}
    res.update(over)
    return res


def test_serve_mp_gates_pass_and_fail():
    assert chip_smoke.serve_mp_problems(_serve_mp_result()) == []
    for over, word in (({"requests": 4, "batches": [4]}, "requests"),
                       ({"equal_world1": [True] * 4 + [False]}, "differ"),
                       ({"ranks_agree": False}, "ranks"),
                       ({"per_chip_expected": 500}, "per-chip"),
                       ({"stats": {"per_chip_param_nbytes": 600,
                                   "replica_param_nbytes": 1000,
                                   "recompiles": 1}}, "recompiles")):
        bad = chip_smoke.serve_mp_problems(_serve_mp_result(**over))
        assert any(word in b for b in bad), (over, bad)


def test_kernel_cases_hold_the_new_paths_shapes():
    """bert_tp2_sp2's ring tile (B 16, 512 / sp tokens, 12 / tp heads of
    64, non-causal) and train_fsdp_dp2's attention (FSDP_BATCH sequences
    at the 1B widths, causal), both in the summary's cases."""
    from horovod_tpu_torch.models import bert, llama
    b = chip_smoke.bert_config(bert)
    B, T = chip_smoke.BERT_MP_BATCH
    sp, tp = chip_smoke.BERT_MP_MESH["sp"], chip_smoke.BERT_MP_MESH["tp"]
    cases = dict(chip_smoke.KERNEL_CASES)
    assert T == b.max_seq_len
    assert cases["lse_bert"] == (B, T // sp, b.n_heads // tp,
                                 b.n_heads // tp, b.head_dim, False)
    c = chip_smoke.bench_config(llama)
    assert cases["fsdp"] == (chip_smoke.FSDP_BATCH, c.max_seq_len,
                             c.n_heads, c.n_kv_heads, c.head_dim, True)
    assert {"lse_bert", "fsdp"} <= set(chip_smoke.MP_CASES)


_A6_REHEARSAL = '''
import dataclasses
import sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa
_bench = chip_smoke.bench_config
chip_smoke.bench_config = lambda llama, **over: dataclasses.replace(
    _bench(llama, **over), vocab_size=512, d_model=128, n_heads=2,
    n_kv_heads=1, d_ff=256, max_seq_len=128)
_bert = chip_smoke.bert_config
chip_smoke.bert_config = lambda bert, **over: dataclasses.replace(
    _bert(bert, **over), vocab_size=256, d_model=128, n_heads=2, d_ff=256,
    n_layers=2, max_seq_len=128)
chip_smoke.BERT_MP_BATCH = (2, 128)
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
# the plain versions' calls stand for the kernels' launches
for kernel, name in (("fwd", "_flash_fwd_bhtd"), ("dq", "_dq"),
                     ("dkv", "_dkv")):
    def counted(*a, _f=getattr(fa, name), _k=kernel, **k):
        fa.LAUNCHES[_k] += 1
        return _f(*a, **k)
    setattr(fa, name, counted)
child = {{"--pp-rank": chip_smoke.pp_child,
          "--bert-mp-rank": chip_smoke.bert_mp_child,
          "--fsdp-rank": chip_smoke.fsdp_child,
          "--serve-mp-rank": chip_smoke.serve_mp_child}}[sys.argv[1]]
sys.exit(child(int(sys.argv[2]), torch.device("cpu")))
'''


def _rehearsal_ref_losses():
    """train's losses at the rehearsal's widths: one process, the same
    config, seed and batch, 1 + 3 steps."""
    import dataclasses
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.optim.precision import adamw_lp
    cfg = dataclasses.replace(
        chip_smoke.bench_config(llama), vocab_size=512, d_model=128,
        n_heads=2, n_kv_heads=1, d_ff=256, max_seq_len=128)
    ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                        device="cpu")
    params, opt = ts.init_fn(0)
    rng = np.random.RandomState(0)
    toks, tgts = (torch.as_tensor(rng.randint(0, 512, (8, 128)))
                  for _ in range(2))
    out = []
    for _ in range(4):
        params, opt, loss = ts.step_fn(params, opt, toks, tgts)
        out.append(loss.item())
    return out


def test_chip_smoke_a6_phases_on_the_cpu(tmp_path, capsys, monkeypatch):
    """train_pp2 (two stages against one process), bert_tp2_sp2 (four
    ranks, then one process), train_fsdp_dp2 (two ranks without and with
    overlap, then one process) and serve_mp2 (two ranks, then one
    process's decode), whole, at small widths on the CPU, through every
    gate of the phases."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # four ranks on few cores
    wrapper = tmp_path / "ranks.py"
    wrapper.write_text(_A6_REHEARSAL.format(
        root=str(pathlib.Path(__file__).resolve().parents[1])))
    pp = chip_smoke.train_pp2_phase(_rehearsal_ref_losses(), script=wrapper)
    monkeypatch.setattr(chip_smoke, "BERT_MP_BATCH", (2, 128))
    bert = chip_smoke.bert_tp2_sp2_phase(script=wrapper)
    fsdp = chip_smoke.train_fsdp_dp2_phase(script=wrapper)
    serve = chip_smoke.serve_mp2_phase(script=wrapper)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["phase"] for x in lines] == ["train_pp2", "bert_tp2_sp2",
                                           "train_fsdp_dp2", "serve_mp2"]
    assert pp["layers_per_stage"] == 8
    assert all(b["pp.ppermute"] > 0 and b["pp.all_reduce"] > 0
               for b in pp["host_bytes_per_step_by_rank"])
    assert bert["launches_by_rank"] == [
        chip_smoke.bert_mp_launches(2, 2, True)] * 4
    run = fsdp["variants"]["plain"]
    assert all(b["dp.all_gather"] > 0 and b["dp.psum_scatter"] > 0
               for b in run["bytes_per_step_by_rank"])
    assert serve["requests"] == 8 and all(serve["equal_world1"])
    # both ranks recorded their first call: broadcasts, then the gathers
    assert chip_smoke.SCHEDULE["serve_mp2"]["not_mp_gathers"] == [
        "pbroadcast@hvd_serve_mp"]
    assert chip_smoke.SCHEDULE["serve_mp2"]["records"] == 3 + 2 + 9 * 2


# ---------------------------------------------------------------------------
# the spec plan's and the tracer's phases
# ---------------------------------------------------------------------------

_SPEC_REHEARSAL = '''
import dataclasses
import sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa
_bench = chip_smoke.bench_config
chip_smoke.bench_config = lambda llama, **over: dataclasses.replace(
    _bench(llama, **over), vocab_size=512, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, max_seq_len=128)
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
# the plain versions' calls stand for the kernels' launches
for kernel, name in (("fwd", "_flash_fwd_bhtd"), ("dq", "_dq"),
                     ("dkv", "_dkv")):
    def counted(*a, _f=getattr(fa, name), _k=kernel, **k):
        fa.LAUNCHES[_k] += 1
        return _f(*a, **k)
    setattr(fa, name, counted)
child = {{"--spec-rank": chip_smoke.spec_child,
          "--hier-rank": chip_smoke.hier_child}}[sys.argv[1]]
sys.exit(child(int(sys.argv[2]), torch.device("cpu")))
'''


def _rehearsal(tmp_path):
    wrapper = tmp_path / "ranks.py"
    wrapper.write_text(_SPEC_REHEARSAL.format(
        root=str(pathlib.Path(__file__).resolve().parents[1])))
    return wrapper


def test_chip_smoke_spec_phase_on_the_cpu(tmp_path, capsys, monkeypatch):
    """train_tp2_dp2_spec whole at small widths on the CPU (four ranks of
    dp 2 x tp 2, then one process), through every gate of the phase: the
    reduced gradients and the updates against one process, the global
    losses, the inner state's and the transform's bytes exactly the
    plan's, the launches of each timed step."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # four ranks on few cores
    res = chip_smoke.train_tp2_dp2_spec_phase(script=_rehearsal(tmp_path))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["phase"] for x in lines] == ["train_tp2_dp2_spec"]
    assert res["local_batch"] == [chip_smoke.SPEC_BATCH, 128]
    plain, ctx = res["runs"]["explicit"], res["runs"]["context"]
    assert not plain["sharded_update"] and ctx["sharded_update"]
    # ZeRO's tiles hold about half of the shards' state, 1/dp
    assert ctx["state_bytes_by_rank"][0] < plain["state_bytes_by_rank"][0]
    # tp is no batch axis (model_axes=()): every bucket crosses dp only
    for run, dp_key in ((plain, "dp.all_reduce"),
                        (ctx, "dp.psum_scatter")):
        assert set(run["transform_bytes_by_rank"][0]) == {dp_key}


def _spec_res(**edit):
    leaf = {"norms": [1.0, 1.001], "cos": 0.9999}
    run = {"losses_by_rank": [[6.6, 5.9, 5.2, 4.6]] * 2
           + [[6.7, 6.0, 5.3, 4.7]] * 2,
           "global_losses": [6.65, 5.95, 5.25, 4.65],
           "grad_parity_by_rank": [{"embed": dict(leaf)}] * 4,
           "update_parity": {"embed": dict(leaf)},
           "state_bytes_by_rank": [100] * 4,
           "state_bytes_expected": [100] * 4,
           "transform_bytes_by_rank": [{"dp.all_reduce": 8}] * 4,
           "transform_bytes_expected": [{"dp.all_reduce": 8}] * 4,
           "launches_per_step_by_rank": [
               [chip_smoke.EXPECTED_SPEC_LAUNCHES] * 3] * 4}
    run.update(edit)
    return {"coords": [{"dp": r // 2, "tp": r % 2} for r in range(4)],
            "losses_world1": [6.65, 5.95, 5.25, 4.65],
            "runs": {"explicit": run}}


def test_spec_gates_pass_and_fail():
    assert chip_smoke.spec_problems(_spec_res()) == []
    for edit, word in (
            ({"losses_by_rank": [[6.6, 5.9, 5.2, 4.6], [6.6, 5.9, 5.2, 4.5]]
              + [[6.7, 6.0, 5.3, 4.7]] * 2}, "tp ranks"),
            ({"global_losses": [6.65, 5.95, 5.25, 4.8]}, "gaps"),
            # a x2 slip in a reduced gradient
            ({"grad_parity_by_rank": [{"embed": {"norms": [2.0, 1.0],
                                                 "cos": 1.0}}] * 4},
             "reduced gradient"),
            ({"update_parity": {"embed": {"norms": [1.0, 1.0],
                                          "cos": 0.9}}}, "update"),
            ({"state_bytes_by_rank": [104] * 4}, "inner state"),
            ({"transform_bytes_by_rank": [{"tp.all_reduce": 8,
                                           "dp.all_reduce": 8}] * 4},
             "bytes a step"),
            ({"launches_per_step_by_rank": [[{"fwd": 4, "dq": 2,
                                              "dkv": 2}] * 3] * 4},
             "launches")):
        bad = chip_smoke.spec_problems(_spec_res(**edit))
        assert any(word in b for b in bad), (word, bad)


def test_kernel_cases_hold_the_spec_paths_shape():
    """train_tp2_dp2_spec's attention: SPEC_BATCH sequences a dp rank at
    the 1B widths, the heads cut over tp, causal; in the summary's
    cases."""
    from horovod_tpu_torch.models import llama
    c = chip_smoke.bench_config(llama)
    tp = chip_smoke.SPEC_MESH["tp"]
    assert dict(chip_smoke.KERNEL_CASES)["spec"] == (
        chip_smoke.SPEC_BATCH, c.max_seq_len, c.n_heads // tp,
        c.n_kv_heads // tp, c.head_dim, True)
    assert "spec" in chip_smoke.MP_CASES


def test_chip_smoke_hier_trace_on_the_cpu(tmp_path, monkeypatch):
    """train_hier_dp4's four ranks at small widths on the CPU as two hosts
    of two: the traced step's buffers pulled from every rank, merged into
    one trace with a pid a host, every dcn span excluding host 1, and
    host 1, which starts the step late, the top gating host.  (The
    rehearsal counts no cross-entropy launch, so only the trace's gates
    and the variants' weights are held here.)"""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res, _ = chip_smoke._run_pair("--hier-rank", chip_smoke.HIER_TIMEOUT_S,
                                  world=4, local_size=2,
                                  script=_rehearsal(tmp_path))
    chip_smoke.hier_trace(res)
    assert chip_smoke.hier_trace_problems(res) == []
    assert len(res[chip_smoke.HIER_TRACED]["steps"]) == 3
    assert "trace" not in res[chip_smoke.HIER_TRACED]["steps"][1]
    traced = res[chip_smoke.HIER_TRACED]["steps"][2]["trace"]
    assert traced["hosts"] == ["host0", "host1"]
    assert traced["top"][0] == "host1" and traced["rounds"] >= 1
    assert all(st["identical"] for name, _ in chip_smoke.HIER_VARIANTS
               for st in res[name]["steps"])


def _trace_row(**on):
    step = {"cycle": 1, "submit": 1, "negotiate": 0, "fuse": 1,
            "dispatch": 66, "dcn": 0, "overlap": 0}
    engine = {"cycles": 1, "executes": 1, "buckets": 66}
    off = {"active": False, "losses": [10.9, 9.9], "dropped": 0,
           "spans": [{k: 0 for k in step}] * 2, "engine": [engine] * 2}
    run = {"active": True, "losses": [10.9, 9.9], "dropped": 0,
           "spans": [dict(step)] * 2, "engine": [dict(engine)] * 2,
           "profile": {"dispatch_ranges": 66, "buckets": 66,
                       "flash_kernels": {k: 2 for k in
                                         chip_smoke.FLASH_KERNEL_NAMES}}}
    run.update(on)
    return {"off": off, "on": run}


def test_trace_gates_pass_and_fail():
    ref = [10.9, 9.9]
    assert chip_smoke.trace_problems(_trace_row(), ref) == []
    bad_step = {"cycle": 1, "submit": 1, "negotiate": 0, "fuse": 1,
                "dispatch": 65, "dcn": 0, "overlap": 0}
    for edit, word in (
            ({"losses": [10.9, 9.90001]}, "losses"),
            ({"spans": [bad_step] * 2}, "spans"),
            ({"dropped": 3}, "dropped"),
            ({"profile": {"dispatch_ranges": 0, "buckets": 66,
                          "flash_kernels": {"flash_fwd_kernel": 1}}},
             "dispatch ranges"),
            ({"profile": {"dispatch_ranges": 66, "buckets": 66,
                          "flash_kernels": {"flash_fwd_kernel": 0}}},
             "flash kernels")):
        bad = chip_smoke.trace_problems(_trace_row(**edit), ref)
        assert any(word in b for b in bad), (word, bad)
    row = _trace_row()
    row["off"]["spans"] = row["on"]["spans"]
    assert any("HOROVOD_TRACE=0" in b
               for b in chip_smoke.trace_problems(row, ref))


# -- the schedule recorder's gates ------------------------------------------------

@pytest.fixture(scope="module")
def engine_schedule():
    """train_dp's recording on the CPU: a world of one, 24 gradient-like
    tensors through the engine's fused buckets (as ``training.sum_scaled_``
    submits them), the recorder armed; the row and the step's plane."""
    import os
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import recorder
    # a 64-byte fusion threshold: several buckets, as at the 1B
    old = os.environ.get("HOROVOD_FUSION_THRESHOLD")
    os.environ["HOROVOD_FUSION_THRESHOLD"] = "64"
    try:
        hvd.init(device="cpu")
    finally:
        if old is None:
            os.environ.pop("HOROVOD_FUSION_THRESHOLD")
        else:
            os.environ["HOROVOD_FUSION_THRESHOLD"] = old
    try:
        engine = hvd.runtime._state().engine
        grads = [torch.full((3 + i,), float(i)) for i in range(24)]
        before = engine.stats()
        with recorder.recording() as rec:
            for h in hvd.api._allreduce_each_async_(
                    grads, [f"g.{i}" for i in range(24)], op=hvd.Sum):
                h.synchronize()
        after = engine.stats()
    finally:
        hvd.shutdown()
    plane = {k: after[k] - before[k] for k in ("buckets", "bytes")}
    return chip_smoke.schedule_row(rec), plane


def test_train_dp_schedule_gates_pass_and_fail(engine_schedule):
    row, plane = engine_schedule
    assert 1 < row["records"] == plane["buckets"] < 24
    assert row["bytes"] == sum(4 * (3 + i) for i in range(24))
    assert chip_smoke.dp_schedule_problems(row, plane) == []
    summary = chip_smoke.schedule_summary(row)
    assert summary["prims"] == {"psum@workers": row["records"]}
    assert summary["host_ms"] >= 0
    recs = row["list"]
    cases = {
        "records for": dict(row, records=row["records"] - 1,
                            list=recs[:-1]),
        "other than a psum": dict(row, list=[dict(recs[0], prim="pmax")]
                                  + recs[1:]),
        "bucket ids": dict(row, list=[dict(r, bucket=r["bucket"] + 1)
                                      for r in recs]),
        "input bytes": dict(row, bytes=row["bytes"] + 4),
    }
    for what, bad_row in cases.items():
        bad = chip_smoke.dp_schedule_problems(bad_row, plane)
        assert any(what in b for b in bad), (what, bad)


def test_train_dp2_schedule_gates_pass_and_fail(engine_schedule):
    row, _ = engine_schedule
    recs = row["list"]
    assert chip_smoke.dp2_schedule_problems([recs, recs], row) == []
    # a 2-layer step has fewer buckets than the 16-layer one: still fine
    assert chip_smoke.dp2_schedule_problems([recs[:2], recs[:2]], row) == []
    other = [dict(recs[0], inputs=["float32[1]"])] + recs[1:]
    assert any("rank 1" in b for b in
               chip_smoke.dp2_schedule_problems([recs, other], row))
    gather = [dict(r, prim="all_gather") for r in recs]
    assert any("prims and axes" in b for b in
               chip_smoke.dp2_schedule_problems([gather, gather], row))
    assert any("no records" in b for b in
               chip_smoke.dp2_schedule_problems([[], []], row))


def test_serve_mp2_schedule_gates_on_a_recorded_world():
    """MeshSlicedForward's first call, recorded on two gloo ranks: the
    leader's broadcasts and the weights' gathers over the mp group."""
    from horovod_tpu_torch.analysis import schedule
    got = schedule.record_worlds(["serve_mp_forward_step"], sizes=(1,))
    ranks = [[{k: v for k, v in r.as_dict().items()
               if k not in ("index", "path")} for r in s.records]
             for s in got[("serve_mp_forward_step", 1)]]
    bad, others = chip_smoke.serve_mp_schedule_problems(ranks)
    assert bad == [] and others == [("pbroadcast", ("hvd_serve_mp",))]
    assert chip_smoke.schedule_summary({
        "records": 0, "bytes": 0, "host_ms": 0.0, "list": []})[
        "prims"] == {}
    moved = [dict(r, axes=["workers"]) if r["prim"] == "all_gather" else r
             for r in ranks[0]]
    bad, _ = chip_smoke.serve_mp_schedule_problems([moved, moved])
    assert any("all_gathers over" in b for b in bad)
    bad, _ = chip_smoke.serve_mp_schedule_problems([ranks[0],
                                                    ranks[0][:-1]])
    assert any("rank 1" in b for b in bad)


# --- native_core and estimator -----------------------------------------------

def test_chip_smoke_native_core_phase_on_the_cpu(capsys):
    """``native_core`` rehearsed on the CPU: a tiny Llama's step through
    the engine and its overlapped step record the lists they plan (as
    ``train_dp`` and ``train_overlap`` do on the card); every gate holds,
    and each fails on a wrong plan or a Python object."""
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.optim import overlap as ov
    from horovod_tpu_torch.optim.precision import adamw_lp
    cfg = dataclasses.replace(llama.tiny(), n_layers=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    hvd.init(device="cpu")
    try:
        engine = hvd.runtime._state().engine
        with chip_smoke.record_plans(engine, "_plan_fn") as dp_plans:
            ts = training.make_llama_train_step(
                cfg, optimizer=adamw_lp(3e-4), device="cpu")
            params, opt = ts.init_fn(0)
            ts.step_fn(params, opt, toks, toks)
        objects = chip_smoke.native_objects(hvd)
        with chip_smoke.record_plans(ov, "plan_fusion") as overlap_plans:
            ts = training.make_llama_train_step(
                cfg, optimizer=adamw_lp(3e-4), overlap=True, device="cpu")
            params, opt = ts.init_fn(0)
            ts.step_fn(params, opt, toks, toks)
    finally:
        hvd.shutdown()
    assert engine._plan_fn.__module__ == chip_smoke.NATIVE_MODULE
    assert dp_plans and overlap_plans
    assert any(s.layer >= 0 for s in overlap_plans[0][0])
    build_row = chip_smoke.build_native_core()
    row = chip_smoke.native_core_phase(build_row, dp_plans, overlap_plans,
                                       objects)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "native_core"
    assert row["artifact"].endswith(
        "_hvd_core" + __import__("sysconfig").get_config_var("EXT_SUFFIX"))
    assert row["decide_equal_by_world"] == {
        w: chip_smoke.NATIVE_DECIDE_SEEDS for w in chip_smoke.NATIVE_WORLDS}
    assert row["planner_host_us"]["plan_fusion_sigs_us"] > 0
    assert row["planner_host_us"]["buckets"] == max(
        len(b) for _, _, b in dp_plans)
    sigs, threshold, buckets = dp_plans[0]
    wrong = [(sigs, threshold, buckets[::-1] + [[]])]
    with pytest.raises(chip_smoke.SmokeFailure, match="differs"):
        chip_smoke.native_core_phase(build_row, wrong, overlap_plans,
                                     objects)
    python = dict(objects, planner="horovod_tpu_torch.ops.fusion")
    assert chip_smoke.native_object_problems("x", [objects, python]) == [
        f"x: rank 1's planner is horovod_tpu_torch.ops.fusion, not "
        f"{chip_smoke.NATIVE_MODULE}"]


def test_estimator_reference_is_the_fit_on_the_cpu(monkeypatch, capsys):
    """``estimator`` rehearsed on the CPU (256 images): the workers' fit
    and the in-process reference agree bit for bit, and every gate holds;
    the gates fail a history or a leaf that differs."""
    monkeypatch.setattr(chip_smoke, "ESTIMATOR_IMAGES", 256)
    monkeypatch.setattr(chip_smoke, "ESTIMATOR_PREDICT_ROWS", 32)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        row = chip_smoke.estimator_phase(device="cpu")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "estimator"
    assert row["history"] == row["reference_history"]
    assert row["differing_leaves"] == [] and row["reload_equal"]
    assert row["checkpoint_devices"] == ["cpu"]
    assert chip_smoke.estimator_problems(row) == []
    flat = dict(row, history=[row["history"][0]] * 2)
    assert any("did not fall" in b
               for b in chip_smoke.estimator_problems(flat))
    assert chip_smoke.estimator_problems(
        dict(row, differing_leaves=["fc1_w"]))
    assert chip_smoke.estimator_problems(
        dict(row, checkpoint_devices=["cuda"]))
