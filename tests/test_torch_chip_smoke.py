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
    restore, steps 4-6 bit for bit, the sampler)."""
    wrapper = tmp_path / "worker.py"
    wrapper.write_text(_REHEARSAL.format(
        root=str(pathlib.Path(__file__).resolve().parents[1])))
    chip_smoke.elastic_resnet_phase(worker_script=wrapper)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "elastic_resnet"
    assert [size for _, size in row["formed"]] == [2, 2, 1, 2]
    assert row["steps_reexecuted"] == 1 and row["recover_s"] > 0
    assert len(row["step_ms_size1"]) == 2
