"""The yardstick's arithmetic against values worked out by hand, and the
trace reduction on a capture built by hand."""

from __future__ import annotations

import pytest

from hvdbench import cells, roofline, trace
from hvdbench.families import bert, llama


def _cfg(name):
    return cells.load({"smollm2-1.7b": "smollm2-1.7b.pretrain-s2048",
                       "bert-base": "bert-base.finetune-s128"}[name]).config


def test_smollm2_operations_a_token():
    cfg = _cfg("smollm2-1.7b")
    # 24 layers of 4·2048² + 3·2048·8192 products, the tied head once
    matmul = 24 * (4 * 2048 ** 2 + 3 * 2048 * 8192) + 49152 * 2048
    assert matmul == 1_711_276_032
    per_token = llama.model_flops(cfg, {"batch": 1, "seq": 2048}) / 2048
    assert per_token == 6 * matmul + 6 * 24 * 2048 * 2048
    assert per_token == pytest.approx(10.87e9, rel=1e-3)
    long = llama.model_flops(cfg, {"batch": 1, "seq": 8192}) / 8192
    # attention: ~6% of the operations at T 2048, ~19% at T 8192
    assert (6 * 24 * 2048 * 2048) / per_token == pytest.approx(0.056, abs=1e-3)
    assert (6 * 24 * 8192 * 2048) / long == pytest.approx(0.19, abs=5e-3)
    step = llama.model_flops(cfg, {"batch": 8, "seq": 2048})
    assert step == pytest.approx(1.78e14, rel=1e-2)


def test_bert_operations_leave_the_tables_out():
    cfg = _cfg("bert-base")
    step = bert.model_flops(cfg, {"batch": 512, "seq": 128})
    encoder = 12 * (4 * 768 ** 2 + 2 * 768 * 3072)
    attn = 12 * 12 * 128 * 768
    head = 768 * 768 + 768 * 4
    assert step == (6 * encoder + attn) * 512 * 128 + 6 * head * 512
    # ~12% of the peak at ~228,000 tokens/s
    assert step / 65536 * 228_000 / roofline.PEAK_BF16_FLOPS == \
        pytest.approx(0.12, abs=5e-3)


def test_xent_least_time_of_a_smollm2_step():
    fwd = roofline.least_s(*roofline.xent_work(16384, 49152, 2048, False))
    bwd = roofline.least_s(*roofline.xent_work(16384, 49152, 2048, True))
    # four products of 3.3e12 operations at 989 TF/s: operations bound
    assert 2 * 16384 * 49152 * 2048 == pytest.approx(3.3e12, rel=1e-2)
    assert (fwd + bwd) * 1e3 == pytest.approx(13.3, abs=0.1)


def test_attention_work_as_flash_attention_2_counts_it():
    B, T, H, D = 8, 2048, 32, 64
    flops, nbytes = roofline.attention_work(B, T, H, H, D, True, False)
    pairs = B * H * T * (T + 1) // 2
    assert flops == 4 * pairs * D
    q = B * T * H * D
    assert nbytes == 2 * 4 * q + 4 * B * H * T
    bflops, bbytes = roofline.attention_work(B, T, H, H, D, True, True)
    assert bflops == 2.5 * flops
    assert bbytes == 2 * 5 * q + 4 * B * H * T + 2 * 3 * q
    # non-causal keeps every score
    assert roofline.attention_work(1, 128, 1, 1, 64, False, False)[0] == \
        4 * 128 * 128 * 64


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.union_ns(iv) == 25
    assert trace.gaps(iv, 0, 40) == [(15, 20), (30, 40)]


def test_reduce_attributes_kernels_to_layers():
    ms = 1_000_000
    cpu = [  # (name, thread, start, end, correlation id)
        (trace.STEP_RANGE, 1, 0, 100 * ms, 1),
        (trace.FLASH_RANGE, 1, 10 * ms, 20 * ms, 2),
        ("aten::mm", 1, 30 * ms, 31 * ms, 3),
        ("autograd::engine::evaluate_function: _FlashAttentionLseBackward",
         2, 40 * ms, 50 * ms, 4),
        ("Optimizer.step#AdamWLP.step", 1, 60 * ms, 90 * ms, 5),
        ("aten::add_", 1, 61 * ms, 62 * ms, 6),
        ("aten::item", 1, 91 * ms, 99 * ms, 7),
    ]
    gpu = [  # (name, start, end, linked correlation id)
        ("flash_fwd_kernel", 11 * ms, 15 * ms, 2),
        ("gemm", 31 * ms, 41 * ms, 3),
        ("flash_dkv_kernel", 41 * ms, 45 * ms, 4),
        ("adam_kernel", 62 * ms, 80 * ms, 6),
        ("ncclDevKernel_AllReduce", 70 * ms, 85 * ms, 0),
    ]
    red = trace.reduce(trace.Events(cpu, gpu))
    assert red["steps"] == 1
    assert red["window_s"] == pytest.approx(0.1)
    assert red["layer_s"]["flash"] == pytest.approx(0.008)
    assert red["layer_s"]["model"] == pytest.approx(0.010)
    assert red["layer_s"]["optimizer"] == pytest.approx(0.018)
    assert red["layer_s"]["nccl"] == pytest.approx(0.015)
    assert red["busy_s"] == pytest.approx(0.004 + 0.014 + 0.023)
    assert red["ranges"]["_FlashAttentionLseBackward"] == 1
    idle = dict(red["idle_gaps"])
    # the device waits 15 ms while the host reads the loss
    assert idle["aten::item"] == pytest.approx(0.015)


def test_roofline_readers_stay_under_the_peak():
    read = cells.metric_reader("flash_roofline")
    calls = [(8, 2048, 32, 32, 64, True)] * 48
    least = sum(roofline.least_s(*roofline.attention_work(*c, backward=b))
                for c in calls[:24] for b in (False, True))
    least += sum(roofline.least_s(*roofline.attention_work(*c, False))
                 for c in calls[24:])
    ctx = {"trace": {"busy_s": 1.0, "layer_s": {"flash": least * 2},
                     "ranges": {"_FlashAttentionLseBackward": 24}},
           "calls": {"flash": calls}}
    assert read(ctx) == pytest.approx(50.0)
    assert cells.metric_reader("xent_roofline")(
        {"trace": {"busy_s": 0.0, "layer_s": {"xent": 0.0}, "ranges": {}},
         "calls": {"xent": []}}) is None


_LAYER_S = {"flash": 0.1, "xent": 0.1, "optimizer": 0.1, "nccl": 0.0,
            "model": 0.1}


@pytest.mark.parametrize("metric,calls,ranges", [
    ("flash_roofline", [], {"_FlashAttentionLseBackward": 2}),
    ("flash_roofline", [(8, 2048, 32, 32, 64, True)], {}),
    ("xent_roofline", [], {"_FusedXentSumBackward": 1}),
    ("xent_roofline", [(16384, 49152, 2048)], {}),
    ("optimizer.device_ms", [], {}),
    ("nccl.device_ms", [], {"Optimizer.step": 1}),
])
def test_a_reader_with_a_device_but_nothing_recorded_raises(metric, calls,
                                                            ranges):
    ctx = {"trace": {"busy_s": 1.0, "steps": 3, "layer_s": _LAYER_S,
                     "ranges": ranges},
           "calls": {"flash": calls, "xent": calls}}
    with pytest.raises(LookupError):
        cells.metric_reader(metric)(ctx)


def test_reduce_raises_on_a_forward_range_without_its_backward_node():
    ms = 1_000_000
    cpu = [(trace.STEP_RANGE, 1, 0, 100 * ms, 1),
           (trace.XENT_RANGE, 1, 10 * ms, 20 * ms, 2),
           ("autograd::engine::evaluate_function: _RenamedXentBackward",
            2, 40 * ms, 50 * ms, 3)]
    gpu = [("xent_fwd_kernel", 11 * ms, 15 * ms, 2),
           ("xent_dw_kernel", 41 * ms, 45 * ms, 3)]
    with pytest.raises(LookupError):
        trace.reduce(trace.Events(cpu, gpu))
