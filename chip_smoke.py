#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and exits non-zero.

  device   the card's name, count and power limit (no card: exit 1)
  build    nvcc builds every csrc/*.cu in parallel; the -Xptxas -v lines
  kernels  each flash-attention kernel at the training shapes (plus a
           non-causal case, an H == Hkv case and a ragged T = 960, a
           multiple of 64 but not of 128) against its plain PyTorch
           version on the same inputs, with its time, the plain version's,
           the least time the card could take, one
           scaled_dot_product_attention call as the forward's yardstick,
           and one call of PyTorch's flash-attention backward operator
           (dq, dk and dv at once) beside dq and dkv as the pair's
           (library_pair_ms); then each fused cross-entropy kernel at the
           loss head's shapes (N 8192, V 32768, D 2048) likewise, with no
           library call
  oneshot  context for the cross-entropy kernels: the port's one-shot loss,
           forward and forward + backward, on the same inputs (each of 10
           calls), and the fused loss's peak extra allocation
  train    make_llama_train_step at the 1B geometry of bench.py (16 layers,
           batch 8, seq 1024, adamw_lp): 1 warm-up step and 3 timed steps,
           with the kernel launches counted over the timed steps
  profile  one more step under torch.profiler: the device's idle share and
           the kernels that took the most device time
  train_fused, profile_fused   the same with fused_xent=True
  parity   2 layers at the same widths: one step and the gradients after
           it with the kernels on the card against the plain versions on
           the CPU, from the same weights
  parity_fused   the same with fused_xent=True

Then three lines: the kernels summary (each kernel's contract numbers,
its TF/s, and for dq and dkv the flash backward operator's time as
library_pair_ms, since it gives both at once), the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.  The script
imports no jax and nothing of horovod_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA's data sheet, dense, at a 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# cycles the card spins for each call time_ms queues behind the spin:
# about 1 ms at the H100's 1.98 GHz
SPIN_CYCLES_PER_CALL = 2_000_000

# (B, T, H, Hkv, D, causal): the training shapes first
KERNEL_CASES = [
    ("main", (8, 1024, 16, 8, 128, True)),
    ("noncausal", (8, 1024, 16, 8, 128, False)),
    ("mha", (8, 1024, 16, 16, 128, True)),
    ("ragged", (8, 960, 16, 8, 128, True)),
]
# out is bf16 (|out| <= ~2 with N(0,1) inputs): a few bf16 steps; lse is
# fp32 from the kernels' fast exp/log and another summation order; the
# gradients are bf16 sums over T = 1024 products in which the kernels round
# P and dS to bf16 (the dkv plain version keeps them fp32), so they are
# held relative to the largest entry of the plain result
OUT_ATOL = 2e-2
LSE_ATOL = 1e-3
GRAD_REL = 2e-2
# per-step launches at 16 layers with the last 2 not rematerialized: the
# forward runs once per layer and again in the backward of the 14
# checkpointed ones
EXPECTED_LAUNCHES = {"fwd": 30, "dq": 16, "dkv": 16}
# parity, bf16 on both sides rounding at different places: loss within
# 5e-3 relative, gradient norms within 2e-2, gradient directions cos > 0.99
PARITY_LOSS_REL = 5e-3
PARITY_NORM_REL = 2e-2
PARITY_COS = 0.99

SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "fwd": "horovod_tpu/ops/flash_attention.py:116",
    "dq": "horovod_tpu/ops/flash_attention.py:188",
    "dkv": "horovod_tpu/ops/flash_attention.py:223",
}

# the loss head of the 1B step: N = batch 8 x seq 1024 tokens, V, D
XENT_SHAPE = (8192, 32768, 2048)
# lse and tgt are fp32 sums of D = 2048 bf16 products in another order
# (and fast exp/log in the kernels): |lse| ~ 11, so 1e-3 is ~1e-4
# relative.  dh = (P - onehot)·W and dW = (P - onehot)ᵀ·h are fp32 sums
# in which both sides round P - onehot to bf16.  Their largest entries
# come from the onehot term (W[y] rows, sums of h rows), which needs no
# softmax at all, so the error is held against the largest entry of the
# softmax term alone (P·W, Pᵀ·h; see softmax_rel): a kernel that drops P
# errs by that whole term (ratio ~1), one that scales P by 1 + e by e
# times it, so any scaling off by more than 2% fails
XENT_ATOL = 1e-3
XENT_GRAD_REL = 2e-2
# per step: the loss head runs once forward and once backward
EXPECTED_XENT_LAUNCHES = {"xent_fwd": 1, "xent_dh": 1, "xent_dw": 1}
XENT_SOURCE = "horovod_tpu_torch/csrc/fused_xent.cu"
XENT_REPLACES = {
    "xent_fwd": "horovod_tpu/ops/fused_xent.py:138",
    "xent_dh": "horovod_tpu/ops/fused_xent.py:199",
    "xent_dw": "horovod_tpu/ops/fused_xent.py:220",
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, from CUDA events around
    ``iters`` calls after ``warmup`` calls.  The card first spins for about
    a millisecond per call while the host queues the calls, so the events
    time the card running them back to back: the host's cores are shared,
    and a stall there would otherwise leave the card idle inside the timed
    window and be counted as the kernel's time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(iters * SPIN_CYCLES_PER_CALL)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def each_ms(fn, iters: int, warmup: int):
    """Milliseconds of each of ``iters`` calls of ``fn()`` on the card,
    from CUDA events around each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def err(a, b) -> float:
    """Largest absolute difference, in fp32."""
    return (a.float() - b.float()).abs().max().item()


def rel(a, b) -> float:
    """:func:`err` over the largest entry of the plain result ``b``."""
    return err(a, b) / b.float().abs().max().item()


def softmax_terms(fx, h, w, lse):
    """The plain ``(P·W, Pᵀ·h)`` with ``P = exp(S − lse)`` rounded to the
    compute dtype: dh and dW without their onehot term."""
    p = torch.exp(fx._scores(h, w) - lse[:, None]).to(h.dtype).float()
    return p @ w.to(h.dtype).float(), p.T @ h.float()


def softmax_rel(a, b, soft) -> float:
    """:func:`err` of a gradient ``a`` against its plain result ``b``, over
    the largest entry of ``soft``, the softmax term of ``b``."""
    return err(a, b) / soft.float().abs().max().item()


def attention_work(B, T, H, Hkv, D, causal):
    """(score entries the mask keeps, element counts) for one call."""
    kept = T * (T + 1) // 2 if causal else T * T
    return B * H * kept, {"q": B * H * T * D, "kv": B * Hkv * T * D,
                          "row": B * H * T}


def bound(kernel: str, shape):
    """Least milliseconds for the work of one call: the larger of its
    operations at the bf16 peak and its bytes (inputs read once, outputs
    written once) at the memory rate."""
    pairs, n = attention_work(*shape)
    D = shape[4]
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kernel]  # matrix products
    flops = 2 * products * pairs * D
    nbytes = {
        "fwd": 2 * (2 * n["q"] + 2 * n["kv"]) + 4 * n["row"],
        "dq": 2 * (3 * n["q"] + 2 * n["kv"]) + 8 * n["row"],
        "dkv": 2 * (2 * n["q"] + 4 * n["kv"]) + 8 * n["row"],
    }[kernel]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def kernels_phase(fa, dev):
    F = torch.nn.functional
    results = {}
    for case, shape in KERNEL_CASES:
        B, T, H, Hkv, D, causal = shape
        scale = D ** -0.5
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def randn(*s, dtype=torch.bfloat16):
            return torch.randn(*s, generator=gen, device=dev, dtype=dtype)

        q, k, v, do = (randn(B, H, T, D), randn(B, Hkv, T, D),
                       randn(B, Hkv, T, D), randn(B, H, T, D))
        out, lse = fa._flash_fwd_bhtd(q, k, v, causal, scale)
        ref_out, ref_lse = fa._fwd_reference(q, k, v, causal, scale)
        torch.cuda.synchronize()
        delta = (do.float() * ref_out.float()).sum(-1)
        args = (q, k, v, do, ref_lse, delta, causal, scale)
        dq = fa._dq(*args)
        dk, dv = fa._dkv(*args)
        ref_dq = fa._dq_reference(*args)
        ref_dk, ref_dv = fa._dkv_reference(*args)
        torch.cuda.synchronize()
        checks = {
            "fwd": (max(err(out, ref_out), err(lse, ref_lse)),
                    err(out, ref_out) <= OUT_ATOL
                    and err(lse, ref_lse) <= LSE_ATOL,
                    {"out_err": err(out, ref_out),
                     "lse_err": err(lse, ref_lse)}),
            "dq": (err(dq, ref_dq), rel(dq, ref_dq) <= GRAD_REL,
                   {"dq_rel": rel(dq, ref_dq)}),
            "dkv": (max(err(dk, ref_dk), err(dv, ref_dv)),
                    max(rel(dk, ref_dk), rel(dv, ref_dv)) <= GRAD_REL,
                    {"dk_rel": rel(dk, ref_dk), "dv_rel": rel(dv, ref_dv)}),
        }
        del out, lse, dq, dk, dv, ref_dq, ref_dk, ref_dv
        runs = {
            "fwd": (lambda: fa._flash_fwd_bhtd(q, k, v, causal, scale),
                    lambda: fa._fwd_reference(q, k, v, causal, scale)),
            "dq": (lambda: fa._dq(*args), lambda: fa._dq_reference(*args)),
            "dkv": (lambda: fa._dkv(*args), lambda: fa._dkv_reference(*args)),
        }
        # yardsticks: kv heads repeated outside the timed calls; one SDPA
        # call for the forward, and for dq and dkv together one call of
        # PyTorch's flash-attention backward operator, which gives dq, dk
        # and dv at once (no single call gives dq alone or dk/dv alone)
        kr, vr = k, v
        if Hkv != H:
            kr = k.repeat_interleave(H // Hkv, dim=1)
            vr = v.repeat_interleave(H // Hkv, dim=1)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=causal, scale=scale), iters=20)
        aten = torch.ops.aten
        fo = aten._scaled_dot_product_flash_attention(
            q, kr, vr, 0.0, causal, False, scale=scale)
        flash_bwd_op_ms = time_ms(
            lambda: aten._scaled_dot_product_flash_attention_backward(
                do, q, kr, vr, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5], 0.0,
                causal, fo[6], fo[7], scale=scale), iters=20)
        del kr, vr, fo
        for kernel, (max_abs_err, ok, detail) in checks.items():
            ms = time_ms(runs[kernel][0], iters=20)
            plain_ms = time_ms(runs[kernel][1], iters=3, warmup=1)
            library_ms = sdpa_ms if kernel == "fwd" else None
            library_pair_ms = None if kernel == "fwd" else flash_bwd_op_ms
            bound_ms, bound_by, flops, nbytes = bound(kernel, shape)
            row = {"case": case, "kernel": kernel, "shape": list(shape),
                   "max_abs_err": max_abs_err, **detail, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_pair_ms": library_pair_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                   "tflops": flops / ms / 1e9}
            emit("kernels", **row)
            require(ok, f"{kernel} kernel disagrees with its plain version "
                        f"on {case}: {detail}")
            results[(case, kernel)] = row
        del q, k, v, do, ref_out, ref_lse, delta, args, runs
        torch.cuda.empty_cache()
    return results


def xent_bound(kernel: str, N: int, V: int, D: int):
    """Least milliseconds for one call of a cross-entropy kernel: its
    products at the bf16 peak against its bytes at the memory rate (h
    bf16, the fp32 embedding and int32 targets read once; lse and tgt, or
    the fp32 gradient and the lse it reads, once)."""
    products = 1 if kernel == "xent_fwd" else 2
    flops = 2 * products * N * V * D
    nbytes = 2 * N * D + 4 * V * D + 4 * N + {
        "xent_fwd": 8 * N,
        "xent_dh": 4 * N + 4 * N * D,
        "xent_dw": 4 * N + 4 * V * D,
    }[kernel]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def xent_kernels_phase(fx, llama, dev):
    """Each cross-entropy kernel against its plain version at the loss
    head's shapes; then the ``oneshot`` context line."""
    N, V, D = XENT_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # unit-variance logits, as the random tied embedding gives the model
    h = torch.randn(N, D, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(V, D, generator=gen, device=dev).mul_(D ** -0.5)
    y = torch.randint(0, V, (N,), generator=gen, device=dev,
                      dtype=torch.int32)
    lse, tgt = fx._xent_fwd(h, w, y)
    ref_lse, ref_tgt = fx._fwd_reference(h, w, y)
    dh = fx._dh(h, w, y, ref_lse)
    ref_dh = fx._dh_reference(h, w, y, ref_lse)
    dw = fx._dw(h, w, y, ref_lse)
    ref_dw = fx._dw_reference(h, w, y, ref_lse)
    soft_dh, soft_dw = softmax_terms(fx, h, w, ref_lse)
    torch.cuda.synchronize()
    fwd_err = max(err(lse, ref_lse), err(tgt, ref_tgt))
    dh_rel = softmax_rel(dh, ref_dh, soft_dh)
    dw_rel = softmax_rel(dw, ref_dw, soft_dw)
    checks = {
        "xent_fwd": (fwd_err, fwd_err <= XENT_ATOL,
                     {"lse_err": err(lse, ref_lse),
                      "tgt_err": err(tgt, ref_tgt)}),
        "xent_dh": (err(dh, ref_dh), dh_rel <= XENT_GRAD_REL,
                    {"dh_rel_softmax": dh_rel,
                     "softmax_max": soft_dh.abs().max().item(),
                     "plain_max": ref_dh.abs().max().item()}),
        "xent_dw": (err(dw, ref_dw), dw_rel <= XENT_GRAD_REL,
                    {"dw_rel_softmax": dw_rel,
                     "softmax_max": soft_dw.abs().max().item(),
                     "plain_max": ref_dw.abs().max().item()}),
    }
    del lse, tgt, ref_tgt, dh, ref_dh, dw, ref_dw, soft_dh, soft_dw
    torch.cuda.empty_cache()
    runs = {
        "xent_fwd": (lambda: fx._xent_fwd(h, w, y),
                     lambda: fx._fwd_reference(h, w, y)),
        "xent_dh": (lambda: fx._dh(h, w, y, ref_lse),
                    lambda: fx._dh_reference(h, w, y, ref_lse)),
        "xent_dw": (lambda: fx._dw(h, w, y, ref_lse),
                    lambda: fx._dw_reference(h, w, y, ref_lse)),
    }
    results = {}
    for kernel, (max_abs_err, ok, detail) in checks.items():
        ms = time_ms(runs[kernel][0], iters=5, warmup=1)
        plain_ms = time_ms(runs[kernel][1], iters=3, warmup=1)
        bound_ms, bound_by, flops, nbytes = xent_bound(kernel, N, V, D)
        row = {"case": "main", "kernel": kernel, "shape": [N, V, D],
               "max_abs_err": max_abs_err, **detail, "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               "library_pair_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "tflops": flops / ms / 1e9}
        emit("kernels", **row)
        require(ok, f"{kernel} kernel disagrees with its plain version: "
                    f"{detail}")
        results[kernel] = row
    del runs
    torch.cuda.empty_cache()

    # context, not a library time: the port's one-shot loss (full logits)
    # on the same inputs, each timed call after 3 that warm the allocator
    h3, y2 = h.view(8, N // 8, D), y.view(8, N // 8)

    def forward_backward(loss_fn):
        hl = h3.detach().requires_grad_()
        wl = w.detach().requires_grad_()
        loss_fn(hl, wl, y2).backward()

    fwd_each = each_ms(lambda: llama._oneshot_xent(h3, w, y2), 10, 3)
    fwd_bwd_each = each_ms(lambda: forward_backward(llama._oneshot_xent),
                           10, 3)
    oneshot = {"oneshot_ms": sum(fwd_each) / len(fwd_each),
               "oneshot_fwd_bwd_ms": sum(fwd_bwd_each) / len(fwd_bwd_each),
               "oneshot_each_ms": fwd_each,
               "oneshot_fwd_bwd_each_ms": fwd_bwd_each}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    forward_backward(fx.fused_xent_mean)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    logits_bytes = N * V * 4
    emit("oneshot", shape=[N, V, D], **oneshot,
         fused_peak_extra_bytes=extra, fp32_logits_bytes=logits_bytes)
    require(extra < logits_bytes,
            f"fused_xent_mean allocated {extra} bytes at its peak, not less "
            f"than the {logits_bytes} bytes of the fp32 logits")
    del h, w, y, h3, y2, ref_lse
    torch.cuda.empty_cache()
    return results


def bench_config(llama, **over):
    """bench.py's default 1B training configuration (bench.py:417-427)."""
    return dataclasses.replace(llama.LlamaConfig(
        vocab_size=32768, d_model=2048, n_layers=16, n_heads=16,
        n_kv_heads=8, d_ff=8192, max_seq_len=1024, remat=True,
        remat_policy="full", loss_chunk=2048, remat_skip_layers=2), **over)


def train_phase(fa, fx, llama, training, adamw_lp, dev, fused: bool):
    """The 1B step (``train``), or with ``fused_xent=True``
    (``train_fused``); returns the kernel launches of its timed steps."""
    phase = "train_fused" if fused else "train"
    cfg = bench_config(llama, fused_xent=fused)
    batch, seq, steps = 8, 1024, 3
    expected = {**EXPECTED_LAUNCHES,
                **{n: c if fused else 0
                   for n, c in EXPECTED_XENT_LAUNCHES.items()}}

    def counts():
        return {**fa.LAUNCHES, **fx.LAUNCHES}

    ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                        device=dev)
    params, opt_state = ts.init_fn(0)
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)),
                           dtype=torch.long, device=dev)
    tgts = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)),
                           dtype=torch.long, device=dev)

    t0 = time.perf_counter()
    params, opt_state, loss = ts.step_fn(params, opt_state, toks, tgts)
    losses = [loss.item()]
    warmup_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()  # the path's run starts here
    fx.reset_launches()
    step_ms, per_step = [], []
    for _ in range(steps):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = ts.step_fn(params, opt_state, toks, tgts)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        after = counts()
        per_step.append({n: after[n] - before[n] for n in before})
    launches = counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    mean_ms = sum(step_ms) / len(step_ms)
    emit(phase, params=llama.count_params(cfg), batch=batch, seq=seq,
         fused_xent=fused, losses=losses, warmup_ms=warmup_ms,
         step_ms=step_ms, tokens_per_sec=batch * seq / (mean_ms / 1e3),
         max_memory_allocated=peak, launches_per_step=per_step,
         launches=launches)
    emit(phase.replace("train", "profile"), **profile_step(
        lambda: ts.step_fn(params, opt_state, toks, tgts)))
    require(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # random tied embeddings give logits of unit variance: ln V + 1/2
    require(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
            f"first loss {losses[0]} is not near ln V = "
            f"{math.log(cfg.vocab_size):.3f}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for step in per_step:
        require(step == expected,
                f"{phase}: launches per step {step}, expected {expected}")
    del params, opt_state, ts
    torch.cuda.empty_cache()
    return launches


def profile_step(step, top: int = 12):
    """One step under torch.profiler: the device's busy share of the wall
    time and the kernels that took most device time, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
    # user annotations (the optimizer's step) span kernels listed apart
    ranges = [e for e in on_device if getattr(e, "is_user_annotation", False)]
    kernels = [e for e in on_device if e not in ranges]

    def device_ms(e):
        return (getattr(e, "self_device_time_total", None) or 0.0) / 1e3

    busy_ms = sum(device_ms(e) for e in kernels)
    kernels.sort(key=device_ms, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "annotated_ms": {e.key: device_ms(e) for e in ranges},
            "top_kernels": [{"name": e.key[:90], "ms": device_ms(e),
                             "calls": e.count} for e in kernels[:top]]}


def cosine(a, b) -> float:
    """Cosine of two gradients in fp64: over the 16.8M entries of a 1B
    weight an fp32 sum errs by ~1e-3, above 1 for equal vectors."""
    return torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0).item()


def parity_phase(llama, training, adamw_lp, convert, dev, fused: bool):
    """``parity``, or ``parity_fused`` with ``fused_xent=True``."""
    cfg = bench_config(llama, n_layers=2, fused_xent=fused)
    batch, seq = 2, 256
    cpu = torch.device("cpu")
    np_params = convert.llama_params_to_numpy(
        llama.init_params(cfg, seed=1, device=cpu))
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq))
    tgts = rng.randint(0, cfg.vocab_size, (batch, seq))
    out = []
    for where in (dev, cpu):
        ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                            device=where)
        params = convert.llama_params_from_numpy(np_params, device=where)
        opt_state = ts.opt_init(params)
        tk = torch.as_tensor(toks, dtype=torch.long, device=where)
        tg = torch.as_tensor(tgts, dtype=torch.long, device=where)
        t0 = time.perf_counter()
        params, opt_state, loss0 = ts.step_fn(params, opt_state, tk, tg)
        loss1, grads = ts.grads_fn(params, tk, tg)
        picked = {"embed": grads["embed"],
                  "wq0": grads["layers"][0]["wq"],
                  "wk0": grads["layers"][0]["wk"],
                  "wo1": grads["layers"][1]["wo"],
                  "w_down1": grads["layers"][1]["w_down"],
                  "final_norm": grads["final_norm"]}
        out.append((loss0.item(), loss1.item(),
                    {n: g.float().cpu() for n, g in picked.items()},
                    time.perf_counter() - t0))
        del ts, params, opt_state, grads, picked
    (g0, g1, gg, gs), (c0, c1, cg, cs) = out
    norms = {n: (gg[n].double().norm().item(), cg[n].double().norm().item())
             for n in gg}
    cos = {n: cosine(gg[n], cg[n]) for n in gg}
    emit("parity_fused" if fused else "parity", layers=cfg.n_layers,
         batch=batch, seq=seq,
         loss_step=[g0, c0], loss_after=[g1, c1], grad_norms=norms,
         grad_cos=cos, seconds={"cuda": gs, "cpu": cs})
    for a, b in ((g0, c0), (g1, c1)):
        require(abs(a - b) <= PARITY_LOSS_REL * abs(b),
                f"parity loss {a} (card) vs {b} (cpu)")
    for n, (a, b) in norms.items():
        require(abs(a - b) <= PARITY_NORM_REL * b,
                f"parity grad norm {n}: {a} (card) vs {b} (cpu)")
        require(cos[n] > PARITY_COS, f"parity grad cos {n}: {cos[n]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_xent as fx
    from horovod_tpu_torch.optim.precision import adamw_lp

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full fp32 matmuls in the plain versions and the fp32 loss head
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=name, count=count, nvidia_smi=smi,
         python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda)

    build_s = _build.build_all()
    emit("build", seconds=build_s, ptxas=_build.PTXAS_REPORT)

    kernels = kernels_phase(fa, dev)
    xent = xent_kernels_phase(fx, llama, dev)
    launches = train_phase(fa, fx, llama, training, adamw_lp, dev,
                           fused=False)
    launches_fused = train_phase(fa, fx, llama, training, adamw_lp, dev,
                                 fused=True)
    parity_phase(llama, training, adamw_lp, convert, dev, fused=False)
    parity_phase(llama, training, adamw_lp, convert, dev, fused=True)

    # (name, source, replaces, kernels-phase row, launches on its path)
    rows = [(f"flash_{k}", SOURCE, REPLACES[k], kernels[("main", k)],
             launches[k]) for k in ("fwd", "dq", "dkv")]
    rows += [(k, XENT_SOURCE, XENT_REPLACES[k], xent[k], launches_fused[k])
             for k in ("xent_fwd", "xent_dh", "xent_dw")]
    summary = []
    for label, source, replaces, row, n in rows:
        summary.append({
            "name": label, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_pair_ms": row["library_pair_ms"],
            "tflops": row["tflops"]})
        require(n > 0, f"{label} never ran on its path")
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
