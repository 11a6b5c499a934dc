#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and exits non-zero.

  device   the card's name, count and power limit (no card: exit 1)
  build    nvcc builds every csrc/*.cu in parallel; the -Xptxas -v lines,
           and the spill bytes of every kernel: the wgmma kernels (flash
           fwd, dq and dkv at head_dim 64 and 128, the xent forward, xent
           dh and dW at every d_model) must spill none, or the phase
           fails; and the clusters of each xent kernel the card runs at
           once, which must be at least one
  kernels  each flash-attention kernel at the training shapes (plus a
           non-causal case, an H == Hkv case, a ragged T = 960, a
           multiple of 64 but not of 128, and BERT-base's fine-tune shape,
           B 512, T 128, 12 heads of 64, non-causal) against its plain
           PyTorch version on the same inputs, with its time, the plain
           version's,
           the least time the card could take, one
           scaled_dot_product_attention call as the forward's yardstick,
           and one call of PyTorch's flash-attention backward operator
           (dq, dk and dv at once) beside dq and dkv as the pair's
           (library_pair_ms), and the card's SM and memory clocks and
           power draw before and after each case; then each fused
           cross-entropy kernel at the
           loss head's shapes (N 8192, V 32768, D 2048) likewise, with no
           library call, and at a ragged full-width shape (N 8128, V
           32640: half a 128-token tile, half a 256-row vocab tile); then
           each xent kernel at d_model 256, 512 and 1024 (dh and dW
           clusters of 1, 2 and 4 blocks) on the same tokens and vocabulary
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
  collectives    hvd.init() at world 1 over NCCL: every op of the API on
           fp32, bf16 and int64 CUDA tensors against its plain expectation,
           and 64 small tensors submitted in one call, which the engine
           must fuse into fewer buckets
  train_dp, profile_dp   the train step under hvd.init() at world 1: the
           gradients go through the engine's fused buckets and NCCL; the
           losses must equal train's bit for bit, with the same launches;
           buckets and bytes a step, the device ms of packing, NCCL and
           unpacking, peak memory; train_dp_vs_train puts its losses,
           step ms, device busy ms and peak beside train's
  train_overlap  the 1B step with overlap=True under hvd.init() at world 1:
           the grad taps reduce each layer's buckets on the plan's stream
           during the backward pass; losses equal to train's bit for bit,
           launches 30/16/16; the buckets a step and their layer keys in
           issue order, how many the device started before the backward's
           last kernel, the exposed plane (device ms from that kernel to
           the last bucket's end, and the host ms after the backward's
           return) beside train_dp's engine host ms, device busy time,
           idle share and peak
  train_wire     the same under HOROVOD_COMPRESSION=int8: the first loss
           equal to train's, the later ones within WIRE_LOSS_REL, the
           wire's quantization error within WIRE_ERROR_REL of the
           gradient, and the wire bytes a step against full width
  train_dp2      two processes (this script with --dp2-rank) share the card
           over gloo (HOROVOD_CONTROLLER=gloo): 2 layers at full width with
           fused_xent=True, batch 8 x 1024 split 4 + 4, rank 1 submitting
           its gradients in another order; both ranks' weights must be
           bit-identical after each step, and agree with one process on
           the whole batch within the parity gates
  train_a5_dp2   two such processes (--a5-rank) run 2 steps of three
           variants: zero1=True, overlap=True under HOROVOD_SHARDED_UPDATE=1
           and HOROVOD_COMPRESSION=int8, and grad_accum=2; weights
           bit-identical on both ranks after every step; zero1 and
           grad_accum within train_dp2's parity gates of one process on
           the whole batch, the quantized overlap within its own
           (A5_WIRE_*); zero1's optimizer state half the dp-1 run's
  decode   the KV-cache decode at the 1B geometry in bf16 (max_new 32):
           batched_greedy_decode and paged_greedy_decode at batch 1 and 8,
           seq 128, each with its prefill ms, decode ms a token, tokens/s,
           one profiled call (device busy ms, idle share, top kernels), the
           bytes a decode step must move and their time at 3.35 TB/s, the
           dense cache's bytes against the pool's, and peak memory; paged
           must equal dense bit for bit; a batch-4 bucket of rows 17, 64,
           100 and 128 long against each row decoded alone (logits within
           BATCH_LOGIT_TOL, argmax equal above that margin); card against
           CPU at 2 layers (CARD_CPU_LOGIT_TOL); none of the six kernels
           may launch
  serve    the serving plane on loopback with one ServingWorker thread on
           the card (paged_llama_decode_forward, warmed up first; buckets
           batch 1/2/4/8 x seq 128/512, KV block 16): 48 requests of 8-512
           tokens, every 6th opening with one 64-token head, in 3 bursts of
           16; completed/submitted, latency p50/p99, batches and fill,
           tokens/s, forward ms a batch, the KV ledger and peak memory;
           every request answered, each answer, teacher forced through its
           prompt decoded alone, that decode's greedy choice at every token
           (or within BATCH_LOGIT_TOL of it), no bucket prepared again,
           every batch's KV bytes exact, a head block reused

  train_bert   models/bert.py's make_dp_finetune_step at bert_base
           (num_labels 4), batch 512 x seq 128, remat on, AdamW(5e-5),
           under hvd.init() at world 1 over NCCL with reduce_grads=True: 1
           warm-up and 3 timed steps (sequences/s, MFU, peak memory), flash
           launches exactly 24/12/12 a step, losses falling; then a
           profiled step (profile_bert)
  train_resnet   ResNet-50 in bf16 at batch 256 x 224^2 through
           training.make_classifier_train_step(sync_bn=True) with SGD(0.01,
           momentum 0.9) at world 1: img/s, peak memory, a profiled step
           (profile_resnet); losses finite, none of the six kernels
  train_resnet_dp2   two processes (--resnet-dp2-rank) share the card over
           gloo: one step of ResNet-50 at 16 + 16 images of 224^2 with
           synchronized batch norm (its statistics summed across the ranks
           in the forward and backward passes), against one process on the
           32: ranks identical, loss, weight updates and running
           statistics within RESNET_DP2_* and the parity gates
  elastic_resnet   elastic Horovod: the port's ElasticDriver in this
           process, a discovery script over a hostfile the phase rewrites,
           workers (this script with --elastic-worker) sharing the card over
           gloo; ResNet-50 in bf16 at 224^2, 32 images a rank a step,
           SGD(0.01, momentum 0.9), synchronized batch norm, seeded images
           through ElasticSampler, a TensorState (weights, statistics,
           momentum, step, data epoch, sampler) committed every step.  Size
           2 for steps 1-3; worker 1 SIGKILLed in the backward pass of step
           4, the survivor restores commit 3, a replacement syncs, steps
           4-6; the hostfile shrinks to 1 (steps 7-8), then grows to 2
           (steps 9-10).  Against an uninterrupted 2-rank run of steps 1-6
           under the static launcher (python -m horovod_tpu_torch.runner):
           every transition formed at its size, digests equal across ranks
           after every sync, the restore exact, steps 4-6 bit for bit (cuDNN
           deterministic), the sampler's indices each taken once; recover_s,
           reform_s, sync_ms, step ms at sizes 1 and 2, peak memory, gloo
           bytes a step
  mnist    5 classifier steps of the MNIST convnet at batch 128 of seeded
           28 x 28 images (losses falling); then serving/models.py's
           classifier_forward on a bucket of MNIST rows and one of BERT
           rows, each answer the argmax of eval_fn / classify on the bucket
  parity_bert    2 layers of bert_base: logits, loss and gradients with
           the kernels on the card against the plain versions on the CPU,
           from the same weights
  parity_resnet  ResNet-50 at batch 4 x 64^2, card against CPU in fp32
           (logits, loss, gradients, running statistics) and in bf16
           (logits, loss, running statistics; the gradients printed)

Then three lines: the kernels summary (each kernel's contract numbers,
its TF/s, and for dq and dkv the flash backward operator's time as
library_pair_ms, since it gives both at once; the flash rows also carry
the bert case's numbers and train_bert's launches), the card's name and
power limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
The script imports no jax and nothing of horovod_tpu.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
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
    # BERT-base's fine-tune attention (bench.py:98-101): head_dim 64, two
    # 64-row key tiles a sequence, non-causal
    ("bert", (512, 128, 12, 12, 64, False)),
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

# per-step launches on train_dp2: 2 layers, neither rematerialized
# (remat_skip_layers=2), with the fused loss
EXPECTED_DP2_LAUNCHES = {"fwd": 2, "dq": 2, "dkv": 2,
                         "xent_fwd": 1, "xent_dh": 1, "xent_dw": 1}
# the two train_dp2 processes together, build of the kernels included
DP2_TIMEOUT_S = 420

# train_wire (int8, one fp32 scale per 256 elements): each element of a
# block quantizes to within amax/(2·127), so the scatter stage's error is
# at most sqrt(256)·amax/254 per block and, summed over blocks, at most
# 16/254 of the gradient's norm (amax² <= the block's sum of squares)
WIRE_ERROR_REL = 16 / 254
# the wire moves 1 + 4/256 bytes an element where fp32 moves 4 (both
# stages), plus block padding of at most 255 elements a bucket
WIRE_RATIO_MAX = (1 + 4 / 256) / 4 + 1e-3
# train_wire's losses after the first: Adam's early updates are about
# lr·sign(g), and the wire keeps every gradient's sign except where an
# element quantizes to zero (|g| < amax/254 of its block, ~1% of
# Gaussian-like entries, whose own contribution to the loss's descent is
# ~1e-4 of it) or moves by up to 1/254 of its block's absmax, ~1.7% of a
# typical entry: the loss's descent (about 1 a step) changes by well
# under 1%, so the losses stay within 1% of train's
WIRE_LOSS_REL = 1e-2
# train_a5_dp2's quantized-overlap variant against one process on the
# whole batch: the same arguments through two quantizations (scatter and
# gather) of 2 steps, with 3x margin over the ~1-2% of entries whose
# update they can zero: losses within 1%, weight updates' norms within
# 5% and their cosine above 0.97
A5_WIRE_LOSS_REL = 1e-2
A5_WIRE_NORM_REL = 5e-2
A5_WIRE_COS = 0.97
# train_a5_dp2's variants: (name, make_llama_train_step options, runtime
# environment); grad_accum=2 runs each layer's kernels twice a step
A5_VARIANTS = (
    ("zero1", {"zero1": True}, {}),
    ("overlap_sharded_int8", {"overlap": True},
     {"HOROVOD_SHARDED_UPDATE": "1", "HOROVOD_COMPRESSION": "int8"}),
    ("grad_accum", {"grad_accum": 2}, {}),
)
EXPECTED_A5_LAUNCHES = {
    "zero1": EXPECTED_DP2_LAUNCHES,
    "overlap_sharded_int8": EXPECTED_DP2_LAUNCHES,
    "grad_accum": {k: 2 * v for k, v in EXPECTED_DP2_LAUNCHES.items()},
}
# the three variants and the dp-1 run of both processes, build included
A5_TIMEOUT_S = 480

# the classifier models.  train_bert: bert_base(num_labels=4) at batch 512
# x seq 128 (bench.py:98-101), remat on, AdamW(5e-5); with remat each
# layer's attention runs forward twice (the recompute) and backward once,
# without it once each
BERT_BATCH, BERT_SEQ, BERT_LABELS = 512, 128, 4
EXPECTED_BERT_LAUNCHES = {"fwd": 24, "dq": 12, "dkv": 12,
                          "xent_fwd": 0, "xent_dh": 0, "xent_dw": 0}
# train_resnet: ResNet-50 in bf16 at batch 256 x 224^2, SGD(0.01,
# momentum 0.9) (bench.py:159-171)
RESNET_BATCH, RESNET_IMG = 256, 224
# train_resnet_dp2: two processes on 16 + 16 images against one process
# on the 32.  bf16 convolutions of 16 and of 32 images may take other
# cuDNN kernels, and the statistics add in another order, so the two
# runs agree as the parity gates say (loss within 5e-3, weight updates'
# norms within 2e-2 and cosines above 0.99), and the running statistics
# within 1e-2 of each leaf's largest entry (one step of momentum 0.9 from
# 0 and 1: 0.1 x a batch statistic of bf16 activations, ~3 decimal
# digits)
RESNET_DP2_BATCH = 16
RESNET_DP2_STATE_REL = 1e-2
RESNET_DP2_TIMEOUT_S = 300
# elastic_resnet: ResNet-50 in bf16 at 224^2, 32 images per rank a step,
# SGD(0.01, momentum 0.9), synchronized batch norm, under the port's
# elastic driver; the images are ELASTIC_DATASET seeded ones indexed
# through ElasticSampler (5 steps of an epoch at size 2).  Transitions:
# size 2 for steps 1-3; rank 1 SIGKILLed in the backward pass of step
# 4 (ELASTIC_KILL_STEP) and the job re-formed at size 2 for steps 4-6;
# a shrink to size 1 after step 6 for steps 7-8; a growth to size 2
# after step 8 for steps 9-10.  The workers wait before committing the
# steps of ELASTIC_PAUSE_STEPS until the phase has changed the hostfile
# and the driver has applied the epoch, so each resize lands at its step.
# An uninterrupted 2-rank run of steps 1-6 under the static launcher is
# the reference: steps 4-6 must equal it bit for bit (cuDNN
# deterministic, benchmark off in both runs)
ELASTIC_BATCH = 32
ELASTIC_DATASET = 320
ELASTIC_STEPS = 10
ELASTIC_REFERENCE_STEPS = 6
ELASTIC_KILL_STEP = 4
ELASTIC_PAUSE_STEPS = (6, 8)
ELASTIC_DIGEST_STEPS = (3, 6)
# the epoch_formed sizes of the four transitions, in order
ELASTIC_FORMED_SIZES = [2, 2, 1, 2]
ELASTIC_TIMEOUT_S = 180
# mnist: batch 128 of seeded 28 x 28 images, 5 steps; classifier_forward
# buckets of 8 rows
MNIST_BATCH, MNIST_STEPS = 128, 5
SERVE_CLASSIFIER_ROWS = 8
# parity_bert: 2 layers of bert_base at batch 4 x seq 128; parity_resnet:
# ResNet-50 at batch 4 x 64^2 with each block's last batch-norm scale
# 0.25 (init zeroes it, which zeroes every residual branch's gradient; at
# 1 the residual stream's variance grows block by block to logits of
# norm ~100)
PARITY_BERT_LAYERS, PARITY_BERT_BATCH = 2, 4
PARITY_RESNET_BATCH, PARITY_RESNET_IMG = 4, 64
PARITY_RESNET_SCALE = 0.25

# the d_model values the xent kernels are built for
XENT_DIMS = (128, 256, 512, 1024, 2048)
# the wgmma kernels, by library, and the template values (head_dim,
# d_model) each is built for: their accumulators live in registers, and a
# spill would put them in local memory around every product
WGMMA_KERNELS = {
    "flash_attention": {"flash_fwd_kernel": (64, 128),
                        "flash_dq_kernel": (64, 128),
                        "flash_dkv_kernel": (64, 128)},
    "fused_xent": {"xent_fwd_kernel": None,  # not a template
                   "xent_dh_kernel": XENT_DIMS,
                   "xent_dw_kernel": XENT_DIMS},
}

SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "fwd": "horovod_tpu/ops/flash_attention.py:116",
    "dq": "horovod_tpu/ops/flash_attention.py:188",
    "dkv": "horovod_tpu/ops/flash_attention.py:223",
}

# the loss head of the 1B step: N = batch 8 x seq 1024 tokens, V, D
XENT_SHAPE = (8192, 32768, 2048)
# the same width with half a 128-token tile (dh's clusters, the forward's
# blocks) and half a 256-row vocab tile (the forward's) at the end
XENT_RAGGED = (8192 - 64, 32768 - 128, 2048)
# d_model values of the xent_*_depths lines, on the first columns of the
# main inputs
XENT_DEPTHS = (256, 512, 1024)
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

# serving at the 1B geometry, weights in bf16: the buckets, new tokens and
# KV block (HOROVOD_SERVE_KV_BLOCK's default) of the decode and serve phases
SERVE_BATCHES = (1, 2, 4, 8)
SERVE_SEQS = (128, 512)
SERVE_NEW = 32
SERVE_BLOCK = 16
# decode: batch 1 and 8 at seq 128, each call timed this many times
DECODE_BATCHES = (1, 8)
DECODE_SEQ = 128
DECODE_ITERS = 2
# the ragged rows of one batch-4, seq-128 bucket held against sequential
# decode
DECODE_RAGGED = (17, 64, 100, 128)
# Batched against sequential decode on the card.  cuBLAS may pick other
# kernels, with other summation orders, for one row and for B rows, so a
# row's bf16 logits may differ in their last bits, and the differences
# compound over 16 layers.  The logits of these random weights have unit
# spread (|max| ~5), and a wrong position, mask or row moves them by that
# much; bf16 rounding alone moves them by a few hundredths (decode_parity
# prints how far a bf16 run on the CPU lies from an fp32 run of the same
# weights).  So the logits, teacher forced on the sequential run's tokens,
# are held within 0.25 of each other, and the greedy tokens to the same
# argmax wherever the sequential run's top-1 over top-2 margin exceeds
# 0.25: below it a near tie may flip either way.
BATCH_LOGIT_TOL = 0.25
# card against CPU at 2 layers of full width: prefill and 8 decode steps,
# teacher forced, both in bf16 rounding at the same points in other
# kernels: within 0.125, about twice the distance of the CPU's bf16 run
# from its fp32 run of the same weights, which the phase prints
# (cpu_bf16_vs_fp32); a wrong position or mask moves logits by ~1
CARD_CPU_LOGIT_TOL = 0.125
DECODE_PARITY_LAYERS = 2
DECODE_PARITY_STEPS = 8
# serve: requests with prompt lengths in [8, 512] from RandomState(0), in
# bursts; every SERVE_SHARED_EVERY-th request opens with one shared head
SERVE_REQUESTS = 48
SERVE_BURSTS = 3
SERVE_SHARED_EVERY = 6
SERVE_HEAD = 64
SERVE_TIMEOUT_S = 600


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


def parse_clocks(line: str):
    """One line of ``nvidia-smi --query-gpu=clocks.sm,clocks.mem,power.draw
    --format=csv,noheader,nounits``: SM and memory clocks in MHz and the
    power draw in W (None where it prints no number)."""
    def number(x):
        try:
            return float(x)
        except ValueError:
            return None
    sm, mem, power = (number(x.strip()) for x in line.split(","))
    return {"sm_mhz": sm, "mem_mhz": mem, "power_w": power}


def clock_sample():
    """The card's clocks and power draw now (:func:`parse_clocks`)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return parse_clocks(out.strip().splitlines()[0])


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


def wgmma_labels(kernels):
    """``{mangled-name tag: label}`` of a library's wgmma kernels: a
    template instance is ``name<value>`` (tag ``<len>nameILi<value>E``),
    a plain kernel (values None) its name (tag ``<len>nameE``)."""
    tags = {}
    for k, values in kernels.items():
        if values is None:
            tags[f"{len(k)}{k}E"] = k
        else:
            tags.update({f"{len(k)}{k}ILi{v}E": f"{k}<{v}>" for v in values})
    return tags


def spill_check(report):
    """Spill bytes of the kernels in a ``-Xptxas -v`` ``report`` (lines by
    library): ``(wgmma, others, problems)``.  ``wgmma`` maps each kernel
    of WGMMA_KERNELS, by its label (:func:`wgmma_labels`), to its (store,
    load) spill bytes; ``others`` maps every other function's mangled name
    to them; ``problems`` names each wgmma kernel that spills or is
    missing."""
    from horovod_tpu_torch.ops import _build
    wgmma, others, problems = {}, {}, []
    for lib, lines in report.items():
        spills = _build.spill_bytes(lines)
        tags = wgmma_labels(WGMMA_KERNELS.get(lib, {}))
        for fn, spill in spills.items():
            label = next((lab for tag, lab in tags.items() if tag in fn), None)
            if label is None:
                others[fn] = spill
            else:
                wgmma[label] = spill
    for lib, kernels in WGMMA_KERNELS.items():
        for label in wgmma_labels(kernels).values():
            spill = wgmma.get(label)
            if spill is None:
                problems.append(f"{label} is not in the ptxas report of {lib}")
            elif spill != (0, 0):
                problems.append(f"{label} spills {spill[0]} bytes of "
                                f"stores and {spill[1]} of loads")
    return wgmma, others, problems


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
        clocks_before = clock_sample()
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
        rows = {}
        for kernel, (max_abs_err, ok, detail) in checks.items():
            ms = time_ms(runs[kernel][0], iters=20)
            plain_ms = time_ms(runs[kernel][1], iters=3, warmup=1)
            library_ms = sdpa_ms if kernel == "fwd" else None
            library_pair_ms = None if kernel == "fwd" else flash_bwd_op_ms
            bound_ms, bound_by, flops, nbytes = bound(kernel, shape)
            rows[kernel] = {
                "case": case, "kernel": kernel, "shape": list(shape),
                "max_abs_err": max_abs_err, **detail, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library_pair_ms": library_pair_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                "tflops": flops / ms / 1e9}
        # the card's clocks and power around the case's timings
        clocks = {"before": clocks_before, "after": clock_sample()}
        for kernel, (_, ok, detail) in checks.items():
            row = {**rows[kernel], "clocks": clocks}
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


def xent_depth_row(kernel: str, N: int, V: int, d: int, ms: float):
    """One entry of an ``xent_*_depths`` line: ``kernel`` at d_model ``d``
    on N tokens and V vocabulary rows took ``ms``; its blocks per cluster
    (two for the forward, d / 256 for dh and dW, one below 512), its bound
    and its TF/s."""
    bound_ms, _, flops, _ = xent_bound(kernel, N, V, d)
    blocks = 2 if kernel == "xent_fwd" else max(1, d // 256)
    return {"blocks_per_cluster": blocks, "ms": ms, "bound_ms": bound_ms,
            "tflops": flops / ms / 1e9}


def xent_inputs(N, V, D, dev):
    """bf16 h, fp32 W and int32 targets from seed 0: unit-variance logits,
    as the random tied embedding gives the model."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    h = torch.randn(N, D, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(V, D, generator=gen, device=dev).mul_(D ** -0.5)
    y = torch.randint(0, V, (N,), generator=gen, device=dev,
                      dtype=torch.int32)
    return h, w, y


def xent_case(fx, case, shape, dev):
    """Each cross-entropy kernel against its plain version at ``shape``:
    emits a ``kernels`` line per kernel, returns them by kernel."""
    N, V, D = shape
    h, w, y = xent_inputs(N, V, D, dev)
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
    clocks_before = clock_sample()
    for kernel, (max_abs_err, ok, detail) in checks.items():
        ms = time_ms(runs[kernel][0], iters=5, warmup=1)
        plain_ms = time_ms(runs[kernel][1], iters=3, warmup=1)
        bound_ms, bound_by, flops, nbytes = xent_bound(kernel, N, V, D)
        results[kernel] = {
            "case": case, "kernel": kernel, "shape": [N, V, D],
            "max_abs_err": max_abs_err, **detail, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library_pair_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / ms / 1e9}
    clocks = {"before": clocks_before, "after": clock_sample()}
    for kernel, (_, ok, detail) in checks.items():
        row = results[kernel] = {**results[kernel], "clocks": clocks}
        emit("kernels", **row)
        require(ok, f"{kernel} kernel disagrees with its plain version on "
                    f"{case}: {detail}")
    del h, w, y, ref_lse, runs
    torch.cuda.empty_cache()
    return results


def xent_kernels_phase(fx, llama, dev):
    """Each cross-entropy kernel against its plain version at the loss
    head's shape and at the ragged one; each at the XENT_DEPTHS; then the
    ``oneshot`` context line."""
    results = xent_case(fx, "main", XENT_SHAPE, dev)
    xent_case(fx, "ragged", XENT_RAGGED, dev)

    # each kernel at the other d_model values it is built for, on the
    # first d columns of the main inputs: the dh and dW clusters have
    # d / 256 blocks (one below 512), so the time per streamed tile shows
    # what the exchange between a cluster's blocks costs
    N, V, D = XENT_SHAPE
    h, w, y = xent_inputs(N, V, D, dev)
    ref_lse = fx._fwd_reference(h, w, y)[0]
    depth_runs = {
        "xent_fwd": lambda hd, wd: fx._xent_fwd(hd, wd, y),
        "xent_dh": lambda hd, wd: fx._dh(hd, wd, y, ref_lse),
        "xent_dw": lambda hd, wd: fx._dw(hd, wd, y, ref_lse),
    }
    depths = {kernel: {} for kernel in depth_runs}
    for d in XENT_DEPTHS:
        hd, wd = h[:, :d].contiguous(), w[:, :d].contiguous()
        for kernel, run in depth_runs.items():
            ms = time_ms(lambda: run(hd, wd), iters=5, warmup=1)
            depths[kernel][d] = xent_depth_row(kernel, N, V, d, ms)
        del hd, wd
    for kernel, rows in depths.items():
        emit(f"{kernel}_depths", shape=[N, V], main_ms=results[kernel]["ms"],
             depths=rows)
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


def train_phase(fa, fx, llama, training, adamw_lp, dev, fused: bool,
                engine=None):
    """The 1B step (``train``), or with ``fused_xent=True``
    (``train_fused``), or under the runtime whose ``engine`` reduces the
    gradients (``train_dp``); returns the kernel launches of its timed
    steps and the line it emitted, with its profiled step's."""
    phase = "train_dp" if engine is not None else (
        "train_fused" if fused else "train")
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
    step_ms, per_step, plane = [], [], []
    for _ in range(steps):
        before = counts()
        stats0 = engine.stats() if engine is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = ts.step_fn(params, opt_state, toks, tgts)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        after = counts()
        per_step.append({n: after[n] - before[n] for n in before})
        if engine is not None:
            stats1 = engine.stats()
            plane.append({k: stats1[k] - stats0[k] for k in
                          ("tensors", "buckets", "bytes", "dispatch_ms")})
    launches = counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    mean_ms = sum(step_ms) / len(step_ms)
    extra = {}
    if engine is not None:
        # one more step with the engine's events around each phase of
        # every bucket: the gradient plane's device time, apart.  The card
        # first spins for about half a second, so the host has queued the
        # whole step, buckets included, before the card reaches them: the
        # events then time the card's work, not the engine thread's pace
        engine.time_device = True
        torch.cuda.synchronize()
        torch.cuda._sleep(500 * SPIN_CYCLES_PER_CALL)
        ts.step_fn(params, opt_state, toks, tgts)
        extra = {"gradient_plane": plane,
                 "plane_device_ms": engine.device_ms()}
        engine.time_device = False
    row = dict(params=llama.count_params(cfg), batch=batch, seq=seq,
               fused_xent=fused, losses=losses, warmup_ms=warmup_ms,
               step_ms=step_ms, tokens_per_sec=batch * seq / (mean_ms / 1e3),
               max_memory_allocated=peak, launches_per_step=per_step,
               launches=launches, **extra)
    emit(phase, **row)
    row["profile"] = profile_step(
        lambda: ts.step_fn(params, opt_state, toks, tgts))
    emit(phase.replace("train", "profile"), **row["profile"])
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
    return launches, row


def overlap_phase(fa, fx, llama, training, adamw_lp, dev, wire: bool):
    """The 1B step with ``overlap=True`` under the runtime (``train_overlap``,
    or ``train_wire`` when HOROVOD_COMPRESSION=int8 is set): 1 warm-up and
    3 timed steps with their launches, then one measured step (the
    dispatch's events and error norms) and one profiled step.  Returns the
    emitted line."""
    from horovod_tpu_torch.optim import overlap as ov
    phase = "train_wire" if wire else "train_overlap"
    cfg = bench_config(llama)
    batch, seq, steps = 8, 1024, 3

    def counts():
        return {**fa.LAUNCHES, **fx.LAUNCHES}

    ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                        overlap=True)
    plan = ov.plan_for(ts.transform)
    params, opt_state = ts.init_fn(0)
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)),
                           dtype=torch.long, device=dev)
    tgts = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)),
                           dtype=torch.long, device=dev)
    params, opt_state, loss = ts.step_fn(params, opt_state, toks, tgts)
    losses = [loss.item()]
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
    plan.time_device = True
    ts.step_fn(params, opt_state, toks, tgts)
    torch.cuda.synchronize()
    plane = plan.last.stats()
    plan.time_device = False
    wire_bytes, full_bytes = ov.plane_bytes(plan.layout, plan.fmt)
    row = dict(params=llama.count_params(cfg), batch=batch, seq=seq,
               wire_format=plan.fmt.name if plan.fmt else "none",
               losses=losses, step_ms=step_ms,
               tokens_per_sec=batch * seq / (sum(step_ms) / steps / 1e3),
               max_memory_allocated=peak, launches_per_step=per_step,
               launches=launches, plane=plane, wire_bytes=wire_bytes,
               full_width_bytes=full_bytes)
    emit(phase, **row)
    row["profile"] = profile_step(
        lambda: ts.step_fn(params, opt_state, toks, tgts))
    emit(phase.replace("train", "profile"), **row["profile"])
    del params, opt_state, ts
    torch.cuda.empty_cache()
    return row


def overlap_problems(row, train_row, expected):
    """``train_overlap``'s gates: ``train``'s losses bit for bit, the
    launches, every bucket issued."""
    bad = []
    if row["losses"] != train_row["losses"]:
        bad.append(f"losses {row['losses']} are not train's "
                   f"{train_row['losses']}")
    bad += [f"launches per step {st}, expected {expected}"
            for st in row["launches_per_step"] if st != expected]
    if row["plane"]["buckets"] != len(row["plane"]["bucket_layers"]) \
            or row["plane"]["buckets"] == 0:
        bad.append(f"no buckets issued: {row['plane']}")
    return bad


def wire_problems(row, train_row, expected):
    """``train_wire``'s gates (WIRE_* above)."""
    bad = []
    losses, ref = row["losses"], train_row["losses"]
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss {losses}")
    elif losses[-1] >= losses[0]:
        bad.append(f"loss did not fall: {losses}")
    if losses[0] != ref[0]:
        bad.append(f"first loss {losses[0]} is not train's {ref[0]}")
    for a, b in zip(losses[1:], ref[1:]):
        if not abs(a - b) <= WIRE_LOSS_REL * abs(b):
            bad.append(f"loss {a} vs train's {b}: beyond {WIRE_LOSS_REL}")
    err = row["plane"].get("quantization_error_rel")
    if err is None or not err <= WIRE_ERROR_REL:
        bad.append(f"quantization error {err} of the gradient's norm, "
                   f"bound {WIRE_ERROR_REL}")
    ratio = row["wire_bytes"] / row["full_width_bytes"]
    if not ratio <= WIRE_RATIO_MAX:
        bad.append(f"wire bytes {ratio:.4f} of full width, bound "
                   f"{WIRE_RATIO_MAX:.4f}")
    bad += [f"launches per step {st}, expected {expected}"
            for st in row["launches_per_step"] if st != expected]
    return bad


def profile_step(step, top: int = 12, cpu: bool = True):
    """One step under torch.profiler: the device's busy share of the wall
    time and the kernels that took most device time, by name.  ``cpu``
    False traces the device alone: a decode call's tens of thousands of
    host calls take the profiler tens of seconds to process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "nccl_ms": sum(device_ms(e) for e in nccl),
            "nccl_calls": sum(e.count for e in nccl),
            "annotated_ms": {e.key: device_ms(e) for e in ranges},
            "top_kernels": [{"name": e.key[:90], "ms": device_ms(e),
                             "calls": e.count} for e in kernels[:top]]}


def collectives_phase(hvd, dev):
    """Every op of the API on fp32, bf16 and int64 tensors on ``dev``, each
    against its plain expectation; returns the emitted line.  The inputs
    are multiples of 1/4 (integers for int64), so every result is exact at
    any world size the runtime has; at one rank each reduction is its
    input, scaled."""
    n, r = hvd.size(), hvd.rank()
    checks = {}
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        name = str(dt).removeprefix("torch.")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x = torch.randint(-16, 16, (64 * n, 96), generator=gen, device=dev)
        x = (x / 4).to(dt) if dt.is_floating_point else x
        # (op, prescale, postscale): a factor is cast to the tensor's dtype
        op, pre, post = ((hvd.Average, 0.5, 4.0) if dt.is_floating_point
                         else (hvd.Sum, 2.0, 3.0))
        red = x * n                       # every rank holds the same x
        scaled = (x * 2 if op == hvd.Average else x * 6 * n)
        h = hvd.allreduce_async(x, op=hvd.Sum, name=f"{name}.async")
        y = x.clone()
        z = torch.zeros_like(x)
        g0, g1 = hvd.grouped_allreduce([x, x[:8] * 2], op=hvd.Sum,
                                       name=f"{name}.grouped")
        pairs = {
            "sum": (hvd.allreduce(x, op=hvd.Sum, name=f"{name}.sum"), red),
            "average": (hvd.allreduce(x, name=f"{name}.avg"), x),
            "scaled": (hvd.allreduce(x, op=op, prescale_factor=pre,
                                     postscale_factor=post,
                                     name=f"{name}.scaled"), scaled),
            "min": (hvd.allreduce(x, op=hvd.Min, name=f"{name}.min"), x),
            "max": (hvd.allreduce(x, op=hvd.Max, name=f"{name}.max"), x),
            "grouped": (torch.cat([g0, g1]), torch.cat([red, x[:8] * 2 * n])),
            "async": (hvd.synchronize(h), red),
            "inplace": (hvd.allreduce_(y, op=hvd.Sum, name=f"{name}.ip"),
                        red),
            "allgather": (hvd.allgather(x, name=f"{name}.ag"),
                          torch.cat([x] * n)),
            "broadcast": (hvd.broadcast(x, 0, name=f"{name}.bc"), x),
            "broadcast_": (hvd.broadcast_(z.copy_(x), 0, name=f"{name}.bc_"),
                           x),
            "alltoall": (hvd.alltoall(x, splits=[64] * n,
                                      name=f"{name}.a2a"),
                         torch.cat([x[64 * r:64 * (r + 1)]] * n)),
            "reducescatter": (hvd.reducescatter(x, op=hvd.Sum,
                                                name=f"{name}.rs"),
                              red[64 * r:64 * (r + 1)]),
        }
        checks[name] = {k: bool(got.device == dev and torch.equal(got, want))
                        for k, (got, want) in pairs.items()}
        checks[name]["poll"] = hvd.poll(h)
        checks[name]["inplace_is_input"] = pairs["inplace"][0] is y
    objects = {"broadcast_object": hvd.broadcast_object({"a": [1, 2]})
               == {"a": [1, 2]},
               "allgather_object": hvd.allgather_object(7) == [7] * n}
    hvd.barrier()
    joined = hvd.join()
    # 64 small tensors in one call: the engine plans them into buckets
    engine = hvd.runtime._state().engine
    before = engine.stats()
    small = [torch.full((3,), float(i), device=dev) for i in range(64)]
    for hd in hvd.api._allreduce_each_async_(
            small, [f"small.{i}" for i in range(64)], op=hvd.Sum):
        hd.synchronize()
    after = engine.stats()
    small_ok = all(torch.equal(t, torch.full_like(t, i * n))
                   for i, t in enumerate(small))
    row = {"world": n, "backend": hvd.runtime._state().backend,
           "device": str(dev), "checks": checks, "objects": objects,
           "join": joined, "small_tensors": after["tensors"] -
           before["tensors"], "small_buckets": after["buckets"] -
           before["buckets"], "small_ok": small_ok,
           "engine": engine.stats()}
    emit("collectives", **row)
    bad = [f"{d}.{k}" for d, c in checks.items() for k, ok in c.items()
           if not ok] + [k for k, ok in objects.items() if not ok]
    require(not bad, f"collectives disagree with their expectation: {bad}")
    require(joined == n - 1, f"join returned {joined}")
    require(small_ok and row["small_tensors"] == 64
            and row["small_buckets"] < 64,
            f"64 small tensors: {row['small_buckets']} buckets, ok "
            f"{small_ok}")
    return row


def _reversed_keys(tree):
    if isinstance(tree, dict):
        return {k: _reversed_keys(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, list):
        return [_reversed_keys(v) for v in tree]
    return tree


def dp2_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_dp2`` (``--dp2-rank``): 2 steps at dp 2 on its
    half of the batch through the engine over gloo on ``cuda:0``; after
    each step rank 0's weights are broadcast and held against this rank's
    bit for bit.  Rank 1 builds its parameter dicts in reverse key order,
    so it submits its gradients in another order.  Then rank 0, without
    the runtime, runs the same 2 steps from the same weights on the whole
    batch at dp 1 and prints both runs' losses and weight updates as
    JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_xent as fx
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    cfg = bench_config(llama, n_layers=2, fused_xent=True)
    rng = np.random.RandomState(2)
    batch = [torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                         (8, cfg.max_seq_len)),
                             dtype=torch.long, device=dev) for _ in range(2)]

    def run(params, toks, tgts):
        ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                            device=dev)
        opt_state = ts.opt_init(params)
        for _ in range(2):
            params, opt_state, loss = ts.step_fn(params, opt_state, toks,
                                                 tgts)
            yield params, loss.item()

    def flat(params):
        return dict(zip(tree_paths(params), tree_leaves(params)))

    hvd.init(device=dev)
    params = llama.init_params(cfg, seed=2, device=dev)
    init = {p: t.detach().clone() for p, t in flat(params).items()}
    if rank == 1:
        params = _reversed_keys(params)
    order = tree_paths(params)
    toks, tgts = (b[4 * rank:4 * (rank + 1)] for b in batch)
    fa.reset_launches()
    fx.reset_launches()
    losses, per_step, identical = [], [], []
    before = {**fa.LAUNCHES, **fx.LAUNCHES}
    for step, (params, loss) in enumerate(run(params, toks, tgts)):
        after = {**fa.LAUNCHES, **fx.LAUNCHES}
        per_step.append({n: after[n] - before[n] for n in before})
        losses.append(loss)
        # rank 0's weights, leaf by leaf by path, against this rank's
        mine = flat(params)
        same = all([torch.equal(hvd.broadcast(mine[p].detach(), 0,
                                              name=f"check{step}.{p}"),
                                mine[p]) for p in sorted(mine)])
        identical.append(all(hvd.allgather_object(same)))
        before = {**fa.LAUNCHES, **fx.LAUNCHES}
    engine = hvd.runtime._state().engine.stats()
    orders = hvd.allgather_object(order[:3])
    hvd.shutdown()
    if rank:
        return 0
    dp2 = {p: t.detach() for p, t in flat(params).items()}
    del params
    losses1 = []
    for dp1_params, loss in run(llama.init_params(cfg, seed=2, device=dev),
                                *batch):
        losses1.append(loss)
    dp1 = flat(dp1_params)
    print(json.dumps({
        "losses": losses, "losses_dp1": losses1,
        "launches_per_step": per_step, "identical_after_step": identical,
        "first_leaves_submitted": orders,
        "engine": engine,
        "update_norms": {p: ((dp2[p] - init[p]).double().norm().item(),
                             (dp1[p] - init[p]).double().norm().item())
                         for p in init},
        "update_cos": {p: cosine(dp2[p] - init[p], dp1[p] - init[p])
                       for p in init}}), flush=True)
    return 0


def a5_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_a5_dp2`` (``--a5-rank``): for each of
    A5_VARIANTS, hvd.init() under the variant's environment, 2 steps on
    this rank's half of the batch from the same weights as train_dp2,
    rank 0's weights broadcast and held against this rank's after each
    step, then shutdown.  Then rank 0 runs the 2 steps at dp 1 on the
    whole batch without the runtime and prints every run as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_xent as fx
    from horovod_tpu_torch.optim.precision import adamw_lp, tree_nbytes
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    cfg = bench_config(llama, n_layers=2, fused_xent=True)
    rng = np.random.RandomState(2)
    batch = [torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                         (8, cfg.max_seq_len)),
                             dtype=torch.long, device=dev) for _ in range(2)]

    def flat(params):
        return dict(zip(tree_paths(params), tree_leaves(params)))

    def state_bytes(opt_state):
        opt = getattr(opt_state, "inner", opt_state)
        return tree_nbytes(list(opt.state.values()))

    init = flat(llama.init_params(cfg, seed=2, device=dev))
    runs = {}
    for name, kw, env in A5_VARIANTS:
        os.environ.update(env)
        hvd.init(device=dev)
        try:
            params = llama.init_params(cfg, seed=2, device=dev)
            if rank == 1:
                params = _reversed_keys(params)
            ts = training.make_llama_train_step(
                cfg, optimizer=adamw_lp(3e-4), device=dev, **kw)
            opt_state = ts.opt_init(params)
            toks, tgts = (b[4 * rank:4 * (rank + 1)] for b in batch)
            fa.reset_launches()
            fx.reset_launches()
            losses, per_step, identical = [], [], []
            for step in range(2):
                before = {**fa.LAUNCHES, **fx.LAUNCHES}
                params, opt_state, loss = ts.step_fn(params, opt_state,
                                                     toks, tgts)
                after = {**fa.LAUNCHES, **fx.LAUNCHES}
                per_step.append({n: after[n] - before[n] for n in before})
                losses.append(loss.item())
                mine = flat(params)
                same = all([torch.equal(hvd.broadcast(
                    mine[p].detach(), 0, name=f"{name}{step}.{p}"), mine[p])
                    for p in sorted(mine)])
                identical.append(all(hvd.allgather_object(same)))
            runs[name] = {"losses": losses, "launches_per_step": per_step,
                          "identical_after_step": identical,
                          "state_bytes": state_bytes(opt_state),
                          "final": {p: t.detach().clone()
                                    for p, t in flat(params).items()}}
            del params, opt_state, ts
        finally:
            hvd.shutdown()
            for k in env:
                os.environ.pop(k)
    if rank:
        return 0
    ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                        device=dev)
    params = llama.init_params(cfg, seed=2, device=dev)
    opt_state = ts.opt_init(params)
    losses1 = []
    for _ in range(2):
        params, opt_state, loss = ts.step_fn(params, opt_state, *batch)
        losses1.append(loss.item())
    dp1 = flat(params)
    out = {"dp1": {"losses": losses1, "state_bytes": state_bytes(opt_state)}}
    for name, run in runs.items():
        final = run.pop("final")
        run["update_norms"] = {p: ((final[p] - init[p]).double().norm()
                                   .item(), (dp1[p] - init[p]).double()
                                   .norm().item()) for p in init}
        run["update_cos"] = {p: cosine(final[p] - init[p], dp1[p] - init[p])
                             for p in init}
        out[name] = run
    print(json.dumps(out), flush=True)
    return 0


def a5_problems(res):
    """``train_a5_dp2``'s gates: weights identical on both ranks after
    every step; launches; zero1 and grad_accum within the parity gates of
    the dp-1 run, the quantized overlap within A5_WIRE_*; zero1's state
    half the dp-1 run's."""
    bad = []
    dp1 = res["dp1"]
    for name, _, _ in A5_VARIANTS:
        run = res[name]
        if not all(run["identical_after_step"]):
            bad.append(f"{name}: the ranks' weights differ after a step: "
                       f"{run['identical_after_step']}")
        bad += [f"{name}: launches per step {st}, expected "
                f"{EXPECTED_A5_LAUNCHES[name]}"
                for st in run["launches_per_step"]
                if st != EXPECTED_A5_LAUNCHES[name]]
        wire = name == "overlap_sharded_int8"
        loss_rel, norm_rel, min_cos = (
            (A5_WIRE_LOSS_REL, A5_WIRE_NORM_REL, A5_WIRE_COS) if wire
            else (PARITY_LOSS_REL, PARITY_NORM_REL, PARITY_COS))
        for a, b in zip(run["losses"], dp1["losses"]):
            if not abs(a - b) <= loss_rel * abs(b):
                bad.append(f"{name}: loss {a} (dp 2) vs {b} (dp 1)")
        for p, (a, b) in run["update_norms"].items():
            if not abs(a - b) <= norm_rel * b:
                bad.append(f"{name}: update norm {p}: {a} vs {b}")
            if not run["update_cos"][p] > min_cos:
                bad.append(f"{name}: update cos {p}: "
                           f"{run['update_cos'][p]}")
    half = res["zero1"]["state_bytes"] / dp1["state_bytes"]
    if not abs(half - 0.5) <= 0.01:
        bad.append(f"zero1: optimizer state {res['zero1']['state_bytes']} "
                   f"B per rank is {half:.4f} of the dp-1 run's "
                   f"{dp1['state_bytes']} B")
    return bad


def _run_pair(flag: str, timeout_s: float):
    """This script with ``flag R`` in two processes sharing the card over
    gloo; returns rank 0's last line as JSON and the seconds taken."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                   HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                   HOROVOD_CONTROLLER="gloo",
                   HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="300")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, flag, str(rank)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True))
    deadline = time.monotonic() + timeout_s
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    for rank, (p, (o, e)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"{flag} rank {rank} exited "
                f"{p.returncode}:\n{o[-2000:]}\n{e[-4000:]}")
    return (json.loads(outs[0][0].strip().splitlines()[-1]),
            time.perf_counter() - t0)


def train_a5_dp2_phase():
    """Two ranks of :func:`a5_child` on the card over gloo; the gates."""
    res, seconds = _run_pair("--a5-rank", A5_TIMEOUT_S)
    emit("train_a5_dp2", layers=2, batch=[4, 4], seq=1024, fused_xent=True,
         backend="gloo", seconds=seconds, **res)
    bad = a5_problems(res)
    require(not bad, f"train_a5_dp2: {bad}")


def train_dp2_phase():
    """Two ranks of :func:`dp2_child` on the card over gloo; the gates."""
    res, seconds = _run_pair("--dp2-rank", DP2_TIMEOUT_S)
    emit("train_dp2", layers=2, batch=[4, 4], seq=1024, fused_xent=True,
         backend="gloo", seconds=seconds, **res)
    require(all(res["identical_after_step"]),
            f"train_dp2: the ranks' weights differ after a step: "
            f"{res['identical_after_step']}")
    for step in res["launches_per_step"]:
        require(step == EXPECTED_DP2_LAUNCHES,
                f"train_dp2: launches per step {step}, expected "
                f"{EXPECTED_DP2_LAUNCHES}")
    for a, b in zip(res["losses"], res["losses_dp1"]):
        require(abs(a - b) <= PARITY_LOSS_REL * abs(b),
                f"train_dp2 loss {a} (dp 2) vs {b} (dp 1)")
    for p, (a, b) in res["update_norms"].items():
        require(abs(a - b) <= PARITY_NORM_REL * b,
                f"train_dp2 update norm {p}: {a} (dp 2) vs {b} (dp 1)")
        cos = res["update_cos"][p]
        require(cos > PARITY_COS, f"train_dp2 update cos {p}: {cos}")


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


def serve_params(llama, gen, cfg, dev, seed: int = 0):
    """``init_params`` from ``seed``, cast once to the compute dtype."""
    return gen.cast_params(llama.init_params(cfg, seed=seed, device=dev), cfg)


def teacher_forced_logits(gen, params, cfg, prompts, lengths, forced,
                          max_len: int):
    """The fp32 logits ``[B, n, V]`` that batched greedy decode chooses
    its ``n`` tokens from, with ``forced[:, :n-1]`` fed to its decode
    steps in place of the tokens it would choose: each row's last prompt
    position from the prefill, then one decode step a token."""
    B = prompts.shape[0]
    cache = gen.init_kv_cache(cfg, B, max_len, device=prompts.device)
    logits, cache = gen.forward_with_cache(params, prompts, cfg, cache)
    rows = torch.arange(B, device=prompts.device)
    out = [logits[rows, lengths - 1].float()]
    for i in range(forced.shape[1] - 1):
        logits, cache = gen.forward_with_cache(
            params, forced[:, i:i + 1], cfg, cache, row_starts=lengths + i)
        out.append(logits[:, -1].float())
    return torch.stack(out, dim=1)


def margin_check(got, ref, tol: float):
    """Trouble spot of batched decode: ``got``'s logits (teacher forced on
    the sequential run's tokens) within ``tol`` of the sequential run's
    ``ref``, and the same argmax wherever ``ref``'s top-1 over top-2
    margin exceeds ``tol``.  Returns ``(problems, stats)``."""
    diff = (got - ref).abs()
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > tol
    same = got.argmax(-1) == ref.argmax(-1)
    stats = {"bitwise": torch.equal(got, ref),
             "max_abs_logit_diff": diff.max().item(),
             "mean_abs_logit_diff": diff.mean().item(),
             "positions": margin.numel(), "decided": int(decided.sum()),
             "argmax_equal": int(same.sum()),
             "argmax_flips_decided": int((~same & decided).sum())}
    problems = []
    if stats["max_abs_logit_diff"] > tol:
        problems.append(f"logits differ by {stats['max_abs_logit_diff']} "
                        f"> {tol}")
    if stats["argmax_flips_decided"]:
        problems.append(f"{stats['argmax_flips_decided']} argmax flips at "
                        f"margins above {tol}")
    return problems, stats


def answer_gaps(gen, params, cfg, prompt, answer, max_len: int):
    """A served answer teacher forced through its prompt decoded alone
    (``greedy_generate``'s steps, fed the answer's tokens): at each token,
    how far its logit lies below that step's largest, 0 where the answer
    is the sequential greedy choice."""
    cache = gen.init_kv_cache(cfg, 1, max_len, device=prompt.device)
    logits, cache = gen.forward_with_cache(params, prompt[None], cfg, cache)
    forced = torch.as_tensor(answer, device=prompt.device)
    gaps = []
    for i in range(len(answer)):
        last = logits[0, -1].float()
        gaps.append(last.max() - last[forced[i]])
        if i < len(answer) - 1:
            logits, cache = gen.forward_with_cache(
                params, forced[None, i:i + 1], cfg, cache)
    return torch.stack(gaps).tolist()


def answer_problem(gaps, tol: float):
    """The rule of :func:`margin_check` for a served answer, whose batched
    logits are not at hand: every token the sequential run's greedy
    choice (``"exact"``), or within ``tol`` of it, a near tie that the
    batch's summation order may flip (``"near_tie"``).  Returns
    ``(problem or None, kind)``."""
    worst = max(gaps)
    if worst == 0:
        return None, "exact"
    if worst <= tol:
        return None, "near_tie"
    return (f"token {gaps.index(worst)} lies {worst:.4f} below the "
            f"sequential run's best logit, more than {tol}"), None


def expected_blocks(rows, new: int, bs: int):
    """``(blocks, distinct)`` a batch's rows hold in the paged pool: each
    row ``ceil((len + new) / bs)`` blocks, and the full prompt blocks of
    rows whose prompts agree up to that block's end are one block."""
    blocks, private, heads = 0, 0, set()
    for toks in rows:
        toks = [int(t) for t in toks]
        need = -(-(len(toks) + new) // bs)
        full = min(len(toks) // bs, need)
        blocks += need
        private += need - full
        heads.update(tuple(toks[:(j + 1) * bs]) for j in range(full))
    return blocks, private + len(heads)


def kv_ledger_problems(batches, new: int, bs: int, block_nbytes: int):
    """Every served batch's KV ledger against :func:`expected_blocks`:
    the blocks granted, the distinct blocks live, and their bytes, each
    exactly."""
    bad = []
    for i, b in enumerate(batches):
        blocks, distinct = expected_blocks(b["prompts"], new, bs)
        if (b["blocks"], b["in_use"], b["bytes_in_use"]) != (
                blocks, distinct, distinct * block_nbytes):
            bad.append(f"batch {i}: blocks {b['blocks']}, in use "
                       f"{b['in_use']}, {b['bytes_in_use']} B; expected "
                       f"{blocks}, {distinct}, {distinct * block_nbytes} B")
    return bad


def bucket_problems(after_warmup: dict, after: dict, n_buckets: int):
    """The no-recompile contract: warm-up prepares every bucket, and the
    traffic prepares none again."""
    bad = []
    if after_warmup["compiles"] != n_buckets:
        bad.append(f"warm-up prepared {after_warmup['compiles']} buckets, "
                   f"expected {n_buckets}")
    if after["recompiles"] or after["compiles"] != n_buckets:
        bad.append(f"after the traffic: {after['compiles']} prepared, "
                   f"{after['recompiles']} recompiles")
    return bad


class _Recorded:
    """A serving forward that keeps each batch's KV ledger for the
    gates; everything else is the forward's."""

    wants_rows = True

    def __init__(self, forward):
        self.forward = forward
        self.batches = []

    def __call__(self, tokens, lengths, n_rows=None):
        t0 = time.perf_counter()
        out = self.forward(tokens, lengths, n_rows=n_rows)
        ms = 1e3 * (time.perf_counter() - t0)
        self.batches.append({
            "bucket": list(tokens.shape), "ms": ms,
            "prompts": [tokens[i, :lengths[i]].tolist()
                        for i in range(n_rows)],
            **self.forward.stats()["kv"]["last"]})
        return out

    def __getattr__(self, name):
        return getattr(self.forward, name)


def serve_prompts(vocab: int, n: int = SERVE_REQUESTS,
                  lo: int = 8, hi: int = 512, head: int = SERVE_HEAD,
                  every: int = SERVE_SHARED_EVERY):
    """``n`` prompts of lengths in [lo, hi] and tokens in [0, vocab) from
    ``RandomState(0)``; every ``every``-th opens with one shared
    ``head``-token prefix (its length drawn above ``head``)."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, vocab, head)
    prompts = []
    for i in range(n):
        if i % every == 0:
            p = rng.randint(0, vocab, rng.randint(head + 1, hi + 1))
            p[:head] = shared
        else:
            p = rng.randint(0, vocab, rng.randint(lo, hi + 1))
        prompts.append(p.tolist())
    return prompts


def serve_run(paging, params, cfg, prompts, new: int, block: int,
              batches, seqs, bursts: int, timeout_s: float):
    """Serve ``prompts`` through a ``ServingPlane`` on loopback and one
    ``ServingWorker`` thread running ``paged_llama_decode_forward`` on the
    params' device, warmed up before its first pull.  The prompts go in
    ``bursts`` bursts over ``serve_submit``, each collected over
    ``serve_drain`` before the next.  Returns the phase's numbers, the
    answers by request, the forward and the recorded batches."""
    from horovod_tpu_torch.runner.rpc import JsonRpcServer, json_request
    from horovod_tpu_torch.serving.models import paged_llama_decode_forward
    from horovod_tpu_torch.serving.plane import ServingPlane
    from horovod_tpu_torch.serving.worker import ServingWorker
    plane = ServingPlane(max_batch=max(batches),
                         batch_buckets=",".join(map(str, batches)),
                         seq_buckets=",".join(map(str, seqs)),
                         deadline_ms=0, lease_s=timeout_s,
                         straggler_factor=0)
    srv = JsonRpcServer(plane.rpc_handlers(), port=0, host="127.0.0.1",
                        secret=None)
    worker = None
    try:
        fwd = paged_llama_decode_forward(params, cfg, new, plane.buckets,
                                         block_size=block)
        t0 = time.perf_counter()
        fwd.warmup()
        warmup_s = time.perf_counter() - t0
        after_warmup = fwd.stats()
        kv0 = fwd.kv_summary()
        rec = _Recorded(fwd)
        worker = ServingWorker("127.0.0.1", srv.port, rec, worker_id="0",
                               wait_s=1.0, secret=None)
        worker.start()
        results = {}
        deadline = time.monotonic() + timeout_s
        per = -(-len(prompts) // bursts)
        t0 = time.perf_counter()
        for start in range(0, len(prompts), per):
            ids = [f"r{i}" for i in range(start,
                                          min(start + per, len(prompts)))]
            json_request("127.0.0.1", srv.port, "serve_submit",
                         {"requests": [{"id": r, "tokens": prompts[int(
                             r[1:])]} for r in ids]}, secret=None)
            while (not all(r in results for r in ids)
                   and time.monotonic() < deadline):
                results.update(json_request(
                    "127.0.0.1", srv.port, "serve_drain", {"wait_s": 2.0},
                    secret=None, timeout=30.0)["results"])
        wall_s = time.perf_counter() - t0
        plane_stats = plane.stats()
    finally:
        plane.close()
        if worker is not None:
            worker.stop()
            worker.join(30)
        srv.close()
    done = {r: res for r, res in results.items()
            if res.get("done") and not res.get("expired")}
    lat = sorted(1e3 * res["latency_s"] for res in done.values())
    kv1 = fwd.kv_summary()
    fill = [b["rows"] / b["bucket"][0] for b in rec.batches]
    row = {"submitted": len(prompts), "completed": len(done),
           "warmup_s": warmup_s, "wall_s": wall_s,
           "latency_ms_p50": float(np.percentile(lat, 50)) if lat else None,
           "latency_ms_p99": float(np.percentile(lat, 99)) if lat else None,
           "batches": len(rec.batches),
           "mean_fill": float(np.mean(fill)) if fill else None,
           "generated_tokens_per_s": len(done) * new / wall_s,
           "forward_ms": [b["ms"] for b in rec.batches],
           "buckets_served": [b["bucket"] for b in rec.batches],
           "forward_stats": {k: v for k, v in fwd.stats().items()
                             if k != "kv"},
           "kv": kv1, "reuse_hits": kv1["reuse_hits"] - kv0["reuse_hits"],
           "plane_completed": plane_stats["completed"]}
    answers = {int(r[1:]): res["output"] for r, res in done.items()}
    return row, answers, fwd, rec.batches, after_warmup


def serve_problems(row, answers, refs, fwd, batches, after_warmup, cfg,
                   paging, new: int, block: int, n_buckets: int):
    """The serve phase's gates; returns ``(problems, kinds)``."""
    bad = []
    if row["completed"] != row["submitted"]:
        bad.append(f"{row['completed']} of {row['submitted']} completed")
    kinds = {"exact": 0, "near_tie": 0}
    for i, gaps in refs.items():
        problem, kind = answer_problem(gaps, BATCH_LOGIT_TOL)
        if problem:
            bad.append(f"request {i}: {problem}")
        else:
            kinds[kind] += 1
    bad += bucket_problems(after_warmup, fwd.stats(), n_buckets)
    blk = paging.kv_block_nbytes(cfg, block)
    if (fwd.allocator.block_nbytes != blk
            or fwd.pool_nbytes != fwd.allocator.n_blocks * blk):
        bad.append(f"pool of {fwd.pool_nbytes} B is not "
                   f"{fwd.allocator.n_blocks} blocks of {blk} B")
    bad += kv_ledger_problems(batches, new, block, blk)
    if row["reuse_hits"] <= 0:
        bad.append("no prompt-head block was reused")
    return bad, kinds


def decode_bound(cfg, count_params, lengths, new: int):
    """Bytes one decode step must move, averaged over the ``new - 1``
    steps: every bf16 weight once (the tied head reads the embedding
    whole) and the k and v of every position each row attends, read, plus
    the step's own k and v, written; and that over the card's memory
    rate, in ms."""
    per_pos = cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    weights = 2 * count_params(cfg)
    kv = [sum(int(n) + i + 1 for n in lengths) * per_pos
          + len(lengths) * per_pos for i in range(new - 1)]
    nbytes = weights + sum(kv) / len(kv)
    return {"weight_bytes": weights, "kv_bytes": sum(kv) / len(kv),
            "bound_ms": 1e3 * nbytes / PEAK_BYTES}


def decode_phase(llama, gen, paging, fa, fx, convert, dev):
    """``batched_greedy_decode`` and ``paged_greedy_decode`` at the 1B
    geometry, then the ragged bucket against sequential decode, then card
    against CPU at 2 layers; none of the six kernels may launch."""
    cfg = bench_config(llama)
    params = serve_params(llama, gen, cfg, dev)
    rng = np.random.RandomState(0)
    new, bs, seq = SERVE_NEW, SERVE_BLOCK, DECODE_SEQ
    max_len = seq + new
    M = paging.row_blocks(seq, new, bs)
    fa.reset_launches()  # the path's run starts here
    fx.reset_launches()
    out, seconds = {}, {}
    t0 = time.perf_counter()
    for B in DECODE_BATCHES:
        prompts = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, seq)),
                                  device=dev)
        lengths = torch.full((B,), seq, device=dev)
        torch.cuda.reset_peak_memory_stats()
        cache = gen.init_kv_cache(cfg, B, max_len, device=dev)
        pool = gen.init_paged_kv_cache(cfg, 1 + B * M, bs, device=dev)
        tables = 1 + torch.arange(B * M, device=dev).view(B, M)
        calls = {
            "dense": (lambda: gen.batched_greedy_decode(
                params, cfg, prompts, lengths, new, max_len=max_len,
                cache=cache),
                lambda: gen.forward_with_cache(
                    params, prompts, cfg, gen.KVCache(cache.k, cache.v, 0))),
            "paged": (lambda: gen.paged_greedy_decode(
                params, cfg, prompts, lengths, tables, pool, new)[0],
                lambda: gen.forward_with_cache(params, prompts, cfg, pool,
                                               block_tables=tables))}
        toks = {k: call() for k, (call, _) in calls.items()}
        row = {"paged_equals_dense": torch.equal(toks["dense"],
                                                 toks["paged"]),
               **decode_bound(cfg, llama.count_params, [seq] * B, new),
               "dense_cache_bytes": paging.dense_kv_nbytes(cfg, B, max_len),
               "paged_pool_bytes": int(pool.k.nbytes + pool.v.nbytes),
               "paged_row_bytes": B * M * paging.kv_block_nbytes(cfg, bs)}
        for kind, (call, prefill) in calls.items():
            pre = each_ms(prefill, DECODE_ITERS, warmup=1)
            total = each_ms(call, DECODE_ITERS, warmup=0)
            mean_pre, mean_total = np.mean(pre), np.mean(total)
            per_tok = (mean_total - mean_pre) / (new - 1)
            t1 = time.perf_counter()
            prof = profile_step(call, top=6, cpu=False)
            seconds[f"profile_{kind}{B}"] = time.perf_counter() - t1
            row[kind] = {"prefill_ms": pre, "call_ms": total,
                         "decode_ms_per_token": per_tok,
                         "generated_tokens_per_s": B * new / (
                             mean_total / 1e3),
                         "profile": prof}
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out[f"batch{B}"] = row
        seconds[f"batch{B}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        require(row["paged_equals_dense"],
                f"decode batch {B}: paged tokens differ from dense")
        del cache, pool
    # the ragged bucket: rows of four lengths against each alone
    lens = torch.tensor(DECODE_RAGGED, device=dev)
    prompts = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (len(DECODE_RAGGED), seq)),
        device=dev)
    batched = gen.batched_greedy_decode(params, cfg, prompts, lens, new,
                                        max_len=max_len)
    seq_toks = torch.cat([gen.greedy_generate(
        params, cfg, prompts[b:b + 1, :n], new, max_len=max_len)
        for b, n in enumerate(DECODE_RAGGED)])
    got = teacher_forced_logits(gen, params, cfg, prompts, lens, seq_toks,
                                max_len)
    ref = torch.cat([teacher_forced_logits(
        gen, params, cfg, prompts[b:b + 1, :n], lens[b:b + 1],
        seq_toks[b:b + 1], max_len) for b, n in enumerate(DECODE_RAGGED)])
    problems, stats = margin_check(got, ref, BATCH_LOGIT_TOL)
    out["ragged"] = {"lengths": list(DECODE_RAGGED),
                     "tokens_equal": int((batched == seq_toks).sum()),
                     "tokens": batched.numel(), **stats}
    launches = {**fa.LAUNCHES, **fx.LAUNCHES}  # ... and ends here
    seconds["ragged"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["card_vs_cpu"] = decode_parity(llama, gen, convert, dev)
    seconds["card_vs_cpu"] = time.perf_counter() - t0
    emit("decode", layers=cfg.n_layers, seq=seq, new=new, block=bs,
         launches=launches, seconds=seconds, **out)
    require(not problems, f"decode: batched vs sequential: {problems}")
    require(not any(launches.values()),
            f"decode launched kernels of the training path: {launches}")
    par = out["card_vs_cpu"]
    require(par["max_abs_logit_diff"] <= CARD_CPU_LOGIT_TOL,
            f"decode card vs cpu: logits differ by "
            f"{par['max_abs_logit_diff']} > {CARD_CPU_LOGIT_TOL}")
    return out


def decode_parity(llama, gen, convert, dev):
    """Teacher-forced logits of the prefill and DECODE_PARITY_STEPS decode
    steps at 2 layers of full width: the card's against the CPU's in bf16,
    and the CPU's bf16 against its fp32 run as the scale of bf16
    rounding."""
    cfg = bench_config(llama, n_layers=DECODE_PARITY_LAYERS)
    cpu = torch.device("cpu")
    np_params = convert.llama_params_to_numpy(
        llama.init_params(cfg, seed=1, device=cpu))
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, cfg.vocab_size, (2, DECODE_SEQ))
    lengths = [DECODE_SEQ, DECODE_SEQ - 28]
    n = DECODE_PARITY_STEPS + 1
    max_len = DECODE_SEQ + n
    logits, forced = {}, None
    for name, where, c in (("cpu", cpu, cfg), ("card", dev, cfg),
                           ("cpu_fp32", cpu, dataclasses.replace(
                               cfg, dtype=torch.float32))):
        params = gen.cast_params(
            convert.llama_params_from_numpy(np_params, device=where), c)
        pr = torch.as_tensor(prompts, device=where)
        ln = torch.as_tensor(lengths, device=where)
        if forced is None:  # the CPU's greedy tokens, fed to every run
            forced = gen.batched_greedy_decode(params, c, pr, ln, n,
                                               max_len=max_len).numpy()
        logits[name] = teacher_forced_logits(
            gen, params, c, pr, ln, torch.as_tensor(forced, device=where),
            max_len).cpu()
        del params
    return {"layers": cfg.n_layers, "steps": DECODE_PARITY_STEPS,
            "max_abs_logit_diff": err(logits["card"], logits["cpu"]),
            "cpu_bf16_vs_fp32": err(logits["cpu"], logits["cpu_fp32"]),
            "argmax_equal": int((logits["card"].argmax(-1)
                                 == logits["cpu"].argmax(-1)).sum()),
            "positions": forced.size}


def serve_phase(llama, gen, paging, fa, fx, dev):
    """48 requests through the serving plane, one worker thread on the
    card with the paged KV pool; the gates of :func:`serve_problems`."""
    cfg = bench_config(llama)
    params = serve_params(llama, gen, cfg, dev)
    prompts = serve_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the path's run starts here
    fx.reset_launches()
    row, answers, fwd, batches, after_warmup = serve_run(
        paging, params, cfg, prompts, SERVE_NEW, SERVE_BLOCK, SERVE_BATCHES,
        SERVE_SEQS, SERVE_BURSTS, SERVE_TIMEOUT_S)
    launches = {**fa.LAUNCHES, **fx.LAUNCHES}  # ... and ends here
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    from horovod_tpu_torch.serving.shapes import ShapeBuckets
    buckets = [ShapeBuckets(SERVE_BATCHES, SERVE_SEQS).seq_bucket(len(p))
               for p in prompts]
    t0 = time.perf_counter()
    refs = {i: answer_gaps(gen, params, cfg, torch.as_tensor(
        prompts[i], device=dev), a, buckets[i] + SERVE_NEW)
        for i, a in answers.items()}
    row["sequential_s"] = time.perf_counter() - t0
    bad, kinds = serve_problems(
        row, answers, refs, fwd, batches, after_warmup, cfg, paging,
        SERVE_NEW, SERVE_BLOCK, len(SERVE_BATCHES) * len(SERVE_SEQS))
    dense = [paging.dense_kv_nbytes(cfg, b["bucket"][0],
                                    b["bucket"][1] + SERVE_NEW)
             for b in batches]
    emit("serve", layers=cfg.n_layers, requests=len(prompts),
         bursts=SERVE_BURSTS, new=SERVE_NEW, block=SERVE_BLOCK,
         launches=launches, answers=kinds, **row,
         batch_kv_bytes=[b["bytes_in_use"] for b in batches],
         batch_dense_kv_bytes=dense,
         note="latencies share one process and the GIL with the eager "
              "decode: the plane's RPC server, the worker thread and the "
              "client")
    require(not bad, f"serve: {bad}")
    require(not any(launches.values()),
            f"serve launched kernels of the training path: {launches}")
    del params, fwd
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------ the classifier models

def mfu(n_params: int, tokens_per_s: float) -> float:
    """Model FLOPs utilization: 6 · parameters · tokens/s over the bf16
    peak (bench.py's reckoning)."""
    return 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS


def step_problems(losses, per_step, expected, falling_from=0):
    """A training phase's gates: finite losses, the last below
    ``losses[falling_from]`` (None: no such gate), and exactly
    ``expected`` launches at every step."""
    bad = []
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss {losses}")
    elif falling_from is not None and \
            not losses[-1] < losses[falling_from]:
        bad.append(f"loss did not fall from step {falling_from}: {losses}")
    bad += [f"launches per step {st}, expected {expected}"
            for st in per_step if st != expected]
    return bad


def run_steps(step, n: int, counts):
    """``n`` calls of ``step()``, which returns the loss tensor, each on
    the host clock up to a synchronize: ``(step_ms, losses, the kernel
    launches of each step)``."""
    step_ms, losses, per_step = [], [], []
    for _ in range(n):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        after = counts()
        per_step.append({k: after[k] - before[k] for k in before})
    return step_ms, losses, per_step


def bert_config(bert, **over):
    """bench.py's BERT fine-tune configuration (bench.py:98-101)."""
    return dataclasses.replace(bert.bert_base(num_labels=BERT_LABELS),
                               **over)


def train_bert_phase(fa, fx, dev):
    """``make_dp_finetune_step`` at bert_base under the runtime (world 1,
    NCCL, reduce_grads=True): 1 warm-up and 3 timed steps with their
    launches, then a profiled step.  Returns the emitted line."""
    from horovod_tpu_torch.models import bert
    cfg = bert_config(bert)
    B, T = BERT_BATCH, BERT_SEQ

    def counts():
        return {**fa.LAUNCHES, **fx.LAUNCHES}

    ts = bert.make_dp_finetune_step(cfg, bert.finetune_optimizer,
                                    reduce_grads=True)
    params, opt_state = ts.init_fn(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device=dev)
    labels = torch.randint(0, BERT_LABELS, (B,), generator=gen, device=dev)

    def step():
        return ts.step_fn(params, opt_state, toks, labels)[2]

    t0 = time.perf_counter()
    losses = [step().item()]
    warmup_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the path's run starts here
    fx.reset_launches()
    step_ms, timed_losses, per_step = run_steps(step, 3, counts)
    launches = counts()  # ... and ends here
    losses += timed_losses
    seq_per_s = B / (sum(step_ms) / len(step_ms) / 1e3)
    n = bert.count_params(cfg)
    row = dict(params=n, batch=B, seq=T, remat=cfg.remat, losses=losses,
               warmup_ms=warmup_ms, step_ms=step_ms,
               sequences_per_sec=seq_per_s, tokens_per_sec=seq_per_s * T,
               mfu=mfu(n, seq_per_s * T),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches_per_step=per_step, launches=launches)
    emit("train_bert", **row)
    row["profile"] = profile_step(step)
    emit("profile_bert", **row["profile"])
    # from a random 12-layer post-LN init the first AdamW step overshoots
    # (the loss rose 1.38 -> 3.92 in the JAX package's step and in the
    # port's alike, on the CPU at batch 32): the timed steps must fall
    bad = step_problems(losses, per_step, EXPECTED_BERT_LAUNCHES,
                        falling_from=1)
    require(not bad, f"train_bert: {bad}")
    del params, opt_state, ts
    torch.cuda.empty_cache()
    return row


def resnet_step(training, resnet, cfg, dev, lr: float = 0.01):
    """The classifier step over ResNet ``cfg`` on ``dev`` with SGD(lr,
    momentum 0.9) (bench.py:159-171) and synchronized batch norm; its
    mesh the runtime's when initialized (on ``dev``)."""
    return training.make_classifier_train_step(
        lambda p, s, x, train, process_set: resnet.forward(
            p, s, x, cfg, train=train, process_set=process_set),
        lambda seed: resnet.init(cfg, seed, device=dev),
        optimizer=functools.partial(torch.optim.SGD, lr=lr, momentum=0.9),
        sync_bn=True, device=dev)


def resnet_batch(B: int, img: int, dev, seed: int = 0):
    """Uniform [0, 1) images ``[B, 3, img, img]`` and labels in [0, 1000),
    made on the card from ``seed``, as bench.py makes its synthetic
    batch."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return (torch.rand((B, 3, img, img), generator=gen, device=dev),
            torch.randint(0, 1000, (B,), generator=gen, device=dev))


def train_resnet_phase(fa, fx, dev):
    """ResNet-50 in bf16 at batch 256 x 224^2 through the classifier step
    (world 1): 1 warm-up and 3 timed steps, a profiled step; none of the
    six kernels may launch."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import resnet
    cfg = resnet.ResNetConfig(variant=50)
    ts = resnet_step(training, resnet, cfg, dev)
    run = dict(zip(("params", "state", "opt_state"), ts.init_fn(0)))
    x, y = resnet_batch(RESNET_BATCH, RESNET_IMG, dev)

    def step():
        (run["params"], run["state"], run["opt_state"], loss,
         _) = ts.step_fn(run["params"], run["state"], run["opt_state"], x, y)
        return loss

    def counts():
        return {**fa.LAUNCHES, **fx.LAUNCHES}

    t0 = time.perf_counter()
    losses = [step().item()]
    warmup_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the path's run starts here
    fx.reset_launches()
    step_ms, timed_losses, per_step = run_steps(step, 3, counts)
    launches = counts()  # ... and ends here
    losses += timed_losses
    row = dict(params=resnet.num_params(run["params"]), batch=RESNET_BATCH,
               image=RESNET_IMG, losses=losses, warmup_ms=warmup_ms,
               step_ms=step_ms, images_per_sec=RESNET_BATCH / (
                   sum(step_ms) / len(step_ms) / 1e3),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit("train_resnet", **row)
    row["profile"] = profile_step(step)
    emit("profile_resnet", **row["profile"])
    bad = step_problems(losses, per_step, {k: 0 for k in launches},
                        falling_from=None)
    require(not bad, f"train_resnet: {bad}")
    run.clear()
    torch.cuda.empty_cache()
    return row


def resnet_dp2_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_resnet_dp2`` (``--resnet-dp2-rank``): one step
    of ResNet-50 with synchronized batch norm at dp 2 on this rank's 16
    images of a batch of 32, over gloo on ``cuda:0``; rank 0's weights and
    state broadcast and held against this rank's.  Then rank 0, without
    the runtime, takes the same step on all 32 images and prints both
    runs as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    cfg = resnet.ResNetConfig(variant=50)
    x, y = resnet_batch(2 * RESNET_DP2_BATCH, RESNET_IMG, dev, seed=3)

    def flat(tree):
        return {p: t.detach() for p, t in zip(tree_paths(tree),
                                              tree_leaves(tree))}

    def one_step(ts, images, labels):
        params, state, opt_state = ts.init_fn(0)
        init = {p: t.clone() for p, t in flat(params).items()}
        params, state, _, loss, _ = ts.step_fn(params, state, opt_state,
                                               images, labels)
        return init, flat(params), flat(state), loss.item()

    hvd.init(device=dev)
    rows = slice(rank * RESNET_DP2_BATCH, (rank + 1) * RESNET_DP2_BATCH)
    init, params, state, loss = one_step(
        resnet_step(training, resnet, cfg, dev), x[rows], y[rows])
    mine = {**params, **{f"state.{p}": t for p, t in state.items()}}
    same = all([torch.equal(hvd.broadcast(mine[p], 0, name=f"check.{p}"),
                            mine[p]) for p in sorted(mine)])
    identical = all(hvd.allgather_object(same))
    engine = hvd.runtime._state().engine.stats()
    hvd.shutdown()
    if rank:
        return 0
    _, params1, state1, loss1 = one_step(
        resnet_step(training, resnet, cfg, dev), x, y)
    print(json.dumps({
        "loss": loss, "loss_dp1": loss1, "identical_after_step": identical,
        "engine": engine,
        "update_norms": {p: ((params[p] - init[p]).double().norm().item(),
                             (params1[p] - init[p]).double().norm().item())
                         for p in init},
        "update_cos": {p: cosine(params[p] - init[p], params1[p] - init[p])
                       for p in init},
        "state_rel": {p: rel(state[p], state1[p]) for p in state}}),
        flush=True)
    return 0


def resnet_dp2_problems(res):
    """``train_resnet_dp2``'s gates: the ranks identical; loss, weight
    updates and running statistics against one process (RESNET_DP2_*).
    A weight whose update is 0 in one process (the residual branches
    behind each block's zero-initialized last batch-norm scale) must be
    0 at dp 2 too."""
    bad = []
    if not res["identical_after_step"]:
        bad.append("the ranks' weights or state differ after the step")
    a, b = res["loss"], res["loss_dp1"]
    if not abs(a - b) <= PARITY_LOSS_REL * abs(b):
        bad.append(f"loss {a} (dp 2) vs {b} (dp 1)")
    for p, (a, b) in res["update_norms"].items():
        if b == 0:
            if a != 0:
                bad.append(f"update of {p}: {a} at dp 2, 0 at dp 1")
            continue
        if not abs(a - b) <= PARITY_NORM_REL * b:
            bad.append(f"update norm {p}: {a} (dp 2) vs {b} (dp 1)")
        if not res["update_cos"][p] > PARITY_COS:
            bad.append(f"update cos {p}: {res['update_cos'][p]}")
    bad += [f"running statistic {p}: {r} of its largest entry apart"
            for p, r in res["state_rel"].items()
            if not r <= RESNET_DP2_STATE_REL]
    return bad


def train_resnet_dp2_phase():
    """Two ranks of :func:`resnet_dp2_child` on the card over gloo."""
    res, seconds = _run_pair("--resnet-dp2-rank", RESNET_DP2_TIMEOUT_S)
    emit("train_resnet_dp2", batch=[RESNET_DP2_BATCH] * 2, image=RESNET_IMG,
         backend="gloo", seconds=seconds, **res)
    bad = resnet_dp2_problems(res)
    require(not bad, f"train_resnet_dp2: {bad}")


def tree_digest(tree):
    """``[fp64 sum, sha256]`` of a tree's tensors, leaves by sorted path
    (a step returns the batch-norm state in another key order than
    ``resnet.init``): equal digests mean equal bytes."""
    import hashlib

    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    leaves = [t.detach() for _, t in sorted(
        zip(tree_paths(tree), tree_leaves(tree)), key=lambda pt: pt[0])]
    total = torch.stack([t.double().sum() for t in leaves]).sum().item()
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in leaves])
    return [total, hashlib.sha256(flat.cpu().numpy()).hexdigest()]


def elastic_child(dev: torch.device, out: str) -> int:
    """One worker of ``elastic_resnet`` (``--elastic-worker OUT``), started
    by the elastic driver (or, for the reference run, by the static
    launcher): ResNet-50 under ``@hvd.elastic.run`` with a TensorState of
    the weights, batch-norm statistics, momentum, step, data epoch and
    sampler, committed every step.  Appends JSON records to
    ``OUT/worker-<id>.jsonl``: each step's start, and its end (indices,
    loss, ms, engine bytes, peak memory so far), the digests of the
    commits of ELASTIC_DIGEST_STEPS, of the state right after each restore
    and after each sync (with its ms and bytes).  Worker 1 stops in the backward pass of step
    ELASTIC_KILL_STEP, writes ``kill.marker`` and waits to be killed."""
    import pathlib

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.elastic import ElasticSampler, TensorState, worker
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.tree import tree_leaves
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = pathlib.Path(out)
    elastic = worker.worker_id() is not None
    total = ELASTIC_STEPS if elastic else ELASTIC_REFERENCE_STEPS
    wid = worker.worker_id() if elastic else int(os.environ["HOROVOD_RANK"])
    log = out / f"worker-{wid}.jsonl"

    def record(kind, **rec):
        with open(log, "a") as f:
            f.write(json.dumps({"kind": kind, "wid": wid, "t": time.time(),
                                "epoch": worker._last_epoch,
                                "rank": hvd.rank(), "size": hvd.size(),
                                **rec}) + "\n")

    def digests(state):
        return {"params": tree_digest(state.params),
                "bn": tree_digest(state.state),
                "momentum": tree_digest(state.opt_state)}

    class Recorded(TensorState):
        def restore(self):
            super().restore()
            record("restore", step=self.step, digest=digests(self))

        def sync(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().sync()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            nbytes = sum(t.numel() * t.element_size()
                         for tree in (self.params, self.state,
                                      self.opt_state)
                         for t in tree_leaves(tree))
            record("sync", step=self.step, ms=ms, bytes=nbytes,
                   digest=digests(self))

    hvd.init(device=dev)
    cfg = resnet.ResNetConfig(variant=50)
    params, bn = resnet.init(cfg, 0, device=dev)
    images, labels = resnet_batch(ELASTIC_DATASET, RESNET_IMG, dev, seed=7)
    state = Recorded(
        params=params, state=bn,
        opt_state=[torch.zeros_like(p) for p in tree_leaves(params)],
        step=0, data_epoch=0,
        sampler=ElasticSampler(ELASTIC_DATASET, shuffle=True, seed=5))
    # the sums of synchronized batch norm a step: [sum, sq_sum] of every
    # channel of every batch norm (the state holds a mean and a variance
    # of each), forward and backward, in fp32
    bn_bytes = 2 * 2 * 4 * (sum(t.numel() for t in tree_leaves(bn)) // 2)

    def stop_in_backward(grad):
        (out / "kill.marker").write_text(json.dumps(
            {"wid": wid, "t": time.time()}))
        time.sleep(ELASTIC_TIMEOUT_S)
        raise RuntimeError("worker 1 was not killed in its backward pass")

    @hvd.elastic.run
    def train(state):
        ts = resnet_step(training, resnet, cfg, dev)
        opt = ts.opt_init(state.params)
        # SGD's momentum buffers are the state's tensors, updated in place
        for p, buf in zip(tree_leaves(state.params), state.opt_state):
            opt.state[p]["momentum_buffer"] = buf
        sampler = state.sampler
        sampler.reset()
        engine = hvd.runtime._state().engine
        batch = 0
        while state.step < total:
            mine = list(sampler)[batch * ELASTIC_BATCH:
                                 (batch + 1) * ELASTIC_BATCH]
            if len(mine) < ELASTIC_BATCH:     # the data epoch is done
                state.data_epoch += 1
                sampler.set_epoch(state.data_epoch)
                batch = 0
                continue
            step = state.step + 1
            hook = None
            if elastic and wid == 1 and step == ELASTIC_KILL_STEP:
                hook = state.params["fc"]["w"].register_hook(
                    stop_in_backward)
            record("begin", step=step)
            bytes0 = engine.stats()["bytes"]
            t0 = time.perf_counter()
            idx = torch.tensor(mine, device=dev)
            (_, state.state, _, loss, _) = ts.step_fn(
                state.params, state.state, opt, images[idx], labels[idx])
            loss = loss.item()
            ms = 1e3 * (time.perf_counter() - t0)
            if hook is not None:
                hook.remove()
            sampler.record_batch(batch, ELASTIC_BATCH)
            batch += 1
            state.step = step
            record("step", step=step, data_epoch=state.data_epoch,
                   indices=mine, loss=loss, ms=ms,
                   engine_bytes=engine.stats()["bytes"] - bytes0,
                   bn_bytes=bn_bytes, peak=torch.cuda.max_memory_allocated())
            if elastic and step in ELASTIC_PAUSE_STEPS:
                release = out / f"release-{step}"
                deadline = time.monotonic() + ELASTIC_TIMEOUT_S
                while not release.exists():
                    require(time.monotonic() < deadline,
                            f"no {release.name} from the phase")
                    time.sleep(0.02)
            state.save()
            if step in ELASTIC_DIGEST_STEPS:
                record("commit", step=step, digest=digests(state))
            state.check_host_updates()
        return state.step

    train(state)
    hvd.shutdown()
    return 0


def elastic_records(out):
    """Every worker's records of an ``elastic_resnet`` run, by time."""
    recs = []
    for f in sorted(out.glob("worker-*.jsonl")):
        recs += [json.loads(line) for line in f.read_text().splitlines()]
    return sorted(recs, key=lambda r: r["t"])


def digest_problems(recs, kind: str):
    """Records of ``kind`` ("sync", "commit") whose digests differ from
    another rank's of the same epoch and step."""
    groups = {}
    for r in recs:
        if r["kind"] == kind:
            groups.setdefault((r["epoch"], r["step"]), []).append(r)
    bad = []
    for (epoch, step), rs in sorted(groups.items()):
        if len({json.dumps(r["digest"], sort_keys=True) for r in rs}) > 1:
            bad.append(f"{kind} digests of epoch {epoch} step {step} "
                       f"differ across ranks {[r['rank'] for r in rs]}")
    return bad


def sampler_problems(steps, dataset: int):
    """Within each data epoch the committed steps' indices are each taken
    once, and a finished epoch (every epoch but the last) took all
    ``dataset``."""
    by_epoch = {}
    for r in steps:
        by_epoch.setdefault(r["data_epoch"], []).extend(r["indices"])
    bad = []
    for epoch, idx in sorted(by_epoch.items()):
        dup = len(idx) - len(set(idx))
        if dup:
            bad.append(f"data epoch {epoch}: {dup} indices taken twice")
        if epoch < max(by_epoch) and sorted(idx) != list(range(dataset)):
            bad.append(f"data epoch {epoch} ended with {len(set(idx))} "
                       f"of {dataset} indices")
    return bad


def transition_problems(events, sizes):
    """The driver's lifecycle ``events`` ((name, info) pairs) must form
    epochs of ``sizes`` in order, each after its own ``epoch_applied``;
    returns (problems, [reform seconds of each formed epoch])."""
    applied = {}
    formed = []
    for name, info in events:
        if name == "epoch_applied":
            applied[info["epoch"]] = info
        elif name == "epoch_formed":
            formed.append(info)
    bad, reform = [], []
    if [f["size"] for f in formed] != list(sizes):
        bad.append(f"epochs formed at sizes {[f['size'] for f in formed]}, "
                   f"expected {list(sizes)}")
    for f in formed:
        a = applied.get(f["epoch"])
        if a is None or a["size"] != f["size"]:
            bad.append(f"epoch {f['epoch']} formed at size {f['size']} "
                       f"without its epoch_applied at that size")
        else:
            reform.append(f["t"] - a["t"])
    return bad, reform


def elastic_resnet_phase(worker_script=None):
    """``elastic_resnet``: the reference run (2 ranks, steps 1-6, through
    ``python -m horovod_tpu_torch.runner``), then the elastic job through
    the port's ElasticDriver in this process with a discovery script over
    a hostfile the phase rewrites; the gates of ELASTIC_* and the
    transition numbers (recover_s, reform_s, sync_ms, step ms, peak).
    The workers run ``worker_script --elastic-worker OUT`` (default: this
    script)."""
    import pathlib
    import shutil
    import signal
    import socket
    import threading

    from horovod_tpu_torch.elastic import discovery
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    t_phase = time.monotonic()
    deadline = t_phase + ELASTIC_TIMEOUT_S
    root = pathlib.Path(__file__).resolve().parent
    # the records go under the checkout's build/ (git ignores it)
    work = root / "build" / "elastic_resnet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {"HOROVOD_CONTROLLER": "gloo", "PYTHONPATH": str(root),
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "120"}
    worker_cmd = [sys.executable, str(worker_script or root / "chip_smoke.py"),
                  "--elastic-worker"]

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    try:
        # the reference: two ranks, steps 1-6, no failure, no resize
        ref = work / "reference"
        ref.mkdir()
        t0 = time.monotonic()
        launch = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
             "-p", str(free_port()), "--network-interface", "lo",
             *worker_cmd, str(ref)], cwd=root, env={**os.environ, **env},
            capture_output=True, text=True,
            timeout=max(deadline - time.monotonic(), 1))
        require(launch.returncode == 0, "elastic_resnet reference run "
                f"exited {launch.returncode}:\n{launch.stdout[-4000:]}")
        reference_s = time.monotonic() - t0
        ref_recs = elastic_records(ref)

        # the elastic job
        run = work / "elastic"
        run.mkdir()
        hostfile = run / "hosts.txt"
        hostfile.write_text("localhost:2\n")
        events = []

        class Driver(ElasticDriver):
            def _emit(self, event, **info):
                info["t"] = time.monotonic()
                events.append((event, dict(info)))
                super()._emit(event, **info)

        driver = Driver(
            discovery.HostDiscoveryScript(f"cat {hostfile}"),
            worker_cmd + [str(run)], min_np=1, port=free_port(),
            discovery_interval=0.3, start_timeout=60.0,
            blacklist_threshold=5, env=env, network_interface="lo")
        result = {}
        thread = threading.Thread(
            target=lambda: result.update(rc=driver.run()), daemon=True)
        t0 = time.monotonic()
        thread.start()

        def left():
            return max(deadline - time.monotonic(), 0.1)

        def wait_for(pred, what):
            while True:
                recs = elastic_records(run)
                if pred(recs):
                    return recs
                require(time.monotonic() < deadline and thread.is_alive(),
                        f"elastic_resnet: {what} (driver "
                        f"{'alive' if thread.is_alive() else result})")
                time.sleep(0.05)

        def steps_done(step, size):
            return lambda recs: sum(
                1 for r in recs if r["kind"] == "step" and r["step"] == step
                and r["size"] == size) == size

        try:
            marker = run / "kill.marker"
            wait_for(lambda _: marker.exists(), "worker 1 never reached "
                     f"the backward pass of step {ELASTIC_KILL_STEP}")
            with driver._lock:
                victim = driver._workers[json.loads(marker.read_text())[
                    "wid"]]
            t_kill = time.time()
            os.kill(victim.proc.popen.pid, signal.SIGKILL)
            wait_for(steps_done(6, 2), "steps 4-6 after the kill")
            hostfile.write_text("localhost:1\n")
            driver.wait_event("epoch_applied", left(),
                              match=lambda e: e["size"] == 1)
            (run / "release-6").touch()
            wait_for(steps_done(8, 1), "steps 7-8 at size 1")
            hostfile.write_text("localhost:2\n")
            n = len(events)
            driver.wait_event("epoch_applied", left(),
                              match=lambda e: e["size"] == 2, since=n)
            (run / "release-8").touch()
            thread.join(left())
            require(not thread.is_alive(), "elastic_resnet: the driver "
                    "did not finish")
        finally:
            driver._terminate_all()
            driver._server.close()
        elastic_s = time.monotonic() - t0
        recs = elastic_records(run)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    steps = [r for r in recs if r["kind"] == "step"]
    rank0 = {r["step"]: r for r in steps if r["rank"] == 0}
    ref0 = {r["step"]: r for r in ref_recs
            if r["kind"] == "step" and r["rank"] == 0}
    bad, reform_s = transition_problems(events, ELASTIC_FORMED_SIZES)
    if result.get("rc") != 0:
        bad.append(f"the driver exited {result.get('rc')}")
    bad += digest_problems(recs, "sync") + digest_problems(recs, "commit")
    bad += digest_problems(ref_recs, "commit")
    bad += sampler_problems(steps, ELASTIC_DATASET)
    if sorted(rank0) != list(range(1, ELASTIC_STEPS + 1)):
        bad.append(f"rank 0 recorded steps {sorted(rank0)}")
    bad += [f"step {r['step']} rank {r['rank']}: loss {r['loss']}"
            for r in steps + ref_recs if r["kind"] == "step"
            and not math.isfinite(r["loss"])]
    commits = {(r["rank"], r["step"]): r["digest"] for r in recs
               if r["kind"] == "commit" and r["epoch"] == 0}
    restores = [r for r in recs if r["kind"] == "restore"]
    if [r["step"] for r in restores] != [ELASTIC_KILL_STEP - 1]:
        bad.append(f"restores at steps {[r['step'] for r in restores]}")
    for r in restores:
        if r["digest"] != commits.get((r["rank"], r["step"])):
            bad.append(f"rank {r['rank']}'s state after restore is not its "
                       f"commit of step {r['step']}")
    after = range(ELASTIC_KILL_STEP, ELASTIC_REFERENCE_STEPS + 1)
    losses = {s: [rank0[s]["loss"], ref0[s]["loss"]] for s in after
              if s in rank0 and s in ref0}
    if any(a != b for a, b in losses.values()) or len(losses) != len(after):
        bad.append(f"losses of steps 4-6 (elastic, reference): {losses}")
    final = {r["rank"]: r["digest"] for r in recs if r["kind"] == "commit"
             and r["step"] == ELASTIC_REFERENCE_STEPS}
    ref_final = {r["rank"]: r["digest"] for r in ref_recs
                 if r["kind"] == "commit"
                 and r["step"] == ELASTIC_REFERENCE_STEPS}
    if final.get(0) is None or final.get(0) != ref_final.get(0):
        bad.append(f"weights after step {ELASTIC_REFERENCE_STEPS}: "
                   f"{final.get(0)} (elastic) vs {ref_final.get(0)} "
                   f"(reference)")
    first_after = min((r["t"] for r in steps
                       if r["step"] == ELASTIC_KILL_STEP), default=None)
    sizes = {1: [r["ms"] for r in steps if r["size"] == 1],
             2: [r["ms"] for r in steps if r["size"] == 2]}
    syncs = [r for r in recs if r["kind"] == "sync"]
    row = dict(
        model="resnet50", image=RESNET_IMG, batch_per_rank=ELASTIC_BATCH,
        dataset=ELASTIC_DATASET, backend="gloo",
        formed=[[info["epoch"], info["size"]] for name, info in events
                if name == "epoch_formed"],
        recover_s=(None if first_after is None else first_after - t_kill),
        reform_s=reform_s,
        sync_ms=[r["ms"] for r in syncs], sync_bytes=[r["bytes"]
                                                     for r in syncs],
        steps_reexecuted=sum(1 for r in recs if r["kind"] == "begin"
                             and r["rank"] == 0) - len(rank0),
        step_ms_size1=sizes[1], step_ms_size2=sizes[2],
        peak_bytes={wid: max(r["peak"] for r in steps if r["wid"] == wid)
                    for wid in sorted({r["wid"] for r in steps})},
        engine_bytes_per_step=sorted({r["engine_bytes"] for r in steps}),
        sync_bn_bytes_per_step=steps[0]["bn_bytes"] if steps else None,
        losses={s: rank0[s]["loss"] for s in sorted(rank0)},
        losses_vs_reference=losses,
        exits=[info for name, info in events if name == "worker_exit"],
        reference_s=reference_s, elastic_s=elastic_s,
        seconds=time.monotonic() - t_phase)
    emit("elastic_resnet", **row)
    if row["seconds"] > ELASTIC_TIMEOUT_S:
        bad.append(f"the phase took {row['seconds']:.1f} s")
    require(not bad, f"elastic_resnet: {bad}")


def mnist_phase(fa, fx, dev):
    """MNIST_STEPS classifier steps at batch 128 of seeded 28 x 28 images;
    then ``classifier_forward`` serves a bucket of MNIST rows (the
    images' bytes) and one of BERT rows (bert_base, seq 128), each
    answer the argmax of ``eval_fn`` (MNIST) or ``classify`` (BERT) on
    the same padded bucket."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import bert, mnist
    from horovod_tpu_torch.serving.models import classifier_forward
    from horovod_tpu_torch.serving.shapes import ShapeBuckets
    cfg = mnist.MnistConfig()
    ts = training.make_classifier_train_step(
        lambda p, s, x, train, process_set: (mnist.forward(p, x, cfg), s),
        lambda seed: (mnist.init(cfg, seed, device=dev), {}), device=dev)
    params, state, opt_state = ts.init_fn(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pixels = torch.randint(0, 256, (MNIST_BATCH, 28 * 28), generator=gen,
                           device=dev)
    labels = torch.randint(0, 10, (MNIST_BATCH,), generator=gen, device=dev)

    def preprocess(t):
        return t.view(-1, 1, 28, 28).float() / 255.0

    images = preprocess(pixels)
    losses, step_ms = [], []
    for _ in range(MNIST_STEPS):
        t0 = time.perf_counter()
        params, state, opt_state, loss, acc = ts.step_fn(
            params, state, opt_state, images, labels)
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    bad = step_problems(losses, [], {})

    n = SERVE_CLASSIFIER_ROWS
    served = {}
    bcfg = bert_config(bert)
    bparams = bert.init_params(bcfg, seed=0, device=dev)
    rng = np.random.RandomState(0)
    cases = {
        "mnist": (lambda p, x: mnist.forward(p, x, cfg), params, preprocess,
                  pixels[:n - 2].cpu().numpy(), 28 * 28,
                  lambda t: ts.eval_fn(params, state, preprocess(t))),
        "bert": (lambda p, x: bert.classify(p, x, bcfg), bparams, None,
                 rng.randint(0, bcfg.vocab_size, (n - 3, BERT_SEQ)),
                 BERT_SEQ, lambda t: bert.classify(bparams, t, bcfg)),
    }
    fa.reset_launches()
    for name, (fwd, p, pre, rows, width, reference) in cases.items():
        tokens = np.zeros((n, width), np.int32)
        tokens[:len(rows)] = rows
        lengths = np.array([width] * len(rows) + [0] * (n - len(rows)),
                           np.int32)
        serve = classifier_forward(fwd, p, ShapeBuckets((n,), (width,)),
                                   preprocess=pre)
        t0 = time.perf_counter()
        got = serve(tokens, lengths)
        ms = 1e3 * (time.perf_counter() - t0)
        with torch.no_grad():
            want = reference(torch.as_tensor(tokens, dtype=torch.long,
                                             device=dev)).argmax(-1)
        want = want.cpu().numpy()[:, None]
        served[name] = {"rows": len(rows), "bucket": [n, width], "ms": ms,
                        "answers": got[:len(rows), 0].tolist(),
                        "equal": bool(np.array_equal(got, want))}
        if not served[name]["equal"]:
            bad.append(f"classifier_forward {name}: {got[:, 0].tolist()}, "
                       f"the reference's argmax {want[:, 0].tolist()}")
    row = dict(batch=MNIST_BATCH, losses=losses, step_ms=step_ms,
               accuracy=acc.item(), served=served,
               bert_serve_launches=dict(fa.LAUNCHES))
    emit("mnist", **row)
    require(not bad, f"mnist: {bad}")
    del bparams, params
    torch.cuda.empty_cache()
    return row


def cosine_problems(pairs):
    """``{name: (card, cpu)}`` by the parity rule: norms within
    PARITY_NORM_REL, cosine above PARITY_COS.  Returns ``(norms, cos,
    problems)``."""
    norms = {n: (a.double().norm().item(), b.double().norm().item())
             for n, (a, b) in pairs.items()}
    cos = {n: cosine(a, b) for n, (a, b) in pairs.items()}
    bad = []
    for n, (a, b) in norms.items():
        if not abs(a - b) <= PARITY_NORM_REL * b:
            bad.append(f"norm {n}: {a} (card) vs {b} (cpu)")
        if not cos[n] > PARITY_COS:
            bad.append(f"cos {n}: {cos[n]}")
    return norms, cos, bad


def parity_bert_phase(convert, dev):
    """2 layers of bert_base, card against CPU from the same converted
    weights: logits, loss and gradients of one fine-tune batch."""
    from horovod_tpu_torch.models import bert
    cfg = bert_config(bert, n_layers=PARITY_BERT_LAYERS)
    cpu = torch.device("cpu")
    np_params = convert.bert_params_to_numpy(
        bert.init_params(cfg, seed=1, device=cpu))
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (PARITY_BERT_BATCH, BERT_SEQ))
    labels = rng.randint(0, BERT_LABELS, PARITY_BERT_BATCH)
    out = {}
    for name, where in (("card", dev), ("cpu", cpu)):
        ts = bert.make_dp_finetune_step(cfg, bert.finetune_optimizer,
                                        device=where)
        params = convert.bert_params_from_numpy(np_params, device=where)
        ts.opt_init(params)
        tk = torch.as_tensor(toks, device=where)
        lb = torch.as_tensor(labels, device=where)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = bert.classify(params, tk, cfg)
        loss, grads = ts.grads_fn(params, tk, lb)
        picked = {"logits": logits, "word_embed": grads["word_embed"],
                  "wq0": grads["layers"][0]["wq"],
                  "wk0": grads["layers"][0]["wk"],
                  "wv1": grads["layers"][1]["wv"],
                  "w_out1": grads["layers"][1]["w_out"],
                  "pooler_w": grads["pooler_w"], "cls_w": grads["cls_w"]}
        out[name] = (loss.item(), {k: v.float().cpu()
                                   for k, v in picked.items()},
                     time.perf_counter() - t0)
        del ts, params, grads, picked
    (gl, gt, gs), (cl, ct, cs) = out["card"], out["cpu"]
    norms, cos, bad = cosine_problems({k: (gt[k], ct[k]) for k in gt})
    if not abs(gl - cl) <= PARITY_LOSS_REL * abs(cl):
        bad.append(f"loss {gl} (card) vs {cl} (cpu)")
    emit("parity_bert", layers=cfg.n_layers, batch=PARITY_BERT_BATCH,
         seq=BERT_SEQ, loss=[gl, cl], norms=norms, cos=cos,
         seconds={"cuda": gs, "cpu": cs})
    require(not bad, f"parity_bert: {bad}")


def parity_resnet_phase(convert, dev):
    """ResNet-50 at batch 4 x 64^2, card against CPU from the same
    converted weights, in fp32 and in bf16: loss, logits, the new running
    statistics and, in fp32, gradients.  Each block's zero-initialized
    last batch-norm scale is set to PARITY_RESNET_SCALE, so that every
    residual branch has a gradient.  bf16 gradients through 50 layers of
    batch norm at 4 images are rounding-bound (the CPU's own bf16 run
    lies at cosines of 0.84-0.99 from its fp32 run at these weights), so
    they are printed beside that distance and held to no gate."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    cfg = resnet.ResNetConfig(variant=50)
    cpu = torch.device("cpu")
    params, state = resnet.init(cfg, seed=1, device=cpu)
    for t, path in zip(tree_leaves(params), tree_paths(params)):
        if path.endswith(".scale") and not t.any():
            t.fill_(PARITY_RESNET_SCALE)
    np_params, np_state = convert.resnet_params_to_numpy(params, state)
    x, y = (t.cpu() for t in resnet_batch(PARITY_RESNET_BATCH,
                                          PARITY_RESNET_IMG, dev, seed=1))
    picked = ("stem", "stage0.0.conv1", "stage1.0.proj", "stage2.3.conv2",
              "stage3.2.conv0", "stage3.2.bn2.scale", "fc.w")

    def run(where, dtype):
        p, st = convert.resnet_params_from_numpy(np_params, np_state,
                                                 device=where)
        flat = dict(zip(tree_paths(p), tree_leaves(p)))
        for t in flat.values():
            t.requires_grad_(True)
        t0 = time.perf_counter()
        logits, new_state = resnet.forward(
            p, st, x.to(where), dataclasses.replace(cfg, dtype=dtype))
        loss = torch.nn.functional.cross_entropy(logits, y.to(where))
        grads = torch.autograd.grad(loss, [flat[k] for k in picked])
        stats = torch.cat([t.flatten() for t in tree_leaves(new_state)])
        return (loss.item(), {"logits": logits.detach().float().cpu(),
                              "running_stats": stats.cpu()},
                {k: g.float().cpu() for k, g in zip(picked, grads)},
                time.perf_counter() - t0)

    out, bad, cpu_fp32_grads = {}, [], None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        (gl, gv, gg, gs), (cl, cv, cg, cs) = (run(dev, dtype),
                                              run(cpu, dtype))
        gated = {**gv, **gg} if dtype == torch.float32 else gv
        norms, cos, problems = cosine_problems(
            {k: (a, {**cv, **cg}[k]) for k, a in gated.items()})
        if not abs(gl - cl) <= PARITY_LOSS_REL * abs(cl):
            problems.append(f"loss {gl} (card) vs {cl} (cpu)")
        out[name] = {"loss": [gl, cl], "norms": norms, "cos": cos,
                     "seconds": {"cuda": gs, "cpu": cs}}
        if dtype == torch.float32:
            cpu_fp32_grads = cg
        else:
            out[name]["grad_cos"] = {k: cosine(gg[k], cg[k]) for k in gg}
            out[name]["cpu_grad_cos_bf16_vs_fp32"] = {
                k: cosine(cg[k], cpu_fp32_grads[k]) for k in cg}
        bad += [f"{name}: {b}" for b in problems]
    emit("parity_resnet", batch=PARITY_RESNET_BATCH, image=PARITY_RESNET_IMG,
         scale=PARITY_RESNET_SCALE, **out)
    require(not bad, f"parity_resnet: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full fp32 matmuls in the plain versions and the fp32 loss head
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--dp2-rank" in sys.argv:
        return dp2_child(int(sys.argv[sys.argv.index("--dp2-rank") + 1]),
                         dev)
    if "--a5-rank" in sys.argv:
        return a5_child(int(sys.argv[sys.argv.index("--a5-rank") + 1]), dev)
    if "--resnet-dp2-rank" in sys.argv:
        return resnet_dp2_child(
            int(sys.argv[sys.argv.index("--resnet-dp2-rank") + 1]), dev)
    if "--elastic-worker" in sys.argv:
        return elastic_child(
            dev, sys.argv[sys.argv.index("--elastic-worker") + 1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import generate as gen
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_xent as fx
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.serving import paging
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=name, count=count, nvidia_smi=smi,
         python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda)

    build_s = _build.build_all()
    wgmma_spills, other_spills, problems = spill_check(_build.PTXAS_REPORT)
    xent_lib = _build.library("fused_xent")
    active = {f"{k}_active_clusters": {
        D: getattr(xent_lib, f"hvd_xent_{k}_active_clusters")(D)
        for D in XENT_DIMS} for k in ("dh", "dw")}
    active["fwd_active_clusters"] = xent_lib.hvd_xent_fwd_active_clusters()
    emit("build", seconds=build_s, ptxas=_build.PTXAS_REPORT,
         wgmma_spills=wgmma_spills, other_spills=other_spills, **active)
    require(not problems, f"wgmma kernels must not spill: {problems}")
    for key, n in active.items():
        counts = n.values() if isinstance(n, dict) else [n]
        require(all(x > 0 for x in counts),
                f"{key}: the xent kernel's clusters do not fit on the card: "
                f"{n}")

    phase_s = {"build": build_s}

    def timed(phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[phase] = time.perf_counter() - t0
        return out

    kernels = timed("kernels", kernels_phase, fa, dev)
    xent = timed("xent_kernels", xent_kernels_phase, fx, llama, dev)
    launches, train = timed("train", train_phase, fa, fx, llama, training,
                            adamw_lp, dev, fused=False)
    launches_fused, _ = timed("train_fused", train_phase, fa, fx, llama,
                              training, adamw_lp, dev, fused=True)
    timed("parity", parity_phase, llama, training, adamw_lp, convert, dev,
          fused=False)
    timed("parity_fused", parity_phase, llama, training, adamw_lp, convert,
          dev, fused=True)

    # the Horovod core at world 1 over NCCL: every op, the train step with
    # its gradients through the engine, then overlapped through the grad
    # taps
    hvd.init()
    try:
        require(hvd.runtime._state().backend == "nccl" and hvd.size() == 1,
                f"hvd.init() on the card: {hvd.runtime._state().backend}, "
                f"size {hvd.size()}")
        timed("collectives", collectives_phase, hvd, dev)
        _, train_dp = timed("train_dp", train_phase, fa, fx, llama,
                            training, adamw_lp, dev, fused=False,
                            engine=hvd.runtime._state().engine)
        train_overlap = timed("train_overlap", overlap_phase, fa, fx, llama,
                              training, adamw_lp, dev, wire=False)
    finally:
        hvd.shutdown()
    emit("train_dp_vs_train", **{
        k: [train_dp[k], train[k]] for k in ("losses", "step_ms",
                                             "max_memory_allocated")},
         device_busy_ms=[train_dp["profile"]["device_busy_ms"],
                         train["profile"]["device_busy_ms"]])
    require(train_dp["losses"] == train["losses"],
            f"train_dp losses {train_dp['losses']} are not train's "
            f"{train['losses']}")
    expected = {**EXPECTED_LAUNCHES,
                **{n: 0 for n in EXPECTED_XENT_LAUNCHES}}
    emit("train_overlap_vs_train_dp", **{
        k: [train_overlap[k], train_dp[k], train[k]]
        for k in ("losses", "step_ms", "max_memory_allocated")},
         device_busy_ms=[r["profile"]["device_busy_ms"]
                         for r in (train_overlap, train_dp, train)],
         device_idle_share=[r["profile"]["device_idle_share"]
                            for r in (train_overlap, train_dp, train)],
         exposed_device_ms=train_overlap["plane"]["exposed_device_ms"],
         overlap_host_ms_after_backward=train_overlap["plane"][
             "finish_host_ms"],
         overlap_host_ms_issuing=train_overlap["plane"]["issue_host_ms"],
         train_dp_engine_host_ms=[st["dispatch_ms"]
                                  for st in train_dp["gradient_plane"]])
    bad = overlap_problems(train_overlap, train, expected)
    require(not bad, f"train_overlap: {bad}")
    # the same step with the int8 wire: the runtime reads the knob at init
    os.environ["HOROVOD_COMPRESSION"] = "int8"
    hvd.init()
    try:
        train_wire = timed("train_wire", overlap_phase, fa, fx, llama,
                           training, adamw_lp, dev, wire=True)
    finally:
        hvd.shutdown()
        os.environ.pop("HOROVOD_COMPRESSION")
    bad = wire_problems(train_wire, train, expected)
    require(not bad, f"train_wire: {bad}")
    torch.cuda.empty_cache()
    timed("train_dp2", train_dp2_phase)
    timed("train_a5_dp2", train_a5_dp2_phase)
    timed("decode", decode_phase, llama, gen, paging, fa, fx, convert, dev)
    timed("serve", serve_phase, llama, gen, paging, fa, fx, dev)

    # the classifier models: BERT through the flash kernels at head_dim 64
    # and ResNet-50 under the runtime at world 1, two ranks of ResNet-50
    # sharing the card, MNIST and the classifier serving forward, and
    # both models against the CPU
    hvd.init()
    try:
        train_bert = timed("train_bert", train_bert_phase, fa, fx, dev)
        timed("train_resnet", train_resnet_phase, fa, fx, dev)
    finally:
        hvd.shutdown()
    timed("train_resnet_dp2", train_resnet_dp2_phase)
    timed("elastic_resnet", elastic_resnet_phase)
    timed("mnist", mnist_phase, fa, fx, dev)
    timed("parity_bert", parity_bert_phase, convert, dev)
    timed("parity_resnet", parity_resnet_phase, convert, dev)
    emit("phase_seconds", **phase_s)

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
        if label.startswith("flash_"):
            # BERT's shape and path: the bert case's numbers and the
            # launches of train_bert's timed steps
            k = label.removeprefix("flash_")
            summary[-1]["bert"] = {
                key: kernels[("bert", k)][key] for key in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_pair_ms", "tflops")}
            summary[-1]["bert"]["launches"] = train_bert["launches"][k]
            require(train_bert["launches"][k] > 0,
                    f"{label} never ran on train_bert's path")
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
