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
           once, which must be at least one; g++ builds the native
           control-plane core (horovod_tpu_torch/native/core.cpp) at the
           same time: its seconds, include dir and artifact
  kernels  each flash-attention kernel at the training shapes (plus a
           non-causal case, an H == Hkv case, a ragged T = 960, a
           multiple of 64 but not of 128, BERT-base's fine-tune shape,
           B 512, T 128, 12 heads of 64, non-causal, train_tp2_sp2's ring
           tile through flash_attention_lse with a cotangent on lse, causal
           and not, its Ulysses shape and train_moe_ep2's, bert_tp2_sp2's
           ring tile and train_fsdp_dp2's attention) against its plain
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
  train_moe, parity_moe   the train step with 8 experts (top-2, capacity
           factor 1.25) at 4 layers; parity at 2 MoE layers with top-8
           routing, where both sides route every token alike
  parity_moe_route   top-2 routing card against CPU at step 0, through
           layer 0 of parity_moe's weights: its picks in the model's
           forward, where a differing pick is printed with its logit gap;
           then layer 0 on one input, where
           every differing pick must be a near-tie of the bf16 logits and
           the agreeing tokens' outputs and gradients meet parity's gates
  train_tp2_sp2  four gloo ranks on the card as MeshConfig(sp=2, tp=2)
           with vocab_parallel, the ring then Ulysses, against one process
  train_tp2_dp2_spec  four gloo ranks as MeshConfig(dp=2, tp=2): the 1B
           widths at 2 layers through DistributedGradientTransform(
           param_specs=llama.param_specs(...)), sharded_update off (specs
           passed) and on (specs from the mesh's context), against one
           process: the reduced gradients, losses and updates, the inner
           state's and the transform's bytes exactly the spec plan's
  train_moe_ep2  two gloo ranks with the experts over dp, against one
           process, at capacity factors 1.25 and 8
  train_pp2  two gloo ranks as MeshConfig(pp=2): the 1B at 16 layers, 8 a
           stage, batch 8 x 1024 in 4 microbatches, against train's losses;
           each stage's flash launches on the live-tick schedule, the hop
           and pp sum bytes a step
  bert_tp2_sp2   four gloo ranks as MeshConfig(sp=2, tp=2): bert_base's
           widths at 2 of its 12 layers, 16 x 512, the non-causal ring's
           tiles through the flash
           kernels; the loss and every leaf's gradient against one process
  train_fsdp_dp2   two gloo ranks through make_llama_fsdp_step at the 1B
           widths and 2 layers (the first rematerialized), without and
           with overlap, against one
           process; each rank's parameter and optimizer bytes exactly the
           shards fsdp_param_specs names
  serve_mp2  two gloo ranks through mp_llama_decode_forward (the 1B's
           widths in bf16, 2 of its 16 layers): 8 requests in batches of 1
           and 4, each
           call's tokens one process's bit for bit, the per-chip bytes
           exact; both ranks record their first call's collectives: the
           same schedule, the weights gathered over hvd_serve_mp
  collectives    hvd.init() at world 1 over NCCL: every op of the API on
           fp32, bf16 and int64 CUDA tensors against its plain expectation,
           and 64 small tensors submitted in one call, which the engine
           must fuse into fewer buckets
  train_dp, profile_dp   the train step under hvd.init() at world 1: the
           gradients go through the engine's fused buckets and NCCL; the
           losses must equal train's bit for bit, with the same launches;
           buckets and bytes a step, the device ms of packing, NCCL and
           unpacking, peak memory; train_dp_vs_train puts its losses,
           step ms, device busy ms and peak beside train's.  Its first
           timed step runs with the schedule recorder armed
           (horovod_tpu_torch/analysis/recorder.py): one record a bucket
           of the step's plane, each a psum over workers, bucket ids
           0..n-1 in issue order, the input bytes the plane's
  train_overlap  the 1B step with overlap=True under hvd.init() at world 1:
           the grad taps reduce each layer's buckets on the plan's stream
           during the backward pass; losses equal to train's bit for bit,
           launches 30/16/16; the buckets a step and their layer keys in
           issue order, how many the device started before the backward's
           last kernel, the exposed plane (device ms from that kernel to
           the last bucket's end, and the host ms after the backward's
           return) beside train_dp's engine host ms, device busy time,
           idle share and peak
  native_core    host code: every signature list train_dp's engine
           planned (the 66-bucket gradient plane) and train_overlap's taps
           planned (82 buckets), planned again by plan_fusion and by the
           native plan_fusion_sigs, all equal; plan_dispatch_sigs equal
           to plan_dispatch on the latter; negotiate_decide equal to the
           controller's Python arithmetic on seeded token multisets at
           worlds 2, 4 and 8; each planner's host us a call on the
           66-bucket list (median of 200); train_dp, train_dp2 and
           train_hier_dp4 ran every control-plane object on the core
  train_wire     the same under HOROVOD_COMPRESSION=int8: the first loss
           equal to train's, the later ones within WIRE_LOSS_REL, the
           wire's quantization error within WIRE_ERROR_REL of the
           gradient, and the wire bytes a step against full width
  train_dp_tools train_dp's step again under HOROVOD_TIMELINE (with cycle
           marks) and HOROVOD_AUTOTUNE (a warm-up of 1 sample of 2 cycles):
           6 steps, the losses train's bit for bit, every gradient
           tensor's NEGOTIATE_ALLREDUCE span, ALLREDUCE activity and DONE
           mark a step in the timeline, the cycle marks, the autotune log's
           header and 2 sample rows; then stop_timeline()/start_timeline()
           around one more step, which the second file must hold whole;
           step ms and engine host ms beside train_dp's
  trace_dp       train_dp's step (16 layers, world 1 over NCCL) with the
           tracer off (HOROVOD_TRACE=0) and on: the losses train_dp's bit
           for bit, a step's dispatch spans its buckets and its fuse and
           cycle spans the engine's counts, step ms and engine host ms
           both ways; then one step under hvd.start_profiler, whose trace
           file holds a range a bucket and the flash kernels
  health_dp      the 1B at 16 layers (world 1 over NCCL), loss_fn's
           gradients through DistributedGradientTransform(adamw_lp(3e-4),
           health=False, then True, health_check_every=1) and tx.update:
           the losses bit for bit both ways, no verdict on a clean run,
           hvd_health_grad_norm set for every bucket, flash launches
           30/16/16 a step; a collective.corrupt nan:0 rule on bucket
           HEALTH_BUCKET from fresh weights gives a nonfinite verdict
           naming worker 0, the bucket's name and the step; scale:0 after
           the EWMA warm-up a grad_explosion verdict on it; step ms, a
           profiled step's busy ms and idle share, the taps' device ms and
           the host ms of their one device-to-host delivery, off and on
  train_dp2      two processes (this script with --dp2-rank) share the card
           over gloo (HOROVOD_CONTROLLER=gloo): 2 layers at full width with
           fused_xent=True, batch 8 x 1024 split 4 + 4, rank 1 submitting
           its gradients in another order; both ranks' weights must be
           bit-identical after each step, and agree with one process on
           the whole batch within the parity gates; both ranks record
           their first step's collectives: the same full schedule, and
           train_dp's prims, axes and bucket sequence
  train_a5_dp2   two such processes (--a5-rank) run 2 steps of three
           variants: zero1=True, overlap=True under HOROVOD_SHARDED_UPDATE=1
           and HOROVOD_COMPRESSION=int8, and grad_accum=2; weights
           bit-identical on both ranks after every step; zero1 and
           grad_accum within train_dp2's parity gates of one process on
           the whole batch, the quantized overlap within its own
           (A5_WIRE_*); zero1's optimizer state half the dp-1 run's
  train_hier_dp4 four processes (--hier-rank) share the card over gloo as
           two hosts of two (HOROVOD_LOCAL_SIZE=2, HOROVOD_CROSS_SIZE=2):
           an eager sub-check on multiples of 1/4 (the hierarchical
           allreduce and allgather exact, a stall naming rank 3, bounded
           and stale rounds with host 1 late), then 2 layers at full width
           with fused_xent=True, batch 8 x 1024 split 2 a rank, 2 steps
           each of flat, hier, hier_int8 (only the cross stage quantized),
           bounded and stale (host 1's cross stage 0.2 s late on step 2,
           past a 50 ms deadline), and one step of
           DistributedOptimizer(SGD, op=Adasum); weights identical on all
           four after every step; parity with one process on the whole
           batch (step 1 only where step 2 excluded a host), bounded's
           step 1 bit for bit hier's, one tail round per hierarchical
           bucket, the late host's ranks scoring above the others, and
           Adasum's applied gradient within ADASUM_REL of the plain tree
           in fp64; a third step of bounded, host 1 starting it late,
           pulled from
           the four ranks' span buffers with their clock probes and merged
           into one trace: a pid a host, every dcn span excluding host 1,
           and host 1 the critical path's top gating host
  decode   the KV-cache decode at the 1B widths in bf16, SERVE_LAYERS of
           its 16 layers (max_new 32):
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
           the card (decode's model; paged_llama_decode_forward, warmed up
           first; buckets
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
           bytes a step; one GET /trace/job from the driver while both
           workers run: both merged, none unreachable, each worker's clock
           offset and every span's error bound; after the recovery, with
           both workers paused at step 6, GET /health/job (both workers
           monitored, the job healthy, ELASTIC_SLO's slo_breach verdict
           among the history) and GET /timeseries/job (windows from both
           workers, one a second)
  recover_resnet   checkpointless recovery: elastic_resnet's model,
           batch and SGD stepped by hand (forward, loss, backward,
           tx.update) through DistributedGradientTransform(sharded_update,
           recovery=RecoveryAgent(mode="neighbor", every=1)), workers (this
           script with --recover-worker) under the ElasticDriver over gloo
           on the card, a TensorState committed every step.  Steps 1-3 at
           size 2; rank 1 SIGKILLed in the backward pass of step 4 after
           its step-3 frame reached rank 0; the job re-forms at size 2, the
           replacement rebuilds its ZeRO tile from the survivor
           (RecoveryAgent.rebuild, restore_dist_state), the weights and
           statistics sync from the survivor, steps 4-6.  Against an
           uninterrupted 2-rank run under the static launcher: the rebuilt
           frame is (epoch 0, step 3) and the commit the survivor
           restored, the tile the reference rank 1's bit for bit and not
           zero, steps 4-6 (losses, weights, statistics) bit for bit, GET
           recovery/stats lists the rebuild, the replacement's
           hvd_recovery_time_seconds counted it; the rebuild's ms, the
           frame's bytes against the priced tile and elastic_resnet's full
           sync, push ms a step, recover_s, step ms, peak memory
  hvd_run  hvd.run of a probe (an allreduce of a CUDA tensor of the rank)
           at np 2 over gloo on the card and at np 1 over NCCL, results in
           rank order; a failing function raises RuntimeError;
           TpuExecutor(np=2): a module-level counter across two run calls
           and run_remote/fetch
  estimator      TorchEstimator.fit of the MNIST convnet (MnistConfig's
           widths as an nn.Module) at np 2, gloo ranks on the card, batch
           64 a rank, 2 epochs of 1024 seeded images, SGD with momentum,
           cuDNN deterministic: the loss falls, the history and the fitted
           weights equal, bit for bit, the same fit run in this process
           rank by rank, the Store's checkpoint holds CPU tensors and
           reloads bit for bit, predict runs on the card
  adapters the TF/Keras adapters: without TensorFlow (the card's machine)
           a child interpreter imports horovod_tpu_torch, .torch and
           .estimator with no TensorFlow or Keras module loaded, and
           .tensorflow, .keras, .mxnet and KerasEstimator.fit (before any
           worker) each raise an ImportError naming the missing package
           and the port's torch path; with TensorFlow, 3 steps of
           tests/helpers_runner.py's tf_training_fn toy at world 1 on the
           card, eager and under jit_compile=True, within 1e-6 of the
           plain TF loop.  The line says which branch ran
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

decode's first batch and serve's traffic record their collectives:
none (serving must not go through the gradient plane).  The schedule
line sums up the armed steps (records, input bytes, the recorder's own
host ms, prims by axis, bucket ids).

Then three lines: the kernels summary (each kernel's contract numbers,
its TF/s, and for dq and dkv the flash backward operator's time as
library_pair_ms, since it gives both at once; the flash rows also carry
the bert case's numbers and train_bert's launches), the card's name and
power limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
The script imports no jax and nothing of horovod_tpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
    # a ring tile of train_tp2_sp2 (batch 2, 1024 / sp 2 tokens, 16 / tp 2
    # heads, 8 / 2 kv heads) through flash_attention_lse with a cotangent
    # on lse: the diagonal tile causal, a past one in full
    ("lse", (2, 512, 8, 4, 128, True)),
    ("lse_noncausal", (2, 512, 8, 4, 128, False)),
    # train_tp2_sp2's Ulysses attention (the whole 1024 tokens, 16 heads
    # / tp 2 / sp 2, 8 kv heads likewise) and train_moe_ep2's (2
    # sequences a rank at full width), both causal
    ("ulysses", (2, 1024, 4, 2, 128, True)),
    ("ep", (2, 1024, 16, 8, 128, True)),
    # bert_tp2_sp2's ring tile (batch 16, 512 / sp 2 tokens, 12 / tp 2
    # heads of 64), non-causal, through flash_attention_lse; and
    # train_fsdp_dp2's attention (4 sequences a rank at full width)
    ("lse_bert", (16, 256, 6, 6, 64, False)),
    ("fsdp", (4, 1024, 16, 8, 128, True)),
    # train_tp2_dp2_spec's attention: 2 sequences a dp rank, 16 / tp 2
    # heads, 8 / 2 kv heads, causal
    ("spec", (2, 1024, 8, 4, 128, True)),
]
# the model-parallel paths' cases, carried into each flash row of the
# summary
MP_CASES = ("lse", "lse_noncausal", "ulysses", "ep", "lse_bert", "fsdp",
            "spec")
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

# train_moe: bench.py's 1B widths with examples/llama_benchmark.py --moe 8
# (Mixtral-style top-2, capacity factor 1.25), depth cut to 4 layers
# (16 hold 6.71 B parameters, ~80.5 GB of fp32 weights, fp32 gradients
# and bf16 moments; 4 hold 1.728 B, ~20.7 GB); the last 2 layers are not
# rematerialized, so the forward runs 4 + 2 times a step
MOE_OVER = {"n_experts": 8, "expert_top_k": 2, "capacity_factor": 1.25}
MOE_LAYERS = 4
EXPECTED_MOE_LAUNCHES = {"fwd": 6, "dq": 4, "dkv": 4}
# parity_moe: parity's batch and widths at 2 MoE layers, card against CPU
# under parity's gates, with every token routed to all 8 experts (top-8,
# capacity factor 1: each expert has a slot for each token).  Top-2
# routing is not continuous in the router's bf16 logits: where the two
# sides round them otherwise, a token whose contested logits nearly tie
# goes to another expert.  The card runs at top-2 read, card/CPU: losses
# 10.9096/10.8960 then 6.580/6.492 (capacity factor 1.25), 10.9026/
# 10.8903 then 6.174/6.056 (factor 8), gradient cosines down to 0.76 and
# 0.94.  Top-8 runs the same router, dispatch, experts, combine and aux
# loss with a selection both sides agree on; parity_moe_route holds the
# top-2 selection itself
PARITY_MOE_OVER = {**MOE_OVER, "expert_top_k": 8, "capacity_factor": 1.0}
# parity_moe_route: parity_moe's weights and batch at top-2 (MOE_OVER),
# card against CPU at step 0, through layer 0 alone (1 of the 2 layers:
# every gate reads layer 0, whose weights and input the cut leaves as
# they were).  On one input, each side's router logit is
# the bf16 rounding of an fp32 sum of the same bf16 products in another
# order, so the two sides' logits lie within a bf16 step of each other,
# and a pick can change only where its two contested logits lie within
# ROUTE_TIE_STEPS bf16 steps (a step each way)
ROUTE_TIE_STEPS = 2
# train_tp2_sp2: four processes (--mp-rank) share the card over gloo as
# MeshConfig(sp=2, tp=2) with vocab_parallel, 2 layers at full width,
# global batch 2 x 1024, 3 steps with attn="ring", then 3 with "ulysses",
# against one process on the whole batch from the same weights: the first
# loss within MP_FIRST_REL, the later ones within MP_LATER_REL (the tp
# partial sums are rounded to bf16 before their all-reduce, once a row-
# parallel product, where one process rounds the whole sum once).  The
# first card run (H100, 700 W) read gaps of 1.2e-5 then up to 1.0e-3 as
# the loss fell from 10.9 to 1.36, ring and Ulysses alike: the gates sit
# 8x and 5x above them
MP_MESH = {"sp": 2, "tp": 2}
MP_BATCH = 2
MP_STEPS = 3
MP_FIRST_REL = 1e-4
MP_LATER_REL = 5e-3
MP_TIMEOUT_S = 420
# train_tp2_dp2_spec: four processes (--spec-rank) share the card over
# gloo as MeshConfig(dp=2, tp=2), the 1B widths at 2 layers with
# vocab_parallel off, SPEC_BATCH sequences of 1024 a dp rank, the weights
# from convert.llama_shard_params; the gradients as the model gives them
# into DistributedGradientTransform(adamw_lp(3e-4),
# param_specs=llama.param_specs(par, cfg), model_axes=()) (the tp ranks
# share one loss: tp is no batch axis, and every bucket sums over dp
# alone), built with explicit specs (sharded_update off) and inside `with
# pmesh.with_param_specs(specs):` (sharded_update on); 1 warm-up and 3
# timed steps each.  Against one
# process on the global batch of 4 from the same seed: the warm-up's
# reduced gradients by the parity rule (a x2 slip shows in the norms,
# where AdamW's normalized step would hide it), the global losses by
# train_tp2_sp2's gates, the updates after the 4 steps by the parity
# rule; the inner state's bytes exactly the spec plan's shards or tiles
SPEC_MESH = {"dp": 2, "tp": 2}
SPEC_BATCH = 2
SPEC_SEED = 4
SPEC_RUNS = (("explicit", False), ("context", True))
SPEC_STEPS = 3
EXPECTED_SPEC_LAUNCHES = {"fwd": 2, "dq": 2, "dkv": 2}
SPEC_TIMEOUT_S = 420
# train_moe_ep2: two processes (--ep-rank), MeshConfig(dp=2) with the 8
# experts aliased onto dp (4 a rank), 2 layers, batch 2 a rank, 3 steps,
# against one process on the batch of 4, at two capacity factors.  At
# 1.25 each rank's capacity (640 slots an expert for 2048 tokens) drops
# other and more picks than one process's (1280 for 4096): the first card
# run kept 0.85/0.92 of the picks against 0.95/0.98 at the first step and
# 0.63-0.80 against 0.68-0.87 once AdamW had sharpened the router, and
# the losses parted by 0.002, 0.16, 0.57.  So only the first loss (the
# same weights) is held there; at 8, where every pick has a slot on both
# sides, every loss is held, to tests/test_llama.py:88's 5e-2 (the first
# card run read gaps of 0.0005, 0.006, 0.011)
EP_BATCH = 2
EP_STEPS = 3
EP_LOSS_ATOL = 5e-2
EP_VARIANTS = (("cf1.25", {}), ("cf8", {"capacity_factor": 8.0}))
EP_TIMEOUT_S = 420

# train_pp2: two processes (--pp-rank) share the card over gloo as
# MeshConfig(pp=2): bench.py's 1B at its full 16 layers, 8 a stage, the
# batch of 8 x 1024 in PP_MICRO microbatches of 2, adamw_lp, 1 warm-up
# and 3 timed steps, against train's losses (one process, the same
# config, seed and batch).  A stage computes on its live ticks only, so
# it launches each of its layers' kernels once a microbatch (the last 2
# of its 8 layers not rematerialized: pp_launches).  The first card run
# (H100, 700 W) read gaps of 0 (the warm-up loss bit for bit: the
# microbatches' products round as the whole batch's), then 8.3e-6,
# 3.8e-5, 4.1e-5: the gates sit 10x above the largest
PP_MESH = {"pp": 2}
PP_MICRO = 4
PP_FIRST_REL = 1e-5
PP_LATER_REL = 4e-4
PP_TIMEOUT_S = 420
# bert_tp2_sp2: four processes (--bert-mp-rank) as MeshConfig(sp=2,
# tp=2): bert_base's widths (D 768, 12 heads of 64, d_ff 3072) cut to
# BERT_MP_LAYERS of its 12 layers (the script's time limit) at batch
# 16 x 512 (BERT's max_seq_len: a rank's ring tile is T 256 with 6
# heads), one forward and backward of the mean of h · c (a fixed
# cotangent c), against one process in bf16 and one in fp32 (the
# blockwise attention, HOROVOD_FLASH_ATTENTION=0).  The first card run
# (H100, 700 W) held the tp x sp gradients to the bf16 process by the
# parity rule and found q and k's gradients noise from layer 5 on: at
# random init the deep layers' attention is near uniform, so dS = P(dP -
# delta) is a small difference that the bf16 rounding of O and P
# dominates (cosines 0.975 at layer 5 down to -0.06 at layer 11 while the
# norms fell from 0.24 to 0.009; every v, o and MLP gradient at 0.9999).
# So each side is held to the fp32 process: the loss and every leaf's
# gradient must lie within BERT_MP_NOISE times the bf16 process's
# distance from fp32, or within BERT_MP_LOSS_REL / PARITY_NORM_REL of the
# fp32 value.  The second card run read the tp x sp gradients' distances
# at 0.59-1.11 times the bf16 process's (median 1.006), the loss's 0.80,
# at 12 layers
BERT_MP_MESH = {"sp": 2, "tp": 2}
BERT_MP_LAYERS = 2
BERT_MP_BATCH = (16, 512)
BERT_MP_LOSS_REL = 5e-3
BERT_MP_NOISE = 2.0
BERT_MP_TIMEOUT_S = 420
# train_fsdp_dp2: two processes (--fsdp-rank), make_llama_fsdp_step over
# dp 2: bench.py's 1B widths cut to FSDP_LAYERS layers (every layer is
# gathered twice a step through host memory), FSDP_BATCH sequences a
# rank, adamw_lp, FSDP_STEPS steps each without and with overlap, against
# one process on the whole batch: the first card run (H100, 700 W) read
# gaps of 8.8e-8, 1.2e-5, 1.2e-4 at 4 layers, the same bits with and
# without overlap, and the gates sit about 10x above them.  Cut to 2
# layers (the script's time limit) with the last FSDP_REMAT_SKIP not
# rematerialized, so the first still gathers its weights inside a
# checkpointed block and again in its recompute: its forward runs twice
# a step, the other's once
FSDP_MESH = {"dp": 2}
FSDP_LAYERS = 2
FSDP_REMAT_SKIP = 1
FSDP_BATCH = 4
FSDP_STEPS = 3
FSDP_FIRST_REL = 1e-6
FSDP_LATER_REL = 1e-3
EXPECTED_FSDP_LAUNCHES = {"fwd": 3, "dq": 2, "dkv": 2}
FSDP_TIMEOUT_S = 420
# serve_mp2: two processes (--serve-mp-rank), the 1B Llama's widths in
# bf16 cut to SERVE_MP_LAYERS of its 16 layers (the script's time limit),
# sharded over mp 2 (mp_llama_decode_forward), prompts of 1-64
# tokens in the seq-64 bucket, 16 new tokens; SERVE_MP_CALLS batches of
# (batch, calls): 8 requests, no warm-up (at 16 layers a call gathered
# 1.07 GB through host memory, ~3 s)
SERVE_MP_DEGREE = 2
SERVE_MP_LAYERS = 2
SERVE_MP_BATCHES = (1, 4)
SERVE_MP_SEQ = 64
SERVE_MP_NEW = 16
SERVE_MP_CALLS = ((1, 4), (4, 1))
SERVE_MP_MIN_REQUESTS = 8
SERVE_MP_TIMEOUT_S = 420

# train_hier_dp4: four processes (--hier-rank) share the card over gloo,
# laid out as two hosts of two (HOROVOD_LOCAL_SIZE=2, HOROVOD_CROSS_SIZE=2,
# ranks host by host), 2 layers at full width with fused_xent=True, batch
# 8 x 1024 split 2 a rank, 2 steps a variant; each variant's environment
# (on top of the layout) for hvd.init().  bounded and stale delay host 1's
# cross stage by HIER_DELAY_S on step 2's rounds, past the deadline.  The
# ranks are named host0 and host1 (HOROVOD_HOSTNAME).  HIER_TRACED runs a
# third step under the same delay, traced, in which host 1's ranks also
# start late, by HIER_STRAGGLE times their step 1 (at least HIER_DELAY_S):
# a straggler whose lateness outlasts the step's own reduction, whose
# segment of the critical path goes to whichever host's last collective
# ends last by a hair.  That step's spans, pulled from every rank with
# their clock probes, merge into one job trace whose critical path the
# phase reads; step 2's gates and the straggler scores (read after step
# 2) see the delay alone.  The first card runs read host 1's share of
# the gating time at 0.621 and 0.571 with a straggle of 1.5 step-times
# (host 0 charged the dispatch phase, 3.71 and 4.92 s): 2.0 widens the
# gate's margin, and read 0.657
HIER_DEADLINE_MS = 50
HIER_DELAY_S = 0.2
HIER_VARIANTS = (
    ("flat", {}),
    ("hier", {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}),
    ("hier_int8", {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                   "HOROVOD_COMPRESSION": "int8"}),
    ("bounded", {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                 "HOROVOD_TAIL_POLICY": "bounded",
                 "HOROVOD_TAIL_DEADLINE_MS": str(HIER_DEADLINE_MS)}),
    ("stale", {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
               "HOROVOD_TAIL_POLICY": "stale",
               "HOROVOD_TAIL_DEADLINE_MS": str(HIER_DEADLINE_MS),
               "HOROVOD_TAIL_MAX_STALENESS": "1"}),
)
# the variants whose cross stage a straggler policy bounds
HIER_LATE = ("bounded", "stale")
HIER_TRACED = "bounded"
HIER_STRAGGLE = 2.0
# the adasum variant: one step of DistributedOptimizer(SGD(lr), op=Adasum)
ADASUM_LR = 1e-3
# its gradient against the plain tree in fp64 on the four ranks' local
# gradients (193M fp32 entries): each fp32 dot product of the tree sums
# blockwise in cuBLAS, erring by ~log2(N)·2^-24 ≈ 1.7e-6 of its terms'
# magnitude, so each pair's coefficients err by ~1e-6 and the combined
# vector by ~1e-6 of its norm; the gate allows 1e-4 in norm
ADASUM_REL = 1e-4
# the four processes: the dp-1 reference, the eager sub-check and six
# variants, the kernels' build included
HIER_TIMEOUT_S = 600

# trace_dp: train_dp's step (the 1B at 16 layers, world 1 over NCCL, no
# cut) under HOROVOD_TRACE=0 and then under the default (on), TRACE_STEPS
# steps each from train's seed; then one step under hvd.start_profiler,
# its trace file under build/
TRACE_STEPS = 4
TRACE_PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "trace_dp_profile")
# the flash kernels' names, as the profiler's CUDA events carry them
FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "flash_dq_kernel",
                      "flash_dkv_kernel")

# health_dp: the health-armed transform on the 1B step.  HEALTH_STEPS clean
# updates with health on (the first HEALTH_OFF_STEPS against health off,
# bit for bit), then one under collective.corrupt scale:0 on bucket
# HEALTH_BUCKET: past the evaluator's warm-up of 5 observations, so its
# EWMA baseline is armed; the NaN run is one update from fresh weights
HEALTH_OFF_STEPS = 4
HEALTH_STEPS = 6
HEALTH_BUCKET = 3
HEALTH_BATCH = (8, 1024)

# train_dp_tools: train_dp's step under HOROVOD_TIMELINE (cycle marks on)
# and HOROVOD_AUTOTUNE, with a warm-up of 1 sample of 2 cycles: 6 steps
# give the warm-up and 2 samples (one cycle a step), then one step into a
# second timeline after stop_timeline()/start_timeline()
TOOLS_ENV = {"HOROVOD_TIMELINE": "build/timeline.json",
             "HOROVOD_TIMELINE_MARK_CYCLES": "1",
             "HOROVOD_AUTOTUNE": "1",
             "HOROVOD_AUTOTUNE_LOG": "build/autotune.csv",
             "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
             "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2"}
TOOLS_STEPS = 6
TOOLS_TIMELINE2 = "build/timeline2.json"
AUTOTUNE_HEADER = ("timestamp,fusion_threshold_bytes,cycle_time_ms,cache,"
                   "hierarchical,compression,score_bytes_per_sec,phase")

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
# the workers' time series (a window a second) and an SLO rule their own
# traffic breaches: the engine's cycle rate (hvd_engine_cycles_total: the
# gradients' allreduce, about one cycle a step) is at least one a window
# in any window a step ends in, against a ceiling of 0.1, and 0 while the
# workers wait at a pause, so the rule fires during steps 4-6 and
# recovers at the pause of step 6 (its verdict stays in the history, the
# job healthy again)
ELASTIC_TIMESERIES_S = 1
ELASTIC_SLO = "cycle_rate<=0.1@1w"
ELASTIC_HEALTH_WAIT_S = 15
# recover_resnet: elastic_resnet's model, batch and SGD as a ZeRO step
# (DistributedGradientTransform, sharded_update) with checkpointless
# recovery in neighbor mode at every boundary; steps 1-3 at size 2, rank
# 1 SIGKILLed in the backward pass of step 4, a replacement at size 2
# rebuilds its tile from the survivor, steps 4-6; against the static
# launcher's uninterrupted 2-rank run of steps 1-6.  Each rank's batch of
# a step is seeded by (step, rank).  Tile and weight digests are taken
# from step RECOVER_KILL_STEP - 1 on
RECOVER_STEPS = 6
RECOVER_KILL_STEP = 4
RECOVER_BATCH = 32
RECOVER_FORMED_SIZES = [2, 2]
RECOVER_TIMEOUT_S = 180
# native_core: the module hvd.init() loads from native/core.cpp (every
# control-plane object of a runtime on the core lives there); the
# decision's seeded token multisets at worlds 2, 4 and 8; the planners'
# host time a call as the median of this many calls
NATIVE_MODULE = "horovod_tpu_torch.native._hvd_core"
NATIVE_WORLDS = (2, 4, 8)
NATIVE_DECIDE_SEEDS = 50
NATIVE_TIMING_CALLS = 200
# estimator: TorchEstimator.fit at np 2 (gloo ranks on the card) of
# models/mnist.py's convnet as an nn.Module, batch 64 a rank, 2 epochs of
# ESTIMATOR_IMAGES seeded 28 x 28 images whose labels are the argmax of a
# seeded linear map of the pixels (a rule the net can learn), SGD with
# momentum; against the same fit in this process, rank by rank
ESTIMATOR_IMAGES = 1024
ESTIMATOR_BATCH = 64
ESTIMATOR_EPOCHS = 2
ESTIMATOR_LR = 0.05
ESTIMATOR_SEED = 0
ESTIMATOR_PREDICT_ROWS = 256
# adapters: the TF/Keras adapters' import rules where TensorFlow is absent
# (a child interpreter; the card's machine has no TensorFlow), else
# tests/helpers_runner.py tf_training_fn's toy at world 1 (3 steps, eager
# and under jit_compile=True) against the plain TF loop
ADAPTERS_TOL = 1e-6
ADAPTERS_STEPS = 3
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

# serving at the 1B widths, weights in bf16, SERVE_LAYERS of its 16 layers
# (the script's time limit): the buckets, new tokens and KV block
# (HOROVOD_SERVE_KV_BLOCK's default) of the decode and serve phases
SERVE_LAYERS = 4
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
# compound over the layers.  The logits of these random weights have unit
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
        dlse = None
        if case.startswith("lse"):
            # a cotangent on lse, folded into delta as _flash_bwd_bhtd does
            dlse = randn(B, H, T, dtype=torch.float32)
            delta = delta - dlse
        args = (q, k, v, do, ref_lse, delta, causal, scale)
        dq = fa._dq(*args)
        dk, dv = fa._dkv(*args)
        ref_dq = fa._dq_reference(*args)
        ref_dk, ref_dv = fa._dkv_reference(*args)
        torch.cuda.synchronize()
        lse_path = {}
        if dlse is not None:
            lse_path = lse_autograd_errors(fa, q, k, v, do, dlse, causal,
                                           scale, ref_out, ref_lse,
                                           (ref_dq, ref_dk, ref_dv))
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
            if lse_path:
                row["autograd"] = lse_path
            emit("kernels", **row)
            require(ok, f"{kernel} kernel disagrees with its plain version "
                        f"on {case}: {detail}")
            results[(case, kernel)] = row
        if lse_path:
            bad = lse_path_problems(lse_path)
            require(not bad, f"flash_attention_lse on {case}: {bad}")
        del q, k, v, do, ref_out, ref_lse, delta, args, runs
        torch.cuda.empty_cache()
    return results


def lse_autograd_errors(fa, q, k, v, do, dlse, causal, scale, ref_out,
                        ref_lse, ref_grads):
    """flash_attention_lse on the ``[B, T, H, D]`` views of q, k, v and its
    autograd with cotangents on both outputs (dO and dlse), against the
    plain results of the same inputs, delta folded: out and lse as
    absolute errors, dq, dk and dv relative to the largest plain entry."""
    t = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_lse(*t, causal=causal, sm_scale=scale)
    torch.autograd.backward([out, lse], [do.transpose(1, 2), dlse])
    torch.cuda.synchronize()
    got = [x.grad.transpose(1, 2) for x in t]
    return {"out_err": err(out.transpose(1, 2), ref_out),
            "lse_err": err(lse, ref_lse),
            **{f"{n}_rel": rel(g, r)
               for n, g, r in zip(("dq", "dk", "dv"), got, ref_grads)}}


def lse_path_problems(errors):
    """The flash gates on :func:`lse_autograd_errors`."""
    bad = []
    if errors["out_err"] > OUT_ATOL:
        bad.append(f"out off by {errors['out_err']}")
    if errors["lse_err"] > LSE_ATOL:
        bad.append(f"lse off by {errors['lse_err']}")
    bad += [f"{n} off by {errors[n]} of its largest entry"
            for n in ("dq_rel", "dk_rel", "dv_rel") if errors[n] > GRAD_REL]
    return bad


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
                engine=None, name=None, over=None, expected=None):
    """The 1B step (``train``), or with ``fused_xent=True``
    (``train_fused``), or under the runtime whose ``engine`` reduces the
    gradients (``train_dp``), or as phase ``name`` with the config's
    fields ``over`` and its ``expected`` launches a step (``train_moe``);
    returns the kernel launches of its timed steps and the line it
    emitted, with its profiled step's."""
    from horovod_tpu_torch.analysis import recorder
    phase = name or ("train_dp" if engine is not None else (
        "train_fused" if fused else "train"))
    cfg = bench_config(llama, fused_xent=fused, **(over or {}))
    batch, seq, steps = 8, 1024, 3
    expected = {**(expected or EXPECTED_LAUNCHES),
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
    schedule = None
    for i in range(steps):
        before = counts()
        stats0 = engine.stats() if engine is not None else None
        # under the engine the first timed step records its collectives
        armed = (recorder.recording() if engine is not None and i == 0
                 else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with armed as rec:
            params, opt_state, loss = ts.step_fn(params, opt_state, toks,
                                                 tgts)
        torch.cuda.synchronize()
        if rec is not None:
            schedule = schedule_row(rec)
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
                 "plane_device_ms": engine.device_ms(),
                 "schedule": schedule}
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
    if cfg.n_experts:
        row["moe_layer"] = moe_layer_ms(llama, cfg, params, toks, dev)
        emit(phase + "_layer", **row["moe_layer"])
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


def moe_layer_ms(llama, cfg, params, toks, dev):
    """Where one MoE layer's forward time goes at the step's N = batch x
    seq tokens: the router and top-k dispatch, the dispatch einsum, the
    experts' SwiGLU and the combine einsum, each in ms on the card
    (time_ms), with the einsums' and the experts' operations."""
    from horovod_tpu_torch.models import moe
    lp = {n: w.to(cfg.dtype) for n, w in params["layers"][0].items()}
    x = llama._embed_lookup(params["embed"], toks, cfg).detach()
    B, T, D = x.shape
    N, E, k = B * T, cfg.n_experts, cfg.expert_top_k
    C = int(math.ceil(k * N / E * cfg.capacity_factor))
    tokens = x.reshape(N, D)
    F = torch.nn.functional

    def route():
        gates = torch.softmax((tokens @ lp["router"]).float(), dim=-1)
        return moe._top_k_dispatch(gates, k, C)

    with torch.no_grad():
        dispatch, combine, _ = route()
        dispatch, combine = dispatch.to(x.dtype), combine.to(x.dtype)
        slots = torch.einsum("nec,nd->ecd", dispatch, tokens)

        def experts():
            gate = F.silu(torch.einsum("ecd,edf->ecf", slots,
                                       lp["we_gate"]))
            up = torch.einsum("ecd,edf->ecf", slots, lp["we_up"])
            return torch.einsum("ecf,efd->ecd", gate * up, lp["we_down"])

        out = experts()
        row = {"tokens": N, "capacity": C,
               "route_ms": time_ms(route, iters=5),
               "dispatch_ms": time_ms(lambda: torch.einsum(
                   "nec,nd->ecd", dispatch, tokens), iters=5),
               "experts_ms": time_ms(experts, iters=5),
               "combine_ms": time_ms(lambda: torch.einsum(
                   "ecd,nec->nd", out, combine), iters=5),
               "einsum_flops": 2 * N * E * C * D,
               "experts_flops": 3 * 2 * E * C * D * cfg.d_ff}
    del dispatch, combine, slots, out
    torch.cuda.empty_cache()
    return row


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

    from horovod_tpu_torch.analysis import recorder
    recorded = []

    def run(params, toks, tgts, record=False):
        ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                            device=dev)
        opt_state = ts.opt_init(params)
        for i in range(2):
            # at dp 2 the first step records its collectives
            armed = (recorder.recording() if record and i == 0
                     else contextlib.nullcontext())
            with armed as rec:
                params, opt_state, loss = ts.step_fn(params, opt_state,
                                                     toks, tgts)
                torch.cuda.synchronize()
            if rec is not None:
                recorded.append(schedule_row(rec))
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
    for step, (params, loss) in enumerate(run(params, toks, tgts,
                                              record=True)):
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
    schedules = hvd.allgather_object(recorded[0])
    native = hvd.allgather_object(native_objects(hvd))
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
        "first_leaves_submitted": orders, "schedule_ranks": schedules,
        "engine": engine, "native_objects": native,
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


def _run_pair(flag: str, timeout_s: float, world: int = 2,
              local_size: int = 0, script=None):
    """This script (or ``script``) with ``flag R`` in ``world`` processes
    (two by default) sharing the card over gloo, as hosts of
    ``local_size`` ranks each (default: one host), numbered host by host;
    returns rank 0's last line as JSON and the seconds taken."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    n_local = local_size or world
    for rank in range(world):
        env = dict(os.environ, HOROVOD_RANK=str(rank),
                   HOROVOD_SIZE=str(world),
                   HOROVOD_LOCAL_RANK=str(rank % n_local),
                   HOROVOD_LOCAL_SIZE=str(n_local),
                   HOROVOD_CROSS_RANK=str(rank // n_local),
                   HOROVOD_CROSS_SIZE=str(world // n_local),
                   HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                   HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                   HOROVOD_CONTROLLER="gloo",
                   HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="300")
        procs.append(subprocess.Popen(
            [sys.executable, str(script or __file__), flag, str(rank)],
            env=env,
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


def train_dp2_phase(dp_schedule):
    """Two ranks of :func:`dp2_child` on the card over gloo; the gates,
    the schedule's against ``dp_schedule`` (``train_dp``'s)."""
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
    ranks = [r["list"] for r in res["schedule_ranks"]]
    bad = dp2_schedule_problems(ranks, dp_schedule)
    require(not bad, f"train_dp2 schedule: {bad}")
    bad = native_object_problems("train_dp2", res["native_objects"])
    require(not bad, f"train_dp2: {bad}")
    SCHEDULE["train_dp2"] = dict(schedule_summary(
        res["schedule_ranks"][0]), ranks_identical=True)


def plain_adasum(rows):
    """The Adasum tree of ``rows`` in their order, written plainly (pairs
    (0, 1), (2, 3), ... a level, an odd last row carried up; a zero-norm
    side keeps coefficient 1), in the rows' dtype."""
    level = list(rows)
    while len(level) > 1:
        nxt = []
        for a, b in zip(level[0::2], level[1::2]):
            dot, na, nb = torch.dot(a, b), torch.dot(a, a), torch.dot(b, b)
            ca = 1.0 - dot / (2.0 * na) if na > 0 else 1.0
            cb = 1.0 - dot / (2.0 * nb) if nb > 0 else 1.0
            nxt.append(ca * a + cb * b)
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def _counter(name: str, **labels) -> float:
    """A metric family's value summed over the series matching
    ``labels``, from this process's ``metrics.snapshot()``."""
    from horovod_tpu_torch import metrics
    fam = metrics.snapshot().get("families", {}).get(name, {})
    return sum(x["value"] for x in fam.get("series", ())
               if all(x["labels"].get(k) == v for k, v in labels.items()))


def _with_env(env, fn):
    """``fn()`` with ``env`` set in os.environ, then unset."""
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k in env:
            os.environ.pop(k)


def hier_eager(hvd, rank: int, dev: torch.device) -> dict:
    """train_hier_dp4's eager sub-check on known tensors (multiples of
    1/4, so every sum is exact): the hierarchical allreduce (Sum,
    Average) and allgather, a stall (rank 3 submits 2 s late under a 1 s
    check time: rank 0's log must name it), then bounded and stale rounds
    with host 1 delayed past the deadline; returns each check's outcome
    and, on rank 0, the stall log."""
    import logging
    from horovod_tpu_torch import chaos

    def x(r, n=37):
        return ((torch.arange(n, device=dev) % 13 - 6 + r) / 4).float()

    def host(k, hosts=(0, 1)):
        return sum(k * x(r) for r in range(4) if r // 2 in hosts)

    hier = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
            "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}
    late = chaos.FaultSchedule.parse(
        f"collective.dcn group=1 action=delay:{HIER_DELAY_S}")
    checks, log = {}, []

    class Keep(logging.Handler):
        def emit(self, record):
            log.append(record.getMessage())

    def plain():
        hvd.init(device=dev)
        try:
            ps = hvd.runtime._get_global_process_set()
            checks["shape"] = ps.hier_shape() == (2, 2)
            checks["sum"] = torch.equal(
                hvd.allreduce(x(rank), op=hvd.Sum, name="e.sum"), host(1))
            checks["average"] = torch.equal(
                hvd.allreduce(x(rank), name="e.avg"), host(1) / 4)
            rows = x(rank, 6).view(3, 2) + 100 * rank
            checks["allgather"] = torch.equal(
                hvd.allgather(rows, name="e.ag"), torch.cat(
                    [x(r, 6).view(3, 2) + 100 * r for r in range(4)]))
            keep = Keep()
            logging.getLogger("horovod_tpu_torch").addHandler(keep)
            if rank == 3:
                time.sleep(2.0)
            checks["stall_completes"] = torch.equal(
                hvd.allreduce(torch.ones(2, device=dev), op=hvd.Sum,
                              name="e.stall"), torch.full((2,), 4.0,
                                                          device=dev))
            logging.getLogger("horovod_tpu_torch").removeHandler(keep)
        finally:
            hvd.shutdown()

    def tail(policy):
        hvd.init(device=dev)
        try:
            got = [hvd.allreduce(x(rank), op=hvd.Sum, name=f"e.{policy}")]
            chaos.install(late)
            try:
                for k in (2, 3):
                    got.append(hvd.allreduce(k * x(rank), op=hvd.Sum,
                                             name=f"e.{policy}"))
            finally:
                chaos.uninstall()
        finally:
            hvd.shutdown()
        # bounded: host 1 excluded twice, host 0's sum times n/k = 2;
        # stale (cap 1): host 1's first contribution substituted once,
        # then waited out at the cap
        want = ([host(1), 2 * host(2, (0,)), 2 * host(3, (0,))]
                if policy == "bounded" else
                [host(1), host(2, (0,)) + host(1, (1,)), host(3)])
        checks[policy] = all(torch.equal(g, w) for g, w in zip(got, want))

    _with_env(dict(hier, HOROVOD_STALL_CHECK_TIME_SECONDS="1"), plain)
    for policy in HIER_LATE:
        _with_env(dict(hier, HOROVOD_TAIL_POLICY=policy,
                       HOROVOD_TAIL_DEADLINE_MS=str(HIER_DEADLINE_MS),
                       HOROVOD_TAIL_MAX_STALENESS="1"),
                  lambda: tail(policy))
    if rank == 0:
        checks["stall_names_rank_3"] = any(
            "for ranks [3]" in m and "'e.stall'" in m for m in log)
    return {"checks": checks, "stall_log": log if rank == 0 else []}


def hier_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_hier_dp4`` (``--hier-rank``).  Rank 0 first runs
    the 2 steps at dp 1 on the whole batch without the runtime (the
    parity reference); then every rank runs the eager sub-check and, for
    each variant of HIER_VARIANTS, hvd.init() under the variant's
    environment and 2 steps on its 2 rows of the batch, rank 0's weights
    broadcast and held against this rank's after each step; then one step
    of DistributedOptimizer(op=Adasum), its applied gradient held on rank
    0 against plain_adasum in fp64 of the four ranks' local gradients.
    Rank 0 prints every run as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import chaos, tracing, training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_xent as fx
    from horovod_tpu_torch.ops.fusion import dtype_name
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    t_phase = time.perf_counter()
    os.environ["HOROVOD_HOSTNAME"] = f"host{rank // 2}"
    cfg = bench_config(llama, n_layers=2, fused_xent=True)
    rng = np.random.RandomState(2)
    batch = [torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                         (8, cfg.max_seq_len)),
                             dtype=torch.long, device=dev) for _ in range(2)]
    toks, tgts = (b[2 * rank:2 * (rank + 1)] for b in batch)

    def flat(params):
        return dict(zip(tree_paths(params), tree_leaves(params)))

    def counts():
        return {**fa.LAUNCHES, **fx.LAUNCHES}

    def identical(mine, tag):
        same = all([torch.equal(hvd.broadcast(mine[p].detach(), 0,
                                              name=f"{tag}.{p}"), mine[p])
                    for p in sorted(mine)])
        return all(hvd.allgather_object(same))

    # the dp-1 reference (rank 0): losses and the weights before and after
    # each step
    ref = None
    if rank == 0:
        ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                            device=dev)
        params = llama.init_params(cfg, seed=2, device=dev)
        opt_state = ts.opt_init(params)
        ref = {"weights": [{p: t.detach().clone()
                            for p, t in flat(params).items()}],
               "losses": []}
        for _ in range(2):
            params, opt_state, loss = ts.step_fn(params, opt_state, *batch)
            ref["losses"].append(loss.item())
            ref["weights"].append({p: t.detach().clone()
                                   for p, t in flat(params).items()})
        del params, opt_state, ts
        torch.cuda.empty_cache()

    def parity(mine, step):
        init, want = ref["weights"][0], ref["weights"][step + 1]
        return {"update_norms": {p: ((mine[p] - init[p]).double().norm()
                                     .item(), (want[p] - init[p]).double()
                                     .norm().item()) for p in init},
                "update_cos": {p: cosine(mine[p] - init[p],
                                         want[p] - init[p]) for p in init}}

    out = {"eager": hier_eager(hvd, rank, dev)}
    hier_step1 = None
    for name, env in HIER_VARIANTS:
        os.environ.update(env)
        hvd.init(device=dev)
        try:
            st = hvd.runtime._state()
            policy = env.get("HOROVOD_TAIL_POLICY", "strict")
            params = llama.init_params(cfg, seed=2, device=dev)
            ts = training.make_llama_train_step(
                cfg, optimizer=adamw_lp(3e-4), device=dev)
            opt_state = ts.opt_init(params)
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            fx.reset_launches()
            steps, scores = [], None
            for step in range(3 if name == HIER_TRACED else 2):
                n_rounds = len(collectives.TAIL_ROUNDS)
                counted0 = _counter("hvd_tail_rounds_total", policy=policy)
                wire0 = {f: _counter("hvd_wire_bytes_total", format=f)
                         for f in ("float32", "int8")}
                s0, c0 = st.engine.stats(), counts()
                traced = name == HIER_TRACED and step == 2
                if name in HIER_LATE and step >= 1:
                    chaos.install(chaos.FaultSchedule.parse(
                        f"collective.dcn group=1 action=delay:"
                        f"{HIER_DELAY_S}"))
                if traced:
                    tracing.buffer().clear()
                    if rank // 2 == 1:   # host 1 runs late
                        time.sleep(max(HIER_DELAY_S, HIER_STRAGGLE
                                       * steps[0]["ms"] / 1e3))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    params, opt_state, loss = ts.step_fn(params, opt_state,
                                                         toks, tgts)
                    torch.cuda.synchronize()
                finally:
                    chaos.uninstall()
                ms = 1e3 * (time.perf_counter() - t0)
                s1, c1 = st.engine.stats(), counts()
                workers = _pull_step_trace(hvd, rank) if traced else None
                mine = flat(params)
                rec = {
                    "loss": loss.item(), "ms": ms,
                    "launches": {k: c1[k] - c0[k] for k in c0},
                    "buckets": s1["buckets"] - s0["buckets"],
                    "payload_bytes": s1["bytes"] - s0["bytes"],
                    "wire_bytes": {f: _counter("hvd_wire_bytes_total",
                                               format=f) - v
                                   for f, v in wire0.items()},
                    "tail_rounds_counted": _counter(
                        "hvd_tail_rounds_total", policy=policy) - counted0,
                    "rounds": [{k: r[k] for k in ("excluded", "wait_s",
                                                  "seconds")}
                               for r in list(collectives.TAIL_ROUNDS)
                               [n_rounds:]],
                    "identical": identical(mine, f"{name}{step}")}
                if workers is not None:
                    rec["trace_workers"] = workers
                if step == 1:
                    scores = st.stall_inspector.straggler_scores()
                if rank == 0 and step < 2:
                    rec.update(parity(mine, step))
                    if step == 0 and name == "hier":
                        hier_step1 = {p: t.detach().clone()
                                      for p, t in mine.items()}
                    if step == 0 and name in HIER_LATE:
                        rec["equals_hier_step1"] = all(
                            torch.equal(mine[p], hier_step1[p])
                            for p in mine)
                steps.append(rec)
            out[name] = {
                "steps": steps,
                "straggler_scores": scores,
                "peak_bytes": hvd.allgather_object(
                    torch.cuda.max_memory_allocated())}
            del params, opt_state, ts
        finally:
            hvd.shutdown()
            for k in env:
                os.environ.pop(k)
        torch.cuda.empty_cache()

    # Adasum through the optimizer wrapper, over the whole vector; the
    # parity references are done with
    dp1_losses = ref["losses"] if ref is not None else None
    ref = hier_step1 = None
    torch.cuda.empty_cache()
    hvd.init(device=dev)
    try:
        params = llama.init_params(cfg, seed=2, device=dev)
        named = sorted(zip(tree_paths(params),
                           training.trainable_leaves(params)))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=ADASUM_LR),
            named_parameters=named, op=hvd.Adasum)
        order = sorted(range(len(named)),
                       key=lambda i: (dtype_name(named[i][1].dtype), i))
        fa.reset_launches()
        fx.reset_launches()
        c0 = counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = llama.loss_fn(params, toks, tgts, cfg)
        loss.backward()
        local = torch.cat([named[i][1].grad.reshape(-1) for i in order])
        opt.synchronize()
        applied = torch.cat([named[i][1].grad.reshape(-1) for i in order])
        with opt.skip_synchronize():
            opt.step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c1 = counts()
        rec = {"loss": loss.item(), "ms": ms,
               "launches": {k: c1[k] - c0[k] for k in c0},
               "identical": identical(flat(params), "adasum"),
               "numel": local.numel(),
               "peak_bytes": hvd.allgather_object(
                   torch.cuda.max_memory_allocated())}
        # each rank's local gradient to rank 0, one at a time, kept on
        # the host: the fp64 tree runs there, leaving the card's memory to
        # the four ranks
        rows = []
        for r in range(4):
            buf = local if r == rank else torch.empty_like(local)
            hvd.broadcast_(buf, r, name=f"adasum.local{r}")
            if rank == 0:
                rows.append(buf.cpu().double())
        if rank == 0:
            want = plain_adasum(rows)
            got = applied.cpu().double()
            rec["rel_err"] = ((got - want).norm() / want.norm()).item()
            rec["local_norms"] = [x.norm().item() for x in rows]
            rec["applied_norm"] = got.norm().item()
            del want, got
        del rows, local, applied, opt, params
        out["adasum"] = {"steps": [rec]}
        out["native_objects"] = hvd.allgather_object(native_objects(hvd))
    finally:
        hvd.shutdown()
    if rank:
        return 0
    out["dp1_losses"] = dp1_losses
    out["seconds_rank0"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return 0


def _pull_step_trace(hvd, rank):
    """Every rank's span buffer as it stands, pulled by rank 0 as the
    driver pulls a job trace: each rank serves a ``trace_pull`` handler
    (a probe answers its clock now; the pull, the snapshot taken here),
    and rank 0 probes each one's clock and pulls its spans
    (``tracing.merge.pull_worker``).  Returns ``{rank: (snapshot,
    offset_s, err_s)}`` on rank 0, else None."""
    from horovod_tpu_torch import tracing
    from horovod_tpu_torch.runner.rpc import JsonRpcServer
    snap = tracing.buffer().snapshot()

    def handle(payload):
        if payload.get("probe"):
            return {"now": tracing.now(), "host": snap["host"],
                    "process": snap["process"]}
        return dict(snap, now=tracing.now())

    srv = JsonRpcServer({"trace_pull": handle}, secret=None,
                        host="127.0.0.1")
    try:
        ports = hvd.allgather_object(srv.port)
        workers = None
        if rank == 0:
            workers = {str(r): tracing.merge.pull_worker(
                "127.0.0.1", port, probes=tracing.probes(), timeout=10.0,
                secret=None) for r, port in enumerate(ports)}
        hvd.allgather_object(True)   # every server lives until the pull
    finally:
        srv.close()
    return workers


def hier_trace(res):
    """Merge each traced step's pulled buffers (``trace_workers``) into one
    job trace and read its critical path; the pulled spans leave ``res``
    and the summary takes their place."""
    from horovod_tpu_torch import tracing
    for name in (HIER_TRACED,):
        for st in res.get(name, {}).get("steps", ()):
            workers = st.pop("trace_workers", None)
            if workers is None:
                continue
            trace = tracing.merge.chrome_trace(
                {w: tuple(v) for w, v in workers.items()})
            report = tracing.critical.analyze(trace)
            events = trace["traceEvents"]
            dcn = [e["args"] for e in events if e.get("cat") == "dcn"
                   and e.get("ph") == "X"]
            st["trace"] = {
                "hosts": trace["otherData"]["hosts"],
                "pids": sorted({e["pid"] for e in events
                                if e.get("name") == "process_name"}),
                "clock": trace["otherData"]["clock"],
                "spans": sum(1 for e in events if e.get("ph") == "X"),
                "dcn_spans": len(dcn),
                "dcn_excluded": sorted({tuple(a["excluded"]) for a in dcn}),
                "rounds": report["rounds"], "top": report["top"],
                "gating": {h: {"fraction": v["fraction"],
                               "phases": v["phases"]}
                           for h, v in report["hosts"].items()}}


def hier_trace_problems(res):
    """train_hier_dp4's trace gates, on HIER_TRACED's step 3: one pid a
    host (two hosts), every dcn span with host 1 excluded, and host 1
    (which the phase delays) the top gating host of the step's rounds."""
    bad = []
    for name in (HIER_TRACED,):
        traced = [st["trace"] for st in res[name]["steps"] if "trace" in st]
        if not traced:
            bad.append(f"{name}: step 3 was not traced")
        for tr_ in traced:
            if tr_["hosts"] != ["host0", "host1"] or len(tr_["pids"]) != 2:
                bad.append(f"{name}: hosts {tr_['hosts']}, pids "
                           f"{tr_['pids']}")
            if not tr_["dcn_spans"] or tr_["dcn_excluded"] != [(1,)]:
                bad.append(f"{name}: {tr_['dcn_spans']} dcn spans, "
                           f"excluded {tr_['dcn_excluded']}")
            if not tr_["top"] or tr_["top"][0] != "host1":
                bad.append(f"{name}: top gating host {tr_['top']}, not "
                           f"host1")
    return bad


def hier_problems(res):
    """``train_hier_dp4``'s gates: the eager sub-check; after every step of
    every variant the four ranks' weights identical and the launches of
    the 2-layer model; flat, hier and step 1 of bounded and stale within
    the parity gates of the dp-1 run, hier_int8 within A5_WIRE_*; bounded's
    step 1 bit for bit hier's; on the hierarchical path one tail round
    counted per bucket; step 2 of bounded and stale with host 1 excluded
    from every round, each waiting at least the deadline, finite losses,
    and host 1's ranks scoring above host 0's; Adasum's applied gradient
    within ADASUM_REL of the plain tree."""
    bad = [f"eager: {k} failed" for k, ok in
           res["eager"]["checks"].items() if not ok]
    dp1 = res["dp1_losses"]
    for name in [v for v, _ in HIER_VARIANTS] + ["adasum"]:
        run = res[name]
        for i, st in enumerate(run["steps"]):
            if not st["identical"]:
                bad.append(f"{name}: the ranks' weights differ after step "
                           f"{i + 1}")
            if st["launches"] != EXPECTED_DP2_LAUNCHES:
                bad.append(f"{name}: launches per step {st['launches']}, "
                           f"expected {EXPECTED_DP2_LAUNCHES}")
        if name == "adasum":
            err = run["steps"][0].get("rel_err", float("inf"))
            if not err <= ADASUM_REL:
                bad.append(f"adasum: applied gradient {err} from the plain "
                           f"tree in norm (> {ADASUM_REL})")
            continue
        wire = name == "hier_int8"
        loss_rel, norm_rel, min_cos = (
            (A5_WIRE_LOSS_REL, A5_WIRE_NORM_REL, A5_WIRE_COS) if wire
            else (PARITY_LOSS_REL, PARITY_NORM_REL, PARITY_COS))
        gated = run["steps"][:1] if name in HIER_LATE else run["steps"]
        for i, st in enumerate(gated):
            if not abs(st["loss"] - dp1[i]) <= loss_rel * abs(dp1[i]):
                bad.append(f"{name}: loss {st['loss']} (dp 4) vs {dp1[i]} "
                           f"(dp 1) at step {i + 1}")
        last = gated[-1]
        for p, (a, b) in last["update_norms"].items():
            if not abs(a - b) <= norm_rel * b:
                bad.append(f"{name}: update norm {p}: {a} vs {b}")
            if not last["update_cos"][p] > min_cos:
                bad.append(f"{name}: update cos {p}: "
                           f"{last['update_cos'][p]}")
        for i, st in enumerate(run["steps"]):
            want = st["buckets"] if name != "flat" else 0
            if st["tail_rounds_counted"] != want or len(st["rounds"]) != \
                    want:
                bad.append(f"{name}: step {i + 1} counted "
                           f"{st['tail_rounds_counted']} tail rounds "
                           f"({len(st['rounds'])} recorded) for {want} "
                           f"hierarchical buckets")
        if name not in HIER_LATE:
            continue
        if name == "bounded" and not run["steps"][0].get(
                "equals_hier_step1"):
            bad.append("bounded: step 1 (every host on time) is not hier's "
                       "step 1 bit for bit")
        second = run["steps"][1]
        if not math.isfinite(second["loss"]):
            bad.append(f"{name}: step 2 loss {second['loss']}")
        for r in second["rounds"]:
            if r["excluded"] != [1] or r["seconds"] < \
                    HIER_DEADLINE_MS / 1000:
                bad.append(f"{name}: step 2 round {r}: host 1 not excluded "
                           f"past the deadline")
        sc = {int(k): v for k, v in run["straggler_scores"].items()}
        if not min(sc.get(2, 0), sc.get(3, 0)) > max(sc.get(0, 0),
                                                      sc.get(1, 0)):
            bad.append(f"{name}: straggler scores {sc}: host 1's ranks "
                       f"(2, 3) not above host 0's")
    return bad


def train_hier_dp4_phase():
    """Four ranks of :func:`hier_child` on the card over gloo as two hosts
    of two; the gates."""
    # the four ranks share the card with this process's own memory
    torch.cuda.empty_cache()
    parent = {"allocated": torch.cuda.memory_allocated(),
              "reserved": torch.cuda.memory_reserved()}
    res, seconds = _run_pair("--hier-rank", HIER_TIMEOUT_S, world=4,
                             local_size=2)
    hier_trace(res)
    emit("train_hier_dp4", layers=2, batch=[2, 2, 2, 2], seq=1024,
         fused_xent=True, backend="gloo", hosts=[[0, 1], [2, 3]],
         seconds=seconds, parent_bytes=parent, **res)
    bad = (hier_problems(res) + hier_trace_problems(res)
           + native_object_problems("train_hier_dp4", res["native_objects"]))
    require(not bad, f"train_hier_dp4: {bad}")


def _lanes(events):
    """{tensor name: [names of its lane's begin and instant events]}."""
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M"}
    out = {name: [] for name in lanes.values()}
    for e in events:
        if e.get("ph") in ("B", "i") and e["tid"] in lanes:
            out[lanes[e["tid"]]].append(e["name"])
    return out


def trace_dp_phase(hvd, llama, training, adamw_lp, dev):
    """``trace_dp``: train_dp's step with the tracer off, then on; each
    step's spans by category, the engine's cycles, plans and buckets,
    the step ms and engine host ms, the ring's drop count; then, with the
    tracer on, one step under ``hvd.start_profiler``, whose trace file's
    ``hvd.allreduce[...]`` ranges and flash kernels are counted.  Returns
    the emitted line."""
    from horovod_tpu_torch import tracing
    cfg = bench_config(llama)
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (8, 1024)),
                           dtype=torch.long, device=dev)
    tgts = torch.as_tensor(rng.randint(0, cfg.vocab_size, (8, 1024)),
                           dtype=torch.long, device=dev)
    row = {}
    for mode, env in (("off", {"HOROVOD_TRACE": "0"}), ("on", {})):
        os.environ.update(env)
        hvd.init(device=dev)
        try:
            engine = hvd.runtime._state().engine
            ts = training.make_llama_train_step(
                cfg, optimizer=adamw_lp(3e-4), device=dev)
            params, opt_state = ts.init_fn(0)
            run = {"active": tracing.ACTIVE, "losses": [], "step_ms": [],
                   "engine_host_ms": [], "spans": [], "engine": []}
            for _ in range(TRACE_STEPS):
                tracing.buffer().clear()
                s0 = engine.stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, loss = ts.step_fn(params, opt_state,
                                                     toks, tgts)
                torch.cuda.synchronize()
                run["step_ms"].append(1e3 * (time.perf_counter() - t0))
                run["losses"].append(loss.item())
                s1 = engine.stats()
                counts = {k: s1[k] - s0[k]
                          for k in ("cycles", "executes", "buckets")}
                # the cycle span closes as its cycle returns, just after
                # the handles resolve
                deadline = time.monotonic() + 5
                while tracing.ACTIVE and time.monotonic() < deadline and \
                        _span_counts(tracing)["cycle"] < counts["cycles"]:
                    time.sleep(0.005)
                run["engine_host_ms"].append(s1["dispatch_ms"]
                                             - s0["dispatch_ms"])
                run["spans"].append(_span_counts(tracing))
                run["engine"].append(counts)
            run["dropped"] = tracing.buffer().snapshot()["dropped"]
            if tracing.ACTIVE:
                b0 = engine.stats()["buckets"]
                hvd.start_profiler(TRACE_PROFILE_DIR)
                ts.step_fn(params, opt_state, toks, tgts)
                torch.cuda.synchronize()
                path = hvd.stop_profiler()
                run["profile"] = _profile_counts(path)
                run["profile"]["buckets"] = engine.stats()["buckets"] - b0
            del params, opt_state, ts
        finally:
            hvd.shutdown()
            for k in env:
                os.environ.pop(k)
        torch.cuda.empty_cache()
        row[mode] = run
    emit("trace_dp", layers=cfg.n_layers, batch=8, seq=1024, **row)
    return row


def _span_counts(tracing) -> dict:
    """The default buffer's spans by category."""
    out = {c: 0 for c in ("cycle", "submit", "negotiate", "fuse",
                          "dispatch", "dcn", "overlap")}
    for sp in tracing.buffer().snapshot()["spans"]:
        out[sp["cat"]] = out.get(sp["cat"], 0) + 1
    return out


def _profile_counts(path) -> dict:
    """A ``stop_profiler`` trace file's host ranges of the engine's
    dispatches and its flash kernels, counted."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sum(1 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("hvd.allreduce["))
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel"
                      and k in str(e.get("name", "")))
               for k in FLASH_KERNEL_NAMES}
    return {"file": path, "bytes": os.path.getsize(path),
            "dispatch_ranges": ranges, "flash_kernels": kernels}


def trace_problems(row, ref_losses):
    """trace_dp's gates: both runs' losses ``ref_losses`` (train_dp's) bit
    for bit; off, no span; on, a step's dispatch spans the buckets it
    dispatched, its fuse and cycle spans the engine's plans and cycles,
    nothing dropped; the profiled step's file one dispatch range a bucket
    and the three flash kernels among its CUDA events."""
    bad = []
    for mode, run in row.items():
        if run["losses"] != ref_losses:
            bad.append(f"{mode}: losses {run['losses']} are not train_dp's "
                       f"{ref_losses}")
    off, on = row["off"], row["on"]
    if off["active"] or any(sum(st.values()) for st in off["spans"]):
        bad.append(f"off: spans recorded under HOROVOD_TRACE=0: "
                   f"{off['spans']}")
    if not on["active"]:
        bad.append("on: the tracer is off by default")
    for i, (st, n) in enumerate(zip(on["spans"], on["engine"])):
        want = {"dispatch": n["buckets"], "fuse": n["executes"],
                "cycle": n["cycles"], "submit": n["executes"]}
        if any(st[k] != v for k, v in want.items()) or not n["buckets"]:
            bad.append(f"on: step {i + 1} spans {st}, the engine's {n}")
    if on["dropped"]:
        bad.append(f"on: {on['dropped']} spans dropped")
    prof = on.get("profile") or {}
    if not prof or prof["dispatch_ranges"] != prof["buckets"] or \
            not prof["buckets"]:
        bad.append(f"profile: {prof.get('dispatch_ranges')} dispatch ranges "
                   f"for {prof.get('buckets')} buckets")
    if prof and not all(prof["flash_kernels"].values()):
        bad.append(f"profile: flash kernels {prof['flash_kernels']}")
    return bad


def tools_phase(hvd, fa, fx, llama, training, adamw_lp, dev):
    """``train_dp_tools``: train_dp's step at world 1 over NCCL under the
    runtime that TOOLS_ENV configured: TOOLS_STEPS steps with their losses,
    step ms, engine host ms and launches, then the timeline closed and a
    second one opened for one more step; returns the emitted line, with
    the timelines' lanes and the autotune log read back."""
    cfg = bench_config(llama)
    ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                        device=dev)
    params, opt_state = ts.init_fn(0)
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (8, 1024)),
                           dtype=torch.long, device=dev)
    tgts = torch.as_tensor(rng.randint(0, cfg.vocab_size, (8, 1024)),
                           dtype=torch.long, device=dev)
    engine = hvd.runtime._state().engine
    losses, step_ms, host_ms, per_step = [], [], [], []
    fa.reset_launches()
    fx.reset_launches()
    for _ in range(TOOLS_STEPS):
        s0, c0 = engine.stats(), {**fa.LAUNCHES, **fx.LAUNCHES}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = ts.step_fn(params, opt_state, toks, tgts)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        s1, c1 = engine.stats(), {**fa.LAUNCHES, **fx.LAUNCHES}
        host_ms.append(s1["dispatch_ms"] - s0["dispatch_ms"])
        per_step.append({k: c1[k] - c0[k] for k in c0})
    autotune = engine.stats()["autotune"]
    hvd.stop_timeline()
    hvd.start_timeline(TOOLS_TIMELINE2, mark_cycles=True)
    ts.step_fn(params, opt_state, toks, tgts)
    torch.cuda.synchronize()
    hvd.stop_timeline()
    from horovod_tpu_torch.tree import tree_paths
    grads = [f"grad.{p}" for p in tree_paths(params)]   # sum_scaled_'s names
    del params, opt_state, ts
    torch.cuda.empty_cache()
    timelines = []
    for path in (TOOLS_ENV["HOROVOD_TIMELINE"], TOOLS_TIMELINE2):
        with open(path) as f:
            timelines.append(json.load(f))
    with open(TOOLS_ENV["HOROVOD_AUTOTUNE_LOG"]) as f:
        log = f.read().strip().splitlines()
    row = dict(steps=TOOLS_STEPS, losses=losses, step_ms=step_ms,
               engine_host_ms=host_ms, launches_per_step=per_step,
               autotune=autotune, autotune_log=log,
               timeline_events=[len(t) for t in timelines],
               cycle_marks=[sum(1 for e in t if e["name"] == "CYCLE_START")
                            for t in timelines])
    emit("train_dp_tools", **row)
    row["lanes"] = [_lanes(t) for t in timelines]
    row["tensors"] = grads + ["loss"]
    return row


def tools_problems(row, train_row, expected):
    """``train_dp_tools``' gates: ``train``'s losses bit for bit (averaging
    at world 1 is exact whatever the buckets); the launches; every
    gradient tensor's lane holding a NEGOTIATE_ALLREDUCE span, an
    ALLREDUCE activity and a DONE mark a step, in the first timeline for
    the steps before stop_timeline() and in the second for the step after
    start_timeline() (no event lost across the two), with the cycle
    marks; the autotune log's header and at least 2 sample rows."""
    bad = []
    n = min(len(train_row["losses"]), len(row["losses"]))
    if row["losses"][:n] != train_row["losses"][:n]:
        bad.append(f"losses {row['losses'][:n]} are not train's "
                   f"{train_row['losses'][:n]}")
    bad += [f"launches per step {st}, expected {expected}"
            for st in row["launches_per_step"] if st != expected]
    for lanes, marks, steps in zip(row["lanes"], row["cycle_marks"],
                                   (row["steps"], 1)):
        for name in row["tensors"]:
            ev = lanes.get(name, [])
            for kind in ("NEGOTIATE_ALLREDUCE", "ALLREDUCE", "DONE"):
                if ev.count(kind) != steps:
                    bad.append(f"timeline: {name} has {ev.count(kind)} "
                               f"{kind} for {steps} steps")
        if marks < steps:
            bad.append(f"timeline: {marks} cycle marks for {steps} steps")
    log = row["autotune_log"]
    if not log or log[0] != AUTOTUNE_HEADER:
        bad.append(f"autotune log header {log[:1]}")
    if sum(1 for line in log[1:] if line.endswith(",sample")) < 2:
        bad.append(f"autotune log has fewer than 2 sample rows: {log}")
    return bad


# ------------------------------------------------ the schedule recorder

#: each armed phase's summary: the ``schedule`` line
SCHEDULE = {}


def schedule_row(rec):
    """One armed step's records (``analysis/recorder.py``, path erased),
    their count, their input bytes and the recorder's own host ms."""
    from horovod_tpu_torch.analysis.wire import aval_nbytes
    recs = [{k: r[k] for k in ("prim", "axes", "inputs", "outputs",
                               "bucket", "params")} for r in rec.records]
    return {"records": len(recs),
            "bytes": sum(aval_nbytes(a) for r in recs for a in r["inputs"]),
            "host_ms": 1e3 * rec.host_s, "list": recs}


def schedule_summary(row):
    """A schedule row for the ``schedule`` line: counts, not records."""
    prims = {}
    for r in row["list"]:
        key = f"{r['prim']}@{'+'.join(r['axes'])}"
        prims[key] = prims.get(key, 0) + 1
    return {"records": row["records"], "bytes": row["bytes"],
            "host_ms": row["host_ms"], "prims": prims,
            "buckets": [r["bucket"] for r in row["list"]]}


def _prims_axes(recs):
    return sorted({(r["prim"], tuple(r["axes"])) for r in recs})


def dp_schedule_problems(row, plane):
    """``train_dp``'s gates: one record a bucket of the step's gradient
    plane (``plane``: its engine stats), each a psum over ``workers``,
    bucket ids 0..n-1 in issue order, the input bytes the plane's."""
    bad = []
    recs = row["list"]
    if row["records"] != plane["buckets"] or not recs:
        bad.append(f"{row['records']} records for the plane's "
                   f"{plane['buckets']} buckets")
    if _prims_axes(recs) not in ([("psum", ("workers",))], []):
        bad.append(f"records other than a psum over workers: "
                   f"{_prims_axes(recs)}")
    if [r["bucket"] for r in recs] != list(range(len(recs))):
        bad.append(f"bucket ids {[r['bucket'] for r in recs]} are not "
                   f"0..{len(recs) - 1} in issue order")
    if row["bytes"] != plane["bytes"]:
        bad.append(f"input bytes {row['bytes']}, the plane's gradient "
                   f"bytes {plane['bytes']}")
    return bad


def ranks_schedule_problems(ranks):
    """Every rank's full records (shapes included) rank 0's."""
    return [f"rank {i} recorded another schedule than rank 0 "
            f"({len(r)} vs {len(ranks[0])} records)"
            for i, r in enumerate(ranks[1:], start=1) if r != ranks[0]]


def dp2_schedule_problems(ranks, dp_row):
    """``train_dp2``'s gates: both ranks' schedules identical; shapes
    erased, the prims, axes and bucket sequence of ``train_dp``'s (the
    depth changes the bucket count only)."""
    bad = ranks_schedule_problems(ranks)
    recs = ranks[0]
    if not recs:
        bad.append("no records")
    if _prims_axes(recs) != _prims_axes(dp_row["list"]):
        bad.append(f"prims and axes {_prims_axes(recs)}, train_dp's "
                   f"{_prims_axes(dp_row['list'])}")
    if [r["bucket"] for r in recs] != list(range(len(recs))):
        bad.append(f"bucket ids {[r['bucket'] for r in recs]} are not "
                   f"0..{len(recs) - 1} in issue order")
    return bad


def serve_mp_schedule_problems(ranks):
    """``serve_mp2``'s gates: both ranks' schedules identical, the weights'
    all-gathers over the mp group; returns the problems and the other
    prims (ROADMAP §C names them)."""
    bad = ranks_schedule_problems(ranks)
    recs = ranks[0]
    gathers = [r for r in recs if r["prim"] == "all_gather"]
    if not gathers:
        bad.append("no all_gather recorded")
    if any(r["axes"] != ["hvd_serve_mp"] for r in gathers):
        bad.append(f"all_gathers over {_prims_axes(gathers)}")
    others = _prims_axes([r for r in recs if r["prim"] != "all_gather"])
    return bad, others


def health_dp_phase(hvd, fa, llama, training, adamw_lp, dev, over=None,
                    batch=HEALTH_BATCH, profile=True):
    """``health_dp``: the 1B step's gradients (``llama.loss_fn``, then
    ``torch.autograd.grad``) through ``DistributedGradientTransform(
    adamw_lp(3e-4), health=..., health_check_every=1)`` and ``tx.update``
    under ``hvd.init()`` at world 1: health off for HEALTH_OFF_STEPS
    updates, then on for HEALTH_STEPS clean ones and one under a
    ``collective.corrupt`` ``scale:0`` rule on bucket HEALTH_BUCKET, then
    one update under ``nan:0`` on it from fresh weights, each run with an
    evaluator of its own.  Returns the emitted line: losses, verdicts,
    launches a step, the buckets' names and the ones
    ``hvd_health_grad_norm`` holds, and the cost off and on (step ms, a
    profiled step's busy ms and idle share, the taps' device ms and the
    host ms of their delivery).  ``over`` changes the config's fields and
    ``profile`` False skips the profiled steps (the CPU rehearsal)."""
    from horovod_tpu_torch import chaos, health, metrics
    from horovod_tpu_torch.health import taps as htaps
    from horovod_tpu_torch.tree import tree_map
    cfg = bench_config(llama, **(over or {}))
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, batch),
                           dtype=torch.long, device=dev)
    tgts = torch.as_tensor(rng.randint(0, cfg.vocab_size, batch),
                           dtype=torch.long, device=dev)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run(armed: bool, steps: int, rule=None, rule_step=None,
            prof=False):
        """``steps`` updates from the seed-0 weights with the taps
        ``armed``, ``rule`` installed for update ``rule_step`` (1-based);
        ``prof`` profiles one more clean update."""
        ev = health.HealthEvaluator()
        old = health.swap_evaluator(ev)
        params = llama.init_params(cfg, 0, device=dev)
        leaves = training.trainable_leaves(params)
        tx = hvd.DistributedGradientTransform(
            adamw_lp(3e-4), health=armed, health_check_every=1)
        state = tx.init(params)

        def update():
            loss = llama.loss_fn(params, toks, tgts, cfg)
            g = iter(torch.autograd.grad(loss, leaves))
            tx.update(tree_map(lambda _: next(g), params), state, params)
            return loss.detach()

        out = {"losses": [], "step_ms": [], "launches_per_step": [],
               "emit_host_ms": []}
        try:
            for i in range(1, steps + 1):
                sched = None
                if rule is not None and i == rule_step:
                    sched = chaos.FaultSchedule.parse(rule, seed=7)
                    chaos.install(sched)
                before = dict(fa.LAUNCHES)
                sync()
                t0 = time.perf_counter()
                try:
                    loss = update()
                    sync()
                finally:
                    if sched is not None:
                        chaos.uninstall()
                out["step_ms"].append(1e3 * (time.perf_counter() - t0))
                out["losses"].append(loss.item())
                out["launches_per_step"].append(
                    {k: fa.LAUNCHES[k] - before[k] for k in before})
                if armed:
                    out["emit_host_ms"].append(
                        htaps.LAST_EMIT.get("emit_host_ms"))
                if sched is not None:
                    out["rule_fired"] = bool(
                        sched.fired_at("collective.corrupt"))
            if prof:
                out["profile"] = profile_step(update)
        finally:
            health.swap_evaluator(old)
        out["verdicts"] = [{k: v[k] for k in ("kind", "worker", "bucket",
                                              "step", "detail")}
                           for v in ev.verdicts()]
        out["buckets"] = {str(d["bucket"]): name for name, d in
                          ev.snapshot()["buckets"].items()}
        del params, state, tx, leaves
        if cuda:
            torch.cuda.empty_cache()
        return out

    def grad_norms():
        """Worker 0's ``hvd_health_grad_norm`` gauges by bucket name."""
        fam = metrics.registry().to_dict().get("hvd_health_grad_norm")
        return {x["labels"]["bucket"]: x["value"]
                for x in (fam or {"series": []})["series"]
                if x["labels"]["worker"] == "0"}

    row = {"layers": cfg.n_layers, "batch": list(batch),
           "bucket": HEALTH_BUCKET}
    hvd.init(device=dev)
    try:
        row["off"] = run(False, HEALTH_OFF_STEPS, prof=profile)
        # the registry is the process's: only gauges this run set count
        # (an earlier run in the process may have left series behind)
        before = grad_norms()
        fa.reset_launches()   # the path's run starts here
        row["on"] = run(True, HEALTH_STEPS + 1,
                        rule=f"collective.corrupt bucket={HEALTH_BUCKET} "
                             f"nth=1 action=scale:0",
                        rule_step=HEALTH_STEPS + 1, prof=profile)
        row["launches"] = dict(fa.LAUNCHES)   # ... and ends here
        row["grad_norm_buckets"] = sorted(
            b for b, v in grad_norms().items() if before.get(b) != v)
        row["nan"] = run(True, 1,
                         rule=f"collective.corrupt bucket={HEALTH_BUCKET} "
                              f"nth=1 action=nan:0", rule_step=1)
    finally:
        hvd.shutdown()
    if profile:
        for mode in ("off", "on"):
            p = row[mode]["profile"]
            row[mode]["profile"] = {
                k: p[k] for k in ("wall_ms", "device_busy_ms",
                                  "device_idle_share")}
            row[mode]["profile"]["taps_device_ms"] = p["annotated_ms"].get(
                htaps.TAPS_RANGE)
    emit("health_dp", **row)
    return row


def health_problems(row, expected):
    """``health_dp``'s gates: the clean updates' losses with health on
    those with it off bit for bit, finite, falling; no verdict before the
    scale rule's update, and then one ``grad_explosion`` on
    HEALTH_BUCKET's name at that step, worker 0; the NaN run's
    ``nonfinite`` verdict on worker 0, the bucket and step 1; each rule
    fired; ``hvd_health_grad_norm`` set for every bucket's name (worker
    0); the flash launches of every update of the armed run
    ``expected``."""
    bad = []
    off, on, nan = row["off"], row["on"], row["nan"]
    n = len(off["losses"])
    if on["losses"][:n] != off["losses"]:
        bad.append(f"losses with health on {on['losses'][:n]} are not "
                   f"those with it off {off['losses']} bit for bit")
    clean = on["losses"][:-1]
    if not all(math.isfinite(x) for x in clean) or \
            not clean[-1] < clean[0]:
        bad.append(f"clean losses {clean} not finite and falling")
    last = len(on["losses"])
    early = [v for v in on["verdicts"] if v["step"] < last]
    if early:
        bad.append(f"verdicts on clean updates: {early}")
    name = on["buckets"].get(str(row["bucket"]))
    if name is None:
        bad.append(f"no bucket {row['bucket']} among {on['buckets']}")
    for run, kind, step in ((on, "grad_explosion", last), (nan, "nonfinite",
                                                           1)):
        hits = [v for v in run["verdicts"] if v["kind"] == kind
                and v["worker"] == 0 and v["bucket"] == row["bucket"]
                and v["step"] == step and name is not None
                and f"({name})" in v["detail"]]
        if not hits:
            bad.append(f"no {kind} verdict naming worker 0, bucket "
                       f"{row['bucket']} ({name}) and step {step}: "
                       f"{run['verdicts']}")
        if not run.get("rule_fired"):
            bad.append(f"the {kind} run's chaos rule never fired")
    missing = set(on["buckets"].values()) - set(row["grad_norm_buckets"])
    if missing or not on["buckets"]:
        bad.append(f"hvd_health_grad_norm lacks buckets {sorted(missing)} "
                   f"of {len(on['buckets'])}")
    bad += [f"launches per step {st}, expected {expected}"
            for st in on["launches_per_step"] if st != expected]
    return bad


def ring_launches(sp_index: int, sp: int, layers: int, causal=True):
    """Flash launches a step of one rank of the ring with no layer
    rematerialized: one tile a layer for each k/v block it attends to
    (its own, causal, and the i earlier ones in full; every block when
    not causal), each a forward and a dq and a dkv."""
    tiles = (sp_index + 1 if causal else sp) * layers
    return {"fwd": tiles, "dq": tiles, "dkv": tiles}


def ulysses_launches(layers: int):
    """Ulysses: one full-sequence causal flash call a layer on each rank's
    heads."""
    return {"fwd": layers, "dq": layers, "dkv": layers}


def loss_gaps(losses, ref):
    """Each step's |loss - ref| / |ref|."""
    return [abs(a - b) / abs(b) for a, b in zip(losses, ref)]


def mp_problems(res):
    """train_tp2_sp2's gates, for ring and Ulysses: every rank's losses
    the same bits, the first within MP_FIRST_REL and the later within
    MP_LATER_REL of one process on the whole batch, the flash launches of
    each rank's schedule at every step, and ring tiles that folded an lse
    cotangent."""
    bad = []
    ref = res["losses_world1"]
    for attn in ("ring", "ulysses"):
        run = res[attn]
        per_rank = run["losses_by_rank"]
        if any(x != per_rank[0] for x in per_rank):
            bad.append(f"{attn}: ranks' losses differ: {per_rank}")
        if not all(math.isfinite(x) for x in per_rank[0]):
            bad.append(f"{attn}: non-finite loss {per_rank[0]}")
        gaps = loss_gaps(per_rank[0], ref)
        if gaps[0] > MP_FIRST_REL or any(g > MP_LATER_REL for g in gaps[1:]):
            bad.append(f"{attn}: losses {per_rank[0]} against one "
                       f"process's {ref} (gaps {gaps})")
        for rank, (coords, steps) in enumerate(zip(
                run["coords"], run["launches_per_step_by_rank"])):
            want = (ring_launches(coords["sp"], MP_MESH["sp"], 2)
                    if attn == "ring" else ulysses_launches(2))
            bad += [f"{attn} rank {rank}: launches {st}, expected {want}"
                    for st in steps if st != want]
        if attn == "ring" and not any(run["dlse_folds_by_rank"]):
            bad.append("ring: no tile folded an lse cotangent")
    return bad


def mp_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_tp2_sp2`` (``--mp-rank``): MeshConfig(sp=2,
    tp=2) with vocab_parallel over gloo on ``cuda:0``, 2 layers at full
    width, this rank's cut of a global batch of 2 x 1024, 3 steps with
    ring attention and 3 with Ulysses; then rank 0, without the runtime,
    runs the same steps from the same weights on the whole batch in one
    process and prints every rank's numbers as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    cfg = bench_config(llama, n_layers=2, vocab_parallel=True)
    rng = np.random.RandomState(3)
    toks, tgts = (torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (MP_BATCH, cfg.max_seq_len)),
        dtype=torch.long, device=dev) for _ in range(2))

    def steps(ts, tk, tg):
        params, opt_state = ts.init_fn(3)
        state = [params, opt_state]

        def step():
            state[0], state[1], loss = ts.step_fn(state[0], state[1], tk, tg)
            return loss

        out = run_steps(step, MP_STEPS, lambda: dict(fa.LAUNCHES))
        del state
        return out

    hvd.init(device=dev)
    pmesh = ParallelMesh(MeshConfig(**MP_MESH))
    res = {}
    for attn in ("ring", "ulysses"):
        ts = training.make_llama_train_step(cfg, pmesh,
                                            optimizer=adamw_lp(3e-4),
                                            attn=attn, device=dev)
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ax.reset_bytes()
        step_ms, losses, per_step = steps(ts, ts.shard_batch(toks),
                                          ts.shard_batch(tgts))
        row = {"coords": pmesh.coords, "losses": losses, "step_ms": step_ms,
               "launches_per_step": per_step,
               "dlse_folds": fa.DLSE_FOLDS[0],
               "bytes_per_step": {k: v // MP_STEPS
                                  for k, v in sorted(ax.BYTES.items())},
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "local_batch": list(ts.shard_batch(toks).shape)}
        rows = hvd.allgather_object(row)
        res[attn] = {
            "coords": [r["coords"] for r in rows],
            "losses_by_rank": [r["losses"] for r in rows],
            "step_ms_by_rank": [r["step_ms"] for r in rows],
            "launches_per_step_by_rank": [r["launches_per_step"]
                                          for r in rows],
            "launches_by_rank": [{k: sum(st[k] for st in r[
                "launches_per_step"]) for k in ("fwd", "dq", "dkv")}
                for r in rows],
            "dlse_folds_by_rank": [r["dlse_folds"] for r in rows],
            "host_bytes_per_step_by_rank": [r["bytes_per_step"]
                                            for r in rows],
            "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                             for r in rows],
            "local_batch": rows[0]["local_batch"]}
        del ts
        torch.cuda.empty_cache()
    hvd.shutdown()
    if rank:
        return 0
    ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                        device=dev)
    _, res["losses_world1"], _ = steps(ts, toks, tgts)
    print(json.dumps(res), flush=True)
    return 0


def train_tp2_sp2_phase(script=None):
    """Four ranks of :func:`mp_child` on the card over gloo (``script``:
    another program that runs them); the gates."""
    res, seconds = _run_pair("--mp-rank", MP_TIMEOUT_S, world=4,
                             script=script)
    gaps = {attn: loss_gaps(res[attn]["losses_by_rank"][0],
                            res["losses_world1"])
            for attn in ("ring", "ulysses")}
    emit("train_tp2_sp2", mesh=MP_MESH, layers=2, batch=[MP_BATCH, 1024],
         vocab_parallel=True, backend="gloo", seconds=seconds,
         loss_gaps=gaps, **res)
    bad = mp_problems(res)
    require(not bad, f"train_tp2_sp2: {bad}")
    return res


def spec_problems(res):
    """train_tp2_dp2_spec's gates, for each run: the tp ranks of a dp
    index report the same loss bits, the global loss (the mean over dp)
    within MP_FIRST_REL of one process's first and MP_LATER_REL of the
    later; every rank's reduced warm-up gradient and the updates after
    the steps by the parity rule (norms within PARITY_NORM_REL, cosine
    above PARITY_COS) against one process's; the inner state's bytes and
    the transform's bytes a step by axis exactly the plan's; the flash
    launches of each timed step."""
    bad = []
    ref = res["losses_world1"]
    for name, run in res["runs"].items():
        by_rank = run["losses_by_rank"]
        coords = res["coords"]
        for r, c in enumerate(coords):
            mate = [q for q, d in enumerate(coords)
                    if d["dp"] == c["dp"] and q != r]
            if any(by_rank[q] != by_rank[r] for q in mate):
                bad.append(f"{name}: tp ranks of dp {c['dp']} differ: "
                           f"{[by_rank[q] for q in [r] + mate]}")
        losses = run["global_losses"]
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"{name}: non-finite loss {losses}")
        gaps = loss_gaps(losses, ref)
        if gaps[0] > MP_FIRST_REL or any(g > MP_LATER_REL for g in gaps[1:]):
            bad.append(f"{name}: losses {losses} against one process's "
                       f"{ref} (gaps {gaps})")
        for rank, leaves in enumerate(run["grad_parity_by_rank"]):
            for path, g in leaves.items():
                a, b = g["norms"]
                if not abs(a - b) <= PARITY_NORM_REL * b or \
                        not g["cos"] > PARITY_COS:
                    bad.append(f"{name} rank {rank}: reduced gradient "
                               f"{path}: norms {a} vs {b}, cos {g['cos']}")
        for path, g in run["update_parity"].items():
            a, b = g["norms"]
            if not abs(a - b) <= PARITY_NORM_REL * b or \
                    not g["cos"] > PARITY_COS:
                bad.append(f"{name}: update {path}: norms {a} vs {b}, cos "
                           f"{g['cos']}")
        for rank, (got, want) in enumerate(zip(
                run["state_bytes_by_rank"], run["state_bytes_expected"])):
            if got != want:
                bad.append(f"{name} rank {rank}: inner state {got} bytes, "
                           f"the plan's {want}")
        for rank, (got, want) in enumerate(zip(
                run["transform_bytes_by_rank"],
                run["transform_bytes_expected"])):
            if got != want:
                bad.append(f"{name} rank {rank}: the transform's bytes a "
                           f"step {got}, the plan's {want}")
        for rank, steps in enumerate(run["launches_per_step_by_rank"]):
            bad += [f"{name} rank {rank}: launches {st}, expected "
                    f"{EXPECTED_SPEC_LAUNCHES}" for st in steps
                    if st != EXPECTED_SPEC_LAUNCHES]
    return bad


def _reduced_by_path(reduced, state, params, sharded, dp_group):
    """The transform's reduced gradients as ``{path: tensor}`` of this
    rank's shapes: the leaves, or under sharded_update every bucket's
    tiles gathered over the data axis and cut back into leaves."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.optim import distributed as tdist
    from horovod_tpu_torch.tree import tree_paths
    if not sharded:
        return dict(zip(tree_paths(params), reduced))
    _, names, _ = tdist._tree_leaves_sorted(params)
    layout = state.layout
    out = {}
    for bl, tile in zip(layout.buckets, reduced):
        full = collectives.all_gather_flat(tile, dp_group)
        off = 0
        for i, sz in zip(bl.indices, bl.sizes):
            out[names[i]] = full[off:off + sz].view(layout.shapes[i])
            off += sz
    return out


def spec_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_tp2_dp2_spec`` (``--spec-rank``): see
    SPEC_MESH.  Each rank first takes one process's gradient of the
    global batch from the full weights (its shard kept for the gate),
    then for each of SPEC_RUNS the warm-up step through ``tx.reduce`` and
    ``tx.apply`` (the reduced gradients held to that shard) and
    SPEC_STEPS timed steps through ``tx.update``, the transform's bytes by
    axis counted around it; the weights gathered over tp after each run.
    Rank 0 then runs one process's train step on the global batch from
    the same seed and prints every number as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim import distributed as tdist
    from horovod_tpu_torch.optim.precision import adamw_lp, tree_nbytes
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.tree import tree_leaves, tree_map, tree_paths
    cfg = bench_config(llama, n_layers=2)
    rng = np.random.RandomState(SPEC_SEED)
    toks, tgts = (torch.as_tensor(
        rng.randint(0, cfg.vocab_size,
                    (SPEC_BATCH * SPEC_MESH["dp"], cfg.max_seq_len)),
        dtype=torch.long, device=dev) for _ in range(2))
    hvd.init(device=dev)
    pmesh = ParallelMesh(MeshConfig(**SPEC_MESH))
    ts = training.make_llama_train_step(cfg, pmesh, device=dev)
    par = ts.par
    specs = llama.param_specs(par, cfg)
    tk, tg = ts.shard_batch(toks), ts.shard_batch(tgts)
    dp_group = pmesh.group("dp")

    # one process's gradient of the global batch, this rank's shard of it
    full = llama.init_params(cfg, SPEC_SEED, device=dev)
    init_full = {p: t.detach().clone() if rank == 0 else None
                 for p, t in zip(tree_paths(full), tree_leaves(full))}
    leaves = training.trainable_leaves(full)
    g = iter(torch.autograd.grad(llama.loss_fn(full, toks, tgts, cfg),
                                 leaves))
    ref_grads = convert.llama_shard_params(
        tree_map(lambda _: next(g).detach(), full), cfg, pmesh, par)
    ref_grads = dict(zip(tree_paths(ref_grads), tree_leaves(ref_grads)))
    del full, leaves, g
    torch.cuda.empty_cache()

    def expected_bytes(params, state, sharded, sp):
        """(inner-state bytes, the transform's bytes a step by axis) the
        plan gives: 2 bf16 moments an element of the shards or tiles;
        every bucket over dp alone, padded when sharded."""
        if sharded:
            lay = tdist.sharded_tile_layout(params, SPEC_MESH["dp"],
                                            spec_plan=sp)
            return (2 * 2 * sum(bl.shard_numel for bl in lay.buckets),
                    {"dp.psum_scatter": 4 * sum(bl.padded_numel
                                                for bl in lay.buckets)})
        n_all = sum(t.numel() for t in tree_leaves(params))
        return 2 * 2 * n_all, {"dp.all_reduce": 4 * n_all}

    runs, gathered = {}, {}
    for name, sharded in SPEC_RUNS:
        params, _ = ts.init_fn(SPEC_SEED)
        leaves = training.trainable_leaves(params)
        kw = dict(sharded_update=sharded, wire_format="none",
                  model_axes=())
        if name == "context":
            with pmesh.with_param_specs(specs):
                tx = hvd.DistributedGradientTransform(adamw_lp(3e-4), **kw)
        else:
            tx = hvd.DistributedGradientTransform(
                adamw_lp(3e-4), param_specs=specs, mesh=pmesh, **kw)
        state = tx.init(params)
        sp = tdist.make_spec_plan(specs, "dp", model_axes=(), mesh=pmesh)

        def grads_of():
            with pmesh:
                loss = llama.loss_fn(params, tk, tg, cfg, par)
                g = iter(torch.autograd.grad(loss, leaves))
            return loss.detach(), tree_map(lambda _: next(g), params)

        loss, grads = grads_of()
        reduced = tx.reduce(grads, state)
        by_path = _reduced_by_path(reduced, state, params, sharded,
                                   dp_group)
        grad_parity = {p: {"norms": [by_path[p].double().norm().item(),
                                     ref_grads[p].double().norm().item()],
                           "cos": cosine(by_path[p], ref_grads[p])}
                       for p in ref_grads}
        tx.apply(reduced, state)
        del reduced, by_path, grads
        losses = [loss.item()]
        fa.reset_launches()
        ax.reset_bytes()
        t_bytes = {}

        def step():
            loss, grads = grads_of()
            b0 = dict(ax.BYTES)
            tx.update(grads, state, params)
            for k, v in ax.BYTES.items():
                t_bytes[k] = t_bytes.get(k, 0) + v - b0.get(k, 0)
            return loss

        torch.cuda.reset_peak_memory_stats()
        step_ms, more, per_step = run_steps(step, SPEC_STEPS,
                                            lambda: dict(fa.LAUNCHES))
        losses += more
        state_want, bytes_want = expected_bytes(params, state, sharded, sp)
        row = {"losses": losses, "step_ms": step_ms,
               "launches_per_step": per_step, "grad_parity": grad_parity,
               "state_bytes": tree_nbytes(list(state.inner.state.values())),
               "state_bytes_expected": state_want,
               "transform_bytes": {k: v // SPEC_STEPS
                                   for k, v in sorted(t_bytes.items())
                                   if v},
               "transform_bytes_expected": bytes_want,
               "bytes_per_step": {k: v // SPEC_STEPS
                                  for k, v in sorted(ax.BYTES.items())},
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        rows = hvd.allgather_object(row)
        back = convert.llama_gather_params(params, cfg, pmesh, par)
        if rank == 0:
            gathered[name] = {p: t.detach().clone() for p, t in
                              zip(tree_paths(back), tree_leaves(back))}
        runs[name] = {
            "sharded_update": sharded,
            "losses_by_rank": [r["losses"] for r in rows],
            "step_ms_by_rank": [r["step_ms"] for r in rows],
            "launches_per_step_by_rank": [r["launches_per_step"]
                                          for r in rows],
            "launches_by_rank": [{k: sum(st[k] for st in r[
                "launches_per_step"]) for k in ("fwd", "dq", "dkv")}
                for r in rows],
            "grad_parity_by_rank": [r["grad_parity"] for r in rows],
            "state_bytes_by_rank": [r["state_bytes"] for r in rows],
            "state_bytes_expected": [r["state_bytes_expected"]
                                     for r in rows],
            "transform_bytes_by_rank": [r["transform_bytes"] for r in rows],
            "transform_bytes_expected": [r["transform_bytes_expected"]
                                         for r in rows],
            "bytes_per_step_by_rank": [r["bytes_per_step"] for r in rows],
            "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                             for r in rows]}
        del params, state, tx, back, leaves
        torch.cuda.empty_cache()
    coords = hvd.allgather_object(pmesh.coords)
    hvd.shutdown()
    if rank:
        return 0
    del ref_grads
    ts1 = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                         device=dev)
    params, opt = ts1.init_fn(SPEC_SEED)
    world1 = []
    for _ in range(1 + SPEC_STEPS):
        params, opt, loss = ts1.step_fn(params, opt, toks, tgts)
        world1.append(loss.item())
    after1 = dict(zip(tree_paths(params), tree_leaves(params)))
    for name, got in gathered.items():
        run = runs[name]
        dp_of = [c["dp"] for c in coords]
        run["global_losses"] = [
            sum(run["losses_by_rank"][dp_of.index(d)][i]
                for d in range(SPEC_MESH["dp"])) / SPEC_MESH["dp"]
            for i in range(1 + SPEC_STEPS)]
        run["update_parity"] = {
            p: {"norms": [(got[p] - init_full[p]).double().norm().item(),
                          (after1[p] - init_full[p]).double().norm()
                          .item()],
                "cos": cosine(got[p] - init_full[p],
                              after1[p] - init_full[p])}
            for p in after1}
    print(json.dumps({"coords": coords, "local_batch": list(tk.shape),
                      "losses_world1": world1, "runs": runs}), flush=True)
    return 0


def train_tp2_dp2_spec_phase(script=None):
    """Four ranks of :func:`spec_child` on the card over gloo (``script``:
    another program that runs them); the gates."""
    res, seconds = _run_pair("--spec-rank", SPEC_TIMEOUT_S, world=4,
                             script=script)
    gaps = {name: loss_gaps(run["global_losses"], res["losses_world1"])
            for name, run in res["runs"].items()}
    emit("train_tp2_dp2_spec", mesh=SPEC_MESH, layers=2,
         batch=[SPEC_BATCH, 1024], vocab_parallel=False, backend="gloo",
         seconds=seconds, loss_gaps=gaps, **res)
    bad = spec_problems(res)
    require(not bad, f"train_tp2_dp2_spec: {bad}")
    return res


def ep_problems(res):
    """train_moe_ep2's gates, for each variant: both ranks' losses the same
    bits and finite, within EP_LOSS_ATOL of one process on the whole batch
    (every step where every pick kept its slot on both sides, the first
    step else), and 2/2/2 flash launches a step on each rank."""
    bad = []
    for name, run in res["variants"].items():
        per_rank = run["losses_by_rank"]
        if any(x != per_rank[0] for x in per_rank):
            bad.append(f"{name}: ranks' losses differ: {per_rank}")
        if not all(math.isfinite(x) for x in per_rank[0]):
            bad.append(f"{name}: non-finite loss {per_rank[0]}")
        gaps = [abs(a - b) for a, b in zip(per_rank[0], run["losses_world1"])]
        dropless = min(run["kept_by_rank"][0] + run["kept_world1"]) == 1.0
        held = gaps if dropless else gaps[:1]
        if any(g > EP_LOSS_ATOL for g in held):
            bad.append(f"{name}: losses {per_rank[0]} against one "
                       f"process's {run['losses_world1']} (gaps {gaps})")
        want = ulysses_launches(2)
        for rank, steps in enumerate(run["launches_per_step_by_rank"]):
            bad += [f"{name} rank {rank}: launches {st}, expected {want}"
                    for st in steps if st != want]
    if not any(min(run["kept_by_rank"][0] + run["kept_world1"]) == 1.0
               for run in res["variants"].values()):
        bad.append("no variant kept every pick: no step-by-step gate ran")
    return bad


def ep_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_moe_ep2`` (``--ep-rank``): MeshConfig(dp=2) with
    the 8 experts aliased onto dp (4 a rank) over gloo on ``cuda:0``, 2
    MoE layers at full width, 2 sequences a rank, 3 steps at each of
    EP_VARIANTS' capacity factors; then rank 0, without the runtime, runs
    the same steps from the same weights on the 4 sequences in one
    process and prints both as JSON, with the share of the k·N expert
    picks each MoE layer kept (a dropped pick has no slot)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama, moe
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    kept = []
    dispatch = moe._top_k_dispatch

    def counted(gates, k, capacity):
        # kept on the card and read after the steps: no sync in a step
        out = dispatch(gates, k, capacity)
        kept.append(out[0].sum() / (k * gates.shape[0]))
        return out

    moe._top_k_dispatch = counted

    def config(over):
        return bench_config(llama, n_layers=2, **{**MOE_OVER, **over})

    cfg = config({})
    rng = np.random.RandomState(4)
    toks, tgts = (torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (2 * EP_BATCH, cfg.max_seq_len)),
        dtype=torch.long, device=dev) for _ in range(2))

    def steps(ts, tk, tg):
        kept.clear()
        state = list(ts.init_fn(4))

        def step():
            state[0], state[1], loss = ts.step_fn(state[0], state[1], tk, tg)
            return loss

        return run_steps(step, EP_STEPS, lambda: dict(fa.LAUNCHES)) + (
            [share.item() for share in kept],)

    hvd.init(device=dev)
    pmesh = ParallelMesh(MeshConfig(dp=2))
    res = {"variants": {}}
    for name, over in EP_VARIANTS:
        cfg = config(over)
        ts = training.make_llama_train_step(cfg, pmesh,
                                            optimizer=adamw_lp(3e-4),
                                            device=dev)
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ax.reset_bytes()
        step_ms, losses, per_step, kept_shares = steps(
            ts, ts.shard_batch(toks), ts.shard_batch(tgts))
        row = {"losses": losses, "step_ms": step_ms,
               "launches_per_step": per_step, "kept": kept_shares,
               "bytes_per_step": {k: v // EP_STEPS
                                  for k, v in sorted(ax.BYTES.items())},
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        rows = hvd.allgather_object(row)
        n_tokens = EP_BATCH * cfg.max_seq_len
        capacity = int(math.ceil(cfg.expert_top_k * n_tokens
                                 / cfg.n_experts * cfg.capacity_factor))
        # 2 all-to-alls forward and 2 backward a layer, each [E, C, D] bf16
        a2a = rows[0]["bytes_per_step"].get("dp.all_to_all", 0)
        res["variants"][name] = {
            "capacity_factor": cfg.capacity_factor,
            "losses_by_rank": [r["losses"] for r in rows],
            "step_ms_by_rank": [r["step_ms"] for r in rows],
            "launches_per_step_by_rank": [r["launches_per_step"]
                                          for r in rows],
            "launches_by_rank": [{k: sum(st[k] for st in r[
                "launches_per_step"]) for k in ("fwd", "dq", "dkv")}
                for r in rows],
            "kept_by_rank": [r["kept"] for r in rows],
            "host_bytes_per_step_by_rank": [r["bytes_per_step"]
                                            for r in rows],
            "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                             for r in rows],
            "local_tokens": n_tokens, "capacity": capacity,
            "all_to_all_bytes_per_layer_each_way": a2a // (2 * 2 * 2),
            "slots_bytes": cfg.n_experts * capacity * cfg.d_model * 2}
        del ts
        torch.cuda.empty_cache()
    hvd.shutdown()
    if rank:
        return 0
    for name, over in EP_VARIANTS:
        ts = training.make_llama_train_step(config(over),
                                            optimizer=adamw_lp(3e-4),
                                            device=dev)
        run = res["variants"][name]
        _, run["losses_world1"], _, run["kept_world1"] = steps(ts, toks,
                                                               tgts)
        del ts
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


def train_moe_ep2_phase(script=None):
    """Two ranks of :func:`ep_child` on the card over gloo (``script``:
    another program that runs them); the gates."""
    res, seconds = _run_pair("--ep-rank", EP_TIMEOUT_S, script=script)
    gaps = {name: [a - b for a, b in zip(run["losses_by_rank"][0],
                                         run["losses_world1"])]
            for name, run in res["variants"].items()}
    emit("train_moe_ep2", layers=2, batch=[EP_BATCH, EP_BATCH], seq=1024,
         backend="gloo", seconds=seconds, loss_gaps=gaps, **res)
    for name, run in res["variants"].items():
        require(run["all_to_all_bytes_per_layer_each_way"]
                == run["slots_bytes"],
                f"train_moe_ep2 {name}: all-to-all bytes a layer "
                f"{run['all_to_all_bytes_per_layer_each_way']}, expected the "
                f"[E, C, D] slots' {run['slots_bytes']}")
    bad = ep_problems(res)
    require(not bad, f"train_moe_ep2: {bad}")
    return res


# -- A6 items 5-8: the pipeline, BERT's tp and sp, FSDP, mp serving ----------


def pp_launches(layers: int, micro: int, skip: int):
    """Flash launches a step of one pipeline stage of ``layers`` layers,
    its last ``skip`` not rematerialized, computing on its ``micro`` live
    ticks only: each microbatch runs every layer's forward, the
    rematerialized ones' again in the backward, and one dq and dkv a
    layer."""
    k = min(skip, layers)
    return {"fwd": micro * (2 * layers - k), "dq": micro * layers,
            "dkv": micro * layers}


def pp_problems(res, ref):
    """train_pp2's gates: the stages' losses the same bits, finite and
    falling, the first within PP_FIRST_REL of ``ref`` (train's, one
    process on the same config, seed and batch) and the later within
    PP_LATER_REL, and each stage's launches on the live-tick schedule at
    every timed step."""
    bad = []
    per_rank = res["losses_by_rank"]
    if any(x != per_rank[0] for x in per_rank):
        bad.append(f"the stages' losses differ: {per_rank}")
    bad += step_problems(per_rank[0], [], {})
    gaps = loss_gaps(per_rank[0], ref)
    if gaps[0] > PP_FIRST_REL or any(g > PP_LATER_REL for g in gaps[1:]):
        bad.append(f"losses {per_rank[0]} against one process's {ref} "
                   f"(gaps {gaps})")
    want = pp_launches(res["layers_per_stage"], PP_MICRO,
                       res["remat_skip_layers"])
    for rank, steps in enumerate(res["launches_per_step_by_rank"]):
        bad += [f"stage {rank}: launches {st}, expected {want}"
                for st in steps if st != want]
    return bad


def pp_child(rank: int, dev: torch.device) -> int:
    """One stage of ``train_pp2`` (``--pp-rank``): MeshConfig(pp=2) over
    gloo on ``cuda:0``, bench.py's 1B at its 16 layers (8 a stage), the
    whole batch of 8 x 1024 (train's seed and data) in PP_MICRO
    microbatches, 1 warm-up and 3 timed steps; rank 0 prints both
    stages' numbers as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    cfg = bench_config(llama)
    rng = np.random.RandomState(0)      # train's batch
    toks, tgts = (torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (8, cfg.max_seq_len)),
        dtype=torch.long, device=dev) for _ in range(2))
    hvd.init(device=dev)
    pmesh = ParallelMesh(MeshConfig(**PP_MESH))
    ts = training.make_llama_train_step(cfg, pmesh, optimizer=adamw_lp(3e-4),
                                        n_microbatches=PP_MICRO, device=dev)
    params, opt_state = ts.init_fn(0)
    state = [params, opt_state]
    del params, opt_state

    def step():
        state[0], state[1], loss = ts.step_fn(state[0], state[1], toks, tgts)
        return loss

    t0 = time.perf_counter()
    first = step().item()
    warmup_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()   # the path's run starts here
    ax.reset_bytes()
    step_ms, losses, per_step = run_steps(step, 3, lambda: dict(fa.LAUNCHES))
    row = {"losses": [first] + losses, "warmup_ms": warmup_ms,
           "step_ms": step_ms, "launches_per_step": per_step,
           "layers": len(state[0]["layers"]),
           "bytes_per_step": {k: v // 3 for k, v in sorted(ax.BYTES.items())},
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    rows = hvd.allgather_object(row)
    hvd.shutdown()
    if rank:
        return 0
    print(json.dumps({
        "layers_per_stage": rows[0]["layers"],
        "remat_skip_layers": cfg.remat_skip_layers,
        "losses_by_rank": [r["losses"] for r in rows],
        "warmup_ms_by_rank": [r["warmup_ms"] for r in rows],
        "step_ms_by_rank": [r["step_ms"] for r in rows],
        "launches_per_step_by_rank": [r["launches_per_step"] for r in rows],
        "launches_by_rank": [{k: sum(st[k] for st in r["launches_per_step"])
                              for k in ("fwd", "dq", "dkv")} for r in rows],
        "host_bytes_per_step_by_rank": [r["bytes_per_step"] for r in rows],
        "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                         for r in rows]}), flush=True)
    return 0


def train_pp2_phase(ref_losses, script=None):
    """Two stages of :func:`pp_child` on the card over gloo, against
    ``ref_losses`` (train's); the gates."""
    res, seconds = _run_pair("--pp-rank", PP_TIMEOUT_S, script=script)
    res["losses_world1"] = list(ref_losses)
    emit("train_pp2", mesh=PP_MESH, n_microbatches=PP_MICRO,
         batch=[8, 1024], backend="gloo", seconds=seconds,
         loss_gaps=loss_gaps(res["losses_by_rank"][0], ref_losses), **res)
    bad = pp_problems(res, ref_losses)
    require(not bad, f"train_pp2: {bad}")
    return res


def bert_mp_launches(layers: int, sp: int, remat: bool):
    """Flash launches of one rank's forward and backward of BERT over a
    non-causal ring of ``sp``: a tile for every k/v block a layer, the
    forward again in the backward's recompute under remat."""
    tiles = sp * layers
    return {"fwd": tiles * (2 if remat else 1), "dq": tiles, "dkv": tiles}


def bert_mp_problems(res):
    """bert_tp2_sp2's gates: the loss and every leaf's gradient no
    farther from the fp32 process than BERT_MP_NOISE times the bf16
    process is (or within BERT_MP_LOSS_REL / PARITY_NORM_REL of the fp32
    value); each rank's flash launches on the ring's schedule."""
    bad = []
    loss, one, f32 = res["loss"], res["loss_world1"], res["loss_fp32"]
    if not abs(loss - f32) <= max(BERT_MP_NOISE * abs(one - f32),
                                  BERT_MP_LOSS_REL * abs(f32)):
        bad.append(f"loss {loss}: {abs(loss - f32)} from fp32's {f32}, "
                   f"one bf16 process's {one} {abs(one - f32)}")
    for path, g in res["grads"].items():
        if not g["err_fp32"] <= max(BERT_MP_NOISE * g["err_fp32_world1"],
                                    PARITY_NORM_REL * g["norm_fp32"]):
            bad.append(f"{path}: {g}")
    want = bert_mp_launches(res["layers"], BERT_MP_MESH["sp"], True)
    for rank, n in enumerate(res["launches_by_rank"]):
        if n != want:
            bad.append(f"rank {rank}: launches {n}, expected {want}")
    return bad


def bert_mp_child(rank: int, dev: torch.device) -> int:
    """One rank of ``bert_tp2_sp2`` (``--bert-mp-rank``): bert_base over
    MeshConfig(sp=2, tp=2) on gloo, this rank's tp slice of the weights
    (convert.bert_shard_params) and sp block of a batch of 16 x 512: the
    forward and backward of the mean of h · c (a fixed cotangent c);
    the loss summed and the gradients summed over sp and gathered over
    tp; then rank 0, without the runtime, the same on the whole batch in
    one process, in bf16 and in fp32 (the blockwise attention), and
    every number as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.models.llama import ParallelSpec
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.tree import tree_leaves, tree_map, tree_paths
    cfg = bert_config(bert, n_layers=BERT_MP_LAYERS)
    B, T = BERT_MP_BATCH
    rng = np.random.RandomState(5)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, T)),
                           dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cot = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)

    def loss_of(params, tk, c, par, cfg=cfg):
        h = bert.encode(params, tk, cfg, par)
        return (h.float() * c).sum() / (B * T)

    hvd.init(device=dev)
    pmesh = ParallelMesh(MeshConfig(**BERT_MP_MESH))
    par = ParallelSpec(tp_axis="tp", sp_axis="sp")
    params = convert.bert_shard_params(bert.init_params(cfg, 0, device=dev),
                                       cfg, pmesh, par)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    n = T // pmesh.axis_size("sp")
    block = slice(pmesh.axis_index("sp") * n, (pmesh.axis_index("sp") + 1)
                  * n)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()   # the path's run starts here
    ax.reset_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pmesh:
        loss = loss_of(params, toks[:, block], cot[:, block], par)
        loss.backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    nbytes = dict(sorted(ax.BYTES.items()))
    g_sp = pmesh.group("sp")
    loss = ax._all_reduce(loss.detach(), g_sp, "sp").item()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else ax._all_reduce(p.grad, g_sp, "sp"), params)
    grads = convert.bert_gather_params(grads, cfg, pmesh, par)
    row = {"coords": pmesh.coords, "launches": launches, "ms": ms,
           "host_bytes": nbytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    rows = hvd.allgather_object(row)
    hvd.shutdown()
    if rank:
        return 0
    one = {}
    for name, c, flash in (("bf16", cfg, "1"),
                           ("fp32", dataclasses.replace(
                               cfg, dtype=torch.float32), "0")):
        full = bert.init_params(c, 0, device=dev)
        for p in tree_leaves(full):
            p.requires_grad_(True)
        os.environ["HOROVOD_FLASH_ATTENTION"] = flash
        try:
            one_loss = loss_of(full, toks, cot, ParallelSpec(), c)
            one_loss.backward()
        finally:
            os.environ.pop("HOROVOD_FLASH_ATTENTION")
        one[name] = (one_loss.item(), [p.grad for p in tree_leaves(full)])
        del full
    out = {}
    for path, g, g1, g32 in zip(tree_paths(grads), tree_leaves(grads),
                                one["bf16"][1], one["fp32"][1]):
        if g32 is None:
            continue
        out[path] = {"norm": g.double().norm().item(),
                     "norm_world1": g1.double().norm().item(),
                     "norm_fp32": g32.double().norm().item(),
                     "cos": cosine(g, g1), "cos_fp32": cosine(g, g32),
                     "err_fp32": (g.double() - g32.double()).norm().item(),
                     "err_fp32_world1": (g1.double()
                                         - g32.double()).norm().item()}
    print(json.dumps({
        "layers": cfg.n_layers, "loss": loss, "loss_world1": one["bf16"][0],
        "loss_fp32": one["fp32"][0],
        "grads": out, "coords": [r["coords"] for r in rows],
        "launches_by_rank": [r["launches"] for r in rows],
        "ms_by_rank": [r["ms"] for r in rows],
        "host_bytes_by_rank": [r["host_bytes"] for r in rows],
        "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                         for r in rows]}), flush=True)
    return 0


def bert_tp2_sp2_phase(script=None):
    """Four ranks of :func:`bert_mp_child` on the card over gloo; the
    gates."""
    res, seconds = _run_pair("--bert-mp-rank", BERT_MP_TIMEOUT_S, world=4,
                             script=script)
    ratio = {p: g["err_fp32"] / max(g["err_fp32_world1"], 1e-30)
             for p, g in res["grads"].items()}
    worst = max(ratio, key=ratio.get)
    emit("bert_tp2_sp2", mesh=BERT_MP_MESH, batch=list(BERT_MP_BATCH),
         backend="gloo", seconds=seconds,
         loss_from_fp32=[abs(res[k] - res["loss_fp32"])
                         for k in ("loss", "loss_world1")],
         largest_noise_ratio={worst: ratio[worst]}, **res)
    bad = bert_mp_problems(res)
    require(not bad, f"bert_tp2_sp2: {bad}")
    return res


def fsdp_expected_bytes(training, llama, cfg, dp: int):
    """(per-rank parameter bytes, one replica's) from fsdp_param_specs:
    each sharded leaf's numel / dp, a replicated one's whole, at the
    params' 4 bytes."""
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    shapes = llama.init_params(cfg, device="meta")
    specs = training.fsdp_param_specs(shapes, dp)
    shard = replica = 0
    for path, t in zip(tree_paths(shapes), tree_leaves(shapes)):
        n = t.numel() * 4
        replica += n
        shard += n // dp if "dp" in llama.leaf_spec(specs, path) else n
    return shard, replica


def fsdp_problems(res):
    """train_fsdp_dp2's gates, for each variant: the ranks' losses the
    same bits, finite and falling, the first within FSDP_FIRST_REL of one
    process on the whole batch and the later within FSDP_LATER_REL; the
    launches of FSDP_LAYERS layers (the last FSDP_REMAT_SKIP not
    rematerialized) at
    every step; each rank's parameter bytes exactly the specs' shards and
    its optimizer state (AdamWLP's bf16 moments, 4 bytes an element: on
    the shards without overlap, on the plane's 1/dp tiles with it) under
    one replica's."""
    bad = []
    ref = res["losses_world1"]
    for name, run in res["variants"].items():
        per_rank = run["losses_by_rank"]
        if any(x != per_rank[0] for x in per_rank):
            bad.append(f"{name}: ranks' losses differ: {per_rank}")
        bad += [f"{name}: {b}" for b in step_problems(
            per_rank[0], [], {})]
        gaps = loss_gaps(per_rank[0], ref)
        if gaps[0] > FSDP_FIRST_REL or any(g > FSDP_LATER_REL
                                           for g in gaps[1:]):
            bad.append(f"{name}: losses {per_rank[0]} against one "
                       f"process's {ref} (gaps {gaps})")
        for rank, steps in enumerate(run["launches_per_step_by_rank"]):
            bad += [f"{name} rank {rank}: launches {st}, expected "
                    f"{EXPECTED_FSDP_LAUNCHES}" for st in steps
                    if st != EXPECTED_FSDP_LAUNCHES]
        for rank, (pb, sb, tb) in enumerate(zip(
                run["param_bytes_by_rank"], run["state_bytes_by_rank"],
                run["tile_bytes_by_rank"])):
            if pb != res["param_bytes_expected"]:
                bad.append(f"{name} rank {rank}: parameter bytes {pb}, "
                           f"the specs' shards {res['param_bytes_expected']}")
            want_state = (res["param_bytes_expected"] if not tb else tb)
            if sb != want_state:
                bad.append(f"{name} rank {rank}: optimizer state {sb}, "
                           f"expected {want_state}")
            if not pb + sb + tb < res["replica_bytes"] + \
                    res["replica_state_bytes"]:
                bad.append(f"{name} rank {rank}: {pb + sb + tb} bytes, not "
                           f"under the replica's")
    return bad


def fsdp_child(rank: int, dev: torch.device) -> int:
    """One rank of ``train_fsdp_dp2`` (``--fsdp-rank``): bench.py's 1B
    widths at FSDP_LAYERS layers (the last FSDP_REMAT_SKIP not
    rematerialized), make_llama_fsdp_step over dp 2 on gloo,
    FSDP_BATCH sequences a rank of 1024, adamw_lp, 3 steps each of
    overlap=False and overlap=True; then rank 0 the same steps in one
    process on the whole batch, and every number as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.tree import tree_leaves
    cfg = bench_config(llama, n_layers=FSDP_LAYERS,
                       remat_skip_layers=FSDP_REMAT_SKIP)
    dp = FSDP_MESH["dp"]
    rng = np.random.RandomState(4)
    toks, tgts = (torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (FSDP_BATCH * dp, cfg.max_seq_len)),
        dtype=torch.long, device=dev) for _ in range(2))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if torch.is_tensor(t) and t.dim() > 0)

    def steps(ts, tk, tg):
        params, opt_state = ts.init_fn(4)
        state = [params, opt_state]

        def step():
            state[0], state[1], loss = ts.step_fn(state[0], state[1], tk, tg)
            return loss

        out = run_steps(step, FSDP_STEPS, lambda: dict(fa.LAUNCHES))
        return out, state

    hvd.init(device=dev)
    pmesh = ParallelMesh(MeshConfig(**FSDP_MESH))
    variants = {}
    for overlap in (False, True):
        ts = training.make_llama_fsdp_step(cfg, pmesh,
                                           optimizer=adamw_lp(3e-4),
                                           overlap=overlap, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()   # the path's run starts here
        ax.reset_bytes()
        (step_ms, losses, per_step), (params, opt_state) = steps(
            ts, ts.shard_batch(toks), ts.shard_batch(tgts))
        inner = opt_state.inner if overlap else opt_state
        row = {"losses": losses, "step_ms": step_ms,
               "launches_per_step": per_step,
               "param_bytes": nbytes(tree_leaves(params)),
               "state_bytes": nbytes(t for st in inner.state.values()
                                     for t in st.values()),
               "tile_bytes": nbytes(opt_state.tiles) if overlap else 0,
               "bytes_per_step": {k: v // FSDP_STEPS
                                  for k, v in sorted(ax.BYTES.items())},
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "local_batch": list(ts.shard_batch(toks).shape)}
        rows = hvd.allgather_object(row)
        variants["overlap" if overlap else "plain"] = {
            f"{k}_by_rank": [r[k] for r in rows] for k in row}
        variants["overlap" if overlap else "plain"][
            "losses_by_rank"] = [r["losses"] for r in rows]
        del ts, params, opt_state
        torch.cuda.empty_cache()
    hvd.shutdown()
    if rank:
        return 0
    shard, replica = fsdp_expected_bytes(training, llama, cfg, dp)
    ts = training.make_llama_train_step(cfg, optimizer=adamw_lp(3e-4),
                                        device=dev)
    torch.cuda.reset_peak_memory_stats()
    (step_ms, losses, _), (params, opt_state) = steps(ts, toks, tgts)
    print(json.dumps({
        "variants": variants, "losses_world1": losses,
        "step_ms_world1": step_ms,
        "max_memory_allocated_world1": torch.cuda.max_memory_allocated(),
        "param_bytes_expected": shard, "replica_bytes": replica,
        "replica_state_bytes": nbytes(t for st in opt_state.state.values()
                                      for t in st.values())}), flush=True)
    return 0


def train_fsdp_dp2_phase(script=None):
    """Two ranks of :func:`fsdp_child` on the card over gloo; the
    gates."""
    res, seconds = _run_pair("--fsdp-rank", FSDP_TIMEOUT_S, script=script)
    gaps = {name: loss_gaps(run["losses_by_rank"][0], res["losses_world1"])
            for name, run in res["variants"].items()}
    emit("train_fsdp_dp2", mesh=FSDP_MESH, layers=FSDP_LAYERS,
         remat_skip_layers=FSDP_REMAT_SKIP,
         batch=[FSDP_BATCH] * FSDP_MESH["dp"], seq=1024, backend="gloo",
         seconds=seconds, loss_gaps=gaps, **res)
    bad = fsdp_problems(res)
    require(not bad, f"train_fsdp_dp2: {bad}")
    return res


def serve_mp_problems(res):
    """serve_mp2's gates: at least SERVE_MP_MIN_REQUESTS answered over
    both batch buckets, every call's tokens one process's at the same
    batch shape bit for bit, the same output on both ranks, the per-chip
    bytes exactly the specs' shards and under a replica's, and nothing
    prepared twice."""
    bad = []
    if res["requests"] < SERVE_MP_MIN_REQUESTS or \
            sorted(set(res["batches"])) != list(SERVE_MP_BATCHES):
        bad.append(f"{res['requests']} requests in batches "
                   f"{res['batches']}")
    if not all(res["equal_world1"]):
        bad.append(f"calls whose tokens differ from one process's: "
                   f"{res['equal_world1']}")
    if not res["ranks_agree"]:
        bad.append("the ranks' outputs differ")
    st = res["stats"]
    if st["per_chip_param_nbytes"] != res["per_chip_expected"] or \
            not st["per_chip_param_nbytes"] < st["replica_param_nbytes"]:
        bad.append(f"per-chip bytes {st['per_chip_param_nbytes']}, "
                   f"expected {res['per_chip_expected']} (replica "
                   f"{st['replica_param_nbytes']})")
    if st["recompiles"]:
        bad.append(f"recompiles {st['recompiles']}")
    return bad


def serve_mp_child(rank: int, dev: torch.device) -> int:
    """One rank of ``serve_mp2`` (``--serve-mp-rank``): the 1B Llama in
    bf16 at SERVE_MP_LAYERS layers through mp_llama_decode_forward over 2
    ranks on
    gloo, buckets batch SERVE_MP_BATCHES x seq SERVE_MP_SEQ,
    SERVE_MP_NEW new tokens; rank 0 takes SERVE_MP_CALLS
    batches of ragged prompts while rank 1 follows; then rank 0 holds
    each call against llama_decode_forward in one process at the same
    batch shape and prints every number as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import generate as gen
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.serving.models import (llama_decode_forward,
                                                  mp_llama_decode_forward)
    from horovod_tpu_torch.serving.shapes import ShapeBuckets
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    cfg = bench_config(llama, n_layers=SERVE_MP_LAYERS)
    params = serve_params(llama, gen, cfg, dev)
    buckets = ShapeBuckets(batch_buckets=SERVE_MP_BATCHES,
                           seq_buckets=(SERVE_MP_SEQ,))
    hvd.init(device=dev)
    torch.cuda.reset_peak_memory_stats()
    fwd = mp_llama_decode_forward(params, cfg, SERVE_MP_NEW, buckets,
                                  mp=SERVE_MP_DEGREE)
    specs = training.fsdp_param_specs(params, SERVE_MP_DEGREE,
                                      axis=fwd.axis)
    expected = sum(t.numel() * t.element_size() // (
        SERVE_MP_DEGREE if fwd.axis in llama.leaf_spec(specs, p) else 1)
        for p, t in zip(tree_paths(params), tree_leaves(params)))
    from horovod_tpu_torch.analysis import recorder
    rng = np.random.RandomState(6)
    calls, outs, ms, recorded = [], [], [], []

    def armed():
        """The first call of each rank records its collectives."""
        return recorder.recording() if not recorded \
            else contextlib.nullcontext()

    ax.reset_bytes()
    if fwd.group.rank() == 0:
        for b, n in SERVE_MP_CALLS:
            for _ in range(n):
                lengths = rng.randint(1, SERVE_MP_SEQ + 1, (b,)).astype(
                    np.int32)
                tokens = rng.randint(0, cfg.vocab_size,
                                     (b, SERVE_MP_SEQ)).astype(np.int32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with armed() as rec:
                    outs.append(np.asarray(fwd(tokens, lengths)))
                ms.append(1e3 * (time.perf_counter() - t0))
                if rec is not None:
                    recorded.append(schedule_row(rec))
                calls.append((tokens, lengths))
        fwd.close()
    else:
        while True:
            with armed() as rec:
                o = fwd()
            if rec is not None:
                recorded.append(schedule_row(rec))
            if o is None:
                break
            outs.append(np.asarray(o))
    nbytes = dict(sorted(ax.BYTES.items()))
    digest = hvd.allgather_object([o.tolist() for o in outs])
    schedules = hvd.allgather_object(recorded[0])
    st = fwd.stats()
    peak = torch.cuda.max_memory_allocated()
    hvd.shutdown()
    if rank:
        return 0
    dense = llama_decode_forward(params, cfg, SERVE_MP_NEW, buckets)
    equal = [bool(np.array_equal(np.asarray(dense(t, n)), o))
             for (t, n), o in zip(calls, outs)]
    print(json.dumps({
        "requests": sum(len(n) for _, n in calls),
        "batches": [len(n) for _, n in calls], "ms_by_call": ms,
        "ms_per_token": [m / SERVE_MP_NEW for m in ms],
        "equal_world1": equal, "ranks_agree": digest[0] == digest[1],
        "schedule_ranks": schedules,
        "stats": st, "per_chip_expected": expected,
        "host_bytes_by_call": {k: v // len(calls)
                               for k, v in nbytes.items()},
        "max_memory_allocated": peak}), flush=True)
    return 0


def serve_mp2_phase(script=None):
    """Two ranks of :func:`serve_mp_child` on the card over gloo; the
    gates."""
    res, seconds = _run_pair("--serve-mp-rank", SERVE_MP_TIMEOUT_S,
                             script=script)
    emit("serve_mp2", mp=SERVE_MP_DEGREE, layers=SERVE_MP_LAYERS,
         seq=SERVE_MP_SEQ,
         new_tokens=SERVE_MP_NEW, backend="gloo", seconds=seconds, **res)
    bad = serve_mp_problems(res)
    require(not bad, f"serve_mp2: {bad}")
    bad, others = serve_mp_schedule_problems(
        [r["list"] for r in res["schedule_ranks"]])
    require(not bad, f"serve_mp2 schedule: {bad}")
    SCHEDULE["serve_mp2"] = dict(schedule_summary(
        res["schedule_ranks"][0]), ranks_identical=True,
        not_mp_gathers=[f"{p}@{'+'.join(a)}" for p, a in others])
    return res



def cosine(a, b) -> float:
    """Cosine of two gradients in fp64: over the 16.8M entries of a 1B
    weight an fp32 sum errs by ~1e-3, above 1 for equal vectors."""
    return torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0).item()


def parity_weights(llama, convert, over=None):
    """The parity phases' weights: ``init_params`` (seed 1) of the
    2-layer config with the fields ``over``, on the CPU, as numpy.  They
    depend on the widths, the depth and the experts alone, so ``parity``
    and ``parity_fused`` share one draw, ``parity_moe`` and
    ``parity_moe_route`` another."""
    cfg = bench_config(llama, **{"n_layers": 2, **(over or {})})
    return convert.llama_params_to_numpy(
        llama.init_params(cfg, seed=1, device=torch.device("cpu")))


def parity_phase(llama, training, adamw_lp, convert, dev, fused: bool,
                 name=None, over=None, np_params=None):
    """``parity``, or ``parity_fused`` with ``fused_xent=True``, or phase
    ``name`` with the config's fields ``over`` (``parity_moe``), on
    ``np_params`` (:func:`parity_weights`, drawn here when None); returns
    the weights."""
    cfg = bench_config(llama, **{"n_layers": 2, "fused_xent": fused,
                                 **(over or {})})
    last = cfg.n_layers - 1
    # the dense MLP's w_down of the last layer, or the experts' and the
    # router
    mlp = ({f"we_down{last}": (last, "we_down"), "router0": (0, "router")}
           if cfg.n_experts else {f"w_down{last}": (last, "w_down")})
    batch, seq = 2, 256
    cpu = torch.device("cpu")
    if np_params is None:
        np_params = parity_weights(llama, convert, over)
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
                  f"wo{last}": grads["layers"][last]["wo"],
                  **{n: grads["layers"][i][leaf]
                     for n, (i, leaf) in mlp.items()},
                  "final_norm": grads["final_norm"]}
        out.append((loss0.item(), loss1.item(),
                    {n: g.float().cpu() for n, g in picked.items()},
                    time.perf_counter() - t0))
        del ts, params, opt_state, grads, picked
    (g0, g1, gg, gs), (c0, c1, cg, cs) = out
    norms = {n: (gg[n].double().norm().item(), cg[n].double().norm().item())
             for n in gg}
    cos = {n: cosine(gg[n], cg[n]) for n in gg}
    emit(name or ("parity_fused" if fused else "parity"),
         layers=cfg.n_layers, n_experts=cfg.n_experts,
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
    return np_params


def bf16_step(x):
    """The spacing of bf16 values at ``|x|`` (fp32, elementwise)."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones(x.shape), e - 8)


def top_k_picks(logits, k: int):
    """The experts ``[N, k]`` of ``moe._top_k_dispatch``'s k sequential
    top-1 picks from the gates of router ``logits [N, E]``."""
    remaining = torch.softmax(logits.float(), dim=-1)
    picks = []
    for _ in range(k):
        idx = remaining.argmax(-1)
        picks.append(idx)
        remaining = remaining * (1.0 - torch.nn.functional.one_hot(
            idx, logits.shape[-1]))
    return torch.stack(picks, dim=-1)


def route_compare(logits_a, logits_b, k: int):
    """Two sides' top-k picks from their router logits ``[N, E]`` (bf16
    values), token by token: ``(differ [N] bool, stats)``.  For each token
    whose ordered picks differ, the gap between the two experts of its
    first differing pick, on side b, in bf16 steps of the larger; and the
    largest difference of any logit between the sides, in bf16 steps."""
    a, b = logits_a.float().cpu(), logits_b.float().cpu()
    pa, pb = top_k_picks(a, k), top_k_picks(b, k)
    ne = pa != pb
    differ = ne.any(-1)
    rows = differ.nonzero()[:, 0]
    first = ne[rows].int().argmax(-1)
    la, lb = b[rows, pa[rows, first]], b[rows, pb[rows, first]]
    gaps = ((la - lb).abs() / bf16_step(torch.maximum(la.abs(), lb.abs())))
    steps = (a - b).abs() / bf16_step(torch.maximum(a.abs(), b.abs()))
    gaps = sorted(gaps.tolist())
    return differ, {
        "tokens": len(a), "differing": len(gaps),
        "differing_share": len(gaps) / len(a),
        "near_ties": sum(g <= ROUTE_TIE_STEPS for g in gaps),
        "gap_steps": gaps[:32], "max_gap_steps": max(gaps, default=None),
        "logits_differing_share": (steps > 0).float().mean().item(),
        "max_logit_diff_steps": steps.max().item()}


def route_problems(stats):
    """The tie rule on one input (:func:`route_compare`'s stats): every
    pick the sides disagree on is a near-tie."""
    bad = []
    if stats["near_ties"] != stats["differing"]:
        bad.append(f"{stats['differing'] - stats['near_ties']} of "
                   f"{stats['differing']} differing picks are no near-tie "
                   f"(gaps {stats['gap_steps']} bf16 steps, rule "
                   f"{ROUTE_TIE_STEPS})")
    return bad


def parity_moe_route_phase(llama, convert, dev, np_params=None):
    """parity_moe's weights (``np_params``, :func:`parity_weights`; drawn
    here when None) and batch at top-2 routing, step 0, card against CPU,
    through layer 0 alone (the gates read layer 0 only; its weights and
    input are those of the 2-layer model).  Layer 0's MoE input is
    captured in the forward on both sides and its picks compared
    (printed: the inputs differ by the attention upstream).  Then layer
    0's moe_layer runs on both sides on the CPU's input: every differing
    pick must be a near-tie, and on the tokens whose picks and kept slots
    agree the output rows and the gradients of a cotangent on those rows
    only meet parity's gates."""
    from horovod_tpu_torch.models import moe
    cfg = bench_config(llama, n_layers=1, **MOE_OVER)
    k = cfg.expert_top_k
    batch, seq = 2, 256
    N, D = batch * seq, cfg.d_model
    C = int(math.ceil(k * N / cfg.n_experts * cfg.capacity_factor))
    cpu = torch.device("cpu")
    if np_params is None:
        np_params = parity_weights(llama, convert, MOE_OVER)
    np_params = {**np_params, "layers": {
        n: w[:cfg.n_layers] for n, w in np_params["layers"].items()}}
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (batch, seq))
    layer_fn, seen = moe.moe_layer, []

    def capture(x, lp, cfg_, par):
        seen.append((x.detach(), lp["router"].detach()))
        return layer_fn(x, lp, cfg_, par)

    def router_logits(x, router):
        return x.reshape(N, D) @ router

    # (params, each layer's (input, router)) on the card, then the CPU
    sides = []
    moe.moe_layer = capture
    try:
        for where in (dev, cpu):
            seen.clear()
            params = convert.llama_params_from_numpy(np_params, device=where)
            with torch.no_grad():
                llama.hidden(params, torch.as_tensor(
                    toks, dtype=torch.long, device=where), cfg)
            sides.append((params, seen[:cfg.n_layers]))
    finally:
        moe.moe_layer = layer_fn
    full = [route_compare(router_logits(*g), router_logits(*c), k)[1]
            for g, c in zip(sides[0][1], sides[1][1])]

    x0 = sides[1][1][0][0]
    runs = []
    for where, (params, _) in zip((dev, cpu), sides):
        lp = {n: params["layers"][0][n].to(cfg.dtype).detach()
              .requires_grad_() for n in ("router", "we_gate", "we_up",
                                          "we_down")}
        x = x0.to(where).requires_grad_()
        y, _ = moe.moe_layer(x, lp, cfg, llama.ParallelSpec())
        with torch.no_grad():
            logits = router_logits(x, lp["router"])
            kept = moe._top_k_dispatch(torch.softmax(logits.float(), -1),
                                       k, C)[0].sum(-1).cpu()
        runs.append((x, lp, y, logits, kept))
    (xg, lpg, yg, lg, kg), (xc, lpc, yc, lc, kc) = runs
    differ, stats = route_compare(lg, lc, k)
    agree = ~differ & (kg == kc).all(-1)
    dy = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (N, D)).astype(np.float32)) * agree[:, None]
    for y in (yg, yc):
        y.backward(dy.to(y.device, y.dtype).reshape(y.shape))
    pairs = {"y_rows": (yg.detach().reshape(N, D)[agree.to(dev)],
                        yc.detach().reshape(N, D)[agree]),
             "dx": (xg.grad, xc.grad),
             **{f"d{n}": (lpg[n].grad, lpc[n].grad) for n in lpg}}
    norms = {n: (a.double().norm().item(), b.double().norm().item())
             for n, (a, b) in pairs.items()}
    cos = {n: cosine(a.cpu(), b) for n, (a, b) in pairs.items()}
    layer0 = {**stats, "capacity": C, "agreeing": int(agree.sum()),
              "picks_agree_kept_differ": int((~differ & ~(kg == kc).all(-1))
                                             .sum()),
              "norms": norms, "cos": cos}
    emit("parity_moe_route", layers=cfg.n_layers, top_k=k,
         capacity_factor=cfg.capacity_factor, batch=batch, seq=seq,
         full_model=full, layer0=layer0)
    bad = route_problems(stats)
    if not agree.any():
        bad.append("no token's picks and slots agree")
    for n, (a, b) in norms.items():
        if abs(a - b) > PARITY_NORM_REL * b:
            bad.append(f"{n} norm {a} (card) vs {b} (cpu)")
        if cos[n] <= PARITY_COS:
            bad.append(f"{n} cos {cos[n]}")
    require(not bad, f"parity_moe_route: {bad}")
    return layer0


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
    widths (SERVE_LAYERS layers), then the ragged bucket against
    sequential decode, then card
    against CPU at 2 layers; none of the six kernels may launch."""
    from horovod_tpu_torch.analysis import recorder
    cfg = bench_config(llama, n_layers=SERVE_LAYERS)
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
        # the first batch's decode calls record their collectives: none
        with (recorder.recording() if not SCHEDULE.get("decode")
              else contextlib.nullcontext()) as rec:
            toks = {k: call() for k, (call, _) in calls.items()}
        if rec is not None:
            SCHEDULE["decode"] = schedule_summary(schedule_row(rec))
            require(not rec.records,
                    f"decode issued collectives: {rec.records[:3]}")
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
    from horovod_tpu_torch.analysis import recorder
    cfg = bench_config(llama, n_layers=SERVE_LAYERS)
    params = serve_params(llama, gen, cfg, dev)
    prompts = serve_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the path's run starts here
    fx.reset_launches()
    # the traffic records its collectives: serving is data parallel, none
    with recorder.recording() as rec:
        row, answers, fwd, batches, after_warmup = serve_run(
            paging, params, cfg, prompts, SERVE_NEW, SERVE_BLOCK,
            SERVE_BATCHES, SERVE_SEQS, SERVE_BURSTS, SERVE_TIMEOUT_S)
    launches = {**fa.LAUNCHES, **fx.LAUNCHES}  # ... and ends here
    SCHEDULE["serve"] = schedule_summary(schedule_row(rec))
    require(not rec.records, f"serve issued collectives: {rec.records[:3]}")
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
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "120",
           "HOROVOD_TIMESERIES_EVERY_S": str(ELASTIC_TIMESERIES_S),
           "HOROVOD_SLO": ELASTIC_SLO}
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
            # the job trace, both workers alive: the driver pulls their
            # span buffers and probes their clocks
            trace_job = elastic_trace_job(driver.port)
            with driver._lock:
                victim = driver._workers[json.loads(marker.read_text())[
                    "wid"]]
            t_kill = time.time()
            os.kill(victim.proc.popen.pid, signal.SIGKILL)
            wait_for(steps_done(6, 2), "steps 4-6 after the kill")
            # both workers wait at the pause of step 6: the job's health
            # and time series from the driver
            health_job = elastic_health_job(driver.port)
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
        trace_job=trace_job, health_job=health_job,
        reference_s=reference_s, elastic_s=elastic_s,
        seconds=time.monotonic() - t_phase)
    emit("elastic_resnet", **row)
    if len(trace_job["clock"]) != 2 or trace_job["unreachable"] or \
            not trace_job["spans"]:
        bad.append(f"GET /trace/job: {trace_job['clock']}, unreachable "
                   f"{trace_job['unreachable']}, {trace_job['spans']} spans")
    bad += health_job_problems(health_job, [r["wid"] for r in steps
                                            if r["step"] == 6])
    if row["seconds"] > ELASTIC_TIMEOUT_S:
        bad.append(f"the phase took {row['seconds']:.1f} s")
    require(not bad, f"elastic_resnet: {bad}")
    return row


def elastic_health_job(port: int) -> dict:
    """``GET /health/job`` from the elastic driver on ``port`` until the
    job is healthy again (the SLO rule recovered) or
    ELASTIC_HEALTH_WAIT_S pass, then one ``GET /timeseries/job``: each
    one's verdict, workers, windows and SLO breaches."""
    import urllib.request

    def get(route):
        t0 = time.monotonic()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/{route}",
                                    timeout=30.0) as resp:
            body = json.loads(resp.read().decode())
        return body, time.monotonic() - t0

    t_end = time.monotonic() + ELASTIC_HEALTH_WAIT_S
    polls = 0
    while True:
        job, seconds = get("health/job")
        polls += 1
        if job["verdict"] == "healthy" or time.monotonic() > t_end:
            break
        time.sleep(0.5)
    ts, ts_seconds = get("timeseries/job")
    return {
        "rule": ELASTIC_SLO, "polls": polls, "seconds": seconds,
        "verdict": job["verdict"], "scraped": job["scraped"],
        "unreachable": job["unreachable"],
        "unmonitored": job["unmonitored"], "workers": job["workers"],
        "counts": job["counts"],
        "slo_verdicts": [{k: v.get(k) for k in ("worker_id", "worker",
                                                "step", "rule", "detail")}
                         for v in job["verdicts"]
                         if v.get("kind") == "slo_breach"],
        "timeseries": {"seconds": ts_seconds, "scraped": ts["scraped"],
                       "unreachable": ts["unreachable"],
                       "workers": ts["workers"],
                       "rates": ts["merged"]["rates"],
                       "active_breaches": ts["slo"]}}


def health_job_problems(hj, workers):
    """``elastic_resnet``'s health and time-series gates: every worker of
    step 6 (``workers``) scraped, monitored and healthy, the job verdict
    healthy, an ``slo_breach`` verdict of ELASTIC_SLO in the history;
    ``/timeseries/job`` with windows from each of them, none
    unreachable."""
    bad = []
    want = sorted(str(w) for w in set(workers))
    if hj["verdict"] != "healthy" or sorted(hj["workers"]) != want or \
            hj["unreachable"] or hj["unmonitored"]:
        bad.append(f"GET /health/job: {hj['verdict']}, workers "
                   f"{sorted(hj['workers'])} (want {want}), unreachable "
                   f"{hj['unreachable']}, unmonitored {hj['unmonitored']}")
    if not any(v["rule"] == ELASTIC_SLO for v in hj["slo_verdicts"]):
        bad.append(f"GET /health/job: no slo_breach verdict of "
                   f"{ELASTIC_SLO}: {hj['counts']}")
    ts = hj["timeseries"]
    have = {w: info.get("windows", 0) for w, info in ts["workers"].items()}
    if ts["unreachable"] or any(have.get(w, 0) < 1 for w in want):
        bad.append(f"GET /timeseries/job: windows by worker {have} (want "
                   f"{want}), unreachable {ts['unreachable']}")
    return bad


def elastic_trace_job(port: int) -> dict:
    """One ``GET /trace/job`` from the elastic driver on ``port``: its
    seconds, each worker's clock offset and error bound, the spans'
    count and their clock-error bounds (µs), the hosts and any
    unreachable worker."""
    import urllib.request
    t0 = time.monotonic()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace/job",
                                timeout=30.0) as resp:
        trace = json.loads(resp.read().decode())
    seconds = time.monotonic() - t0
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    other = trace["otherData"]
    return {"seconds": seconds, "hosts": other["hosts"],
            "clock": other["clock"],
            "unreachable": other.get("unreachable", {}),
            "spans": len(spans),
            "clock_err_us": sorted({e["args"]["clock_err_us"]
                                    for e in spans})}


def tile_digest(dist_state):
    """``[sha256, nonzero]`` of the inner optimizer's state in a
    ``DistributedGradientTransform`` state (this rank's ZeRO tiles'),
    names in sorted order: equal digests mean equal bytes."""
    import hashlib

    from horovod_tpu_torch.optim import recovery_payload
    payload = recovery_payload(dist_state)
    h = hashlib.sha256()
    nonzero = False
    for name in sorted(n for n in payload if n.startswith("inner/")):
        raw = np.ascontiguousarray(payload[name]).tobytes()
        h.update(name.encode() + raw)
        nonzero = nonzero or any(raw)
    return [h.hexdigest(), nonzero]


def recover_child(dev: torch.device, out: str) -> int:
    """One worker of ``recover_resnet`` (``--recover-worker OUT``), under
    the elastic driver or, for the reference run, the static launcher:
    ResNet-50 stepped by hand (forward, loss, backward, then
    ``tx.update``) with a ZeRO ``DistributedGradientTransform`` of SGD
    whose recovery agent (neighbor mode, every boundary; elastic runs
    only) pushes this rank's tile after each update; a TensorState of the
    weights, batch-norm statistics, the transform's state and the step,
    committed every step.  A replacement (epoch > 0) first rebuilds its
    tile from the fleet and installs it (``restore_dist_state``).
    Appends JSON records to ``OUT/worker-<id>.jsonl``: each step's start
    and end (loss, ms, the pushes' ms and bytes, digests of the weights,
    statistics and tile from step RECOVER_KILL_STEP - 1 on, peak memory),
    the restore's step, and the rebuild (version, ms, frame bytes, the
    priced tile bytes, the tile's digest, the worker's own
    hvd_recovery_time_seconds count).  Worker 1 stops in the backward
    pass of step RECOVER_KILL_STEP, writes ``kill.marker`` and waits to be
    killed."""
    import pathlib

    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.elastic import TensorState, worker
    from horovod_tpu_torch.elastic.recovery import (RecoveryAgent,
                                                    priced_tile_bytes)
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.optim import restore_dist_state
    from horovod_tpu_torch.tree import tree_leaves, tree_map
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = pathlib.Path(out)
    elastic = worker.worker_id() is not None
    wid = worker.worker_id() if elastic else int(os.environ["HOROVOD_RANK"])
    log = out / f"worker-{wid}.jsonl"

    def record(kind, **rec):
        with open(log, "a") as f:
            f.write(json.dumps({"kind": kind, "wid": wid, "t": time.time(),
                                "epoch": worker._last_epoch,
                                "rank": hvd.rank(), "size": hvd.size(),
                                **rec}) + "\n")

    pushes = []

    class TimedAgent(RecoveryAgent):
        def _push_one(self, version, frame):
            t0 = time.perf_counter()
            try:
                return super()._push_one(version, frame)
            finally:
                pushes.append({"step": version[1], "bytes": len(frame),
                               "ms": 1e3 * (time.perf_counter() - t0)})

    hvd.init(device=dev)
    cfg = resnet.ResNetConfig(variant=50)
    params, bn = resnet.init(cfg, 0, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    agent = (TimedAgent(rank=hvd.rank(), size=hvd.size(),
                        epoch=worker._last_epoch, mode="neighbor", every=1,
                        driver=worker._driver_endpoint(), worker_id=wid)
             if elastic else None)
    tx = hvd.DistributedGradientTransform(
        functools.partial(torch.optim.SGD, lr=0.01, momentum=0.9),
        sharded_update=True, recovery=agent)
    dist_state = tx.init(params)
    if elastic and worker._last_epoch > 0:
        # a replacement: this rank's tile comes back from the fleet
        t0 = time.perf_counter()
        payload = agent.rebuild(min_epoch=0)
        restore_dist_state(dist_state, payload)
        torch.cuda.synchronize()
        fams = metrics.registry().to_dict()
        record("rebuilt", version=agent.last_rebuild["version"],
               rebuild_ms=1e3 * agent.last_rebuild["seconds"],
               restore_ms=1e3 * (time.perf_counter() - t0),
               frame_bytes=len(agent.store.get_own()[1]),
               priced_bytes=priced_tile_bytes(dist_state.layout),
               tile=tile_digest(dist_state),
               time_count=sum(s["count"] for s in fams.get(
                   "hvd_recovery_time_seconds", {}).get("series", [])))

    class Recorded(TensorState):
        def restore(self):
            super().restore()
            record("restore", step=self.step)

    state = Recorded(params=params, bn=bn, dist=dist_state, step=0)
    if agent is not None:
        # a re-form moves peers: ask the driver for the new plan
        state.register_reset_callbacks([agent._fetch_plan])

    def stop_in_backward(grad):
        (out / "kill.marker").write_text(json.dumps(
            {"wid": wid, "t": time.time()}))
        time.sleep(RECOVER_TIMEOUT_S)
        raise RuntimeError("worker 1 was not killed in its backward pass")

    @hvd.elastic.run
    def train(state):
        while state.step < RECOVER_STEPS:
            step = state.step + 1
            hook = None
            if elastic and wid == 1 and step == RECOVER_KILL_STEP:
                hook = state.params["fc"]["w"].register_hook(
                    stop_in_backward)
            record("begin", step=step)
            images, labels = resnet_batch(RECOVER_BATCH, RESNET_IMG, dev,
                                          seed=1000 * step + hvd.rank())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state.bn = resnet.forward(
                state.params, state.bn, images, cfg, train=True,
                process_set=hvd.global_process_set)
            loss = F.cross_entropy(logits, labels.long())
            loss.backward()
            if hook is not None:
                hook.remove()
            n = len(pushes)
            tx.update(tree_map(lambda p: p.grad, state.params), state.dist,
                      state.params)
            for p in tree_leaves(state.params):
                p.grad = None
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            state.step = step
            rec = dict(step=step, loss=loss.item(), ms=ms,
                       pushes=pushes[n:],
                       peak=torch.cuda.max_memory_allocated())
            if step >= RECOVER_KILL_STEP - 1:
                rec.update(weights=tree_digest(state.params),
                           bn=tree_digest(state.bn),
                           tile=tile_digest(state.dist))
            record("step", **rec)
            state.commit()
        return state.step

    train(state)
    hvd.shutdown()
    return 0


def recover_problems(recs, ref_recs, stats):
    """The gates of ``recover_resnet`` on the elastic run's records, the
    reference's and the driver's ``recovery/stats``: the rebuild's frame
    is rank 1's of (epoch 0, step RECOVER_KILL_STEP - 1), the commit the
    survivor restored; the installed tile is the reference rank 1's
    after that step bit for bit and not all zeros; steps
    RECOVER_KILL_STEP..RECOVER_STEPS (losses, weights and statistics of
    every rank) bit for bit the reference's; the driver lists rank 1's
    rebuild; the replacement observed its rebuild time."""
    bad = []
    last = RECOVER_KILL_STEP - 1
    rebuilt = [r for r in recs if r["kind"] == "rebuilt"]
    restores = [r for r in recs if r["kind"] == "restore"]
    if len(rebuilt) != 1:
        return [f"{len(rebuilt)} rebuilds recorded"]
    rb = rebuilt[0]
    if rb["rank"] != 1 or rb["version"] != [0, last]:
        bad.append(f"rank {rb['rank']} rebuilt version {rb['version']}, "
                   f"expected rank 1's [0, {last}]")
    if [r["step"] for r in restores] != [last]:
        bad.append(f"the survivor restored steps "
                   f"{[r['step'] for r in restores]}, not the rebuilt "
                   f"frame's step {last}")
    ref = {(r["rank"], r["step"]): r for r in ref_recs
           if r["kind"] == "step"}
    ref_tile = ref.get((1, last), {}).get("tile")
    if ref_tile is None or rb["tile"] != ref_tile:
        bad.append(f"the rebuilt tile {rb['tile']} is not the reference "
                   f"rank 1's after step {last}: {ref_tile}")
    if not rb["tile"][1]:
        bad.append("the rebuilt tile is all zeros")
    got = {(r["rank"], r["step"]): r for r in recs if r["kind"] == "step"
           and r["step"] >= RECOVER_KILL_STEP}
    for rank in (0, 1):
        for step in range(RECOVER_KILL_STEP, RECOVER_STEPS + 1):
            a, b = got.get((rank, step)), ref.get((rank, step))
            if a is None or b is None:
                bad.append(f"rank {rank} step {step} missing "
                           f"(elastic {a is not None}, reference "
                           f"{b is not None})")
                continue
            for key in ("loss", "weights", "bn"):
                if a[key] != b[key]:
                    bad.append(f"rank {rank} step {step}: {key} "
                               f"{a[key]} vs the reference's {b[key]}")
    if not any(r.get("src_rank") == 1 for r in stats.get("rebuilds", [])):
        bad.append(f"recovery/stats lists no rebuild of rank 1: {stats}")
    if rb["time_count"] < 1:
        bad.append(f"hvd_recovery_time_seconds count {rb['time_count']}")
    return bad


def recover_resnet_phase(worker_script=None, full_sync=None):
    """``recover_resnet``: the reference run (2 ranks, steps 1-6, through
    ``python -m horovod_tpu_torch.runner``), then the elastic job through
    the port's ElasticDriver in this process over a hostfile of 2 slots;
    the kill in rank 1's backward pass of step RECOVER_KILL_STEP, the
    re-form at size 2 and the replacement's rebuild; the gates of
    :func:`recover_problems` and the numbers (the rebuild's ms, the
    frame's bytes against the priced tile and against ``full_sync``,
    elastic_resnet's sync of this run as ``{"bytes", "ms"}``; push ms a
    step, recover_s, step ms, peak memory).  The workers run
    ``worker_script --recover-worker OUT`` (default: this script)."""
    import pathlib
    import shutil
    import signal
    import socket
    import threading

    from horovod_tpu_torch.elastic import discovery
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.metrics import aggregate
    t_phase = time.monotonic()
    deadline = t_phase + RECOVER_TIMEOUT_S
    root = pathlib.Path(__file__).resolve().parent
    work = root / "build" / "recover_resnet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {"HOROVOD_CONTROLLER": "gloo", "PYTHONPATH": str(root),
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "120"}
    worker_cmd = [sys.executable, str(worker_script or root / "chip_smoke.py"),
                  "--recover-worker"]

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    try:
        ref = work / "reference"
        ref.mkdir()
        t0 = time.monotonic()
        launch = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
             "-p", str(free_port()), "--network-interface", "lo",
             *worker_cmd, str(ref)], cwd=root, env={**os.environ, **env},
            capture_output=True, text=True,
            timeout=max(deadline - time.monotonic(), 1))
        require(launch.returncode == 0, "recover_resnet reference run "
                f"exited {launch.returncode}:\n{launch.stdout[-4000:]}")
        reference_s = time.monotonic() - t0
        ref_recs = elastic_records(ref)

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

        def wait_for(pred, what):
            while True:
                recs = elastic_records(run)
                if pred(recs):
                    return recs
                require(time.monotonic() < deadline and thread.is_alive(),
                        f"recover_resnet: {what} (driver "
                        f"{'alive' if thread.is_alive() else result})")
                time.sleep(0.05)

        try:
            marker = run / "kill.marker"
            wait_for(lambda _: marker.exists(), "worker 1 never reached "
                     f"the backward pass of step {RECOVER_KILL_STEP}")
            with driver._lock:
                victim = driver._workers[json.loads(marker.read_text())[
                    "wid"]]
            t_kill = time.time()
            os.kill(victim.proc.popen.pid, signal.SIGKILL)
            wait_for(lambda recs: any(r["kind"] == "rebuilt"
                                      for r in recs), "no rebuild")
            stats = json.loads(aggregate.scrape(
                "127.0.0.1", driver.port, route="recovery/stats"))
            thread.join(max(deadline - time.monotonic(), 0.1))
            require(not thread.is_alive(), "recover_resnet: the driver "
                    "did not finish")
        finally:
            driver._terminate_all()
            driver._server.close()
        elastic_s = time.monotonic() - t0
        recs = elastic_records(run)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    bad, _ = transition_problems(events, RECOVER_FORMED_SIZES)
    if result.get("rc") != 0:
        bad.append(f"the driver exited {result.get('rc')}")
    bad += recover_problems(recs, ref_recs, stats)
    steps = [r for r in recs if r["kind"] == "step"]
    bad += [f"step {r['step']} rank {r['rank']}: loss {r['loss']}"
            for r in steps + ref_recs if r["kind"] == "step"
            and not math.isfinite(r["loss"])]
    rb = next((r for r in recs if r["kind"] == "rebuilt"), {})
    pushes = [p for r in steps for p in r["pushes"]]
    first_after = min((r["t"] for r in steps
                       if r["step"] == RECOVER_KILL_STEP), default=None)
    row = dict(
        model="resnet50", image=RESNET_IMG, batch_per_rank=RECOVER_BATCH,
        backend="gloo", mode="neighbor", every=1,
        formed=[[info["epoch"], info["size"]] for name, info in events
                if name == "epoch_formed"],
        rebuilt_version=rb.get("version"),
        rebuild_ms=rb.get("rebuild_ms"), restore_ms=rb.get("restore_ms"),
        frame_bytes=rb.get("frame_bytes"),
        priced_tile_bytes=rb.get("priced_bytes"),
        full_sync=full_sync,
        push_ms=[[p["step"], p["ms"]] for p in pushes],
        push_bytes=sorted({p["bytes"] for p in pushes}),
        recover_s=(None if first_after is None else first_after - t_kill),
        step_ms={f"{r['rank']}:{r['step']}:{r['epoch']}": r["ms"]
                 for r in steps},
        reference_step_ms={f"{r['rank']}:{r['step']}": r["ms"]
                           for r in ref_recs if r["kind"] == "step"},
        peak_bytes={wid: max(r["peak"] for r in steps if r["wid"] == wid)
                    for wid in sorted({r["wid"] for r in steps})},
        losses={r["step"]: r["loss"] for r in steps if r["rank"] == 0},
        rebuilds_on_stats=stats.get("rebuilds"),
        exits=[info for name, info in events if name == "worker_exit"],
        reference_s=reference_s, elastic_s=elastic_s,
        seconds=time.monotonic() - t_phase)
    emit("recover_resnet", **row)
    if row["seconds"] > RECOVER_TIMEOUT_S:
        bad.append(f"the phase took {row['seconds']:.1f} s")
    require(not bad, f"recover_resnet: {bad}")
    return row


def hvd_run_probe():
    """``hvd_run``'s function: this rank's allreduced CUDA tensor of its
    rank, as ``(rank, size, value, device name)``."""
    import horovod_tpu_torch as hvd
    dev = hvd.runtime._state().device
    t = torch.full((4,), float(hvd.rank()), device=dev)
    value = hvd.allreduce(t, op=hvd.Sum, name="hvd_run.probe")
    return (hvd.rank(), hvd.size(), value.tolist(),
            torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def hvd_run_count():
    """A module-level counter that outlives a task in the executor's
    worker: 1, 2, ... on each call in one process."""
    global _HVD_RUN_CALLS
    _HVD_RUN_CALLS = globals().get("_HVD_RUN_CALLS", 0) + 1
    return _HVD_RUN_CALLS


def hvd_run_fail():
    raise ValueError("hvd_run: a deliberate failure")


def hvd_run_problems(res):
    """``hvd_run``'s gates on ``{"run2", "run1", "counts", "remote",
    "failure"}``: the probes' results in rank order with the sums of the
    ranks, the counter 1 then 2 on both workers, the failing function
    raised."""
    bad = []

    def probes(got, n, what):
        want_sum = float(sum(range(n)))
        ranks = [r[0] for r in got]
        if ranks != list(range(n)):
            bad.append(f"{what}: results in rank order {ranks}")
        for r in got:
            if r[1] != n or r[2] != [want_sum] * 4:
                bad.append(f"{what}: rank {r[0]} got size {r[1]}, value "
                           f"{r[2]}, expected {n}, {want_sum}")

    probes(res["run2"], 2, "run(np=2)")
    probes(res["run1"], 1, "run(np=1)")
    probes(res["remote"], 2, "run_remote/fetch")
    if res["counts"] != [[1, 1], [2, 2]]:
        bad.append(f"the executor's counter read {res['counts']}")
    if not res["failure"]:
        bad.append("a failing function did not raise RuntimeError")
    return bad


def hvd_run_phase(device="cuda:0"):
    """``hvd_run``: ``hvd.run`` of :func:`hvd_run_probe` at np 2 over gloo
    (two ranks sharing ``device``) and at np 1 over NCCL, a failing
    function, and ``TpuExecutor(np=2)`` over gloo: the counter across two
    ``run`` calls and ``run_remote``/``fetch`` of the probe; the four
    launches run at once, each timed from its start.  The
    functions are this module's as imported by name (``import
    chip_smoke``), so plain ``pickle`` finds them in the workers too."""
    import pathlib
    import socket

    import chip_smoke as mod
    from horovod_tpu_torch import runner
    t_phase = time.monotonic()
    root = pathlib.Path(__file__).resolve().parent
    env = {"PYTHONPATH": str(root)}
    gloo = {**env, "HOROVOD_CONTROLLER": "gloo"}

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def timed_call(key, fn):
        t0 = time.perf_counter()
        try:
            return key, fn(), 1e3 * (time.perf_counter() - t0)
        except RuntimeError:
            return key, None, 1e3 * (time.perf_counter() - t0)

    def executor():
        with runner.TpuExecutor(np=2, env=gloo, port=free_port(),
                                device=device) as ex:
            counts = [ex.run(mod.hvd_run_count) for _ in range(2)]
            return counts, ex.fetch(ex.run_remote(mod.hvd_run_probe))

    # the four launches at once: each is mostly its workers' start
    calls = {
        "run2": lambda: runner.run(mod.hvd_run_probe, np=2, env=gloo,
                                   port=free_port(), device=device),
        "run1": lambda: runner.run(mod.hvd_run_probe, np=1, env=env,
                                   port=free_port(), device=device),
        "failure": lambda: runner.run(mod.hvd_run_fail, np=2, env=gloo,
                                      port=free_port(), device=device,
                                      prefix_output=False),
        "executor": executor}
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        done = list(pool.map(lambda kv: timed_call(*kv), calls.items()))
    res = {key: out for key, out, _ in done}
    ms = {key: t for key, _, t in done}
    require(res["run2"] is not None and res["run1"] is not None
            and res["executor"] is not None,
            f"hvd_run: a launch failed: {res}")
    # the failing function's launch must have raised RuntimeError
    res["failure"] = res["failure"] is None
    res["counts"], res["remote"] = res.pop("executor")
    emit("hvd_run", **res, ms=ms, seconds=time.monotonic() - t_phase)
    bad = hvd_run_problems(res)
    require(not bad, f"hvd_run: {bad}")
    return res


def native_objects(hvd) -> dict:
    """Where each control-plane object of the runtime's engine lives: the
    planner and its response cache, the controller's decision, the
    timeline's writer and the stall inspector's tracker (the native core's
    module, or the Python one's; None where there is no native object)."""
    eng = hvd.runtime._state().engine
    return {"planner": eng._plan_fn.__module__,
            "cache": type(eng._cache).__module__,
            "decision": getattr(eng._controller._core, "__name__", None),
            "timeline": getattr(eng.timeline._core, "__name__", None),
            "stall": type(eng.stall._native).__module__}


def native_object_problems(what: str, objects) -> list:
    """``objects`` (one :func:`native_objects` dict, or one a rank) all on
    the native core."""
    ranks = objects if isinstance(objects, list) else [objects]
    return [f"{what}: rank {r}'s {k} is {v}, not {NATIVE_MODULE}"
            for r, objs in enumerate(ranks) for k, v in objs.items()
            if v != NATIVE_MODULE]


@contextlib.contextmanager
def record_plans(owner, attr: str):
    """Wrap the planner ``owner.attr`` (``(sigs, threshold) -> buckets``)
    so that each call is kept as ``(sigs, threshold, buckets)``; yields
    the list, and puts the planner back at the block's exit."""
    plan_fn, calls = getattr(owner, attr), []

    def recording(sigs, threshold):
        buckets = plan_fn(sigs, threshold)
        calls.append((list(sigs), threshold, buckets))
        return buckets

    setattr(owner, attr, recording)
    try:
        yield calls
    finally:
        setattr(owner, attr, plan_fn)


def build_native_core():
    """Build the native core (``python -m horovod_tpu_torch.native.build``
    does the same); returns its line's fields."""
    from horovod_tpu_torch.native import build
    t0 = time.perf_counter()
    path = build.build()
    return {"build_seconds": time.perf_counter() - t0,
            "compiler": build.compiler(),
            "include_dir": build.include_dir(), "artifact": str(path)}


def decide_multisets(world: int, seed: int):
    """Seeded announced-token multisets of ``world`` processes and the
    active ones (the rest joined): repeats, grouped tokens, a rank that
    announced nothing."""
    rng = np.random.RandomState(seed)

    def token(names):
        return json.dumps({"s": [[n, "allreduce", "sum", "float32", [4], 0,
                                  False, -1 if len(names) == 1 else 0,
                                  None, None, "none", "strict",
                                  "replicated"] for n in names],
                           "r": 0, "sp": None},
                          separators=(",", ":"), sort_keys=True)

    pool = [token([f"t{i}"]) for i in range(12)]
    pool += [token([f"g{i}.0", f"g{i}.1"]) for i in range(3)]
    full = {q: [pool[i] for i in rng.randint(0, len(pool),
                                             rng.randint(0, 16))]
            for q in range(world)}
    active = sorted(int(q) for q in rng.choice(
        world, rng.randint(1, world + 1), replace=False))
    return full, active


def host_us(fn, calls: int) -> float:
    """Median host microseconds of one call of ``fn`` over ``calls``."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    return float(np.median(times))


def native_core_phase(build_row, dp_plans, overlap_plans, objects):
    """``native_core``: the native planner's buckets against the Python
    planner's on every signature list ``train_dp``'s engine planned and
    ``train_overlap``'s taps planned (``record_plans``), and
    ``plan_dispatch_sigs`` against ``plan_dispatch`` on the latter;
    ``negotiate_decide`` against the controller's Python arithmetic on
    :func:`decide_multisets` at NATIVE_WORLDS; each planner's host us a
    call on ``train_dp``'s largest list; ``objects``: train_dp's runtime
    on the core.  Host code only: it runs alike on the CPU."""
    from collections import Counter

    from horovod_tpu_torch.native import loader
    from horovod_tpu_torch.ops import controller, fusion
    core = loader.load()
    bad = native_object_problems("train_dp", objects)
    if not dp_plans or not overlap_plans:
        bad.append(f"no plan recorded: train_dp {len(dp_plans)}, "
                   f"train_overlap {len(overlap_plans)}")
    for what, plans in (("train_dp", dp_plans),
                        ("train_overlap", overlap_plans)):
        for sigs, threshold, buckets in plans:
            want = fusion.plan_fusion(sigs, threshold)
            if buckets != want or core.plan_fusion_sigs(
                    sigs, threshold) != want:
                bad.append(f"{what}: the native plan of {len(sigs)} "
                           f"signatures at {threshold} B differs from "
                           f"plan_fusion's")
    for sigs, _, buckets in overlap_plans:
        want = fusion.plan_dispatch(sigs, buckets)
        if core.plan_dispatch_sigs(sigs, buckets) != (want.order,
                                                      want.layers):
            bad.append("train_overlap: plan_dispatch_sigs differs from "
                       "plan_dispatch")
    decide = {}
    python, native = controller.Controller(), controller.Controller(
        core=core)
    for world in NATIVE_WORLDS:
        same = 0
        for seed in range(NATIVE_DECIDE_SEEDS):
            full, active = decide_multisets(world, 1000 * world + seed)
            counters = {q: Counter(full[q]) for q in full}
            tokens = sorted(set().union(*map(set, counters.values())))
            same += (native._decide_counts(full, active, counters, tokens)
                     == python._decide_counts(full, active, counters,
                                              tokens))
        decide[world] = same
        if same != NATIVE_DECIDE_SEEDS:
            bad.append(f"negotiate_decide at world {world}: {same} of "
                       f"{NATIVE_DECIDE_SEEDS} decisions equal Python's")
    timing = {}
    if dp_plans:
        sigs, threshold, _ = max(dp_plans, key=lambda p: len(p[2]))
        timing = {
            "signatures": len(sigs), "threshold": threshold,
            "buckets": len(fusion.plan_fusion(sigs, threshold)),
            "plan_fusion_us": host_us(
                lambda: fusion.plan_fusion(sigs, threshold),
                NATIVE_TIMING_CALLS),
            "plan_fusion_sigs_us": host_us(
                lambda: core.plan_fusion_sigs(sigs, threshold),
                NATIVE_TIMING_CALLS)}
    row = dict(build_row, objects=objects,
               train_dp_lists=[[len(s), len(b)] for s, _, b in dp_plans],
               train_overlap_lists=[[len(s), len(b)]
                                    for s, _, b in overlap_plans],
               decide_equal_by_world=decide, timing_calls=NATIVE_TIMING_CALLS,
               planner_host_us=timing)
    emit("native_core", **row)
    require(not bad, f"native_core: {bad}")
    return row


class EstimatorMnist(torch.nn.Module):
    """models/mnist.py's convnet at MnistConfig's widths as an
    ``nn.Module`` (the estimator ships modules): its parameters are
    ``mnist.init``'s, seeded, on the CPU; its forward is
    ``mnist.forward`` (bf16 convolutions and fc1, fp32 fc2)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        from horovod_tpu_torch.models import mnist
        p = mnist.init(mnist.MnistConfig(), seed, device="cpu")
        self.conv1 = torch.nn.Parameter(p["conv1"])
        self.conv2 = torch.nn.Parameter(p["conv2"])
        self.fc1_w = torch.nn.Parameter(p["fc1"]["w"])
        self.fc1_b = torch.nn.Parameter(p["fc1"]["b"])
        self.fc2_w = torch.nn.Parameter(p["fc2"]["w"])
        self.fc2_b = torch.nn.Parameter(p["fc2"]["b"])

    def forward(self, images):
        from horovod_tpu_torch.models import mnist
        return mnist.forward(
            {"conv1": self.conv1, "conv2": self.conv2,
             "fc1": {"w": self.fc1_w, "b": self.fc1_b},
             "fc2": {"w": self.fc2_w, "b": self.fc2_b}},
            images, mnist.MnistConfig())


def estimator_optimizer(params):
    """The estimator's optimizer factory: SGD with momentum, after
    setting cuDNN deterministic and TF32 off; in an estimator worker this
    is the first code of this script that runs, before the first step."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.optim.SGD(params, lr=ESTIMATOR_LR, momentum=0.9)


def estimator_data():
    """ESTIMATOR_IMAGES seeded ``[N, 1, 28, 28]`` images in [0, 1) and
    int64 labels: the argmax of a seeded linear map of the pixels."""
    rng = np.random.RandomState(ESTIMATOR_SEED)
    X = rng.rand(ESTIMATOR_IMAGES, 1, 28, 28).astype(np.float32)
    w = rng.randn(28 * 28, 10).astype(np.float32)
    return X, (X.reshape(len(X), -1) @ w).argmax(1).astype(np.int64)


def estimator_reference(model, X, y, dev, world: int = 2):
    """The estimator's fit in this process, rank by rank: each rank's
    shard (``X[r::world]``), its order (``torch.randperm`` from a
    generator seeded ``seed + r``) and its batches as
    ``estimator/_worker.py`` takes them; at each step every rank's
    gradient in turn, summed in rank order and divided by ``world`` as
    the port's ``DistributedOptimizer`` reduces them, then one optimizer
    step; each epoch's loss the ranks' mean losses averaged likewise.
    Returns (history, model)."""
    import torch.nn.functional as F
    model = model.to(dev)
    opt = estimator_optimizer(model.parameters())
    params = list(model.parameters())
    shards = [(torch.from_numpy(np.ascontiguousarray(X[r::world])),
               torch.from_numpy(np.ascontiguousarray(y[r::world])))
              for r in range(world)]
    gens = [torch.Generator().manual_seed(ESTIMATOR_SEED + r)
            for r in range(world)]
    steps = min(len(xs) // ESTIMATOR_BATCH for xs, _ in shards)
    history = []
    for _ in range(ESTIMATOR_EPOCHS):
        orders = [torch.randperm(len(xs), generator=g)
                  for (xs, _), g in zip(shards, gens)]
        epoch_loss = [0.0] * world
        for s in range(steps):
            grads = []
            for r, (xs, ys) in enumerate(shards):
                idx = orders[r][s * ESTIMATOR_BATCH:(s + 1) * ESTIMATOR_BATCH]
                opt.zero_grad()
                loss = F.cross_entropy(model(xs[idx].to(dev)),
                                       ys[idx].to(dev))
                loss.backward()
                grads.append([p.grad.clone() for p in params])
                epoch_loss[r] += float(loss.detach())
            for i, p in enumerate(params):
                total = grads[0][i].clone()
                for g in grads[1:]:
                    total.add_(g[i])
                p.grad = total.div_(world)
            opt.step()
        means = [torch.tensor(e / max(steps, 1), device=dev)
                 for e in epoch_loss]
        total = means[0].clone()
        for m in means[1:]:
            total.add_(m)
        history.append(float(total.div_(world)))
    return history, model


def estimator_phase(device="cuda:0"):
    """``estimator``: ``TorchEstimator.fit`` of :class:`EstimatorMnist` at
    np 2 (gloo ranks sharing ``device``) with a FilesystemStore under
    ``build/``; the loss falls, the fitted weights and the loss history
    are :func:`estimator_reference`'s bit for bit (cuDNN deterministic),
    the Store's checkpoint holds CPU tensors and reloads bit for bit, and
    ``predict`` runs on ``device``.  The model class, the optimizer
    factory and the loss are names of modules the workers import (this
    one as ``chip_smoke``), so plain ``pickle`` finds them."""
    import io
    import pathlib
    import shutil
    import socket
    import tempfile

    import torch.nn.functional as F

    import chip_smoke as mod
    from horovod_tpu_torch.estimator import (FilesystemStore,
                                             TorchEstimator, load_model)
    t_phase = time.perf_counter()
    dev = torch.device(device)
    root = pathlib.Path(__file__).resolve().parent
    X, y = estimator_data()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    (root / "build").mkdir(exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="estimator-", dir=root / "build")
    try:
        store = FilesystemStore(store_dir)
        est = TorchEstimator(
            model=mod.EstimatorMnist(ESTIMATOR_SEED),
            optimizer=mod.estimator_optimizer, loss=F.cross_entropy,
            epochs=ESTIMATOR_EPOCHS, batch_size=ESTIMATOR_BATCH, np=2,
            store=store, run_id="estimator", seed=ESTIMATOR_SEED,
            env={"PYTHONPATH": str(root), "HOROVOD_CONTROLLER": "gloo",
                 "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "120"},
            port=port, device=dev)
        t0 = time.perf_counter()
        fitted = est.fit(X, y)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_history, ref = estimator_reference(
            mod.EstimatorMnist(ESTIMATOR_SEED), X, y, dev)
        ref_s = time.perf_counter() - t0
        got, want = fitted.model.state_dict(), ref.state_dict()
        differing = [k for k in want if not torch.equal(got[k], want[k])]
        ckpt = store.load_checkpoint("estimator")
        saved = torch.load(io.BytesIO(ckpt["model"]), weights_only=False)
        saved_devices = sorted({p.device.type for p in saved.parameters()})
        reloaded = load_model(store, "estimator", device=dev)
        reload_equal = all(torch.equal(v, got[k]) for k, v in
                           reloaded.model.state_dict().items())
        rows = X[:ESTIMATOR_PREDICT_ROWS]
        t0 = time.perf_counter()
        preds = fitted.predict(rows)
        predict_ms = 1e3 * (time.perf_counter() - t0)
        with torch.no_grad():
            ref_preds = ref(torch.from_numpy(rows).to(dev)).cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
        shutil.rmtree(store_dir, ignore_errors=True)
    row = dict(
        device=str(dev), np=2, images=ESTIMATOR_IMAGES,
        batch=ESTIMATOR_BATCH, epochs=ESTIMATOR_EPOCHS,
        history=fitted.history, reference_history=ref_history,
        differing_leaves=differing, checkpoint_devices=saved_devices,
        reload_equal=reload_equal, predict_shape=list(preds.shape),
        predict_device=str(fitted.device),
        predict_equal=bool(np.array_equal(preds, ref_preds)),
        predict_ms=predict_ms, fit_seconds=fit_s, reference_seconds=ref_s,
        seconds=time.perf_counter() - t_phase)
    emit("estimator", **row)
    bad = estimator_problems(row)
    require(not bad, f"estimator: {bad}")
    return row


def estimator_problems(row) -> list:
    """``estimator``'s gates on its line's fields."""
    bad = []
    hist = row["history"]
    if len(hist) != ESTIMATOR_EPOCHS or not all(map(math.isfinite, hist)):
        bad.append(f"history {hist}")
    elif not hist[-1] < hist[0]:
        bad.append(f"the loss did not fall: {hist}")
    if hist != row["reference_history"]:
        bad.append(f"history {hist} is not the reference's "
                   f"{row['reference_history']}")
    if row["differing_leaves"]:
        bad.append(f"fitted leaves differ from the reference's: "
                   f"{row['differing_leaves']}")
    if row["checkpoint_devices"] != ["cpu"]:
        bad.append(f"the checkpoint holds {row['checkpoint_devices']} "
                   f"tensors")
    if not row["reload_equal"]:
        bad.append("load_model's weights differ from the fitted ones")
    if row["predict_shape"] != [ESTIMATOR_PREDICT_ROWS, 10] or \
            not row["predict_equal"]:
        bad.append(f"predict gave {row['predict_shape']}, equal to the "
                   f"reference's: {row['predict_equal']}")
    return bad


ADAPTERS_CHILD = """
import json, sys
import horovod_tpu_torch, horovod_tpu_torch.torch, horovod_tpu_torch.estimator
from horovod_tpu_torch import runner
from horovod_tpu_torch.estimator import KerasEstimator
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("tensorflow", "keras"))
errors = {}
for sub in ("tensorflow", "keras", "mxnet"):
    try:
        __import__("horovod_tpu_torch." + sub)
        errors[sub] = None
    except ImportError as exc:
        errors[sub] = [type(exc).__name__, str(exc)]
launched = []
runner.run = lambda *a, **k: launched.append(1)
try:
    KerasEstimator(model=None, optimizer="sgd", loss="mse", np=2).fit(
        [[0.0]], [[0.0]])
    errors["KerasEstimator.fit"] = None
except ImportError as exc:
    errors["KerasEstimator.fit"] = [type(exc).__name__, str(exc)]
print(json.dumps({"loaded": loaded, "errors": errors,
                  "launched": len(launched)}))
"""

#: the package each ImportError must name, by what was imported
ADAPTERS_MISSING = {"tensorflow": "tensorflow", "keras": "tensorflow",
                    "mxnet": "mxnet", "KerasEstimator.fit": "tensorflow"}


def adapters_absent():
    """The import rules without TensorFlow, in a child interpreter (its
    ``sys.modules`` clean): ``horovod_tpu_torch``, ``.torch`` and
    ``.estimator`` load no TensorFlow or Keras; ``.tensorflow``,
    ``.keras`` and ``.mxnet`` raise an ImportError naming the missing
    package and the port's torch path; ``KerasEstimator.fit`` raises one
    before launching a worker.  A caller that hid TensorFlow
    (``sys.modules["tensorflow"] = None``) hides it from the child too."""
    root = os.path.dirname(os.path.abspath(__file__))
    prelude = ('import sys; sys.modules["tensorflow"] = None\n'
               if "tensorflow" in sys.modules
               and sys.modules["tensorflow"] is None else "")
    res = subprocess.run([sys.executable, "-c", prelude + ADAPTERS_CHILD],
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    require(res.returncode == 0,
            f"adapters: the import child failed: {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def adapters_absent_problems(got) -> list:
    bad = []
    if got["loaded"]:
        bad.append(f"importing the port loaded {got['loaded']}")
    if got["launched"]:
        bad.append("KerasEstimator.fit launched a worker")
    for what, package in ADAPTERS_MISSING.items():
        err = got["errors"].get(what)
        if err is None or err[0] != "ImportError":
            bad.append(f"{what}: no ImportError ({err})")
            continue
        named = (package, "horovod_tpu_torch.torch")
        if not all(n in err[1] for n in named):
            bad.append(f"{what}: the error does not name {named}: "
                       f"{err[1]}")
    return bad


def adapters_present(device):
    """tests/helpers_runner.py ``tf_training_fn``'s toy over
    ``horovod_tpu_torch.tensorflow`` at world 1 on ``device`` (NCCL on the
    card): ``ADAPTERS_STEPS`` steps through ``DistributedGradientTape``,
    eagerly and under ``tf.function(jit_compile=True)``, against the
    plain TF loop; each weight's largest difference."""
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd
    from horovod_tpu_torch import runtime

    X = np.random.RandomState(3).randn(8, 2).astype("f4")
    y = (X @ np.array([[1.0], [-0.5]], dtype="f4")).astype("f4")
    Xs, ys = tf.constant(X[:4]), tf.constant(y[:4])

    def train(distributed: bool, jit: bool):
        w = tf.Variable([[0.2], [0.1]])

        def step():
            tape = tf.GradientTape()
            if distributed:
                tape = hvd.DistributedGradientTape(tape)
            with tape:
                loss = tf.reduce_mean((tf.matmul(Xs, w) - ys) ** 2)
            w.assign_sub(0.5 * tape.gradient(loss, [w])[0])

        fn = tf.function(step, jit_compile=True) if jit else step
        for _ in range(ADAPTERS_STEPS):
            fn()
        return w.numpy()

    hvd.init(device=device)
    try:
        backend = runtime._state().backend
        ref = train(False, False)
        eager, jit = train(True, False), train(True, True)
    finally:
        hvd.shutdown()
    return {"tensorflow": tf.__version__, "backend": backend,
            "weights": ref.ravel().tolist(),
            "max_abs_err": {"eager": float(np.abs(eager - ref).max()),
                            "jit": float(np.abs(jit - ref).max())}}


def adapters_phase(device="cuda:0"):
    """``adapters``: the TF/Keras adapters where the card's machine runs
    them.  Without TensorFlow (the card's machine): the import rules
    (:func:`adapters_absent`).  With it: the toy's steps
    (:func:`adapters_present`) within ``ADAPTERS_TOL`` of plain TF.  The
    line says which branch ran; either failing fails the run."""
    import importlib.util
    t0 = time.perf_counter()
    if importlib.util.find_spec("tensorflow") is None:
        got = adapters_absent()
        row = {"branch": "absent", "tensorflow": "absent",
               "messages": {k: (v[1] if v else None)
                            for k, v in got["errors"].items()},
               "loaded": got["loaded"], "launched": got["launched"]}
        bad = adapters_absent_problems(got)
    else:
        row = {"branch": "present", **adapters_present(device)}
        bad = [f"{mode}: {err} > {ADAPTERS_TOL}"
               for mode, err in row["max_abs_err"].items()
               if not err <= ADAPTERS_TOL]
    row["seconds"] = time.perf_counter() - t0
    emit("adapters", **row)
    require(not bad, f"adapters: {bad}")
    return row


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
    if "--hier-rank" in sys.argv:
        return hier_child(int(sys.argv[sys.argv.index("--hier-rank") + 1]),
                          dev)
    if "--mp-rank" in sys.argv:
        return mp_child(int(sys.argv[sys.argv.index("--mp-rank") + 1]), dev)
    if "--ep-rank" in sys.argv:
        return ep_child(int(sys.argv[sys.argv.index("--ep-rank") + 1]), dev)
    for flag, child in (("--spec-rank", spec_child),
                        ("--pp-rank", pp_child),
                        ("--bert-mp-rank", bert_mp_child),
                        ("--fsdp-rank", fsdp_child),
                        ("--serve-mp-rank", serve_mp_child)):
        if flag in sys.argv:
            return child(int(sys.argv[sys.argv.index(flag) + 1]), dev)
    if "--resnet-dp2-rank" in sys.argv:
        return resnet_dp2_child(
            int(sys.argv[sys.argv.index("--resnet-dp2-rank") + 1]), dev)
    if "--elastic-worker" in sys.argv:
        return elastic_child(
            dev, sys.argv[sys.argv.index("--elastic-worker") + 1])
    if "--recover-worker" in sys.argv:
        return recover_child(
            dev, sys.argv[sys.argv.index("--recover-worker") + 1])
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

    # the native core's g++ alongside the kernels' nvccs
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(build_native_core)
        build_s = _build.build_all()
        native_build = native_build.result()
    wgmma_spills, other_spills, problems = spill_check(_build.PTXAS_REPORT)
    xent_lib = _build.library("fused_xent")
    active = {f"{k}_active_clusters": {
        D: getattr(xent_lib, f"hvd_xent_{k}_active_clusters")(D)
        for D in XENT_DIMS} for k in ("dh", "dw")}
    active["fwd_active_clusters"] = xent_lib.hvd_xent_fwd_active_clusters()
    emit("build", seconds=build_s, ptxas=_build.PTXAS_REPORT,
         wgmma_spills=wgmma_spills, other_spills=other_spills,
         native_core=native_build, **active)
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
    weights = timed("parity", parity_phase, llama, training, adamw_lp,
                    convert, dev, fused=False)
    timed("parity_fused", parity_phase, llama, training, adamw_lp, convert,
          dev, fused=True, np_params=weights)
    # the mixture of experts at world 1: 4 layers at the 1B widths, then
    # 2 layers card against CPU
    launches_moe, _ = timed(
        "train_moe", train_phase, fa, fx, llama, training, adamw_lp, dev,
        fused=False, name="train_moe",
        over={**MOE_OVER, "n_layers": MOE_LAYERS},
        expected=EXPECTED_MOE_LAUNCHES)
    weights = timed("parity_moe", parity_phase, llama, training, adamw_lp,
                    convert, dev, fused=False, name="parity_moe",
                    over=PARITY_MOE_OVER)
    timed("parity_moe_route", parity_moe_route_phase, llama, convert, dev,
          np_params=weights)
    del weights

    # the Horovod core at world 1 over NCCL: every op, the train step with
    # its gradients through the engine, then overlapped through the grad
    # taps
    # train_dp's engine and train_overlap's taps record the signature
    # lists they plan, for native_core
    from horovod_tpu_torch.optim import overlap as ov
    hvd.init()
    try:
        require(hvd.runtime._state().backend == "nccl" and hvd.size() == 1,
                f"hvd.init() on the card: {hvd.runtime._state().backend}, "
                f"size {hvd.size()}")
        timed("collectives", collectives_phase, hvd, dev)
        engine = hvd.runtime._state().engine
        with record_plans(engine, "_plan_fn") as dp_plans:
            _, train_dp = timed("train_dp", train_phase, fa, fx, llama,
                                training, adamw_lp, dev, fused=False,
                                engine=engine)
        dp_objects = native_objects(hvd)
        with record_plans(ov, "plan_fusion") as overlap_plans:
            train_overlap = timed("train_overlap", overlap_phase, fa, fx,
                                  llama, training, adamw_lp, dev,
                                  wire=False)
    finally:
        hvd.shutdown()
    timed("native_core", native_core_phase, native_build, dp_plans,
          overlap_plans, dp_objects)
    emit("train_dp_vs_train", **{
        k: [train_dp[k], train[k]] for k in ("losses", "step_ms",
                                             "max_memory_allocated")},
         device_busy_ms=[train_dp["profile"]["device_busy_ms"],
                         train["profile"]["device_busy_ms"]])
    require(train_dp["losses"] == train["losses"],
            f"train_dp losses {train_dp['losses']} are not train's "
            f"{train['losses']}")
    # its first timed step ran with the schedule recorder armed
    bad = dp_schedule_problems(train_dp["schedule"],
                               train_dp["gradient_plane"][0])
    require(not bad, f"train_dp schedule: {bad}")
    SCHEDULE["train_dp"] = schedule_summary(train_dp["schedule"])
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
    # train_dp's step again with the timeline and the autotuner on: the
    # runtime reads their knobs at init
    os.makedirs("build", exist_ok=True)
    os.environ.update(TOOLS_ENV)
    hvd.init()
    try:
        tools = timed("train_dp_tools", tools_phase, hvd, fa, fx, llama,
                      training, adamw_lp, dev)
    finally:
        hvd.shutdown()
        for k in TOOLS_ENV:
            os.environ.pop(k)
    emit("train_dp_tools_vs_train_dp",
         step_ms=[tools["step_ms"], train_dp["step_ms"]],
         engine_host_ms=[tools["engine_host_ms"],
                         [st["dispatch_ms"]
                          for st in train_dp["gradient_plane"]]])
    bad = tools_problems(tools, train, expected)
    require(not bad, f"train_dp_tools: {bad}")
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
    # train_dp's step with the tracer off and on, then under the profiler
    trace = timed("trace_dp", trace_dp_phase, hvd, llama, training,
                  adamw_lp, dev)
    bad = trace_problems(trace, train_dp["losses"])
    require(not bad, f"trace_dp: {bad}")
    # the health-armed transform: clean, then under the corrupt rules
    health_dp = timed("health_dp", health_dp_phase, hvd, fa, llama,
                      training, adamw_lp, dev)
    bad = health_problems(health_dp, EXPECTED_LAUNCHES)
    require(not bad, f"health_dp: {bad}")
    torch.cuda.empty_cache()
    timed("train_dp2", train_dp2_phase, train_dp["schedule"])
    timed("train_a5_dp2", train_a5_dp2_phase)
    timed("train_hier_dp4", train_hier_dp4_phase)
    # the model-parallel Llama: tp x sp (ring, then Ulysses) and experts
    # over dp, gloo ranks sharing the card
    mp = timed("train_tp2_sp2", train_tp2_sp2_phase)
    # the spec-aware gradient transform over dp x tp
    spec = timed("train_tp2_dp2_spec", train_tp2_dp2_spec_phase)
    ep = timed("train_moe_ep2", train_moe_ep2_phase)
    # the pipeline, BERT's tp x sp, FSDP and model-parallel serving, gloo
    # ranks sharing the card
    pp = timed("train_pp2", train_pp2_phase, train["losses"])
    bert_mp = timed("bert_tp2_sp2", bert_tp2_sp2_phase)
    fsdp = timed("train_fsdp_dp2", train_fsdp_dp2_phase)
    timed("serve_mp2", serve_mp2_phase)
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
    elastic = timed("elastic_resnet", elastic_resnet_phase)
    timed("recover_resnet", recover_resnet_phase,
          full_sync={"bytes": sorted(set(elastic["sync_bytes"])),
                     "ms": elastic["sync_ms"]})
    timed("hvd_run", hvd_run_phase)
    timed("estimator", estimator_phase)
    timed("adapters", adapters_phase)
    timed("mnist", mnist_phase, fa, fx, dev)
    timed("parity_bert", parity_bert_phase, convert, dev)
    timed("parity_resnet", parity_resnet_phase, convert, dev)
    emit("phase_seconds", **phase_s)
    emit("schedule", **SCHEDULE)

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
            # the model-parallel paths' shapes (the ring tile through
            # flash_attention_lse, Ulysses, ep), and the launches of those
            # paths' timed steps (per rank)
            for case in MP_CASES:
                row = kernels[(case, k)]
                summary[-1][case] = {key: row[key] for key in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_pair_ms", "tflops")}
                if "autograd" in row:
                    summary[-1][case]["autograd"] = row["autograd"]
            paths = {"train_moe": [launches_moe[k]],
                     "train_tp2_sp2_ring": [
                         n[k] for n in mp["ring"]["launches_by_rank"]],
                     "train_tp2_sp2_ulysses": [
                         n[k] for n in mp["ulysses"]["launches_by_rank"]],
                     "train_moe_ep2": [
                         n[k] for run in ep["variants"].values()
                         for n in run["launches_by_rank"]],
                     "train_pp2": [n[k] for n in pp["launches_by_rank"]],
                     "bert_tp2_sp2": [n[k] for n in
                                      bert_mp["launches_by_rank"]],
                     "train_fsdp_dp2": [
                         sum(st[k] for st in steps)
                         for run in fsdp["variants"].values()
                         for steps in run["launches_per_step_by_rank"]],
                     "train_tp2_dp2_spec": [
                         n[k] for run in spec["runs"].values()
                         for n in run["launches_by_rank"]],
                     "health_dp": [health_dp["launches"][k]]}
            summary[-1]["launches_by_path"] = paths
            for path, counts in paths.items():
                require(all(n > 0 for n in counts),
                        f"{label} never ran on {path}'s path: {counts}")
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
