"""Model adapters: the zoo's forwards as bucketed serving functions.

Counterpart: ``horovod_tpu/serving/models.py``.  Each builder returns a
:class:`~horovod_tpu_torch.serving.worker.BucketedForward` mapping a
padded micro-batch ``(tokens [B, S], lengths [B])`` to a per-row output
array — the one signature the serving worker speaks:

* ``llama_decode_forward`` — the KV-cache ragged batched greedy decode
  (``models/generate.py batched_greedy_decode``), one dense cache per
  shape bucket, allocated on the bucket's first call and reused;
* ``paged_llama_decode_forward`` — the same through the paged KV pool
  (``serving/paging.py``);
* ``toy_echo_forward`` — a deterministic verification forward.

Each row of a decode continues its own prompt; per-row parity with
sequential ``greedy_generate`` is the micro-batching correctness floor.
The model-parallel decode and the classifier forwards (BERT, MNIST) wait
for ROADMAP.md A6.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import DeviceLike
from .shapes import ShapeBuckets
from .worker import BucketedForward


def llama_decode_forward(params, cfg, max_new_tokens: int,
                         buckets: ShapeBuckets) -> BucketedForward:
    """Greedy KV-cache decode over a padded ragged micro-batch.

    Output rows are ``[max_new_tokens]`` generated ids.  ``max_len`` is
    the bucket's padded seq + ``max_new_tokens``, so each shape bucket
    holds exactly one ``[L, B, max_len]`` cache.  The weights are cast to
    ``cfg.dtype`` once, here; the forward runs on their device.
    """
    from ..models.generate import (batched_greedy_decode, cast_params,
                                   init_kv_cache)
    if buckets.max_seq + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"largest seq bucket {buckets.max_seq} + max_new_tokens "
            f"{max_new_tokens} exceeds the model's max_seq_len "
            f"{cfg.max_seq_len}")
    params = cast_params(params, cfg)
    device = params["embed"].device

    def prepare(shape):
        b, s = shape
        return {"cache": init_kv_cache(cfg, b, s + max_new_tokens,
                                       device=device)}

    def fn(bufs):
        tokens = bufs["tokens"]
        return batched_greedy_decode(
            params, cfg, tokens, bufs["lengths"], max_new_tokens,
            max_len=tokens.shape[1] + max_new_tokens, cache=bufs["cache"])

    return BucketedForward(fn, buckets, device=device, prepare=prepare)


def paged_llama_decode_forward(params, cfg, max_new_tokens: int,
                               buckets: ShapeBuckets,
                               block_size: int = 16,
                               n_blocks=None):
    """:func:`llama_decode_forward` through the paged KV pool: same
    signature and per-row parity, but cache bytes are priced per row
    (``ceil((len+new)/block)`` blocks) instead of bucket-max, with
    prompt-head blocks shared across requests (serving/paging.py)."""
    from .paging import PagedDecodeForward
    return PagedDecodeForward(params, cfg, max_new_tokens, buckets,
                              block_size=block_size, n_blocks=n_blocks)


def mp_llama_decode_forward(params, cfg, max_new_tokens: int,
                            buckets: ShapeBuckets, mp: int = 2,
                            axis: str = "hvd_serve_mp", devices=None):
    """Decode over a model-parallel mesh slice: not ported yet."""
    raise NotImplementedError(
        "model-parallel serving (mp_llama_decode_forward) is not ported "
        "yet (ROADMAP.md A6)")


def classifier_forward(forward: Callable, params, buckets: ShapeBuckets,
                       preprocess: Callable = None) -> BucketedForward:
    """A plain classifier forward as a serving function: not ported yet
    (its models, BERT and MNIST, are not)."""
    raise NotImplementedError(
        "classifier_forward serves BERT/MNIST-shaped models, which are "
        "not ported yet (ROADMAP.md A6)")


def toy_echo_forward(buckets: ShapeBuckets, burn_dim: int = 200,
                     burn_iters: int = 3,
                     device: DeviceLike = None) -> BucketedForward:
    """Deterministic verification forward for benches and smokes.

    Burns a BATCH-INDEPENDENT matmul chain (``burn_iters`` x
    ``[burn_dim, burn_dim]``) on ``device`` (default: the CUDA device) —
    the stand-in for the per-forward fixed cost (weight streaming,
    kernel dispatch) that real serving amortizes over the batch.  Then
    echoes ``tokens * 2 + 1``: unique payloads round-trip, so a routing
    or requeue bug shows up as a WRONG answer, not just a lost one.  The
    burn result is folded in at a scale that truncates to +0.
    """
    def fn(bufs):
        tokens = bufs["tokens"]
        z = torch.ones((burn_dim, burn_dim), dtype=torch.float32,
                       device=tokens.device) \
            * (1.0 + tokens.sum().float() * 1e-9)
        for _ in range(burn_iters):
            z = torch.tanh(z @ z)
        return tokens * 2 + 1 + (z.sum() * 1e-30).to(torch.long)

    return BucketedForward(fn, buckets, device=device)


def decode_rows(outputs: np.ndarray, lengths: np.ndarray,
                n_rows: int) -> list:
    """Strip pad rows from a batched output (helper for callers that
    bypass the plane)."""
    return [np.asarray(outputs[i]) for i in range(n_rows)]
