"""Ulysses-style sequence parallelism: an all-to-all head scatter.

Counterpart: ``horovod_tpu/parallel/ulysses.py``.  One all-to-all over the
sequence axis re-shards q/k/v from sequence-sharded to head-sharded, each
rank attends over the full sequence for its heads (through the flash
kernels where they take the shape), and a second all-to-all restores the
sequence sharding.  The all-to-alls are :func:`parallel.axis.all_to_all`,
whose backward is the inverse exchange.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from . import axis as ax


def seq_to_heads(x, axis_name: str):
    """``[B, T/sp, H, D]`` sequence-sharded → ``[B, T, H/sp, D]``
    head-sharded: head chunk j goes to rank j; the received sequence
    blocks concatenate in source order."""
    n = ax.axis_size(axis_name)
    H = x.shape[2]
    if H % n:
        raise ValueError(f"heads {H} not divisible by sp={n}")
    return ax.all_to_all(x, axis_name, split_axis=2, concat_axis=1)


def heads_to_seq(x, axis_name: str):
    """Inverse of :func:`seq_to_heads`: ``[B, T, H/sp, D]`` →
    ``[B, T/sp, H, D]``."""
    n = ax.axis_size(axis_name)
    T = x.shape[1]
    if T % n:
        raise ValueError(f"sequence {T} not divisible by sp={n}")
    return ax.all_to_all(x, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention(q, k, v, axis_name: Optional[str] = None,
                      attn_fn: Optional[Callable] = None,
                      causal: bool = True,
                      sm_scale: Optional[float] = None):
    """Attention over a sequence-sharded input via a head scatter.

    q/k/v ``[B, T/sp, H, D]`` (k/v with Hkv heads).  ``attn_fn(q, k, v)``
    attends over head-sharded tensors; the default is the single-shard
    :func:`ring_attention`.  With GQA, when sp divides Hkv the kv heads
    scatter as they are; otherwise they are repeated to ``lcm(Hkv, sp)``
    first, the least that scatters evenly.
    """
    from .ring_attention import ring_attention
    if attn_fn is None:
        def attn_fn(q, k, v):
            return ring_attention(q, k, v, axis_name=None, causal=causal,
                                  sm_scale=sm_scale)
    if axis_name is None or ax.axis_size(axis_name) == 1:
        return attn_fn(q, k, v)
    n = ax.axis_size(axis_name)
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H and Hkv % n:
        # lcm(Hkv, n) divides H whenever Hkv | H and n | H, so the grouped
        # q-head → kv-head mapping stays rank-local after the all-to-all
        rep = (n * Hkv // math.gcd(Hkv, n)) // Hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qh = seq_to_heads(q, axis_name)
    kh = seq_to_heads(k, axis_name)
    vh = seq_to_heads(v, axis_name)
    return heads_to_seq(attn_fn(qh, kh, vh), axis_name)
