"""Exact attention over the local sequence, through the flash kernels.

Counterpart: ``horovod_tpu/parallel/ring_attention.py``.
:func:`ring_attention` with no sequence-parallel axis (or one of size 1)
is :func:`local_attention`; over an axis it runs the ring, its tiles
through the flash kernels' ``(out, lse)`` path where they take the shape.

:func:`blockwise_attend` is the flash recurrence written in PyTorch; it is
the CPU path for shapes the kernels do not take, and on the card the path
``HOROVOD_FLASH_ATTENTION=0`` selects.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention as _fa

NEG_INF = -1e30


def _block_attend(q, k, v, m, l, o, q_start, k_start, causal, scale):
    """One tile: scores q·k with causal masking by global token position,
    folded into the ``(m, l, o)`` online-softmax accumulator in fp32.

    q ``[B, Tq, H, D]``, k/v ``[B, Tk, Hkv, D]``; query head h reads kv head
    ``h // (H // Hkv)``.  m, l ``[B, H, Tq]``, o ``[B, Tq, H, D]`` fp32.
    """
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if H == Hkv:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    else:
        g = H // Hkv
        qg = q.float().reshape(B, Tq, Hkv, g, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
        s = s.reshape(B, H, Tq, Tk) * scale
    if causal:
        tq = torch.arange(Tq, device=q.device)[:, None] + q_start
        tk = torch.arange(Tk, device=q.device)[None, :] + k_start
        s = torch.where(tk <= tq, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    vf = v.float()
    if H == Hkv:
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    else:
        pg = p.reshape(B, Hkv, H // Hkv, Tq, Tk)
        pv = torch.einsum("bhgqk,bkhd->bqhgd", pg, vf).reshape(B, Tq, H, D)
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def blockwise_attend(q, k, v, m, l, o, q_start: int, k_start: int,
                     causal: bool, scale: float, block_size: int = 512):
    """Fold one q × kv tile into the ``(m, l, o)`` accumulator with
    O(Tq·block) live memory: a loop over key/value blocks, each block
    checkpointed (recomputed in the backward pass)."""
    Tk = k.shape[1]
    blk = min(block_size, Tk)
    if Tk % blk:
        # largest divisor of Tk that fits the requested block; no divisor
        # >= 64 collapses to one tile
        blk = next((b for b in range(blk, 63, -1) if Tk % b == 0), Tk)
    attend = functools.partial(_block_attend, causal=causal, scale=scale)
    for off in range(0, Tk, blk):
        m, l, o = checkpoint(attend, q, k[:, off:off + blk],
                             v[:, off:off + blk], m, l, o, q_start,
                             k_start + off, use_reentrant=False)
    return m, l, o


def local_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_size: int = 512):
    """Exact single-shard attention.  q ``[B, T, H, D]``; k/v
    ``[B, Tk, Hkv, D]`` with ``Hkv | H``.

    Shapes the flash kernels take go through them (their plain versions
    on CPU tensors).  Other shapes take :func:`blockwise_attend` on the
    CPU and raise on the card, where ``HOROVOD_FLASH_ATTENTION=0`` is the
    way to the blockwise path.
    """
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if _fa.enabled():
        reason = _fa.unsupported_reason(q, k, v)
        if reason is None:
            return _fa.flash_attention(q, k, v, causal=causal, sm_scale=scale)
        if q.device.type == "cuda":
            raise ValueError(
                f"the flash attention kernels do not take this input: "
                f"{reason}; set HOROVOD_FLASH_ATTENTION=0 to run the "
                f"blockwise path on the card")

    B, T, H, D = q.shape
    m0 = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l0 = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    o0 = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    m, l, o = blockwise_attend(q, k, v, m0, l0, o0, 0, 0, causal, scale,
                               block_size)
    # causal guarantees every query attends at least to itself → l > 0
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _merge_tile(m, l, o, out_t, lse_t):
    """Fold a kernel tile (normalized ``out_t [B,Tq,H,D]`` and its
    logsumexp ``lse_t [B,H,Tq]``) into the accumulator: the tile weighs
    ``exp(lse_t)``."""
    m_new = torch.maximum(m, lse_t)
    corr = torch.exp(m - m_new)
    w_t = torch.exp(lse_t - m_new)
    l_new = l * corr + w_t
    o_new = (o * corr.transpose(1, 2)[..., None]
             + out_t.float() * w_t.transpose(1, 2)[..., None])
    return m_new, l_new, o_new


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``dep`` (the last rotated k/v) joined to
    its graph: a rank whose last ring tile was skipped still runs every
    rotation's backward, with zero cotangents, so its peers' reverse
    rotations find it."""

    @staticmethod
    def forward(ctx, out, dep):
        ctx.save_for_backward(dep)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, dout):
        dep, = ctx.saved_tensors
        return dout, torch.zeros_like(dep)


def ring_attention(q, k, v, axis_name: Optional[str] = None,
                   causal: bool = True, sm_scale: Optional[float] = None):
    """Exact attention with the sequence sharded over ``axis_name``.

    q ``[B, Tl, H, D]``, k/v ``[B, Tl, Hkv, D]``: this rank's block of the
    sequence (GQA circulates only the Hkv heads).  ``axis_name=None`` (or
    an axis of size 1) is :func:`local_attention`.  Otherwise ring step s
    attends to the k/v block of rank ``(i - s) % n``, then rotates k/v one
    rank on (a :func:`parallel.axis.ppermute`, n - 1 rotations in all,
    whose backward carries the k/v cotangents back).  Shapes the flash
    kernels take go through :func:`flash_attention_lse` (past blocks in
    full, the diagonal causal, future blocks skipped by this rank's
    coordinate, which still rotates) and fold by :func:`_merge_tile`;
    others take :func:`blockwise_attend` on the CPU and raise on the card,
    as :func:`local_attention` does (``HOROVOD_FLASH_ATTENTION=0`` takes
    the blockwise path there).  Returns ``[B, Tl, H, D]`` in q's dtype.
    """
    from . import axis as ax
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    n = ax.axis_size(axis_name) if axis_name is not None else 1
    if n == 1:
        return local_attention(q, k, v, causal=causal, sm_scale=scale)
    my = ax.axis_index(axis_name)
    B, Tl, H, D = q.shape
    reason = _fa.unsupported_reason(q, k, v) if _fa.enabled() else None
    use_kernel = _fa.enabled() and reason is None
    if reason is not None and q.device.type == "cuda":
        raise ValueError(
            f"the flash attention kernels do not take this ring tile: "
            f"{reason}; set HOROVOD_FLASH_ATTENTION=0 to run the blockwise "
            f"path on the card")
    m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    hkv = k.shape[2]
    kv = torch.cat([k, v], dim=2)       # one rotation a step carries both
    skipped = False
    for s in range(n):
        blk = (my - s) % n              # whose block this rank holds now
        ck, cv = kv[:, :, :hkv], kv[:, :, hkv:]
        skipped = use_kernel and causal and blk > my
        if not use_kernel:
            m, l, o = blockwise_attend(q, ck, cv, m, l, o, my * Tl,
                                       blk * Tl, causal, scale)
        elif not skipped:
            out_t, lse_t = _fa.flash_attention_lse(
                q, ck, cv, causal=causal and blk == my, sm_scale=scale)
            m, l, o = _merge_tile(m, l, o, out_t, lse_t)
        if s < n - 1:
            kv = ax.ppermute(kv, axis_name,
                             [(i, (i + 1) % n) for i in range(n)])
    # causal guarantees every query attends at least to itself → l > 0
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return _Tie.apply(out, kv) if skipped else out
