"""Flash attention through hand-written CUDA kernels for Hopper.

Counterpart: ``horovod_tpu/ops/flash_attention.py``.  The three Pallas TPU
kernels (forward, dQ, dK/dV) become the CUDA kernels of
``csrc/flash_attention.cu``; the ``jax.custom_vjp`` becomes one
``torch.autograd.Function`` serving both :func:`flash_attention` and
:func:`flash_attention_lse`.

Public layout (as in JAX): q ``[B, T, H, D]``, k/v ``[B, Tk, Hkv, D]`` with
``Hkv | H`` (query head h reads kv head ``h // (H // Hkv)``), lse
``[B, H, T]``.  The kernels run in ``[B, H, T, D]`` layout.  The TPU
kernel's blocked ``[B, H, nq, bq]`` lse was a tiling artefact and does not
carry over.

Every wrapper dispatches on the device of its inputs: on CUDA tensors it
launches its kernel or raises, on CPU tensors it runs the kernel's plain
PyTorch version (``_fwd_reference``, ``_dq_reference``, ``_dkv_reference``).
``LAUNCHES`` counts kernel launches, one per launch, and nothing else.

Knobs, with the JAX package's meaning: ``HOROVOD_FLASH_ATTENTION=0``
disables the kernels (``local_attention`` then takes its blockwise path,
the only way to reach it on the card), and ``HOROVOD_FLASH_BLOCK``
overrides the tile rows (the CUDA kernels are built for 64).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)  # head dims the CUDA kernels are instantiated for
_KERNEL_BLOCK = 64      # rows of a query or key tile in the CUDA kernels

#: kernel launches since the last :func:`reset_launches`, by kernel
LAUNCHES: Dict[str, int] = {"fwd": 0, "dq": 0, "dkv": 0}
#: backward passes that folded a cotangent of the exposed lse into delta
#: (ring attention's tiles), since the last :func:`reset_launches`; not a
#: launch count
DLSE_FOLDS = [0]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    DLSE_FOLDS[0] = 0


def enabled() -> bool:
    """False when ``HOROVOD_FLASH_ATTENTION`` turns the kernels off."""
    return os.environ.get("HOROVOD_FLASH_ATTENTION", "1") not in ("0", "false")


def _block_sizes(t_q: int, t_kv: int) -> Tuple[int, int]:
    """Query/key tile rows: ``HOROVOD_FLASH_BLOCK`` or the Hopper default
    of 64, clamped to the sequence lengths.  :func:`unsupported_reason`
    rejects anything but the 64 the kernels are built for."""
    try:
        blk = int(os.environ.get("HOROVOD_FLASH_BLOCK", "64") or 64)
    except ValueError:
        blk = 64
    if blk <= 0:
        blk = 64
    return min(blk, t_q), min(blk, t_kv)


def unsupported_reason(q, k, v) -> Optional[str]:
    """Why the CUDA kernels cannot take these ``[B, T, H, D]`` inputs, or
    None when they can."""
    if q.dim() != 4 or k.dim() != 4:
        return f"q and k must be [B, T, H, D], got {q.dim()}-d and {k.dim()}-d"
    B, T, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        return (f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                f"q {tuple(q.shape)}")
    if H % Hkv:
        return f"kv heads {Hkv} do not divide query heads {H}"
    if D not in _HEAD_DIMS:
        return f"head_dim {D} is not one of {_HEAD_DIMS}"
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return f"dtype {q.dtype} is not torch.bfloat16"
    bq, bk = _block_sizes(T, Tk)
    if bq != _KERNEL_BLOCK or bk != _KERNEL_BLOCK or T % bq or Tk % bk:
        return (f"sequence lengths {T}/{Tk} with HOROVOD_FLASH_BLOCK tiles "
                f"{bq}/{bk}: the kernels take tiles of {_KERNEL_BLOCK} rows "
                f"that divide the sequence")
    return None


def supported(q, k, v, causal: bool = True) -> bool:
    """True when the kernels are enabled and take this shape (on the CPU
    the plain versions then stand in for them)."""
    del causal  # both masks are supported
    return enabled() and unsupported_reason(q, k, v) is None


# ------------------------------------------------------- plain versions

def _scores(q, k, causal, scale):
    """fp32 ``q k^T * scale`` with kv heads repeated over their groups and
    the causal mask at NEG_INF; q ``[B,H,T,D]``, k ``[B,Hkv,Tk,D]``."""
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if causal:
        T, Tk = q.shape[2], k.shape[2]
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    return s


def _group_sum(x, hkv):
    """``[B, H, T, D]`` summed over the query heads of each kv group."""
    B, H, T, D = x.shape
    return x.reshape(B, hkv, H // hkv, T, D).sum(2)


def _fwd_reference(q, k, v, causal: bool, scale: float):
    """Plain version of the forward kernel: ``(out [B,H,T,D], lse [B,H,T])``.
    P is rounded to v's dtype before P.V, as in the kernels."""
    g = q.shape[1] // k.shape[1]
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    vf = v.float().repeat_interleave(g, dim=1)
    acc = torch.matmul(p.to(v.dtype).float(), vf)
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _dq_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of the dQ kernel; dS is rounded to k's dtype before
    dS.K, as in the kernels."""
    g = q.shape[1] // k.shape[1]
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    vf = v.float().repeat_interleave(g, dim=1)
    dp = torch.matmul(do.float(), vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    kf = k.float().repeat_interleave(g, dim=1)
    return torch.matmul(ds.to(k.dtype).float(), kf).to(q.dtype)


def _dkv_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of the dK/dV kernel, as the TPU kernel computes it: P
    and dS stay fp32 for their products (the CUDA kernel rounds them to
    bf16 for the tensor cores)."""
    hkv, g = k.shape[1], q.shape[1] // k.shape[1]
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = do.float()
    vf = v.float().repeat_interleave(g, dim=1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), dof), hkv)
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), hkv)
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ wrappers

def _dispatch(q) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu tensors, not "
                     f"{q.device.type}")


def _launch(kernel: str, inputs: Dict[str, torch.Tensor], outputs,
            causal: bool, scale: float) -> None:
    """Check ``inputs`` (``[B,H,T,D]`` layout), launch ``hvd_flash_<kernel>``
    on the current stream with the pointers of inputs then outputs, raise
    on a launch error, count the launch."""
    q, k = inputs["q"], inputs["k"]
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if (H % Hkv or D not in _HEAD_DIMS or T % _KERNEL_BLOCK
            or Tk % _KERNEL_BLOCK):
        raise ValueError(
            f"flash attention kernels do not take q {tuple(q.shape)} with k "
            f"{tuple(k.shape)} ([B, H, T, D]; need head_dim in {_HEAD_DIMS} "
            f"and sequences a multiple of {_KERNEL_BLOCK}); set "
            f"HOROVOD_FLASH_ATTENTION=0 to run the blockwise path on the card")
    shapes = {"q": (B, H, T, D), "do": (B, H, T, D), "k": (B, Hkv, Tk, D),
              "v": (B, Hkv, Tk, D), "lse": (B, H, T), "delta": (B, H, T)}
    what = f"flash_{kernel}_kernel"
    for name, t in inputs.items():
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {q.device}")
        if t.dtype != want:
            raise ValueError(f"{what}: {name} is {t.dtype}, the kernel takes "
                             f"{want}; set HOROVOD_FLASH_ATTENTION=0 to run "
                             f"the blockwise path on the card")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             f"aligned")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    lib = _build.library("flash_attention")
    ptrs = [t.data_ptr() for t in (*inputs.values(), *outputs)]
    with torch.cuda.device(q.device):
        err = getattr(lib, f"hvd_flash_{kernel}")(
            *ptrs, B, H, Hkv, T, Tk, D, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, what)
    LAUNCHES[kernel] += 1


def _flash_fwd_bhtd(q, k, v, causal: bool, scale: float):
    """q ``[B,H,T,D]``, k/v ``[B,Hkv,Tk,D]`` → (out ``[B,H,T,D]``, lse
    ``[B,H,T]`` fp32)."""
    if not _dispatch(q):
        return _fwd_reference(q, k, v, causal, scale)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("fwd", {"q": q, "k": k, "v": v}, (out, lse), causal, scale)
    return out, lse


def _dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    if not _dispatch(q):
        return _dq_reference(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty_like(q)
    _launch("dq", {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                   "delta": delta}, (dq,), causal, scale)
    return dq


def _dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    if not _dispatch(q):
        return _dkv_reference(q, k, v, do, lse, delta, causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                    "delta": delta}, (dk, dv), causal, scale)
    return dk, dv


def _flash_bwd_bhtd(q, k, v, out, lse, do, causal: bool, scale: float,
                    dlse=None):
    # delta_i = rowsum(dO * O) in fp32, outside the kernels.  A cotangent
    # on the exposed lse folds in here: dlse/ds = p, so
    # ds = p·(dp − delta) + p·dlse = p·(dp − (delta − dlse)).
    delta = (do.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
        DLSE_FOLDS[0] += 1
    delta = delta.contiguous()
    dq = _dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttentionLse(torch.autograd.Function):
    """``(out, lse)`` of exact attention in ``[B,H,T,D]`` layout; gradients
    flow through both outputs.  Saves the contiguous q/k/v the kernels
    read, plus out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _flash_fwd_bhtd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = torch.zeros_like(out) if do is None else do.contiguous()
        dq, dk, dv = _flash_bwd_bhtd(q, k, v, out, lse, do, ctx.causal,
                                     ctx.scale, dlse=dlse)
        return dq, dk, dv, None, None


def _to_bhtd(x):
    return x.transpose(1, 2).contiguous()


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None):
    """Fused exact attention.  ``q [B,T,H,D]``, ``k/v [B,Tk,Hkv,D]``."""
    scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    out, _ = _FlashAttentionLse.apply(_to_bhtd(q), _to_bhtd(k), _to_bhtd(v),
                                      bool(causal), scale)
    return out.transpose(1, 2)


def flash_attention_lse(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None):
    """Fused attention returning ``(out [B,T,H,D], lse [B,H,T])``;
    gradients flow through both outputs."""
    scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    out, lse = _FlashAttentionLse.apply(_to_bhtd(q), _to_bhtd(k),
                                        _to_bhtd(v), bool(causal), scale)
    return out.transpose(1, 2), lse
