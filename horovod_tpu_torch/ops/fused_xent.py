"""Fused vocabulary cross-entropy through hand-written CUDA kernels for Hopper.

Counterpart: ``horovod_tpu/ops/fused_xent.py``.  The three Pallas TPU
kernels (forward, dh, dW) become the CUDA kernels of
``csrc/fused_xent.cu``; the ``jax.custom_vjp`` around ``_xent_sum`` becomes
:class:`_FusedXentSum`.  The loss ``mean(logsumexp(h @ W.T) - logit[y])``
never materializes the ``[N, V]`` logits: the kernels form score tiles on
the fly, and the backward recomputes them from the saved logsumexp.

Per-token ``lse`` and ``tgt`` are flat ``[N]`` fp32.  The TPU kernel's
blocked ``[nr, 1, br]`` layout was a Mosaic tiling artefact (a block's
trailing dims had to equal the array's) and does not carry over, as the
flash kernels' blocked lse did not.

Every wrapper dispatches on the device of ``h``: on CUDA tensors it
launches its kernel or raises, on CPU tensors it runs the kernel's plain
PyTorch version (``_fwd_reference``, ``_dh_reference``, ``_dw_reference``).
``LAUNCHES`` counts kernel launches, one per launch, and nothing else.  The
kernels read the embedding in bf16: the wrapper casts the fp32 master once
for the forward and once for both backward kernels, the values the TPU
kernel casts in registers.

Knob, with the JAX package's meaning: ``HOROVOD_FUSED_XENT=0`` (or
``false``) turns the kernels off; ``models.llama.loss_fn`` then takes the
chunked or one-shot loss, the only way to them on the card when
``LlamaConfig.fused_xent`` is set.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from . import _build

_ROW_BLOCKS = (256, 128, 64, 32, 16, 8)
_VOCAB_BLOCKS = (512, 256, 128)
_DIMS = (128, 256, 512, 1024, 2048)  # d_model values the CUDA kernels are built for
_KERNEL_ROWS = 64    # tokens: whole halves of the kernels' 128-token tiles
_KERNEL_VOCAB = 128  # vocab: whole 128-row clusters of the dW kernel

#: kernel launches since the last :func:`reset_launches`, by kernel
LAUNCHES: Dict[str, int] = {"xent_fwd": 0, "xent_dh": 0, "xent_dw": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def enabled() -> bool:
    """False when ``HOROVOD_FUSED_XENT`` turns the kernels off."""
    return os.environ.get("HOROVOD_FUSED_XENT", "1") not in ("0", "false")


def _blocks(n_rows: int, vocab: int):
    """The TPU kernels' row and vocab blocks (None where none divides)."""
    br = next((b for b in _ROW_BLOCKS if n_rows % b == 0), None)
    bv = next((b for b in _VOCAB_BLOCKS if vocab % b == 0), None)
    return br, bv


def unsupported_reason(h, w, targets) -> Optional[str]:
    """Why the fused loss cannot take ``h [B,T,D]``, ``w [V,D]`` and
    ``targets [B,T]``, or None when it can.

    The JAX package's shape gates hold everywhere (its VMEM budget, a TPU
    limit, does not carry over).  On CUDA tensors the kernels' own gates
    follow (:func:`_kernel_reason`).  On CPU tensors the plain versions
    take any float dtype.
    """
    if h.dim() != 3 or w.dim() != 2 or targets.dim() != 2:
        return (f"h, w and targets must be [B, T, D], [V, D] and [B, T], got "
                f"{h.dim()}-d, {w.dim()}-d and {targets.dim()}-d")
    B, T, D = h.shape
    V = w.shape[0]
    if w.shape[1] != D or tuple(targets.shape) != (B, T):
        return (f"w {tuple(w.shape)} and targets {tuple(targets.shape)} do "
                f"not match h {tuple(h.shape)}")
    if D % 128:
        return f"d_model {D} is not a multiple of 128"
    br, bv = _blocks(B * T, V)
    if br is None:
        return f"no row block of {_ROW_BLOCKS} divides the {B * T} tokens"
    if bv is None:
        return f"no vocab block of {_VOCAB_BLOCKS} divides vocab {V}"
    if h.device.type == "cuda":
        return _kernel_reason(B * T, D, V, h.dtype)
    return None


def _kernel_reason(N: int, D: int, V: int, dtype) -> Optional[str]:
    """Why the CUDA kernels cannot take ``N`` tokens of d_model ``D`` in
    ``dtype`` against vocab ``V``, or None: the d_model values they are
    built for, bf16 hidden states, tokens a multiple of 64 and vocab a
    multiple of 128.  ``csrc/fused_xent.cu``'s ``shape_ok`` guards the
    same."""
    if D not in _DIMS:
        return f"d_model {D} is not one of {_DIMS}"
    if dtype != torch.bfloat16:
        return f"hidden states are {dtype}, the kernels take torch.bfloat16"
    if N % _KERNEL_ROWS:
        return f"{N} tokens are not a multiple of {_KERNEL_ROWS}"
    if V % _KERNEL_VOCAB:
        return f"vocab {V} is not a multiple of {_KERNEL_VOCAB}"
    return None


def supported(h, w, targets) -> bool:
    """True when the kernels are enabled and take these inputs (on the CPU
    the plain versions then stand in for them)."""
    return enabled() and unsupported_reason(h, w, targets) is None


# ------------------------------------------------------- plain versions

def _scores(h, w):
    """fp32 ``h @ w.to(h.dtype).T``: products of the compute-dtype values,
    summed in fp32, as the kernels form them."""
    return torch.matmul(h.float(), w.to(h.dtype).float().T)


def _fwd_reference(h, w, y):
    """Plain version of the forward kernel: ``(lse [N], tgt [N])`` fp32."""
    s = _scores(h, w)
    return torch.logsumexp(s, dim=-1), s.gather(1, y[:, None].long())[:, 0]


def _probs_minus_onehot(h, w, y, lse):
    """``softmax(S) - onehot(y)`` from the saved lse, rounded to the
    compute dtype as the kernels round it before their products."""
    p = torch.exp(_scores(h, w) - lse[:, None])
    p[torch.arange(p.shape[0], device=p.device), y.long()] -= 1.0
    return p.to(h.dtype).float()


def _dh_reference(h, w, y, lse):
    """Plain version of the dh kernel: ``(P - onehot) @ w`` in fp32."""
    return torch.matmul(_probs_minus_onehot(h, w, y, lse),
                        w.to(h.dtype).float())


def _dw_reference(h, w, y, lse):
    """Plain version of the dW kernel: ``(P - onehot).T @ h`` in fp32."""
    return torch.matmul(_probs_minus_onehot(h, w, y, lse).T, h.float())


# ------------------------------------------------------------ wrappers

def _dispatch(h) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version."""
    if h.device.type == "cuda":
        return True
    if h.device.type == "cpu":
        return False
    raise ValueError(f"the fused cross-entropy runs on cuda or cpu tensors, "
                     f"not {h.device.type}")


def _launch(kernel: str, inputs: Dict[str, torch.Tensor], outputs) -> None:
    """Check ``inputs`` (h ``[N,D]``, w ``[V,D]``, y ``[N]``, lse ``[N]``),
    launch ``hvd_xent_<kernel>`` on the current stream with the pointers of
    inputs then outputs, raise on a launch error, count the launch."""
    h, w = inputs["h"], inputs["w"]
    N, D = h.shape
    V = w.shape[0]
    reason = _kernel_reason(N, D, V, h.dtype)
    if reason is not None:
        raise ValueError(
            f"the fused cross-entropy kernels do not take h {tuple(h.shape)} "
            f"with w {tuple(w.shape)}: {reason}; set HOROVOD_FUSED_XENT=0 to "
            f"run the chunked or one-shot loss on the card")
    shapes = {"h": (N, D), "w": (V, D), "y": (N,), "lse": (N,)}
    dtypes = {"h": h.dtype, "w": h.dtype, "y": torch.int32,
              "lse": torch.float32}
    what = f"xent_{kernel}_kernel"
    for name, t in inputs.items():
        if t.device != h.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {h.device}")
        if t.dtype != dtypes[name]:
            raise ValueError(f"{what}: {name} is {t.dtype}, the kernel takes "
                             f"{dtypes[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             f"aligned")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    lib = _build.library("fused_xent")
    ptrs = [t.data_ptr() for t in (*inputs.values(), *outputs)]
    with torch.cuda.device(h.device):
        err = getattr(lib, f"hvd_xent_{kernel}")(
            *ptrs, N, V, D, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, what)
    LAUNCHES[f"xent_{kernel}"] += 1


def _xent_fwd(h, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """h ``[N,D]``, w ``[V,D]`` (any float dtype, read as ``h.dtype``), y
    ``[N]`` → (lse ``[N]``, tgt ``[N]``) fp32."""
    if not _dispatch(h):
        return _fwd_reference(h, w, y)
    lse = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    tgt = torch.empty_like(lse)
    _launch("fwd", {"h": h, "w": w.to(h.dtype), "y": y}, (lse, tgt))
    return lse, tgt


def _dh(h, w, y, lse):
    """fp32 ``[N,D]`` gradient of Σ(lse − tgt) with respect to h."""
    if not _dispatch(h):
        return _dh_reference(h, w, y, lse)
    dh = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    _launch("dh", {"h": h, "w": w.to(h.dtype), "y": y, "lse": lse}, (dh,))
    return dh


def _dw(h, w, y, lse):
    """fp32 ``[V,D]`` gradient of Σ(lse − tgt) with respect to w."""
    if not _dispatch(h):
        return _dw_reference(h, w, y, lse)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    _launch("dw", {"h": h, "w": w.to(h.dtype), "y": y, "lse": lse}, (dw,))
    return dw


class _FusedXentSum(torch.autograd.Function):
    """Σ over tokens of ``lse − tgt``; h ``[N,D]``, w ``[V,D]``, y ``[N]``.
    Saves h, w, y and lse.  The backward runs both kernels, then applies
    the upstream scalar outside them.  It has no cross-device sum: over dp
    that belongs to the gradient plane, as for every other leaf."""

    @staticmethod
    def forward(ctx, h, w, y):
        lse, tgt = _xent_fwd(h, w, y)
        ctx.save_for_backward(h, w, y, lse)
        return (lse - tgt).sum()

    @staticmethod
    def backward(ctx, g):
        h, w, y, lse = ctx.saved_tensors
        wc = w.to(h.dtype)  # one cast serves both kernels
        dh = _dh(h, wc, y, lse)
        dw = _dw(h, wc, y, lse)
        del wc
        return dh.mul_(g).to(h.dtype), dw.mul_(g).to(w.dtype), None


def fused_xent_mean(h, w_embed, targets):
    """Mean token cross-entropy, fully fused.

    ``h`` ``[B, T, D]`` final hidden states, ``w_embed`` ``[V, D]`` tied
    embedding (fp32 master, read in h's dtype), ``targets`` ``[B, T]``
    integer labels.  Returns the scalar mean of ``lse − target_logit``;
    gradients flow to ``h`` (in its dtype) and ``w_embed`` (in its dtype).
    """
    B, T, D = h.shape
    N = B * T
    y = targets.reshape(N).to(torch.int32)
    return _FusedXentSum.apply(h.reshape(N, D).contiguous(), w_embed, y) / N
