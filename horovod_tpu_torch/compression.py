"""Gradient compression for the collective wire (counterpart:
``horovod_tpu/compression.py``, after ``horovod/torch/compression.py``).

``Compression.none``, ``Compression.fp16`` and ``Compression.bf16``
compress a tensor before an allreduce and decompress the result.

The block-scaled quantized wire formats (EQuARX, arXiv:2506.17615) are
int8, fp8 e4m3 and fp8 e5m2 with one fp32 scale per ``block_size``
elements.  A quantized payload cannot be summed by the collective itself,
so the reduction is rewritten as quantize → exchange payloads and scales
→ dequantize and accumulate in fp32 (``ops/collectives.py``
``quantized_*``).  This module holds the math and the format table; the
arithmetic is the JAX package's step for step, so payloads and scales
agree bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch


class Compressor:
    """A compressor returns ``(compressed_tensor, context)`` and
    decompresses with that context."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Floating tensors travel as ``wire_dtype`` and come back in their
    dtype; other tensors pass unchanged."""
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 on the wire: half the bytes, fp32's exponent range."""
    wire_dtype = torch.bfloat16


class Compression:
    """Namespace matching the reference's ``hvd.Compression``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor


# ---------------------------------------------------------------------------
# block-scaled quantized wire formats
# ---------------------------------------------------------------------------

#: default elements per scale block (HOROVOD_COMPRESSION_BLOCK_SIZE): the
#: scales add 4/256 bytes an element, so int8 carries 1.016 B/elem
DEFAULT_BLOCK_SIZE = 256

#: input dtypes a quantized wire format applies to (integers would be
#: corrupted, fp64 loses too much); by name, as ops.fusion names dtypes
QUANTIZABLE_DTYPES = frozenset({"float32", "bfloat16", "float16"})


class WireFormat(NamedTuple):
    """One quantized wire format: ``name`` is its cross-process identity,
    ``qmax`` the largest magnitude of ``wire_dtype``, onto which each
    block's absolute maximum is scaled.  Scales are fp32, one per
    ``block_size`` elements."""
    name: str
    wire_dtype: torch.dtype
    block_size: int
    qmax: float

    def wire_nbytes(self, numel: int) -> int:
        """Payload bytes for ``numel`` elements: 1-byte lanes plus one
        fp32 scale per (padded) block."""
        blocks = -(-numel // self.block_size)
        return blocks * self.block_size + blocks * 4


#: name -> builder(block_size); fp8 qmax are the formats' maxima
_FORMAT_BUILDERS = {
    "int8": lambda b: WireFormat("int8", torch.int8, b, 127.0),
    "fp8_e4m3": lambda b: WireFormat("fp8_e4m3", torch.float8_e4m3fn, b,
                                     448.0),
    "fp8_e5m2": lambda b: WireFormat("fp8_e5m2", torch.float8_e5m2, b,
                                     57344.0),
}

#: the format names HOROVOD_COMPRESSION accepts (besides "none")
WIRE_FORMATS = tuple(sorted(_FORMAT_BUILDERS))


def resolve_wire_format(spec, block_size: Optional[int] = None
                        ) -> Optional[WireFormat]:
    """A format name (``"int8"``, ``"fp8_e4m3"``, ``"fp8_e5m2"``), or a
    :class:`WireFormat` (its block size overridden by ``block_size``), as
    a :class:`WireFormat`; ``None``, ``""`` and ``"none"`` give None."""
    if spec is None or spec == "" or spec == "none":
        return None
    if isinstance(spec, WireFormat):
        return (spec if block_size is None or block_size == spec.block_size
                else spec._replace(block_size=int(block_size)))
    builder = _FORMAT_BUILDERS.get(str(spec))
    if builder is None:
        raise ValueError(
            f"unknown wire format {spec!r}: expected one of "
            f"{('none',) + WIRE_FORMATS}")
    b = int(block_size) if block_size is not None else DEFAULT_BLOCK_SIZE
    if b <= 0:
        raise ValueError(f"wire-format block size must be positive, got {b}")
    return builder(b)


def quantizable(dtype) -> bool:
    """True when a quantized wire format applies to ``dtype`` (a torch
    dtype or its name)."""
    return str(dtype).removeprefix("torch.") in QUANTIZABLE_DTYPES


@functools.lru_cache(maxsize=None)
def _fp32_reciprocal(x: float) -> float:
    """``1 / x`` rounded to fp32, as a Python float: it meets an fp32
    tensor as that fp32 value (a device tensor would cost a host copy)."""
    return torch.tensor(1.0 / x, dtype=torch.float32).item()


def quantize_blocks(buf: torch.Tensor, fmt: WireFormat):
    """Block-scaled quantization of a 1-D buffer whose length is a
    multiple of ``fmt.block_size`` (callers pad with zeros, which quantize
    exactly).  Returns ``(q, scales)``: the payload in ``fmt.wire_dtype``
    and one fp32 scale per block, 1.0 for an all-zero block.  Integer
    formats round half to even; both fp8 casts clip to ``qmax`` first.

    The scale is ``amax`` times the fp32 reciprocal of ``qmax``: XLA
    rewrites a division by a constant so inside every compiled JAX
    collective, and that differs from ``amax / qmax`` in the last place
    for some blocks (enough to move a code at the next stage)."""
    b = buf.float().reshape(-1, fmt.block_size)
    amax = b.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax * _fp32_reciprocal(fmt.qmax),
                        torch.ones_like(amax))
    q = b / scale
    if not fmt.wire_dtype.is_floating_point:
        q = torch.round(q)
    q = q.clamp(-fmt.qmax, fmt.qmax).to(fmt.wire_dtype)
    return q.reshape(-1), scale.reshape(-1)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      fmt: WireFormat) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: an fp32 buffer of ``len(q)``."""
    b = q.float().reshape(-1, fmt.block_size)
    return (b * scales.reshape(-1, 1)).reshape(-1)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in fp32 with one rounding, as XLA fuses a dequantizing
    multiply into the add or subtract after it.  On the card
    ``torch.addcmul`` is one fused multiply-add.  On the CPU the product
    of a wire code (at most 8 significant bits) and an fp32 scale is exact
    in float64; the sum is rounded to odd there (TwoSum's error decides
    the last bit), so the one rounding to fp32 is correct."""
    if a.is_cuda:
        return torch.addcmul(c.float(), a.float(), b.float())
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def dequantize_sum(q: torch.Tensor, scales: torch.Tensor, fmt: WireFormat,
                   n: int) -> torch.Tensor:
    """The fp32 sum of ``n`` equal rows of codes (``q`` is ``n`` rows laid
    end to end, ``scales`` theirs), accumulated row by row as a chain of
    fused multiply-adds: the order and the rounding of JAX's
    ``jnp.sum(dequantize_blocks(...).reshape(n, -1), axis=0)``."""
    qb = q.reshape(n, -1, fmt.block_size)
    sb = scales.reshape(n, -1, 1).expand(qb.shape)
    acc = qb[0].float() * sb[0]
    for i in range(1, n):
        acc = fma(qb[i], sb[i], acc)
    return acc.reshape(-1)


def quantization_error(buf: torch.Tensor, q: torch.Tensor,
                       scales: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """``buf - dequantize_blocks(q, scales)`` with one rounding (the fused
    multiply-subtract of JAX's error-feedback residual)."""
    qb = q.reshape(-1, fmt.block_size)
    return fma(-qb.float(), scales.reshape(-1, 1).expand(qb.shape),
               buf.float().reshape(qb.shape)).reshape(-1)
