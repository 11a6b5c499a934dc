"""Gradient compression for the collective wire (counterpart:
``horovod_tpu/compression.py``, after ``horovod/torch/compression.py``).

``Compression.none`` and ``Compression.fp16`` compress a tensor before an
allreduce and decompress the result.  The JAX package's block-scaled int8
and fp8 wire formats are not ported yet (ROADMAP.md A5).
"""

from __future__ import annotations

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


class FP16Compressor(Compressor):
    """Floating tensors travel as float16 and come back in their dtype."""

    @staticmethod
    def compress(tensor):
        if tensor.is_floating_point():
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class Compression:
    """Namespace matching the reference's ``hvd.Compression``."""
    none = NoneCompressor
    fp16 = FP16Compressor
