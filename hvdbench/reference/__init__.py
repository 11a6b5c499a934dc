"""Plain fp32 PyTorch references of the benchmark's models and optimizers.

Nothing here imports the program under test (``horovod_tpu_torch``), the
JAX package or JAX, and nothing here takes a tensor the program made: the
harness hands both sides the same seeded weights and batches, and the
reference works everything else out again.  Matrix products run in fp32
with TF32 off (:func:`fp32_matmuls`), or, for the lower-precision control,
on operands rounded to fp8 (:class:`precision.Fp8Matmul`).
"""

from __future__ import annotations

import torch


def fp32_matmuls() -> None:
    """Full fp32 products on the card: TF32 keeps ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
