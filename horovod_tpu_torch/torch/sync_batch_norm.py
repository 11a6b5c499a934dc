"""``SyncBatchNorm`` under the torch adapter's import path (counterpart:
``horovod_tpu/torch/sync_batch_norm.py``; reference:
``horovod/torch/sync_batch_norm.py``), re-exported from the port's
``sync_batch_norm.py``, where it lives."""

from __future__ import annotations

from ..sync_batch_norm import SyncBatchNorm  # noqa: F401

__all__ = ["SyncBatchNorm"]
