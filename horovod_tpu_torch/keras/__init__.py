"""Keras adapter: optimizer wrapper + training callbacks (counterpart:
``horovod_tpu/keras/``).

Reference parity: ``horovod/keras/`` + ``horovod/_keras/callbacks.py``
(SURVEY.md §2.2) — ``DistributedOptimizer`` plus the canonical
callbacks (``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateWarmupCallback``, ``LearningRateScheduleCallback``), built
on the port's TF adapter (``horovod_tpu_torch.tensorflow``) and its
engine.  Keras comes with TensorFlow (``tf.keras``).
"""

from __future__ import annotations

try:
    import tensorflow  # noqa: F401
except ImportError as _exc:
    raise ImportError(
        "horovod_tpu_torch.keras needs the tensorflow package (its "
        "tf.keras), which is not installed here; PyTorch training takes "
        "`import horovod_tpu_torch.torch as hvd` instead") from _exc

from ..tensorflow import (  # noqa: F401
    DistributedOptimizer, allreduce, broadcast, broadcast_variables, init,
    is_initialized, join, rank, size, local_rank, local_size, cross_rank,
    cross_size, shutdown, Average, Sum, Adasum, Compression)
from .callbacks import (BroadcastGlobalVariablesCallback,  # noqa: F401
                        LearningRateScheduleCallback,
                        LearningRateWarmupCallback, MetricAverageCallback)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "Average", "Sum", "Adasum",
    "DistributedOptimizer", "allreduce", "broadcast", "broadcast_variables",
    "BroadcastGlobalVariablesCallback", "MetricAverageCallback",
    "LearningRateWarmupCallback", "LearningRateScheduleCallback",
    "Compression",
]
