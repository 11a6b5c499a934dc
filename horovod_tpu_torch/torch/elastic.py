"""``hvd.elastic`` under the torch adapter's import path (counterpart:
``horovod_tpu/torch/elastic.py``; reference:
``horovod/torch/elastic/``): ``TorchState`` (a module, its optimizer and
scalars, committed in memory, restored after a failure, synced from rank
0 after a membership change) and ``run``, re-exported from the port's
``elastic`` package, where they live."""

from __future__ import annotations

from ..elastic import ElasticSampler, ObjectState, State, run  # noqa: F401
from ..elastic.state import FrameworkState, TorchState  # noqa: F401

__all__ = ["TorchState", "FrameworkState", "ObjectState", "State",
           "ElasticSampler", "run"]
