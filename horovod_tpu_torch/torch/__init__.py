"""``import horovod_tpu_torch.torch as hvd``: the torch adapter's import
path (counterpart: ``horovod_tpu/torch/__init__.py``; reference:
``horovod.torch``).

The JAX package needs an adapter here: its engine holds JAX arrays, so
its ``horovod_tpu.torch`` converts torch tensors at the boundary and
hooks a torch optimizer.  The port's top level already is that surface
on torch tensors (the eager collectives and their async forms, the
hooked ``DistributedOptimizer``, the broadcast helpers,
``SyncBatchNorm``, ``elastic``), so this module re-exports it and adds
nothing.  ``TorchHandle`` names the engine's async handle
(``ops/engine.py`` ``Handle``), which resolves to torch tensors already.
User code written as ``import horovod_tpu.torch as hvd`` runs with this
import in its place.
"""

from __future__ import annotations

from .. import *  # noqa: F401,F403
from .. import __all__ as _top_all
from ..ops.engine import Handle as TorchHandle
from . import elastic  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401

__all__ = [*_top_all, "TorchHandle"]
