"""PyTorch/CUDA port of horovod_tpu (counterparts: ``horovod_tpu/__init__.py``
and the torch-facing ``horovod_tpu/torch/__init__.py``).

The JAX package ``horovod_tpu`` is the reference; this package runs the
same programs on an NVIDIA H100 through PyTorch and hand-written CUDA
kernels.  It imports ``torch`` and never ``jax`` or ``horovod_tpu``.
``import horovod_tpu_torch as hvd`` gives the Horovod API: ``hvd.init()``,
rank and size, the eager collectives with async handles over
``torch.distributed`` (``api.py``), ``DistributedOptimizer``,
``DistributedGradientTransform`` (planned buckets, ZeRO tiles, the
quantized wire formats) and the broadcast helpers
(``optim/distributed.py``), ``overlapped_backprop``
(``optim/overlap.py``), ``start_timeline``/``stop_timeline``
(``timeline.py``), ``start_profiler``/``stop_profiler`` (a
``torch.profiler`` capture), ``hvd.tracing`` (the job-wide tracer) and
``hvd.health`` (the training-health plane), ``SyncBatchNorm``
(``sync_batch_norm.py``) and
``hvd.elastic`` (``elastic/``: ``run``, ``TensorState``, ``TorchState``,
``ElasticSampler``).  ``horovod_tpu_torch.checkpoint`` and
``horovod_tpu_torch.data`` are imported on their own, and
``python -m horovod_tpu_torch.runner`` launches a job.

Entry points run on the card unless the caller passes ``device="cpu"``:
:func:`default_device` raises when no card is visible instead of carrying
on quietly on the CPU.  On CPU tensors the kernels' plain PyTorch versions
stand in, which is how the tests hold the port against the JAX package.
"""

from __future__ import annotations

from typing import Union

# under another name: importing the subpackage horovod_tpu_torch.torch
# binds ``torch`` in this namespace to it
import torch as _torch

__version__ = "0.1.0"

DeviceLike = Union[str, _torch.device, None]


def default_device() -> _torch.device:
    """The current CUDA device; raises when there is none."""
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on a CUDA device by default and none is "
            "visible; pass device=\"cpu\" to run on the CPU")
    return _torch.device("cuda", _torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> _torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    return default_device() if device is None else _torch.device(device)


# the Horovod API (after the helpers above, which runtime imports)
from .api import (  # noqa: E402
    allgather, allgather_async, allgather_object, allreduce, allreduce_,
    allreduce_async, allreduce_async_, alltoall, alltoall_async, barrier,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    broadcast_object, grouped_allgather, grouped_allgather_async,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async,
    grouped_allreduce_async_, grouped_reducescatter,
    grouped_reducescatter_async, join, poll, reducescatter,
    reducescatter_async, synchronize, wait)
from .compression import (  # noqa: E402
    WIRE_FORMATS, Compression, WireFormat, resolve_wire_format)
from .exceptions import (  # noqa: E402
    HorovodInternalError, HostsUpdatedInterrupt, NotInitializedError)
from .ops.collectives import (  # noqa: E402
    allgather_p, allreduce_p, alltoall_p, broadcast_p, reducescatter_p)
from .optim.distributed import (  # noqa: E402
    DistributedGradientTransform, DistributedOptimizer,
    all_gather_sharded_tree, broadcast_optimizer_state, broadcast_parameters,
    fused_reduce_scatter_tree)
# overlapped dispatch: wrap the step's forward and backward passes so the
# model's grad taps reduce each layer's buckets during backprop
from .optim.overlap import overlapped_backprop  # noqa: E402
from .runtime import (  # noqa: E402
    Adasum, Average, Max, Min, Product, ProcessSet, ReduceOp, Sum,
    add_process_set, ccl_built, cross_rank, cross_size, cuda_built,
    ddl_built, get_process_set_ids_and_ranks, gloo_built, gloo_enabled,
    init, is_homogeneous, is_initialized, local_rank, local_size,
    mpi_built, mpi_enabled, mpi_threads_supported, nccl_built, rank,
    remove_process_set, rocm_built, shutdown, size, start_profiler,
    start_timeline, stop_profiler, stop_timeline, tpu_built, xla_built)

from .sync_batch_norm import SyncBatchNorm  # noqa: E402
# the job-wide tracer (spans, the merge, the critical path)
from . import tracing  # noqa: E402
# training-health telemetry: hvd.health.note_loss / on_unhealthy are the
# user hooks
from . import health  # noqa: E402


def __getattr__(name):
    if name == "global_process_set":
        from .runtime import _get_global_process_set
        return _get_global_process_set()
    if name == "elastic":
        # loaded at first use: the driver and its RPC transport stay out
        # of a plain ``import horovod_tpu_torch``
        import importlib
        return importlib.import_module(".elastic", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__", "default_device", "resolve_device",
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous",
    "Average", "Sum", "Adasum", "Min", "Max", "Product", "ReduceOp",
    "allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_async", "grouped_allreduce_",
    "grouped_allreduce_async_", "allgather", "allgather_async",
    "grouped_allgather", "grouped_allgather_async", "reducescatter",
    "reducescatter_async", "grouped_reducescatter",
    "grouped_reducescatter_async", "broadcast", "broadcast_async",
    "broadcast_", "broadcast_async_", "alltoall", "alltoall_async",
    "allreduce_p", "allgather_p", "broadcast_p", "alltoall_p",
    "reducescatter_p",
    "synchronize", "poll", "wait", "join", "barrier", "broadcast_object",
    "allgather_object", "broadcast_parameters", "broadcast_optimizer_state",
    "DistributedOptimizer", "DistributedGradientTransform",
    "fused_reduce_scatter_tree", "all_gather_sharded_tree",
    "overlapped_backprop", "SyncBatchNorm", "WireFormat", "WIRE_FORMATS",
    "resolve_wire_format", "Compression", "HorovodInternalError",
    "HostsUpdatedInterrupt", "NotInitializedError", "elastic",
    "ProcessSet", "add_process_set", "remove_process_set",
    "get_process_set_ids_and_ranks", "start_timeline", "stop_timeline",
    "start_profiler", "stop_profiler", "tracing", "health",
    "mpi_threads_supported", "mpi_built", "mpi_enabled", "gloo_built",
    "gloo_enabled", "nccl_built", "ddl_built", "ccl_built", "cuda_built",
    "rocm_built", "xla_built", "tpu_built",
]
