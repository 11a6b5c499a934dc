"""TF custom-op bridge: registered collective ops with XLA kernels
(counterpart: ``horovod_tpu/tensorflow/_xla_bridge.py``).

Reference parity: ``horovod/tensorflow/mpi_ops.cc`` (registered custom
ops as the binding) + ``xla_mpi_ops.cc`` (XLA CustomCall registration so
the ops survive ``tf.function(jit_compile=True)``) — SURVEY.md §2.1.

``native/tf_xla_ops.cc`` registers ``HorovodTorchCollective`` /
``HorovodTorchGroupedAllreduce`` with a CPU kernel (eager and plain
graphs) and an XlaOpKernel lowering to a typed-FFI custom call (XLA:CPU
clusters).  Both kernels call back into :func:`_dispatch` below, which
hands the buffers to the port's engine through ``api`` — so
multi-process collectives work inside ``jit_compile=True`` graphs.

``native/tf_build.py`` compiles the library at first use into
``build/horovod_tpu_torch/tf-xla-<hash>/``.  Unlike the JAX package, a
failed build or load does not fall back quietly: :func:`status` reports
it with the error's text, the adapter's agreement round shares every
member's answer, and every member raises (naming the failed ranks).
``HOROVOD_TF_XLA_OPS=0`` selects the ``py_function`` path on purpose.

This module also holds the boundary between the two frameworks: a TF
tensor's numpy value becomes a torch tensor on the runtime's device
(:func:`to_torch`) and comes back in its own dtype (:func:`to_numpy`).
bfloat16 crosses as a 16-bit integer view: ``torch.from_numpy`` refuses
``ml_dtypes.bfloat16``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_lib = None
_error: Optional[str] = None   # why this process has no bridge


class TfXlaBridgeError(RuntimeError):
    """The op bridge failed to build or load on a member of a call's
    process set."""


def enabled() -> bool:
    """``HOROVOD_TF_XLA_OPS`` is not off (read per call, not cached, so a
    job can fence the bridge off after a load)."""
    return os.environ.get("HOROVOD_TF_XLA_OPS", "1").strip().lower() \
        not in ("0", "false")


def load():
    """The loaded op module, built first if need be; raises
    :class:`TfXlaBridgeError` with the build's or the load's error (the
    same error again on a later call)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise TfXlaBridgeError(_error)
    import tensorflow as tf

    from ..native import tf_build
    try:
        _lib = tf.load_op_library(str(tf_build.build_library()))
    except Exception as exc:  # noqa: BLE001 - reported to every member
        _error = f"{type(exc).__name__}: {exc}"
        raise TfXlaBridgeError(_error) from exc
    return _lib


def status() -> Tuple[str, str]:
    """This process's answer in the agreement round: ``("ok", "")``,
    ``("off", "")`` under ``HOROVOD_TF_XLA_OPS=0``, or ``("failed",
    error text)``."""
    if not enabled():
        return "off", ""
    try:
        load()
    except TfXlaBridgeError as exc:
        return "failed", str(exc)
    return "ok", ""


def ops():
    """The loaded op module (after an ``"ok"`` :func:`status`)."""
    return _lib


def sanitize_name(name: str) -> str:
    """Attr-safe tensor name (it rides an MLIR attribute dictionary in
    the XLA lowering; applied in ONE place so the eager/graph/XLA paths
    all negotiate the same identity)."""
    return "".join(c if (c.isalnum() or c in "._/-") else "_"
                   for c in name)


def _np_dtype(dtype: str):
    if dtype == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


def to_torch(arr: np.ndarray):
    """A copy of ``arr`` as a torch tensor on the runtime's device."""
    import torch

    from .. import runtime
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(runtime._state().device)


def to_numpy(t) -> np.ndarray:
    """A torch result as numpy in its own dtype (bfloat16 as
    ``ml_dtypes.bfloat16``)."""
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_np_dtype("bfloat16"))
    return t.numpy()


def _dispatch(kind: str, name: str, rop: str, root: int, pre: float,
              post: float, psid: int, dtype: str, in_views, in_dims,
              out_views, out_dims) -> None:
    """Kernel-side trampoline: zero-copy memoryviews in and out.

    Runs on a TF executor (or XLA runtime) thread under the GIL; the
    engine's ``Handle.synchronize`` waits on a ``threading.Event``,
    which releases the GIL so the background engine thread keeps
    negotiating.  ``psid`` selects a registered process set (-1: the
    global set).  The port's reducescatter and alltoall results are
    already this rank's own.
    """
    from .. import api, runtime

    ps = None if psid < 0 else runtime.get_process_set_by_id(int(psid))
    dt = _np_dtype(dtype)
    ins = [to_torch(np.frombuffer(v, dtype=dt).reshape(d))
           for v, d in zip(in_views, in_dims)]
    name = name or None
    if kind == "grouped_allreduce":
        res = api.grouped_allreduce(ins, op=rop, name=name,
                                    prescale_factor=pre,
                                    postscale_factor=post, process_set=ps)
    elif kind == "allreduce":
        res = [api.allreduce(ins[0], op=rop, name=name,
                             prescale_factor=pre, postscale_factor=post,
                             process_set=ps)]
    elif kind == "allgather":
        res = [api.allgather(ins[0], name=name, process_set=ps)]
        got = tuple(res[0].shape)
        if got != tuple(out_dims[0]):
            raise ValueError(
                f"bridge allgather result shape {got} != static XLA "
                f"shape {tuple(out_dims[0])}: ragged (Allgatherv) "
                "inputs need the py_function path - set "
                "HOROVOD_TF_XLA_OPS=0 for this job")
    elif kind == "broadcast":
        res = [api.broadcast(ins[0], int(root), name=name, process_set=ps)]
    elif kind == "alltoall":
        res = [api.alltoall(ins[0], name=name, process_set=ps)]
    elif kind == "reducescatter":
        res = [api.reducescatter(ins[0], op=rop, name=name,
                                 process_set=ps)]
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    for r, v, d in zip(res, out_views, out_dims):
        out = np.frombuffer(v, dtype=dt).reshape(d)
        out[...] = to_numpy(r).reshape(d)
