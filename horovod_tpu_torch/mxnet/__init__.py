"""MXNet adapter stub (counterpart: ``horovod_tpu/mxnet/``; reference:
``horovod/mxnet/``, SURVEY.md §2.2).

MXNet is end-of-life (retired by Apache in 2023) and the port has no
binding for it.  The module exists so ``import horovod_tpu_torch.mxnet``
fails with an actionable message rather than a bare
ModuleNotFoundError, as the reference's extension probing does
(``check_extension`` in horovod/mxnet's __init__).  The torch and
tensorflow adapters cover the same surface.
"""

try:
    import mxnet  # noqa: F401
except ImportError as _exc:
    raise ImportError(
        "horovod_tpu_torch.mxnet requires the mxnet package, which is "
        "not installed (MXNet is retired). Use horovod_tpu_torch.torch "
        "(`import horovod_tpu_torch.torch as hvd`) or "
        "horovod_tpu_torch.tensorflow instead") from _exc
