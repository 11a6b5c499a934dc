"""Functions that ``tests/test_torch_executor.py`` ships to the port's
``hvd.run`` and ``TpuExecutor`` workers.  A module of its own, importable
by name in a worker (``tests/`` on its ``PYTHONPATH``), that imports
neither jax nor horovod_tpu: plain ``pickle`` finds these functions by
module and name."""

import builtins


def topology():
    # the JAX test reads cross_rank(): a process is a host there; the
    # port's rank is its process
    import horovod_tpu_torch as hvd
    return {"rank": hvd.rank(), "size": hvd.size()}


def bump_counter():
    import horovod_tpu_torch as hvd  # noqa: F401 - runtime stays initialized
    builtins._hvd_exec_counter = getattr(
        builtins, "_hvd_exec_counter", 0) + 1
    return builtins._hvd_exec_counter


def allreduce_rank():
    import torch

    import horovod_tpu_torch as hvd
    out = hvd.allreduce(torch.tensor(hvd.rank() + 1.0), op=hvd.Sum,
                        name="exec_ar")
    return float(out)


def scaled_rank(scale, offset=0.0):
    import horovod_tpu_torch as hvd
    return (hvd.rank(), hvd.size(), hvd.rank() * scale + offset)


def boom():
    raise ValueError("deliberate task failure")
