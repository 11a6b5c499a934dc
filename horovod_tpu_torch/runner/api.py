"""``horovod_tpu_torch.runner.run`` — the in-Python launch API.

Counterpart: ``horovod_tpu/runner/api.py``; reference parity:
``horovod.run(fn, args=..., np=N, hosts=...)`` (horovod/runner/launch.py
``run`` / ``_run``): pickle a function, launch ``np`` workers that each
call it under an initialized runtime, and return the list of per-rank
results ordered by rank.

The rendezvous is rank 0's ``TCPStore`` at ``port`` on the first host, as
under ``hvdrun-torch`` (the JAX package hosts ``runner/kv.py`` here, which
the port does not have).  The function travels by ``cloudpickle`` when it
imports, else by ``pickle``, which finds a function by its module and
name: define it in an importable module, not in ``__main__``.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Any, Callable, List, Optional

try:  # serialize __main__-defined functions by value (reference: horovod
    # uses cloudpickle for run(fn) the same way)
    import cloudpickle as _fn_pickle
except ImportError:  # pragma: no cover - plain pickle finds it by name
    _fn_pickle = pickle

from . import spawn
from .hosts import assign_slots, effective_hosts
from .launch import DEFAULT_PORT, _coordinator_addr


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        np: int = 1, hosts: Optional[str] = None,
        hostfile: Optional[str] = None, port: int = DEFAULT_PORT,
        env: Optional[dict] = None, verbose: bool = False,
        prefix_output: bool = True, device: Optional[str] = None
        ) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` workers; returns per-rank
    results ordered by rank.  Raises RuntimeError if any worker fails.

    Each worker calls ``hvd.init(device=device)``: ``cuda:<local_rank>``
    by default, ``"cpu"`` for gloo on CPU tensors, ``"cuda:0"`` for ranks
    sharing one card (with ``HOROVOD_CONTROLLER=gloo`` in ``env``)."""
    kwargs = kwargs or {}
    host_list = effective_hosts(hosts, hostfile, np)
    slots = assign_slots(host_list, np)
    addr = _coordinator_addr(host_list)
    with tempfile.TemporaryDirectory(prefix="hvdrun_") as tmp:
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            _fn_pickle.dump((fn, args, kwargs), f)
        results_dir = os.path.join(tmp, "results")
        os.makedirs(results_dir)
        command = [sys.executable, "-m", "horovod_tpu_torch.runner.run_task",
                   payload, results_dir]
        if device is not None:
            command.append(str(device))
        base_env = dict(os.environ)
        if env:
            base_env.update(env)
        procs = spawn.spawn_workers(
            slots, command, addr, port, prefix_output=prefix_output,
            base_env=base_env)
        rc = spawn.wait_workers(procs)
        if rc != 0:
            raise RuntimeError(f"horovod_tpu_torch.runner.run failed with "
                               f"exit code {rc}")
        results = []
        for slot in slots:
            path = os.path.join(results_dir, f"rank_{slot.rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"worker rank {slot.rank} exited 0 but wrote no result")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
