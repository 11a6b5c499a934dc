"""TpuExecutor: a persistent worker-pool execution API (L5 tier).

Counterpart: ``horovod_tpu/runner/executor.py``, whose class name this
keeps.  Reference parity: ``horovod.ray.RayExecutor`` (SURVEY.md §2.2,
L5) — the cluster-integration capability class: start a pool of workers
once (placement-group actors in the reference; runtime-initialized
processes here), ``run()`` arbitrary functions on all of them repeatedly
without re-paying rendezvous/compile setup, then ``shutdown()``.

Workers are spawned through the same launcher substrate as
``hvdrun-torch`` (ssh/local, rank 0's ``TCPStore`` for the rendezvous)
and keep their runtime, process groups and built CUDA kernels alive
between calls.  Task distribution uses a shared control directory
(localhost or shared filesystem; the reference delegates the equivalent
plumbing to Ray's object store).  Functions travel as in
:func:`~horovod_tpu_torch.runner.api.run`: by ``cloudpickle`` when it
imports, else by ``pickle`` (define them in an importable module).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional

try:  # serialize __main__-defined functions by value (Ray ergonomics)
    import cloudpickle as _fn_pickle
except ImportError:  # pragma: no cover - plain pickle finds it by name
    _fn_pickle = pickle

from . import spawn
from .hosts import assign_slots, effective_hosts
from .launch import DEFAULT_PORT, _coordinator_addr

_POLL_S = 0.05


class TpuExecutor:
    """Persistent pool of runtime-initialized workers.

    Usage (reference: RayExecutor)::

        ex = TpuExecutor(np=4)
        ex.start()
        results = ex.run(train_fn, args=(cfg,))   # list, one per rank
        more    = ex.run(eval_fn)                 # same workers, warm
        ex.shutdown()
    """

    def __init__(self, np: int = 1, hosts: Optional[str] = None,
                 hostfile: Optional[str] = None, port: int = DEFAULT_PORT,
                 env: Optional[dict] = None, verbose: bool = False,
                 device: Optional[str] = None):
        self.np = np
        self._device = device
        self._hosts = hosts
        self._hostfile = hostfile
        self._port = port
        self._env = env or {}
        self._verbose = verbose
        self._procs = None
        self._tmp = None
        self._control_dir = None
        self._seq = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout_s: float = 120.0):
        """Spawn the worker pool and wait until every worker is ready
        (runtime initialized on the executor's ``device``, task loop
        entered)."""
        if self._procs is not None:
            raise RuntimeError("executor already started")
        host_list = effective_hosts(self._hosts, self._hostfile, self.np)
        slots = assign_slots(host_list, self.np)
        addr = _coordinator_addr(host_list)
        self._tmp = tempfile.TemporaryDirectory(prefix="hvdexec_")
        self._control_dir = self._tmp.name
        command = [sys.executable, "-m",
                   "horovod_tpu_torch.runner.executor_task",
                   self._control_dir]
        if self._device is not None:
            command.append(str(self._device))
        base_env = dict(os.environ)
        base_env.update(self._env)
        self._procs = spawn.spawn_workers(
            slots, command, addr, self._port,
            prefix_output=self._verbose, base_env=base_env)
        self._slots = slots
        deadline = time.monotonic() + timeout_s
        try:
            for slot in slots:
                ready = os.path.join(self._control_dir,
                                     f"ready_{slot.rank}")
                while not os.path.exists(ready):
                    self._check_alive()
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"worker rank {slot.rank} not ready within "
                            f"{timeout_s}s")
                    time.sleep(_POLL_S)
        except BaseException:
            # a worker died or timed out during startup: stop the
            # survivors and reclaim the control dir before surfacing
            self.shutdown()
            raise

    def _check_alive(self):
        for p in self._procs or []:
            rc = p.popen.poll()
            if rc is not None and rc != 0:
                raise RuntimeError(
                    f"executor worker rank {p.slot.rank} exited with "
                    f"code {rc}")

    # -- execution -----------------------------------------------------------
    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None,
            timeout_s: float = 600.0) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` on every worker; returns per-rank
        results ordered by rank (reference: RayExecutor.run)."""
        return self.fetch(self.run_remote(fn, args, kwargs), timeout_s)

    execute = run  # reference alias

    def run_remote(self, fn: Callable, args: tuple = (),
                   kwargs: Optional[dict] = None) -> int:
        """Submit without waiting; returns a task id for :meth:`fetch`."""
        if self._procs is None:
            raise RuntimeError("executor not started")
        seq = self._seq
        self._seq += 1
        task_tmp = os.path.join(self._control_dir, f".task_{seq}.tmp")
        with open(task_tmp, "wb") as f:
            _fn_pickle.dump((fn, args, kwargs or {}), f)
        os.replace(task_tmp, os.path.join(self._control_dir,
                                          f"task_{seq}.pkl"))
        return seq

    def fetch(self, task_id: int, timeout_s: float = 600.0) -> List[Any]:
        """Collect the per-rank results of a :meth:`run_remote` task."""
        results: List[Any] = [None] * self.np
        deadline = time.monotonic() + timeout_s
        for slot in self._slots:
            path = os.path.join(self._control_dir,
                                f"result_{task_id}_{slot.rank}.pkl")
            while not os.path.exists(path):
                self._check_alive()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"task {task_id}: no result from rank "
                        f"{slot.rank} within {timeout_s}s")
                time.sleep(_POLL_S)
            with open(path, "rb") as f:
                ok, payload = pickle.load(f)
            if not ok:
                raise RuntimeError(
                    f"task {task_id} failed on rank {slot.rank}:"
                    f"\n{payload}")
            results[slot.rank] = payload
        return results

    # -- teardown ------------------------------------------------------------
    def shutdown(self, timeout_s: float = 30.0):
        """Stop the pool (reference: RayExecutor.shutdown)."""
        if self._procs is None:
            return
        try:
            stop = os.path.join(self._control_dir, "stop")
            with open(stop, "w") as f:
                f.write("1")
            deadline = time.monotonic() + timeout_s
            for p in self._procs:
                while p.popen.poll() is None:
                    if time.monotonic() > deadline:
                        p.popen.terminate()
                        break
                    time.sleep(_POLL_S)
        finally:
            self._procs = None
            if self._tmp is not None:
                self._tmp.cleanup()
                self._tmp = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
