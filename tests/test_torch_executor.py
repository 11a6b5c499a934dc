"""The port's ``hvd.run`` and ``TpuExecutor`` (counterparts:
``horovod_tpu/runner/{api,executor}.py``).

``tests/test_executor.py``'s five cases on ``horovod_tpu_torch.runner``,
with CPU workers (``device="cpu"``, gloo) that import neither jax nor
horovod_tpu, then ``run``: results in rank order, a failing rank raising,
and a module-level function shipped by plain ``pickle``.  The functions
live in ``tests/torch_exec_tasks.py``.  Every launch is bounded: the
executor's start and fetch timeouts, and ``spawn.wait_workers`` under a
test-side watchdog for ``run``.
"""

import inspect
import os
import pickle
import threading

import pytest

from _helpers import free_port

import horovod_tpu.runner as jrunner
import torch_exec_tasks as tasks
from horovod_tpu_torch import runner
from horovod_tpu_torch.runner import TpuExecutor
from horovod_tpu_torch.runner import api as tapi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds any one launch in this file may take before the test fails
LAUNCH_S = 120


def _env():
    return {"PYTHONPATH": REPO + os.pathsep + os.path.join(REPO, "tests"),
            "HOROVOD_CYCLE_TIME": "0.2", "OMP_NUM_THREADS": "1"}


def _executor(**kw):
    return TpuExecutor(np=2, env=_env(), port=free_port(), device="cpu",
                       **kw)


def _run(fn, **kw):
    """``runner.run`` on CPU workers, failing the test if it outlives
    :data:`LAUNCH_S` (the workers are its children: a hang would keep
    them)."""
    out = {}

    def go():
        try:
            out["res"] = runner.run(fn, port=free_port(), env=_env(),
                                    device="cpu", **kw)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["err"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(LAUNCH_S)
    assert not t.is_alive(), f"run() outlived {LAUNCH_S} s"
    if "err" in out:
        raise out["err"]
    return out["res"]


# --- tests/test_executor.py's cases ------------------------------------------

def test_executor_pool_persistent_state():
    with _executor() as ex:
        topo = ex.run(tasks.topology, timeout_s=LAUNCH_S)
        assert [t["rank"] for t in topo] == [0, 1]
        assert all(t["size"] == 2 for t in topo)
        # workers persist between calls: the counter accumulates
        assert ex.run(tasks.bump_counter, timeout_s=LAUNCH_S) == [1, 1]
        assert ex.run(tasks.bump_counter, timeout_s=LAUNCH_S) == [2, 2]
        # a REAL cross-process collective through the warm pool
        assert ex.run(tasks.allreduce_rank, timeout_s=LAUNCH_S) == \
            [3.0, 3.0]


def test_executor_task_failure_surfaces():
    with _executor() as ex:
        with pytest.raises(RuntimeError, match="deliberate task failure"):
            ex.run(tasks.boom, timeout_s=LAUNCH_S)


def test_executor_run_remote_fetch():
    with _executor() as ex:
        t1 = ex.run_remote(tasks.bump_counter)
        t2 = ex.run_remote(tasks.bump_counter, kwargs={})
        assert ex.fetch(t1, LAUNCH_S) == [1, 1]
        assert ex.fetch(t2, LAUNCH_S) == [2, 2]


def test_executor_requires_start():
    ex = TpuExecutor(np=1)
    with pytest.raises(RuntimeError, match="not started"):
        ex.run(tasks.topology)


def test_executor_startup_failure_cleans_up():
    """A worker dying during startup must stop survivors and reclaim the
    control dir (an init that refuses its environment)."""
    bad_env = _env()
    bad_env["HOROVOD_CYCLE_TIME"] = "not-a-number"
    ex = TpuExecutor(np=2, env=bad_env, port=free_port(), device="cpu")
    with pytest.raises(RuntimeError):
        ex.start(timeout_s=LAUNCH_S)
    assert ex._procs is None and ex._tmp is None


# --- run --------------------------------------------------------------------

def test_run_returns_results_in_rank_order():
    got = _run(tasks.scaled_rank, args=(10,), kwargs={"offset": 0.5}, np=2)
    assert got == [(0, 2, 0.5), (1, 2, 10.5)]
    assert _run(tasks.allreduce_rank, np=2) == [3.0, 3.0]


def test_run_failure_raises():
    with pytest.raises(RuntimeError, match="exit code"):
        _run(tasks.boom, np=2, prefix_output=False)


def test_run_ships_a_module_function_by_plain_pickle(monkeypatch):
    """Where cloudpickle is absent, ``pickle`` ships a function by its
    module and name, which the worker imports."""
    monkeypatch.setattr(tapi, "_fn_pickle", pickle)
    blob = pickle.dumps((tasks.scaled_rank, (2,), {}))
    assert b"torch_exec_tasks" in blob and b"scaled_rank" in blob
    assert _run(tasks.scaled_rank, args=(2,), np=1) == [(0, 1, 0)]


def test_api_names_and_parameters_match_jax():
    """``runner.run`` and ``TpuExecutor`` take the JAX package's
    parameters (plus ``device``, the port's entry-point rule), and the
    package exports them as JAX's does."""
    def params(fn):
        return list(inspect.signature(fn).parameters)

    assert params(runner.run) == params(jrunner.run) + ["device"]
    assert params(TpuExecutor) == params(jrunner.TpuExecutor) + ["device"]
    for name in ("start", "run", "execute", "run_remote", "fetch",
                 "shutdown", "__enter__", "__exit__"):
        assert params(getattr(TpuExecutor, name)) == \
            params(getattr(jrunner.TpuExecutor, name)), name
    assert runner.TpuExecutor is TpuExecutor and runner.run is tapi.run


def test_chip_smoke_hvd_run_phase_on_the_cpu(capsys):
    """chip_smoke.py's hvd_run, whole, on CPU workers: the probe at np 2
    and np 1, the failing function, the executor's counter and
    run_remote/fetch, and the phase's gates."""
    import json

    import chip_smoke
    res = chip_smoke.hvd_run_phase(device="cpu")
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "hvd_run" and row["counts"] == [[1, 1], [2, 2]]
    assert [r[0] for r in res["run2"]] == [0, 1] and res["failure"]
