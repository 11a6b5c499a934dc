"""The port's elastic driver with real gloo worker processes on the CPU
(``tests/torch_elastic_worker.py``), after ``tests/test_elastic_driver.py``'s
integration cases: a hostfile the test rewrites is the discovery script's
answer.  Each case has its own deadline (WAIT_S) and waits on the driver's
lifecycle events, not on wall-clock windows."""

import json
import os
import sys
import threading
import time
from pathlib import Path

import pytest

from _helpers import free_port

from horovod_tpu_torch.elastic import discovery
from horovod_tpu_torch.elastic.driver import ElasticDriver

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_elastic_worker.py"
#: the bound of each case, process start-up included
WAIT_S = 75


def _records(out_base: Path):
    recs = []
    for f in out_base.parent.glob(out_base.name + ".*"):
        recs += [json.loads(line) for line in f.read_text().splitlines()]
    return recs


def _wait_records(out_base, pred, deadline, what):
    while time.monotonic() < deadline:
        recs = _records(out_base)
        if pred(recs):
            return recs
        time.sleep(0.1)
    pytest.fail(f"{what}; records={_records(out_base)}")


def _start(tmp_path, hosts, steps, min_np, mode="sum"):
    hostfile = tmp_path / "hosts.txt"
    hostfile.write_text(hosts)
    out_base = tmp_path / "out"
    env = {"TEST_TOTAL_STEPS": str(steps), "TEST_OUT": str(out_base),
           "TEST_MODE": mode, "PYTHONPATH": str(HERE.parent),
           "HOROVOD_CYCLE_TIME": "0.1", "OMP_NUM_THREADS": "1",
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "60"}
    driver = ElasticDriver(
        discovery.HostDiscoveryScript(f"cat {hostfile}"),
        [sys.executable, str(WORKER)], min_np=min_np, port=free_port(),
        discovery_interval=0.3, start_timeout=60.0, blacklist_threshold=8,
        env=env)
    rc = {}
    thread = threading.Thread(target=lambda: rc.update(code=driver.run()),
                              daemon=True)
    thread.start()
    return driver, thread, rc, hostfile, out_base


def _steps(recs):
    return [r for r in recs if "step" in r]


def test_scale_up_2_to_3_syncs_a_resnet_state(tmp_path):
    """2 workers → the hostfile grows to 3 → the job re-forms at size 3;
    every allreduced sum equals its world size, and the tiny ResNet's
    TensorState is bit-identical on the three ranks after the sync (the
    joiner started from another seed)."""
    driver, thread, rc, hostfile, out = _start(tmp_path, "localhost:2\n",
                                               12, 2, mode="resnet")
    deadline = time.monotonic() + WAIT_S
    try:
        i, info = driver.wait_event(
            "epoch_formed", timeout=deadline - time.monotonic(),
            match=lambda e: e["size"] == 2)
        _wait_records(out, lambda r: sum(x["size"] == 2
                                         for x in _steps(r)) >= 4,
                      deadline, "no size-2 progress")
        hostfile.write_text("localhost:3\n")
        _, info3 = driver.wait_event(
            "epoch_formed", timeout=deadline - time.monotonic(),
            match=lambda e: e["size"] == 3, since=i + 1)
        assert info3["epoch"] > info["epoch"]
        thread.join(max(deadline - time.monotonic(), 1))
        assert not thread.is_alive(), "driver did not finish"
        assert rc.get("code") == 0, rc
    finally:
        driver._terminate_all()
        driver._server.close()
    recs = _records(out)
    assert all(r["sum"] == r["size"] for r in _steps(recs))
    assert {r["size"] for r in _steps(recs)} == {2, 3}
    assert {r["rank"] for r in _steps(recs) if r["size"] == 3} == {0, 1, 2}
    # every sync leaves its epoch's ranks equal; the growth's sync ran
    # on all three (an epoch re-formed before the first step, say for a
    # taken port, syncs too: its members all joined past epoch 0)
    syncs = [r for r in recs if r.get("sync")]
    for epoch in {r["epoch"] for r in syncs}:
        assert len({r["digest"] for r in syncs if r["epoch"] == epoch}) == 1
    assert sorted(r["rank"] for r in syncs
                  if r["epoch"] == info3["epoch"]) == [0, 1, 2]


def test_sigkilled_rank_0_recovers(tmp_path):
    """SIGKILL rank 0 of two mid-job (its process hosts the store): the
    driver counts the failure and re-forms; the survivor's collective
    raises, it restores its last commit, and the replacement (rank 0 of
    the new epoch, on the dead worker's slot) takes the survivor's state
    in the sync, not its own fresh one; the job runs to its end."""
    driver, thread, rc, hostfile, out = _start(tmp_path, "localhost:2\n",
                                               10, 1, mode="resnet")
    deadline = time.monotonic() + WAIT_S
    try:
        i, _ = driver.wait_event(
            "epoch_formed", timeout=deadline - time.monotonic(),
            match=lambda e: e["size"] == 2)
        _wait_records(out, lambda r: sum(x["size"] == 2
                                         for x in _steps(r)) >= 4,
                      deadline, "no initial progress")
        with driver._lock:
            victim = next(w for w in driver._workers.values()
                          if w.slot.rank == 0)
        victim.proc.popen.kill()
        _, exit_info = driver.wait_event(
            "worker_exit", timeout=deadline - time.monotonic(),
            match=lambda e: e["worker_id"] == victim.worker_id, since=i + 1)
        assert exit_info["kind"] == "failure"
        _, formed = driver.wait_event(
            "epoch_formed", timeout=deadline - time.monotonic(),
            match=lambda e: e["size"] == 2, since=i + 1)
        thread.join(max(deadline - time.monotonic(), 1))
        assert not thread.is_alive(), "driver did not finish after failure"
        assert rc.get("code") == 0, rc
    finally:
        driver._terminate_all()
        driver._server.close()
    assert driver.registry.failure_count("localhost") == 1
    recs = _records(out)
    steps = _steps(recs)
    assert all(r["sum"] == r["size"] for r in steps)
    assert max(r["step"] for r in steps) == 9
    # the last steps ran in the re-formed epoch, on both ranks
    assert {r["rank"] for r in steps if r["epoch"] == formed["epoch"]} == \
        {0, 1}
    # the survivor (rank 1 before and after) went through a restore or,
    # if it was between collectives when rank 0 died, the re-form
    # notice; either way the sync spread one of its commits
    syncs = [r for r in recs if r.get("sync")
             and r["epoch"] == formed["epoch"]]
    assert sorted(r["rank"] for r in syncs) == [0, 1]
    assert len({r["digest"] for r in syncs}) == 1
    survivor = {r["digest"] for r in recs if r.get("commit")
                and r["rank"] == 1 and r["epoch"] < formed["epoch"]}
    assert syncs[0]["digest"] in survivor
    assert all(r["rank"] == 1 for r in recs if r.get("restore"))


def test_scale_down_3_to_2(tmp_path):
    """3 workers → the hostfile shrinks to 2 → the removed worker leaves,
    the job re-forms at size 2 and runs to its end."""
    driver, thread, rc, hostfile, out = _start(tmp_path, "localhost:3\n",
                                               12, 2)
    deadline = time.monotonic() + WAIT_S
    try:
        i, info = driver.wait_event(
            "epoch_formed", timeout=deadline - time.monotonic(),
            match=lambda e: e["size"] == 3)
        _wait_records(out, lambda r: sum(x["size"] == 3
                                         for x in _steps(r)) >= 6,
                      deadline, "no size-3 progress")
        hostfile.write_text("localhost:2\n")
        _, info2 = driver.wait_event(
            "epoch_formed", timeout=deadline - time.monotonic(),
            match=lambda e: e["size"] == 2, since=i + 1)
        assert info2["epoch"] > info["epoch"]
        thread.join(max(deadline - time.monotonic(), 1))
        assert not thread.is_alive(), "driver did not finish"
        assert rc.get("code") == 0, rc
    finally:
        driver._terminate_all()
        driver._server.close()
    recs = _steps(_records(out))
    assert all(r["sum"] == r["size"] for r in recs)
    assert max(r["step"] for r in recs) == 11
    assert {r["size"] for r in recs if r["step"] >= 10} == {2}
    exits = [i for e, i in driver._events if e == "worker_exit"]
    assert sorted(x["kind"] for x in exits) == ["expected", "success",
                                                "success"]


def test_worker_script_runs_without_the_driver(tmp_path):
    """HOROVOD_ELASTIC=1 without the driver's address: init takes the
    launcher's environment (a world of one here) and @hvd.elastic.run
    trains to the end."""
    import subprocess
    env = dict(os.environ, HOROVOD_ELASTIC="1", TEST_TOTAL_STEPS="2",
               TEST_OUT=str(tmp_path / "out"), HOROVOD_ELASTIC_WORKER_ID="0",
               PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    for k in ("HOROVOD_ELASTIC_DRIVER_ADDR", "HOROVOD_ELASTIC_DRIVER_PORT"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, str(WORKER)], env=env,
                         capture_output=True, text=True, timeout=WAIT_S)
    assert res.returncode == 0, res.stdout + res.stderr
    recs = _steps(_records(tmp_path / "out"))
    assert [(r["step"], r["size"], r["sum"]) for r in recs] == \
        [(0, 1, 1.0), (1, 1, 1.0)]
