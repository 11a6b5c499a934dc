"""The port's launcher (``python -m horovod_tpu_torch.runner``, console
script ``hvdrun-torch``) against the JAX package's: the cases of
``tests/test_runner.py`` for arguments, hosts, slots, the worker
environment and the remote command line, on both packages where they
agree, and real 2-process launches on the CPU over gloo."""

import os
import socket
import subprocess
import sys

import pytest

from _helpers import free_port

from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner import network as jnetwork
from horovod_tpu.runner import spawn as jspawn
from horovod_tpu_torch.runner import launch, network, parse_args
from horovod_tpu_torch.runner.hosts import (
    HostInfo, SlotAssignment, assign_slots, effective_hosts, parse_hostfile,
    parse_hosts)
from horovod_tpu_torch.runner.spawn import (is_local, remote_command,
                                            worker_env)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- arg parsing -------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["-np", "4", "-H", "a:2,b:2", "python", "train.py"],
    ["-np", "2", "--", "python", "train.py", "--lr", "0.1"],
    ["-np", "2", "--network-interface", "eth1", "python", "x.py"],
    ["--host-discovery-script", "./d.sh", "--min-np", "1", "--max-np", "4",
     "python", "x.py"],
    ["--check-build"],
])
def test_parse_args_matches_the_reference(argv):
    got, want = vars(parse_args(argv)), vars(jlaunch.parse_args(argv))
    assert got == want


def test_parse_args_basic():
    a = parse_args(["-np", "4", "-H", "a:2,b:2", "python", "train.py"])
    assert a.np == 4 and a.hosts == "a:2,b:2"
    assert a.command == ["python", "train.py"]
    a = parse_args(["-np", "2", "--", "python", "train.py", "--lr", "0.1"])
    assert a.command == ["python", "train.py", "--lr", "0.1"]
    assert a.hosts is None and a.hostfile is None


def test_parse_args_requires_np_and_command():
    with pytest.raises(SystemExit):
        parse_args(["python", "train.py"])
    with pytest.raises(SystemExit):
        parse_args(["-np", "2"])


# --- hosts and slots ---------------------------------------------------------

def test_parse_hosts():
    assert parse_hosts("a:4,b:2") == [HostInfo("a", 4), HostInfo("b", 2)]
    assert parse_hosts("solo") == [HostInfo("solo", 1)]


def test_parse_hostfile(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# comment\nnode1 slots=4\nnode2 2\nnode3\n")
    got = parse_hostfile(str(hf))
    assert got == [HostInfo("node1", 4), HostInfo("node2", 2),
                   HostInfo("node3", 1)]
    assert [(h.hostname, h.slots) for h in got] == [
        (h.hostname, h.slots) for h in jhosts.parse_hostfile(str(hf))]


def test_effective_hosts_default_localhost():
    assert effective_hosts(None, None, 8) == [HostInfo("localhost", 8)]
    with pytest.raises(ValueError):
        effective_hosts("a:1", "file", 1)


@pytest.mark.parametrize("hosts,np_", [
    ([("a", 2), ("b", 2)], 4), ([("a", 4), ("b", 4)], 5),
    ([("a", 1), ("b", 3), ("c", 2)], 6), ([("a", 8)], 3)])
def test_assign_slots_matches_the_reference(hosts, np_):
    got = assign_slots([HostInfo(h, s) for h, s in hosts], np_)
    want = jhosts.assign_slots([jhosts.HostInfo(h, s) for h, s in hosts],
                               np_)
    assert [s.to_env() for s in got] == [s.to_env() for s in want]


def test_assign_slots_host_major():
    slots = assign_slots([HostInfo("a", 2), HostInfo("b", 2)], 4)
    assert [(s.rank, s.hostname, s.local_rank, s.cross_rank)
            for s in slots] == [
        (0, "a", 0, 0), (1, "a", 1, 0), (2, "b", 0, 1), (3, "b", 1, 1)]
    assert all(s.size == 4 and s.cross_size == 2 for s in slots)


def test_assign_slots_partial_last_host():
    slots = assign_slots([HostInfo("a", 4), HostInfo("b", 4)], 5)
    assert slots[4].hostname == "b" and slots[4].local_size == 1
    assert slots[0].local_size == 4


def test_assign_slots_overflow():
    with pytest.raises(ValueError, match="exceeds"):
        assign_slots([HostInfo("a", 2)], 3)


# --- the env contract ---------------------------------------------------------

def test_worker_env_contract():
    slot = SlotAssignment(rank=3, size=8, local_rank=1, local_size=4,
                          cross_rank=0, cross_size=2, hostname="a")
    env = worker_env(slot, "10.0.0.1", 29410, base_env={"PATH": "/bin"})
    want = jspawn.worker_env(
        jhosts.SlotAssignment(rank=3, size=8, local_rank=1, local_size=4,
                              cross_rank=0, cross_size=2, hostname="a"),
        "10.0.0.1", 29410, base_env={"PATH": "/bin"})
    # the same contract, less the JAX package's controller pin: the
    # rendezvous names rank 0's TCPStore, the controller is the user's
    assert want.pop("HOROVOD_CONTROLLER") == "jax"
    assert env == want
    assert env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] == "10.0.0.1"
    assert env["HOROVOD_GLOO_RENDEZVOUS_PORT"] == "29410"
    assert env["HOROVOD_RANK"] == "3" and env["HOROVOD_SIZE"] == "8"
    assert env["HOROVOD_LOCAL_RANK"] == "1"
    assert env["HOROVOD_CROSS_RANK"] == "0"
    assert env["PATH"] == "/bin"
    gloo = worker_env(slot, "h", 1, base_env={"HOROVOD_CONTROLLER": "gloo"})
    assert gloo["HOROVOD_CONTROLLER"] == "gloo"


def test_remote_command_construction():
    slot = SlotAssignment(rank=2, size=4, local_rank=0, local_size=2,
                          cross_rank=1, cross_size=2, hostname="nodeb")
    env = {"HOROVOD_RANK": "2", "SECRET": "x", "PYTHONPATH": "/repo",
           "XLA_FLAGS": "--foo", "NCCL_DEBUG": "INFO",
           "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
           "CUDA_VISIBLE_DEVICES": "0", "HOROVOD_SECRET_KEY": "k"}
    cmd = remote_command(slot, ["python", "train.py"], env, "/work dir")
    assert cmd[0] == "ssh" and "nodeb" in cmd
    remote = cmd[-1]
    assert remote.startswith("IFS= read -r HOROVOD_SECRET_KEY && ")
    assert "cd '/work dir' && env " in remote
    for kv in ("HOROVOD_RANK=2", "PYTHONPATH=/repo", "NCCL_DEBUG=INFO",
               "TORCH_NCCL_ASYNC_ERROR_HANDLING=1",
               "CUDA_VISIBLE_DEVICES=0"):
        assert kv in remote
    assert "SECRET=" not in remote.replace("HOROVOD_SECRET_KEY", "")
    assert "=k " not in remote             # the secret rides stdin
    assert "XLA_FLAGS" not in remote
    assert remote.endswith("python train.py")


# --- network-interface selection ----------------------------------------------

def test_network_selection_matches_the_reference(monkeypatch):
    assert network.list_interfaces().get("lo") == "127.0.0.1"
    assert network.resolve_interface("lo") == "127.0.0.1"
    with pytest.raises(ValueError, match="lo"):
        network.resolve_interface("no-such-if0")
    assert network.routable_source_addr("127.0.0.1") == "127.0.0.1"
    for hosts, iface in ((["nodeA", "localhost"], None), (["localhost"], None),
                         (["localhost", "nodeB"], "lo")):
        assert network.coordinator_addr(hosts, is_local, interface=iface) \
            == jnetwork.coordinator_addr(hosts, jspawn.is_local,
                                         interface=iface)
    assert network.coordinator_addr(["localhost"], is_local) == \
        socket.gethostname()
    monkeypatch.setattr(network, "routable_source_addr",
                        lambda h, port=1: "10.0.0.7")
    assert network.coordinator_addr(["localhost", "nodeB"], is_local) == \
        "10.0.0.7"
    assert network.local_service_addr("nodeB", is_local) == "10.0.0.7"
    assert network.local_service_addr("nodeB", is_local,
                                      interface="lo") == "127.0.0.1"
    assert launch._coordinator_addr([HostInfo("localhost", 2)],
                                    interface="lo") == "127.0.0.1"


def test_check_build_reports_the_port(capsys):
    args = launch.parse_args(["--check-build"])
    assert launch.run_launcher(args) == 0
    out = capsys.readouterr().out
    assert "horovod_tpu_torch v" in out and "Available features" in out
    assert "[X] PyTorch" in out and "[X] Gloo" in out
    for name in ("flash_attention", "fused_xent"):
        assert f"CUDA library {name} built" in out
    assert "nvcc" in out and "[X] Elastic training" in out
    assert "Pallas" not in out and "_hvd_core" not in out


# --- real launches ------------------------------------------------------------

_ALLREDUCE = """
import json, os, sys, torch
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
s = hvd.allreduce(torch.tensor([hvd.rank() + 1.0]), op=hvd.Sum, name="s")
print("RESULT", json.dumps({"rank": hvd.rank(), "size": hvd.size(),
                            "local_rank": hvd.local_rank(),
                            "sum": s.item()}), flush=True)
rank = hvd.rank()
hvd.shutdown()
sys.exit(int(os.environ.get("FAIL_RANK", "-1")) == rank)
"""


def _launch(tmp_path, extra_env=None, np_=2):
    script = tmp_path / "job.py"
    script.write_text(_ALLREDUCE)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HOROVOD_CYCLE_TIME="0.1", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(np_),
         "-p", str(free_port()), "--network-interface", "lo",
         sys.executable, str(script)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_two_process_launch_allreduces(tmp_path):
    res = _launch(tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    import json
    rows = sorted(json.loads(line.split("RESULT ", 1)[1])["rank"]
                  for line in res.stdout.splitlines() if "RESULT" in line)
    assert rows == [0, 1]
    for line in res.stdout.splitlines():
        if "RESULT" in line:
            r = json.loads(line.split("RESULT ", 1)[1])
            assert (r["size"], r["sum"]) == (2, 3.0)
            assert r["local_rank"] == r["rank"]
            assert line.startswith(f"[{r['rank']}]<localhost>: ")


def test_a_failing_worker_fails_the_launch(tmp_path):
    res = _launch(tmp_path, {"FAIL_RANK": "1"})
    assert res.returncode == 1
    assert "hvdrun-torch: worker rank 1 (localhost) exited with 1" in res.stderr
