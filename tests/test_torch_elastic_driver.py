"""The port's elastic driver against the JAX package's: the decision-logic
cases of ``tests/test_elastic_driver.py`` (discovery, registry,
assignments, the release gate, lifecycle events, the blacklist and churn)
replayed on ``horovod_tpu_torch.elastic``, and one discovery sequence fed
to both drivers with the same assignments, spawns, notifications and
events.  No worker processes (``tests/test_torch_elastic_integration.py``
runs real ones)."""

import json
import threading
import time

import pytest

from _helpers import free_port

from horovod_tpu.elastic import driver as jdriver
from horovod_tpu_torch.elastic import discovery, registration
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.elastic.worker import HostUpdateResult
from horovod_tpu_torch.runner.rpc import JsonRpcServer, json_request


# --- discovery --------------------------------------------------------------

def test_parse_host_lines():
    from horovod_tpu.elastic import discovery as jdiscovery
    text = "a:4\n\n# comment\nb:2\nbare-host\n"
    assert discovery.parse_host_lines(text) == {"a": 4, "b": 2,
                                                "bare-host": 1}
    assert discovery.parse_host_lines(text) == \
        jdiscovery.parse_host_lines(text)


def test_host_discovery_script(tmp_path):
    hf = tmp_path / "hosts.txt"
    hf.write_text("localhost:3\n")
    d = discovery.HostDiscoveryScript(f"cat {hf}")
    assert d.find_available_hosts_and_slots() == {"localhost": 3}
    hf.write_text("localhost:1\nother:2\n")
    assert d.find_available_hosts_and_slots() == {"localhost": 1, "other": 2}


# --- registry ---------------------------------------------------------------

def test_registry_blacklist():
    reg = registration.WorkerStateRegistry(blacklist_threshold=2)
    reg.record_ready(0, "hostA")
    reg.record_result(0, registration.FAILURE)
    assert not reg.is_blacklisted("hostA")
    reg.record_result(1, registration.FAILURE, "hostA")
    assert reg.is_blacklisted("hostA")
    assert reg.blacklisted_hosts() == ("hostA",)
    assert reg.failure_count("hostA") == 2


# --- driver decision logic (no processes) -----------------------------------

class _StubProc:
    class _Popen:
        def __init__(self):
            self.rc = None

        def poll(self):
            return self.rc

        def terminate(self):
            self.rc = -15

        def kill(self):
            self.rc = -9

    def __init__(self):
        self.popen = self._Popen()


def _capturing(base):
    """``base`` with process launch and notification captured, its
    decisions real; every launched process stub kept in ``procs``."""

    class Driver(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.spawned = []
            self.notified = []
            self.procs = {}

        def _launch(self, slot, coord_addr, coord_port, env):
            wid = int(env["HOROVOD_ELASTIC_WORKER_ID"])
            self.spawned.append((wid, slot.hostname, slot.rank))
            self.procs[wid] = _StubProc()
            return self.procs[wid]

        def _notify_workers(self, targets, update_res):
            self.notified.append((sorted(wid for wid, _ in targets),
                                  update_res))

    return Driver


_NoSpawnDriver = _capturing(ElasticDriver)


@pytest.fixture
def nospawn():
    d = _NoSpawnDriver(
        discovery.FixedHostDiscovery({"localhost": 2}),
        ["true"], min_np=1, port=free_port())
    yield d
    d._server.close()


def test_driver_initial_assignment(nospawn):
    nospawn._apply_hosts({"localhost": 2}, HostUpdateResult.ADDED)
    assert [w for w, _, _ in nospawn.spawned] == [0, 1]
    # release gate: the first member's poll is held until every member
    # has polled once
    assert nospawn._handle_assignment(
        {"worker_id": 0, "min_epoch": 0}) == {"ready": False,
                                              "retry_after": 0.2}
    asg1 = nospawn._handle_assignment({"worker_id": 1, "min_epoch": 0})
    asg0 = nospawn._handle_assignment({"worker_id": 0, "min_epoch": 0})
    assert asg0["ready"] and asg1["ready"]
    assert asg0["rank"] == 0 and asg1["rank"] == 1
    assert asg0["size"] == 2 == asg1["size"]
    assert asg0["coordinator_port"] == asg1["coordinator_port"]
    assert nospawn._handle_assignment(
        {"worker_id": 0, "min_epoch": 1}) == {"ready": False,
                                              "retry_after": 0.2}


def test_driver_scale_up_spawns_and_notifies(nospawn):
    nospawn._apply_hosts({"localhost": 2}, HostUpdateResult.ADDED)
    nospawn._handle_register_notification(
        {"worker_id": 0, "addr": "localhost", "port": 1})
    nospawn.spawned.clear()
    nospawn._apply_hosts({"localhost": 3}, HostUpdateResult.ADDED)
    assert [w for w, _, _ in nospawn.spawned] == [2]
    assert nospawn.notified[-1] == ([0], HostUpdateResult.ADDED)
    for wid in (0, 1):   # open the release gate
        nospawn._handle_assignment({"worker_id": wid, "min_epoch": 1})
    asg = nospawn._handle_assignment({"worker_id": 2, "min_epoch": 0})
    assert asg["rank"] == 2 and asg["size"] == 3


def test_driver_removed_worker_gets_removed_reply(nospawn):
    nospawn._apply_hosts({"localhost": 2, "hostB": 1},
                         HostUpdateResult.ADDED)
    nospawn._apply_hosts({"localhost": 2}, HostUpdateResult.REMOVED)
    assert nospawn._handle_assignment(
        {"worker_id": 2, "min_epoch": 0}) == {"removed": True}
    nospawn._handle_assignment({"worker_id": 0, "min_epoch": 1})
    nospawn._handle_assignment({"worker_id": 1, "min_epoch": 1})
    asg = nospawn._handle_assignment({"worker_id": 0, "min_epoch": 1})
    assert asg["ready"] and asg["size"] == 2 and asg["epoch"] == 1


def test_driver_max_np_caps_slots(nospawn):
    nospawn.max_np = 2
    nospawn._apply_hosts({"localhost": 8}, HostUpdateResult.ADDED)
    assert len(nospawn.spawned) == 2


def test_epoch_release_gate_all_polled(nospawn):
    nospawn._apply_hosts({"localhost": 3}, HostUpdateResult.ADDED)
    assert not nospawn._handle_assignment(
        {"worker_id": 0, "min_epoch": 0})["ready"]
    assert not nospawn._handle_assignment(
        {"worker_id": 1, "min_epoch": 0})["ready"]
    assert nospawn._handle_assignment(
        {"worker_id": 2, "min_epoch": 0})["ready"]
    assert nospawn._handle_assignment(
        {"worker_id": 0, "min_epoch": 0})["ready"]
    assert "epoch_applied" in [e for e, _ in nospawn._events]
    _, info = nospawn.wait_event("epoch_released", timeout=1)
    assert info == {"epoch": 0, "reason": "all_polled"}


def test_epoch_release_gate_deadline_fallback(nospawn):
    nospawn.start_timeout = 0.05
    nospawn._apply_hosts({"localhost": 2}, HostUpdateResult.ADDED)
    assert not nospawn._handle_assignment(
        {"worker_id": 0, "min_epoch": 0})["ready"]
    time.sleep(0.1)
    assert nospawn._handle_assignment(
        {"worker_id": 0, "min_epoch": 0})["ready"]
    _, info = nospawn.wait_event("epoch_released", timeout=1)
    assert info["reason"] == "deadline"


def test_lifecycle_events_formed_and_listener(nospawn):
    seen = []
    nospawn.add_listener(lambda ev, info: seen.append(ev))
    nospawn._apply_hosts({"localhost": 2}, HostUpdateResult.ADDED)
    nospawn._handle_running({"worker_id": 0, "epoch": 0})
    with pytest.raises(TimeoutError):
        nospawn.wait_event("epoch_formed", timeout=0.05)
    nospawn._handle_running({"worker_id": 1, "epoch": 0})
    i, info = nospawn.wait_event("epoch_formed", timeout=1)
    assert info == {"epoch": 0, "size": 2}
    assert nospawn.flush_listeners(timeout=5)
    assert "epoch_applied" in seen and "epoch_formed" in seen
    # a stale-epoch running report never forms a fresh epoch
    nospawn._apply_hosts({"localhost": 2}, HostUpdateResult.MIXED)
    nospawn._handle_running({"worker_id": 0, "epoch": 0})
    with pytest.raises(TimeoutError):
        nospawn.wait_event("epoch_formed", timeout=0.05, since=i + 1)


def test_blacklist_fed_by_repeated_started_crashes():
    d = _NoSpawnDriver(
        discovery.FixedHostDiscovery({"hostA": 1}), ["true"],
        min_np=1, port=free_port(), blacklist_threshold=2)
    try:
        d._apply_hosts({"hostA": 1}, HostUpdateResult.ADDED)
        d._handle_running({"worker_id": 0, "epoch": 0})
        d.procs[0].popen.rc = 1                      # crash #1
        assert d._reap_workers() is None             # re-forms, respawns
        assert d.registry.failure_count("hostA") == 1
        assert not d.registry.is_blacklisted("hostA")
        assert 1 in d.procs
        d._handle_running({"worker_id": 1, "epoch": 1})
        d.procs[1].popen.rc = 1                      # crash #2: threshold
        rc = d._reap_workers()
        assert d.registry.is_blacklisted("hostA")
        assert d._discover() == {}
        assert rc == 1
    finally:
        d._server.close()


def test_rendezvous_churn_does_not_feed_blacklist():
    d = _NoSpawnDriver(
        discovery.FixedHostDiscovery({"hostA": 1}), ["true"],
        min_np=1, port=free_port(), blacklist_threshold=2)
    try:
        d._apply_hosts({"hostA": 1}, HostUpdateResult.ADDED)
        for _ in range(4):
            d.procs[max(d.procs)].popen.rc = 1
            assert d._reap_workers() is None
        assert d.registry.failure_count("hostA") == 0
        assert not d.registry.is_blacklisted("hostA")
        assert d._reset_count == 0
        assert len(d.procs) == 5
        kinds = [i["kind"] for e, i in d._events if e == "worker_exit"]
        assert kinds == ["churn"] * 4
    finally:
        d._server.close()


def test_driver_blacklisted_host_excluded(nospawn):
    for _ in range(3):
        nospawn.registry.record_result(99, registration.FAILURE, "badhost")
    nospawn.discovery = discovery.FixedHostDiscovery(
        {"localhost": 1, "badhost": 4})
    assert nospawn._discover() == {"localhost": 1}


def test_json_rpc_roundtrip():
    got = {}

    def handler(payload):
        got.update(payload)
        return {"echo": payload["x"] * 2}

    srv = JsonRpcServer({"f": handler})
    try:
        assert json_request("localhost", srv.port, "f", {"x": 21}) == \
            {"echo": 42}
        assert got == {"x": 21}
        with pytest.raises(Exception):
            json_request("localhost", srv.port, "nope", {})
    finally:
        srv.close()


def test_flush_listeners_delivers_terminal_events(nospawn):
    seen = []
    nospawn.add_listener(lambda ev, info: seen.append(ev))
    nospawn._apply_hosts({"localhost": 1}, HostUpdateResult.ADDED)
    nospawn._handle_result({"worker_id": 0, "status": "SUCCESS"})
    assert nospawn.flush_listeners(timeout=5)
    assert "job_done" in seen


def test_driver_network_interface_flows_to_workers():
    captured = {}

    class _CaptureDriver(_NoSpawnDriver):
        def _launch(self, slot, coord_addr, coord_port, env):
            captured["coord"] = coord_addr
            captured["driver"] = env["HOROVOD_ELASTIC_DRIVER_ADDR"]
            return super()._launch(slot, coord_addr, coord_port, env)

    d = _CaptureDriver(
        discovery.FixedHostDiscovery({"localhost": 1}), ["true"],
        min_np=1, port=free_port(), network_interface="lo")
    try:
        d._apply_hosts({"localhost": 1}, HostUpdateResult.ADDED)
    finally:
        d._server.close()
    assert captured == {"coord": "127.0.0.1", "driver": "127.0.0.1"}


# --- the port's additions ---------------------------------------------------

def test_hosts_updated_push_names_the_epoch_and_the_dead_ranks():
    """The push carries the new epoch and the previous epoch's ranks whose
    processes died; a removed but live worker is not among them."""
    pushes = []
    srv = JsonRpcServer({"hosts_updated":
                         lambda p: pushes.append(p) or {"ok": True}})
    d = ElasticDriver(discovery.FixedHostDiscovery({"localhost": 3}),
                      ["true"], min_np=1, port=free_port())
    procs = {}
    d._launch = lambda slot, a, p, env: procs.setdefault(
        int(env["HOROVOD_ELASTIC_WORKER_ID"]), _StubProc())
    try:
        d._apply_hosts({"localhost": 3}, HostUpdateResult.ADDED)
        d._handle_register_notification(
            {"worker_id": 0, "addr": "127.0.0.1", "port": srv.port})
        procs[1].popen.rc = -9            # rank 1 dies
        d._apply_hosts({"localhost": 2}, HostUpdateResult.MIXED)
        assert pushes[-1]["epoch"] == 1 and pushes[-1]["lost"] == [1]
        assert pushes[-1]["res"] == HostUpdateResult.MIXED
        d._apply_hosts({"localhost": 1}, HostUpdateResult.REMOVED)
        assert pushes[-1]["epoch"] == 2 and pushes[-1]["lost"] == []
    finally:
        d._server.close()
        srv.close()


def test_driver_exposes_no_recovery_or_kv_plane(nospawn):
    """A store per epoch: no driver-hosted KV store and no dead-epoch
    sweep.  The checkpointless-recovery RPCs are ported since: the plan
    answers with the epoch's peers, a note lands in the directory, a
    rebuild note emits ``worker_rebuilt`` and GET ``recovery/stats``
    serves the directory (the JAX driver serves it through its job
    scraper, A9)."""
    from horovod_tpu_torch.metrics import aggregate
    assert not hasattr(nospawn, "_kv_server")
    assert not hasattr(nospawn, "_prune_dead_epoch_keys")
    plan = json_request("localhost", nospawn.port, "recovery_plan", {},
                        retries=0)
    assert plan["ok"] and plan["peers"] == {} and "epoch" in plan
    note = {"kind": "rebuilt", "src_worker": 5, "src_rank": 1, "epoch": 0,
            "step": 3, "bytes": 64, "source": "neighbor", "seconds": 0.5}
    assert json_request("localhost", nospawn.port, "recovery_note", note,
                        retries=0)["ok"]
    _, ev = nospawn.wait_event("worker_rebuilt", timeout=10)
    assert (ev["worker_id"], ev["rank"], ev["step"]) == (5, 1, 3)
    stats = json.loads(aggregate.scrape("127.0.0.1", nospawn.port,
                                        route="recovery/stats"))
    assert stats["rebuilds"][-1]["src_worker"] == 5


# --- one discovery sequence, both drivers ------------------------------------

def _drive(base, port):
    """A discovery sequence through ``base``: start at 2 slots, register
    two listeners, form, grow to 3, add a host, crash a running worker
    (the reaper re-forms), drop the host, shrink, and finish.  Returns
    what the driver decided at each point."""
    cls = _capturing(base)
    d = cls(discovery.FixedHostDiscovery({"localhost": 2}), ["true"],
            min_np=1, port=port, blacklist_threshold=3)
    seen = []
    try:
        def snap():
            with d._lock:
                seen.append({
                    "epoch": d._epoch,
                    "assignment": {
                        wid: {**{k: v for k, v in a.items()
                                 if k != "coordinator_port"},
                              "port_offset": a["coordinator_port"] - port}
                        for wid, a in sorted(d._assignment.items())},
                    "expected_exit": sorted(
                        w.worker_id for w in d._workers.values()
                        if w.expected_exit)})

        def poll_all(epoch):
            for wid in sorted(d._assignment):
                d._handle_assignment({"worker_id": wid,
                                      "min_epoch": epoch})
            replies = {wid: d._handle_assignment({"worker_id": wid,
                                                  "min_epoch": epoch})
                       for wid in sorted(d._assignment)}
            for r in replies.values():
                r["coordinator_port"] -= port
            return replies

        def run_all(epoch):
            for wid in sorted(d._assignment):
                d._handle_running({"worker_id": wid, "epoch": epoch})

        d._apply_hosts({"localhost": 2}, HostUpdateResult.ADDED)
        for wid in (0, 1):
            d._handle_register_notification(
                {"worker_id": wid, "addr": "127.0.0.1", "port": 1})
        seen.append(poll_all(0))
        run_all(0)
        snap()
        d.discovery = discovery.FixedHostDiscovery({"localhost": 3})
        d._apply_hosts(d._discover(), d._host_delta(d._discover()))
        seen.append(poll_all(1))
        run_all(1)
        snap()
        d.discovery = discovery.FixedHostDiscovery({"localhost": 3,
                                                    "hostB": 2})
        d._apply_hosts(d._discover(), d._host_delta(d._discover()))
        run_all(2)
        snap()
        d.procs[1].popen.rc = 1           # a running worker crashes
        seen.append(d._reap_workers())
        seen.append(poll_all(3))
        run_all(3)
        snap()
        d.discovery = discovery.FixedHostDiscovery({"localhost": 2})
        d._apply_hosts(d._discover(), d._host_delta(d._discover()))
        snap()
        for wid, p in sorted(d.procs.items()):
            if p.popen.rc is None and d._workers[wid].expected_exit:
                p.popen.rc = 1            # the removed ones leave
        seen.append(d._reap_workers())
        d._handle_result({"worker_id": 0, "status": "SUCCESS"})
        for p in d.procs.values():
            if p.popen.rc is None:
                p.popen.rc = 0
        seen.append(d._reap_workers())
        d.flush_listeners()
        events = [(e, {k: v for k, v in i.items()})
                  for e, i in d._events]
        return {"seen": seen, "spawned": d.spawned, "notified": d.notified,
                "events": events,
                "failures": d.registry.failure_count("localhost"),
                "resets": d._reset_count}
    finally:
        d._server.close()


def test_one_discovery_sequence_gives_both_drivers_the_same_decisions():
    want = _drive(jdriver.ElasticDriver, free_port())
    got = _drive(ElasticDriver, free_port())
    for key in ("spawned", "notified", "failures", "resets"):
        assert got[key] == want[key], key
    assert [e for e, _ in got["events"]] == [e for e, _ in want["events"]]
    assert got["events"] == want["events"]
    assert got["seen"] == want["seen"]
    # the sequence did what it says: four epochs formed, one failure
    formed = [i for e, i in got["events"] if e == "epoch_formed"]
    assert [f["size"] for f in formed] == [2, 3, 5, 5]
    assert got["failures"] == 1


def test_driver_run_exits_zero_when_workers_finish():
    """run() applies the first epoch, reaps, and returns 0 once the job's
    workers report success and exit (the monitor loop, end to end)."""
    d = _NoSpawnDriver(discovery.FixedHostDiscovery({"localhost": 2}),
                       ["true"], min_np=2, port=free_port(),
                       discovery_interval=0.05)
    rc = {}
    t = threading.Thread(target=lambda: rc.update(code=d.run()),
                         daemon=True)
    t.start()
    d.wait_event("epoch_applied", timeout=10)
    d._handle_result({"worker_id": 0, "status": "SUCCESS"})
    for p in d.procs.values():
        p.popen.rc = 0
    t.join(10)
    assert not t.is_alive() and rc == {"code": 0}


def test_elastic_driver_attach_serving():
    """tests/test_serving.py's attach_serving case on the port: the serve
    data path joins the driver's control server, a dead worker's lease
    requeues through the reaper's hook, and serve/stats rides the
    driver's GET routes."""
    import json
    import urllib.request

    from horovod_tpu_torch.serving.plane import ServingPlane
    driver = ElasticDriver(discovery.FixedHostDiscovery({"localhost": 2}),
                           ["true"], min_np=1, max_np=2, port=0)
    plane = ServingPlane(tick_ms=1.0, max_batch=2, seq_buckets="8",
                         deadline_ms=0)
    try:
        driver.attach_serving(plane)
        assert "serving_attached" in [e for e, _ in driver._events]
        json_request("127.0.0.1", driver._server.port, "serve_submit",
                     {"id": "via_driver", "tokens": [1, 2]})
        batch = plane.pull("3", wait_s=5.0)
        assert batch["ids"] == ["via_driver"]
        driver._serving.worker_gone(3)
        assert plane.stats()["queue"]["requeued"] == 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{driver._server.port}/serve/stats",
                timeout=5) as resp:
            assert json.loads(resp.read())["queue"]["requeued"] == 1
    finally:
        plane.close()
        driver._server.close()
