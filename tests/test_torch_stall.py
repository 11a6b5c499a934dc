"""The port's stall inspector (``stall.py``) against the JAX package's, and
its bridge to the elastic driver's blacklist.

* The stall cases of the JAX package's ``tests/test_tail.py`` (arrival
  timestamps, the straggler EWMA, the edge-triggered ``on_straggler``, a
  disabled inspector), replayed, and one event sequence fed to both
  inspectors with the same scores and missing ranks.
* The warning after ``HOROVOD_STALL_CHECK_TIME_SECONDS``, and the
  controller's deadline as the one abort bar (``overdue``).
* The engine: at world 1 its stats carry the scores; at world 2
  (``tests/torch_ranks.py`` ``case_tools``) rank 1 submits a tensor 1.5 s
  late under a 0.5 s check time: rank 0's log names rank 1, the
  collective completes, and rank 1's straggler score rises on rank 0.
* The straggler bridge (JAX ``tests/test_tail.py`` :476-547 on the port's
  driver): soft failures feed the blacklist, debounced per epoch and off
  without a bar; and ``hvd.init()``'s inspector reports a straggler
  through ``elastic.worker.report_straggler`` to a live driver.
"""

import logging

import pytest
import torch

from _helpers import free_port

from horovod_tpu.stall import StallInspector as JStall
import horovod_tpu_torch as hvd
from horovod_tpu_torch.elastic import discovery, registration
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.elastic.worker import HostUpdateResult
from horovod_tpu_torch.stall import EWMA_ALPHA, StallInspector

import torch_ranks as tr


def test_record_missing_stamps_arrival_timestamps():
    si = StallInspector(check_time=1e9)
    si.record_missing("t", [1, 2], now=100.0)
    assert si.missing_since("t", 1) == 100.0
    assert si.missing_since("t", 2) == 100.0
    si.record_missing("t", [2], now=101.5)
    assert si.missing_since("t", 1) is None
    assert si.straggler_scores()[1] == pytest.approx(1.5 * EWMA_ALPHA)
    si.record_complete("t", now=102.0)
    assert si.missing_since("t", 2) is None
    assert si.straggler_scores()[2] == pytest.approx(2.0 * EWMA_ALPHA)
    assert si.missing_processes("t") == []


def test_straggler_score_ewma_decays_on_on_time_rounds():
    si = StallInspector(check_time=1e9)
    si.note_lateness(3, 1.0)
    peak = si.straggler_scores()[3]
    for _ in range(20):
        si.note_lateness(3, 0.0)
    assert si.straggler_scores()[3] < peak / 10


def test_on_straggler_fires_edge_triggered_and_rearms():
    fired = []
    si = StallInspector(check_time=1e9, blacklist_score=0.5,
                        on_straggler=lambda p, s: fired.append((p, s)))
    for _ in range(8):
        si.note_lateness(1, 3.0)
    assert len(fired) == 1 and fired[0][0] == 1 and fired[0][1] >= 0.5
    for _ in range(30):
        si.note_lateness(1, 0.0)
    for _ in range(8):
        si.note_lateness(1, 3.0)
    assert len(fired) == 2


def test_disabled_inspector_scores_nothing():
    si = StallInspector(check_time=1e9, disabled=True)
    si.note_lateness(1, 5.0)
    si.record_missing("t", [1], now=1.0)
    assert si.straggler_scores() == {}


def _sequence(si):
    si.record_enqueue("a", 10.0)
    si.record_missing("a", [1, 3], now=10.5)
    si.note_lateness(0, 0.2)
    si.record_missing("a", [3], now=11.25)
    si.record_missing("b", [2], now=11.5)
    si.note_lateness(2, 0.0)
    si.record_complete("a", now=12.0)
    si.record_missing("b", [], now=13.0)
    return (si.straggler_scores(), si.missing_processes("a"),
            si.missing_processes("b"), si.missing_since("b", 2))


def test_same_scores_as_jax_on_one_sequence():
    got = _sequence(StallInspector(check_time=1e9))
    want = _sequence(JStall(check_time=1e9, use_native=False))
    assert got[1:] == want[1:]
    assert got[0] == pytest.approx(want[0])


def test_check_warns_once_naming_the_missing_ranks(caplog):
    si = StallInspector(check_time=1.0)
    si.record_enqueue("slow", 0.0)
    si.record_missing("slow", [3], now=0.5)
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        si.check(now=0.9)
        assert si.warnings_issued == 0
        si.check(now=1.5)
        si.check(now=2.5)
    assert si.warnings_issued == 1
    assert "slow" in caplog.text and "missing on ranks [3]" in caplog.text
    si.record_complete("slow", now=3.0)
    si.record_enqueue("slow", 4.0)
    si.check(now=5.5)
    assert si.warnings_issued == 2


def test_overdue_is_the_controllers_bar():
    si = StallInspector(check_time=60.0)
    si.record_enqueue("t", 100.0)
    assert not si.overdue("t", 5.0, now=104.0)
    assert si.overdue("t", 5.0, now=105.5)
    assert not si.overdue("other", 5.0, now=200.0)
    si.record_complete("t")
    assert not si.overdue("t", 5.0, now=200.0)


def test_lateness_histogram_family_observes_per_process():
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.stall import _m_lateness
    si = StallInspector(check_time=1e9)
    before = _m_lateness.child(process="91")
    n0 = before.count if before is not None else 0
    for v in (0.1, 2.0, 0.0):
        si.note_lateness(91, v)
    assert _m_lateness.child(process="91").count == n0 + 3
    assert 'hvd_tail_lateness_seconds_count{process="91"}' in \
        metrics.render_prometheus()


def test_engine_stats_carry_the_scores():
    hvd.init(device="cpu")
    try:
        st = hvd.runtime._state()
        st.stall_inspector.note_lateness(0, 0.0)
        hvd.allreduce(torch.ones(2), name="s")
        stats = st.engine.stats()
        assert stats["stall"]["straggler_scores"] == {0: 0.0}
        assert stats["stall"]["warnings_issued"] == 0
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    return tr.launch(2, ["tools"], tmp_path_factory.mktemp("tools"))


def test_late_rank_named_and_scored(tools):
    r0, r1 = (res["tools"] for res in tools)
    assert any("for ranks [1]" in m and "'late'" in m for m in r0["log"])
    assert not any("for ranks" in m for m in r1["log"])
    for r in (r0, r1):
        assert r["late"].tolist() == [2.0, 2.0]
    # rank 1 arrived about 1.5 s after rank 0 first reported it missing
    assert r0["stall"]["straggler_scores"][1] > 0.5 * 1.0 * EWMA_ALPHA


# ---------------------------------------------------------------------------
# the straggler bridge to the elastic driver
# ---------------------------------------------------------------------------

class _StubProc:
    class _Popen:
        def poll(self):
            return None

        def terminate(self):
            pass

    def __init__(self):
        self.popen = self._Popen()


class _NoSpawnDriver(ElasticDriver):
    def _launch(self, slot, coord_addr, coord_port, env):
        return _StubProc()

    def _notify_workers(self, targets, update_res):
        pass


def test_registry_soft_failures_feed_blacklist():
    reg = registration.WorkerStateRegistry(blacklist_threshold=2)
    reg.record_soft_failure("hostA")
    assert reg.failure_count("hostA") == 1
    assert reg.soft_failure_count("hostA") == 1
    assert not reg.is_blacklisted("hostA")
    reg.record_result(3, registration.FAILURE, "hostA")
    assert reg.is_blacklisted("hostA")


def test_straggler_reports_blacklist_before_a_crash():
    d = _NoSpawnDriver(
        discovery.FixedHostDiscovery({"hostA": 1}), ["true"],
        min_np=1, port=free_port(), blacklist_threshold=2,
        straggler_blacklist_score=0.5)
    try:
        d._apply_hosts({"hostA": 1}, HostUpdateResult.ADDED)
        r = d._handle_straggler({"worker_id": 0, "process": 0, "score": 0.9})
        assert r["ok"] and r["counted"] and not r["blacklisted"]
        assert d.registry.failure_count("hostA") == 1
        for score in (2.0, 0.2):     # debounced in the epoch; below bar
            r = d._handle_straggler({"worker_id": 0, "process": 0,
                                     "score": score})
            assert r["ok"] and not r["counted"]
        r = d._handle_straggler({"worker_id": 0, "process": 9, "score": 2.0})
        assert not r["ok"]
        d._apply_hosts({"hostA": 1}, HostUpdateResult.MIXED)
        r = d._handle_straggler({"worker_id": 0, "process": 0, "score": 1.1})
        assert r["counted"] and r["blacklisted"]
        assert d.registry.is_blacklisted("hostA")
        assert d.registry.soft_failure_count("hostA") == 2
        assert d._discover() == {}
        assert len([e for e, _ in d._events
                    if e == "straggler_reported"]) == 2
    finally:
        d._server.close()


def test_straggler_reports_ignored_when_bar_disabled():
    d = _NoSpawnDriver(
        discovery.FixedHostDiscovery({"hostA": 1}), ["true"],
        min_np=1, port=free_port(), blacklist_threshold=1,
        straggler_blacklist_score=0.0)
    try:
        d._apply_hosts({"hostA": 1}, HostUpdateResult.ADDED)
        r = d._handle_straggler({"worker_id": 0, "process": 0,
                                 "score": 99.0})
        assert r["ok"] and not r["counted"]
        assert d.registry.failure_count("hostA") == 0
    finally:
        d._server.close()


def test_inspector_reports_a_straggler_to_the_driver(monkeypatch):
    """hvd.init() wires the inspector's on_straggler to the worker's
    report_straggler: a rank whose score crosses
    HOROVOD_TAIL_BLACKLIST_SCORE reaches the driver as a soft failure of
    its host, which the threshold of 1 blacklists."""
    from horovod_tpu_torch.runner import secret
    port = free_port()
    # the driver keeps a job secret it finds: this one goes with the test
    monkeypatch.setenv(secret.SECRET_ENV, secret.make_secret_key())
    d = _NoSpawnDriver(
        discovery.FixedHostDiscovery({"hostA": 2}), ["true"],
        min_np=1, port=port, blacklist_threshold=1,
        straggler_blacklist_score=0.5)
    try:
        d._apply_hosts({"hostA": 2}, HostUpdateResult.ADDED)
        monkeypatch.setenv("HOROVOD_ELASTIC_DRIVER_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_ELASTIC_DRIVER_PORT", str(port))
        monkeypatch.setenv("HOROVOD_ELASTIC_WORKER_ID", "0")
        monkeypatch.setenv("HOROVOD_TAIL_BLACKLIST_SCORE", "0.5")
        hvd.init(device="cpu")
        try:
            insp = hvd.runtime._state().stall_inspector
            for _ in range(8):
                insp.note_lateness(1, 3.0)
        finally:
            hvd.shutdown()
        assert d.registry.soft_failure_count("hostA") == 1
        assert d.registry.is_blacklisted("hostA")
        assert [e for e, _ in d._events].count("straggler_reported") == 1
    finally:
        d._server.close()
