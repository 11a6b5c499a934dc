"""The port's timeline (``timeline.py``) against the JAX package's.

The JAX package's ``tests/test_timeline.py`` cases replayed on the port's
copy, each event stream also driven through the JAX writer (without its
native core): the two files must hold the same events, timestamps aside.
Then the engine's hooks: under ``HOROVOD_TIMELINE`` (and
``HOROVOD_TIMELINE_MARK_CYCLES``) at world 1 every tensor opens a
NEGOTIATE span at submission, a QUEUED span when its cycle agrees on it,
``MEMCPY_IN_FUSION_BUFFER`` and the op's activity (with the bucket's
wire format, tail policy and path as args) and a DONE mark, and
``hvd.stop_timeline()``/``start_timeline()`` lose no event; at world 2
(``tests/torch_ranks.py`` ``case_tools``) each rank writes its own.
"""

import json

import pytest
import torch

from horovod_tpu import timeline as jtl
import horovod_tpu_torch as hvd
from horovod_tpu_torch import timeline as ttl
from horovod_tpu_torch.timeline import Timeline

import torch_ranks as tr


def _read(path):
    with open(path) as f:
        return json.load(f)


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _drive(tl):
    for i in range(5):
        tl.negotiate_start(f"a{i}", "allreduce")
        tl.negotiate_end(f"a{i}")
    tl.cycle_mark(1)
    tl.activity_start(["a0", "a1"], "MEMCPY_IN_FUSION_BUFFER")
    tl.activity_transition(["a0", "a1"], "ALLREDUCE",
                           args={"wire_format": "int8"})
    tl.activity_end(["a0", "a1"])
    tl.end("a0")
    tl.close()


def test_same_events_as_jax(tmp_path):
    j = jtl.Timeline(str(tmp_path / "j.json"), mark_cycles=True,
                     use_native=False)
    t = Timeline(str(tmp_path / "t.json"), mark_cycles=True)
    _drive(j)
    _drive(t)
    assert _strip(_read(tmp_path / "t.json")) == \
        _strip(_read(tmp_path / "j.json"))


def test_timeline_close_reopen_cycle_no_drops(tmp_path):
    p1, p2 = tmp_path / "t1.json", tmp_path / "t2.json"
    tl = Timeline(str(p1))
    assert tl.enabled
    for i in range(50):
        tl.negotiate_start(f"a{i}", "allreduce")
        tl.negotiate_end(f"a{i}")
    tl.close()
    assert not tl.enabled
    tl.reopen(str(p2))
    assert tl.enabled
    for i in range(30):
        tl.negotiate_start(f"b{i}", "allgather")
        tl.negotiate_end(f"b{i}")
    tl.close()
    ev1, ev2 = _read(p1), _read(p2)
    assert [e["args"]["name"] for e in ev1 if e.get("ph") == "M"] == \
        [f"a{i}" for i in range(50)]
    assert sum(1 for e in ev1
               if e.get("name", "").startswith("NEGOTIATE_")) == 50
    names2 = [e["args"]["name"] for e in ev2 if e.get("ph") == "M"]
    assert names2 == [f"b{i}" for i in range(30)]
    assert sum(1 for e in ev2
               if e.get("name") == "NEGOTIATE_ALLGATHER") == 30


def test_timeline_has_no_stop_flag(tmp_path):
    tl = Timeline(str(tmp_path / "t.json"))
    assert not hasattr(tl, "_stop")
    tl.close()


def test_timeline_events_after_close_are_dropped_silently(tmp_path):
    p = tmp_path / "t.json"
    tl = Timeline(str(p))
    tl.negotiate_start("x", "broadcast")
    tl.close()
    tl.negotiate_end("x")
    tl.end("x")
    assert any(e.get("name") == "NEGOTIATE_BROADCAST" for e in _read(p))


def test_timeline_reopen_resets_tensor_tids(tmp_path):
    p1, p2 = tmp_path / "t1.json", tmp_path / "t2.json"
    tl = Timeline(str(p1))
    tl.negotiate_start("x", "allreduce")
    tl.negotiate_start("y", "allreduce")
    assert tl._tensor_tids == {"x": 1, "y": 2}
    tl.close()
    tl.reopen(str(p2))
    assert tl._tensor_tids == {}
    tl.negotiate_start("y", "allreduce")
    tl.close()
    ev2 = _read(p2)
    assert [(e["tid"], e["args"]["name"]) for e in ev2
            if e.get("ph") == "M"] == [(1, "y")]
    spans = [e for e in ev2 if e.get("name", "").startswith("NEGOTIATE_")]
    assert spans and all(e["tid"] == 1 for e in spans)


def test_timeline_tid_table_bounded_with_overflow_lane(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(ttl, "MAX_TENSOR_TIDS", 3)
    p = tmp_path / "t.json"
    tl = Timeline(str(p))
    for i in range(6):
        tl.negotiate_start(f"t{i}", "allreduce")
    assert len(tl._tensor_tids) == 3
    assert tl._tid("t5") == 0 and tl._tid("t0") == 1
    tl.close()
    metas = [(e["tid"], e["args"]["name"]) for e in _read(p)
             if e.get("ph") == "M"]
    assert metas.count((0, "overflow")) == 1 and len(metas) == 4


def test_timeline_activity_events_carry_bucket_args(tmp_path):
    p = tmp_path / "t.json"
    tl = Timeline(str(p))
    tl.negotiate_start("g", "allreduce")
    tl.negotiate_end("g")
    tl.activity_start(["g"], "MEMCPY_IN_FUSION_BUFFER")
    tl.activity_transition(["g"], "ALLREDUCE",
                           args={"wire_format": "int8",
                                 "tail_policy": "bounded"})
    tl.activity_end(["g"])
    tl.close()
    ev = _read(p)
    (op,) = [e for e in ev if e.get("name") == "ALLREDUCE"]
    assert op["args"] == {"wire_format": "int8", "tail_policy": "bounded"}
    (mem,) = [e for e in ev if e.get("name") == "MEMCPY_IN_FUSION_BUFFER"]
    assert "args" not in mem


# ---------------------------------------------------------------------------
# the engine's hooks
# ---------------------------------------------------------------------------

def _spans(events):
    """{tensor lane name: [event names on its lane]}."""
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M"}
    out = {}
    for e in events:
        if e.get("ph") != "M" and e["tid"] in lanes:
            out.setdefault(lanes[e["tid"]], []).append(e["name"])
    return out


#: one tensor's lane: B/E pairs (QUEUED's end event carries its name, as
#: in the JAX writer), then the DONE mark
LIFECYCLE = ["NEGOTIATE_ALLREDUCE", "", "QUEUED", "QUEUED",
             "MEMCPY_IN_FUSION_BUFFER", "", "ALLREDUCE", "", "DONE"]


def test_engine_writes_each_tensors_lifecycle(monkeypatch, tmp_path):
    p1, p2 = tmp_path / "t1.json", tmp_path / "t2.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(p1))
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    hvd.init(device="cpu")
    try:
        for h in hvd.api._allreduce_each_async_(
                [torch.ones(4), torch.ones(2)], ["g.a", "g.b"], op=hvd.Sum):
            h.synchronize()
        hvd.allgather(torch.ones(2, 2), name="ag")
        hvd.stop_timeline()
        hvd.start_timeline(str(p2), mark_cycles=False)
        hvd.allreduce(torch.ones(3), name="after")
    finally:
        hvd.shutdown()
    ev = _read(p1)
    lanes = _spans(ev)
    assert lanes["g.a"] == LIFECYCLE and lanes["g.b"] == LIFECYCLE
    assert lanes["ag"][0] == "NEGOTIATE_ALLGATHER"
    assert "ALLGATHER" in lanes["ag"] and lanes["ag"][-1] == "DONE"
    (op,) = [e for e in ev if e["name"] == "ALLREDUCE" and e["tid"] == 1]
    assert op["args"] == {"wire_format": "none", "tail_policy": "strict",
                          "hierarchical": False}
    assert any(e["name"] == "CYCLE_START" for e in ev)
    ev2 = _read(p2)
    assert _spans(ev2)["after"] == LIFECYCLE
    assert not any(e["name"] == "CYCLE_START" for e in ev2)


#: the JAX engine's and controller's metric families the port records
ENGINE_FAMILIES = (
    "hvd_engine_cycles_total", "hvd_cycle_duration_seconds",
    "hvd_engine_tensors_total", "hvd_engine_bytes_reduced_total",
    "hvd_dispatch_tensors", "hvd_dispatch_bytes",
    "hvd_fusion_utilization_ratio", "hvd_response_cache_total",
    "hvd_wire_bytes_total", "hvd_wire_compression_ratio",
    "hvd_negotiation_rounds_total", "hvd_negotiation_duration_seconds",
    "hvd_kv_ops_total", "hvd_tail_rounds_total", "hvd_stall_warnings_total",
    "hvd_straggler_score", "hvd_tail_lateness_seconds")


def test_engine_metric_families_match_jax():
    """The engine's and controller's families carry the JAX package's
    names, types, labels and bucket edges, and an allreduce at world 1
    records into the engine's."""
    import horovod_tpu.ops.engine  # noqa: F401 - registers the families
    import horovod_tpu.ops.controller  # noqa: F401
    import horovod_tpu.stall  # noqa: F401
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu_torch import metrics as tmetrics
    from horovod_tpu_torch import stall  # noqa: F401
    jfam = {f.name: f for f in jmetrics.registry().families()}
    tfam = {f.name: f for f in tmetrics.registry().families()}
    for name in ENGINE_FAMILIES:
        j, t = jfam[name], tfam[name]
        assert (t.kind, tuple(t.label_names)) == \
            (j.kind, tuple(j.label_names)), name
        assert getattr(t, "edges", None) == getattr(j, "edges", None), name
    hvd.init(device="cpu")
    try:
        hvd.allreduce(torch.ones(4), name="m")
        fams = hvd.runtime._state().engine.stats()["metrics"]["families"]
    finally:
        hvd.shutdown()
    for name in ("hvd_engine_cycles_total", "hvd_dispatch_bytes",
                 "hvd_wire_bytes_total", "hvd_response_cache_total"):
        assert fams[name]["series"], name


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    return tr.launch(2, ["tools"], tmp_path_factory.mktemp("tools"))


def test_each_rank_writes_its_timeline(tools):
    for res in tools:
        ev = res["tools"]["events"]
        lanes = _spans(ev)
        for name in ("tune0", "tune1", "late"):
            assert lanes[name][:len(LIFECYCLE)] == LIFECYCLE, name
        assert sum(1 for e in ev if e["name"] == "CYCLE_START") >= 11
