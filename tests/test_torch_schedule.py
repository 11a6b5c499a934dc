"""The port's collective schedules against the JAX package's 11 pinned
snapshots (``tests/schedules/*.json``, read and never written).

One spawned world of gloo ranks on the CPU per world size (2, 4 and 8
ranks) records every builtin entry of
``horovod_tpu_torch.analysis.schedule`` at ``workers`` 2 and 4 (the 2-D
entries at 2×2 and 4×2), plus a toy step with a rank-conditional
collective:

* each entry's recorded schedule at ``workers`` 2 is what its snapshot
  implies under the module's comparison rules (HVD211), each rule held
  on a synthetic snapshot too;
* each entry's canonical schedule is the same at both sizes (HVD210),
  and every rank of one world records the same full schedule; the toy
  step's rank-conditional collective is an HVD210 naming the rank;
* each deliberate difference's entry pins the port's own record list;
* ``--update`` refuses ``tests/schedules/``; the recorder, disarmed,
  records nothing and nests no recording.
"""

import dataclasses
import os

import pytest

from horovod_tpu_torch.analysis import recorder
from horovod_tpu_torch.analysis import schedule as sched

ENTRIES = sorted(sched.BUILTIN_ENTRIES)


@pytest.fixture(scope="module")
def recorded():
    """``{(entry, n): [each rank's Schedule]}``: three worlds (2, 4, 8)."""
    return sched.record_worlds(ENTRIES + ["rank_conditional"],
                               sizes=(2, 4), timeout=420)


def test_eleven_entries_each_with_a_pinned_snapshot():
    assert len(ENTRIES) == 11
    assert sorted(f[:-5] for f in os.listdir(sched.snapshot_dir())) == ENTRIES
    assert sched.worlds_for(ENTRIES, (2, 4)) == [2, 4, 8]


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_matches_its_pinned_snapshot(recorded, name):
    assert sched.check_snapshot(name, recorded[(name, 2)][0]) == []


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_is_consistent_across_sizes_and_ranks(recorded, name):
    """HVD210: the canonical schedule at workers 2 and 4 alike, and each
    world's ranks identical, shapes included."""
    assert sched.check_builtin_consistency(recorded, [name]) == []
    for n in (2, 4):
        ranks = recorded[(name, n)]
        assert len(ranks) == sched._lookup(name).world(n)
        assert all(r.to_json() == ranks[0].to_json() for r in ranks)


def test_a_rank_conditional_collective_is_hvd210_naming_the_rank(recorded):
    ranks = recorded[("rank_conditional", 2)]
    assert [r.records[0].prim for r in ranks] == ["pmin", "pmax"]
    found = sched.check_ranks("rank_conditional", 2, ranks)
    assert [f.code for f in found] == ["HVD210"]
    assert "rank 1" in found[0].message and "pmax" in found[0].message
    four = sched.check_ranks("rank_conditional", 4,
                             recorded[("rank_conditional", 4)])
    assert [f.message.split()[1] for f in four] == ["1"]


def test_gradient_plane_records_carry_bucket_ids_in_plan_order(recorded):
    recs = recorded[("distopt_step", 2)][0].records
    assert [(r.prim, r.axes, r.bucket) for r in recs] == [
        ("psum", ["workers"], 0), ("psum", ["workers"], 1),
        ("psum", ["workers"], 2)]
    # the overlapped step: each layer's two buckets, reverse layer order
    # (identical records), then the root leaves' bucket
    ov = recorded[("overlapped_distopt_step", 2)][0].records
    assert [(r.inputs[0], r.bucket) for r in ov] == (
        [("bfloat16[8]", 0), ("float32[72]", 1)] * 3 + [("float32[48]", 0)])
    assert recorded[("serve_forward_step", 4)][0].records == []


# -- the deliberate differences, each pinned ---------------------------------------

def _compact(schedule):
    return [(r.prim, "+".join(r.axes), r.inputs[0], r.outputs[0], r.bucket,
             {k: v for k, v in r.params.items() if k != "axis_index_groups"})
            for r in schedule.records]


_RS = {"axis_size": 2, "scatter_dimension": 0, "tiled": True}
_AG0 = {"all_gather_dimension": 0, "axis_size": 2, "tiled": True}
_AG1 = {"all_gather_dimension": 1, "axis_size": 2, "tiled": True}


def test_tail_stages_in_the_ports_form(recorded):
    """One agreement (pmin) over the whole set where JAX issues one per
    axis; the DCN gather tiled over a flat chunk where JAX stacks rows."""
    want = []
    for b, (dt, full) in enumerate((("bfloat16", 260), ("float32", 144),
                                    ("float32", 256))):
        half = f"{dt}[{full // 2}]"
        want += [("reduce_scatter", "hvd_local", f"{dt}[{full}]", half, b,
                  _RS),
                 ("pmin", "workers+hvd_local", "float32[2]", "float32[2]", b,
                  {}),
                 ("all_gather", "workers", half, f"{dt}[{full}]", b, _AG0),
                 ("all_gather", "hvd_local", half, f"{dt}[{full}]", b, _AG0)]
    assert _compact(recorded[("tail_distopt_step", 2)][0]) == want


def test_health_sentinel_gather_in_the_ports_form(recorded):
    """The sentinel's [2, 4] checksums travel flat: a tiled gather of 8
    floats, where JAX gathers the stacked rows untiled."""
    assert _compact(recorded[("health_distopt_step", 2)][0]) == [
        ("psum", "workers", "bfloat16[260]", "bfloat16[260]", 0, {}),
        ("psum", "workers", "float32[144]", "float32[144]", 1, {}),
        ("psum", "workers", "float32[256]", "float32[256]", 2, {}),
        ("all_gather", "workers", "float32[8]", "float32[16]", None, _AG0)]


def test_mesh_sliced_serving_in_the_ports_form(recorded):
    """The leader's three broadcasts, then the shards leaf by leaf in the
    port's tree order (embed, final_norm, each layer's nine)."""
    def ag(i, o, p=_AG0):
        return ("all_gather", "hvd_serve_mp", f"float32[{i}]",
                f"float32[{o}]", None, p)

    def bc(a):
        return ("pbroadcast", "hvd_serve_mp", a, a, None, {"source": 0})

    layer = [ag("32x64", "64x64"), ag("32x32", "64x32"),
             ag("32x32", "64x32"), ag("32x64", "64x64"), ag("32", "64"),
             ag("64x64", "64x128", _AG1), ag("64x64", "64x128", _AG1),
             ag("64x64", "128x64"), ag("32", "64")]
    assert _compact(recorded[("serve_mp_forward_step", 2)][0]) == (
        [bc("int64[3]"), bc("int64[2x16]"), bc("int64[2]"),
         ag("32x64", "64x64"), ag("32", "64")] + layer * 2)


# -- the comparison rules on synthetic snapshots ----------------------------------

def _rec(i, prim="psum", path="", bucket=0, shape="float32[4]", **params):
    return sched.CollectiveRecord(index=i, prim=prim, axes=["workers"],
                                  inputs=[shape], outputs=[shape], path=path,
                                  bucket=bucket, params=params)


def test_rules_erase_paths_unroll_scans_and_select_branches():
    snap = sched.Schedule("toy", [("workers", 2)], [
        _rec(0, path="pjit<inner>"),
        _rec(1, path="pjit<f>/scan:jaxpr", bucket=0),
        _rec(2, path="pjit<f>/scan:jaxpr", bucket=1),
        _rec(3, path="cond:branches[1]", prim="all_gather", bucket=None),
        _rec(4, path="cond:branches[0]", prim="pmax", bucket=None),
        _rec(5, bucket=0)])
    entry = dataclasses.replace(sched.BUILTIN_ENTRIES["distopt_step"],
                                name="toy", layers=3,
                                taken=("cond:branches[1]",))
    got = sched.expected_records(entry, snap)
    assert [r.index for r in got] == list(range(9))
    assert {r.path for r in got} == {""}
    assert [(r.prim, r.bucket) for r in got] == (
        [("psum", 0)] + [("psum", 0), ("psum", 1)] * 3
        + [("all_gather", None), ("psum", 0)])
    untaken = dataclasses.replace(entry, taken=())
    assert "all_gather" not in [r.prim for r in
                                sched.expected_records(untaken, snap)]


def test_a_drifted_schedule_is_hvd211(recorded):
    got = recorded[("fused_reduce", 2)][0]
    assert sched.check_snapshot("fused_reduce", got) == []
    for drift in (got.records[:-1], got.records[::-1],
                  [dataclasses.replace(got.records[0], bucket=7)]
                  + got.records[1:]):
        found = sched.check_snapshot(
            "fused_reduce", sched.Schedule("fused_reduce", got.axis_env,
                                           list(drift)))
        assert [f.code for f in found] == ["HVD211"]
    # jit_fused_reduce's snapshot carries a jaxpr path; rule 1 erases it
    assert {r.path for r in sched.load_snapshot(
        "jit_fused_reduce").records} == {"pjit<inner>"}


def test_update_refuses_the_pinned_snapshots(tmp_path):
    with pytest.raises(SystemExit) as exc:
        sched.main(["--update", sched.snapshot_dir()])
    assert exc.value.code == 2
    assert sched._refuses(os.path.join(sched.snapshot_dir(), "sub"))
    assert not sched._refuses(str(tmp_path))


def test_the_recorder_disarmed_and_nested():
    assert recorder.ARMED is False
    with recorder.recording() as rec:
        assert recorder.ARMED
        with pytest.raises(RuntimeError):
            with recorder.recording():
                pass
    assert recorder.ARMED is False and rec.records == []


def test_disarmed_collectives_do_not_reach_the_recorder(monkeypatch):
    """A world of one: the flat collectives run with the recorder
    disarmed and never call it; armed, they record in plan order."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim.distributed import fused_reduce_tree
    hvd.init(device="cpu")
    try:
        def boom(*a, **k):
            raise AssertionError("the recorder was called disarmed")
        monkeypatch.setattr(recorder, "note", boom)
        fused_reduce_tree(sched._grads(), threshold_bytes=1024)
        monkeypatch.undo()
        with recorder.recording() as rec:
            fused_reduce_tree(sched._grads(), threshold_bytes=1024)
    finally:
        hvd.shutdown()
    assert [(r["prim"], r["inputs"], r["bucket"]) for r in rec.records] == [
        ("psum", ["bfloat16[260]"], 0), ("psum", ["float32[144]"], 1),
        ("psum", ["float32[256]"], 2)]
