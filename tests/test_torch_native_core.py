"""The port's native control-plane core (``horovod_tpu_torch/native/``)
against its pure-Python planner, decision, writer and tracker and against
the JAX package's native core, on the same inputs; exact equality
throughout.

* The fusion planner on ``_helpers.random_entry_sigs`` streams (20
  seeds, with layer, wire-format, tail-policy and spec keys drawn too) at
  thresholds from 1 B to 64 MiB; the group-atomic case; each dtype's
  width against ``ops/fusion.py``'s ``_DTYPE_BYTES``.
* ``plan_dispatch_sigs`` against ``plan_dispatch``.
* ``negotiate_decide`` against the controller's Python arithmetic and
  the JAX core on seeded token multisets at worlds 2, 4 and 8.
* ``ResponseCache`` (LRU order, capacity 0, ``stats()``),
  ``TimelineWriter`` (a whole Chrome trace; a write after close is a
  no-op; ``Timeline``'s close and reopen), ``StallTracker`` (warns once,
  then clears) and the ``StallInspector`` over it.
* The knobs: ``HOROVOD_TPU_NATIVE_CORE=0`` runs the Python objects; a
  failing compiler or ``HOROVOD_TPU_NATIVE_BUILD=0`` with nothing built
  makes ``hvd.init()`` raise, naming the knob; two processes racing a
  cold build load one artifact.
* A gloo world of 2 (``tests/torch_ranks.py`` ``native_core``): eager
  collectives give the same results with the core on and off, and every
  plan the engine made is the Python planner's and the same on both
  ranks.
"""

import dataclasses
import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_ranks
from _helpers import random_entry_sigs
from horovod_tpu.native import loader as jloader
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch.native import build, loader
from horovod_tpu_torch.ops import controller as tctl
from horovod_tpu_torch.ops import fusion as tfusion

core = loader.load()
jcore = jloader.load()
ROOT = torch_ranks.ROOT

THRESHOLDS = (1, 1024, 64 * 1024, 64 * 1024 * 1024)


def _sig_streams(seed):
    """(JAX sigs, port sigs) of one seeded stream, with the layer,
    wire-format, tail-policy and spec keys drawn as well."""
    rng = random.Random(seed)
    jsigs = [dataclasses.replace(
        s, layer=rng.choice([-1, -1, 0, 1, 2]),
        wire_format=rng.choice(["none", "none", "int8"]),
        tail_policy=rng.choice(["strict", "strict", "bounded"]),
        spec=rng.choice(["replicated", "replicated", "1:tp"]))
        for s in random_entry_sigs(rng, rng.randint(0, 40))]
    return jsigs, [tfusion.EntrySig(**dataclasses.asdict(s)) for s in jsigs]


@pytest.mark.parametrize("seed", range(20))
def test_plan_matches_python_and_jax(seed):
    jsigs, tsigs = _sig_streams(seed)
    for threshold in THRESHOLDS:
        want = tfusion.plan_fusion(tsigs, threshold)
        assert core.plan_fusion_sigs(tsigs, threshold) == want
        assert jfusion.plan_fusion(jsigs, threshold) == want
        assert jcore.plan_fusion_sigs(jsigs, threshold) == want


def _sigs(names, **kw):
    fields = dict(op_type="allreduce", reduce_op="average", dtype="float32",
                  shape=(1024,), process_set_id=0, stacked=False)
    fields.update(kw)
    return [tfusion.EntrySig(name=n, **fields) for n in names]


def test_group_fuses_whole_past_the_threshold():
    grouped = _sigs([f"g{i}" for i in range(4)], group_id=7)
    solo = _sigs(["a", "z"])
    sigs = solo[:1] + grouped + solo[1:]
    want = tfusion.plan_fusion(sigs, 1)
    assert want == [[1, 2, 3, 4], [0], [5]]
    assert core.plan_fusion_sigs(sigs, 1) == want
    assert core.plan_fusion_sigs([], 1024) == []


@pytest.mark.parametrize("seed", range(8))
def test_plan_dispatch_matches_python(seed):
    _, sigs = _sig_streams(100 + seed)
    buckets = tfusion.plan_fusion(sigs, 64 * 1024)
    want = tfusion.plan_dispatch(sigs, buckets)
    assert core.plan_dispatch_sigs(sigs, buckets) == (want.order,
                                                      want.layers)
    if len(sigs) > 1 and sigs[0].layer != sigs[1].layer:
        with pytest.raises(ValueError, match="spans layers"):
            tfusion.plan_dispatch(sigs, [[0, 1]])
        with pytest.raises(ValueError, match="spans layers"):
            core.plan_dispatch_sigs(sigs, [[0, 1]])


@pytest.mark.parametrize("dtype", sorted(tfusion._DTYPE_BYTES))
def test_dtype_widths_are_the_planners(dtype):
    """Two 16-element tensors fuse exactly when the threshold holds both
    at the dtype's width in ``_DTYPE_BYTES``."""
    width = tfusion._DTYPE_BYTES[dtype]
    sigs = _sigs(["a", "b"], dtype=dtype, shape=(16,))
    for threshold, want in ((32 * width, [[0, 1]]),
                            (32 * width - 1, [[0], [1]])):
        assert tfusion.plan_fusion(sigs, threshold) == want
        assert core.plan_fusion_sigs(sigs, threshold) == want


def test_unknown_dtype_raises_in_both():
    sigs = _sigs(["a"], dtype="float4_e2m1")
    with pytest.raises(ValueError, match="unknown dtype"):
        tfusion.plan_fusion(sigs, 1024)
    with pytest.raises(ValueError, match="unknown dtype"):
        core.plan_fusion_sigs(sigs, 1024)


def _token(names):
    return json.dumps({"s": [[n, "allreduce", "sum", "float32", [4], 0,
                              False, -1 if len(names) == 1 else 0, None,
                              None, "none", "strict", "replicated"]
                             for n in names], "r": 0, "sp": None},
                      separators=(",", ":"), sort_keys=True)


def _multisets(world, seed):
    """Each process's announced tokens, and the active processes (the
    rest joined): seeded draws with repeats and grouped tokens."""
    rng = random.Random(seed)
    pool = [_token([f"t{i}"]) for i in range(8)]
    pool += [_token([f"g{i}.0", f"g{i}.1"]) for i in range(2)]
    full = {q: [rng.choice(pool) for _ in range(rng.randint(0, 10))]
            for q in range(world)}
    active = sorted(rng.sample(range(world), rng.randint(1, world)))
    return full, active


@pytest.mark.parametrize("world", [2, 4, 8])
def test_negotiate_decide_matches_python_and_jax(world):
    from collections import Counter
    py, nat = tctl.Controller(), tctl.Controller(core=core)
    for seed in range(25):
        full, active = _multisets(world, 1000 * world + seed)
        counters = {q: Counter(full[q]) for q in full}
        tokens = sorted(set().union(*map(set, counters.values())))
        want = py._decide_counts(full, active, counters, tokens)
        assert nat._decide_counts(full, active, counters, tokens) == want
        assert core.negotiate_decide(full, active) == \
            jcore.negotiate_decide(full, active)


def test_response_cache_lru_zero_capacity_and_stats():
    a, b, d = _sigs(["a"]), _sigs(["b"]), _sigs(["d"])
    for cache in (core.ResponseCache(2), tfusion.ResponseCache(2)):
        cache.put(a, [[0]])
        cache.put(b, [[0]])
        assert cache.get(a) == [[0]]     # a is now the most recent
        cache.put(d, [[0]])              # evicts b
        assert cache.get(b) is None
        assert cache.get(a) == [[0]] and cache.get(d) == [[0]]
        assert cache.stats() == {"hits": 3, "misses": 1, "entries": 2}
        assert cache.get(_sigs(["a"], dtype="bfloat16")) is None
        cache.clear()
        assert cache.stats()["entries"] == 0
    for cache in (core.ResponseCache(0), tfusion.ResponseCache(0)):
        cache.put(a, [[0]])
        assert cache.get(a) is None
        assert cache.stats() == {"hits": 0, "misses": 0, "entries": 0}
    # the engine's planner: the same (plan, cache) pair either way
    cfg = type("Cfg", (), {"cache_capacity": 3})()
    plan_fn, cache = tfusion.get_planner(cfg, core)
    assert plan_fn is core.plan_fusion_sigs
    assert type(cache) is core.ResponseCache
    assert tfusion.get_planner(cfg)[0] is tfusion.plan_fusion


def test_timeline_writer_chrome_trace_and_write_after_close(tmp_path):
    path = tmp_path / "w.json"
    w = core.TimelineWriter(str(path))
    for i in range(100):
        w.write(json.dumps({"name": f"ev{i}", "ph": "B", "ts": i}))
    w.close()
    w.write("{}")   # a no-op
    w.close()       # idempotent
    events = json.loads(path.read_text())
    assert [e["name"] for e in events] == [f"ev{i}" for i in range(100)]


def test_timeline_on_the_core_closes_whole_and_reopens(tmp_path):
    from horovod_tpu_torch.timeline import Timeline
    files = [tmp_path / "a.json", tmp_path / "b.json"]
    tl = Timeline(str(files[0]), mark_cycles=True, core=core)
    assert tl._native is not None and tl._file is None
    for f in files:
        # many events still queued at close: the file must end whole
        for i in range(2000):
            tl.negotiate_start(f"g.{i}", "allreduce")
            tl.negotiate_end(f"g.{i}")
        tl.cycle_mark(1)
        if f is files[0]:
            tl.reopen(str(files[1]), mark_cycles=True)
    tl.close()
    assert tl._native is None
    for f in files:
        events = json.loads(f.read_text())
        names = [e["name"] for e in events]
        assert names.count("NEGOTIATE_ALLREDUCE") == 2000
        assert names.count("QUEUED") == 2000 and "CYCLE_START" in names


def test_stall_tracker_warns_once_then_clears():
    t = core.StallTracker(check_time=10.0, shutdown_time=0.0)
    t.record_enqueue("x", 100.0)
    t.record_enqueue("y", 105.0)
    stalled, shut = t.check(111.0)
    assert [n for n, _ in stalled] == ["x"] and shut is None
    assert t.check(112.0) == ([], None)          # warned once
    stalled, _ = t.check(116.0)
    assert [n for n, _ in stalled] == ["y"]
    assert t.pending_since("y") == 105.0 and t.pending_since("z") is None
    t.record_complete("x")
    assert t.pending_count() == 1 and t.pending_since("x") is None
    t.record_enqueue("x", 200.0)                  # a new stall warns again
    assert [n for n, _ in t.check(211.0)[0]] == ["x"]


def test_stall_inspector_on_the_core_warns_as_python(caplog):
    import logging

    from horovod_tpu_torch.stall import StallInspector

    def run(si):
        si.record_enqueue("slow", 0.0)
        si.record_missing("slow", [3], now=0.5)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
            si.check(now=0.9)
            si.check(now=1.5)
            si.check(now=2.5)
        text = caplog.text
        si.record_complete("slow", now=3.0)
        si.record_enqueue("slow", 4.0)
        si.check(now=5.5)
        return (si.warnings_issued, "missing on ranks [3]" in text,
                si.overdue("slow", 1.0, now=5.5), si.straggler_scores())

    native = StallInspector(check_time=1.0, core=core)
    assert native._native is not None
    assert run(native) == run(StallInspector(check_time=1.0)) == \
        (2, True, True, {3: pytest.approx(0.25 * 2.5)})
    # one table: the tracker's; the inspector's own stay empty
    assert native._pending == {} and native._warned == {}
    assert native._native.pending_count() == 1
    native.record_complete("slow", now=6.0)
    assert not native.overdue("slow", 1.0, now=9.0)
    assert StallInspector(check_time=1.0, disabled=True,
                          core=core)._native is None


def test_native_core_off_runs_the_python_objects(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import ResponseCache, plan_fusion

    def objects():
        hvd.init(device="cpu")
        try:
            eng = hvd.runtime._state().engine
            return (eng._plan_fn, type(eng._cache), eng._controller._core,
                    eng.timeline._core, eng.stall._native is not None)
        finally:
            hvd.shutdown()

    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "60")
    assert objects() == (core.plan_fusion_sigs, core.ResponseCache, core,
                         core, True)
    monkeypatch.setenv("HOROVOD_TPU_NATIVE_CORE", "0")
    assert objects() == (plan_fusion, ResponseCache, None, None, False)


def _init_in_a_process(build_dir, env):
    """``hvd.init(device="cpu")`` in a fresh process with the native
    build directory at ``build_dir``; returns (exit code, output)."""
    code = textwrap.dedent(f"""
        import pathlib, sys
        import torch.distributed as dist
        from horovod_tpu_torch.native import build
        build.BUILD_DIR = pathlib.Path({str(build_dir)!r})
        import horovod_tpu_torch as hvd
        try:
            hvd.init(device="cpu")
        except RuntimeError as exc:
            print("RAISED", type(exc).__name__, exc)
            print("GROUP", dist.is_initialized())
            sys.exit(3)
        print("INIT", hvd.runtime._state().engine._controller._core)
        hvd.shutdown()
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT), **env},
                         capture_output=True, text=True, timeout=120)
    return res.returncode, res.stdout + res.stderr


def test_failed_build_raises_at_init_naming_the_knob(tmp_path):
    rc, out = _init_in_a_process(tmp_path / "b", {"CXX": "false"})
    assert rc == 3, out
    assert "RAISED NativeCoreError" in out and "GROUP False" in out
    assert "HOROVOD_TPU_NATIVE_CORE=0" in out
    assert "failed to build core.cpp" in out
    # no artifact, not even a partial one
    assert not list((tmp_path / "b").rglob("_hvd_core*"))
    rc, out = _init_in_a_process(tmp_path / "b", {
        "CXX": "false", "HOROVOD_TPU_NATIVE_CORE": "0"})
    assert rc == 0 and "INIT None" in out, out
    rc, out = _init_in_a_process(tmp_path / "c", {
        "HOROVOD_TPU_NATIVE_BUILD": "0"})
    assert rc == 3, out
    assert "HOROVOD_TPU_NATIVE_BUILD=0" in out
    assert "HOROVOD_TPU_NATIVE_CORE=0" in out
    assert not (tmp_path / "c").exists()


def test_unwritable_build_dir_raises_at_init_naming_the_knob(tmp_path):
    # the build directory's parent is a file: its mkdir fails (as a
    # read-only install prefix would, for any user)
    (tmp_path / "file").write_text("")
    rc, out = _init_in_a_process(tmp_path / "file" / "b", {})
    assert rc == 3, out
    assert "RAISED NativeCoreError" in out and "GROUP False" in out
    assert "could not build core.cpp into" in out
    assert "HOROVOD_TPU_NATIVE_CORE=0" in out


def test_two_processes_racing_a_cold_build_load_one_artifact(tmp_path):
    code = textwrap.dedent(f"""
        import pathlib
        from horovod_tpu_torch.native import build, loader
        build.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        mod = loader.load()
        print(mod.__file__, mod.plan_fusion_sigs([], 1))
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [o.strip().splitlines()[-1] for o in outs]
    assert lines[0] == lines[1] and lines[0].endswith(" []")
    artifacts = list(tmp_path.rglob("_hvd_core*"))
    assert [a.name for a in artifacts] == [build.artifact_path().name]


def test_artifact_is_keyed_by_source_compiler_and_suffix(monkeypatch,
                                                         tmp_path):
    path = build.artifact_path()
    assert path.parent.name.startswith("native-")
    assert path.name == "_hvd_core" + build.ext_suffix()
    monkeypatch.setenv("CXX", "clang++")
    assert build.artifact_path() != path
    monkeypatch.delenv("CXX")
    src = tmp_path / "core.cpp"
    src.write_bytes(build.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(build, "SOURCE", src)
    assert build.artifact_path() != path
    monkeypatch.setattr(build.sysconfig, "get_config_var",
                        lambda name: ".other.so")
    assert build.artifact_path().name == "_hvd_core.other.so"


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return torch_ranks.launch(2, ["native_core"],
                              tmp_path_factory.mktemp("native"))


def test_world_of_two_same_results_and_plans_on_and_off(world2):
    ranks = [r["native_core"] for r in world2]
    for r in ranks:
        on, off = r["on"], r["off"]
        assert on["objects"] == ["horovod_tpu_torch.native._hvd_core"] * 4
        assert on["planner"] == "horovod_tpu_torch.native._hvd_core"
        assert off["objects"] == ["horovod_tpu_torch.ops.fusion",
                                  "builtins", None, None]
        assert off["planner"] == "horovod_tpu_torch.ops.fusion"
        assert on["out"].keys() == off["out"].keys()
        for k, v in on["out"].items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(off["out"][k]),
                                          err_msg=k)
        for run in (on, off):
            assert run["plans"]
            for sigs, threshold, buckets in run["plans"]:
                assert tfusion.plan_fusion(sigs, threshold) == buckets
                assert core.plan_fusion_sigs(sigs, threshold) == buckets
    # the negotiated cycles: every rank planned the same lists alike
    for key in ("on", "off"):
        plans = [[[[sigs[i].name for i in b] for b in buckets]
                  for sigs, _, buckets in r[key]["plans"]] for r in ranks]
        assert plans[0] == plans[1]
