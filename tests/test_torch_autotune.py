"""The port's autotuner (``autotune.py``) and its engine hooks against the
JAX package's.

``autotune.py`` is a copy (numpy only): the JAX package's
``tests/test_autotune.py`` cases are replayed on it, and each synthetic
feed runs through both managers, which must walk the same points, log the
same rows (timestamps aside) and converge to the same one.  The engine's
hooks: at world 1 the live engine reads the tuner's cycle time,
threshold and cache switch each cycle; at world 2 (``tests/torch_ranks.py``
``case_tools``, two real rank processes over gloo) rank 0's tuner learns
and every rank applies the same agreed point in every round.  The
reference's ``test_negotiated_autotune_survives_leader_join`` fails on
the JAX package itself (ROADMAP.md §C) and is not replayed.
"""

import math

import pytest
import torch

from horovod_tpu import autotune as jat
from horovod_tpu import config as jconfig
import horovod_tpu_torch as hvd
from horovod_tpu_torch import autotune as tat
from horovod_tpu_torch import config as tconfig

import torch_ranks as tr


def _cfg(config, **kw):
    c = config.Config()
    c.autotune = True
    c.autotune_warmup_samples = kw.pop("warmup", 1)
    c.autotune_steps_per_sample = kw.pop("steps", 2)
    c.autotune_max_samples = kw.pop("max_samples", 6)
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def _feed(pm, score_fn, n_cycles=400):
    trail = []
    for _ in range(n_cycles):
        if pm.tuned:
            break
        bps = score_fn(pm.current_fusion_threshold(),
                       pm.current_cycle_time_ms())
        pm.record_cycle(nbytes=int(bps), elapsed_s=1.0)
        trail.append(pm._current)
    return trail


def _peak(thr, cyc):
    return 1e9 * math.exp(-abs(math.log2(thr) - 26) - abs(cyc - 1.0))


FEEDS = {"peak": (_peak, {}),
         "flat": (lambda thr, cyc: 1.0, {"max_samples": 4}),
         "threshold": (lambda thr, cyc: thr, {"max_samples": 3}),
         "short_cycle": (lambda thr, cyc: 1e6 / (1.0 + cyc),
                         {"cycle_time_ms": 0.2, "max_samples": 8})}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_same_walk_and_log_as_jax(feed, tmp_path):
    fn, kw = FEEDS[feed]
    runs = []
    for mod, config in ((jat, jconfig), (tat, tconfig)):
        log = tmp_path / f"{mod.__name__}.csv"
        pm = mod.ParameterManager(_cfg(config, autotune_log=str(log), **kw))
        trail = _feed(pm, fn)
        pm._log_file.flush()
        rows = [line.split(",")[1:] for line in
                log.read_text().strip().splitlines()]
        runs.append((trail, pm.tuned, pm._current, rows))
    assert runs[0] == runs[1]


def test_tunes_both_dimensions_and_converges():
    pm = tat.ParameterManager(_cfg(tconfig))
    _feed(pm, _peak)
    assert pm.tuned
    xs = pm._gp.xs
    assert len({x[0] for x in xs}) > 1 or len({x[1] for x in xs}) > 1
    assert pm.current_cycle_time_ms() in tat._CYCLE_GRID_MS
    assert pm._current in set(xs)


def test_converges_at_sample_budget():
    pm = tat.ParameterManager(_cfg(tconfig, max_samples=4))
    _feed(pm, lambda thr, cyc: 1.0)
    assert pm.tuned and len(pm._gp.xs) == 4


def test_autotune_log_schema(tmp_path):
    log = str(tmp_path / "autotune.csv")
    pm = tat.ParameterManager(_cfg(tconfig, autotune_log=log,
                                   max_samples=3))
    _feed(pm, lambda thr, cyc: thr)
    pm._log_file.flush()
    lines = open(log).read().strip().splitlines()
    assert lines[0] == ("timestamp,fusion_threshold_bytes,cycle_time_ms,"
                        "cache,hierarchical,compression,"
                        "score_bytes_per_sec,phase")
    assert any(line.endswith("tuned") for line in lines[1:])
    for line in lines[1:]:
        cols = line.split(",")
        assert float(cols[2]) in tat._CYCLE_GRID_MS
        assert cols[3] in ("0", "1") and cols[4] in ("0", "1")
        assert cols[5] in ("0", "1")


def test_configured_cycle_time_honored_before_tuning():
    pm = tat.ParameterManager(_cfg(tconfig, cycle_time_ms=0.2))
    assert pm.current_cycle_time_ms() == pytest.approx(0.2)
    assert 0.2 in pm._cycle_grid


def test_retune_on_sustained_regression():
    pm = tat.ParameterManager(_cfg(tconfig, max_samples=3))
    _feed(pm, lambda thr, cyc: 1e6)
    assert pm.tuned
    for _ in range(pm.retune_windows * pm.steps_per_sample):
        pm.record_cycle(nbytes=int(0.5e6), elapsed_s=1.0)
    assert not pm.tuned and pm.retunes == 1 and pm._best is None
    _feed(pm, lambda thr, cyc: 0.5e6)
    assert pm.tuned


def test_transient_dip_does_not_retune():
    pm = tat.ParameterManager(_cfg(tconfig, max_samples=3))
    _feed(pm, lambda thr, cyc: 1e6)
    for n, bps in ((2, 0.5e6), (1, 1e6), (2, 0.5e6)):
        for _ in range(n * pm.steps_per_sample):
            pm.record_cycle(int(bps), 1.0)
    assert pm.tuned and pm.retunes == 0


def test_retune_disabled_with_zero_drop():
    pm = tat.ParameterManager(_cfg(tconfig, max_samples=3,
                                   autotune_retune_drop=0.0))
    _feed(pm, lambda thr, cyc: 1e6)
    for _ in range(10 * pm.steps_per_sample):
        pm.record_cycle(int(1e3), 1.0)
    assert pm.tuned and pm.retunes == 0


def test_tunes_cache_dimension():
    pm = tat.ParameterManager(_cfg(tconfig, max_samples=60))
    for _ in range(800):
        if pm.tuned:
            break
        pm.record_cycle(nbytes=int(1e9 if not pm.current_cache_enabled()
                                   else 1e5), elapsed_s=1.0)
    assert pm.tuned and pm.current_cache_enabled() is False


def test_cache_dim_pinned_when_capacity_zero():
    pm = tat.ParameterManager(_cfg(tconfig, cache_capacity=0,
                                   max_samples=10))
    assert pm.current_cache_enabled() is False
    assert all(p[2] == 0.0 for p in pm._grid)
    _feed(pm, lambda thr, cyc: 1e6)
    assert pm.tuned and pm.current_cache_enabled() is False


# ---------------------------------------------------------------------------
# the engine's hooks
# ---------------------------------------------------------------------------

@pytest.fixture
def engine():
    hvd.init(device="cpu")
    try:
        yield hvd.runtime._state().engine
    finally:
        hvd.shutdown()


def test_engine_reads_tuned_cycle_time(engine):
    pm = tat.ParameterManager(_cfg(tconfig))
    engine.autotuner = pm
    pm._current = (pm._current[0], float(tat._CYCLE_GRID_MS.index(5.0)),
                   1.0, 0.0, 0.0)
    assert engine._cycle_time_s() == pytest.approx(0.005)
    pm._current = (pm._current[0], 0.0, 1.0, 0.0, 0.0)
    assert engine._cycle_time_s() == 0.0


def test_engine_applies_threshold_and_cache_switch(engine):
    """Cache-off cycles never touch the plan cache; the tuned threshold
    plans the buckets; stats()['autotune'] shows what was applied."""
    pm = tat.ParameterManager(_cfg(tconfig))
    engine.autotuner = pm
    pm._current = (pm._current[0], pm._current[1], 0.0, 0.0, 0.0)
    before = engine.stats()["cache"]["entries"]
    hvd.allreduce(torch.ones(4), name="ca_off")
    st = engine.stats()
    assert st["cache"]["entries"] == before
    assert st["autotune"]["cache_enabled"] is False
    assert st["autotune"]["hierarchical"] is False
    # a 16-byte threshold: two 16-byte tensors plan into two buckets
    pm._current = (4.0, pm._current[1], 1.0, 0.0, 0.0)
    b0 = engine.stats()["buckets"]
    for h in hvd.api._allreduce_each_async_(
            [torch.ones(4), torch.ones(4)], ["t0", "t1"], op=hvd.Sum):
        h.synchronize()
    st = engine.stats()
    assert st["buckets"] - b0 == 2
    assert st["cache"]["entries"] > before
    assert st["autotune"]["fusion_threshold_bytes"] == 16


def test_autotune_at_init_records_cycles(monkeypatch, tmp_path):
    """HOROVOD_AUTOTUNE=1 builds the tuner at init (no hierarchy at one
    rank: its switch pinned off); every cycle is scored into the log."""
    log = tmp_path / "at.csv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    hvd.init(device="cpu")
    try:
        pm = hvd.runtime._state().autotuner
        assert pm is not None
        assert {p[3] for p in pm._grid} == {0.0}
        for i in range(4):
            hvd.allreduce(torch.ones(8), name=f"a{i % 2}")
    finally:
        hvd.shutdown()
    rows = log.read_text().strip().splitlines()
    assert len(rows) >= 1 + 4
    assert rows[1].endswith("warmup")
    assert any(r.endswith("sample") for r in rows[2:])


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    return tr.launch(2, ["tools"], tmp_path_factory.mktemp("tools"))


def test_negotiated_parameters_identical_across_ranks(tools):
    """Every round agrees on rank 0's point: the two ranks applied the
    same parameters after every collective, and the tuner moved them."""
    a, b = (res["tools"] for res in tools)
    assert a["applied"] == b["applied"]
    assert all(p for p in a["applied"])
    assert len({tuple(sorted(p.items())) for p in a["applied"]}) > 1
    assert a["autotune"]["negotiated"] and b["autotune"]["negotiated"]
    for k in ("fusion_threshold_bytes", "cycle_time_ms", "cache_enabled"):
        assert a["autotune"][k] == b["autotune"][k]
