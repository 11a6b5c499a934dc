"""The port's training-health plane against the JAX package's.

* The taps' reductions (``health.taps.bucket_stats``/``checksum_flat``)
  on the same fp32 and bf16 buffers, NaN, ±inf, empty and odd lengths
  included: l2 and max-abs within 1e-6 relative (fp32 sums in another
  order), the nonfinite count equal, the xor of the fp32 bit patterns
  bitwise, the fp32 sum within 1e-5 relative.
* The evaluators fed one observation sequence (numpy seeds): the same
  verdicts (kind, worker, bucket, step, detail), the same ``summary()``
  and snapshot; ``merge_job_health`` and ``render_job_health`` of the
  same worker payloads the same JSON and text.
* The transform with ``health=True`` in 2 gloo rank processes
  (``tests/torch_ranks.py`` ``case_health``) against JAX's
  ``DistributedOptimizer(health=True)`` under ``pmap`` on as many virtual
  devices, on the toy tree both planners bucket alike (35 and 3
  elements, a 64-byte threshold; JAX names a leaf ``['a']``, the port
  ``a``): each (step, worker, bucket)'s stats
  within 1e-6 relative, the error-feedback residual norms under int8
  within 1e-5, the sentinel's rounds and a chaos NaN's verdict equal;
  ``scale:R`` after the warm-up names rank R's ``grad_explosion``.  At
  world 3 the sentinel convicts the one replica whose weights start 1
  ulp off; at world 2 such a split convicts no single replica.
* The stale tail round's staleness feed, the engine's dispatch tap, the
  doctor CLI (table, ``--json``, exit codes, the trace cross-reference),
  ``GET /health`` and the elastic driver's ``health/job`` and
  ``timeseries/job`` end to end.
"""

import json
import pathlib
import re
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import chaos as jchaos
from horovod_tpu import health as jhealth
from horovod_tpu.health import __main__ as jdoctor
from horovod_tpu.health import taps as jtaps
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.optim import precision as jprecision
from horovod_tpu.optim.distributed import \
    DistributedOptimizer as JDistributedOptimizer
import horovod_tpu_torch as hvd
from horovod_tpu_torch import chaos, health
from horovod_tpu_torch.health import __main__ as doctor
from horovod_tpu_torch.health import taps
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.runner.rpc import JsonRpcServer

import torch_ranks as tr

AXIS = "hw"
TRACE = pathlib.Path(__file__).resolve().parent / "traces" / \
    "chaos_4proc.trace.json"


# -- the taps' reductions ------------------------------------------------------

BUFFERS = {"random": 1000, "odd": 1001, "one": 1, "empty": 0, "nan": 257,
           "inf": 130, "large": 4099}


def _buffer(kind: str, dtype: str):
    """(port tensor, JAX array) of one seeded buffer; bf16 buffers hold
    bf16 values on both sides."""
    rng = np.random.RandomState(sorted(BUFFERS).index(kind))
    x = (rng.standard_normal(BUFFERS[kind]) * 3).astype(np.float32)
    if kind == "nan":
        x[[3, 100, 256]] = np.nan
    if kind == "inf":
        x[5], x[7] = np.inf, -np.inf
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        # the same bf16 bit patterns on both sides (the NaNs' payloads too)
        t = t.to(torch.bfloat16)
        return t, jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return t, jnp.asarray(x)


def _u32(x: torch.Tensor) -> np.ndarray:
    """An int32 bit-pattern tensor's bits as JAX's uint32."""
    return x.numpy().astype(np.int32).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(BUFFERS))
def test_bucket_stats_and_checksum_match_jax(kind, dtype):
    t, j = _buffer(kind, dtype)
    got = [x.item() for x in taps.bucket_stats(t)]
    want = [np.asarray(x).item() for x in jtaps.bucket_stats(j)]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6, atol=0)
    assert got[2] == want[2] == int((~np.isfinite(
        t.float().numpy())).sum())
    s, x = taps.checksum_flat(t)
    js, jx = jtaps.checksum_flat(j)
    assert _u32(x) == np.asarray(jx).astype(np.uint32)
    np.testing.assert_allclose(s.item(), np.asarray(js).item(), rtol=1e-5,
                               atol=1e-6)


def test_checksum_of_leaves_is_the_concatenation_s():
    """Per-leaf checksums combined: the xor bitwise the concatenation's,
    the sum within fp32 reordering."""
    parts = [_buffer(k, "float32")[0] for k in ("odd", "one", "large")]
    s, x = taps.checksum_leaves(parts)
    cs, cx = taps.checksum_flat(torch.cat(parts))
    assert _u32(x) == _u32(cx)
    np.testing.assert_allclose(s.item(), cs.item(), rtol=1e-5)


# -- the evaluator, the merge and the table ------------------------------------

def _observations(seed: int, steps: int = 300):
    """A seeded stream of every kind of observation: bucket stats (some
    spiking 30x, some nonfinite), residual norms (some drifting, some
    NaN), staleness counters, checksum rounds (some replicas disagreeing,
    some even splits), losses (spikes, NaN) and SLO edges."""
    rng = np.random.RandomState(seed)
    names = ["a", "b", "c"]
    out = []
    for step in range(1, steps):
        for b, name in enumerate(names):
            worker = int(rng.randint(0, 3))
            l2 = float(abs(rng.normal(1.0, 0.1))
                       * rng.choice([1, 1, 1, 1, 1, 1, 1, 1, 30]))
            nonf = int(rng.rand() < 0.03) * int(rng.randint(1, 5))
            out.append(("ingest_bucket", (step, worker, b, name, l2,
                                          l2 / 2, nonf), {}))
            if rng.rand() < 0.2:
                norm = float(l2 * rng.choice([0.1, 0.1, 0.1, 10.0,
                                              float("nan")]))
                out.append(("ingest_residual", (step, worker, b, norm),
                            {"name": name}))
        if rng.rand() < 0.15:
            out.append(("ingest_staleness",
                        (step, "t.stale",
                         [int(c) for c in rng.randint(0, 3, size=2)], 2),
                        {"bucket": int(rng.randint(0, 2))}))
        if rng.rand() < 0.2:
            n = int(rng.choice([2, 3, 4]))
            xors = [[int(rng.choice([7, 7, 7, 9])) for _ in names]
                    for _ in range(n)]
            sums = [[float(v) for v in row] for row in xors]
            out.append(("ingest_checksums", (step, 0, names, sums, xors),
                        {}))
        if rng.rand() < 0.5:
            out.append(("note_loss", (float(rng.choice(
                [2.0, 2.1, 1.9, 9.0, float("nan")])),), {"step": step}))
        if rng.rand() < 0.05:
            out.append(("ingest_slo", ("serve_p99_s<=0.5@1w", "slow"),
                        {"step": step, "clear": bool(rng.rand() < 0.5)}))
    return out


def _fed(ev, seed):
    for method, args, kw in _observations(seed):
        getattr(ev, method)(*args, **kw)
    return ev


def _strip(v):
    return {k: x for k, x in v.items() if k != "wall"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluators_give_the_same_verdicts(seed):
    got = _fed(health.HealthEvaluator(), seed)
    want = _fed(jhealth.HealthEvaluator(), seed)
    assert [_strip(v) for v in got.verdicts()] == \
        [_strip(v) for v in want.verdicts()]
    assert got.summary() == want.summary()
    assert got.summary()["verdicts"] > 10
    # straggler_scores cross-references a live runtime's stall inspector
    # (another test's in this process), not the evaluator's state
    skip = ("active", "verdicts", "straggler_scores")
    snap = {k: v for k, v in got.snapshot().items() if k not in skip}
    jsnap = {k: v for k, v in want.snapshot().items() if k not in skip}
    assert json.dumps(snap, sort_keys=True) == json.dumps(jsnap,
                                                          sort_keys=True)


def _payloads(pkg):
    """Worker snapshots for a merge: two fed from seeds (one monitored
    and unhealthy, one with monitoring off) and a clean one."""
    out = {}
    for wid, seed in (("0", 3), ("1", 4), ("2", None)):
        ev = pkg.HealthEvaluator()
        ev.process, ev.host = int(wid), f"host{wid}"
        if seed is not None:
            _fed(ev, seed)
        snap = ev.snapshot()
        snap["enabled"] = wid != "1"
        out[wid] = snap
    return out


@pytest.mark.parametrize("unreachable", [{}, {"3": "timed out"}])
@pytest.mark.parametrize("workers", [("0", "1", "2"), ("2",), ("0",)])
def test_merge_and_render_job_health_match_jax(workers, unreachable):
    snaps = _payloads(health)
    chosen = {w: snaps[w] for w in workers}
    got = health.merge_job_health(chosen, unreachable)
    want = jhealth.merge_job_health(chosen, unreachable)
    got.pop("wall"), want.pop("wall")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert health.render_job_health(got) == jhealth.render_job_health(want)


# -- the transform's taps against JAX's, and the sentinel ----------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return tr.Worlds(tmp_path_factory, ["health"])


class _JRecording(jhealth.HealthEvaluator):
    def __init__(self):
        super().__init__()
        self.obs, self.res = [], []

    def ingest_bucket(self, step, worker, bucket, name, l2, max_abs,
                      nonfinite):
        self.obs.append((int(step), int(worker), int(bucket), str(name),
                         float(l2), float(max_abs), int(nonfinite)))
        super().ingest_bucket(step, worker, bucket, name, l2, max_abs,
                              nonfinite)

    def ingest_residual(self, step, worker, bucket, norm, name=None):
        self.res.append((int(step), int(worker), int(bucket), float(norm)))
        super().ingest_residual(step, worker, bucket, norm, name=name)


def jax_health_run(n, kw, steps=4, every=2, rule=None):
    """JAX's DistributedOptimizer(health=True) under pmap on ``n`` virtual
    devices, :func:`torch_ranks.zgrads` a device; its recording
    evaluator."""
    ev = _JRecording()
    old = jhealth.swap_evaluator(ev)
    inner = jprecision.adamw_lp(tr.ZLR, mu_dtype=jnp.float32,
                                nu_dtype=jnp.float32)
    kw = dict({"wire_format": "none", "wire_block_size": tr.ZBLOCK}, **kw)
    opt = JDistributedOptimizer(inner, axis_name=AXIS,
                                threshold_bytes=tr.ZTHRESHOLD, health=True,
                                health_check_every=every, **kw)
    devs = jax.devices()[:n]
    params = tr.zparams()
    if rule is not None:
        jchaos.install(jchaos.FaultSchedule.parse(rule, seed=7))
    try:
        st = jax.pmap(lambda p, _: opt.init(p), axis_name=AXIS,
                      in_axes=(None, 0), devices=devs)(params, np.zeros(n))

        def step(p, s, g):
            u, ns = opt.update(g, s, p)
            return optax.apply_updates(p, u), ns

        f = jax.pmap(step, axis_name=AXIS, in_axes=(None, 0, 0),
                     devices=devs)
        for i in range(steps):
            g = {k: np.stack([tr.zgrads(r, i)[k] for r in range(n)])
                 for k in params}
            pstack, st = f(params, st, g)
            jax.block_until_ready(pstack)
            params = {k: np.asarray(v[0]) for k, v in pstack.items()}
    finally:
        jchaos.uninstall()
        jhealth.swap_evaluator(old)
    return ev


def _path(name: str) -> str:
    """A JAX leaf name (``jax.tree_util.keystr``: ``['a']``) as the port
    names it (``tree.tree_paths``: ``a``), in a name or a detail."""
    return re.sub(r"\['([^']*)'\]", r"\1", name)


def _by_key(rows):
    return {r[:3] + (_path(r[3]),): r[4:] for r in rows}


@pytest.mark.parametrize("name", sorted(tr.HEALTH_CONFIGS))
def test_transform_taps_match_jax(worlds, name):
    ranks = worlds[2]
    want = jax_health_run(2, tr.HEALTH_CONFIGS[name])
    runs = [r["health"][name] for r in ranks]
    got = _by_key([o for run in runs for o in run["obs"]])
    jwant = _by_key(want.obs)
    assert sorted(got) == sorted(jwant) and len(got) == 2 * 2 * (
        2 if name == "k2" else 4)
    for key, w in jwant.items():
        np.testing.assert_allclose(got[key][:2], w[:2], rtol=1e-6,
                                   err_msg=str(key))
        assert got[key][2] == w[2] == 0
    res = sorted(r for run in runs for r in run["res"])
    jres = sorted(want.res)
    assert [r[:3] for r in res] == [r[:3] for r in jres]
    np.testing.assert_allclose([r[3] for r in res], [r[3] for r in jres],
                               rtol=1e-5)
    assert bool(res) == (name == "int8")
    for run in runs:
        assert run["verdicts"] == [] and run["summary"]["healthy"]
        assert run["checksum_rounds"] == \
            want.snapshot()["checks"]["checksum_rounds"] > 0


def test_chaos_nan_and_scale_name_the_rank_and_bucket(worlds):
    """``nan:1`` on bucket 1: rank 1's nonfinite verdict, JAX's verdict
    word for word (JAX bakes its trace-time rule into every step, the
    port's rule fires at every update); ``scale:1`` on bucket 0 after the
    warm-up: rank 1's grad_explosion at that update; rank 0 sees none."""
    ranks = worlds[2]
    want = jax_health_run(2, {}, steps=2, every=1,
                          rule="collective.corrupt bucket=1 nth=1 "
                               "action=nan:1")
    jv = [{k: (_path(v[k]) if k == "detail" else v[k])
           for k in ("kind", "worker", "bucket", "step", "detail")}
          for v in want.verdicts()]
    assert ranks[1]["health"]["nan"]["verdicts"] == jv
    assert jv[0]["kind"] == "nonfinite" and jv[0]["worker"] == 1
    assert ranks[0]["health"]["nan"]["verdicts"] == []
    scale = ranks[1]["health"]["scale"]["verdicts"]
    assert [(v["kind"], v["worker"], v["bucket"], v["step"])
            for v in scale] == [("grad_explosion", 1, 0, 7)]
    assert "(a)" in scale[0]["detail"]
    assert ranks[0]["health"]["scale"]["verdicts"] == []


@pytest.mark.parametrize("world", [2, 3])
def test_sentinel_convicts_the_minority_not_a_split(worlds, world):
    """The last rank's weights start 1 ulp off in bucket 1: at world 3
    every rank convicts replica 2 of bucket 1; at world 2 the split has
    no majority and no single replica is convicted (worker -1)."""
    for r in worlds[world]:
        v = r["health"]["perturbed"]["verdicts"]
        assert [(x["kind"], x["bucket"], x["step"]) for x in v] == [
            ("replica_desync", 1, 1)], v
        assert v[0]["worker"] == (2 if world == 3 else -1)
        assert "0x7f800001" in v[0]["detail"]


# -- the tail round, the engine, the transform's defaults ----------------------

def test_stale_tail_round_feeds_staleness_saturation():
    """A stale round whose group 0 sits at the cap: the port's and JAX's
    tail rounds give the same verdict; a round below the cap re-arms."""
    got, want = health.HealthEvaluator(), jhealth.HealthEvaluator()
    old, jold = health.swap_evaluator(got), jhealth.swap_evaluator(want)
    try:
        for stal in ([2, 0], [0, 0], [2, 1]):
            tcoll.tail_round("t.stale", "stale", 2, 0.05, max_staleness=2,
                             staleness=stal)
            jcoll.tail_round("t.stale", "stale", 2, 0.05, max_staleness=2,
                             staleness=stal)
    finally:
        health.swap_evaluator(old)
        jhealth.swap_evaluator(jold)
    v = [_strip(x) for x in got.verdicts()]
    assert v == [_strip(x) for x in want.verdicts()]
    assert [(x["kind"], x["worker"], x["group"]) for x in v] == [
        ("staleness_saturated", -1, 0), ("staleness_saturated", -1, 0)]


@pytest.fixture
def runtime(monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "30")
    # the engine's tap observes every cycle (default: every 32nd)
    monkeypatch.setenv("HOROVOD_HEALTH_CHECK_EVERY", "1")
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()
        chaos.uninstall()


def test_engine_dispatch_tap_names_this_rank(runtime):
    """The engine's fused allreduce: a NaN'd contribution (the
    ``collective.corrupt`` site) gives a nonfinite verdict on this rank
    and the bucket's first tensor; stats() carries the health and
    time-series blocks."""
    ev = health.HealthEvaluator()
    old = health.swap_evaluator(ev)
    try:
        x = torch.ones(8)
        runtime.allreduce(x, name="clean")
        chaos.install(chaos.FaultSchedule.parse(
            "collective.corrupt action=nan:0"))
        out = runtime.allreduce(x, name="poisoned")
        chaos.uninstall()
    finally:
        health.swap_evaluator(old)
    assert torch.isnan(out).all() and not torch.isnan(x).any()
    v = ev.verdicts()
    assert [(x["kind"], x["worker"]) for x in v] == [("nonfinite", 0)]
    assert "poisoned" in v[0]["detail"]
    stats = runtime.runtime._state().engine.stats()
    assert set(stats["health"]) == {"healthy", "verdicts", "active",
                                    "kinds", "last_step"}
    assert stats["timeseries"]["enabled"]


@pytest.mark.parametrize("env,armed", [
    ({"HOROVOD_HEALTH_TAPS": "1"}, True),
    ({"HOROVOD_HEALTH_TAPS": "1", "HOROVOD_HEALTH": "0"}, False),
    ({}, False)])
def test_taps_default_from_the_environment(monkeypatch, env, armed):
    """Without ``health=`` the transform arms its taps from
    HOROVOD_HEALTH_TAPS, which HOROVOD_HEALTH=0 vetoes; with them armed
    ``count`` advances every update."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "30")
    hvd.init(device="cpu")
    ev = health.HealthEvaluator()
    old = health.swap_evaluator(ev)
    try:
        params = {k: torch.from_numpy(v) for k, v in tr.zparams().items()}
        tx = hvd.DistributedGradientTransform(
            tr._fp32_adamw_lp(tr.ZLR), threshold_bytes=tr.ZTHRESHOLD)
        state = tx.init(params)
        for i in range(2):
            tx.update({k: torch.from_numpy(v) for k, v in
                       tr.zgrads(0, i).items()}, state, params)
    finally:
        health.swap_evaluator(old)
        hvd.shutdown()
    assert ev.summary()["last_step"] == (2 if armed else -1)
    assert state.count == (2 if armed else 0)


# -- the doctor CLI --------------------------------------------------------------

def _job(kind):
    snaps = _payloads(health)
    chosen = {"healthy": {"2": snaps["2"]}, "unhealthy": snaps,
              "degraded": {"2": snaps["2"]}}[kind]
    return health.merge_job_health(
        chosen, {"9": "refused"} if kind == "degraded" else {})


@pytest.mark.parametrize("kind,code", [("healthy", 0), ("unhealthy", 1),
                                       ("degraded", 2)])
def test_doctor_table_json_and_exit_codes(tmp_path, capsys, kind, code):
    path = tmp_path / "health.json"
    path.write_text(json.dumps(_job(kind)))
    assert doctor.main([str(path), "--top", "5"]) == code
    table = capsys.readouterr().out
    assert jdoctor.main([str(path), "--top", "5"]) == code
    assert table == capsys.readouterr().out
    assert table.startswith(f"job health: {kind.upper()}")
    assert doctor.main([str(path), "--json"]) == code
    assert json.loads(capsys.readouterr().out) == json.loads(
        path.read_text())
    assert doctor.main([str(path), "--trace", str(TRACE)]) == code
    lines = capsys.readouterr().out.strip().splitlines()
    jdoctor.main([str(path), "--trace", str(TRACE)])
    assert lines == capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("trace cross-ref: critical-path host")


def test_doctor_smoke_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "30")
    assert doctor.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "doctor smoke OK" in out and "UNHEALTHY" in out


# -- GET /health, the driver's health/job and timeseries/job -------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, route):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{route}",
                                timeout=60) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_get_health_on_every_server():
    ev = _fed(health.HealthEvaluator(), 5)
    old = health.swap_evaluator(ev)
    srv = JsonRpcServer({}, secret=None, host="127.0.0.1")
    try:
        status, body = _get(srv.port, "health")
    finally:
        srv.close()
        health.swap_evaluator(old)
    assert status == 200 and body["enabled"] is True
    assert body["counts"] == ev.summary()["kinds"]


def test_driver_health_and_timeseries_job_end_to_end():
    """The port's ElasticDriver serves GET /health/job and
    /timeseries/job: two workers' health_pull snapshots (one with a
    nonfinite verdict) merged into an unhealthy job verdict, their
    /timeseries windows merged per worker, and an endpoint nothing
    listens on unreachable in both."""
    from horovod_tpu_torch.elastic import discovery
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.metrics import timeseries
    driver = ElasticDriver(discovery.FixedHostDiscovery({"localhost": 1}),
                           ["true"], min_np=1, port=_free_port())
    evs = [health.HealthEvaluator() for _ in range(2)]
    for i, ev in enumerate(evs):
        ev.process, ev.host = i, f"host{i}"
    evs[1].ingest_bucket(4, 1, 2, "w", 1.0, float("nan"), 3)
    ring = timeseries.TimeSeriesRing(window=4, every_s=60.0)
    old_ring = timeseries.swap_ring(ring)
    ring.sample()
    workers = [JsonRpcServer(
        {"health_pull": lambda p, ev=ev: dict(ev.snapshot(), enabled=True)},
        host="127.0.0.1") for ev in evs]
    try:
        with driver._lock:
            for i, s in enumerate(workers):
                driver._notif[i] = ("127.0.0.1", s.port)
            driver._notif[2] = ("127.0.0.1", _free_port())   # gone
        status, job = _get(driver.port, "health/job")
        ts_status, ts = _get(driver.port, "timeseries/job")
    finally:
        driver._server.close()
        for s in workers:
            s.close()
        timeseries.swap_ring(old_ring)
    assert status == 200 and job["verdict"] == "unhealthy"
    assert sorted(job["workers"]) == ["0", "1"]
    assert list(job["unreachable"]) == ["2"]
    assert [(v["worker_id"], v["kind"], v["bucket"], v["step"])
            for v in job["verdicts"]] == [("1", "nonfinite", 2, 4)]
    assert ts_status == 200 and list(ts["unreachable"]) == ["2"]
    assert all(ts["workers"][w]["windows"] == 1 for w in ("0", "1"))


def test_elastic_worker_serves_health_pull():
    """The worker's notification server answers health_pull with this
    process's snapshot."""
    from horovod_tpu_torch.elastic import worker
    from horovod_tpu_torch.runner.rpc import json_request
    mgr = worker.WorkerNotificationManager()
    try:
        got = json_request("127.0.0.1", mgr._server.port, "health_pull", {},
                           timeout=10.0, retries=0)
    finally:
        mgr._server.close()
    assert got["enabled"] is True and "verdicts" in got
