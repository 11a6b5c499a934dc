"""The port's time-series ring, SLO watchdog and top CLI against the JAX
package's.

* ``_window_delta`` of the same registry snapshots (counters, gauges,
  histograms, a counter and a histogram that went backwards at a
  restart): the same window.  The windowed helpers (``counter_rate``,
  ``hist_quantile``, ``gauge_last``, ``percentile_from_buckets``,
  ``merge_hist_windows`` and its refusal of mismatched edges) the same
  numbers; ``render_windows`` the same text.
* ``parse_rules`` of the same specs the same rules, or the same error.
* The watchdog over the same windows: the same breaches, edge-triggered,
  re-armed on recovery, each riding the health plane as an
  ``slo_breach`` verdict.
* ``merge_job_timeseries`` and the top table of the same worker payloads
  the same JSON and text; the top CLI's exit codes and ``--smoke``.
* The sampler: started at ``hvd.init()`` under
  ``HOROVOD_TIMESERIES_EVERY_S``, stopped at shutdown (no stray thread),
  ``GET /timeseries`` and ``engine.stats()["timeseries"]``.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest

from horovod_tpu.metrics import slo as jslo
from horovod_tpu.metrics import timeseries as jts
from horovod_tpu.metrics import top as jtop
import horovod_tpu_torch as hvd
from horovod_tpu_torch import health
from horovod_tpu_torch.metrics import slo, top
from horovod_tpu_torch.metrics import timeseries as ts
from horovod_tpu_torch.runner.rpc import JsonRpcServer

# the modules (both packages' ``metrics.registry`` attribute is a function)
registry = importlib.import_module("horovod_tpu_torch.metrics.registry")
jregistry = importlib.import_module("horovod_tpu.metrics.registry")


def _registry(seed: int, pkg=registry):
    """A registry with a counter, a gauge and a histogram, each with two
    label sets, fed from ``seed``; returns its ``to_dict()``."""
    rng = np.random.RandomState(seed)
    reg = pkg.MetricRegistry()
    c = reg.counter("hvd_engine_cycles_total", "cycles", labels=("k",))
    g = reg.gauge("hvd_serve_queue_depth", "depth", labels=("k",))
    h = reg.histogram("hvd_serve_request_latency_seconds", "lat",
                      labels=("k",), lo=-8, hi=2)
    for k in ("x", "y"):
        c.inc(float(rng.randint(0, 50)), k=k)
        g.set(float(rng.randint(0, 9)), k=k)
        for v in rng.exponential(0.05, size=int(rng.randint(1, 40))):
            h.observe(float(v), k=k)
    return reg.to_dict()


def _later(prev: dict, seed: int, restart=False) -> dict:
    """``prev`` a window later: counters and histograms grown (or, with
    ``restart``, one series of each started again from a smaller
    count)."""
    cur = json.loads(json.dumps(prev))
    more = _registry(seed)
    for name, fam in cur.items():
        for s, m in zip(fam["series"], more[name]["series"]):
            if fam["type"] == "counter":
                s["value"] = m["value"] if restart and s["labels"]["k"] == \
                    "x" else s["value"] + m["value"]
            elif fam["type"] == "gauge":
                s["value"] = m["value"]
            elif restart and s["labels"]["k"] == "x":
                s.update(buckets=m["buckets"], sum=m["sum"],
                         count=min(m["count"], s["count"] - 1))
            else:
                s.update(buckets=[a + b for a, b in zip(s["buckets"],
                                                        m["buckets"])],
                         sum=s["sum"] + m["sum"],
                         count=s["count"] + m["count"])
    return cur


def _windows(n=5, seed=0):
    snaps = [_registry(seed)]
    for i in range(n):
        snaps.append(_later(snaps[-1], seed + 10 + i, restart=i == 2))
    return [ts._window_delta(a, b, i, 10.0 + i, 1000.0 + i)
            for i, (a, b) in enumerate(zip(snaps, snaps[1:]))], snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_delta_and_helpers_match_jax(seed):
    wins, snaps = _windows(seed=seed)
    jwins = [jts._window_delta(a, b, i, 10.0 + i, 1000.0 + i)
             for i, (a, b) in enumerate(zip(snaps, snaps[1:]))]
    assert wins == jwins
    # a registry snapshot of both packages' registries is the same dict
    assert _registry(seed) == _registry(seed, jregistry)
    for fam in ("hvd_engine_cycles_total", "hvd_rpc_client_requests_total"):
        assert ts.counter_rate(wins, fam) == jts.counter_rate(jwins, fam)
    lat = "hvd_serve_request_latency_seconds"
    for q in (0.5, 0.9, 0.99, 1.0):
        assert ts.hist_quantile(wins, lat, q) == \
            jts.hist_quantile(jwins, lat, q)
    assert ts.hist_window(wins, lat) == jts.hist_window(jwins, lat)
    for labels in (None, {"k": "x"}, {"k": "z"}):
        assert ts.gauge_last(wins, "hvd_serve_queue_depth", labels) == \
            jts.gauge_last(jwins, "hvd_serve_queue_depth", labels)
    assert ts.render_windows(wins) == jts.render_windows(jwins)
    assert ts.counter_rate([], "x") is None
    bad = dict(wins[0]["histograms"][lat]["series"][0], le=[1.0])
    with pytest.raises(ValueError, match="mismatched bucket edges"):
        ts.merge_hist_windows([dict(bad, le=[0.5, 1.0]), bad])


def test_ring_windows_deltas_and_evicts():
    reg = registry.MetricRegistry()
    c = reg.counter("hvd_engine_cycles_total", "cycles")
    ring = ts.TimeSeriesRing(window=3, every_s=1.0, registry=reg)
    for i in range(5):
        c.inc(i + 1)
        ring.sample()
    wins = ring.windows()
    assert len(ring) == 3 and ring.closed() == 5
    assert [w["counters"]["hvd_engine_cycles_total"][0]["delta"]
            for w in wins] == [3.0, 4.0, 5.0]
    ring.sample()   # an idle window: the family pruned, a rate of 0
    assert ts.counter_rate(ring.windows(1), "hvd_engine_cycles_total") == 0
    with pytest.raises(ValueError):
        ts.TimeSeriesRing(window=1)


SPECS = ["serve_p99_s<=0.5@3w,cycle_rate>=10@5w,recovery_time_s<=30",
         "queue_depth<=4", " rpc_rate>=1e2@2w , ", "",
         "nope<=1", "cycle_rate<1", "cycle_rate<=abc", "cycle_rate<=1@0w",
         "serve_p99_s<=1.5.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_rules_matches_jax(spec):
    try:
        want = [(r.raw, r.name, r.op, r.threshold, r.nw, r.unit)
                for r in jslo.parse_rules(spec)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            slo.parse_rules(spec)
        assert str(got.value) == str(e)
        return
    assert [(r.raw, r.name, r.op, r.threshold, r.nw, r.unit)
            for r in slo.parse_rules(spec)] == want
    assert sorted(slo.SIGNALS) == sorted(jslo.SIGNALS)


class _Ring:
    def __init__(self, windows):
        self._w = windows

    def windows(self, limit=None):
        return self._w[-limit:] if limit else list(self._w)


def _cycle_window(n, cycles):
    counters = ({"hvd_engine_cycles_total": [{"labels": {}, "delta":
                                              float(cycles)}]}
                if cycles else {})
    return {"n": n, "wall": float(n), "dur_s": 1.0, "counters": counters,
            "gauges": {}, "histograms": {}}


def test_watchdog_edges_ride_the_health_plane():
    """A cycle-rate ceiling over a sequence of windows: the port's and
    JAX's watchdogs fire and re-arm alike; each breach is one slo_breach
    verdict, its recovery re-arms it, and a second episode fires again."""
    rule = "cycle_rate<=2@2w"
    rates = [0, 1, 5, 5, 9, 0, 0, 0, 4, 4]
    ev = health.HealthEvaluator()
    old = health.swap_evaluator(ev)
    try:
        wd, jwd = slo.Watchdog(slo.parse_rules(rule)), jslo.Watchdog(
            jslo.parse_rules(rule))
        fired, jfired, active = [], [], []
        for i in range(len(rates)):
            ring = _Ring([_cycle_window(j, r)
                          for j, r in enumerate(rates[:i + 1])])
            fired.append(wd.observe(ring))
            jfired.append(jwd.observe(ring))
            active.append([b["rule"] for b in wd.snapshot()["active"]])
    finally:
        health.swap_evaluator(old)
    assert fired == jfired
    assert [i for i, f in enumerate(fired) if f] == [2, 9]
    assert active[6] == [] and active[9] == [rule]
    assert [(v["kind"], v["rule"]) for v in ev.verdicts()] == [
        ("slo_breach", rule)] * 2


def _payload(seed, enabled=True, breach=None):
    wins = _windows(n=3, seed=seed)[0]
    out = {"enabled": enabled, "pid": seed, "every_s": 10.0, "window": 8,
           "closed": len(wins), "windows": wins, "straggler": 0.25 * seed}
    if breach:
        out["slo"] = {"rules": [breach], "active": [
            {"rule": breach, "signal": "queue_depth", "value": 9.0,
             "threshold": 4.0, "op": "<=", "windows": 1,
             "detail": f"queue_depth=9 violates {breach}"}]}
    return out


@pytest.mark.parametrize("unreachable", [{}, {"9": "refused"}])
def test_merge_job_timeseries_and_top_table_match_jax(unreachable):
    workers = {"0": _payload(0), "1": _payload(1, breach="queue_depth<=4"),
               "2": _payload(2, enabled=False)}
    got = ts.merge_job_timeseries(workers, unreachable)
    want = jts.merge_job_timeseries(workers, unreachable)
    got.pop("wall"), want.pop("wall")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert top.render_job_timeseries(got) == jtop.render_job_timeseries(want)
    assert got["slo"][0]["worker"] == "1"


@pytest.mark.parametrize("workers,unreachable,code", [
    ({"0": {}}, {}, 0), ({"1": {"breach": "queue_depth<=4"}}, {}, 1),
    ({"0": {}}, {"9": "refused"}, 2)])
def test_top_cli_json_and_exit_codes(tmp_path, capsys, workers,
                                     unreachable, code):
    job = ts.merge_job_timeseries(
        {w: _payload(int(w), **kw) for w, kw in workers.items()},
        unreachable)
    path = tmp_path / "ts.json"
    path.write_text(json.dumps(job))
    assert top.main([str(path)]) == code
    table = capsys.readouterr().out
    assert jtop.main([str(path)]) == code
    assert table == capsys.readouterr().out
    assert top.main([str(path), "--json"]) == code
    assert json.loads(capsys.readouterr().out) == job


def test_top_smoke_on_the_cpu(capsys):
    assert top.main(["--smoke", "--device", "cpu"]) == 0
    assert "top smoke OK" in capsys.readouterr().out


def _sampler_threads():
    return [t for t in threading.enumerate()
            if t.name == "hvd-timeseries" and t.is_alive()]


def test_sampler_starts_at_init_and_stops_at_shutdown(monkeypatch):
    """HOROVOD_TIMESERIES_EVERY_S=0.05: windows close while the runtime
    lives, GET /timeseries serves them with the watchdog's rules, stats()
    summarizes them; shutdown stops the thread and keeps the ring."""
    monkeypatch.setenv("HOROVOD_TIMESERIES_EVERY_S", "0.05")
    monkeypatch.setenv("HOROVOD_SLO", "cycle_rate>=1000@1w")
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "30")
    old_ring = ts.swap_ring(None)
    ev = health.HealthEvaluator()
    old_ev = health.swap_evaluator(ev)
    try:
        hvd.init(device="cpu")
        try:
            assert len(_sampler_threads()) == 1
            import torch
            hvd.allreduce(torch.ones(4), name="ts.x")
            deadline = time.monotonic() + 10
            while ts.ring().closed() < 3 and time.monotonic() < deadline:
                time.sleep(0.02)
            srv = JsonRpcServer({}, secret=None, host="127.0.0.1")
            try:
                import urllib.request
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}/timeseries",
                        timeout=30) as resp:
                    body = json.loads(resp.read().decode())
            finally:
                srv.close()
            stats = hvd.runtime._state().engine.stats()["timeseries"]
        finally:
            hvd.shutdown()
        assert _sampler_threads() == []
        assert ts.ring() is not None and ts.ring().closed() >= 3
    finally:
        ts.swap_ring(old_ring)
        slo.swap_watchdog(None)
        health.swap_evaluator(old_ev)
    assert body["enabled"] and body["every_s"] == 0.05
    assert len(body["windows"]) >= 3
    assert body["slo"]["rules"] == ["cycle_rate>=1000@1w"]
    assert stats["sampling"] and stats["windows"] >= 3
    assert stats["slo"]["rules"] == 1
    # the floor's breach rode the health plane
    assert any(v["kind"] == "slo_breach" for v in ev.verdicts())


def test_failure_report_carries_windows(monkeypatch):
    """A worker's FAILURE report carries the last windows, which the
    driver renders."""
    from horovod_tpu_torch.elastic import worker
    sent = {}
    monkeypatch.setattr(worker, "_driver_endpoint", lambda: ("h", 1))
    monkeypatch.setattr(worker, "worker_id", lambda: 3)
    monkeypatch.setattr(worker, "json_request",
                        lambda a, p, n, payload, **kw: sent.update(payload))
    ring = ts.TimeSeriesRing(window=8, every_s=1.0)
    old = ts.swap_ring(ring)
    try:
        ring.sample()
        ring.sample()
        worker.record_result("FAILURE")
    finally:
        ts.swap_ring(old)
    assert [w["n"] for w in sent["timeseries"]] == [0, 1]
    assert ts.render_windows(sent["timeseries"]).count("\n") == 1
