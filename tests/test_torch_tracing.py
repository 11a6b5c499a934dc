"""The port's job-wide tracer against the JAX package's.

The span buffer, the clock-offset estimate, the merged Chrome trace, the
critical-path report and the hvdtrace CLI are the JAX package's code
(``horovod_tpu/tracing/``), copied: each case runs the same inputs
through both and compares the outputs exactly.  Then the port's own
sites: the engine's spans from a world-2 gloo job
(``tests/torch_ranks.py`` ``case_tracing``), the tail round's ``dcn``
span, the ``/trace`` route, ``hvd.start_profiler``'s ranges from the
engine thread, and the elastic driver's ``GET /trace/job`` with one
worker unreachable.  Last the port's own step spans (``tracing/steps.py``):
the data-parallel Llama step at worlds 1 and 2 and the BERT step, tracing
off, the profiler's ranges, the collector hook and the shared clock.  Waits on a clock carry their own bounds (the
scrape's budget, ``urlopen``'s timeout), well above what they need.
"""

import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest
import torch

import horovod_tpu.tracing as jtracing
from horovod_tpu.tracing import critical as jcritical
from horovod_tpu.tracing import merge as jmerge
from horovod_tpu.tracing.span import SpanBuffer as JSpanBuffer
from horovod_tpu_torch import tracing
from horovod_tpu_torch.runner.rpc import JsonRpcServer
from horovod_tpu_torch.tracing import critical, merge
from horovod_tpu_torch.tracing.span import SpanBuffer

import torch_ranks as tr

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "traces" / "chaos_4proc.trace.json"


def _both(capacity, **kw):
    return (JSpanBuffer(capacity=capacity, **kw),
            SpanBuffer(capacity=capacity, **kw))


def _strip(snap):
    """A snapshot without its clock sample (taken at another instant on
    each side)."""
    return {k: v for k, v in snap.items() if k != "now"}


# ---------------------------------------------------------------------------
# the span buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,n", [(4, 7), (8, 3), (0, 5), (-2, 5)])
def test_buffer_ring_bound_and_drops_match_jax(capacity, n):
    """The ring keeps the newest ``capacity`` spans and counts the rest
    dropped; a non-positive capacity degrades to the default."""
    jb, tb = _both(capacity, host="h", process=0)
    for b in (jb, tb):
        for i in range(n):
            b.add("dispatch", f"s{i}", float(i), i + 0.5, bytes=i)
    assert _strip(tb.snapshot()) == _strip(jb.snapshot())
    assert tb.capacity == jb.capacity
    assert tracing.DEFAULT_CAPACITY == jtracing.DEFAULT_CAPACITY == 4096
    assert tracing.PHASES == jtracing.PHASES


def test_buffer_tags_match_jax():
    """Identity (host, process, epoch) and context (round, cycle, group)
    tag every span; an explicit round or group wins."""
    jb, tb = _both(8, host="h9", process=3)
    for b in (jb, tb):
        b.set_identity(epoch=5)
        b.set_context(round=17, cycle=4, group="g1")
        b.add("negotiate", "round17", 1.0, 2.0, kind="fast")
        b.add("overlap", "stage", 1.0, 1.1, round=-1, group="")
        b.set_identity(process=1, host="h2")
    assert _strip(tb.snapshot()) == _strip(jb.snapshot())
    s1, s2 = tb.snapshot()["spans"]
    assert (s1["round"], s1["epoch"], s1["cycle"], s1["group"]) == \
        (17, 5, 4, "g1")
    assert (s2["round"], s2["group"]) == (-1, "")


def test_buffer_set_capacity_keeps_newest_as_jax():
    jb, tb = _both(8)
    for b in (jb, tb):
        for i in range(6):
            b.add("cycle", f"c{i}", float(i), i + 1.0)
        b.set_capacity(2)
    assert _strip(tb.snapshot()) == _strip(jb.snapshot())
    assert [s["name"] for s in tb.snapshot()["spans"]] == ["c4", "c5"]
    for b in (jb, tb):
        b.set_capacity(16)
        b.add("cycle", "c6", 9.0, 10.0)
    assert len(tb) == len(jb) == 3


def test_pull_handler_probe_and_full_as_jax():
    kw = dict(host="hp", process=2, clock=lambda: 123.25)
    jb, tb = _both(8, **kw)
    for b in (jb, tb):
        b.add("dcn", "grad", 1.0, 2.0, policy="bounded")
    for payload in ({"probe": True}, {}):
        assert tb.pull_handler()(payload) == jb.pull_handler()(payload)
    assert tb.pull_handler()({"probe": True}) == {
        "now": 123.25, "host": "hp", "process": 2}


def test_init_from_env_reads_the_knobs_as_jax():
    """HOROVOD_TRACE (default on), HOROVOD_TRACE_BUFFER (default 4096, a
    malformed value the default) and HOROVOD_TRACE_PROBES (default 3, at
    least 1)."""
    old_cap = tracing.buffer().capacity
    try:
        for env in ({"HOROVOD_TRACE": "0", "HOROVOD_TRACE_BUFFER": "7"},
                    {"HOROVOD_TRACE": "1", "HOROVOD_TRACE_BUFFER": "x"},
                    {}):
            tracing.init_from_env(env)
            assert tracing.ACTIVE == (env.get("HOROVOD_TRACE") != "0")
            assert tracing.buffer().capacity == (
                7 if env.get("HOROVOD_TRACE_BUFFER") == "7" else 4096)
        for raw in ("5", "0", "-1", "x", ""):
            env = {"HOROVOD_TRACE_PROBES": raw}
            assert tracing.probes(env) == jtracing.probes(env)
    finally:
        tracing.init_from_env({"HOROVOD_TRACE_BUFFER": str(old_cap)})
    assert tracing.ACTIVE


# ---------------------------------------------------------------------------
# the clock offset (midpoint method) with injected clocks
# ---------------------------------------------------------------------------

class _Clocked:
    """A ``json_request`` stand-in for a worker whose span clock runs
    ``skew`` seconds ahead of this process's; each call sleeps its
    request and reply legs (``legs`` pops (request, reply) seconds)
    around the worker's clock sample."""

    def __init__(self, skew, legs):
        self.skew, self.legs = skew, list(legs)

    def __call__(self, addr, port, name, payload, **kw):
        pre, post = self.legs.pop(0) if self.legs else (0.0, 0.0)
        time.sleep(pre)
        now = time.monotonic() + self.skew
        time.sleep(post)
        assert name == "trace_pull"
        return {"now": now, "host": "w", "process": 0, "spans": []}


@pytest.mark.parametrize("skew,legs", [
    (4.5, [(0.0, 0.0)] * 3),
    (-2.25, [(0.02, 0.0), (0.0, 0.0), (0.0, 0.02)]),
    (3.0, [(0.05, 0.0)] * 2),
    (3.0, [(0.0, 0.05)] * 2),
])
def test_offset_estimate_lands_within_its_rtt_bound(skew, legs):
    """The true offset is the injected skew; the estimate from the probe
    of least RTT lies within that probe's RTT/2, however asymmetric its
    legs; both packages estimate alike from the same replies."""
    for mod in (merge, jmerge):
        offset, err = mod.estimate_offset(
            "127.0.0.1", 1, probes=len(legs), _request=_Clocked(skew, legs))
        assert abs(offset - skew) <= err + 1e-9
        if all(p == q == 0.0 for p, q in legs):
            assert err < 0.05
        else:
            assert err >= min(p + q for p, q in legs) / 2 - 1e-3


def test_offset_estimate_over_a_real_server():
    buf = SpanBuffer(host="skewed", clock=lambda: time.monotonic() + 7.0)
    srv = JsonRpcServer({"trace_pull": buf.pull_handler()}, secret=None,
                        host="127.0.0.1")
    try:
        offset, err = merge.estimate_offset("127.0.0.1", srv.port,
                                            probes=3, secret=None)
        snap, off2, err2 = merge.pull_worker("127.0.0.1", srv.port,
                                             probes=2, secret=None)
    finally:
        srv.close()
    assert abs(offset - 7.0) <= err + 1e-9 and err < 0.5
    assert abs(off2 - 7.0) <= err2 + 1e-9 and snap["host"] == "skewed"


# ---------------------------------------------------------------------------
# the merged trace and the critical path, on the same records
# ---------------------------------------------------------------------------

def _snap(host, process, spans, now=100.0, dropped=0):
    return {"host": host, "process": process, "epoch": 0,
            "dropped": dropped, "capacity": 64, "now": now,
            "spans": [dict(s, seq=i + 1) for i, s in enumerate(spans)]}


def _span(cat, name, t0, t1, round=0, epoch=0, group="", **args):
    return {"cat": cat, "name": name, "t0": t0, "t1": t1, "round": round,
            "group": group, "epoch": epoch, "cycle": round, "args": args}


def _workers():
    """Two hosts, hostB's clock 10 s ahead and its two processes on one
    pid; rounds 0 and 1 gated by hostB's dispatch and dcn."""
    wa = _snap("hostA", 0, [
        _span("submit", "c1", 50.0, 50.01), _span("negotiate", "r0", 50.01,
                                                  50.02, kind="full"),
        _span("dispatch", "g", 50.02, 50.03, op="allreduce", bytes=16),
        _span("dcn", "g", 50.03, 50.05, excluded=[1], policy="bounded"),
        _span("cycle", "c1", 50.0, 50.06, round=-1),
        _span("dispatch", "h", 51.0, 51.01, round=1)])
    wb = _snap("hostB", 1, [
        _span("submit", "c1", 60.0, 60.02), _span("negotiate", "r0", 60.02,
                                                  60.025),
        _span("dispatch", "g", 60.025, 60.08, op="allreduce", bytes=16),
        _span("dispatch", "h", 61.0, 61.3, round=1)], dropped=2)
    wc = _snap("hostB", 2, [_span("dcn", "g", 60.08, 60.2, excluded=[1])])
    return {"0": (wa, 0.0, 0.001), "1": (wb, 10.0, 0.002),
            "2": (wc, 10.0, 0.0025)}


def test_chrome_trace_on_the_same_records_equals_jax():
    workers = _workers()
    got = merge.chrome_trace(workers, unreachable={"3": OSError("down")})
    want = jmerge.chrome_trace(workers, unreachable={"3": OSError("down")})
    assert got == want
    json.dumps(got)
    pids = {e["args"]["name"]: e["pid"] for e in got["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "process_name"}
    assert set(pids) == {"hostA", "hostB"}
    assert got["otherData"]["unreachable"] == {"3": "down"}
    assert got["otherData"]["clock"]["1"]["dropped"] == 2


def test_local_trace_equals_jax():
    jb, tb = _both(8, host="solo", process=4)
    for b in (jb, tb):
        b.add("cycle", "cycle1", 0.5, 0.6, round=1)
        b.add("fuse", "plan[2]", 0.51, 0.52, round=1, buckets=1)
    assert merge.local_trace(tb) == jmerge.local_trace(jb)


def test_critical_path_on_the_same_records_equals_jax():
    trace = merge.chrome_trace(_workers())
    got, want = critical.analyze(trace), jcritical.analyze(trace)
    assert got == want
    assert got["top"][0] == "hostB" and got["rounds"] == 2
    assert critical.render_table(got) == jcritical.render_table(want)


def test_critical_path_on_the_recorded_fixture_equals_jax():
    """The recorded 4-host chaos trace (read-only): the same report and
    table, and the injected straggler named the critical-path host."""
    trace = json.loads(FIXTURE.read_text())
    got = critical.analyze(trace)
    assert got == jcritical.analyze(trace)
    assert critical.round_spans(trace) == jcritical.round_spans(trace)
    assert critical.render_table(got, top=3) == \
        jcritical.render_table(got, top=3)
    assert got["top"][0] == trace["otherData"]["chaos"]["injected_host"]


def test_hvdtrace_cli_smoke_table_and_json(tmp_path):
    """``python -m horovod_tpu_torch.tracing``: --smoke over the fixture,
    the table of a saved trace, --json equal to JAX's report."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    mod = [sys.executable, "-m", "horovod_tpu_torch.tracing"]
    res = subprocess.run(mod + ["--smoke"], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "hvdtrace smoke OK" in res.stdout and "host1" in res.stdout
    res = subprocess.run(mod + [str(FIXTURE)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "critical-path host: host1" in res.stdout
    res = subprocess.run(mod + ["--json", str(FIXTURE)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(res.stdout) == json.loads(json.dumps(
        jcritical.analyze(json.loads(FIXTURE.read_text()))))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    res = subprocess.run(mod + [str(empty)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 2 and "no round spans" in res.stdout


# ---------------------------------------------------------------------------
# the port's own sites
# ---------------------------------------------------------------------------

def test_tail_round_records_a_dcn_span_with_its_exclusions():
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.ops.collectives import tail_round
    buf = SpanBuffer(host="unit", process=0)
    buf.set_context(round=7)
    old = tracing.swap_buffer(buf)
    chaos.install(chaos.FaultSchedule.parse(
        "collective.dcn group=1 nth=1 action=delay:0.2", seed=3))
    try:
        present = tail_round("unit_bucket", "bounded", 2, 0.05)
    finally:
        chaos.uninstall()
        tracing.swap_buffer(old)
    assert list(present) == [1.0, 0.0]
    (span,) = buf.snapshot()["spans"]
    assert span["cat"] == "dcn" and span["round"] == 7
    assert span["args"]["policy"] == "bounded"
    assert span["args"]["excluded"] == [1]
    assert span["args"]["deadline_s"] == pytest.approx(0.05)
    assert span["args"]["lateness"][1] == pytest.approx(0.2)
    # the round waited out the deadline, not the straggler
    assert 0.04 <= span["t1"] - span["t0"] <= 0.15


def test_trace_route_serves_the_buffer():
    from horovod_tpu_torch.metrics import aggregate
    buf = SpanBuffer(host="solo", process=0)
    buf.add("cycle", "cycle1", 0.0, 0.1, round=1)
    old = tracing.swap_buffer(buf)
    try:
        srv = JsonRpcServer({}, secret=None, host="127.0.0.1")
        try:
            raw = aggregate.scrape("127.0.0.1", srv.port, route="trace")
        finally:
            srv.close()
    finally:
        tracing.swap_buffer(old)
    trace = json.loads(raw)
    assert trace == merge.local_trace(buf)
    assert trace["otherData"]["hosts"] == ["solo"]


@pytest.fixture(scope="module")
def traced_world(tmp_path_factory):
    return tr.launch(2, ["tracing", "step_spans"],
                     tmp_path_factory.mktemp("trace2"))


def test_engine_spans_of_a_world_2_job(traced_world):
    """Each rank's buffer after 3 grouped allreduces: one span of each
    phase a cycle that dispatched (cycle, submit, negotiate, fuse) and one
    dispatch a bucket, matching the engine's counters; every phase span
    of a cycle carries its negotiated round and group, the same on both
    ranks, and the dispatch span the bucket's vocabulary."""
    rounds = []
    for rank, res in enumerate(traced_world):
        r = res["tracing"]
        spans = r["snapshot"]["spans"]
        by = {}
        for s in spans:
            by.setdefault(s["cat"], []).append(s)
        assert r["snapshot"]["host"] == f"host{rank}"
        assert r["snapshot"]["process"] == rank
        assert len(by["cycle"]) == r["cycles"]
        assert len(by["fuse"]) == len(by["submit"]) == r["executes"] == 3
        assert len(by["dispatch"]) == r["buckets"]
        assert len(by["negotiate"]) >= 3
        phase = by["submit"] + by["fuse"] + by["dispatch"]
        assert all(s["round"] >= 0 and s["group"].startswith("g")
                   for s in phase)
        disp = by["dispatch"][0]["args"]
        assert (disp["op"], disp["wire_format"], disp["tail_policy"]) == \
            ("allreduce", "none", "strict")
        assert disp["bytes"] == 4 * 4 + 3 * 4
        rounds.append(sorted((s["round"], s["group"])
                             for s in by["dispatch"]))
    assert rounds[0] == rounds[1]
    # merged, the two ranks are two hosts, every round on the critical
    # path of both
    workers = {str(r): (res["tracing"]["snapshot"], 0.0, 0.0)
               for r, res in enumerate(traced_world)}
    trace = merge.chrome_trace(workers)
    assert trace["otherData"]["hosts"] == ["host0", "host1"]
    report = critical.analyze(trace)
    assert report == jcritical.analyze(trace)
    assert report["rounds"] == len(rounds[0])


def test_start_profiler_captures_the_engine_threads_ranges(tmp_path):
    """``hvd.start_profiler``/``stop_profiler`` at world 1 on the CPU:
    the trace file holds one ``hvd.allreduce[n]`` range a dispatch, from
    the engine's thread."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        hvd.allreduce(torch.ones(3), name="warm")
        hvd.start_profiler(str(tmp_path / "prof"))
        with pytest.raises(RuntimeError, match="already running"):
            hvd.start_profiler(str(tmp_path / "prof"))
        for i in range(3):
            hvd.grouped_allreduce([torch.ones(4), torch.ones(2)],
                                  name=f"p{i}")
        path = hvd.stop_profiler()
        with pytest.raises(RuntimeError, match="no capture"):
            hvd.stop_profiler()
    finally:
        hvd.shutdown()
    names = [e.get("name") for e in json.loads(
        pathlib.Path(path).read_text())["traceEvents"]]
    assert names.count("hvd.allreduce[2]") == 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_elastic_driver_trace_job_with_a_worker_unreachable():
    """The port's ElasticDriver serves GET /trace/job: the registered
    workers' buffers pulled over signed trace_pull RPCs and merged, one
    pid a host, each span's clock-error bound recorded; a registered
    endpoint nothing listens on is named in ``unreachable`` within the
    scrape's budget instead of hanging the route.  health/job and
    timeseries/job answer too, the gone endpoint unreachable in each."""
    import urllib.request
    from horovod_tpu_torch.elastic import discovery
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    driver = ElasticDriver(discovery.FixedHostDiscovery({"localhost": 1}),
                           ["true"], min_np=1, port=_free_port())
    bufs = []
    for h in range(2):
        b = SpanBuffer(host=f"host{h}", process=h,
                       clock=lambda h=h: time.monotonic() + 4.0 * h)
        t = b.now()
        b.set_context(round=0, group="g")
        b.add("negotiate", "round0", t - 0.2, t - 0.1)
        b.add("dispatch", "grad", t - 0.1, t - 0.05 + 0.3 * h)
        bufs.append(b)
    # the workers' servers verify the job secret the driver minted
    workers = [JsonRpcServer({"trace_pull": b.pull_handler()},
                             host="127.0.0.1") for b in bufs]
    try:
        with driver._lock:
            for i, s in enumerate(workers):
                driver._notif[i] = ("127.0.0.1", s.port)
            driver._notif[2] = ("127.0.0.1", _free_port())   # gone
        t0 = time.monotonic()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{driver.port}/trace/job",
                timeout=60.0) as resp:
            trace = json.loads(resp.read().decode())
        seconds = time.monotonic() - t0
        codes = []
        for route in ("health/job", "timeseries/job"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{driver.port}/{route}",
                    timeout=60) as resp:
                codes.append((resp.status, "2" in json.loads(
                    resp.read().decode())["unreachable"]))
    finally:
        driver._server.close()
        for s in workers:
            s.close()
    assert sorted(trace["otherData"]["hosts"]) == ["host0", "host1"]
    assert list(trace["otherData"]["unreachable"]) == ["2"]
    # the scrape's budget: 2 s a try, (probes + 1) tries, plus 1 s
    assert seconds < 2.0 * (tracing.probes() + 1) + 1.0 + 5.0
    clock = trace["otherData"]["clock"]
    assert abs(clock["1"]["offset_s"] - 4.0) <= clock["1"]["err_s"] + 1e-6
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert spans and all(e["args"]["clock_err_us"] >= 0 for e in spans)
    assert critical.analyze(trace)["top"][0] == "host1"
    assert codes == [(200, True), (200, True)]


# ---------------------------------------------------------------------------
# the step spans (the port's own)
# ---------------------------------------------------------------------------

PHASE_NAMES = ["backward", "exchange", "forward", "optimizer"]


def _tiny_llama_step(**kw):
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=64,
                            max_seq_len=16, dtype=torch.float32,
                            param_dtype=torch.float32)
    ts = training.make_llama_train_step(cfg, device="cpu", **kw)
    params, opt = ts.init_fn(0)
    toks = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                         .manual_seed(0))
    return lambda: ts.step_fn(params, opt, toks, toks)[2]


def _tiny_bert():
    from horovod_tpu_torch.models import bert
    cfg = bert.BertConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_seq_len=16, num_labels=4,
                          dtype=torch.float32, param_dtype=torch.float32)
    ts = bert.make_dp_finetune_step(cfg, bert.finetune_optimizer,
                                    reduce_grads=True, device="cpu")
    params, opt = ts.init_fn(0)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 64, (4, 16), generator=gen)
    labels = torch.randint(0, 4, (4,), generator=gen)
    return ts, params, opt, toks, labels


def _await_cycles(eng, c0):
    """The cycle span closes after the handles resolve: wait for it."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and sum(
            s["cat"] == "cycle" for s in tracing.buffer().snapshot()[
                "spans"]) < eng.stats()["cycles"] - c0:
        time.sleep(0.01)


def _assert_step_spans(spans, n, phases=PHASE_NAMES):
    """``n`` step spans, each with its phases nested inside it and naming
    it their parent, and the engine's spans of its entries carrying its
    id."""
    steps = [s for s in spans if s["cat"] == "step" and s["name"] == "step"]
    assert len(steps) == n
    assert len({s["args"]["step"] for s in steps}) == n
    for st in steps:
        sid, a = st["args"]["step"], st["args"]
        assert st["round"] == -1 and a["profiled"] is False
        assert a["wait_ms"] >= 0 and a["queue_ms"] > 0 and a["gc_ms"] >= 0
        kids = [s for s in spans if s["cat"] == "step"
                and s["args"].get("parent") == sid]
        assert sorted(k["name"] for k in kids) == phases
        assert all(st["t0"] <= k["t0"] <= k["t1"] <= st["t1"] for k in kids)
        mine = {s["cat"] for s in spans if s["args"].get("step") == sid
                and s["cat"] not in ("step", "gc")}
        assert {"submit", "cycle", "fuse", "dispatch"} <= mine
    return steps


def test_llama_step_spans_at_world_1():
    """One ``step`` span a call of the data-parallel Llama step, with its
    four phases and its engine spans; the engine counts the waits and the
    queue."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        step = _tiny_llama_step()
        eng = hvd.runtime._state().engine
        tracing.buffer().clear()
        c0, st0 = eng.stats()["cycles"], eng.stats()
        for _ in range(3):
            step()
        _await_cycles(eng, c0)
        st1 = eng.stats()
        spans = tracing.buffer().snapshot()["spans"]
    finally:
        hvd.shutdown()
    steps = _assert_step_spans(spans, 3)
    assert st1["queue_ms"] > st0["queue_ms"]
    assert st1["wait_ms"] - st0["wait_ms"] >= sum(
        s["args"]["wait_ms"] for s in steps) - 1e-6


def test_llama_step_spans_at_world_2(traced_world):
    """The same on two gloo ranks: each rank's two steps."""
    for res in traced_world:
        _assert_step_spans(res["step_spans"]["snapshot"]["spans"], 2)


def test_bert_step_and_grads_spans():
    """BERT's ``step_fn`` and ``grads_fn`` record one step span a call;
    ``grads_fn`` has no optimizer phase."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        ts, params, opt, toks, labels = _tiny_bert()
        eng = hvd.runtime._state().engine
        tracing.buffer().clear()
        c0 = eng.stats()["cycles"]
        ts.step_fn(params, opt, toks, labels)
        ts.step_fn(params, opt, toks, labels)
        _await_cycles(eng, c0)
        stepped = tracing.buffer().snapshot()["spans"]
        tracing.buffer().clear()
        c0 = eng.stats()["cycles"]
        ts.grads_fn(params, toks, labels)
        _await_cycles(eng, c0)
        graded = tracing.buffer().snapshot()["spans"]
    finally:
        hvd.shutdown()
    _assert_step_spans(stepped, 2)
    _assert_step_spans(graded, 1, ["backward", "exchange", "forward"])


def _losses(n=3):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        step = _tiny_llama_step()
        tracing.buffer().clear()
        return [step().item() for _ in range(n)], \
            len(tracing.buffer()), tracing.ACTIVE
    finally:
        hvd.shutdown()


def test_trace_off_records_nothing_and_the_losses_are_bitwise(monkeypatch):
    on, n_on, active_on = _losses()
    monkeypatch.setenv("HOROVOD_TRACE", "0")
    try:
        off, n_off, active_off = _losses()
    finally:
        monkeypatch.delenv("HOROVOD_TRACE")
        tracing.init_from_env()
    assert active_on and not active_off
    assert n_on > 0 and n_off == 0
    assert on == off


def test_off_the_profiler_no_range_is_entered(monkeypatch):
    """No ``record_function`` is built by a step or its engine dispatch
    while no profiler records."""
    import horovod_tpu_torch as hvd
    built = []

    def record_function(name, *a, **kw):
        built.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    hvd.init(device="cpu")
    try:
        step = _tiny_llama_step()
        step()
    finally:
        hvd.shutdown()
    assert built == []


def test_a_collection_inside_a_step_is_a_gc_span():
    import gc
    import horovod_tpu_torch as hvd

    class Collecting(torch.optim.AdamW):
        def step(self, closure=None):
            gc.collect(0)
            gc.collect()
            return super().step(closure)
    hvd.init(device="cpu")
    try:
        step = _tiny_llama_step(optimizer=lambda ps: Collecting(ps, lr=1e-3))
        tracing.buffer().clear()
        step()
        spans = tracing.buffer().snapshot()["spans"]
    finally:
        hvd.shutdown()
    (st,) = [s for s in spans if s["cat"] == "step" and s["name"] == "step"]
    full = [s for s in spans if s["cat"] == "gc"
            and s["args"]["generation"] == 2
            and s["args"].get("step") == st["args"]["step"]]
    assert full and all(st["t0"] <= s["t0"] <= st["t1"] for s in full)
    # the young generation's collections are timed, not spanned
    assert not [s for s in spans if s["cat"] == "gc"
                and s["args"]["generation"] == 0]
    assert st["args"]["gc_ms"] > 0
    assert st["args"]["gc_ms"] >= 1e3 * sum(s["t1"] - s["t0"]
                                           for s in full) - 1e-6
    assert tracing.steps._on_gc not in gc.callbacks


def test_profiler_range_and_ring_span_share_one_clock(tmp_path):
    """Under ``hvd.start_profiler`` the step is an ``hvd.step`` range and a
    ``step`` span marked profiled; in the written trace the two start
    within 1 ms of each other, and the phases' ranges are there too."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        step = _tiny_llama_step()
        step()
        hvd.start_profiler(str(tmp_path / "prof"))
        step()
        path = hvd.stop_profiler()
    finally:
        hvd.shutdown()
    events = [e for e in json.loads(pathlib.Path(path).read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if e["name"] == "hvd.step"
              and e.get("cat") == "user_annotation"]
    spans = [e for e in events if e["name"] == "step"
             and e.get("cat") == "step"]
    assert len(ranges) == len(spans) == 1
    assert spans[0]["args"]["profiled"] is True
    assert abs(ranges[0]["ts"] - spans[0]["ts"]) < 1000.0
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {f"hvd.{p}" for p in PHASE_NAMES} <= names


def test_anchor_maps_the_buffer_clock_onto_the_epoch():
    clock = [100.0]
    buf = SpanBuffer(clock=lambda: clock[0])
    mono, unix = buf.anchor
    assert mono == 100.0 and abs(unix - time.time_ns()) < 5e9
    assert buf.unix_ns(101.5) == unix + 1_500_000_000
    assert "anchor" not in buf.snapshot()
