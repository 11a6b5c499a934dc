"""The top CLI: the job's time-series, humanly.

    python -m horovod_tpu_torch.metrics.top --url http://driver:29410/timeseries/job
    python -m horovod_tpu_torch.metrics.top job.json     # saved GET /timeseries/job body
    python -m horovod_tpu_torch.metrics.top --url ... --watch 5   # live dashboard
    python -m horovod_tpu_torch.metrics.top --json job.json       # machine-readable
    python -m horovod_tpu_torch.metrics.top --smoke --device cpu  # chaos-delayed loopback plane

Counterpart: ``horovod_tpu/metrics/top.py`` (``tools/hvdtop``), copied;
the smoke runs the port's ``ServingPlane``, ``ServingWorker`` and
``toy_echo_forward`` on ``--device`` (default: the card).

Prints the per-worker table (windowed rates, serve p99, queue depth,
straggler EWMA, active SLO breaches) plus the job-level merged windowed
histograms — ``top`` for a training job: not "what has this job done
since boot" (that is ``GET /metrics/job``) but "what is it doing RIGHT
NOW", from the last N sampler windows.

``--smoke`` is the deterministic proof: a pinned ``serve.batch`` chaos
delay stretches a real loopback serving plane's batch clock; the SLO
watchdog must name the p99 rule breached WITHIN ONE WINDOW, the breach
must surface through a driver-shaped ``GET /timeseries/job`` scrape, a
clean burst must stay breach-free (and re-arm the rule), and the seed
must prove non-inert.  Exit codes: 0 no active breach, 1 active
breaches, 2 degraded (partial scrape).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

#: The pinned smoke seed: +1.2 s on every served batch's service clock
#: (no qualifiers — fires at each batch), vs a 0.5 s p99 budget over
#: one window.  1.2 s lands in the latency histogram's le=2.0 bucket,
#: 4x over budget; a clean loopback burst sits well below it (observed
#: ~0.25 s tail on a loaded CI box — queue age, not service).
SMOKE_SEED = "serve.batch action=delay:1.2"
SMOKE_RULE = "serve_p99_s<=0.5@1w"


def _load(args) -> dict:
    if args.url:
        with urllib.request.urlopen(args.url, timeout=10.0) as resp:
            return json.loads(resp.read().decode("utf-8"))
    with open(args.timeseries) as f:
        return json.load(f)


def _fmt(v, unit="", nd=2) -> str:
    if v is None:
        return "-"
    if v != v:
        return "nan"
    if v == float("inf"):
        return "inf"
    return f"{v:.{nd}f}{unit}" if isinstance(v, float) else f"{v}{unit}"


def _fmt_bytes(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    if v >= (1 << 30):
        return f"{v / (1 << 30):.1f}G"
    if v >= (1 << 20):
        return f"{v / (1 << 20):.1f}M"
    if v >= (1 << 10):
        return f"{v / (1 << 10):.1f}K"
    return f"{int(v)}B"


def render_job_timeseries(job: dict) -> str:
    """The top table over a merged ``GET /timeseries/job`` body."""
    cols = ("worker", "win", "cyc/s", "rpc/s", "srv/s", "p99", "queue",
            "kv", "strag", "breach")
    rows = [cols]
    for w in sorted(job.get("workers", {})):
        info = job["workers"][w]
        rows.append((
            w, str(info.get("windows", 0)),
            _fmt(info.get("cycle_rate")), _fmt(info.get("rpc_rate")),
            _fmt(info.get("serve_rate")),
            _fmt(info.get("serve_p99_s"), "s", 3),
            _fmt(info.get("queue_depth"), "", 0),
            _fmt_bytes(info.get("kv_bytes")),
            _fmt(info.get("straggler"), "", 3),
            ",".join(info.get("breaches", [])) or "-",
        ))
    for w, err in sorted(job.get("unreachable", {}).items()):
        rows.append((w, "-", "-", "-", "-", "-", "-", "-", "-",
                     f"unreachable: {err}"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(widths[i]) for i, c in enumerate(r))
             .rstrip() for r in rows]
    merged = job.get("merged", {})
    for fam, h in sorted(merged.get("histograms", {}).items()):
        if "error" in h:
            lines.append(f"merged {fam}: ERROR {h['error']}")
        else:
            lines.append(
                f"merged {fam}: n={h['count']} "
                f"p50<={_fmt(h['p50'], 's', 4)} "
                f"p99<={_fmt(h['p99'], 's', 4)}")
    if merged.get("rates"):
        lines.append("merged rates: " + "  ".join(
            f"{k}={v:g}/s" for k, v in sorted(merged["rates"].items())))
    breaches = job.get("slo", [])
    if breaches:
        lines.append(f"ACTIVE SLO BREACHES ({len(breaches)}):")
        lines.extend(f"  [{b.get('worker', '?')}] {b['detail']}"
                     for b in breaches)
    else:
        lines.append("no active SLO breaches")
    if job.get("unreachable"):
        lines.append(f"DEGRADED: {len(job['unreachable'])} worker(s) "
                     f"unreachable")
    return "\n".join(lines)


def _smoke(device=None) -> int:
    from .. import chaos as _chaos
    from . import jobscrape, slo as _slo, timeseries as _timeseries
    from ..runner.rpc import JsonRpcServer, json_request
    from ..serving.models import toy_echo_forward
    from ..serving.plane import ServingPlane
    from ..serving.worker import ServingWorker

    plane = ServingPlane(tick_ms=2.0, max_batch=8, seq_buckets="8,16",
                         deadline_ms=0)
    srv = JsonRpcServer(plane.rpc_handlers(), secret=None)
    worker = ServingWorker("127.0.0.1", srv.port,
                           toy_echo_forward(plane.buckets, burn_dim=32,
                                            burn_iters=1, device=device),
                           worker_id="0", wait_s=2.0, secret=None)
    worker.start()

    def burst(tag, n=8):
        for i in range(n):
            json_request("127.0.0.1", srv.port, "serve_submit",
                         {"id": f"{tag}{i}", "tokens": [i, i + 1]},
                         secret=None)
        for i in range(n):
            res = json_request("127.0.0.1", srv.port, "serve_result",
                               {"id": f"{tag}{i}", "wait_s": 30.0},
                               secret=None)
            assert res.get("done"), res

    # the first batch pays the forward's warm-up: warm up BEFORE the
    # ring takes its baseline snapshot, so the clean window measures
    # steady-state serving
    burst("warm", n=2)

    _timeseries.enable()
    ring = _timeseries.TimeSeriesRing(window=8, every_s=60.0)
    wd = _slo.Watchdog(_slo.parse_rules(SMOKE_RULE))
    old_ring = _timeseries.swap_ring(ring)
    old_wd = _slo.swap_watchdog(wd)

    try:
        # 1) clean burst: one window, zero breaches
        burst("clean")
        _timeseries.tick()
        assert not wd.snapshot()["active"], wd.snapshot()
        clean_p99 = _timeseries.hist_quantile(
            ring.windows(1), "hvd_serve_request_latency_seconds", 0.99)
        assert clean_p99 <= 0.5, (
            f"clean loopback p99 {clean_p99} already over the smoke "
            f"budget — the breach below would prove nothing")

        # 2) chaos burst: the pinned delay must breach the p99 rule
        #    WITHIN ONE WINDOW — and must not be inert
        sched = _chaos.FaultSchedule.parse(SMOKE_SEED, seed=7)
        _chaos.install(sched)
        try:
            burst("slow", n=4)
        finally:
            _chaos.uninstall()
        assert sched.fired_at("serve.batch"), (
            "delay seed was inert — no injection fired")
        fired = []
        _timeseries.tick()
        fired = wd.snapshot()["active"]
        assert [b["rule"] for b in fired] == [SMOKE_RULE], (
            f"watchdog did not name {SMOKE_RULE!r} within one window: "
            f"{wd.snapshot()}")

        # 3) the breach surfaces through a driver-shaped
        #    GET /timeseries/job scrape (this worker's default
        #    /timeseries route + one synthetic quiet worker)
        wsrv = JsonRpcServer({}, secret=None)   # serves /timeseries

        def _quiet():
            return (200, "application/json", json.dumps(
                {"enabled": True, "pid": 0, "every_s": 60.0,
                 "window": 8, "closed": 1, "windows": [
                     {"n": 0, "wall": 0.0, "dur_s": 60.0,
                      "counters": {}, "gauges": {}, "histograms": {}}]}))

        qsrv = JsonRpcServer({}, secret=None,
                             get_routes={"timeseries": _quiet})
        endpoints = {"0": ("127.0.0.1", wsrv.port),
                     "1": ("127.0.0.1", qsrv.port)}
        scraper = jobscrape.JobScraper(lambda: endpoints)
        driver = JsonRpcServer({}, secret=None,
                               get_routes=scraper.routes())
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{driver.port}/timeseries/job",
                    timeout=10.0) as resp:
                job = json.loads(resp.read().decode())
        finally:
            for s in (wsrv, qsrv, driver):
                s.close()
        assert job["scraped"] >= 2, job["scraped"]
        assert not job["unreachable"], job["unreachable"]
        named = [b for b in job["slo"] if b["rule"] == SMOKE_RULE]
        assert named, job["slo"]
        merged = job["merged"]["histograms"][
            "hvd_serve_request_latency_seconds"]
        assert merged["p99"] > 0.5, merged

        # 4) a clean burst recovers and RE-ARMS the rule (episodes,
        #    not a latched alarm)
        burst("recover")
        _timeseries.tick()
        assert not wd.snapshot()["active"], wd.snapshot()

        print(render_job_timeseries(job))
        print(f"top smoke OK: clean burst breach-free "
              f"(p99 {clean_p99:g}s), seed {SMOKE_SEED!r} fired and "
              f"breached {SMOKE_RULE!r} within one window, surfaced "
              f"via GET /timeseries/job ({job['scraped']} workers "
              f"merged), rule re-armed after recovery")
        return 0
    finally:
        _timeseries.swap_ring(old_ring)
        _slo.swap_watchdog(old_wd)
        plane.close()
        worker.stop()
        worker.join(10)
        srv.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.metrics.top",
        description="per-worker time-series dashboard over "
                    "GET /timeseries/job output")
    ap.add_argument("timeseries", nargs="?",
                    help="merged job time-series JSON file")
    ap.add_argument("--url", help="scrape the job view from a URL (e.g. "
                                  "http://driver:29410/timeseries/job)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the merged object as JSON")
    ap.add_argument("--watch", type=float, nargs="?", const=5.0,
                    metavar="SECS",
                    help="refresh the dashboard every SECS (default 5)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: pinned serve.batch delay on a "
                         "loopback plane must breach the p99 SLO")
    ap.add_argument("--device", default=None,
                    help="the smoke forward's device (default: the "
                         "card; 'cpu' to run without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.device)
    if not args.timeseries and not args.url:
        ap.error("a time-series file or --url is required")
    if args.watch:
        if not args.url:
            ap.error("--watch needs --url (a file never changes)")
        try:
            while True:
                job = _load(args)
                # clear + home, then the fresh table (plain ANSI — no
                # curses dependency for a dashboard this small)
                sys.stdout.write("\x1b[2J\x1b[H")
                print(time.strftime("%H:%M:%S"), args.url)
                print(render_job_timeseries(job))
                sys.stdout.flush()
                time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0
    job = _load(args)
    if args.as_json:
        json.dump(job, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        print(render_job_timeseries(job))
    if job.get("slo"):
        return 1
    return 2 if job.get("unreachable") else 0


if __name__ == "__main__":
    sys.exit(main())
