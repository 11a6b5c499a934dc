"""The doctor CLI: the job health verdict, humanly.

    python -m horovod_tpu_torch.health --url http://driver:29410/health/job
    python -m horovod_tpu_torch.health health.json            # saved GET /health/job body
    python -m horovod_tpu_torch.health --json health.json     # machine-readable
    python -m horovod_tpu_torch.health health.json --trace trace.json  # cross-ref
    python -m horovod_tpu_torch.health --smoke --device cpu   # chaos-corrupted transform

Counterpart: ``horovod_tpu/health/__main__.py`` (``tools/hvddoctor``),
copied; the smoke drives the port's ``DistributedGradientTransform`` in
place of JAX's pmapped ``DistributedOptimizer``.

Prints the verdict table (step, kind, worker, bucket, detail), the
per-worker health rows, and cross-references the stall inspector's
straggler EWMA (carried in the snapshots) and — with ``--trace`` /
``--trace-url`` — the job trace's critical-path host
(``tracing.critical``), so one command answers "is this job healthy,
and if not, who and what".

``--smoke`` is the deterministic proof: a world of one (``hvd.init`` on
``--device``, default the card) runs ``DistributedGradientTransform(
health=True)`` clean, then under a pinned ``collective.corrupt`` seed
that NaNs this rank's contribution to one fusion bucket; the evaluator
must name exactly that (rank, bucket), the verdict must surface through
a driver-shaped ``GET /health/job`` scrape, and the clean run must stay
verdict-free.  Exit codes: 0 healthy, 1 unhealthy, 2 degraded (partial
scrape).
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

#: The pinned smoke seed: NaN rank 0's contribution to fusion bucket 1
#: at every update (JAX bakes its trace-time rule into every step of the
#: compiled program; an eager rule with ``nth=1`` would corrupt one
#: update, and the next clean one would clear the condition).
SMOKE_SEED = "collective.corrupt bucket=1 action=nan:0"
SMOKE_RANK, SMOKE_BUCKET = 0, 1


def _load(args) -> dict:
    if args.url:
        with urllib.request.urlopen(args.url, timeout=10.0) as resp:
            return json.loads(resp.read().decode("utf-8"))
    with open(args.health) as f:
        return json.load(f)


def _cross_reference_trace(args) -> str:
    from ..tracing import critical
    if args.trace_url:
        with urllib.request.urlopen(args.trace_url, timeout=10.0) as r:
            trace = json.loads(r.read().decode("utf-8"))
    else:
        with open(args.trace) as f:
            trace = json.load(f)
    report = critical.analyze(trace)
    if not report.get("rounds"):
        return "trace cross-ref: no analyzable rounds"
    host, frac = report["top"]
    return (f"trace cross-ref: critical-path host {host} "
            f"({frac:.1%} of attributed time over "
            f"{report['rounds']} round(s))")


def _smoke(device=None) -> int:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from .. import chaos as _chaos
    from . import render_job_health, scrape_job_health, swap_evaluator
    from .evaluate import HealthEvaluator
    from ..runner.rpc import JsonRpcServer

    # two fusion buckets at this threshold: 'a' (140 B) alone in bucket
    # 0, 'b' (12 B) in bucket 1 — the seed targets bucket 1
    init = {"a": np.linspace(-1, 1, 35).reshape(7, 5).astype(np.float32),
            "b": np.arange(3, dtype=np.float32)}
    grads = {"a": np.sin(np.arange(35, dtype=np.float32)).reshape(7, 5),
             "b": np.full((3,), 1.0, np.float32)}

    def run(dev, steps=3):
        params = {k: torch.tensor(v, device=dev) for k, v in init.items()}
        tx = hvd.DistributedGradientTransform(
            lambda ps: torch.optim.SGD(ps, lr=1e-2), threshold_bytes=64,
            health=True, health_check_every=2)
        state = tx.init(params)
        for _ in range(steps):
            g = {k: torch.tensor(v, device=dev) for k, v in grads.items()}
            state = tx.update(g, state, params)

    hvd.init(device=device)
    try:
        dev = hvd.runtime._state().device
        # 1) clean run: taps on, zero verdicts
        clean_ev = HealthEvaluator()
        old = swap_evaluator(clean_ev)
        try:
            run(dev)
        finally:
            swap_evaluator(old)
        assert clean_ev.healthy, clean_ev.verdicts()
        assert clean_ev.summary()["last_step"] >= 3, clean_ev.summary()

        # 2) corrupt run: the pinned seed must be flagged with exact
        #    (rank, bucket) attribution — and must not be inert
        sched = _chaos.FaultSchedule.parse(SMOKE_SEED, seed=7)
        corrupt_ev = HealthEvaluator()
        old = swap_evaluator(corrupt_ev)
        _chaos.install(sched)
        try:
            run(dev, steps=2)
        finally:
            _chaos.uninstall()
            swap_evaluator(old)
    finally:
        hvd.shutdown()
    assert sched.fired_at("collective.corrupt"), (
        "corruption seed was inert — no injection fired")
    verdicts = corrupt_ev.verdicts()
    hits = [v for v in verdicts if v["kind"] == "nonfinite"
            and v["worker"] == SMOKE_RANK and v["bucket"] == SMOKE_BUCKET]
    assert hits, (
        f"evaluator did not name the injected (rank {SMOKE_RANK}, "
        f"bucket {SMOKE_BUCKET}): {verdicts}")

    # 3) the verdict surfaces through the driver-shaped GET /health/job
    #    scrape (one real worker, one synthetic healthy one)
    healthy_ev = HealthEvaluator()
    healthy_ev.process, healthy_ev.host = 1, "smoke-hostB"
    srv0 = JsonRpcServer({"health_pull":
                          lambda p: corrupt_ev.snapshot()}, secret=None)
    srv1 = JsonRpcServer({"health_pull":
                          lambda p: healthy_ev.snapshot()}, secret=None)
    endpoints = {"0": ("127.0.0.1", srv0.port),
                 "1": ("127.0.0.1", srv1.port)}

    def route():
        job = scrape_job_health(endpoints, secret=None)
        return (200, "application/json", json.dumps(job))

    driver = JsonRpcServer({}, secret=None,
                           get_routes={"health/job": route})
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{driver.port}/health/job",
                timeout=10.0) as resp:
            job = json.loads(resp.read().decode())
    finally:
        for s in (srv0, srv1, driver):
            s.close()
    assert job["verdict"] == "unhealthy", job["verdict"]
    assert job["scraped"] == 2, job
    named = [v for v in job["verdicts"] if v["kind"] == "nonfinite"
             and v["worker"] == SMOKE_RANK
             and v["bucket"] == SMOKE_BUCKET]
    assert named, job["verdicts"]
    print(render_job_health(job))
    print(f"doctor smoke OK: clean run verdict-free; seed "
          f"{SMOKE_SEED!r} flagged as nonfinite at (rank {SMOKE_RANK}, "
          f"bucket {SMOKE_BUCKET}) and surfaced via GET /health/job "
          f"({job['scraped']} workers merged)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.health",
        description="job health verdict table over GET /health/job "
                    "output")
    ap.add_argument("health", nargs="?",
                    help="merged job-health JSON file")
    ap.add_argument("--url", help="scrape the verdict from a URL (e.g. "
                                  "http://driver:29410/health/job)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the merged object as JSON")
    ap.add_argument("--top", type=int, default=16,
                    help="verdicts shown in the table (default 16)")
    ap.add_argument("--trace", help="merged trace JSON to cross-ref "
                                    "the critical-path host")
    ap.add_argument("--trace-url", help="scrape the trace from a URL")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: a pinned collective.corrupt seed on the "
                         "transform must be named exactly")
    ap.add_argument("--device", default=None,
                    help="the smoke's device (default: the card; 'cpu' "
                         "to run without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.device)
    if not args.health and not args.url:
        ap.error("a health file or --url is required")
    job = _load(args)
    if args.as_json:
        json.dump(job, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        print(render_job_health_cli(job, args))
    return {"healthy": 0, "unhealthy": 1}.get(job.get("verdict"), 2)


def render_job_health_cli(job, args) -> str:
    from . import render_job_health
    out = [render_job_health(job, top=args.top)]
    if args.trace or args.trace_url:
        try:
            out.append(_cross_reference_trace(args))
        except Exception as e:  # noqa: BLE001 - the verdict table must
            # survive a missing/unanalyzable trace
            out.append(f"trace cross-ref failed: {e}")
    return "\n".join(out)


if __name__ == "__main__":
    sys.exit(main())
