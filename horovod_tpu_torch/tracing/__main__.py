"""hvdtrace CLI: critical-path attribution over a merged job trace.

Counterpart: ``horovod_tpu/tracing/__main__.py``.  Run as a module::

    python -m horovod_tpu_torch.tracing trace.json   # a saved merged trace
    python -m horovod_tpu_torch.tracing --url http://driver:29410/trace/job
    python -m horovod_tpu_torch.tracing --json trace.json  # report as JSON
    python -m horovod_tpu_torch.tracing --smoke      # the recorded fixture

The input is the ``GET /trace/job`` object (or any Chrome-trace JSON
whose events carry ``host``/``round`` args — ``GET /trace`` per-worker
output works too, it just has one host to attribute to).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

from . import critical

#: The recorded fixture --smoke replays (read-only): a 4-host merged trace
#: under the pinned ``collective.dcn group=1 every=3 action=delay:0.8``
#: chaos seed; the injected host is recorded in otherData.chaos.
SMOKE_FIXTURE = os.path.join("tests", "traces", "chaos_4proc.trace.json")


def _load(args) -> dict:
    if args.url:
        with urllib.request.urlopen(args.url, timeout=10.0) as resp:
            return json.loads(resp.read().decode("utf-8"))
    with open(args.trace) as f:
        return json.load(f)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _smoke() -> int:
    path = os.path.join(_repo_root(), SMOKE_FIXTURE)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    pids = {e["pid"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert len(pids) >= 2, f"fixture has {len(pids)} host pid(s)"
    report = critical.analyze(trace)
    assert report["rounds"] >= 3, report
    chaos = (trace.get("otherData") or {}).get("chaos") or {}
    injected = chaos.get("injected_host")
    assert injected, "fixture missing otherData.chaos.injected_host"
    assert report["top"] and report["top"][0] == injected, (
        f"critical-path verdict {report['top']} != injected straggler "
        f"{injected!r}")
    assert report["top"][1] > 0.5, report["top"]
    print(f"hvdtrace smoke OK: {report['rounds']} rounds, "
          f"critical-path host {injected} at {report['top'][1]:.1%} "
          f"(clock err bound {report['max_clock_err_s'] * 1e3:.2f}ms)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hvdtrace",
        description="critical-path attribution over a merged job trace "
                    "(GET /trace/job output)")
    ap.add_argument("trace", nargs="?",
                    help="merged trace JSON file")
    ap.add_argument("--url", help="scrape the trace from a URL "
                                  "(e.g. http://driver:29410/trace/job)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON")
    ap.add_argument("--top", type=int, default=8,
                    help="hosts shown in the table (default 8)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke over the recorded chaos fixture")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()
    if not args.trace and not args.url:
        ap.error("a trace file or --url is required")
    trace = _load(args)
    report = critical.analyze(trace)
    if args.as_json:
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        print(critical.render_table(report, top=args.top))
    return 0 if report["rounds"] else 2


if __name__ == "__main__":
    sys.exit(main())
