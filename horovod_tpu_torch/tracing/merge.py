"""Driver-side trace merge: scrape every worker's span buffer, align
clocks, emit ONE Chrome-trace/Perfetto JSON with one ``pid`` per host.

Counterpart: ``horovod_tpu/tracing/merge.py``, copied; the probes and
pulls ride the port's ``runner/rpc.json_request``.

Clock alignment needs no NTP and no shared clock: each scrape runs a
few tiny ``trace_pull`` probe RPCs over the RPC transport
and applies the midpoint method — the worker samples its clock inside
the handler, the driver brackets the request with its own clock, and

    offset = worker_now - (t_send + t_recv) / 2

is correct to within ``RTT / 2`` *regardless of how asymmetric the two
legs are* (the sample point lies somewhere inside the bracket).  The
probe with the smallest RTT wins, and its ``RTT / 2`` is recorded on
every merged span as ``clock_err_us`` — the error bound the
critical-path analyzer and the tests hold alignment claims to.

Merged layout: one ``pid`` per HOST (the unit OptiReduce's tail
question is about), one ``tid`` lane per (process, span category),
spans as complete ``"X"`` events carrying round id, epoch, and the
instrumentation args verbatim.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from .span import SpanBuffer

#: Sentinel: resolve the RPC signing secret from the environment (the
#: launcher/driver default); pass ``secret=None`` explicitly for
#: unauthenticated test servers.
_ENV = object()


def estimate_offset(addr: str, port: int, probes: int = 3,
                    timeout: float = 2.0, secret=_ENV,
                    _request=None) -> Tuple[float, float]:
    """(offset, error) of the worker's span clock relative to this
    process's ``time.monotonic``: ``driver_time = span_time - offset``,
    correct to within ``error`` seconds (best probe's RTT / 2)."""
    from ..runner.rpc import json_request
    request = _request or json_request
    best: Optional[Tuple[float, float]] = None
    kw = {} if secret is _ENV else {"secret": secret}
    for _ in range(max(int(probes), 1)):
        t0 = time.monotonic()
        reply = request(addr, port, "trace_pull", {"probe": True},
                       timeout=timeout, retries=0, **kw)
        t1 = time.monotonic()
        rtt = t1 - t0
        offset = float(reply["now"]) - (t0 + t1) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    return best[1], best[0] / 2.0


def pull_worker(addr: str, port: int, probes: int = 3,
                timeout: float = 2.0, secret=_ENV,
                _request=None) -> Tuple[Dict, float, float]:
    """(snapshot, offset, error) for one worker endpoint: probe the
    clock first (tiny replies — tight RTT bound), then pull the span
    buffer once."""
    from ..runner.rpc import json_request
    request = _request or json_request
    offset, err = estimate_offset(addr, port, probes=probes,
                                  timeout=timeout, secret=secret,
                                  _request=request)
    kw = {} if secret is _ENV else {"secret": secret}
    snap = request(addr, port, "trace_pull", {}, timeout=timeout,
                   retries=0, **kw)
    return snap, offset, err


def chrome_trace(workers: Dict[str, Tuple[Dict, float, float]],
                 unreachable: Optional[Dict[str, str]] = None) -> Dict:
    """Assemble ``{worker: (snapshot, offset_s, error_s)}`` into one
    Chrome-trace object (``traceEvents`` form, Perfetto-loadable).

    One ``pid`` per distinct host; one ``tid`` lane per
    (process, category); timestamps mapped onto the scraper's clock
    (``span_time - offset``) and rebased so the earliest span is 0.
    Every event's args carry ``host``/``process``/``round``/``epoch``
    plus ``clock_err_us``, so downstream analysis never needs the
    side tables.
    """
    hosts = sorted({snap.get("host", w)
                    for w, (snap, _o, _e) in workers.items()})
    pid_of = {h: i for i, h in enumerate(hosts)}
    events: List[Dict] = []
    for h in hosts:
        events.append({"name": "process_name", "ph": "M",
                       "pid": pid_of[h], "tid": 0,
                       "args": {"name": h}})
    base = None
    for _w, (snap, offset, _err) in sorted(workers.items()):
        for s in snap.get("spans", ()):
            t = float(s["t0"]) - offset
            if base is None or t < base:
                base = t
    base = base or 0.0
    tids: Dict[Tuple[int, int, str], int] = {}
    clock_meta: Dict[str, Dict] = {}
    for w, (snap, offset, err) in sorted(workers.items()):
        host = snap.get("host", w)
        pid = pid_of[host]
        proc = int(snap.get("process", 0))
        clock_meta[w] = {"host": host, "process": proc,
                         "offset_s": round(offset, 6),
                         "err_s": round(err, 6),
                         "dropped": int(snap.get("dropped", 0))}
        for s in snap.get("spans", ()):
            lane = (pid, proc, s["cat"])
            tid = tids.get(lane)
            if tid is None:
                tid = len(tids) + 1
                tids[lane] = tid
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid,
                    "args": {"name": f"p{proc} {s['cat']}"}})
            args = dict(s.get("args") or {})
            args.update(round=s.get("round", -1),
                        group=s.get("group", ""),
                        epoch=s.get("epoch", 0),
                        host=host, process=proc,
                        clock_err_us=round(err * 1e6, 1))
            events.append({
                "name": s["name"], "cat": s["cat"], "ph": "X",
                "pid": pid, "tid": tid,
                "ts": round((float(s["t0"]) - offset - base) * 1e6, 1),
                "dur": round((float(s["t1"]) - float(s["t0"])) * 1e6, 1),
                "args": args})
    other = {"hosts": hosts, "clock": clock_meta}
    if unreachable:
        other["unreachable"] = {w: str(e)
                                for w, e in sorted(unreachable.items())}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def local_trace(buffer: SpanBuffer) -> Dict:
    """The single-process view (``GET /trace`` on any server): this
    buffer rendered as a Chrome trace with zero offset/error."""
    snap = buffer.snapshot()
    return chrome_trace({str(snap.get("process", 0)): (snap, 0.0, 0.0)})


def scrape_job_trace(endpoints: Dict[str, Tuple[str, int]],
                     timeout: float = 2.0, probes: int = 3,
                     secret=_ENV) -> Dict:
    """Scrape every ``{worker: (addr, port)}`` span buffer in parallel
    and merge into one job trace.  Unreachable workers become entries
    in ``otherData.unreachable``, never a failed scrape — mid-churn is
    exactly when this view matters (the shared-deadline fan-out is the
    unified ``metrics.jobscrape.fan_out`` engine; probes+pull make a
    few round trips, hence the larger per-worker budget)."""
    from ..metrics import jobscrape

    def _fetch(worker, addr, port):
        return pull_worker(addr, port, probes=probes, timeout=timeout,
                           secret=secret)

    workers, failed = jobscrape.fan_out(
        endpoints, _fetch, budget=timeout * (probes + 1) + 1.0,
        wedged="trace scrape timed out", name="trace")
    return chrome_trace(workers,
                        unreachable={w: str(e)
                                     for w, e in failed.items()})
