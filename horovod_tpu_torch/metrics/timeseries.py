"""hvdtimeseries: on-worker bounded ring of per-window metric deltas.

Counterpart: ``horovod_tpu/metrics/timeseries.py``, copied.  Every other
exposition path answers "what is true right now" — cumulative counters,
current gauges, all-time histograms.  This module is the history layer,
"what has been true over the last N windows":

* a sampler thread (started by ``metrics.init_from_env`` at
  ``hvd.init()``, stopped by ``metrics.stop_exposition`` at shutdown)
  closes one WINDOW every ``HOROVOD_TIMESERIES_EVERY_S`` seconds:
  counters and histogram buckets are stored as per-window DELTAS
  against the previous snapshot (→ rates; a counter that went backwards
  means the worker restarted mid-window, and the post-restart value IS
  the delta — never a negative rate), gauges are point-sampled, and the
  SLO watchdog (``metrics/slo.py``) evaluates its rules over the ring;
* a bounded ring (``HOROVOD_TIMESERIES_WINDOW`` windows, oldest
  evicted) holds them; ``GET /timeseries`` serves the local slice on
  every ``JsonRpcServer`` and the driver's ``GET /timeseries/job``
  merges the fleet (mismatched histogram edges raise, exactly like
  the cumulative merge in ``aggregate``);
* windowed percentiles come from the summed bucket deltas, with the
  nearest-rank definition delegated to ``aggregate.percentile`` so a
  windowed p99 can never diverge from the job-level cumulative one.

Hot-path discipline: every ride-along site guards ``if
_timeseries.ACTIVE:`` — one attribute load and a false branch when
``HOROVOD_TIMESERIES=0``.  The sampler itself costs one registry
snapshot per window, off the training thread.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import metrics as _metrics
from .aggregate import percentile

logger = logging.getLogger("horovod_tpu_torch")

ENV_ENABLE = "HOROVOD_TIMESERIES"
ENV_EVERY = "HOROVOD_TIMESERIES_EVERY_S"
ENV_WINDOW = "HOROVOD_TIMESERIES_WINDOW"

DEFAULT_EVERY_S = 10.0
DEFAULT_WINDOW = 90

#: Windows from a crashed worker attached to its FAILURE report beside
#: the flight recorder's last-200 events (and logged by the driver).
FAILURE_REPORT_WINDOWS = 5

#: Windows ``GET /timeseries`` carries (the ring may retain more; the
#: scrape stays bounded no matter the configured window).
PAYLOAD_WINDOWS = 20

_m_windows = _metrics.counter(
    "hvd_timeseries_windows_total",
    "Time-series windows closed by the sampler")
_m_retained = _metrics.gauge(
    "hvd_timeseries_retained_windows",
    "Windows currently held in the bounded ring")


def _env_on(name: str, default: bool = True, environ=os.environ) -> bool:
    from ..config import _env_bool  # one truthy grammar codebase-wide
    return _env_bool(name, default, environ)


#: Ride-along hot-path guard (one false branch when disabled).
ACTIVE = _env_on(ENV_ENABLE)


def enable():
    global ACTIVE
    ACTIVE = True


def disable():
    global ACTIVE
    ACTIVE = False


def _env_every(environ=os.environ) -> float:
    # config.from_env validates strictly (raises); reads here degrade —
    # a malformed value must never kill hvd.init's observability setup
    try:
        v = float(environ.get(ENV_EVERY, "") or DEFAULT_EVERY_S)
        if v <= 0:
            raise ValueError
        return v
    except ValueError:
        logger.warning("invalid %s=%r; using %g", ENV_EVERY,
                       environ.get(ENV_EVERY), DEFAULT_EVERY_S)
        return DEFAULT_EVERY_S


def _env_window(environ=os.environ) -> int:
    try:
        v = int(environ.get(ENV_WINDOW, "") or DEFAULT_WINDOW)
        if v < 2:
            raise ValueError
        return v
    except ValueError:
        logger.warning("invalid %s=%r; using %d", ENV_WINDOW,
                       environ.get(ENV_WINDOW), DEFAULT_WINDOW)
        return DEFAULT_WINDOW


def _skey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


# -- windowed math ------------------------------------------------------------

def percentile_from_buckets(le: List[float], buckets: List[float],
                            q: float) -> float:
    """Nearest-rank percentile of a windowed histogram, reported as the
    upper edge of the bucket holding the rank (``inf`` when it lands in
    the ``+Inf`` overflow bucket).  The RANK itself is delegated to
    ``aggregate.percentile`` over the implied index multiset — the one
    nearest-rank definition codebase-wide, so a windowed p99 and a
    cumulative job-level p99 can never disagree on what "p99" means
    (pinned by the oracle test in tests/test_timeseries.py)."""
    total = int(sum(buckets))
    if total <= 0:
        return float("nan")
    rank = int(percentile(range(total), q))
    edges = list(le) + [float("inf")]
    cum = 0
    for edge, count in zip(edges, buckets):
        cum += int(count)
        if rank < cum:
            return edge
    return edges[-1]


def merge_hist_windows(entries) -> dict:
    """Sum windowed histogram deltas (across windows, series, and
    workers) bucket-wise.  Mismatched ``le`` sets raise — a
    version-skewed worker must surface, not silently corrupt the
    tails (same contract as the cumulative ``aggregate.merge``)."""
    le: Optional[List[float]] = None
    buckets: Optional[List[float]] = None
    total_sum, total_count = 0.0, 0
    for e in entries:
        ele = [float(x) for x in e["le"]]
        if le is None:
            le, buckets = ele, [0.0] * len(e["buckets"])
        elif ele != le or len(e["buckets"]) != len(buckets):
            raise ValueError(
                "histogram windows have mismatched bucket edges; "
                "cannot merge bucket-wise")
        buckets = [a + b for a, b in zip(buckets, e["buckets"])]
        total_sum += e["sum"]
        total_count += int(e["count"])
    return {"le": le or [], "buckets": buckets or [],
            "sum": total_sum, "count": total_count}


def counter_rate(windows: List[dict], family: str) -> Optional[float]:
    """Per-second rate of a counter family over ``windows``: summed
    deltas (all series) / summed duration.  A family absent from a
    window means ZERO delta there (windows prune idle families), so an
    idle engine yields 0.0 — the signal an SLO floor like
    ``cycle_rate>=X`` exists to catch.  None only when ``windows`` is
    empty (nothing sampled yet)."""
    if not windows:
        return None
    delta = 0.0
    dur = 0.0
    for w in windows:
        dur += w.get("dur_s", 0.0)
        for s in w.get("counters", {}).get(family, ()):
            delta += s["delta"]
    return delta / dur if dur > 0 else None


def hist_window(windows: List[dict], family: str) -> Optional[dict]:
    """The family's bucket deltas merged over ``windows`` (all
    series), or None when no window observed it."""
    entries = []
    for w in windows:
        fam = w.get("histograms", {}).get(family)
        if fam:
            entries.extend(
                dict(s, le=fam["le"]) for s in fam["series"])
    if not entries:
        return None
    return merge_hist_windows(entries)


def hist_quantile(windows: List[dict], family: str, q: float) -> float:
    """Windowed percentile of a histogram family over ``windows``
    (NaN when unobserved there)."""
    merged = hist_window(windows, family)
    if merged is None:
        return float("nan")
    return percentile_from_buckets(merged["le"], merged["buckets"], q)


def gauge_last(windows: List[dict], family: str,
               labels: Optional[Dict[str, str]] = None) -> Optional[float]:
    """The most recent sample of a gauge family (max across series —
    'worst' for depth/backlog-shaped gauges), or None if unseen.  With
    ``labels``, only series whose labels include every given pair count
    (e.g. ``hvd_serve_kv_bytes`` wants kind=allocated, not the max over
    allocated AND capacity)."""
    for w in reversed(windows):
        series = w.get("gauges", {}).get(family)
        if labels and series:
            series = [s for s in series
                      if all(s.get("labels", {}).get(k) == v
                             for k, v in labels.items())]
        if series:
            return max(s["value"] for s in series)
    return None


# -- the ring -----------------------------------------------------------------

class TimeSeriesRing:
    """Bounded ring of per-window metric deltas over one registry.

    The baseline snapshot is taken at construction, so the first
    ``sample()`` windows exactly the activity since then — never the
    process's whole cumulative history.  Thread-safe; ``sample()`` is
    called by the sampler thread (or directly by tests and smokes for
    deterministic windows).
    """

    def __init__(self, window: int = DEFAULT_WINDOW,
                 every_s: float = DEFAULT_EVERY_S, registry=None):
        if window < 2:
            raise ValueError(f"timeseries window must be >= 2, "
                             f"got {window}")
        if every_s <= 0:
            raise ValueError(f"timeseries sample period must be > 0, "
                             f"got {every_s}")
        self.every_s = float(every_s)
        self._registry = registry
        self._lock = threading.Lock()
        self._windows: deque = deque(maxlen=int(window))
        self._seq = 0
        self._t_prev = time.monotonic()
        self._prev = self._snap()

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._windows.maxlen

    def _snap(self) -> dict:
        reg = self._registry
        if reg is None:
            reg = _metrics.registry()
        return reg.to_dict()

    def sample(self) -> dict:
        """Close one window (deltas vs the previous snapshot), append
        it to the ring, and return it."""
        cur = self._snap()
        now = time.monotonic()
        wall = time.time()
        with self._lock:
            dur = max(now - self._t_prev, 1e-9)
            win = _window_delta(self._prev, cur, self._seq, dur, wall)
            self._prev, self._t_prev = cur, now
            self._seq += 1
            self._windows.append(win)
            retained = len(self._windows)
        if _metrics.ACTIVE:
            _m_windows.inc()
            _m_retained.set(retained)
        return win

    def windows(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._windows)
        return out[-limit:] if limit else out

    def closed(self) -> int:
        """Windows ever closed (≥ retained once eviction starts)."""
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._windows)


def _window_delta(prev: dict, cur: dict, seq: int, dur: float,
                  wall: float) -> dict:
    """One window: per-family deltas between two registry snapshots.
    Idle families (zero delta / no observations) are pruned — absence
    from a window MEANS zero activity, which keeps windows compact and
    lets ``counter_rate`` report an honest 0.0."""
    counters: Dict[str, list] = {}
    gauges: Dict[str, list] = {}
    hists: Dict[str, dict] = {}
    for name, fam in cur.items():
        kind = fam["type"]
        prev_series = (prev.get(name) or {}).get("series", [])
        if kind == "gauge":
            series = [{"labels": s["labels"], "value": s["value"]}
                      for s in fam["series"]]
            if series:
                gauges[name] = series
        elif kind == "histogram":
            pmap = {_skey(s["labels"]): s for s in prev_series}
            le = [float(x) for x in fam.get("le", ())]
            series = []
            for s in fam["series"]:
                p = pmap.get(_skey(s["labels"]))
                dc = s["count"] - (p["count"] if p else 0)
                if p is None or dc < 0:
                    # new series, or a count that went BACKWARDS: the
                    # worker restarted mid-window and the post-restart
                    # totals are this window's deltas
                    db = list(s["buckets"])
                    ds, dc = s["sum"], s["count"]
                else:
                    db = [b - pb for b, pb
                          in zip(s["buckets"], p["buckets"])]
                    ds = s["sum"] - p["sum"]
                if dc:
                    series.append({"labels": s["labels"], "buckets": db,
                                   "sum": ds, "count": dc})
            if series:
                hists[name] = {"le": le, "series": series}
        else:   # counter / untyped
            pmap = {_skey(s["labels"]): s["value"] for s in prev_series}
            series = []
            for s in fam["series"]:
                d = s["value"] - pmap.get(_skey(s["labels"]), 0.0)
                if d < 0:
                    # counter reset (restart): post-restart value IS
                    # the delta — never a negative rate
                    d = s["value"]
                if d:
                    series.append({"labels": s["labels"], "delta": d})
            if series:
                counters[name] = series
    return {"n": seq, "wall": round(wall, 3), "dur_s": round(dur, 6),
            "counters": counters, "gauges": gauges, "histograms": hists}


# -- module sampler (rides metrics.init_from_env) -----------------------------

_RING: Optional[TimeSeriesRing] = None
_thread: Optional[threading.Thread] = None
_stop: Optional[threading.Event] = None


def ring() -> Optional[TimeSeriesRing]:
    """The process-wide ring (None until ``init_from_env`` under
    ``HOROVOD_TIMESERIES=1``)."""
    return _RING


def swap_ring(r: Optional[TimeSeriesRing]) -> Optional[TimeSeriesRing]:
    """Install a ring (tests / smokes); returns the previous one."""
    global _RING
    old, _RING = _RING, r
    return old


def tick() -> Optional[dict]:
    """One sampler beat: close a window, then run the SLO watchdog
    over the updated ring.  The sampler thread calls this every
    ``every_s``; tests and smokes call it directly for deterministic
    windows."""
    r = _RING
    if r is None:
        return None
    win = r.sample()
    from . import slo as _slo
    wd = _slo.watchdog()
    if wd is not None:
        wd.observe(r)
    return win


def _loop(stop: threading.Event, every_s: float):
    while not stop.wait(every_s):
        try:
            tick()
        except Exception:  # noqa: BLE001 - sampling must not kill jobs
            logger.debug("timeseries sample failed", exc_info=True)


def init_from_env(environ=os.environ):
    """Apply the HOROVOD_TIMESERIES* / HOROVOD_SLO contract (called
    from ``metrics.init_from_env`` — the sampler rides the same
    ``hvd.init()`` plumbing as the dump thread; idempotent)."""
    global ACTIVE, _RING, _thread, _stop
    ACTIVE = _env_on(ENV_ENABLE, environ=environ)
    from . import slo as _slo
    _slo.init_from_env(environ)
    if not ACTIVE:
        stop_sampler()
        return
    every = _env_every(environ)
    if _RING is None:
        _RING = TimeSeriesRing(window=_env_window(environ),
                               every_s=every)
    if _thread is None:
        _stop = threading.Event()
        _thread = threading.Thread(target=_loop, args=(_stop, every),
                                   name="hvd-timeseries", daemon=True)
        _thread.start()


def stop_sampler():
    """Stop the sampler thread (the ring and its windows survive —
    a shutdown must not erase the history a post-mortem wants)."""
    global _thread, _stop
    if _stop is not None:
        _stop.set()
        if _thread is not None:
            _thread.join(timeout=5)
    _thread, _stop = None, None


# -- exposition ---------------------------------------------------------------

def report_windows(limit: int = FAILURE_REPORT_WINDOWS) -> List[dict]:
    """The FAILURE-report ride-along: the last ``limit`` windows (call
    sites guard on ACTIVE; empty when no ring sampled yet)."""
    r = _RING
    if not ACTIVE or r is None:
        return []
    return r.windows(limit)


def local_payload(limit: Optional[int] = None) -> dict:
    """The ``GET /timeseries`` body: this process's slice of the
    driver's merged ``GET /timeseries/job``."""
    out: Dict[str, object] = {"enabled": ACTIVE, "pid": os.getpid()}
    r = _RING
    if not ACTIVE or r is None:
        out["windows"] = []
        return out
    wins = r.windows(limit or PAYLOAD_WINDOWS)
    out.update(every_s=r.every_s, window=r.capacity,
               closed=r.closed(), windows=wins)
    from . import slo as _slo
    wd = _slo.watchdog()
    if wd is not None:
        out["slo"] = wd.snapshot()
    try:
        # the trace/metrics cross-reference the top CLI's straggler column
        # prints: the stall inspector's worst per-peer EWMA lateness
        from .. import runtime
        insp = runtime._state().stall_inspector
        if insp is not None and not insp.disabled:
            scores = insp.straggler_scores()
            if scores:
                out["straggler"] = round(max(scores.values()), 6)
    except Exception:  # noqa: BLE001 - exposition must not raise
        pass
    return out


def summary() -> dict:
    """The ``engine.stats()["timeseries"]`` block (call sites guard on
    ACTIVE): knobs, ring occupancy, and the last window's headline
    rates — the full windows are ``GET /timeseries``."""
    r = _RING
    if r is None:
        return {"enabled": ACTIVE, "sampling": False, "windows": 0}
    last = r.windows(1)
    out = {"enabled": ACTIVE, "sampling": _thread is not None,
           "every_s": r.every_s, "window": r.capacity,
           "windows": len(r), "closed": r.closed()}
    if last:
        out["last"] = {
            "wall": last[0]["wall"], "dur_s": last[0]["dur_s"],
            "cycle_rate": counter_rate(last, "hvd_engine_cycles_total"),
            "rpc_rate": counter_rate(last,
                                     "hvd_rpc_client_requests_total"),
        }
    from . import slo as _slo
    wd = _slo.watchdog()
    if wd is not None:
        snap = wd.snapshot()
        out["slo"] = {"rules": len(snap["rules"]),
                      "active": [b["rule"] for b in snap["active"]]}
    return out


def render_windows(windows: List[dict]) -> str:
    """Compact per-window text for driver logs (the FAILURE-report
    ride-along): what the worker's rates looked like before it died."""
    lines = []
    for w in windows:
        parts = [f"w{w['n']}", f"dur={w['dur_s']:.1f}s"]
        cyc = counter_rate([w], "hvd_engine_cycles_total")
        if cyc:
            parts.append(f"cycles/s={cyc:.2f}")
        rpc = counter_rate([w], "hvd_rpc_client_requests_total")
        if rpc:
            parts.append(f"rpc/s={rpc:.2f}")
        srv = counter_rate([w], "hvd_serve_requests_total")
        if srv:
            parts.append(f"serve/s={srv:.2f}")
        p99 = hist_quantile([w], "hvd_serve_request_latency_seconds",
                            0.99)
        if p99 == p99:  # not NaN
            parts.append(f"serve_p99<={p99:g}s")
        n_act = (len(w.get("counters", {})) + len(w.get("gauges", {}))
                 + len(w.get("histograms", {})))
        parts.append(f"families={n_act}")
        lines.append("  " + " ".join(parts))
    return "\n".join(lines)


# -- job-level merge (GET /timeseries/job) ------------------------------------

#: The headline families the top CLI's table and the per-worker
#: summaries report (full per-family data rides in the carried windows).
_RATE_FAMILIES = (("cycle_rate", "hvd_engine_cycles_total"),
                  ("rpc_rate", "hvd_rpc_client_requests_total"),
                  ("serve_rate", "hvd_serve_requests_total"))
_HIST_FAMILIES = ("hvd_serve_request_latency_seconds",
                  "hvd_serve_e2e_latency_seconds",
                  "hvd_cycle_duration_seconds",
                  "hvd_rpc_request_duration_seconds",
                  "hvd_recovery_time_seconds")


def merge_job_timeseries(workers: Dict[str, dict],
                         unreachable: Dict[str, str]) -> dict:
    """Merge scraped ``{worker: GET /timeseries payload}`` into the
    job view: per-worker summaries (rates, windowed p99, queue depth,
    straggler score, active breaches) plus job-level windowed
    histograms summed bucket-wise across the fleet.  Unreachable
    workers degrade to ``unreachable`` entries, never a failed scrape;
    a mismatched-edge worker surfaces as a per-family ``error``."""
    job: Dict[str, object] = {
        "scraped": len(workers),
        "unreachable": dict(unreachable),
        "workers": {},
        "merged": {"histograms": {}, "rates": {}},
        "slo": [],
        "wall": round(time.time(), 3),
    }
    all_windows: List[dict] = []
    for w in sorted(workers):
        p = workers[w] or {}
        wins = p.get("windows") or []
        all_windows.extend(wins)
        info: Dict[str, object] = {
            "enabled": bool(p.get("enabled", False)),
            "windows": len(wins),
        }
        if wins:
            info["wall"] = wins[-1]["wall"]
            for key, fam in _RATE_FAMILIES:
                rate = counter_rate(wins, fam)
                if rate is not None:
                    info[key] = round(rate, 6)
            p99 = hist_quantile(wins, "hvd_serve_request_latency_seconds",
                                0.99)
            if p99 == p99:
                info["serve_p99_s"] = p99
            depth = gauge_last(wins, "hvd_serve_queue_depth")
            if depth is not None:
                info["queue_depth"] = depth
            # paged-KV residency: the allocator's live ledger
            # gauges — bytes actually allocated (kind=allocated, NOT the
            # capacity series) and blocks in flight (state=allocated)
            kvb = gauge_last(wins, "hvd_serve_kv_bytes",
                             labels={"kind": "allocated"})
            if kvb is not None:
                info["kv_bytes"] = kvb
            kvn = gauge_last(wins, "hvd_serve_kv_blocks",
                             labels={"state": "allocated"})
            if kvn is not None:
                info["kv_blocks"] = kvn
        if "straggler" in p:
            info["straggler"] = p["straggler"]
        breaches = (p.get("slo") or {}).get("active") or []
        if breaches:
            info["breaches"] = [b["rule"] for b in breaches]
            job["slo"].extend(dict(b, worker=w) for b in breaches)
        job["workers"][w] = info
    for fam in _HIST_FAMILIES:
        try:
            merged = hist_window(all_windows, fam)
        except ValueError as e:
            job["merged"]["histograms"][fam] = {"error": str(e)}
            continue
        if merged is None:
            continue
        merged["p50"] = percentile_from_buckets(
            merged["le"], merged["buckets"], 0.50)
        merged["p99"] = percentile_from_buckets(
            merged["le"], merged["buckets"], 0.99)
        job["merged"]["histograms"][fam] = merged
    for key, fam in _RATE_FAMILIES:
        # throughputs add across workers (each worker's windows span
        # its own wall clock, so rates sum per worker, not per pool)
        total = 0.0
        seen = False
        for w, p in workers.items():
            rate = counter_rate((p or {}).get("windows") or [], fam)
            if rate is not None:
                total += rate
                seen = True
        if seen:
            job["merged"]["rates"][key] = round(total, 6)
    return job


def scrape_job_timeseries(endpoints: Dict[str, Tuple[str, int]],
                          timeout: float = 2.0) -> dict:
    """Scrape every ``{worker: (addr, port)}`` ``GET /timeseries``
    route in parallel (the unified ``jobscrape.fan_out`` engine —
    same shared-deadline contract as every other job route) and merge
    into the job view.  The driver's own ring, when it samples one
    (a co-located serving plane), joins as pseudo-worker ``driver``."""
    from . import jobscrape

    def _fetch(worker, addr, port):
        return json.loads(jobscrape.http_get(addr, port, "timeseries",
                                             timeout=timeout))

    ok, failed = jobscrape.fan_out(
        endpoints, _fetch, budget=timeout + 1.0,
        wedged="timeseries scrape timed out", name="tswin")
    if ACTIVE and _RING is not None:
        ok = dict(ok, driver=local_payload())
    return merge_job_timeseries(
        ok, {w: str(e) for w, e in failed.items()})
