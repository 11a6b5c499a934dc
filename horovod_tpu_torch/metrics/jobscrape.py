"""The driver's job scraper: one parallel fan-out and one route table
behind every job-level GET view.

Counterpart: ``horovod_tpu/metrics/jobscrape.py``.

* :func:`fan_out` scrapes every worker endpoint on a daemon thread each,
  under ONE shared deadline (a join per thread would degrade to N ×
  timeout with several wedged workers); a thread still running at the
  deadline reports its worker as failed instead of hanging the route.
  The degrade policies stay in their planes: comment lines in the merged
  exposition (``aggregate.scrape_and_merge``), ``otherData.unreachable``
  in the merged trace (``tracing.merge.scrape_job_trace``).
* :class:`JobScraper` is the route table the elastic driver registers:
  ``metrics/job``, ``trace/job``, ``health/job`` (every worker's
  ``health_pull`` merged into one job verdict, ``health.
  merge_job_health``), ``timeseries/job`` (every worker's ``GET
  /timeseries`` merged, ``metrics.timeseries.merge_job_timeseries``),
  ``recovery/stats`` and, once a serving plane attaches,
  ``serve/stats``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Callable, Dict, Optional, Tuple

_JSON_CT = "application/json"
_PROM_CT = "text/plain; version=0.0.4; charset=utf-8"


def fan_out(endpoints: Dict[str, Tuple[str, int]],
            fetch: Callable[[str, str, int], object], *,
            budget: float, wedged: str = "scrape timed out",
            name: str = "scrape",
            ) -> Tuple[Dict[str, object], Dict[str, Exception]]:
    """Call ``fetch(worker, addr, port)`` for every ``{worker: (addr,
    port)}`` endpoint in parallel, under one deadline of ``budget``
    seconds.  Whatever ``fetch`` raises marks that worker failed, never
    the whole scrape; a thread still running at the deadline yields
    ``TimeoutError(wedged)``.  Returns ``(ok, failed)``, both keyed by
    ``str(worker)`` in sorted order."""
    results: Dict[str, object] = {}

    def one(worker, addr, port):
        try:
            results[worker] = fetch(worker, addr, port)
        except Exception as e:  # noqa: BLE001 - partial view is useful
            results[worker] = e

    threads = [threading.Thread(target=one, args=(str(w), a, p),
                                name=f"hvd-{name}-{w}", daemon=True)
               for w, (a, p) in endpoints.items()]
    for t in threads:
        t.start()
    deadline = time.monotonic() + budget
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    for w in endpoints:   # a wedged thread still reports as unreachable
        results.setdefault(str(w), TimeoutError(wedged))
    ok: Dict[str, object] = {}
    failed: Dict[str, Exception] = {}
    for w in sorted(results):
        got = results[w]
        if isinstance(got, Exception):
            failed[w] = got
        else:
            ok[w] = got
    return ok, failed


def http_get(addr: str, port: int, route: str,
             timeout: float = 2.0) -> str:
    """GET a worker's unauthenticated exposition route (``/metrics``,
    ``/trace``): exposition is read-only, so it rides plain HTTP rather
    than the signed RPC path."""
    with urllib.request.urlopen(
            f"http://{addr}:{port}/{route}", timeout=timeout) as resp:
        return resp.read().decode("utf-8", errors="replace")


class JobScraper:
    """The route table behind every job-level GET view on the driver.

    ``endpoints`` is a zero-argument callable returning the CURRENT
    ``{worker: (addr, port)}`` notification endpoints (the driver
    re-snapshots them under its lock on every scrape, so a re-form
    mid-scrape sees the new fleet); ``recovery_stats`` and the plane
    given to :meth:`serving_routes` supply the in-process JSON views."""

    def __init__(self, endpoints: Callable[[], Dict[str, Tuple[str, int]]],
                 recovery_stats: Optional[Callable[[], dict]] = None):
        self._endpoints = endpoints
        self._recovery_stats = recovery_stats

    def routes(self) -> Dict[str, Callable]:
        """The driver's GET routes, each returning the ``(status,
        content_type, body)`` a ``JsonRpcServer`` serves."""
        routes = {
            # every registered worker's /metrics scraped and merged
            # (histograms bucket-wise, gauges per-worker min/max/sum);
            # unreachable workers render as comment lines
            "metrics/job": self._metrics_job,
            # every worker's span buffer pulled, clocks aligned by RPC
            # midpoint offsets, one Chrome trace with one pid per host
            "trace/job": self._trace_job,
            # every worker's health_pull snapshot merged into ONE verdict
            # with (worker, bucket, step) attribution
            "health/job": self._health_job,
            # every worker's windowed-delta ring merged into per-worker
            # rates and percentiles plus job-level windowed histograms
            "timeseries/job": self._timeseries_job,
        }
        if self._recovery_stats is not None:
            # who holds redundancy for whom, and every rebuild
            routes["recovery/stats"] = self._recovery_stats_route
        return routes

    def serving_routes(self, stats: Callable[[], dict]) -> Dict[str, Callable]:
        """The ``serve/stats`` route a ``ServingPlane`` adds on attach."""
        def _serve_stats():
            return (200, _JSON_CT,
                    json.dumps(stats(), separators=(",", ":")))
        return {"serve/stats": _serve_stats}

    def _recovery_stats_route(self):
        return (200, _JSON_CT,
                json.dumps(self._recovery_stats(), separators=(",", ":")))

    def _metrics_job(self):
        from . import aggregate
        body = aggregate.scrape_and_merge(self._endpoints())
        return (200, _PROM_CT, body)

    def _trace_job(self):
        from .. import tracing as _tracing
        trace = _tracing.merge.scrape_job_trace(
            self._endpoints(), probes=_tracing.probes())
        return (200, _JSON_CT, json.dumps(trace, separators=(",", ":")))

    def _health_job(self):
        from .. import health as _health
        job = _health.scrape_job_health(self._endpoints())
        return (200, _JSON_CT, json.dumps(job, separators=(",", ":")))

    def _timeseries_job(self):
        from . import timeseries as _timeseries
        job = _timeseries.scrape_job_timeseries(self._endpoints())
        return (200, _JSON_CT, json.dumps(job, separators=(",", ":")))
