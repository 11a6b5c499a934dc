"""hvdslo: declarative SLO rules evaluated over time-series windows.

Counterpart: ``horovod_tpu/metrics/slo.py``, copied.  The health plane
answers "did something BREAK" — NaNs, gradient explosions, divergent
replicas.  It cannot answer "is the job still MEETING its objectives": a
serving p99 that drifted past its budget or a cycle rate that quietly
halved breaks nothing, yet is exactly what an operator pages on.  This
module closes that gap declaratively:

    HOROVOD_SLO="serve_p99_s<=0.5@3w,cycle_rate>=10@5w,recovery_time_s<=30"

Each rule is ``signal OP threshold [@Nw]`` — the signal evaluated over
the last N closed time-series windows (default 1).  Signals are the
windowed reductions ``timeseries`` already defines (rates from counter
deltas, percentiles from bucket deltas via the one nearest-rank
definition, last-sampled gauges), so an SLO breach and a top-CLI column
can never disagree about the number they both looked at.

Verdicts are EDGE-TRIGGERED, exactly like the health evaluator's: a
rule fires once when it crosses into breach, stays silent while the
breach persists, and re-arms when the signal recovers.  Every newly
fired breach rides the health plane (``HealthEvaluator.ingest_slo``):
it shows up in ``/health/job``, the flight recorder, and the
``on_unhealthy`` hook, so ONE plane owns "is the job OK".
"""

from __future__ import annotations

import logging
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics as _metrics
from . import timeseries as _timeseries

logger = logging.getLogger("horovod_tpu_torch")

ENV_RULES = "HOROVOD_SLO"

_m_breaches = _metrics.counter(
    "hvd_slo_breaches_total",
    "SLO breach episodes (edge-triggered)", labels=("rule",))
_m_active = _metrics.gauge(
    "hvd_slo_active_breaches", "SLO rules currently in breach")

# signal name -> (reducer over windows, unit) — every reducer returns
# None for "no data yet" (the rule SKIPS: absence of traffic is not a
# breach for ceilings; floors see 0.0 once windows exist, because
# counter_rate treats a pruned family as zero activity)
_RATE = _timeseries.counter_rate
_Q = _timeseries.hist_quantile


def _quantile(family: str, q: float):
    def signal(windows):
        v = _Q(windows, family, q)
        return None if v != v else v   # NaN -> no observations
    return signal


SIGNALS: Dict[str, Tuple[Callable[[List[dict]], Optional[float]], str]] = {
    "cycle_rate": (lambda w: _RATE(w, "hvd_engine_cycles_total"), "/s"),
    "serve_rate": (lambda w: _RATE(w, "hvd_serve_requests_total"), "/s"),
    "rpc_rate": (lambda w: _RATE(w, "hvd_rpc_client_requests_total"),
                 "/s"),
    "serve_p50_s": (_quantile("hvd_serve_request_latency_seconds", 0.50),
                    "s"),
    "serve_p99_s": (_quantile("hvd_serve_request_latency_seconds", 0.99),
                    "s"),
    "serve_e2e_p99_s": (_quantile("hvd_serve_e2e_latency_seconds", 0.99),
                        "s"),
    "cycle_p99_s": (_quantile("hvd_cycle_duration_seconds", 0.99), "s"),
    "rpc_p99_s": (_quantile("hvd_rpc_request_duration_seconds", 0.99),
                  "s"),
    # worst recovery in the window, not a percentile: ONE slow rebuild
    # blowing the budget is the page
    "recovery_time_s": (_quantile("hvd_recovery_time_seconds", 1.0),
                        "s"),
    "queue_depth": (lambda w: _timeseries.gauge_last(
        w, "hvd_serve_queue_depth"), ""),
}

_RULE_RE = re.compile(
    r"^(?P<name>[a-z0-9_]+)(?P<op><=|>=)(?P<value>[0-9.eE+-]+)"
    r"(?:@(?P<nw>[0-9]+)w)?$")


class Rule:
    """One parsed SLO rule: ``signal OP threshold [@Nw]``."""

    __slots__ = ("raw", "name", "op", "threshold", "nw", "signal", "unit")

    def __init__(self, raw: str):
        m = _RULE_RE.match(raw.strip())
        if not m:
            raise ValueError(
                f"SLO rule {raw!r} does not match "
                f"'signal<=value[@Nw]' / 'signal>=value[@Nw]'")
        self.raw = raw.strip()
        self.name = m.group("name")
        if self.name not in SIGNALS:
            raise ValueError(
                f"SLO rule {raw!r}: unknown signal {self.name!r} "
                f"(known: {', '.join(sorted(SIGNALS))})")
        self.op = m.group("op")
        try:
            self.threshold = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"SLO rule {raw!r}: threshold "
                f"{m.group('value')!r} is not a number") from None
        self.nw = int(m.group("nw") or 1)
        if self.nw < 1:
            raise ValueError(f"SLO rule {raw!r}: window count must "
                             f"be >= 1")
        self.signal, self.unit = SIGNALS[self.name]

    def breached(self, value: float) -> bool:
        return (value > self.threshold if self.op == "<="
                else value < self.threshold)

    def __repr__(self):
        return f"Rule({self.raw!r})"


def parse_rules(spec: str) -> List[Rule]:
    """Parse a comma-separated rule list (the ``HOROVOD_SLO`` value).
    Raises ``ValueError`` naming the offending rule — a typo'd SLO
    silently watching nothing is worse than no SLO."""
    return [Rule(part) for part in spec.split(",") if part.strip()]


class Watchdog:
    """Evaluates the rule set over a ring after every closed window
    (the sampler's ``tick()`` calls :meth:`observe`).  Edge-triggered
    per rule; breaches ride the health plane when it is active."""

    def __init__(self, rules: List[Rule]):
        self.rules = list(rules)
        self._active: Dict[str, dict] = {}   # raw rule -> breach dict

    def observe(self, ring) -> List[dict]:
        """One evaluation pass; returns the NEWLY-fired breaches."""
        fired: List[dict] = []
        for rule in self.rules:
            windows = ring.windows(rule.nw)
            if len(windows) < rule.nw:
                continue   # not enough history yet: no verdict either way
            value = rule.signal(windows)
            if value is None:
                continue   # signal unobserved in the window: skip
            if rule.breached(value):
                if rule.raw in self._active:
                    continue   # still breaching: one episode, one verdict
                breach = {
                    "rule": rule.raw, "signal": rule.name,
                    "value": round(value, 6),
                    "threshold": rule.threshold, "op": rule.op,
                    "windows": rule.nw,
                    "detail": (f"{rule.name}={value:g}{rule.unit} "
                               f"violates {rule.raw} "
                               f"over {rule.nw} window(s)"),
                }
                self._active[rule.raw] = breach
                fired.append(breach)
            elif rule.raw in self._active:
                # recovered: re-arm so the NEXT episode fires again
                del self._active[rule.raw]
                logger.info("SLO recovered: %s (%s=%g%s)", rule.raw,
                            rule.name, value, rule.unit)
                self._ride_health(rule.raw, "", clear=True)
        for b in fired:
            logger.warning("SLO breach: %s", b["detail"])
            if _metrics.ACTIVE:
                _m_breaches.inc(rule=b["rule"])
            if _metrics.RECORDING:
                _metrics.event("slo.breach", **b)
            self._ride_health(b["rule"], b["detail"])
        if _metrics.ACTIVE:
            _m_active.set(len(self._active))
        return fired

    @staticmethod
    def _ride_health(rule: str, detail: str, clear: bool = False):
        from .. import health as _health
        if not _health.ACTIVE:
            return
        try:
            _health.evaluator().ingest_slo(rule, detail, clear=clear)
        except Exception:  # noqa: BLE001 - the watchdog must not die
            # with the health plane mid-teardown
            logger.debug("SLO health ride-along failed", exc_info=True)

    def snapshot(self) -> dict:
        """The ``GET /timeseries`` ``"slo"`` block: configured rules
        and the currently-active breaches."""
        return {"rules": [r.raw for r in self.rules],
                "active": sorted(self._active.values(),
                                 key=lambda b: b["rule"])}


_WATCHDOG: Optional[Watchdog] = None


def watchdog() -> Optional[Watchdog]:
    """The process-wide watchdog (None when ``HOROVOD_SLO`` is empty)."""
    return _WATCHDOG


def swap_watchdog(wd: Optional[Watchdog]) -> Optional[Watchdog]:
    """Install a watchdog (tests / smokes); returns the previous one."""
    global _WATCHDOG
    old, _WATCHDOG = _WATCHDOG, wd
    return old


def init_from_env(environ=os.environ):
    """Apply the ``HOROVOD_SLO`` contract (called from
    ``timeseries.init_from_env``).  Reads here degrade with a warning
    instead of raising — ``config.from_env`` owns strict validation."""
    global _WATCHDOG
    spec = environ.get(ENV_RULES, "").strip()
    if not spec:
        _WATCHDOG = None
        return
    try:
        rules = parse_rules(spec)
    except ValueError as e:
        logger.warning("ignoring %s: %s", ENV_RULES, e)
        _WATCHDOG = None
        return
    _WATCHDOG = Watchdog(rules)
