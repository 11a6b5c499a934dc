"""Critical-path attribution over a merged job trace.

Counterpart: ``horovod_tpu/tracing/critical.py``, copied.

For every negotiation round, the spans from all hosts form a small DAG
with a fixed phase order (submit → negotiate → fuse → dispatch → dcn;
:data:`~.span.PHASES`).  The round's wall time is attributed by walking
the phases in order and charging each segment to the host whose span of
that phase *finished last* — the gating host: everyone else had that
phase done and was waiting.  Summed over rounds this yields the
per-host gating-fraction table — the evidence form of "which host's
which phase is costing us", cross-checkable against the stall
inspector's per-host straggler EWMA (which sees only DCN arrival
lateness, not negotiate/fuse/dispatch gating).

Works on the ``chrome_trace`` object (events carry host/round/epoch in
their args), so it runs identically on a live ``GET /trace/job`` scrape
and on a recorded fixture file.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from .span import PHASES

_PHASE_INDEX = {p: i for i, p in enumerate(PHASES)}


def round_spans(trace: Dict) -> Dict[tuple, List[Dict]]:
    """Group the trace's phase spans by ``(epoch, group, round)`` —
    round ids are per-GROUP sequence numbers, so the negotiation group
    key disambiguates them when subset process sets negotiate alongside
    the global one.  Spans with ``round < 0`` (trace-time staging,
    envelope spans) and non-phase categories are not on any round's
    path."""
    rounds: Dict[tuple, List[Dict]] = defaultdict(list)
    for e in trace.get("traceEvents", ()):
        if e.get("ph") != "X" or e.get("cat") not in _PHASE_INDEX:
            continue
        args = e.get("args") or {}
        rnd = args.get("round", -1)
        if rnd is None or int(rnd) < 0:
            continue
        t0 = float(e.get("ts", 0.0)) / 1e6
        rounds[(int(args.get("epoch", 0)),
                str(args.get("group", "")), int(rnd))].append({
            "phase": e["cat"], "name": e.get("name", ""),
            "host": str(args.get("host", "?")),
            "process": args.get("process", 0),
            "t0": t0, "t1": t0 + float(e.get("dur", 0.0)) / 1e6,
            "err_s": float(args.get("clock_err_us", 0.0)) / 1e6,
            "args": args})
    return dict(rounds)


def analyze(trace: Dict) -> Dict:
    """Attribute every round's duration to its gating (host, phase,
    span) and aggregate the per-host gating fractions.

    Returns ``{"rounds", "attributed_s", "max_clock_err_s", "hosts":
    {host: {"gating_s", "fraction", "phases": {phase: s}, "spans":
    {span name: s}}}, "top": [host, fraction] | None}``.
    """
    rounds = round_spans(trace)
    hosts: Dict[str, Dict] = defaultdict(lambda: {
        "gating_s": 0.0,
        "phases": defaultdict(float),
        "spans": defaultdict(float)})
    total = 0.0
    max_err = 0.0
    for _key, spans in sorted(rounds.items()):
        mark = min(s["t0"] for s in spans)
        for phase in PHASES:
            in_phase = [s for s in spans if s["phase"] == phase]
            if not in_phase:
                continue
            gate = max(in_phase, key=lambda s: s["t1"])
            max_err = max(max_err, gate["err_s"])
            seg = gate["t1"] - mark
            if seg <= 0:
                continue   # finished before the previous gate: hidden
            h = hosts[gate["host"]]
            h["gating_s"] += seg
            h["phases"][phase] += seg
            h["spans"][gate["name"]] += seg
            total += seg
            mark = gate["t1"]
    out_hosts: Dict[str, Dict] = {}
    for host, h in hosts.items():
        out_hosts[host] = {
            "gating_s": round(h["gating_s"], 6),
            "fraction": round(h["gating_s"] / total, 6) if total else 0.0,
            "phases": {p: round(v, 6)
                       for p, v in sorted(h["phases"].items())},
            "spans": {n: round(v, 6)
                      for n, v in sorted(h["spans"].items())},
        }
    top = None
    if out_hosts:
        name = max(out_hosts, key=lambda h: out_hosts[h]["gating_s"])
        top = [name, out_hosts[name]["fraction"]]
    return {"rounds": len(rounds), "attributed_s": round(total, 6),
            "max_clock_err_s": round(max_err, 6),
            "hosts": out_hosts, "top": top}


def render_table(report: Dict, top: int = 8) -> str:
    """The per-host gating-fraction table, worst first."""
    lines = [f"rounds analyzed: {report['rounds']}   "
             f"attributed: {report['attributed_s']:.3f}s   "
             f"clock error bound: "
             f"{report['max_clock_err_s'] * 1e3:.2f}ms"]
    header = (f"{'host':<24} {'gating_s':>10} {'fraction':>9}  "
              f"by phase")
    lines.append(header)
    lines.append("-" * len(header))
    ranked = sorted(report["hosts"].items(),
                    key=lambda kv: -kv[1]["gating_s"])[:top]
    for host, h in ranked:
        phases = " ".join(f"{p}={v:.3f}s"
                          for p, v in sorted(h["phases"].items(),
                                             key=lambda kv: -kv[1]))
        lines.append(f"{host:<24} {h['gating_s']:>10.3f} "
                     f"{h['fraction']:>9.1%}  {phases}")
    if report["top"]:
        lines.append(f"critical-path host: {report['top'][0]} "
                     f"({report['top'][1]:.1%} of attributed time)")
    else:
        lines.append("no round spans found (is HOROVOD_TRACE enabled?)")
    return "\n".join(lines)
