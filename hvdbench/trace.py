"""The traced steps: a ``torch.profiler`` capture reduced to device time by
layer, the device's busy time, and the breakdown.

Layers are found by host ranges.  The harness opens its own
``record_function`` ranges around the calls into the attention and the
cross-entropy entries (:data:`FLASH_RANGE`, :data:`XENT_RANGE`) and around
each step (:data:`STEP_RANGE`); the profiler itself names each autograd
backward node (``autograd::engine::evaluate_function: <Node>``) and each
optimizer step (``Optimizer.step#<Class>.step``).  A kernel belongs to the
innermost layer range open, on the launching thread, when the host op that
launched it started; NCCL's kernels go by name.  A layer's device time is
the union of its kernels' intervals, so overlap between streams counts
once; the device's busy time is the union of all kernels' intervals.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

STEP_RANGE = "hvdbench.step"
FLASH_RANGE = "hvdbench.flash_attention"
XENT_RANGE = "hvdbench.fused_xent"

FLASH_BACKWARD = "_FlashAttentionLseBackward"
XENT_BACKWARD = "_FusedXentSumBackward"
BACKWARD = "evaluate_function: "
#: layer → substrings of the host ranges that open it
LAYER_RANGES = {
    "flash": (FLASH_RANGE, BACKWARD + FLASH_BACKWARD),
    "xent": (XENT_RANGE, BACKWARD + XENT_BACKWARD),
    "optimizer": ("Optimizer.step#",),
}
#: the harness's range around a forward entry → the backward node its
#: calls create (the port's autograd Function's name)
BACKWARD_OF = {FLASH_RANGE: FLASH_BACKWARD, XENT_RANGE: XENT_BACKWARD}
LAYERS = ("flash", "xent", "optimizer", "nccl", "model")

Interval = Tuple[int, int]


def union_ns(intervals: Sequence[Interval]) -> int:
    """Nanoseconds covered by the union of ``intervals``."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def _layer_of(name: str) -> Optional[str]:
    for layer, keys in LAYER_RANGES.items():
        if any(k in name for k in keys):
            return layer
    return None


class Events:
    """The plain records the reduction needs, from a profiler's kineto
    events or (in tests) built by hand.

    ``cpu``: ``(name, thread, start_ns, end_ns, correlation_id)`` of host
    ops and ranges; ``gpu``: ``(name, start_ns, end_ns,
    linked_correlation_id)`` of device operations."""

    def __init__(self, cpu, gpu):
        self.cpu = list(cpu)
        self.gpu = list(gpu)

    @classmethod
    def from_profiler(cls, prof) -> "Events":
        from torch.autograd import DeviceType
        cpu, gpu = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                cpu.append((e.name(), e.start_thread_id(), start, end,
                            e.correlation_id()))
            elif e.device_type() == DeviceType.CUDA and not _annotation(e):
                gpu.append((e.name(), start, end, e.linked_correlation_id()))
        return cls(cpu, gpu)


def _annotation(e) -> bool:
    """A host range's span as the device trace repeats it (a
    ``gpu_user_annotation``), not an operation on the device."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith(
        ("hvdbench.", "Optimizer.", "ProfilerStep#", "autograd::"))


def reduce(ev: Events, top: int = 10) -> Dict:
    """Reduce a capture of whole steps: the traced window (first step
    range's start to last one's end), the device's busy time, each
    layer's device time, the step count, the layer ranges' counts, the
    top device operations by name and the idle gaps by the host range
    open during them.  Raises where the harness's forward range of a layer
was entered in steps that ran a backward, but the layer's backward node
never was."""
    steps = sorted((s, e, th) for n, th, s, e, _ in ev.cpu if n == STEP_RANGE)
    if not steps:
        raise ValueError(f"no {STEP_RANGE} range in the capture")
    lo, hi, main = steps[0][0], steps[-1][1], steps[0][2]

    # the layer ranges by thread, sorted by start (they do not nest)
    ranges = collections.defaultdict(list)
    counts = collections.Counter()
    by_corr = {}
    for name, th, s, e, corr in ev.cpu:
        by_corr[corr] = (th, s)
        layer = _layer_of(name)
        if layer is not None and s >= lo and e <= hi:
            ranges[th].append((s, e, layer))
            counts[name if name.startswith("hvdbench.") else
                   name.rsplit(": ", 1)[-1].split("#")[0]] += 1
    backward_ran = any(BACKWARD in n for n, th, s, e, _ in ev.cpu
                       if s >= lo and e <= hi)
    for fwd, bwd in BACKWARD_OF.items():
        if counts[fwd] and backward_ran and not counts[bwd]:
            raise LookupError(
                f"{counts[fwd]} {fwd} calls and a backward ran, but no "
                f"{bwd} node: the port's autograd Function was renamed, "
                f"and its backward kernels would count as the model's")
    starts = {}
    for th in ranges:
        ranges[th].sort()
        starts[th] = [r[0] for r in ranges[th]]

    def layer_at(th, t):
        rs = ranges.get(th)
        if not rs:
            return None
        i = bisect.bisect_right(starts[th], t) - 1
        if i >= 0 and rs[i][0] <= t <= rs[i][1]:
            return rs[i][2]
        return None

    per_layer = {k: [] for k in LAYERS}
    every, by_name = [], collections.Counter()
    for name, s, e, corr in ev.gpu:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        every.append((s, e))
        by_name[name[:96]] += (e - s) / 1e9
        if "nccl" in name.lower():
            layer = "nccl"
        else:
            at = by_corr.get(corr) if corr else None
            layer = (layer_at(*at) if at is not None else None) or "model"
        per_layer[layer].append((s, e))

    idle = _label_gaps(gaps(every, lo, hi),
                       [(s, e, n) for n, th, s, e, _ in ev.cpu
                        if th == main])
    return {
        "steps": len(steps),
        "window_s": (hi - lo) / 1e9,
        "busy_s": union_ns(every) / 1e9,
        "layer_s": {k: union_ns(v) / 1e9 for k, v in per_layer.items()},
        "ranges": dict(counts),
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[n, s] for n, s in idle.most_common(top)],
    }


def _label_gaps(idle: List[Interval], host) -> collections.Counter:
    """Seconds of idle device time by the innermost host range open (on
    the step's thread) at the middle of each gap."""
    out = collections.Counter()
    if not idle:
        return out
    host = sorted(host)
    mids = sorted(((s + e) // 2, e - s) for s, e in idle)
    stack, i = [], 0
    for mid, length in mids:
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        stack = [h for h in stack if h[1] >= mid]
        label = stack[-1][2] if stack else "(no host range)"
        out[label[:96]] += length / 1e9
    return out

