"""``xent_roofline``: the vocabulary cross-entropy's least time over its
device time, in percent.  The least time is ``roofline.xent_work`` at the
card's peaks, summed over the forward calls of the profiled steps and
their backward nodes; the device time is the union of the kernels
launched inside the harness's range around
``ops.fused_xent.fused_xent_mean`` and inside the ``_FusedXentSumBackward``
nodes.  Nothing on a device (the CPU's tests):
nothing to read.  A cell that lists this metric runs the layer, so a
capture with device time but no recorded call, or no backward node, or
no device time in the layer's ranges raises: a caller that bypassed the
harness's wrapper, or a renamed autograd Function, would otherwise leave
the layer's work to ``model.device_ms``."""

from hvdbench.roofline import least_s, xent_work
from hvdbench.trace import XENT_BACKWARD


def read(ctx):
    t, calls = ctx["trace"], ctx["calls"].get("xent", [])
    if t["busy_s"] <= 0:
        return None
    device_s = t["layer_s"]["xent"]
    n_bwd = t["ranges"].get(XENT_BACKWARD, 0)
    if not calls or not n_bwd or device_s <= 0:
        raise LookupError(
            f"xent_roofline: {len(calls)} calls through "
            f"ops.fused_xent.fused_xent_mean, "
            f"{n_bwd} {XENT_BACKWARD} nodes and {device_s} s of the layer's "
            f"device time in the traced steps")
    fwd = sum(least_s(*xent_work(*c, backward=False)) for c in calls)
    bwd = sum(least_s(*xent_work(*c, backward=True))
              for c in calls) / len(calls) * n_bwd
    return 100.0 * (fwd + bwd) / device_s
