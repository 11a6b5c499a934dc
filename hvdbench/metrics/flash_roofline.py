"""``flash_roofline``: the attention calls' least time over their device
time, in percent.  The least time of a call is ``roofline.attention_work``
at the card's peaks; it is summed over the forward calls the profiled
steps made (recomputed forwards included) and their backward nodes.  The
device time is the union of the kernels launched inside the harness's
range around ``ops.flash_attention.flash_attention`` and inside the
``_FlashAttentionLseBackward`` nodes.  Nothing on a device (the CPU's tests):
nothing to read.  A cell that lists this metric runs the layer, so a
capture with device time but no recorded call, or no backward node, or
no device time in the layer's ranges raises: a caller that bypassed the
harness's wrapper, or a renamed autograd Function, would otherwise leave
the layer's work to ``model.device_ms``."""

from hvdbench.roofline import attention_work, least_s
from hvdbench.trace import FLASH_BACKWARD


def read(ctx):
    t, calls = ctx["trace"], ctx["calls"].get("flash", [])
    if t["busy_s"] <= 0:
        return None
    device_s = t["layer_s"]["flash"]
    n_bwd = t["ranges"].get(FLASH_BACKWARD, 0)
    if not calls or not n_bwd or device_s <= 0:
        raise LookupError(
            f"flash_roofline: {len(calls)} calls through "
            f"ops.flash_attention.flash_attention, "
            f"{n_bwd} {FLASH_BACKWARD} nodes and {device_s} s of the layer's "
            f"device time in the traced steps")
    fwd = sum(least_s(*attention_work(*c, backward=False)) for c in calls)
    bwd = sum(least_s(*attention_work(*c, backward=True))
              for c in calls) / len(calls) * n_bwd
    return 100.0 * (fwd + bwd) / device_s
