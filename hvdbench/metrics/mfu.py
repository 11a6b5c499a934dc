"""``mfu``: model operations a second over the card's bf16 peak times the
chips, in percent, over the run's whole measured window (the profiled
steps come after it).  The operations are ``roofline.model_flops``'s
count (recomputation not counted) of every rank's steps."""

from hvdbench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    w = ctx["window"]
    if w["seconds"] <= 0:
        return None
    return 100.0 * w["flops"] / w["seconds"] / (PEAK_BF16_FLOPS
                                               * ctx["chips"])
