"""``device.idle_share``: the share of the measured window in which the
card ran nothing, in percent: one less the card's busy time a step (the
union of every kernel's interval over the profiled steps, any stream, rank
0's card) times the window's steps, over the window's wall time.  The
profiled steps' own wall time is not used: the profiler's host cost
stretches it (the result line's ``device.busy_s`` and ``window_s`` are the
profiled steps')."""


def read(ctx):
    t, w = ctx["trace"], ctx["window"]
    busy = t["busy_s"] / t["steps"] * w["steps"]
    return 100.0 * (1.0 - busy / w["seconds"])
