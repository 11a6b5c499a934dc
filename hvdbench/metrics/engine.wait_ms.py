"""``engine.wait_ms``: host milliseconds a step that the step's thread
spent blocked on the engine's handles (``Handle.synchronize``/``wait``),
the median over the window's steps of their ``step`` spans' ``wait_ms``
(``hvdbench.spans``): the exchange as the step's thread feels it.
Nothing to read where the port records no step span."""

import statistics

from hvdbench import spans


def read(ctx):
    steps = spans.window_steps(ctx["window"]["steps"])
    if steps is None:
        return None
    return statistics.median(s["args"]["wait_ms"] for s in steps)
