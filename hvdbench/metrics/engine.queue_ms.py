"""``engine.queue_ms``: host milliseconds a step that the step's entries
waited in the engine's queue, enqueue to the cycle's drain (the ``submit``
spans' intervals), the median over the window's steps of their ``step``
spans' ``queue_ms`` (``hvdbench.spans``): the cycle's batching delay.
Nothing to read where the port records no step span."""

import statistics

from hvdbench import spans


def read(ctx):
    steps = spans.window_steps(ctx["window"]["steps"])
    if steps is None:
        return None
    return statistics.median(s["args"]["queue_ms"] for s in steps)
