"""``host.gc_ms``: milliseconds a step of Python's collections, the
window's steps' ``step`` spans' ``gc_ms`` (``hvdbench.spans``: every
collection the port's hook timed inside a step, each generation) summed
over the steps' count.  A mean, as most steps hold no full collection.
Nothing to read where the port records no step span."""

from hvdbench import spans


def read(ctx):
    steps = spans.window_steps(ctx["window"]["steps"])
    if steps is None:
        return None
    return sum(s["args"]["gc_ms"] for s in steps) / len(steps)
