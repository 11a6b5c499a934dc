"""``engine.host_ms``: host milliseconds a step the engine spent
dispatching collectives, from its own counter (``Engine.stats()``'s
``dispatch_ms``) over the profiled steps."""


def read(ctx):
    ms = ctx.get("engine_dispatch_ms")
    return None if ms is None else ms / ctx["trace"]["steps"]
