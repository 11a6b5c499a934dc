"""``optimizer.device_ms``: device milliseconds a step of the kernels
launched inside the ``Optimizer.step#…`` range (their intervals' union).
Nothing on a device (the CPU's tests): nothing to read; device time but no
such range raises, as every cell steps an optimizer."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0:
        return None
    if not t["ranges"].get("Optimizer.step"):
        raise LookupError("optimizer.device_ms: no Optimizer.step# range "
                          "in the traced steps")
    return 1e3 * t["layer_s"]["optimizer"] / t["steps"]
