"""``nccl.device_ms``: device milliseconds a step of NCCL's kernels (their
intervals' union).  Nothing on a device (the CPU's tests): nothing to
read; device time but no NCCL kernel raises, as only cells on several
cards list this metric."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0:
        return None
    if t["layer_s"]["nccl"] <= 0:
        raise LookupError("nccl.device_ms: no NCCL kernel in the traced "
                          "steps")
    return 1e3 * t["layer_s"]["nccl"] / t["steps"]
