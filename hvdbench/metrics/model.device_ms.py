"""``model.device_ms``: device milliseconds a step of every kernel outside
the attention, cross-entropy and optimizer ranges and outside NCCL: the
model's products, norms, activations and casts (and the engine's packing
copies)."""


def read(ctx):
    t = ctx["trace"]
    return 1e3 * t["layer_s"]["model"] / t["steps"]
