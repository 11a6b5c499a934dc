"""Exception types of the port (counterpart: ``horovod_tpu/exceptions.py``).

The JAX package's error surface, less the elastic driver's
``HostsUpdatedInterrupt`` (ROADMAP.md A8): ``HorovodInternalError`` when a
collective fails, ``NotInitializedError`` before ``hvd.init()``,
``StallError`` when a negotiation waits past its deadline.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective operation failed (peer died, diverged or timed out)."""


class NotInitializedError(HorovodTpuError):
    """An API requiring ``hvd.init()`` was called before initialization."""

    def __init__(self, name: str = "this function"):
        super().__init__(
            f"horovod_tpu_torch has not been initialized; call hvd.init() "
            f"before using {name}.")


class StallError(HorovodTpuError):
    """Raised when a negotiation round waits past its deadline."""
