"""Exception types of the port (counterpart: ``horovod_tpu/exceptions.py``).

The JAX package's error surface: ``HorovodInternalError`` when a
collective fails, ``HostsUpdatedInterrupt`` when the elastic driver
changed the job's membership, ``NotInitializedError`` before
``hvd.init()``, ``StallError`` when a negotiation waits past its deadline.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective operation failed (peer died, diverged or timed out)."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The elastic driver changed the job's hosts (raised at the next
    ``state.commit()``).

    Carries ``skip_sync``: True when hosts were only removed, so the
    survivors' state is still consistent and ``state.sync()`` may be
    skipped.
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class NotInitializedError(HorovodTpuError):
    """An API requiring ``hvd.init()`` was called before initialization."""

    def __init__(self, name: str = "this function"):
        super().__init__(
            f"horovod_tpu_torch has not been initialized; call hvd.init() "
            f"before using {name}.")


class StallError(HorovodTpuError):
    """Raised when a negotiation round waits past its deadline."""
