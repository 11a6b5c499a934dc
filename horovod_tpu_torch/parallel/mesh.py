"""Named parallel axes over torch devices.

Counterpart: ``horovod_tpu/parallel/mesh.py``.  ``MeshConfig`` keeps the
JAX package's axes (dp, pp, sp, tp and an optional dedicated ep) and
``ParallelMesh`` answers the same queries.  The port runs one process per
GPU, so a mesh holds this process's device only: dp = 1 on its own, or
dp = ``hvd.size()`` when the runtime is initialized at that size, where the
mesh also holds the global process set whose ranks the dp axis spans.  A
mesh with tp, sp, pp or ep above 1 raises ``NotImplementedError`` until
the parallel layouts are ported (ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import DeviceLike, resolve_device
from .. import runtime

AXIS_ORDER = ("dp", "pp", "sp", "tp")
AXIS_ORDER_EP = ("dp", "pp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: Optional[int] = None  # None → experts sharded over the dp axis

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * (self.ep or 1)

    def axis_sizes(self) -> Dict[str, int]:
        sizes = {"dp": self.dp, "pp": self.pp, "sp": self.sp, "tp": self.tp}
        if self.ep:
            sizes["ep"] = self.ep
        return sizes


class ParallelMesh:
    """A named multi-axis mesh: this process's device and, when the
    runtime is initialized, the process set the dp axis spans.

    ``devices`` defaults to the runtime's device when ``hvd.init()`` has
    run, else to the current CUDA device (raising without one; pass
    ``[torch.device("cpu")]`` to run on the CPU).  ``ep`` is by default an
    alias of the dp axis, as in the JAX package.
    """

    def __init__(self, config: MeshConfig,
                 devices: Optional[Sequence[DeviceLike]] = None):
        model_axes = {k: v for k, v in config.axis_sizes().items()
                      if k != "dp" and v > 1}
        if model_axes:
            raise NotImplementedError(
                f"mesh axes {model_axes} ({config}) need the parallel "
                f"layouts of the port (ROADMAP.md A6); it runs dp only")
        self.config = config
        #: the global process set when the runtime is initialized: the dp
        #: axis is its ranks, and the train step reduces over it
        self.process_set = None
        if runtime.is_initialized():
            if config.dp != runtime.size():
                raise ValueError(
                    f"MeshConfig(dp={config.dp}) on a runtime of "
                    f"{runtime.size()} ranks: dp must be hvd.size()")
            self.process_set = runtime._get_global_process_set()
            own = runtime.device()
        elif config.dp != 1:
            raise ValueError(
                f"MeshConfig(dp={config.dp}) needs the runtime initialized "
                f"at that size: call hvd.init() in each of {config.dp} "
                f"processes first")
        else:
            own = None
        devices = ([own or resolve_device(None)] if devices is None
                   else [torch.device(d) for d in devices])
        if len(devices) != 1 or (own is not None and devices[0] != own):
            raise ValueError(f"a process's mesh holds its own device only "
                             f"({own or 'one device'}), got {devices}")
        self.devices = devices
        self.ep_axis = "ep" if config.ep else "dp"

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER_EP if self.config.ep else AXIS_ORDER

    def axis_size(self, name: str) -> int:
        if name == "ep" and self.config.ep is None:
            return self.config.dp  # aliased onto dp
        return self.config.axis_sizes()[name]
