"""Named parallel axes over torch processes.

Counterpart: ``horovod_tpu/parallel/mesh.py``.  ``MeshConfig`` keeps the
JAX package's axes (dp, pp, sp, tp and an optional dedicated ep) and
``ParallelMesh`` answers the same queries.  The port runs one process per
GPU, so the mesh's "devices" are the runtime's ranks: a process's mesh
holds its own device only, and ``config.n_devices`` must be
``hvd.size()``.

A rank's coordinates are ``np.unravel_index(rank, shape)`` over
:data:`AXIS_ORDER` (:data:`AXIS_ORDER_EP` with a dedicated ep), tp
innermost: the layout of JAX's ``np.array(devices).reshape(shape)``.  Each
axis of size > 1 has one ``torch.distributed`` group for every line of
ranks that differ only in that coordinate; every rank makes every group,
in the same order (``new_group`` is collective over the world), on the
runtime's backend.  A line of every rank is the global process set's
group: the engine shares it, so collectives over it must not run while
the engine reduces.  ``ep=None`` aliases dp.

A mesh entered as a context (``with pmesh:``) is :func:`current_mesh`,
where the axis collectives of ``parallel/axis.py`` find their groups.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device
from .. import runtime

AXIS_ORDER = ("dp", "pp", "sp", "tp")  # ep is aliased onto dp by default
# a dedicated expert axis sits between sp and tp
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


def _subgroup(members: Sequence[int]) -> "runtime.SubGroup":
    """The group of ``members``, made at first use; a line of every rank
    (dp of a dp-only mesh) is the global process set's group, made at
    ``hvd.init()``, so such a mesh makes no group.  The runtime's process
    set table keeps each and drops it at shutdown, so no group, and with
    it rank 0's store, outlives the runtime."""
    groups = runtime._state().process_set_table.subgroups
    key = tuple(members)
    if key not in groups:
        world = runtime._get_global_process_set()
        group = (world.group if list(key) == world.ranks
                 else dist.new_group(list(key)))
        groups[key] = runtime.SubGroup(members, group)
    return groups[key]


class ParallelMesh:
    """A named multi-axis mesh over the runtime's ranks.

    ``devices`` defaults to the runtime's device when ``hvd.init()`` has
    run, else to the current CUDA device (raising without one; pass
    ``[torch.device("cpu")]`` to run on the CPU).  A mesh of more than one
    device needs the runtime initialized at that size.  ``process_set`` is
    the global process set when the runtime is initialized (the dp-only
    step reduces over it through the engine); :meth:`group` gives an
    axis's group.
    """

    def __init__(self, config: MeshConfig,
                 devices: Optional[Sequence[DeviceLike]] = None):
        self.config = config
        #: the global process set when the runtime is initialized
        self.process_set = None
        n = config.n_devices
        if runtime.is_initialized():
            if n != runtime.size():
                raise ValueError(
                    f"{config} spans {n} devices on a runtime of "
                    f"{runtime.size()} ranks: the mesh must cover "
                    f"hvd.size()")
            self.process_set = runtime._get_global_process_set()
            own, rank = runtime.device(), runtime.rank()
        elif n != 1:
            raise ValueError(
                f"{config} spans {n} devices: call hvd.init() in each of "
                f"{n} processes first")
        else:
            own, rank = None, 0
        devices = ([own or resolve_device(None)] if devices is None
                   else [torch.device(d) for d in devices])
        if len(devices) != 1 or (own is not None and devices[0] != own):
            raise ValueError(f"a process's mesh holds its own device only "
                             f"({own or 'one device'}), got {devices}")
        self.devices = devices
        self.ep_axis = "ep" if config.ep else "dp"
        sizes = config.axis_sizes()
        self.shape = tuple(sizes[a] for a in self.axis_names)
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(rank, self.shape))))
        self._groups: Dict[str, "runtime.SubGroup"] = {}
        if n > 1:
            for axis in self.axis_names:
                for line in self.lines(axis):
                    g = _subgroup(line)
                    if rank in line:
                        self._groups[axis] = g

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER_EP if self.config.ep else AXIS_ORDER

    def axis_size(self, name: str) -> int:
        if name == "ep" and self.config.ep is None:
            return self.config.dp  # aliased onto dp
        return self.config.axis_sizes()[name]

    def _resolve(self, name: str) -> str:
        return "dp" if name == "ep" and self.config.ep is None else name

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (JAX
        ``lax.axis_index``)."""
        return self.coords[self._resolve(name)]

    def lines(self, axis: str) -> List[List[int]]:
        """Every group of ranks that differ only in ``axis``'s coordinate,
        in the order every rank makes them; none for an axis of size 1."""
        names = self.axis_names
        i = names.index(self._resolve(axis))
        if self.shape[i] <= 1:
            return []
        others = [range(s) for j, s in enumerate(self.shape) if j != i]
        out = []
        for rest in itertools.product(*others):
            idx = list(rest)
            out.append([int(np.ravel_multi_index(
                tuple(idx[:i] + [c] + idx[i:]), self.shape))
                for c in range(self.shape[i])])
        return out

    def group(self, name: str):
        """This rank's group on axis ``name`` (a ``runtime.SubGroup``:
        ``ranks``, ``group``, ``size()``, ``rank()``), None for an axis of
        size 1."""
        g = self._groups.get(self._resolve(name))
        if g is not None and g.group is None:
            raise ValueError(f"the runtime this mesh's {name!r} group was "
                             f"made under has shut down: make the mesh "
                             f"again after hvd.init()")
        return g

    def __enter__(self):
        _ACTIVE_MESHES.append(self)
        return self

    def __exit__(self, *a):
        if _ACTIVE_MESHES and _ACTIVE_MESHES[-1] is self:
            _ACTIVE_MESHES.pop()
        return False


#: innermost-first stack of ParallelMesh contexts currently entered
_ACTIVE_MESHES: list = []


def current_mesh() -> Optional[ParallelMesh]:
    """The innermost active ``ParallelMesh`` context (None outside any)."""
    return _ACTIVE_MESHES[-1] if _ACTIVE_MESHES else None


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              pp: int = 1, sp: int = 1, tp: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None
              ) -> ParallelMesh:
    """Build a ParallelMesh; ``dp`` defaults to whatever ranks remain
    (``n_devices`` defaults to ``hvd.size()``, 1 without the runtime)."""
    n = n_devices or (runtime.size() if runtime.is_initialized() else 1)
    if dp is None:
        denom = pp * sp * tp
        if n % denom:
            raise ValueError(f"{n} devices not divisible by pp*sp*tp={denom}")
        dp = n // denom
    return ParallelMesh(MeshConfig(dp=dp, pp=pp, sp=sp, tp=tp),
                        devices=devices)


def factor_mesh(n: int, want_pp: bool = True) -> MeshConfig:
    """Factor ``n`` devices into a sensible (dp, pp, sp, tp) for dry runs:
    tp, then sp, then pp, then dp each take a factor of 2 while one is
    left; the rest goes to dp."""
    sizes = {"dp": 1, "pp": 1, "sp": 1, "tp": 1}
    order = ["tp", "sp", "pp", "dp"] if want_pp else ["tp", "sp", "dp"]
    rem = n
    for axis in order:
        if rem % 2 == 0 and rem > 1:
            sizes[axis] *= 2
            rem //= 2
    sizes["dp"] *= rem
    return MeshConfig(**sizes)
