"""The collective-schedule recorder: where the port's data plane reports.

Counterpart: the jaxpr walk of ``horovod_tpu/analysis/schedule.py``
(``_walk``).  The JAX package reads its collective schedule off a traced
program; the eager port has no program to read, so every
``torch.distributed`` call of its data plane (``ops/collectives.py``,
``parallel/axis.py``, ``optim/distributed.py``, ``serving/worker.py``)
reports here as it is issued, in the JAX package's vocabulary:

* ``prim``: an all-reduce SUM/MIN/MAX is ``psum``/``pmin``/``pmax``, an
  all-gather ``all_gather``, a reduce-scatter ``reduce_scatter``, an
  all-to-all ``all_to_all``, an isend/irecv exchange ``ppermute``, a
  broadcast ``pbroadcast``;
* ``axes``: the axis the group belongs to: a process set is ``workers``,
  a hierarchy's groups ``hvd_local`` and ``workers``, a mesh's groups
  their axis (``dp`` is ``workers``; a recording may rename others, e.g.
  ``tp`` to ``hvd_model``), a serving slice its axis (``hvd_serve_mp``);
* ``inputs`` / ``outputs``: aval strings, ``bfloat16[260]``;
* ``bucket``: the fusion bucket the call belongs to, set by the bucket
  loops around it (:func:`set_bucket`, the counterpart of JAX's
  ``hvd_bucket<i>`` name scope); the engine numbers its fused responses
  in issue order (:func:`engine_bucket`);
* ``params``: JAX's eqn params of that primitive (``axis_size``,
  ``tiled``, ``all_gather_dimension``, ``scatter_dimension``,
  ``split_axis``/``concat_axis``, ``perm``, ``axis_index_groups``).

Every call site guards on :data:`ARMED`: disarmed, the recorder costs one
flag test a collective.  :func:`recording` arms it for a block and
collects the records of every thread (the engine issues from its own).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

#: True inside :func:`recording`; call sites test it before anything else.
ARMED = False

_LOCK = threading.Lock()
_LOCAL = threading.local()
_ACTIVE: Optional["Recording"] = None

#: the all-reduce op names of ``torch.distributed.ReduceOp`` and of the
#: runtime's ``ReduceOp``, as JAX primitives
PRIM_OF_OP = {"sum": "psum", "average": "psum", "adasum": "psum",
              "min": "pmin", "max": "pmax", "product": "pprod",
              "band": "pand", "bor": "por", "bxor": "pxor"}


class Recording:
    """The records of one armed block, in issue order (dicts in the
    layout of ``schedule.CollectiveRecord.as_dict``, ``path`` empty), and
    ``host_s``, the host seconds the recorder itself spent on them."""

    def __init__(self, axis_names: Dict[str, str], mesh=None):
        self.axis_names = dict(axis_names)
        self.mesh = mesh
        self.records: List[dict] = []
        self.engine_buckets = 0
        self.host_s = 0.0


def aval(t) -> str:
    """A tensor's aval string: ``bfloat16[2x130]``, ``float32[]``."""
    dtype = str(t.dtype).removeprefix("torch.")
    return f"{dtype}[{'x'.join(str(int(d)) for d in t.shape)}]"


def _op_name(op) -> str:
    """``dist.ReduceOp.SUM`` or the runtime's ``"sum"`` → ``"sum"``."""
    if isinstance(op, str):
        return op.lower()
    name = getattr(op, "name", None) or str(op)
    return name.rsplit(".", 1)[-1].lower()


def _mesh_axis(rec: Recording, group) -> Optional[str]:
    """The axis of the recording's mesh, else of the entered one, whose
    group ``group`` is."""
    meshes = [rec.mesh]
    try:
        from ..parallel.mesh import current_mesh
        meshes.append(current_mesh())
    except ImportError:  # pragma: no cover - the package is whole
        pass
    for mesh in meshes:
        if mesh is None:
            continue
        for name in mesh.axis_names:
            if mesh.axis_size(name) > 1 and mesh.group(name) is group:
                return name
    return None


def _axes(rec: Recording, group, axis) -> List[str]:
    if axis is None:
        axis = getattr(group, "axis", None)
    if axis is None:
        from ..runtime import ProcessSet
        if isinstance(group, ProcessSet):
            axis = "workers"
        else:
            axis = _mesh_axis(rec, group) or "?"
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return [rec.axis_names.get(a, a) for a in names]


def note(prim: str, group, inputs: Sequence, outputs: Sequence,
         axis=None, bucket: Any = "scope", **params) -> None:
    """Record one collective about to be issued over ``group`` (a process
    set, a ``runtime.SubGroup``; ``axis``, a name or a tuple of names,
    when the call site knows it).  Call only when :data:`ARMED`."""
    rec = _ACTIVE
    if rec is None:
        return
    t0 = time.perf_counter()
    if bucket == "scope":
        bucket = getattr(_LOCAL, "bucket", None)
    entry = {"prim": prim, "axes": _axes(rec, group, axis),
             "inputs": [aval(t) for t in inputs],
             "outputs": [aval(t) for t in outputs],
             "path": "", "bucket": bucket,
             "params": dict(sorted(params.items()))}
    with _LOCK:
        entry["index"] = len(rec.records)
        rec.records.append(entry)
        rec.host_s += time.perf_counter() - t0


def reduce(op, group, t, axis=None) -> None:
    """An all-reduce of ``t`` by ``op`` (in place: input and output)."""
    note(PRIM_OF_OP.get(_op_name(op), _op_name(op)), group, [t], [t],
         axis=axis, axis_index_groups=None)


def gather(group, inp, out, dim: int = 0, tiled: bool = True,
           axis=None) -> None:
    note("all_gather", group, [inp], [out], axis=axis,
         all_gather_dimension=dim, axis_index_groups=None,
         axis_size=group.size(), tiled=tiled)


def scatter(group, inp, out, dim: int = 0, axis=None) -> None:
    note("reduce_scatter", group, [inp], [out], axis=axis,
         axis_index_groups=None, axis_size=group.size(),
         scatter_dimension=dim, tiled=True)


def exchange(group, inp, out, split: int = 0, concat: int = 0,
             axis=None) -> None:
    note("all_to_all", group, [inp], [out], axis=axis,
         axis_index_groups=None, concat_axis=concat, split_axis=split,
         tiled=True)


def permute(group, inp, out, perm, axis=None) -> None:
    note("ppermute", group, [inp], [out], axis=axis,
         perm=[list(p) for p in perm])


def broadcast(group, t, root: int, axis=None) -> None:
    note("pbroadcast", group, [t], [t], axis=axis, source=int(root))


def set_bucket(bucket: Optional[int]) -> None:
    """The fusion bucket of this thread's next collectives (None: none).
    Call only when :data:`ARMED`."""
    _LOCAL.bucket = bucket


def engine_bucket() -> Optional[int]:
    """The bucket of an engine response: the scope's when a bucket loop
    set one, else the response's ordinal in this recording."""
    scoped = getattr(_LOCAL, "bucket", None)
    if scoped is not None or _ACTIVE is None:
        return scoped
    with _LOCK:
        b = _ACTIVE.engine_buckets
        _ACTIVE.engine_buckets += 1
    return b


@contextlib.contextmanager
def recording(axis_names: Optional[Dict[str, str]] = None, mesh=None):
    """Arm the recorder for the block; yields the :class:`Recording`.

    ``axis_names`` renames axes as they are recorded (``dp`` is always
    ``workers``); ``mesh`` resolves the groups of a ``ParallelMesh`` that
    is not entered.  Recordings do not nest."""
    global ARMED, _ACTIVE
    rec = Recording({"dp": "workers", **(axis_names or {})}, mesh=mesh)
    with _LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a schedule recording is already armed")
        _ACTIVE = rec
        ARMED = True
    _LOCAL.bucket = None
    try:
        yield rec
    finally:
        with _LOCK:
            ARMED = False
            _ACTIVE = None
        _LOCAL.bucket = None
