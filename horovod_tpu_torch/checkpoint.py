"""Durable checkpoints of trees of tensors.

Counterpart: ``horovod_tpu/checkpoint.py``, whose API this keeps:
``save(path, tree, step, force, asynchronous)``, ``wait``,
``restore(path, like, step)`` and ``latest_step``.  Reference parity: the
reference owns NO checkpoint format — its convention is "rank 0 writes
framework-native checkpoints" plus the elastic in-memory ``State``
(SURVEY.md §5.4).  The JAX package writes orbax; the port writes
``torch.save`` files of its own format: a checkpoint is a directory
(``path``, or ``path/<step>``) holding ``tree.pt``, written to a
temporary file and renamed into place, so a reader sees a whole file or
none.  The elastic ``State`` stays the recovery path (restore from
memory, not disk).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

import torch

from . import runtime
from .tree import tree_map

FILE = "tree.pt"

_pending: Optional[threading.Thread] = None
_pending_error: list = []


def _target(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    return path if step is None else os.path.join(path, str(step))


def _write(host_tree: Any, target: str) -> None:
    os.makedirs(target, exist_ok=True)
    final = os.path.join(target, FILE)
    tmp = f"{final}.tmp-{os.getpid()}"
    torch.save(host_tree, tmp)
    os.replace(tmp, final)


def _background_write(host_tree: Any, target: str) -> None:
    try:
        _write(host_tree, target)
    except BaseException as e:  # noqa: BLE001 - re-raised by wait()
        _pending_error.append(e)


def _drain() -> None:
    """Join an in-flight asynchronous write; re-raise its failure."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error:
        raise _pending_error.pop()


def save(path: str, tree: Any, step: Optional[int] = None,
         force: bool = False, asynchronous: bool = False):
    """Write ``tree`` (nested dicts/lists of tensors and picklable
    scalars) durably at ``path`` (``path/<step>`` with a ``step``).

    Rank 0 writes (the reference idiom); every rank then meets at a
    barrier so a save followed by ``restore`` or ``latest_step`` on
    another rank never races rank 0's write.  An existing checkpoint is
    overwritten only with ``force``.

    ``asynchronous=True`` returns once the tensors are copied to host
    memory and writes the file on a background thread — training resumes
    while bytes hit disk (call :func:`wait` before reading the files or
    exiting).  The barrier moves into :func:`wait`.
    """
    global _pending
    if runtime.rank() == 0:
        # drain the previous in-flight save first: a second handle would
        # make wait() forget the earlier checkpoint
        _drain()
        target = _target(path, step)
        if os.path.exists(os.path.join(target, FILE)) and not force:
            raise FileExistsError(
                f"checkpoint {target} exists; pass force=True to replace it")
        host = tree_map(lambda t: t.detach().to("cpu", copy=True)
                        if torch.is_tensor(t) else t, tree)
        if asynchronous:
            _pending = threading.Thread(
                target=_background_write, args=(host, target),
                name="hvd-checkpoint", daemon=True)
            _pending.start()
        else:
            _write(host, target)
    if not asynchronous:
        from . import api
        api.barrier()


def wait():
    """Block until an in-flight :func:`save(asynchronous=True)` is on
    disk, then barrier all ranks."""
    _drain()
    from . import api
    api.barrier()


def restore(path: str, like: Any, step: Optional[int] = None) -> Any:
    """Load the tree saved at ``path``; every rank reads it (reads are
    parallel-safe).  Each tensor lands on the device and in the dtype of
    the matching leaf of ``like``, an exemplar tree of the same
    structure."""
    loaded = torch.load(os.path.join(_target(path, step), FILE),
                        map_location="cpu", weights_only=True)
    return tree_map(lambda saved, ex: saved.to(device=ex.device,
                                               dtype=ex.dtype)
                    if torch.is_tensor(saved) and torch.is_tensor(ex)
                    else saved, loaded, like)


def latest_step(path: str) -> Optional[int]:
    """Largest integer subdirectory of ``path`` that holds a whole
    checkpoint (step-numbered saves)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path)
             if d.isdigit() and os.path.exists(os.path.join(path, d, FILE))]
    return max(steps) if steps else None
