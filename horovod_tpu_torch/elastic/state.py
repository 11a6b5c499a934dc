"""Elastic state objects: commit / restore / sync.

Counterpart: ``horovod_tpu/elastic/state.py`` (``State``,
``ObjectState``, ``FrameworkState``, ``ArrayState``) and
``horovod_tpu/torch/elastic.py`` (``TorchState``); reference parity:
``horovod/common/elastic.py`` and ``horovod/torch/elastic/state.py``
(SURVEY.md §5.4).  ``commit()`` is an *in-memory* snapshot (cheap,
per-batch); ``restore()`` rolls back to it after a failure; ``sync()``
broadcasts state to every rank after membership changes.  Durable
checkpoints are ``checkpoint.py``'s.

:class:`TensorState` takes ``ArrayState``'s place: it holds the port's
nested dicts and lists of tensors (parameters, batch-norm statistics,
optimizer state).  ``save`` clones every leaf on its device; ``restore``
copies the snapshot back *into* the live tensors, so an optimizer that
holds them keeps working; ``sync`` broadcasts every leaf in place.
Tensors survive a re-initialization of the runtime here (the JAX
package's device arrays die with its backends), so ``evacuate`` has
nothing to do.

``sync`` spreads the state of the lowest rank whose state did not start
fresh (:meth:`State.sync_root`), where the JAX package always takes rank
0: a worker the driver spawns into a running job holds only its initial
state, and when rank 0 dies its replacement takes rank 0.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, List

import torch

from ..tree import tree_leaves, tree_paths


class State:
    """Base elastic state (reference: common/elastic.py State)."""

    def __init__(self, **kwargs):
        self._host_messages: List = []
        self._reset_callbacks: List[Callable] = []
        # True while a worker that joined a running job syncs the state it
        # started with (elastic/runner.run)
        self._fresh = False
        for k, v in kwargs.items():
            setattr(self, k, v)

    def register_reset_callbacks(self, callbacks: List[Callable]):
        """Callbacks invoked after a reset (e.g. rebuild data loaders)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_messages.clear()
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp, update_res):
        self._host_messages.append((timestamp, update_res))

    def process_incoming_updates(self):
        """Raise HostsUpdatedInterrupt if the driver flagged a change."""
        from ..exceptions import HostsUpdatedInterrupt
        from .worker import HostUpdateResult
        if self._host_messages:
            msgs = self._host_messages
            self._host_messages = []
            # sync is skippable only when hosts were purely REMOVED: the
            # survivors already hold consistent state, whereas any added
            # worker starts empty and must receive state via sync
            skip = all(res == HostUpdateResult.REMOVED for _, res in msgs)
            raise HostsUpdatedInterrupt(skip_sync=skip)

    # subclass interface ----------------------------------------------------
    def commit(self):
        """Snapshot state in memory AND check for membership updates."""
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        self.process_incoming_updates()

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def sync_root(self) -> int:
        """The rank whose state ``sync`` spreads: the lowest whose state
        did not start fresh in this process, else 0."""
        from .. import api
        fresh = api.allgather_object(self._fresh, name="elastic.fresh")
        return next((r for r, f in enumerate(fresh) if not f), 0)

    def evacuate(self):
        """Move snapshots off the device ahead of a re-rendezvous that
        would invalidate device memory.  Tensors outlive the port's
        re-initialization, so the states here keep theirs in place."""

    def reset(self):
        pass


class FrameworkState(State):
    """Shared machinery for the model states (TorchState): a model +
    optimizer pair plus named scalars readable/writable as attributes.
    Subclasses implement save/restore/sync over their weight
    containers."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        self._model = model
        self._optimizer = optimizer
        self._scalars: Dict[str, Any] = dict(kwargs)
        self._saved: Dict[str, Any] = {}
        super().__init__()
        self.save()

    def __getattr__(self, name):
        scalars = object.__getattribute__(self, "_scalars")
        if name in scalars:
            return scalars[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        elif "_scalars" in self.__dict__ and name in self._scalars:
            self._scalars[name] = value
        else:
            object.__setattr__(self, name, value)

    @property
    def model(self):
        return self._model

    @property
    def optimizer(self):
        return self._optimizer


class ObjectState(State):
    """Elastic state for picklable Python attributes.

    Reference: ``horovod/common/elastic.py`` ObjectState — ``sync()``
    broadcasts the pickled attribute dict from the coordinator.
    """

    def __init__(self, bcast_object=None, get_rank=None, **kwargs):
        from .. import api, runtime
        self._bcast_object = bcast_object or functools.partial(
            api.broadcast_object, name="elastic.object_state")
        self._get_rank = get_rank or runtime.rank
        self._saved_state: Dict[str, Any] = {}
        super().__init__(**kwargs)
        self._attrs = list(kwargs.keys())
        self.save()

    def save(self):
        self._saved_state = {
            k: copy.deepcopy(getattr(self, k)) for k in self._attrs}

    def restore(self):
        for k, v in self._saved_state.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        if self._saved_state:
            synced = self._bcast_object(self._saved_state,
                                        root_rank=self.sync_root())
            for k, v in synced.items():
                setattr(self, k, v)
            self.save()


def _is_tree(x) -> bool:
    """A tensor, or a dict/list/tuple with a tensor among its leaves."""
    return (torch.is_tensor(x)
            or (isinstance(x, (dict, list, tuple))
                and any(torch.is_tensor(t) for t in tree_leaves(x))))


def _snapshot(tree):
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return copy.deepcopy(tree)


def _restore_into(saved, live):
    """``saved`` copied into ``live`` where the structure and every
    tensor's shape, dtype and device match, so holders of the live
    tensors (an optimizer) see the restored values; a fresh copy of
    ``saved`` wherever they do not.  A live tensor's gradient goes: it
    belongs to the failed step (a backward that died halfway leaves some
    gradients accumulated)."""
    if torch.is_tensor(saved):
        if (torch.is_tensor(live) and live.shape == saved.shape
                and live.dtype == saved.dtype
                and live.device == saved.device):
            with torch.no_grad():
                live.copy_(saved)
            live.grad = None
            return live
        return saved.clone()
    if isinstance(saved, dict) and isinstance(live, dict) \
            and live.keys() == saved.keys():
        for k in saved:
            live[k] = _restore_into(saved[k], live[k])
        return live
    if isinstance(saved, list) and isinstance(live, list) \
            and len(live) == len(saved):
        for i, v in enumerate(saved):
            live[i] = _restore_into(v, live[i])
        return live
    return _snapshot(saved)


class TensorState(State):
    """Elastic state for the port's trees of tensors (params, batch-norm
    state, optimizer state) plus picklable scalars (step, epoch, a
    sampler): the counterpart of the JAX package's ``ArrayState``.

    Keyword arguments that are tensors or dicts/lists holding tensors are
    trees; the rest are scalars.  Both read and write as attributes
    (``state.params``, ``state.step``).  ``commit`` clones every leaf on
    its device, ``restore`` copies the commit back into the live tensors
    in place and drops their gradients, and ``sync`` broadcasts every
    leaf from :meth:`sync_root` in place (``broadcast_parameters``) and the
    scalars by pickle (``broadcast_object``).
    """

    def __init__(self, **trees):
        self._trees: Dict[str, Any] = {}
        self._saved: Dict[str, Any] = {}
        self._scalar_state: Dict[str, Any] = {}
        super().__init__()
        for name, tree in trees.items():
            if _is_tree(tree):
                self._trees[name] = tree
            else:
                self._scalar_state[name] = tree
        self.save()

    def __getattr__(self, name):
        trees = object.__getattribute__(self, "_trees")
        if name in trees:
            return trees[name]
        scalars = object.__getattribute__(self, "_scalar_state")
        if name in scalars:
            return scalars[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if "_trees" in self.__dict__ and name in self._trees:
            self._trees[name] = value
        elif "_scalar_state" in self.__dict__ and \
                name in self._scalar_state:
            self._scalar_state[name] = value
        else:
            object.__setattr__(self, name, value)

    def save(self):
        self._saved = {
            "trees": {k: _snapshot(v) for k, v in self._trees.items()},
            "scalars": copy.deepcopy(self._scalar_state),
        }

    def restore(self):
        for k, v in self._saved.get("trees", {}).items():
            self._trees[k] = _restore_into(v, self._trees.get(k))
        self._scalar_state = copy.deepcopy(self._saved.get("scalars", {}))

    def sync(self):
        from .. import api
        from ..optim.distributed import broadcast_parameters
        root = self.sync_root()
        for k, tree in self._trees.items():
            broadcast_parameters(
                {f"{k}.{p}": t for p, t in zip(tree_paths(tree),
                                               tree_leaves(tree))
                 if torch.is_tensor(t)}, root_rank=root)
        self._scalar_state = api.broadcast_object(
            self._scalar_state, root, name="elastic.scalars")
        self.save()


class TorchState(FrameworkState):
    """Elastic snapshot/sync for a ``torch.nn.Module`` + optimizer +
    scalars (reference: ``hvd.elastic.TorchState``).

    ``commit`` snapshots the model's and optimizer's ``state_dict``s,
    ``restore`` loads them back after a collective failure, and ``sync``
    broadcasts the live parameters in place (``broadcast_parameters``),
    the optimizer state (``broadcast_optimizer_state``) and the scalars
    from :meth:`sync_root`::

        state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)

        @hvd.elastic.run
        def train(state): ...
    """

    def __init__(self, model: torch.nn.Module = None, optimizer=None,
                 **kwargs):
        super().__init__(model=model, optimizer=optimizer, **kwargs)

    def save(self):
        self._saved = {
            "model": (copy.deepcopy(self._model.state_dict())
                      if self._model is not None else None),
            "optimizer": (copy.deepcopy(self._optimizer.state_dict())
                          if self._optimizer is not None else None),
            "scalars": copy.deepcopy(self._scalars),
        }

    def restore(self):
        if self._saved.get("model") is not None:
            self._model.load_state_dict(
                copy.deepcopy(self._saved["model"]))
        if self._saved.get("optimizer") is not None:
            self._optimizer.load_state_dict(
                copy.deepcopy(self._saved["optimizer"]))
        self._scalars = copy.deepcopy(self._saved.get("scalars", {}))

    def sync(self):
        from .. import api
        from ..optim.distributed import (broadcast_optimizer_state,
                                         broadcast_parameters)
        root = self.sync_root()
        if self._model is not None:
            broadcast_parameters(self._model.state_dict(), root_rank=root)
        if self._optimizer is not None:
            broadcast_optimizer_state(self._optimizer, root_rank=root)
        self._scalars = api.broadcast_object(self._scalars, root,
                                             name="elastic.scalars")
        self.save()
