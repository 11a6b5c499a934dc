"""Elastic state for tf.keras models (counterpart:
``horovod_tpu/tensorflow/elastic.py``; reference:
``horovod/tensorflow/elastic.py`` ``TensorFlowKerasState`` — SURVEY.md
§2.2).

``TensorFlowKerasState(model, optimizer=None, **scalars)`` snapshots
the model (and optimizer) weights in memory on ``commit()``, rolls back
on ``restore()`` after a collective failure, and ``sync()``s everything
after membership changes — the TF face of the same elastic machinery
:class:`horovod_tpu_torch.elastic.TorchState` gives torch modules.  As
there, ``sync()`` spreads the state of the lowest rank that did not
start fresh (``State.sync_root``).  Use with ``@hvd.elastic.run`` as
upstream:

    state = hvd.elastic.TensorFlowKerasState(model, optimizer=opt,
                                             batch=0, epoch=0)

    @hvd.elastic.run
    def train(state): ...
"""

from __future__ import annotations

import copy
import logging

from ..elastic.state import FrameworkState

logger = logging.getLogger("horovod_tpu_torch")


class TensorFlowKerasState(FrameworkState):
    """Elastic snapshot/sync for keras models + optimizers + scalars
    (scalar/attribute machinery shared via FrameworkState)."""

    def __init__(self, model, optimizer=None, **kwargs):
        super().__init__(
            model=model,
            optimizer=(optimizer if optimizer is not None
                       else getattr(model, "optimizer", None)),
            **kwargs)

    def _opt_vars(self):
        opt = self._optimizer
        if opt is None:
            return []
        vars_ = getattr(opt, "variables", None)
        if vars_ is None:
            return []
        return list(vars_() if callable(vars_) else vars_)

    # State interface ----------------------------------------------------
    def save(self):
        opt_vars = self._opt_vars()
        names = [v.name for v in opt_vars]
        self._saved = {
            "model": [w.copy() for w in self._model.get_weights()],
            # keyed by name so slot variables created AFTER a commit are
            # detected on restore instead of silently mis-zipped
            "optimizer": ({v.name: v.numpy().copy() for v in opt_vars}
                          if len(set(names)) == len(names)
                          else [v.numpy().copy() for v in opt_vars]),
            "scalars": copy.deepcopy(self._scalars),
        }

    def restore(self):
        if self._saved.get("model"):
            self._model.set_weights(
                [w.copy() for w in self._saved["model"]])
        saved_opt = self._saved.get("optimizer", {})
        cur = self._opt_vars()
        if isinstance(saved_opt, dict):
            missing = [v.name for v in cur if v.name not in saved_opt]
            if missing:
                logger.warning(
                    "TensorFlowKerasState.restore(): optimizer variables "
                    "created after the last commit cannot be rolled back "
                    "(%s) — commit() after the first training step so "
                    "slot variables are captured.", ", ".join(missing))
            for v in cur:
                if v.name in saved_opt:
                    v.assign(saved_opt[v.name])
        else:  # duplicate names: positional fallback
            if len(saved_opt) != len(cur):
                logger.warning(
                    "TensorFlowKerasState.restore(): optimizer variable "
                    "count changed since the last commit (%d -> %d); "
                    "only the common prefix is rolled back.",
                    len(saved_opt), len(cur))
            for var, val in zip(cur, saved_opt):
                var.assign(val)
        self._scalars = copy.deepcopy(self._saved.get("scalars", {}))

    def sync(self):
        """Broadcast the live model, optimizer and scalars from the sync
        root (after a membership change the new rank set must agree)."""
        from . import broadcast_object, broadcast_variables
        root = self.sync_root()
        variables = list(self._model.variables) + self._opt_vars()
        if variables:
            broadcast_variables(variables, root_rank=root)
        self._scalars = broadcast_object(self._scalars, root_rank=root,
                                         name="elastic.scalars")
        self.save()


# the TF elastic namespace mirrors upstream hvd.elastic: the run
# wrapper, sampler, and object state come from the shared machinery
from ..elastic import ElasticSampler, run  # noqa: E402,F401
from ..elastic.state import ObjectState, State  # noqa: E402,F401
