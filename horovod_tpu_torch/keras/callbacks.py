"""Keras training callbacks (counterpart: ``horovod_tpu/keras/callbacks.py``).

Reference parity: ``horovod/_keras/callbacks.py`` (SURVEY.md §2.2) —
``BroadcastGlobalVariablesCallback`` (weight sync at train start),
``MetricAverageCallback`` (allreduce-averaged epoch metrics),
``LearningRateWarmupCallback`` (linear LR ramp over the first epochs,
scaling to ``size()`` ranks, per the large-batch training recipe the
reference ships) and ``LearningRateScheduleCallback`` (staircase /
smooth LR decay over an epoch range).
"""

from __future__ import annotations

import numpy as np
import tensorflow as tf

keras = tf.keras


def _set_model_lr(model, lr: float):
    """Assign the optimizer's learning rate (shared by the LR callbacks:
    one place to extend when an optimizer's learning_rate is a schedule
    object rather than a variable/attribute)."""
    opt = model.optimizer
    lr_attr = getattr(opt, "learning_rate", None)
    if lr_attr is None:
        return
    if hasattr(lr_attr, "assign"):
        lr_attr.assign(lr)
    else:
        opt.learning_rate = lr


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast initial model + optimizer state from ``root_rank`` so all
    ranks start identical (reference: BroadcastGlobalVariablesCallbackImpl).
    """

    def __init__(self, root_rank: int = 0, process_set=None):
        super().__init__()
        self.root_rank = root_rank
        self.process_set = process_set
        self.broadcast_done = False

    def on_batch_begin(self, batch, logs=None):
        if self.broadcast_done:
            return
        from ..tensorflow import broadcast_variables
        broadcast_variables(self.model.weights, self.root_rank,
                            process_set=self.process_set)
        opt = getattr(self.model, "optimizer", None)
        if opt is not None and getattr(opt, "variables", None):
            vars_ = opt.variables if not callable(opt.variables) \
                else opt.variables()
            broadcast_variables([v for v in vars_], self.root_rank,
                                process_set=self.process_set)
        self.broadcast_done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average epoch metrics over ranks before other callbacks see them
    (reference: MetricAverageCallbackImpl, used so checkpoint/early-stop
    decisions agree across ranks): each metric as an fp32 scalar through
    the engine."""

    def __init__(self, process_set=None):
        super().__init__()
        self.process_set = process_set

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        from .. import api
        from ..tensorflow import to_torch
        for k in sorted(logs):
            v = logs[k]
            if isinstance(v, (int, float, np.floating, np.integer)):
                logs[k] = float(api.allreduce(
                    to_torch(np.float32(v)), name=f"metric.{k}",
                    process_set=self.process_set))


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Multiply the base LR by ``multiplier`` over an epoch range
    (reference: LearningRateScheduleCallbackImpl — the staircase /
    exponential-decay half of the large-batch recipe, which
    LearningRateWarmupCallback complements).

    ``multiplier`` is a constant or a callable ``epoch -> factor``;
    the schedule applies on ``[start_epoch, end_epoch)``.  With
    ``staircase=True`` the factor updates once per epoch; otherwise it
    updates every batch using fractional epochs (needs
    ``steps_per_epoch``)."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch=None, staircase: bool = True,
                 steps_per_epoch=None):
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0
        if not staircase and steps_per_epoch is None:
            raise ValueError(
                "staircase=False requires steps_per_epoch so the "
                "schedule can compute fractional epochs")
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def _in_range(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _set_lr(self, lr: float):
        _set_model_lr(self.model, lr)

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_range(epoch):
            self._set_lr(self.initial_lr * self.multiplier(epoch))

    def on_train_batch_begin(self, batch, logs=None):
        if self.staircase:
            return
        # keras passes the in-epoch batch index — no extra counter needed
        epoch = self.current_epoch + batch / self.steps_per_epoch
        if self._in_range(epoch):
            self._set_lr(self.initial_lr * self.multiplier(epoch))


class LearningRateWarmupCallback(keras.callbacks.Callback):
    """Linearly ramp LR from the single-rank rate to ``initial_lr`` over
    ``warmup_epochs`` (reference: LearningRateWarmupCallbackImpl;
    Goyal et al.'s gradual warmup for large-batch DP training)."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True, steps_per_epoch=None,
                 verbose: int = 0):
        super().__init__()
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0
        self._steps = 0

    def _set_lr(self, lr: float):
        _set_model_lr(self.model, lr)

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def on_train_batch_begin(self, batch, logs=None):
        if self.current_epoch >= self.warmup_epochs:
            return
        self._steps += 1
        if self.steps_per_epoch:
            progress = self._steps / (self.steps_per_epoch
                                      * self.warmup_epochs)
        else:
            progress = (self.current_epoch + 1) / self.warmup_epochs
        progress = min(progress, 1.0)
        from ..runtime import size
        base = self.initial_lr / size()
        self._set_lr(base + (self.initial_lr - base) * progress)

    def on_epoch_end(self, epoch, logs=None):
        if epoch == self.warmup_epochs - 1:
            self._set_lr(self.initial_lr)
            if self.verbose:
                print(f"Epoch {epoch + 1}: finished gradual learning rate "
                      f"warmup to {self.initial_lr}.")
