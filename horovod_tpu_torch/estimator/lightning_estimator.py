"""LightningEstimator: the reference's third estimator flavor.

Counterpart: ``horovod_tpu/estimator/lightning_estimator.py``; reference
parity: ``horovod/spark/lightning/estimator.py`` (SURVEY.md §2.2).  With
``lightning`` (or ``pytorch_lightning``) importable it trains a
``LightningModule`` over the port's launcher by driving the module's own
``training_step`` / ``configure_optimizers`` contract through
``DistributedOptimizer``, on ``device`` as the :class:`TorchEstimator`
does; without it, construction raises a clear ImportError naming the
missing dependency.
"""

from __future__ import annotations

import io
import uuid
from typing import Any, Optional, Sequence

import numpy as np

from .. import DeviceLike, resolve_device
from .store import Store
from .torch_estimator import _load


def _lightning_module_cls():
    try:
        import lightning  # noqa: F401
        return lightning.LightningModule
    except ImportError:
        try:
            import pytorch_lightning  # noqa: F401
            return pytorch_lightning.LightningModule
        except ImportError:
            return None


def _first_optimizer(ret):
    """Normalize configure_optimizers()'s documented return forms —
    a single optimizer, a list/tuple of optimizers, a list of config
    dicts, an ``([optimizers], [schedulers])`` pair, or a dict with an
    ``"optimizer"`` key — down to the first optimizer.  Schedulers are
    dropped (the estimator drives fixed-epoch training)."""
    while isinstance(ret, (dict, list, tuple)):
        ret = ret["optimizer"] if isinstance(ret, dict) else ret[0]
    return ret


def _train_on_worker(model_bytes, X, y, epochs, batch_size, seed,
                     validation=0.0):
    """Runs on every launched worker."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.runtime import device

    from ._worker import run_data_parallel_training
    module = _load(model_bytes).to(device())
    module.train()

    def loss_of_batch(m, xb, yb, step_idx):
        out = m.training_step((xb, yb), step_idx)
        return out["loss"] if isinstance(out, dict) else out

    hist = run_data_parallel_training(
        module, _first_optimizer(module.configure_optimizers()),
        loss_of_batch, X, y, epochs, batch_size, seed,
        validation=validation)

    if hvd.rank() == 0:
        buf = io.BytesIO()
        torch.save(module.cpu(), buf)
        return {"module": buf.getvalue(), "history": hist["loss"],
                "val_history": hist["val_loss"]}
    return None


class LightningEstimator:
    """sklearn-style fit/predict around a ``LightningModule``.

    Drives the module's ``training_step``/``configure_optimizers``
    contract on ``num_proc`` launched workers on ``device`` with
    data-parallel gradient reduction; rank 0's fitted module comes back
    (on the CPU in the Store) for ``predict`` on ``device``.  Requires PyTorch Lightning — absent, ``__init__``
    raises ImportError immediately (fail at construction, not at fit).
    """

    def __init__(self, model, num_proc: int = 2, epochs: int = 1,
                 batch_size: int = 32, store: Optional[Store] = None,
                 seed: int = 0, env: Optional[dict] = None,
                 port: int = 0, validation: float = 0.0,
                 device: DeviceLike = None):
        lm = _lightning_module_cls()
        if lm is None:
            raise ImportError(
                "LightningEstimator needs `lightning` or "
                "`pytorch_lightning`, neither of which is installed. "
                "Use TorchEstimator for plain torch modules.")
        if not isinstance(model, lm):
            raise TypeError(f"model must be a LightningModule, got "
                            f"{type(model).__name__}")
        self.model = model
        self.num_proc = num_proc
        self.epochs = epochs
        self.batch_size = batch_size
        self.store = store
        self.seed = seed
        self.env = env
        self.port = port
        if not 0.0 <= validation < 1.0:
            raise ValueError(
                f"validation must be a fraction in [0, 1), got {validation}")
        self.validation = validation
        self.device = device

    def fit(self, X: Sequence, y: Sequence) -> "LightningModelWrapper":
        import torch

        from ..runner import api as runner_api

        buf = io.BytesIO()
        torch.save(self.model, buf)
        extra = {} if self.port == 0 else {"port": self.port}
        results = runner_api.run(
            _train_on_worker,
            args=(buf.getvalue(), np.asarray(X), np.asarray(y),
                  self.epochs, self.batch_size, self.seed,
                  self.validation),
            np=self.num_proc, env=self.env,
            device=None if self.device is None else str(self.device),
            **extra)
        fitted = next(r for r in results if r is not None)
        if self.store is not None:
            run_id = f"lightning-{uuid.uuid4().hex[:8]}"
            self.store.save_checkpoint(run_id, fitted)
        return LightningModelWrapper(_load(fitted["module"]),
                                     fitted["history"],
                                     fitted.get("val_history"),
                                     device=self.device)


class LightningModelWrapper:
    """Fitted module + per-epoch loss history (parity with
    TorchModel.history — the reference's lightning estimator records
    metrics on the returned model); the module lives on ``device``."""

    def __init__(self, module: Any, history: Optional[list] = None,
                 val_history: Optional[list] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.module = (module.to(self.device) if hasattr(module, "to")
                       else module)
        self.history = list(history or [])
        self.val_history = list(val_history or [])

    def predict(self, X) -> np.ndarray:
        import torch
        self.module.eval()
        with torch.no_grad():
            out = self.module(torch.from_numpy(np.asarray(X)).to(
                self.device))
        return out.cpu().numpy()
