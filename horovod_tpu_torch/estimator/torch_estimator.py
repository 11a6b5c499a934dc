"""TorchEstimator: fit/predict orchestration over the launcher.

Counterpart: ``horovod_tpu/estimator/torch_estimator.py``; reference
parity: ``horovod/spark/torch/estimator.py`` (SURVEY.md §2.2) — an
sklearn-style estimator that ships a torch model and an optimizer
factory to ``np`` workers, trains data-parallel with per-worker shards,
checkpoints through the Store, and returns a fitted model wrapper with
``predict``.

The workers are the port's own launch (``runner.run``: fresh processes
per fit, the reference's Spark-task model), each with the runtime on
``device`` (``cuda:<local_rank>`` by default; ``"cpu"`` for gloo on the
CPU; ``"cuda:0"`` with ``env={"HOROVOD_CONTROLLER": "gloo"}`` for ranks
sharing one card) and ``DistributedOptimizer`` inside.  Inputs are
in-memory arrays (``fit(X, y)``) or an on-disk
:class:`~horovod_tpu_torch.data.ParquetDataset` (``fit(dataset)``), of
which only the handle rides the payload and each worker reads its own
shard.  Checkpoints and the weights that come back hold CPU tensors;
``predict`` runs on the estimator's device and returns numpy.

The function, the optimizer factory, the loss and the model's class reach
the workers by ``cloudpickle`` when it imports, else by ``pickle``, which
finds them by module and name: define them in an importable module.
"""

from __future__ import annotations

import io
import uuid
from typing import Any, Callable, List, Optional

import numpy as np

from .. import DeviceLike, resolve_device
from .store import Store


def _load(data: bytes):
    """A ``torch.save``'d module or state dict, on the CPU."""
    import torch
    return torch.load(io.BytesIO(data), map_location="cpu",
                      weights_only=False)


def _train_on_worker(model_bytes, opt_factory, loss_fn, X, y, epochs,
                     batch_size, seed, shuffle, validation):
    """Runs on every launched worker."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.runtime import device

    from ._worker import run_data_parallel_training
    model = _load(model_bytes).to(device())
    pre_sharded = False
    if y is None:
        # the on-disk data plane: the payload carried only the dataset
        # handle; read THIS worker's strided shard, the rows the
        # in-memory X[rank::size] holds
        X, y = X.read_xy(hvd.rank(), hvd.size())
        pre_sharded = True
    hist = run_data_parallel_training(
        model, opt_factory(model.parameters()),
        lambda m, xb, yb, _s: loss_fn(m(xb), yb),
        X, y, epochs, batch_size, seed, shuffle, validation,
        pre_sharded=pre_sharded)
    state = None
    if hvd.rank() == 0:
        buf = io.BytesIO()
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, buf)
        state = buf.getvalue()
    return {"state_dict": state, "history": hist["loss"],
            "val_history": hist["val_loss"]}


class TorchModel:
    """Fitted model wrapper (reference: TorchModel transformer); the model
    lives on ``device``."""

    def __init__(self, model, history: List[float], run_id: str,
                 val_history: Optional[List[float]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.history = history
        self.val_history = list(val_history or [])
        self.run_id = run_id

    def predict(self, X: np.ndarray) -> np.ndarray:
        import torch
        self.model.eval()
        with torch.no_grad():
            out = self.model(torch.from_numpy(
                np.ascontiguousarray(X)).to(self.device))
        return out.cpu().numpy()

    def getModel(self):  # reference naming
        return self.model


class TorchEstimator:
    """Distributed-training estimator for torch models.

    Args mirror the reference's essentials: ``model`` (an ``nn.Module``),
    ``optimizer`` (factory ``params -> torch.optim.Optimizer``; a factory
    rather than an instance so fresh workers can rebuild it), ``loss``
    (``(pred, target) -> scalar``), ``epochs``, ``batch_size`` (per
    worker), ``np`` workers, ``store`` for checkpoints, ``run_id``, and
    the port's ``device`` (the workers' and ``predict``'s; None:
    ``cuda:<local_rank>`` in a worker, the current card here).
    """

    def __init__(self, model, optimizer: Callable, loss: Callable,
                 epochs: int = 1, batch_size: int = 32, np: int = 1,
                 store: Optional[Store] = None,
                 run_id: Optional[str] = None, shuffle: bool = True,
                 seed: int = 0, env: Optional[dict] = None,
                 port: int = 29600, verbose: int = 0,
                 validation: float = 0.0, device: DeviceLike = None):
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.epochs = epochs
        self.batch_size = batch_size
        self.num_proc = np
        self.store = store
        self.run_id = run_id or f"torch-{uuid.uuid4().hex[:8]}"
        self.shuffle = shuffle
        self.seed = seed
        self.env = env
        self.port = port
        self.verbose = verbose
        if not 0.0 <= validation < 1.0:
            raise ValueError(
                f"validation must be a fraction in [0, 1), got {validation}")
        self.validation = validation
        self.device = device

    def fit(self, X, y: Optional[np.ndarray] = None) -> TorchModel:
        """Train on in-memory arrays ``fit(X, y)`` or on an on-disk
        dataset ``fit(ParquetDataset(path))``, whose handle alone goes to
        the workers; each reads its own shard."""
        import torch

        from ..data.parquet import ParquetDataset
        from ..runner import run

        if isinstance(X, ParquetDataset):
            if y is not None:
                raise ValueError("fit(dataset) takes no y — the label "
                                 "column lives in the dataset")
            data_args = (X, None)
        else:
            if y is None:
                raise TypeError("fit(X, y) needs y for array inputs "
                                "(only fit(ParquetDataset) omits it)")
            data_args = (np.asarray(X), np.asarray(y))
        model_bytes = self._serialized_model()
        results = run(
            _train_on_worker,
            args=(model_bytes, self.optimizer, self.loss, *data_args,
                  self.epochs, self.batch_size, self.seed, self.shuffle,
                  self.validation),
            np=self.num_proc, env=self.env, port=self.port,
            verbose=bool(self.verbose),
            device=None if self.device is None else str(self.device))
        history = results[0]["history"]
        val_history = results[0]["val_history"]
        fitted = _load(model_bytes)
        fitted.load_state_dict(_load(results[0]["state_dict"]))
        if self.store is not None:
            # a self-contained checkpoint: the fitted module (definition
            # and CPU weights) rides along, so load_model() needs no live
            # estimator
            mbuf = io.BytesIO()
            torch.save(fitted, mbuf)
            self.store.save_checkpoint(
                self.run_id, {"model": mbuf.getvalue(),
                              "history": history,
                              "val_history": val_history})
        return TorchModel(fitted, history, self.run_id,
                          val_history=val_history, device=self.device)

    def load(self, store: Optional[Store] = None,
             run_id: Optional[str] = None) -> TorchModel:
        """Rehydrate a fitted model from the store (reference:
        TorchModel load from checkpoint)."""
        return load_model(store or self.store, run_id or self.run_id,
                          fallback_model_bytes=self._serialized_model,
                          device=self.device)

    def _serialized_model(self) -> bytes:
        import torch
        buf = io.BytesIO()
        torch.save(self.model, buf)
        return buf.getvalue()


def load_model(store: Store, run_id: str,
               fallback_model_bytes: Optional[Any] = None,
               device: DeviceLike = None) -> TorchModel:
    """Rehydrate a fitted :class:`TorchModel` on ``device`` from a store
    checkpoint, with NO live estimator required: the checkpoint carries
    the model definition (``"model"``).  A checkpoint that holds only a
    state dict needs ``fallback_model_bytes`` — a ``torch.save``'d module
    of the matching architecture, or a zero-arg callable returning one
    (evaluated only then)."""
    ckpt = store.load_checkpoint(run_id)
    if "model" in ckpt:
        model = _load(ckpt["model"])
    elif fallback_model_bytes is not None:
        if callable(fallback_model_bytes):
            fallback_model_bytes = fallback_model_bytes()
        model = _load(fallback_model_bytes)
        model.load_state_dict(_load(ckpt["state_dict"]))
    else:
        raise ValueError(
            f"checkpoint '{run_id}' predates self-contained checkpoints "
            f"(no serialized model); pass fallback_model_bytes or load "
            f"through an estimator constructed with the architecture")
    return TorchModel(model, ckpt.get("history", []), run_id,
                      val_history=ckpt.get("val_history", []),
                      device=device)
