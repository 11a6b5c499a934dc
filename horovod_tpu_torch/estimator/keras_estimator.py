"""KerasEstimator: fit/predict orchestration for tf.keras models
(counterpart: ``horovod_tpu/estimator/keras_estimator.py``).

Reference parity: ``horovod/spark/keras/estimator.py`` (SURVEY.md §2.2)
— sklearn-style fit over ``np`` workers with the Keras callbacks
(broadcast, metric averaging) installed, checkpointing through the
Store, returning a fitted wrapper with ``predict``.

The workers are the port's own launch (``runner.run``), each with the
runtime on ``device`` and the TF adapter over its engine; each takes the
rows ``X[rank::size]`` (the JAX package shards by process,
``cross_rank()``/``cross_size()``, which in the port count hosts).  The
model travels as Keras JSON and a weight list, which both packages read.
TensorFlow is imported only by :meth:`KerasEstimator.fit` and
:func:`load_keras_model`; without it they raise an ImportError naming
it before any worker starts.
"""

from __future__ import annotations

import uuid
from typing import Optional

import numpy as np

from .. import DeviceLike
from .store import Store


def _tensorflow():
    """``tensorflow``, or the ImportError that names it."""
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError(
            "KerasEstimator and load_keras_model need the tensorflow "
            "package (tf.keras), which is not installed here; torch "
            "models take horovod_tpu_torch.estimator.TorchEstimator, "
            "over horovod_tpu_torch.torch") from exc
    return tf


def _train_on_worker(model_bytes, compile_kwargs, X, y, epochs,
                     batch_size, seed, validation=0.0):
    """Runs on every launched worker."""
    import tensorflow as tf

    import horovod_tpu_torch.keras as khvd
    import horovod_tpu_torch.tensorflow as hvd

    rank, nproc = hvd.rank(), hvd.size()
    tf.keras.utils.set_random_seed(seed + rank)
    model = tf.keras.models.model_from_json(model_bytes["json"])
    model.set_weights(model_bytes["weights"])
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.get(dict(compile_kwargs["optimizer"])))
    model.compile(optimizer=opt, loss=compile_kwargs["loss"],
                  metrics=compile_kwargs.get("metrics"))
    if y is None:
        # on-disk data plane: the payload carried only the dataset
        # handle; read THIS rank's strided shard (identical rows to
        # the in-memory X[rank::nproc] branch below)
        Xs, ys = X.read_xy(rank, nproc)
    else:
        Xs, ys = X[rank::nproc], y[rank::nproc]
    hist = model.fit(
        Xs, ys, epochs=epochs,
        batch_size=batch_size, verbose=0,
        validation_split=validation or 0.0,
        callbacks=[khvd.BroadcastGlobalVariablesCallback(0),
                   khvd.MetricAverageCallback()])
    return {"weights": model.get_weights() if rank == 0 else None,
            "history": {k: [float(v) for v in vs]
                        for k, vs in hist.history.items()}}


class KerasModel:
    """Fitted model wrapper (reference: KerasModel transformer)."""

    def __init__(self, model, history, run_id: str):
        self.model = model
        self.history = history
        self.run_id = run_id

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self.model.predict(X, verbose=0))

    def getModel(self):  # reference naming
        return self.model


class KerasEstimator:
    """Distributed-training estimator for tf.keras models.

    ``model`` must be json-serializable (Sequential/functional);
    ``optimizer`` is a keras identifier dict/config (workers rebuild it);
    ``loss``/``metrics`` as in ``model.compile``; ``device`` is the
    workers' (``cuda:<local_rank>`` by default, ``"cpu"`` for gloo on
    the CPU).
    """

    def __init__(self, model, optimizer, loss, metrics=None,
                 epochs: int = 1, batch_size: int = 32, np: int = 1,
                 store: Optional[Store] = None,
                 run_id: Optional[str] = None, seed: int = 0,
                 env: Optional[dict] = None, port: int = 29610,
                 verbose: int = 0, validation: float = 0.0,
                 device: DeviceLike = None):
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = metrics
        self.epochs = epochs
        self.batch_size = batch_size
        self.num_proc = np
        self.store = store
        self.run_id = run_id or f"keras-{uuid.uuid4().hex[:8]}"
        self.seed = seed
        self.env = env
        self.port = port
        self.verbose = verbose
        if not 0.0 <= validation < 1.0:
            raise ValueError(
                f"validation must be a fraction in [0, 1), got {validation}")
        self.validation = validation
        self.device = device

    def fit(self, X, y: Optional[np.ndarray] = None) -> KerasModel:
        """``fit(X, y)`` on in-memory arrays, or ``fit(ParquetDataset)``
        on an on-disk dataset (only the handle rides the payload; each
        worker reads its own shard — the Spark store data flow)."""
        tf = _tensorflow()
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
        opt_cfg = tf.keras.optimizers.serialize(
            tf.keras.optimizers.get(self.optimizer))
        payload = {"json": self.model.to_json(),
                   "weights": self.model.get_weights()}
        results = run(
            _train_on_worker,
            args=(payload, {"optimizer": opt_cfg, "loss": self.loss,
                            "metrics": self.metrics},
                  *data_args, self.epochs,
                  self.batch_size, self.seed, self.validation),
            np=self.num_proc, env=self.env, port=self.port,
            verbose=bool(self.verbose),
            device=None if self.device is None else str(self.device))
        fitted = tf.keras.models.model_from_json(payload["json"])
        fitted.set_weights(results[0]["weights"])
        history = results[0]["history"]
        if self.store is not None:
            # SELF-CONTAINED: the model json rides along so
            # load_keras_model() needs no live estimator (parity with
            # the torch store checkpoints)
            self.store.save_checkpoint(
                self.run_id, {"json": payload["json"],
                              "weights": results[0]["weights"],
                              "history": history})
        return KerasModel(fitted, history, self.run_id)


def load_keras_model(store: Store, run_id: str,
                     fallback_json: Optional[str] = None) -> KerasModel:
    """Rehydrate a fitted :class:`KerasModel` from a SELF-CONTAINED store
    checkpoint (model json + weights), with no live estimator required —
    parity with :func:`torch_estimator.load_model` and the reference's
    store round-trip.  Legacy (weights-only) checkpoints need
    ``fallback_json`` (``model.to_json()`` of the matching
    architecture)."""
    tf = _tensorflow()
    ckpt = store.load_checkpoint(run_id)
    json_def = ckpt.get("json", fallback_json)
    if json_def is None:
        raise ValueError(
            f"checkpoint '{run_id}' predates self-contained keras "
            f"checkpoints (no model json); pass fallback_json="
            f"model.to_json() of the matching architecture")
    model = tf.keras.models.model_from_json(json_def)
    model.set_weights(ckpt["weights"])
    return KerasModel(model, ckpt.get("history", {}), run_id)
