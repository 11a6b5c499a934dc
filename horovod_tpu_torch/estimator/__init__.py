"""Estimator tier: sklearn-style distributed fit/predict, torch half
(counterpart: ``horovod_tpu/estimator/``).

Reference parity: ``horovod/spark/`` estimators (SURVEY.md §2.2): hand an
unfitted model and data to an estimator and get a fitted model back, the
distributed training run by the port's launcher (``runner.run``) on
``device`` and the artifacts in a :class:`Store`.  Spark itself
(DataFrames, Petastorm) is absent, as in the JAX package:
``fit(ParquetDataset)`` is the on-disk data plane.  The Keras estimator
(``KerasEstimator``, ``KerasModel``, ``load_keras_model``) imports
TensorFlow only when it fits or loads, so this package imports without
it.
"""

from .keras_estimator import (  # noqa: F401
    KerasEstimator, KerasModel, load_keras_model)
from .lightning_estimator import (  # noqa: F401
    LightningEstimator, LightningModelWrapper)
from .store import (  # noqa: F401
    FilesystemStore, LocalStore, RemoteStore, Store)
from .torch_estimator import (  # noqa: F401
    TorchEstimator, TorchModel, load_model)

__all__ = ["Store", "LocalStore", "FilesystemStore", "RemoteStore",
           "TorchEstimator", "TorchModel", "KerasEstimator", "KerasModel",
           "LightningEstimator", "LightningModelWrapper", "load_model",
           "load_keras_model"]
