"""The port's estimator tier (``horovod_tpu_torch/estimator/``) against the
JAX package's (``horovod_tpu/estimator/``).

* The Store: filesystem and ``memory://`` round trips, the scheme
  dispatch, the legacy (state-dict-only) checkpoint contract.
* ``TorchEstimator.fit`` at np 2 on the CPU (the port's workers over
  gloo, the JAX package's through its own launcher) from the same seed,
  data, model bytes, optimizer, epochs and batch as the JAX package's
  ``tests/test_estimator.py::test_torch_estimator_fit_predict``: the loss
  histories and the fitted ``state_dict`` bit for bit (both average two
  fp32 gradients, which rounds alike), the checkpoint CPU tensors,
  ``load_model`` with no live estimator.
* Uneven shards with a ``memory://`` store; the validation split with
  ``fit(ParquetDataset)`` equal to the in-memory fit; the Lightning
  estimator's absence contract and a fit through a stub ``lightning``.

Four tests start workers (five launches of two ranks each).
"""

import importlib
import io
import os
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _helpers import free_port
from horovod_tpu_torch.estimator import (FilesystemStore, LightningEstimator,
                                         RemoteStore, Store, TorchEstimator,
                                         load_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

#: the port's workers: CPU ranks over gloo
ENV = {"PYTHONPATH": REPO + ":" + TESTS, "HOROVOD_CYCLE_TIME": "0.2",
       "OMP_NUM_THREADS": "1"}
#: the JAX package's workers (tests/test_estimator.py's _env)
JAX_ENV = {"HOROVOD_TPU_FORCE_PLATFORM": "cpu",
           "PYTHONPATH": REPO + ":" + TESTS,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
           "HOROVOD_CYCLE_TIME": "0.2", "OMP_NUM_THREADS": "1"}


def _regression_data(n=64, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    return X, (X @ w).astype(np.float32)


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Linear(4, 8), torch.nn.Tanh(), torch.nn.Linear(8, 1))


def _adam(params):
    return torch.optim.Adam(params, lr=5e-3)


def _sgd(params):
    return torch.optim.SGD(params, lr=0.05)


def test_store_round_trips_and_scheme_dispatch(tmp_path):
    store = FilesystemStore(str(tmp_path))
    assert not store.exists("run1")
    store.save_checkpoint("run1", {"a": np.arange(3)})
    assert store.exists("run1")
    np.testing.assert_array_equal(store.load_checkpoint("run1")["a"],
                                  np.arange(3))
    assert os.path.isdir(store.logs_path("run1"))
    s = Store.create("memory://hvdtorchtest/store1")
    assert isinstance(s, RemoteStore) and not s.exists("runA")
    s.save_checkpoint("runA", {"w": np.arange(4.0), "history": [1.0]})
    assert s.exists("runA")
    np.testing.assert_array_equal(s.load_checkpoint("runA")["w"],
                                  np.arange(4.0))
    assert s.logs_path("runA").endswith("/logs")
    s.save_checkpoint("runA", {"w": np.zeros(2)})
    np.testing.assert_array_equal(s.load_checkpoint("runA")["w"],
                                  np.zeros(2))
    assert isinstance(Store.create(str(tmp_path)), FilesystemStore)
    assert isinstance(Store.create("file://" + str(tmp_path)),
                      FilesystemStore)
    with pytest.raises(ValueError, match="storage_options"):
        Store.create(str(tmp_path), anon=True)


def test_legacy_checkpoint_contract(tmp_path):
    torch.manual_seed(1)
    model = torch.nn.Linear(3, 2)
    sbuf, mbuf = io.BytesIO(), io.BytesIO()
    torch.save(model.state_dict(), sbuf)
    torch.save(model, mbuf)
    store = FilesystemStore(str(tmp_path))
    store.save_checkpoint("legacy", {"state_dict": sbuf.getvalue(),
                                     "history": [0.5]})
    with pytest.raises(ValueError, match="self-contained"):
        load_model(store, "legacy", device="cpu")
    out = load_model(store, "legacy", fallback_model_bytes=mbuf.getvalue,
                     device="cpu")
    assert out.history == [0.5] and out.device == torch.device("cpu")
    x = np.ones((2, 3), np.float32)
    np.testing.assert_array_equal(
        out.predict(x), model(torch.from_numpy(x)).detach().numpy())


def test_arguments_are_checked_before_any_launch(tmp_path):
    with pytest.raises(ValueError, match="validation"):
        TorchEstimator(model=torch.nn.Linear(2, 1), optimizer=_sgd,
                       loss=F.mse_loss, validation=1.5)
    from horovod_tpu_torch.data import ParquetDataset, write_parquet
    write_parquet(str(tmp_path / "d.parquet"),
                  {"x0": np.zeros(8, np.float32),
                   "y": np.zeros(8, np.float32)})
    est = TorchEstimator(model=torch.nn.Linear(1, 1), optimizer=_sgd,
                         loss=F.mse_loss, device="cpu")
    with pytest.raises(ValueError, match="label column"):
        est.fit(ParquetDataset(str(tmp_path / "d.parquet")),
                np.zeros((8, 1)))
    with pytest.raises(TypeError, match="needs y"):
        est.fit(np.zeros((8, 1), np.float32))


def test_fit_reproduces_the_jax_estimator(tmp_path):
    """The JAX package's ``test_torch_estimator_fit_predict`` setup through
    both estimators: histories and fitted weights bit for bit."""
    from horovod_tpu.estimator import TorchEstimator as JaxEstimator
    X, y = _regression_data()
    model = _mlp()
    kw = dict(optimizer=_adam, loss=F.mse_loss, epochs=6, batch_size=16,
              np=2)
    jax_fit = JaxEstimator(model=model, run_id="jfit", port=free_port(),
                           env=JAX_ENV, **kw).fit(X, y)
    store = FilesystemStore(str(tmp_path))
    est = TorchEstimator(model=model, store=store, run_id="fit1",
                         port=free_port(), env=ENV, device="cpu", **kw)
    fitted = est.fit(X, y)
    assert len(fitted.history) == 6
    assert fitted.history == jax_fit.history
    assert fitted.history[-1] < fitted.history[0]
    want = jax_fit.model.state_dict()
    got = fitted.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    preds = fitted.predict(X)
    assert preds.shape == (64, 1) and preds.dtype == np.float32
    np.testing.assert_array_equal(preds, jax_fit.predict(X))
    # the checkpoint holds CPU tensors and reloads with no live estimator
    ckpt = store.load_checkpoint("fit1")
    saved = torch.load(io.BytesIO(ckpt["model"]), weights_only=False)
    assert all(p.device.type == "cpu" for p in saved.parameters())
    standalone = load_model(store, "fit1", device="cpu")
    np.testing.assert_array_equal(standalone.predict(X), preds)
    assert standalone.history == fitted.history
    np.testing.assert_array_equal(est.load().predict(X), preds)


def test_uneven_shards_with_a_remote_store():
    """127 samples over 2 workers (64/63-sample shards, 2 vs 1 batches at
    bs 32): the per-epoch step count is the global minimum or the
    per-step allreduces desynchronize; the checkpoint goes to
    ``memory://``."""
    X, y = _regression_data(n=127)
    torch.manual_seed(0)
    store = Store.create("memory://hvdtorchtest/uneven")
    est = TorchEstimator(model=torch.nn.Linear(4, 1), optimizer=_sgd,
                         loss=F.mse_loss, epochs=3, batch_size=32, np=2,
                         store=store, run_id="uneven", env=ENV,
                         port=free_port(), device="cpu")
    fitted = est.fit(X, y)
    assert len(fitted.history) == 3
    assert fitted.predict(X).shape == (127, 1)
    standalone = load_model(store, "uneven", device="cpu")
    np.testing.assert_array_equal(standalone.predict(X), fitted.predict(X))
    assert standalone.history == fitted.history


def test_validation_split_from_parquet_equals_in_memory(tmp_path):
    """``fit(ParquetDataset)`` with a 0.25 validation split and shuffling:
    each worker reads its own strided shard, so the train and validation
    histories equal the in-memory fit's exactly."""
    from horovod_tpu_torch.data import ParquetDataset, write_parquet
    X, y = _regression_data(n=512)
    write_parquet(str(tmp_path / "train.parquet"),
                  {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
                   "x3": X[:, 3], "y": y[:, 0]}, rows_per_group=64)

    def fit(data):
        est = TorchEstimator(
            model=_mlp(), optimizer=_adam, loss=F.mse_loss, epochs=3,
            batch_size=16, np=2, env=ENV, port=free_port(), device="cpu",
            validation=0.25, shuffle=True, seed=11)
        return est.fit(*data)

    ds = ParquetDataset(str(tmp_path / "train.parquet"),
                        features=["x0", "x1", "x2", "x3"], label="y")
    from_disk, from_mem = fit((ds,)), fit((X, y))
    assert len(from_mem.history) == len(from_mem.val_history) == 3
    assert from_disk.history == from_mem.history
    assert from_disk.val_history == from_mem.val_history
    assert all(np.isfinite(v) for v in from_mem.val_history)
    assert from_mem.val_history[-1] < from_mem.val_history[0]


def test_lightning_absence_contract():
    for mod in ("lightning", "pytorch_lightning"):
        if importlib.util.find_spec(mod) is not None:
            pytest.skip(f"{mod} is installed: the absence contract is moot")
    with pytest.raises(ImportError, match="lightning"):
        LightningEstimator(model=object())
    from horovod_tpu_torch.estimator import LightningModelWrapper
    w = LightningModelWrapper(module=object(), history=[1.0, 0.5],
                              device="cpu")
    assert w.history == [1.0, 0.5] and w.val_history == []


def test_lightning_fit_through_a_stub_package(tmp_path):
    """The fit/predict path with a stub ``lightning`` on ``PYTHONPATH``:
    the ``configure_optimizers`` dict form, the Store checkpoint and the
    fitted wrapper (the JAX package's
    ``test_lightning_estimator_functional_with_fake_lightning``)."""
    pkg = tmp_path / "fakelib"
    (pkg / "lightning").mkdir(parents=True)
    (pkg / "lightning" / "__init__.py").write_text(textwrap.dedent("""
        import torch

        class LightningModule(torch.nn.Module):
            pass
    """))
    (pkg / "fake_lm_model.py").write_text(textwrap.dedent("""
        import torch
        import torch.nn.functional as F
        from lightning import LightningModule

        class LinearLM(LightningModule):
            def __init__(self):
                super().__init__()
                self.lin = torch.nn.Linear(4, 1)

            def forward(self, x):
                return self.lin(x)

            def training_step(self, batch, batch_idx):
                x, y = batch
                return {"loss": F.mse_loss(self.lin(x)[:, 0], y)}

            def configure_optimizers(self):
                return {"optimizer":
                        torch.optim.SGD(self.parameters(), lr=0.05)}
    """))
    sys.path.insert(0, str(pkg))
    importlib.invalidate_caches()
    try:
        fake_lm_model = importlib.import_module("fake_lm_model")
        rng = np.random.RandomState(0)
        X = rng.randn(64, 4).astype(np.float32)
        y = X @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)
        store = FilesystemStore(str(tmp_path / "store"))
        env = dict(ENV, PYTHONPATH=str(pkg) + ":" + ENV["PYTHONPATH"])
        est = LightningEstimator(fake_lm_model.LinearLM(), num_proc=2,
                                 epochs=5, batch_size=8, store=store,
                                 env=env, port=free_port(), device="cpu")
        fitted = est.fit(X, y)
        assert len(fitted.history) == 5
        pred = fitted.predict(X)[:, 0]
        mse = float(((pred - y) ** 2).mean())
        assert mse < 0.5 * float((y ** 2).mean())
        runs = os.listdir(str(tmp_path / "store"))
        assert any(r.startswith("lightning-") for r in runs), runs
    finally:
        sys.path.remove(str(pkg))
        sys.modules.pop("lightning", None)
        sys.modules.pop("fake_lm_model", None)
