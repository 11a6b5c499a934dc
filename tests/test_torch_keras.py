"""The port's Keras adapter (``horovod_tpu_torch/keras/``) and Keras
estimator (``estimator/keras_estimator.py``) against the JAX package's,
on the CPU.

* World 2: ``model.fit`` with ``DistributedOptimizer`` and the four
  callbacks (broadcast, metric average, warmup, schedule) over the
  port's gloo ranks (``tests/torch_tf_cases.py`` ``keras_fit``) and over
  the JAX package's workers (``horovod_tpu.runner.run``) from the same
  seeds: weights, the averaged logs and each batch's learning rate.
* ``KerasEstimator`` at np 2 on ``tests/test_estimator.py``'s data and
  settings (``test_keras_estimator_fit_predict``), the port's workers on
  the CPU against the JAX package's: fitted weights, history,
  ``predict`` and ``load_keras_model``.
* World 1, in this process: ``DistributedOptimizer`` trains as plain
  Keras does, bit for bit, with and without ``jit_compile``; the
  callbacks' single-rank behaviour; the estimator's argument checks.

Every fit's tolerance is stated where it is compared; the launches run
two at a time from one module fixture.
"""

import concurrent.futures
import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import torch_ranks  # noqa: E402
import torch_tf_cases as cases  # noqa: E402
from _helpers import free_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
#: the port's estimator workers: CPU ranks over gloo
ENV = {"PYTHONPATH": REPO + ":" + TESTS, "HOROVOD_CYCLE_TIME": "0.2",
       "OMP_NUM_THREADS": "1"}
#: the JAX package's workers (tests/test_estimator.py's _env)
JAX_ENV = {"HOROVOD_TPU_FORCE_PLATFORM": "cpu",
           "PYTHONPATH": REPO + ":" + TESTS,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
           "HOROVOD_CYCLE_TIME": "0.2", "OMP_NUM_THREADS": "1"}
#: tests/test_estimator.py test_keras_estimator_fit_predict's settings
EST_ARGS = dict(optimizer={"class_name": "SGD",
                           "config": {"learning_rate": 0.05}},
                loss="mse", epochs=4, batch_size=16, np=2)
#: the fits' tolerance against the JAX package's: two fp32 gradients
#: averaged round alike, so the same bits are expected; 1e-6 absolute
FIT_TOL = 1e-6


def _regression_data(n=64, d=4, seed=0):
    """tests/test_estimator.py ``_regression_data``."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    return X, (X @ w).astype(np.float32)


def _estimator_model():
    tf.keras.utils.set_random_seed(0)
    return tf.keras.Sequential([
        tf.keras.layers.Input(shape=(4,)),
        tf.keras.layers.Dense(8, activation="tanh"),
        tf.keras.layers.Dense(1)])


def _fit_estimator(package, model, store_dir):
    """Fit ``package``'s KerasEstimator (``"port"`` or ``"jax"``) on
    test_estimator.py's data; returns (fitted, reloaded from the store)."""
    if package == "port":
        from horovod_tpu_torch.estimator import (FilesystemStore,
                                                 KerasEstimator,
                                                 load_keras_model)
        extra = dict(env=ENV, device="cpu")
    else:
        from horovod_tpu.estimator import (FilesystemStore, KerasEstimator,
                                           load_keras_model)
        extra = dict(env=JAX_ENV)
    store = FilesystemStore(str(store_dir))

    def fit():
        est = KerasEstimator(model=model, store=store, run_id="kfit",
                             port=free_port(), **EST_ARGS, **extra)
        return est.fit(*_regression_data(seed=2))
    # the JAX package's launch is the reference, started again if its
    # workers fail (its port taken); the port's is not
    fitted = torch_ranks.retried(fit) if package == "jax" else fit()
    return fitted, load_keras_model(store, "kfit")


class Runs(dict):
    """Each run's result by key, started at once on a pool of two and
    read when a test first asks."""

    def __init__(self, jobs):
        super().__init__()
        self._pool = concurrent.futures.ThreadPoolExecutor(2)
        self._futures = {k: self._pool.submit(f) for k, f in jobs.items()}

    def __missing__(self, key):
        self[key] = self._futures[key].result()
        return self[key]

    def close(self):
        self._pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from horovod_tpu.runner import run

    def jax_fit():
        res = torch_ranks.retried(lambda: run(
            cases.jax_keras_fit, np=2, env=JAX_ENV, port=free_port()))
        return {r["rank"]: r for r in res}

    # one model, built here, for both estimators: the same initial weights
    models = {"port": _estimator_model(), "jax": _estimator_model()}
    models["jax"].set_weights(models["port"].get_weights())
    r = Runs({
        "port_fit": lambda: [x["torch_tf_cases:keras_fit"] for x in
                             torch_ranks.launch(
                                 2, ["torch_tf_cases:keras_fit"],
                                 tmp_path_factory.mktemp("keras_fit"))],
        "jax_fit": jax_fit,
        "port_est": lambda: _fit_estimator(
            "port", models["port"], tmp_path_factory.mktemp("port_est")),
        "jax_est": lambda: _fit_estimator(
            "jax", models["jax"], tmp_path_factory.mktemp("jax_est")),
    })
    yield r
    r.close()


def _same(a, b, tol=FIT_TOL):
    """Within ``tol``; True when bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    return a.tobytes() == b.tobytes()


# -- world 2: model.fit with the callbacks ----------------------------------

def test_keras_fit_weights_match_jax(runs, record_property):
    """Both ranks end with rank 0's broadcast start trained on averaged
    gradients: the same weights on both ranks, and the JAX package's
    within 1e-6."""
    port, jax = runs["port_fit"], runs["jax_fit"]
    bitwise = True
    for rank in (0, 1):
        for got, want in zip(port[rank]["weights"], jax[rank]["weights"]):
            bitwise &= _same(got, want)
        for got, want in zip(port[rank]["weights"], port[0]["weights"]):
            np.testing.assert_array_equal(got, want)
    record_property("bitwise", bitwise)
    print(f"keras fit against JAX: bitwise={bitwise}")


@pytest.mark.parametrize("metric", ["loss", "mae"])
def test_keras_fit_logs_are_averaged_as_jax_does(runs, metric):
    """MetricAverageCallback: every epoch's log is the ranks' mean, the
    same on both ranks and the JAX package's within 1e-6."""
    port, jax = runs["port_fit"], runs["jax_fit"]
    for rank in (0, 1):
        got = port[rank]["history"][metric]
        assert len(got) == cases.KERAS_EPOCHS
        _same(got, jax[rank]["history"][metric])
        assert got == port[0]["history"][metric]
    assert port[0]["history"]["loss"][-1] < port[0]["history"]["loss"][0]


def test_lr_callbacks_give_jax_rates(runs):
    """LearningRateWarmupCallback (from KERAS_LR / 2 over epochs 0-1) and
    LearningRateScheduleCallback (smooth from epoch 2) set the JAX
    package's rate at every batch, and the expected ones."""
    port, jax = runs["port_fit"], runs["jax_fit"]
    steps = 64 // 2 // cases.KERAS_BATCH
    lr = cases.KERAS_LR
    want = []
    for epoch in range(cases.KERAS_EPOCHS):
        for b in range(steps):
            if epoch < 2:
                progress = min((epoch * steps + b + 1) / (steps * 2), 1.0)
                want.append(lr / 2 + (lr - lr / 2) * progress)
            else:
                want.append(lr / (1.0 + epoch + b / steps - 2))
    for rank in (0, 1):
        assert port[rank]["lrs"] == jax[rank]["lrs"]
        np.testing.assert_allclose(port[rank]["lrs"], want, rtol=1e-6)


# -- the Keras estimator ------------------------------------------------------

def test_keras_estimator_matches_jax(runs, record_property):
    """test_estimator.py's KerasEstimator fit at np 2: the port's fitted
    weights and history are the JAX package's within 1e-6, the loss
    falls, and ``predict`` agrees."""
    (port, _), (jax, _) = runs["port_est"], runs["jax_est"]
    bitwise = True
    for got, want in zip(port.model.get_weights(), jax.model.get_weights()):
        bitwise &= _same(got, want)
    assert port.history.keys() == jax.history.keys()
    losses = port.history["loss"]
    assert len(losses) == 4 and losses[-1] < losses[0]
    bitwise &= _same(losses, jax.history["loss"])
    X, _ = _regression_data(seed=2)
    preds = port.predict(X)
    assert preds.shape == (64, 1)
    bitwise &= _same(preds, jax.predict(X))
    record_property("bitwise", bitwise)
    print(f"keras estimator against JAX: bitwise={bitwise}")


def test_load_keras_model_rehydrates_the_fit(runs):
    """The store's checkpoint is self-contained: ``load_keras_model``
    gives the fitted weights, history and predictions, as the JAX
    package's does."""
    for key in ("port_est", "jax_est"):
        fitted, reloaded = runs[key]
        for got, want in zip(reloaded.model.get_weights(),
                             fitted.model.get_weights()):
            np.testing.assert_array_equal(got, want)
        assert reloaded.history == fitted.history
        X, _ = _regression_data(seed=2)
        np.testing.assert_array_equal(reloaded.predict(X),
                                      fitted.predict(X))
        assert reloaded.run_id == "kfit"
        assert reloaded.getModel() is reloaded.model


# -- world 1, in this process ---------------------------------------------------

@pytest.fixture(scope="module")
def world1():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _tiny_fit(opt, jit, data_seed=1):
    tf.keras.utils.set_random_seed(3)
    model = tf.keras.Sequential([tf.keras.layers.Input(shape=(4,)),
                                 tf.keras.layers.Dense(3, activation="relu"),
                                 tf.keras.layers.Dense(1)])
    model.compile(optimizer=opt, loss="mse", jit_compile=jit)
    X = np.random.RandomState(data_seed).randn(32, 4).astype("f4")
    y = X @ np.array([[1.0], [0.5], [-0.5], [0.2]], dtype="f4")
    hist = model.fit(X, y, epochs=2, batch_size=8, verbose=0,
                     shuffle=False)
    return model, hist


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("passes", [1, 2])
def test_world_1_distributed_optimizer_trains_as_plain_keras(world1, jit,
                                                             passes):
    """At world 1 the wrapped optimizer's gradients are unchanged (the
    lowering is the identity), so training equals plain Keras bit for
    bit, compiled by XLA or not; with ``backward_passes_per_step=2`` it
    applies every second step the sum of two passes' gradients."""
    import horovod_tpu_torch.tensorflow as thvd
    opt = thvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=0.05, momentum=0.9),
        backward_passes_per_step=passes)
    model, hist = _tiny_fit(opt, jit)
    assert type(model.optimizer).__name__ == "SGD"
    if passes == 1:
        ref, ref_hist = _tiny_fit(
            tf.keras.optimizers.SGD(learning_rate=0.05, momentum=0.9), jit)
        for got, want in zip(model.get_weights(), ref.get_weights()):
            np.testing.assert_array_equal(got, want)
        assert hist.history == ref_hist.history
    else:
        assert int(opt._hvd_bpps_counter.numpy()) == 8
        assert int(opt.iterations.numpy()) == 4


def test_world_1_lr_schedule_matches_jax_callback(world1):
    """LearningRateScheduleCallback, staircase and smooth, sets the JAX
    package's callback's rates (neither reads the world size)."""
    import horovod_tpu.keras as jkhvd
    import horovod_tpu_torch.keras as khvd

    def rates(mod, **kw):
        model, _ = _tiny_fit(tf.keras.optimizers.SGD(learning_rate=1.0),
                             False)
        cb = mod.LearningRateScheduleCallback(initial_lr=0.5, **kw)
        cb.set_model(model)
        out = []
        for epoch in range(4):
            cb.on_epoch_begin(epoch)
            for b in range(4):
                cb.on_train_batch_begin(b)
                out.append(float(np.asarray(model.optimizer.learning_rate)))
        return out

    for kw in ({"multiplier": lambda e: 0.5 ** e, "start_epoch": 1},
               {"multiplier": lambda e: 1.0 / (1.0 + e), "staircase": False,
                "steps_per_epoch": 4, "end_epoch": 3},
               {"multiplier": 0.2}):
        assert rates(khvd, **kw) == rates(jkhvd, **kw)


def test_world_1_callbacks(world1):
    """One rank: the warmup holds the full rate (initial_lr / size() is
    initial_lr), metric averaging is the identity, the broadcast runs
    once."""
    import horovod_tpu_torch.keras as khvd
    model, _ = _tiny_fit(tf.keras.optimizers.SGD(learning_rate=0.3), False)
    wu = khvd.LearningRateWarmupCallback(initial_lr=0.8, warmup_epochs=2)
    wu.set_model(model)
    wu.on_epoch_begin(0)
    wu.on_train_batch_begin(0)
    assert float(np.asarray(model.optimizer.learning_rate)) == \
        pytest.approx(0.8, rel=1e-6)
    logs = {"loss": 0.5, "acc": 0.75, "name": "kept"}
    khvd.MetricAverageCallback().on_epoch_end(0, logs)
    assert logs == {"loss": 0.5, "acc": 0.75, "name": "kept"}
    bc = khvd.BroadcastGlobalVariablesCallback(root_rank=0)
    before = [w.copy() for w in model.get_weights()]
    model.fit(np.zeros((8, 4), "f4"), np.zeros((8, 1), "f4"), epochs=1,
              batch_size=8, verbose=0, callbacks=[bc])
    assert bc.broadcast_done
    assert len(before) == len(model.get_weights())
    with pytest.raises(ValueError, match="steps_per_epoch"):
        khvd.LearningRateScheduleCallback(initial_lr=0.1, multiplier=0.5,
                                          staircase=False)


def test_estimator_arguments_are_checked_before_any_launch(tmp_path):
    from horovod_tpu_torch.data import ParquetDataset, write_parquet
    from horovod_tpu_torch.estimator import KerasEstimator
    with pytest.raises(ValueError, match="validation"):
        KerasEstimator(model=None, optimizer="sgd", loss="mse",
                       validation=1.5)
    est = KerasEstimator(model=None, optimizer="sgd", loss="mse")
    with pytest.raises(TypeError, match="needs y"):
        est.fit(np.zeros((4, 2), np.float32))
    path = str(tmp_path / "d.parquet")
    write_parquet(path, {"x0": np.zeros(8, np.float32),
                         "y": np.zeros(8, np.float32)})
    with pytest.raises(ValueError, match="label column"):
        est.fit(ParquetDataset(path), np.zeros(8))
