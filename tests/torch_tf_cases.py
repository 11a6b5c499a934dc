"""TF and Keras cases of the port's adapters, run as rank processes, and
the JAX package's Keras worker they are held against.

The port's cases (``case_<name>(hvd, rank, world)``) run under
``tests/torch_ranks.py`` as ``launch(world, ["torch_tf_cases:<name>"],
tmp)``, after its ``hvd.init(device="cpu")``.  Each hides jax before
TensorFlow is first imported (TF imports jax when it can,
``tensorflow/lite/python/util.py``, and the card's machine has none),
then imports the port's TF adapter, which loads the op bridge before any
TF op runs.  ``jax_keras_fit`` runs under ``horovod_tpu.runner.run`` and
imports its packages inside.  Inputs come from numpy seeds defined here,
so the test process can rebuild them.
"""

import os
import pathlib
import sys

import numpy as np

#: the dtypes of the op bridge's kernels (``_BRIDGE_DTYPES``)
TF_DTYPES = ("float32", "float64", "float16", "int32", "int64", "bfloat16")
FLOATS = ("float32", "float64", "float16", "bfloat16")
#: every op the tests hold, by the key its result is returned under
OPS = ("sum", "min", "max", "scaled", "avg", "grouped", "ag", "agv",
       "grouped_ag", "bc", "a2a", "a2av", "rs", "rs_avg", "grouped_rs",
       "ps_sum")
#: ops the bridge does not carry: they stay py_function ops (not
#: XLA-compilable at world > 1)
PY_ONLY = ("agv", "grouped_ag", "a2av", "grouped_rs")
#: ops whose shapes differ by rank, so the bridge's static shapes refuse
#: them in a graph
RAGGED = ("agv",)


def hide_jax():
    """Make ``import jax`` fail in this process, as on the card's machine."""
    sys.modules.setdefault("jax", None)


def base(dtype, rank, shape=(4, 6), seed=0):
    """Rank ``rank``'s input as float64: multiples of 1/4 in [-4, 4)
    (integers in [-16, 16) for int dtypes), exact in every dtype here and
    in every sum of a few of them."""
    rng = np.random.RandomState(seed + 100 * rank)
    v = rng.randint(-16, 16, shape).astype(np.float64)
    return v / 4 if dtype in FLOATS else v


def scales(dtype):
    """(op, prescale, postscale): f32-exact factors, ints get int ones."""
    return ("average", 0.5, 4.0) if dtype in FLOATS else ("sum", 2.0, 3.0)


def a2a_splits(world):
    return [(2 * j + 1) % 4 for j in range(world)]


def inputs(dtype, rank, world):
    """The arrays of one dtype's ops: ``x`` [4, 6], ``xr`` [2·world, 3]
    (the even alltoall and reducescatter), ``xv`` [rank + 1, 3] (ragged)
    and ``xs`` [sum(splits), 3] (alltoall with splits)."""
    return {"x": base(dtype, rank),
            "xr": base(dtype, rank, (2 * world, 3), seed=1),
            "xv": base(dtype, rank, (rank + 1, 3), seed=2),
            "xs": base(dtype, rank, (sum(a2a_splits(world)), 3), seed=3)}


def ops_of(hvd, ps, dtype, world, names, member):
    """``fn(x, xr, xv, xs) -> {op: result}`` over the ops ``names`` with
    the collectives of ``hvd`` (the TF adapter or the port's torch API;
    both take the same arguments).  ``ps`` scopes ``ps_sum``, which only
    a ``member`` runs."""
    op, pre, post = scales(dtype)
    mn, mx = hvd.ReduceOp.MIN, hvd.ReduceOp.MAX

    def fn(x, xr, xv, xs):
        calls = {
            "sum": lambda: hvd.allreduce(x, op=hvd.Sum, name=f"{dtype}.sum"),
            "min": lambda: hvd.allreduce(x, op=mn, name=f"{dtype}.min"),
            "max": lambda: hvd.allreduce(x, op=mx, name=f"{dtype}.max"),
            "scaled": lambda: hvd.allreduce(
                x, op=op, prescale_factor=pre, postscale_factor=post,
                name=f"{dtype}.scaled"),
            "avg": lambda: hvd.allreduce(x, name=f"{dtype}.avg"),
            "grouped": lambda: hvd.grouped_allreduce(
                [x, x[:2] * 2], op=hvd.Sum, name=f"{dtype}.grouped"),
            "ag": lambda: hvd.allgather(x, name=f"{dtype}.ag"),
            "agv": lambda: hvd.allgather(xv, name=f"{dtype}.agv"),
            "grouped_ag": lambda: hvd.grouped_allgather(
                [x, xv], name=f"{dtype}.grouped_ag"),
            "bc": lambda: hvd.broadcast(x, world - 1, name=f"{dtype}.bc"),
            "a2a": lambda: hvd.alltoall(xr, name=f"{dtype}.a2a"),
            "a2av": lambda: hvd.alltoall(xs, splits=a2a_splits(world),
                                         name=f"{dtype}.a2av"),
            "rs": lambda: hvd.reducescatter(xr, op=hvd.Sum,
                                            name=f"{dtype}.rs"),
            "rs_avg": lambda: hvd.reducescatter(xr, name=f"{dtype}.rs_avg"),
            "grouped_rs": lambda: hvd.grouped_reducescatter(
                [xr, xr * 2], op=hvd.Sum, name=f"{dtype}.grouped_rs"),
            "ps_sum": lambda: hvd.allreduce(x, op=hvd.Sum, process_set=ps,
                                            name=f"{dtype}.ps_sum"),
        }
        return {k: calls[k]() for k in names
                if k != "ps_sum" or member}
    return fn


def op_names(dtype, mode, path):
    """The ops one (dtype, mode, path) runs: no Average of ints (it
    floors), no ragged op through the bridge's static shapes, and under
    ``jit_compile`` only the bridge's ops (at world 1, ``path`` is
    ``"lowered"``: every op lowers to TF ops)."""
    names = [k for k in OPS
             if k not in ("avg", "rs_avg") or dtype in FLOATS]
    if mode == "jit" and path != "lowered":
        names = [k for k in names if k not in PY_ONLY]
    if mode != "eager" and path == "bridge":
        names = [k for k in names if k not in RAGGED]
    return names


def raw(a) -> tuple:
    """An array as (dtype name, shape, bytes): bfloat16 and float16
    compared bit for bit after a pickle round trip."""
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def tf_results(thvd, tf, ps, dtype, rank, world, mode, path, member):
    """{op: raw result} of the TF adapter's collectives in ``mode``
    (``eager``, ``graph``: ``tf.function``, ``jit``:
    ``tf.function(jit_compile=True)``)."""
    arrs = inputs(dtype, rank, world)
    ts = {k: tf.cast(tf.constant(v), getattr(tf, dtype))
          for k, v in arrs.items()}
    names = op_names(dtype, mode, path)
    out = {}
    # the scoped call in a function of its own: a graph that differs
    # between ranks may order its XLA custom calls differently
    for group in ([k for k in names if k != "ps_sum"],
                  [k for k in names if k == "ps_sum" and member]):
        fn = ops_of(thvd, ps, dtype, world, group, member)
        if mode != "eager":
            fn = tf.function(fn, jit_compile=(mode == "jit"))
        if group:
            out.update(fn(ts["x"], ts["xr"], ts["xv"], ts["xs"]))
    return {k: ([raw(t.numpy()) for t in v] if isinstance(v, list)
                else raw(v.numpy())) for k, v in out.items()}


def torch_results(hvd, ps, dtype, rank, world, member):
    """{op: raw result} of the port's torch API on the same inputs."""
    import torch

    from horovod_tpu_torch.tensorflow import to_numpy
    ts = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in inputs(dtype, rank, world).items()}
    out = ops_of(hvd, ps, dtype, world, op_names(dtype, "eager", "py"),
                 member)(ts["x"], ts["xr"], ts["xv"], ts["xs"])
    return {k: ([raw(to_numpy(t)) for t in v] if isinstance(v, list)
                else raw(to_numpy(v))) for k, v in out.items()}


def ps_of(hvd, world):
    """The process set of ``ps_sum``: ranks 0 and ``world - 1``, at world 2
    the global set (every rank registers a new one)."""
    if world > 2:
        return hvd.add_process_set([0, world - 1])
    return hvd.global_process_set


def _reinit(hvd, **env):
    hvd.shutdown()
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    hvd.init(device="cpu")


def case_tf_ops(hvd, rank, world):
    """Every op of :data:`OPS` on every dtype of :data:`TF_DTYPES`,
    eager, in ``tf.function`` and under ``jit_compile=True``, through the
    bridge, then again on the py_function path (``HOROVOD_TF_XLA_OPS=0``,
    a re-init) without ``jit_compile``, which then raises; beside the
    port's torch API on the same inputs.  ``ps_sum`` is scoped to
    :func:`ps_of`'s set, which the bridge resolves by its id."""
    hide_jax()
    import horovod_tpu_torch.tensorflow as thvd
    import tensorflow as tf
    from horovod_tpu_torch.tensorflow import _xla_bridge

    out = {"loaded": _xla_bridge.ops() is not None}
    for path in ("bridge", "py"):
        if path == "py":
            _reinit(hvd, HOROVOD_TF_XLA_OPS="0")
        ps = ps_of(hvd, world)
        member = rank in ps.ranks
        for dt in TF_DTYPES:
            out[(path, "torch", dt)] = torch_results(hvd, ps, dt, rank,
                                                     world, member)
            for mode in ("eager", "graph", "jit"):
                if mode == "jit" and path == "py":
                    continue
                out[(path, mode, dt)] = tf_results(
                    thvd, tf, ps, dt, rank, world, mode, path, member)
        out[(path, "psid")] = ps.process_set_id
        # the op types one dtype's graph holds: the bridge's ops, or
        # py_function's
        ts = [tf.constant(v, tf.float32) for v in
              inputs("float32", rank, world).values()]
        fn = ops_of(thvd, ps, "float32", world,
                    op_names("float32", "graph", path), member)
        out[(path, "op_types")] = sorted({
            o.type for o in tf.function(fn).get_concrete_function(*ts)
            .graph.get_operations()})
        if world > 2:
            hvd.remove_process_set(ps)
    # the knob's jit_compile failure names the fence
    try:
        tf.function(lambda x: thvd.allreduce(x, op=thvd.Sum, name="fence"),
                    jit_compile=True)(tf.ones([2]))
        out["fence_error"] = None
    except Exception as exc:  # noqa: BLE001 - the message is the result
        out["fence_error"] = f"{type(exc).__name__}: {exc}"
    _reinit(hvd, HOROVOD_TF_XLA_OPS=None)
    return out


def train_data(rank):
    """tests/helpers_runner.py ``tf_training_fn``'s shard of rank
    ``rank`` (its ``cross_rank()``)."""
    X = np.random.RandomState(3).randn(8, 2).astype("f4")
    y = (X @ np.array([[1.0], [-0.5]], dtype="f4")).astype("f4")
    return X[rank * 4:(rank + 1) * 4], y[rank * 4:(rank + 1) * 4]


def case_tf_train(hvd, rank, world):
    """helpers_runner's ``tf_training_fn`` (3 eager steps through
    ``DistributedGradientTape``) and ``tf_jit_training_fn`` (the whole
    step under ``jit_compile=True``) over the port's adapter."""
    hide_jax()
    import horovod_tpu_torch.tensorflow as thvd
    import tensorflow as tf
    Xn, yn = train_data(rank)
    Xs, ys = tf.constant(Xn), tf.constant(yn)
    out = {}
    w = tf.Variable([[0.2], [0.1]])
    thvd.broadcast_variables([w], root_rank=0)
    for _ in range(3):
        tape = thvd.DistributedGradientTape(tf.GradientTape())
        with tape:
            loss = tf.reduce_mean((tf.matmul(Xs, w) - ys) ** 2)
        g = tape.gradient(loss, [w])
        w.assign_sub(0.5 * g[0])
    out["eager"] = w.numpy()

    wj = tf.Variable([[0.2], [0.1]])
    thvd.broadcast_variables([wj], root_rank=0)

    @tf.function(jit_compile=True)
    def train_step():
        tape = thvd.DistributedGradientTape(tf.GradientTape())
        with tape:
            loss = tf.reduce_mean((tf.matmul(Xs, wj) - ys) ** 2)
        g = tape.gradient(loss, [wj])
        wj.assign_sub(0.5 * g[0])
        return loss

    for _ in range(3):
        train_step()
    out["jit"] = wj.numpy()
    return out


def case_tf_sparse(hvd, rank, world):
    """helpers_runner's ``tf_sparse_allreduce_fn`` (a ragged
    ``tf.IndexedSlices`` Sum) over the port's adapter, eagerly and in a
    ``tf.function``."""
    hide_jax()
    import horovod_tpu_torch.tensorflow as thvd
    import tensorflow as tf
    if rank == 0:
        sl = tf.IndexedSlices(values=tf.constant([[1.0], [2.0]]),
                              indices=tf.constant([0, 1], dtype=tf.int64),
                              dense_shape=tf.constant([4, 1], tf.int64))
    else:
        sl = tf.IndexedSlices(values=tf.constant([[10.0]]),
                              indices=tf.constant([1], dtype=tf.int64),
                              dense_shape=tf.constant([4, 1], tf.int64))

    def dense(s):
        return tf.scatter_nd(tf.reshape(s.indices, (-1, 1)), s.values,
                             (4, 1))

    out = {"dense": dense(thvd.allreduce(sl, op=thvd.Sum, name="sp2p"))
           .numpy().ravel().tolist()}
    graph = tf.function(lambda v, i: dense(thvd.allreduce(
        tf.IndexedSlices(v, i, tf.constant([4, 1], tf.int64)),
        op=thvd.Sum, name="sp2p.graph")))
    out["graph"] = graph(sl.values, sl.indices).numpy().ravel().tolist()
    return out


def case_tf_elastic(hvd, rank, world):
    """``TensorFlowKerasState``: rank-dependent weights, optimizer slots
    and a scalar; commit, change, restore; then sync (every rank takes
    rank 0's)."""
    hide_jax()
    import horovod_tpu_torch.tensorflow as thvd
    import tensorflow as tf
    tf.keras.utils.set_random_seed(5 + rank)
    model = tf.keras.Sequential([tf.keras.layers.Input(shape=(3,)),
                                 tf.keras.layers.Dense(2)])
    opt = tf.keras.optimizers.SGD(learning_rate=0.1, momentum=0.9)
    model.compile(optimizer=opt, loss="mse")
    X = np.random.RandomState(rank).randn(8, 3).astype("f4")
    model.train_on_batch(X, X[:, :2])  # makes the momentum slots
    state = thvd.elastic.TensorFlowKerasState(model, opt, epoch=rank)
    committed = [w.copy() for w in model.get_weights()]
    slots = [v.numpy().copy() for v in opt.variables]
    model.set_weights([np.zeros_like(w) for w in committed])
    for v in opt.variables:
        v.assign(tf.zeros_like(v))
    state.epoch = 99
    state.restore()
    out = {
        "restored": all(np.array_equal(a, b) for a, b in
                        zip(model.get_weights(), committed)),
        "slots_restored": all(np.array_equal(v.numpy(), s) for v, s in
                              zip(opt.variables, slots)),
        "epoch_restored": state.epoch,
    }
    state.sync()
    out["synced_weights"] = model.get_weights()
    out["synced_slots"] = [v.numpy() for v in opt.variables]
    out["synced_epoch"] = state.epoch
    out["committed"] = committed
    out["slots"] = slots
    return out


def case_tf_failed_build(hvd, rank, world):
    """The bridge's build fails on every rank (``CXX=false``, an empty
    build directory, ``$TF_BRIDGE_BUILD_DIR``): the first collective
    raises on every rank; then ``HOROVOD_TF_XLA_OPS=0`` (a re-init) runs
    the py_function path."""
    hide_jax()
    from horovod_tpu_torch.native import build as native_build
    native_build.BUILD_DIR = pathlib.Path(os.environ["TF_BRIDGE_BUILD_DIR"])
    os.environ["CXX"] = "false"
    import horovod_tpu_torch.tensorflow as thvd
    import tensorflow as tf
    out = {"built": sorted(p.name for p in
                           native_build.BUILD_DIR.glob("tf-xla-*/*.so"))}
    x = tf.constant([float(rank + 1)] * 2)
    for mode in ("eager", "graph"):
        def fn(t, mode=mode):
            return thvd.allreduce(t, op=thvd.Sum, name=f"f.{mode}")
        try:
            (fn if mode == "eager" else tf.function(fn))(x)
            out[mode] = None
        except Exception as exc:  # noqa: BLE001 - the message is the result
            out[mode] = (type(exc).__name__, str(exc))
    _reinit(hvd, HOROVOD_TF_XLA_OPS="0")
    out["knob_off_sum"] = tf.function(
        lambda t: thvd.allreduce(t, op=thvd.Sum, name="f.off"))(x) \
        .numpy().tolist()
    return out


def keras_data(rank, size):
    """Rank ``rank``'s shard of a seeded regression (64 rows, 4
    features): ``X[rank::size]``."""
    rng = np.random.RandomState(11)
    X = rng.randn(64, 4).astype("f4")
    y = (X @ rng.randn(4, 1).astype("f4")
         + 0.1 * rng.randn(64, 1).astype("f4")).astype("f4")
    return X[rank::size], y[rank::size]


#: the Keras fit's learning-rate callbacks: warmup over epochs 0-1 at 4
#: steps an epoch, then a smooth decay from epoch 2
KERAS_LR, KERAS_EPOCHS, KERAS_BATCH = 0.08, 4, 8


def keras_fit(tf, hvd, khvd, rank, size):
    """``model.fit`` with the four callbacks and ``hvd``'s
    ``DistributedOptimizer`` (rank 1 starts from other weights, which the
    broadcast callback replaces); returns the weights, the history and
    the learning rate each batch began with."""
    tf.keras.utils.set_random_seed(7)
    model = tf.keras.Sequential([
        tf.keras.layers.Input(shape=(4,)),
        tf.keras.layers.Dense(8, activation="tanh"),
        tf.keras.layers.Dense(1)])
    if rank:
        model.set_weights([w + 0.5 for w in model.get_weights()])
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(
        learning_rate=KERAS_LR, momentum=0.9))
    model.compile(optimizer=opt, loss="mse", metrics=["mae"])
    lrs = []

    class Record(tf.keras.callbacks.Callback):
        def on_train_batch_begin(self, batch, logs=None):
            lrs.append(float(np.asarray(self.model.optimizer.learning_rate)))

    X, y = keras_data(rank, size)
    steps = len(X) // KERAS_BATCH
    hist = model.fit(X, y, epochs=KERAS_EPOCHS, batch_size=KERAS_BATCH,
                     verbose=0, callbacks=[
                         khvd.BroadcastGlobalVariablesCallback(0),
                         khvd.MetricAverageCallback(),
                         khvd.LearningRateWarmupCallback(
                             initial_lr=KERAS_LR, warmup_epochs=2,
                             steps_per_epoch=steps),
                         khvd.LearningRateScheduleCallback(
                             initial_lr=KERAS_LR, start_epoch=2,
                             multiplier=lambda e: 1.0 / (1.0 + e - 2),
                             staircase=False, steps_per_epoch=steps),
                         Record()])
    return {"rank": rank, "weights": model.get_weights(),
            "history": {k: [float(v) for v in vs]
                        for k, vs in hist.history.items()},
            "lrs": lrs}


def case_keras_fit(hvd, rank, world):
    """:func:`keras_fit` over the port's adapters."""
    hide_jax()
    import horovod_tpu_torch.keras as khvd
    import horovod_tpu_torch.tensorflow as thvd
    import tensorflow as tf
    return keras_fit(tf, thvd, khvd, rank, world)


def jax_keras_fit():
    """:func:`keras_fit` over the JAX package's adapters (a worker of
    ``horovod_tpu.runner.run``)."""
    import tensorflow as tf

    import horovod_tpu.keras as khvd
    import horovod_tpu.tensorflow as hvd
    hvd.init()
    out = keras_fit(tf, hvd, khvd, hvd.cross_rank(), hvd.cross_size())
    hvd.shutdown()
    return out
