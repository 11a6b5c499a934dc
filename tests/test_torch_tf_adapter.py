"""The port's TensorFlow adapter (``horovod_tpu_torch/tensorflow/``, the op
bridge ``native/tf_xla_ops.cc``) against the JAX package's and the port's
own torch API, on the CPU.

* World 1, in this process: every op on every dtype of the bridge's
  kernels, eager (through the engine), in ``tf.function`` and under
  ``jit_compile=True`` (lowered to TF ops), bit for bit alike and equal
  to the torch API's result.
* Worlds 2 and 3, gloo rank processes (``tests/torch_ranks.py`` running
  ``tests/torch_tf_cases.py``): every op through the bridge (eager,
  graph, XLA) and through ``py_function`` (``HOROVOD_TF_XLA_OPS=0``),
  bit for bit the torch API's on the same inputs; a Sum in a
  ``tf.function`` sums the ranks (the JAX package keys "one process" on
  ``cross_size()``, 1 here); with the knob off ``jit_compile`` raises
  naming the fence; a failed build raises on every rank.
* Against the JAX package at np 2 (``horovod_tpu.runner.run`` on
  ``tests/helpers_runner.py``'s functions): tape training, eager and
  under ``jit_compile=True``, within 1e-6 (the JAX test's tolerance);
  the ragged sparse allreduce exactly.
* The elastic state at world 2; the import rules with TF hidden; both
  packages' op libraries loaded in one process.

The launches run two at a time from one module fixture; the first
world-2 launch builds the bridge (~55 s of g++ on a fresh tree).
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import helpers_runner  # noqa: E402
import torch_ranks  # noqa: E402
import torch_tf_cases as cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
#: the JAX package's workers (tests/test_tf_adapter.py's env)
JAX_ENV = {"HOROVOD_TPU_FORCE_PLATFORM": "cpu",
           "PYTHONPATH": REPO + ":" + TESTS,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
           "HOROVOD_CYCLE_TIME": "0.2", "OMP_NUM_THREADS": "1"}
W2_CASES = [f"torch_tf_cases:{c}" for c in
            ("tf_train", "tf_sparse", "tf_elastic", "tf_ops")]
#: the tape training's tolerance against the JAX package's (its own)
TRAIN_TOL = 1e-6


def _jax_run(fn):
    from _helpers import free_port
    from horovod_tpu.runner import run
    res = torch_ranks.retried(
        lambda: run(fn, np=2, env=JAX_ENV, port=free_port()))
    return {r["rank"]: r for r in res}


class Runs(dict):
    """Each launch's result by key, started at once on a pool of two
    and read when a test first asks; a failed launch fails only the
    tests that read it."""

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
    def tmp(name):
        return tmp_path_factory.mktemp(name)

    empty = tmp("empty_build")
    r = Runs({
        "w2": lambda: torch_ranks.launch(2, W2_CASES, tmp("w2")),
        "jax_jit": lambda: _jax_run(helpers_runner.tf_jit_training_fn),
        "jax_train": lambda: _jax_run(helpers_runner.tf_training_fn),
        "failed": lambda: torch_ranks.launch(
            2, ["torch_tf_cases:tf_failed_build"], tmp("failed"),
            env={"TF_BRIDGE_BUILD_DIR": str(empty)}),
        "w3": lambda: torch_ranks.launch(3, ["torch_tf_cases:tf_ops"],
                                         tmp("w3")),
        "jax_sparse": lambda: _jax_run(
            helpers_runner.tf_sparse_allreduce_fn),
    })
    yield r
    r.close()


# -- world 1, in this process -----------------------------------------------

@pytest.fixture(scope="module")
def world1():
    """Per dtype: {mode: {op: raw}} of the adapter at world 1 and the
    torch API's (``"torch"``), computed at first use."""
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.tensorflow as thvd
    hvd.init(device="cpu")
    got = {}

    def of(dtype):
        if dtype not in got:
            ps = hvd.global_process_set
            got[dtype] = {mode: cases.tf_results(thvd, tf, ps, dtype, 0, 1,
                                                 mode, "lowered", True)
                          for mode in ("eager", "graph", "jit")}
            got[dtype]["torch"] = cases.torch_results(hvd, ps, dtype, 0, 1,
                                                      True)
        return got[dtype]
    yield of
    hvd.shutdown()


W1_CASES = [(dt, op) for dt in cases.TF_DTYPES
            for op in cases.op_names(dt, "eager", "lowered")]


def _expected_world1(dtype, op):
    """Each op at world 1 by numpy: the identity, scaled by the factors."""
    arrs = cases.inputs(dtype, 0, 1)
    x, xr = arrs["x"], arrs["xr"]
    _, pre, post = cases.scales(dtype)
    out = {"scaled": x * pre * post, "grouped": [x, x[:2] * 2],
           "agv": arrs["xv"], "grouped_ag": [x, arrs["xv"]],
           "a2a": xr, "a2av": arrs["xs"], "rs": xr, "rs_avg": xr,
           "grouped_rs": [xr, xr * 2]}.get(op, x)
    cast = (lambda a: cases.raw(tf.cast(a, getattr(tf, dtype)).numpy()))
    return [cast(a) for a in out] if isinstance(out, list) else cast(out)


@pytest.mark.parametrize("dtype,op", W1_CASES)
def test_world_1_eager_graph_and_xla_agree_bitwise(world1, dtype, op):
    """At world 1 the engine (eager) and the trace-time lowering
    (``tf.function``, ``jit_compile=True``) give the same bits, the torch
    API's and numpy's identity."""
    got = world1(dtype)
    want = _expected_world1(dtype, op)
    for mode in ("eager", "graph", "jit", "torch"):
        assert got[mode][op] == want, (mode, dtype, op)


def test_world_1_graph_has_no_collective_op(world1):
    """At world 1 a ``jit_compile=True`` function holds neither a
    py_function nor a bridge op: the lowering is plain TF."""
    import horovod_tpu_torch.tensorflow as thvd
    x = tf.ones([4, 2])
    graph = tf.function(lambda t: [
        thvd.allreduce(t, op=thvd.Sum), thvd.allgather(t),
        thvd.alltoall(t), thvd.reducescatter(t),
        *thvd.grouped_allreduce([t, t])], jit_compile=True) \
        .get_concrete_function(x).graph
    types = {o.type for o in graph.get_operations()}
    assert not {"EagerPyFunc", "HorovodTorchCollective",
                "HorovodTorchGroupedAllreduce"} & types


def test_get_process_set_by_id(world1):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import runtime
    ps = hvd.global_process_set
    assert runtime.get_process_set_by_id(ps.process_set_id) is ps
    with pytest.raises(ValueError, match="not registered"):
        runtime.get_process_set_by_id(1234)


def test_the_bridge_is_keyed_by_source_and_tensorflow(monkeypatch):
    """The artifact's directory changes with TF's version and the
    compiler; it lives under build/horovod_tpu_torch/."""
    from horovod_tpu_torch.native import tf_build
    path = tf_build.artifact_path()
    assert path.parent.name.startswith("tf-xla-")
    assert path.parts[-4:-2] == ("build", "horovod_tpu_torch")
    monkeypatch.setattr(tf, "__version__", tf.__version__ + ".other")
    assert tf_build.artifact_path() != path
    monkeypatch.undo()
    monkeypatch.setenv("CXX", "clang++")
    assert tf_build.artifact_path() != path


def test_sanitize_name_and_bf16_boundary(world1):
    import ml_dtypes
    import torch

    from horovod_tpu_torch.tensorflow import _xla_bridge
    assert _xla_bridge.sanitize_name("a b/c:0-x.y") == "a_b/c_0-x.y"
    a = np.array([1.5, -2.25, 3e38], dtype=ml_dtypes.bfloat16)
    t = _xla_bridge.to_torch(a)
    assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
    back = _xla_bridge.to_numpy(t)
    assert back.dtype == a.dtype and back.tobytes() == a.tobytes()


# -- worlds 2 and 3 against the port's own API --------------------------------

def _ops_run(runs, world):
    return [r["torch_tf_cases:tf_ops"] for r in runs[f"w{world}"]]


@pytest.mark.parametrize("path", ["bridge", "py"])
def test_sum_in_a_tf_function_sums_both_ranks(runs, path):
    """The world-size trap: two ranks on one host have ``cross_size() ==
    1``; a Sum in a ``tf.function`` still sums both ranks' tensors, on
    the bridge and on the py_function path."""
    want = {}
    for dt in cases.TF_DTYPES:
        total = cases.base(dt, 0) + cases.base(dt, 1)
        want[dt] = cases.raw(tf.cast(total, getattr(tf, dt)).numpy())
    for res in _ops_run(runs, 2):
        for dt in cases.TF_DTYPES:
            for mode in ("graph", "jit") if path == "bridge" else ("graph",):
                assert res[(path, mode, dt)]["sum"] == want[dt], (mode, dt)


def test_the_bridge_path_runs_the_bridges_ops(runs):
    """The bridge path's graphs hold the port's registered ops (renamed
    from the JAX package's) for the collectives it carries, the
    py_function path's only py_functions; the scoped call's set id rides
    the op."""
    for world in (2, 3):
        for res in _ops_run(runs, world):
            assert res["loaded"]
            bridge, py = res[("bridge", "op_types")], res[("py",
                                                           "op_types")]
            assert {"HorovodTorchCollective",
                    "HorovodTorchGroupedAllreduce"} <= set(bridge)
            assert "EagerPyFunc" in py
            assert not {t for t in py if t.startswith("Horovod")}
            assert res[("bridge", "psid")] == (1 if world > 2 else 0)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("op", cases.OPS)
def test_ops_match_the_ports_torch_api(runs, world, op):
    """Each op through both paths and every mode, on every dtype, is bit
    for bit the port's torch API on the same numpy inputs."""
    seen = 0
    for rank, res in enumerate(_ops_run(runs, world)):
        member = op != "ps_sum" or rank in (0, world - 1)
        for path in ("bridge", "py"):
            for dt in cases.TF_DTYPES:
                want = res[(path, "torch", dt)].get(op)
                assert (want is not None) == (
                    member and op in cases.op_names(dt, "eager", "py"))
                for mode in ("eager", "graph", "jit"):
                    got = res.get((path, mode, dt), {}).get(op)
                    if got is None:
                        continue
                    assert got == want, (rank, path, mode, dt)
                    seen += 1
    assert seen > 0


def test_scoped_and_ragged_results_are_right(runs):
    """The scoped Sum adds only its members' tensors; the ragged
    allgather concatenates every rank's rows (torch API and adapter
    alike, already equal)."""
    for world in (2, 3):
        for rank, res in enumerate(_ops_run(runs, world)):
            got = res[("bridge", "torch", "float32")]
            if rank in (0, world - 1):
                want = cases.base("float32", 0) + cases.base(
                    "float32", world - 1)
                assert got["ps_sum"] == cases.raw(want.astype("f4"))
            rows = np.concatenate([cases.inputs("float32", r, world)["xv"]
                                   for r in range(world)]).astype("f4")
            assert got["agv"] == cases.raw(rows)


@pytest.mark.parametrize("world", [2, 3])
def test_knob_off_jit_compile_raises_naming_the_fence(runs, world):
    for res in _ops_run(runs, world):
        err = res["fence_error"]
        assert err is not None
        assert "requires_jit_compile_False_see_docs_adapters_md" in err


def test_a_failed_build_raises_on_every_rank(runs):
    """``CXX=false`` with an empty build directory: every rank raises the
    same error at its first collective (eager and again in a graph),
    naming both ranks and ``HOROVOD_TF_XLA_OPS=0``; none hangs (the
    launch's timeout); with that knob the py_function path sums."""
    res = [r["torch_tf_cases:tf_failed_build"] for r in runs["failed"]]
    for r in res:
        assert r["built"] == []
        kind, msg = r["eager"]
        assert kind == "TfXlaBridgeError", msg
        assert "HOROVOD_TF_XLA_OPS=0" in msg
        assert "rank(s) [0, 1]" in msg
        assert "compiler failed" in msg and "false -shared" in msg
        # raised while tracing: TF's autograph wraps it, message intact
        kind, graph_msg = r["graph"]
        assert kind == "StagingError"
        assert f"TfXlaBridgeError: {msg.splitlines()[0]}" in graph_msg
        assert r["knob_off_sum"] == [3.0, 3.0]
    assert res[0]["eager"] == res[1]["eager"]


# -- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("mode,jax_key", [("eager", "jax_train"),
                                          ("jit", "jax_jit")])
def test_tape_training_matches_jax(runs, mode, jax_key, record_property):
    """``DistributedGradientTape`` training at np 2, eagerly and with the
    whole step under ``jit_compile=True`` (the bridge's XLA kernels),
    equals the JAX package's within 1e-6 on both ranks."""
    port = [r["torch_tf_cases:tf_train"][mode] for r in runs["w2"]]
    jax = runs[jax_key]
    assert not any(r.get("skipped") for r in jax.values())
    bitwise = True
    for rank in (0, 1):
        want = np.asarray(jax[rank]["w"], np.float32)
        np.testing.assert_allclose(port[rank], want, rtol=0, atol=TRAIN_TOL)
        bitwise &= port[rank].tobytes() == want.tobytes()
    np.testing.assert_array_equal(port[0], port[1])
    record_property("bitwise", bitwise)
    print(f"tape training ({mode}) against JAX: bitwise={bitwise}")


def test_sparse_allreduce_matches_jax(runs):
    """Ragged ``tf.IndexedSlices`` (2 and 1 nonzero rows) sum as the JAX
    package's do, eagerly and in a ``tf.function``."""
    jax = runs["jax_sparse"]
    for rank, r in enumerate(runs["w2"]):
        got = r["torch_tf_cases:tf_sparse"]
        assert got["dense"] == jax[rank]["dense"] == [1.0, 12.0, 0.0, 0.0]
        assert got["graph"] == got["dense"]


def test_elastic_state_restores_and_syncs(runs):
    res = [r["torch_tf_cases:tf_elastic"] for r in runs["w2"]]
    for rank, r in enumerate(res):
        assert r["restored"] and r["slots_restored"]
        assert r["epoch_restored"] == rank
        assert r["synced_epoch"] == 0
        for got, want in zip(r["synced_weights"], res[0]["committed"]):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(r["synced_slots"], res[0]["slots"]):
            np.testing.assert_array_equal(got, want)
    assert not all(np.array_equal(a, b) for a, b in
                   zip(res[0]["committed"], res[1]["committed"]))


# -- processes of their own ---------------------------------------------------

def _child(code, env=None, timeout=180):
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


NO_TF = """
import json, sys
sys.modules["tensorflow"] = None
import horovod_tpu_torch, horovod_tpu_torch.torch, horovod_tpu_torch.estimator
from horovod_tpu_torch import runner
from horovod_tpu_torch.estimator import (KerasEstimator, KerasModel,
                                         load_keras_model)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("tensorflow", "keras") and sys.modules[m] is not None)
errors = {}
for mod in ("tensorflow", "keras", "mxnet"):
    try:
        __import__("horovod_tpu_torch." + mod)
        errors[mod] = None
    except ImportError as exc:
        errors[mod] = [type(exc).__name__, str(exc)]
def launched(*a, **k):
    raise AssertionError("a worker was launched")
runner.run = launched
import numpy as np
for call in ("fit", "load"):
    try:
        if call == "fit":
            KerasEstimator(model=object(), optimizer="sgd", loss="mse",
                           np=2).fit(np.zeros((4, 2)), np.zeros((4, 1)))
        else:
            load_keras_model(None, "run")
        errors[call] = None
    except ImportError as exc:
        errors[call] = [type(exc).__name__, str(exc)]
print(json.dumps({"loaded": loaded, "errors": errors}))
"""


def test_import_rules_without_tensorflow():
    """With TF hidden: the top level, ``.torch`` and ``.estimator`` import
    and load no TF or Keras; ``.tensorflow``, ``.keras`` and ``.mxnet``
    raise an ImportError naming the missing package and the port's torch
    path; ``KerasEstimator.fit`` and ``load_keras_model`` raise one before
    any worker starts."""
    got = _child(NO_TF)
    assert got["loaded"] == []
    for key, package in (("tensorflow", "tensorflow"),
                         ("keras", "tensorflow"), ("mxnet", "mxnet"),
                         ("fit", "tensorflow"), ("load", "tensorflow")):
        kind, msg = got["errors"][key]
        assert kind == "ImportError", (key, msg)
        assert package in msg and "horovod_tpu_torch" in msg, (key, msg)
        if key != "fit" and key != "load":
            assert "horovod_tpu_torch.torch" in msg, (key, msg)
    assert "TorchEstimator" in got["errors"]["fit"][1]


BOTH = """
import json
import numpy as np
import tensorflow as tf
from horovod_tpu.tensorflow import _xla_bridge as jax_bridge
from horovod_tpu_torch.tensorflow import _xla_bridge as port_bridge
assert jax_bridge.available()
port = port_bridge.load()
jax = jax_bridge.ops()
import horovod_tpu, horovod_tpu_torch
horovod_tpu.init()
horovod_tpu_torch.init(device="cpu")
x = tf.constant([1.0, 2.0])

def both(t):
    a = jax.horovod_tpu_collective(t, kind="allreduce", tensor_name="j",
                                   reduce_op="sum", nproc=1)
    b = port.horovod_torch_collective(t, kind="allreduce", tensor_name="p",
                                      reduce_op="sum", nproc=1)
    c = port.horovod_torch_grouped_allreduce([t], tensor_name="g",
                                             reduce_op="sum")
    return a, b, c[0]

out = {"eager": [v.numpy().tolist() for v in both(x)],
       "jit": [v.numpy().tolist()
               for v in tf.function(both, jit_compile=True)(x)],
       "names": sorted(n for n in dir(port) + dir(jax)
                       if n.startswith("horovod_"))}
horovod_tpu_torch.shutdown()
horovod_tpu.shutdown()
print(json.dumps(out))
"""


def test_both_packages_op_libraries_load_in_one_process(runs):
    """The JAX package's library and the port's register other op and
    FFI target names, so both load in one process (as under xdist), and
    each runs its own package's engine, eagerly and under XLA."""
    runs["w2"], runs["jax_jit"]   # both libraries are built by now
    env = {k: v for k, v in JAX_ENV.items() if k != "PYTHONPATH"}
    got = _child(BOTH, env=env)
    assert got["eager"] == got["jit"] == [[1.0, 2.0]] * 3
    assert {"horovod_torch_collective", "horovod_torch_grouped_allreduce",
            "horovod_tpu_collective",
            "horovod_tpu_grouped_allreduce"} <= set(got["names"])
