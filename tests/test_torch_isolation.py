"""The PyTorch port stands alone: no jax, no horovod_tpu, card by default.

The import check runs in a subprocess because this test process has
already imported jax (tests/conftest.py).
"""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "horovod_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "horovod_tpu_torch.ops.flash_attention" in mods
    assert "horovod_tpu_torch.ops.fused_xent" in mods
    # the distributed optimizer's modules (overlap, ZeRO, the wire)
    for m in ("optim.overlap", "optim.distributed", "compression",
              "ops.collectives", "ops.fusion"):
        assert f"horovod_tpu_torch.{m}" in mods
    # serving: the decode path, the hvdserve plane and its transport,
    # metrics and chaos
    for m in ("models.generate", "serving", "serving.shapes",
              "serving.admission", "serving.plane", "serving.worker",
              "serving.paging", "serving.models", "runner", "runner.rpc",
              "runner.secret", "metrics", "metrics.registry",
              "metrics.flight", "metrics.aggregate", "chaos",
              "chaos.schedule"):
        assert f"horovod_tpu_torch.{m}" in mods
    # the classifier models, synchronized batch norm and their step
    for m in ("models.bert", "models.resnet", "models.mnist",
              "ops.sync_batch_norm", "sync_batch_norm", "training",
              "convert"):
        assert f"horovod_tpu_torch.{m}" in mods
    # elastic Horovod, the launcher, checkpoints and the data loaders
    for m in ("elastic", "elastic.driver", "elastic.worker",
              "elastic.state", "elastic.runner", "elastic.sampler",
              "elastic.discovery", "elastic.registration", "runner.launch",
              "runner.spawn", "runner.hosts", "runner.network",
              "runner.__main__", "checkpoint", "data", "data.data_loader"):
        assert f"horovod_tpu_torch.{m}" in mods
    # the rest of the distributed optimizer and the engine's tools
    for m in ("ops.adasum", "timeline", "stall", "autotune"):
        assert f"horovod_tpu_torch.{m}" in mods
    # the parallel layouts: the mesh's axes, their collectives, the ring,
    # Ulysses, MoE
    for m in ("parallel.mesh", "parallel.axis", "parallel.ring_attention",
              "parallel.ulysses", "models.moe"):
        assert f"horovod_tpu_torch.{m}" in mods
    # the pipeline; BERT's tp and sp, FSDP and model-parallel serving
    # live in modules listed above
    for m in ("parallel.pipeline",):
        assert f"horovod_tpu_torch.{m}" in mods
    # checkpointless recovery, hvd.run and the executor, the parquet reader
    for m in ("elastic.recovery", "runner.api", "runner.run_task",
              "runner.executor", "runner.executor_task", "data.parquet",
              "optim"):
        assert f"horovod_tpu_torch.{m}" in mods
    # the training-health plane, the time series and the SLO watchdog
    for m in ("health", "health.evaluate", "health.taps",
              "health.__main__", "metrics.timeseries", "metrics.slo",
              "metrics.top", "metrics.jobscrape"):
        assert f"horovod_tpu_torch.{m}" in mods
    # the native control-plane core, the torch adapter's import path and
    # the estimator's torch half
    for m in ("native", "native.build", "native.loader", "torch",
              "torch.elastic", "torch.sync_batch_norm", "estimator",
              "estimator.store", "estimator._worker",
              "estimator.torch_estimator", "estimator.lightning_estimator"):
        assert f"horovod_tpu_torch.{m}" in mods
    # the analysis plane: the hvdlint engines and the schedule recorder
    for m in ("analysis", "analysis.__main__", "analysis.cli",
              "analysis.report", "analysis.baseline", "analysis.callgraph",
              "analysis.lock_order", "analysis.guarded_by",
              "analysis.lifecycle", "analysis.user_rules",
              "analysis.divergence", "analysis.wire", "analysis.contracts",
              "analysis.recorder", "analysis.schedule"):
        assert f"horovod_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_elastic_surface_imports_without_jax():
    """``hvd.elastic``'s names, ``checkpoint`` and ``data`` come with a
    plain ``import horovod_tpu_torch`` and load no jax."""
    code = (
        "import sys\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import checkpoint, data\n"
        "names = [hvd.elastic.run, hvd.elastic.TensorState,\n"
        "         hvd.elastic.TorchState, hvd.elastic.ElasticSampler,\n"
        "         hvd.HostsUpdatedInterrupt, checkpoint.save,\n"
        "         checkpoint.restore, data.ShardedLoader]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


#: top-level names of the JAX package the port leaves out by design
#: (ROADMAP.md §C, "The world model": no stacked mode, no mesh) or has no
#: torch counterpart for (``compat``: jax version shims; ``version``: the
#: port keeps ``__version__`` in its ``__init__``)
DELIBERATE = {"mesh", "worker_axis", "process_count", "process_index",
              "stack_on_workers", "worker_values", "compat", "version"}
#: top-level names not ported yet, by ROADMAP.md item (none now)
STILL_MISSING = {}


def test_top_level_names_resolve_as_in_jax():
    """Every public name of ``import horovod_tpu`` resolves on ``import
    horovod_tpu_torch``, but for the deliberate differences and the
    names still to port, which this test names."""
    code = (
        "import json\n"
        "import horovod_tpu as j, horovod_tpu_torch as t\n"
        "names = [n for n in vars(j) if not n.startswith('_')]\n"
        "print(json.dumps(sorted(n for n in names if not hasattr(t, n))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    missing = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert missing - DELIBERATE == set(STILL_MISSING)
    import horovod_tpu_torch as hvd
    for name in ("NotInitializedError", "get_process_set_ids_and_ranks",
                 "start_timeline", "stop_timeline", "start_profiler",
                 "stop_profiler", "tracing", "health"):
        assert name in hvd.__all__ and hasattr(hvd, name), name
    assert callable(hvd.health.note_loss) and \
        callable(hvd.health.on_unhealthy)
    with pytest.raises(hvd.NotInitializedError):
        hvd.get_process_set_ids_and_ranks()


@pytest.mark.parametrize("sub", ["runner", "data", "elastic", "optim",
                                 "torch", "estimator"])
def test_subpackage_names_resolve_as_in_jax(sub):
    """Every public name of ``horovod_tpu.<sub>`` that is not a module
    (nor a helper its source imports from ``typing``, ``contextlib`` or
    ``__future__``) resolves on ``horovod_tpu_torch.<sub>``
    (``hvd.runner.run``, ``hvd.runner.TpuExecutor``,
    ``hvd.data.ParquetDataset``, ``horovod_tpu_torch.torch.TorchHandle``,
    ...), but for the names still to port or left out by design, which
    this test names."""
    code = (
        "import __future__, importlib, json, types\n"
        f"j = importlib.import_module('horovod_tpu.{sub}')\n"
        f"t = importlib.import_module('horovod_tpu_torch.{sub}')\n"
        "helper = lambda v: isinstance(v, __future__._Feature) or \\\n"
        "    getattr(v, '__module__', None) in ('typing', 'contextlib')\n"
        "names = [n for n, v in vars(j).items() if not n.startswith('_')\n"
        "         and not isinstance(v, types.ModuleType)\n"
        "         and not helper(v)]\n"
        "print(json.dumps(sorted(n for n in names if not hasattr(t, n))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    missing = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert missing == SUB_MISSING[sub]
    if sub == "runner":
        from horovod_tpu_torch.runner import TpuExecutor, run
        assert callable(run) and TpuExecutor.__name__ == "TpuExecutor"
    if sub == "data":
        from horovod_tpu_torch.data import ParquetDataset, ParquetLoader
        assert ParquetLoader.__mro__[1].__name__ == "BaseDataLoader"
        assert ParquetDataset.__name__ == "ParquetDataset"
    if sub == "torch":
        import horovod_tpu_torch as top
        import horovod_tpu_torch.torch as hvd
        from horovod_tpu_torch.ops.engine import Handle
        assert hvd.TorchHandle is Handle and hvd.allreduce is top.allreduce
        assert hvd.DistributedOptimizer is top.DistributedOptimizer
        assert hvd.elastic.TorchState is top.elastic.TorchState
        assert hvd.elastic.run is top.elastic.run
        assert hvd.SyncBatchNorm is top.SyncBatchNorm


#: public names of the JAX subpackages the port's lack: by design
#: (``ArrayState``/``TpuState``: the port's ``TensorState``;
#: ``fused_tail_reduce_tree``: the port's ``fused_reduce_tree`` takes the
#: hierarchical path itself; ``scale_by_adam_lp``: an optax
#: transformation, where the port has the optimizer ``AdamWLP``) or by
#: ROADMAP.md item (the Keras estimator, with the TF/Keras adapters)
SUB_MISSING = {
    "runner": set(), "data": set(),
    "elastic": {"ArrayState", "TpuState"},
    "optim": {"fused_tail_reduce_tree", "scale_by_adam_lp"},
    "torch": set(),
    "estimator": {"KerasEstimator", "KerasModel", "load_keras_model"},
}


def test_sources_import_neither_jax_nor_horovod_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|horovod_tpu\b(?!_torch))", re.M)
    for path in PKG.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)


def test_analysis_runs_without_jax_or_horovod_tpu():
    """The port's hvdlint lints a script and its schedule module reads a
    pinned snapshot with neither jax nor horovod_tpu loaded; the data
    plane's import of the recorder leaves the engines unloaded."""
    code = (
        "import sys\n"
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch.ops import collectives\n"
        "lazy = 'horovod_tpu_torch.analysis.cli' not in sys.modules\n"
        "from horovod_tpu_torch.analysis import analyze_source, schedule\n"
        "src = 'import horovod_tpu_torch as hvd\\nif hvd.rank() == 0:\\n'"
        " '    hvd.allreduce(x)\\n'\n"
        "codes = [f.code for f in analyze_source(src, 'x.py')]\n"
        "snap = schedule.load_snapshot('distopt_step')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
        "print(bad, codes, len(snap.records), lazy)\n"
        "sys.exit(0 if not bad and codes == ['HVD001'] and lazy"
        " and len(snap.records) == 3 else 1)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")


def test_entry_points_raise_without_a_card(no_card):
    from horovod_tpu_torch import convert, default_device, training
    from horovod_tpu_torch.models import bert, generate, llama, mnist, resnet
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.serving.models import toy_echo_forward
    from horovod_tpu_torch.serving.shapes import ShapeBuckets
    cfg = llama.tiny()
    for call in (default_device,
                 lambda: llama.init_params(cfg),
                 lambda: training.make_llama_train_step(cfg),
                 lambda: ParallelMesh(MeshConfig()),
                 lambda: convert.llama_params_from_numpy({}),
                 lambda: generate.init_kv_cache(cfg, 1, 8),
                 lambda: generate.init_paged_kv_cache(cfg, 2, 4),
                 lambda: toy_echo_forward(ShapeBuckets((1,), (8,))),
                 lambda: bert.init_params(bert.tiny()),
                 lambda: bert.make_dp_finetune_step(
                     bert.tiny(), bert.finetune_optimizer),
                 lambda: resnet.init(resnet.ResNetConfig(variant=18)),
                 lambda: mnist.init(),
                 lambda: training.make_classifier_train_step(
                     None, None),
                 lambda: convert.resnet_params_from_numpy({}, {}),
                 lambda: convert.mnist_params_from_numpy({})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
