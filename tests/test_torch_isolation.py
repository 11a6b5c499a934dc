"""The PyTorch port stands alone: no jax, no horovod_tpu, card by default.

The import check runs in a subprocess because this test process has
already imported jax (tests/conftest.py).
"""

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


def test_sources_import_neither_jax_nor_horovod_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|horovod_tpu\b(?!_torch))", re.M)
    for path in PKG.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)


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
