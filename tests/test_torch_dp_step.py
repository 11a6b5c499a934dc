"""The slice as a whole: the port's data-parallel Llama step at dp 2 against
the JAX package's dp-2 step.

Two gloo rank processes (tests/torch_ranks.py) each run
``make_llama_train_step`` under ``hvd.init()`` on their half of the batch
for 3 steps of ``adamw_lp(3e-4)``; the gradients and the loss go through
the engine's negotiated, fused allreduce.  Rank 1 builds its parameter
dicts in reverse key order, so its gradients are submitted in another
order than rank 0's and negotiation has to pair them.  The JAX reference
is ``make_llama_train_step`` on a dp-2 mesh of the virtual CPU devices,
from the same converted weights and the same batch: 2 layers at narrow
widths, with the one-shot loss and with ``fused_xent=True``.  With
``fused_xent`` the port runs its fused loss (the kernels' plain versions
on the CPU); the JAX step takes its one-shot loss there, the same
function, because its Pallas kernels cannot run in interpret mode inside
the dp-2 step's ``shard_map`` (the interpreter trips the step's
``check_vma``), and the JAX package falls through off the TPU without it.

Tolerances: the two ranks apply the same reduced gradients to the same
weights, so they agree bit for bit.  Against JAX, the tolerances of
tests/test_torch_training.py's one-device trajectory (losses rtol 1e-5;
parameters atol 1e-5 on all but 0.1% of entries and 2·lr per step
everywhere), for the reasons given there.

A world of one in this process checks that the step under ``hvd.init()``,
which then reduces through the engine and the process group, leaves the
losses and weights bit-identical to the step without a runtime.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import training as jtraining
from horovod_tpu.models import llama as jl
from horovod_tpu.ops import fused_xent as jfx
from horovod_tpu.optim import precision as jprecision
from horovod_tpu.parallel.mesh import MeshConfig as JMeshConfig
from horovod_tpu.parallel.mesh import ParallelMesh as JParallelMesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.optim import precision
from horovod_tpu_torch.tree import tree_leaves, tree_paths

import torch_ranks
from test_torch_llama import torch_cfg

CONFIGS = {
    "oneshot": jl.tiny(vocab=64, seq=32),
    "fused": dataclasses.replace(jl.tiny(vocab=128, seq=32), d_model=128,
                                 fused_xent=True, loss_chunk=48),
}
LR = 3e-4


def _batch(vocab, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (8, 32)).astype(np.int32),
            rng.randint(0, vocab, (8, 32)).astype(np.int32))


def _flat(tree):
    return dict(zip(tree_paths(tree), tree_leaves(tree)))


@pytest.fixture(scope="module")
def jax_runs():
    """3 JAX dp-2 steps per config: initial weights, losses, final weights
    (flattened by path)."""
    out = {}
    for seed, (name, cfg) in enumerate(sorted(CONFIGS.items())):
        assert not jfx.supported(jnp.zeros((4, 32, cfg.d_model)),
                                 jnp.zeros((cfg.vocab_size, cfg.d_model)),
                                 jnp.zeros((4, 32), jnp.int32))
        ts = jtraining.make_llama_train_step(
            cfg, JParallelMesh(JMeshConfig(dp=2)),
            optimizer=jprecision.adamw_lp(LR))
        params, state = ts.init_fn(jax.random.PRNGKey(seed))
        init = jax.tree_util.tree_map(np.array, params)
        toks, tgts = _batch(cfg.vocab_size, seed)
        losses = []
        for _ in range(3):
            params, state, loss = ts.step_fn(params, state,
                                             jnp.asarray(toks),
                                             jnp.asarray(tgts))
            losses.append(float(loss))
        out[name] = (init, toks, tgts, losses,
                     _flat(jax.tree_util.tree_map(np.array, params)))
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_step")
    spec = {}
    for name, (init, toks, tgts, _, _) in jax_runs.items():
        tcfg = torch_cfg(CONFIGS[name])
        fields = {f.name: getattr(tcfg, f.name)
                  for f in dataclasses.fields(tcfg)}
        fields["dtype"] = str(tcfg.dtype).removeprefix("torch.")
        fields["param_dtype"] = str(tcfg.param_dtype).removeprefix("torch.")
        spec[name] = fields
        np.savez(d / f"{name}.npz", toks=toks, tgts=tgts, **_flat(init))
    (d / "dp_step.json").write_text(json.dumps(spec))
    return torch_ranks.launch(2, ["dp_step"], d,
                              env={"DP_STEP_DIR": str(d)})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ranks_stay_bit_identical(port_runs, name):
    r0, r1 = (r["dp_step"][name] for r in port_runs)
    assert r0["order"] != r1["order"]          # submitted in other orders
    assert sorted(r0["order"]) == sorted(r1["order"])
    assert r0["losses"] == r1["losses"]
    for path, a in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][path], a, err_msg=path)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dp2_step_matches_jax_dp2_step(jax_runs, port_runs, name):
    _, _, _, jlosses, jparams = jax_runs[name]
    got = port_runs[0]["dp_step"][name]
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    assert set(got["params"]) == set(jparams)
    for path, want in jparams.items():
        diff = np.abs(got["params"][path] - want)
        assert (diff > 1e-5).mean() <= 1e-3, (path, (diff > 1e-5).sum())
        assert diff.max() <= 3 * 2 * LR, (path, diff.max())


def test_gradients_fuse_into_buckets(port_runs):
    stats = port_runs[0]["stats"]
    # 3 steps x 2 configs x (2 layers x 9 + 2 leaves + the loss)
    assert stats["tensors"] == 3 * 2 * 21
    assert stats["buckets"] < stats["tensors"]


def test_world_of_one_is_bit_identical_to_no_runtime():
    cfg = torch_cfg(CONFIGS["oneshot"])
    toks, tgts = (torch.from_numpy(a) for a in _batch(cfg.vocab_size, 0))
    runs = []
    for init in (False, True):
        if init:
            hvd.init(device="cpu")
        try:
            ts = training.make_llama_train_step(
                cfg, optimizer=precision.adamw_lp(LR), device="cpu")
            assert (ts.mesh.process_set is not None) == init
            params, opt_state = ts.init_fn(0)
            losses = []
            for _ in range(2):
                params, opt_state, loss = ts.step_fn(params, opt_state, toks,
                                                     tgts)
                losses.append(loss.item())
            runs.append((losses, [p.detach().clone()
                                  for p in tree_leaves(params)]))
            if init:
                stats = hvd.runtime._state().engine.stats()
                assert stats["tensors"] == 2 * 21
                assert 0 < stats["buckets"] < stats["tensors"]
        finally:
            hvd.shutdown()
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
