"""Parity of the port's FSDP step (``training.make_llama_fsdp_step``,
``fsdp_param_specs``, ``spec_all_gather``, ``spec_shard``) with the JAX
package's.

Rank processes (tests/torch_ranks.py ``fsdp``, gloo on the CPU) run the
step at dp 2 and dp 4, with ``overlap=False`` (each layer gathered just in
time, the gathers' backward reduce-scattering) and ``overlap=True`` (one
gather, the overlapped plane's sharded update), from the JAX init's
weights, on tests/test_llama.py's ``tiny(vocab=64, seq=32)`` model and
batch, 3 steps.  Tolerance: tests/test_llama.py
``test_fsdp_matches_baseline``'s atol 1e-4 on the losses, against its
one-device baseline (``optax.sgd(0.05)``, and ``optax.adamw(3e-4)``, the
port's default) and against JAX's FSDP step at the same dp.  The spec
map is held leaf by leaf (the port's dim is JAX's minus 1 on every layer
leaf), the per-rank bytes exactly, and the refusals by JAX's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks
from horovod_tpu import training as jtraining
from horovod_tpu.models import llama as jl
from horovod_tpu.parallel.mesh import MeshConfig as JMeshConfig
from horovod_tpu.parallel.mesh import ParallelMesh as JParallelMesh
from horovod_tpu_torch import training
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh

CFG = jl.tiny(vocab=64, seq=32)
_RNG = np.random.RandomState(0)
TOKS = _RNG.randint(0, 64, (8, 32)).astype(np.int32)
TGTS = _RNG.randint(0, 64, (8, 32)).astype(np.int32)
ATOL = 1e-4
WORLDS = (2, 4)


def _optimizer(opt):
    return optax.sgd(0.05) if opt == "sgd" else optax.adamw(3e-4)


def jax_baseline(opt):
    """tests/test_llama.py's run_steps on one device."""
    pmesh = JParallelMesh(JMeshConfig(), devices=jax.devices()[:1])
    ts = jtraining.make_llama_train_step(CFG, pmesh,
                                         optimizer=_optimizer(opt))
    return _run(ts)


def jax_fsdp(world, opt):
    pmesh = JParallelMesh(JMeshConfig(dp=world),
                          devices=jax.devices()[:world])
    ts = jtraining.make_llama_fsdp_step(CFG, pmesh,
                                        optimizer=_optimizer(opt))
    return _run(ts)


def _run(ts):
    params, opt_state = ts.init_fn(jax.random.PRNGKey(0))
    sh = jtraining.make_data_sharding(ts)
    toks = jax.device_put(jnp.asarray(TOKS), sh)
    tgts = jax.device_put(jnp.asarray(TGTS), sh)
    losses = []
    for _ in range(3):
        params, opt_state, loss = ts.step_fn(params, opt_state, toks, tgts)
        losses.append(float(loss))
    return losses, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import os
    d = tmp_path_factory.mktemp("fsdp")
    w = jax.tree_util.tree_map(np.asarray,
                               jl.init_params(CFG, jax.random.PRNGKey(0)))
    np.savez(d / "dense.npz", embed=w["embed"], final_norm=w["final_norm"],
             **{f"layers.{k}": v for k, v in w["layers"].items()})
    np.savez(d / "batch.npz", toks=TOKS, tgts=TGTS)
    os.environ["FSDP_DIR"] = str(d)
    return torch_ranks.Worlds(tmp_path_factory, ["fsdp"])


@pytest.fixture(scope="module")
def baselines():
    return {opt: jax_baseline(opt)[0] for opt in ("sgd", "adamw")}


@pytest.mark.parametrize("run", list(torch_ranks.FSDP_RUNS))
@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_matches_baseline_and_jax(ranks, baselines, world, run):
    overlap, opt = torch_ranks.FSDP_RUNS[run]
    res = [r["fsdp"][run] for r in ranks[world]]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        for path, a in res[0]["final"].items():
            np.testing.assert_array_equal(r["final"][path], a)
    np.testing.assert_allclose(res[0]["losses"], baselines[opt], rtol=0,
                               atol=ATOL, err_msg=f"{run} vs baseline")
    want, jparams = jax_fsdp(world, opt)
    np.testing.assert_allclose(res[0]["losses"], want, rtol=0, atol=ATOL,
                               err_msg=f"{run} vs JAX fsdp at dp {world}")
    # the weights after the steps, gathered, against JAX's
    jflat = {"embed": np.asarray(jparams["embed"]),
             "final_norm": np.asarray(jparams["final_norm"])}
    for k, v in jparams["layers"].items():
        for i in range(CFG.n_layers):
            jflat[f"layers.{i}.{k}"] = np.asarray(v[i])
    for path, a in res[0]["final"].items():
        np.testing.assert_allclose(a, jflat[path], rtol=0, atol=ATOL,
                                   err_msg=f"{run} {path}")


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_bytes_are_the_spec_shards(ranks, world):
    """Each rank holds exactly the shards fsdp_param_specs names: its
    parameter bytes are the sum over leaves of numel / dp (numel for a
    replicated leaf) times 4; AdamW's two fp32 moments are twice that;
    the overlapped step's tiles are 1/dp of the padded buckets; all below
    one replica's."""
    full = tl.init_params(_port_cfg(CFG), device="meta")
    specs = training.fsdp_param_specs(full, world)
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    want, replica = 0, 0
    for path, t in zip(tree_paths(full), tree_leaves(full)):
        spec = tl.leaf_spec(specs, path)
        want += t.numel() * 4 // (world if "dp" in spec else 1)
        replica += t.numel() * 4
    for r in ranks[world]:
        res = r["fsdp"]
        for run in torch_ranks.FSDP_RUNS:
            assert res[run]["param_bytes"] == want, run
        assert res["sgd"]["state_bytes"] == 0
        assert res["adamw"]["state_bytes"] == 2 * want
        tiles = res["adamw_overlap"]["tile_bytes"]
        assert res["adamw_overlap"]["state_bytes"] == 2 * tiles
        # the tiles cover the padded buckets: 1/dp of at least a replica
        assert replica <= tiles * world and tiles < replica
        assert replica <= want * world and want < replica
        # dp all-gathers and reduce-scatters move the sharded leaves
        step = res["sgd"]["step_bytes"]
        assert step["dp.all_gather"] > 0 and step["dp.psum_scatter"] > 0


def _port_cfg(jcfg):
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = f["param_dtype"] = torch.float32
    return tl.LlamaConfig(**f)


@pytest.mark.parametrize("dp", [2, 4, 8, 3])
def test_fsdp_param_specs_match_jax_leaf_by_leaf(dp):
    """Each leaf's sharded dim is JAX's, minus 1 on the layer leaves
    (the port's layers are a list: no stacked scan dim)."""
    jshapes = jax.eval_shape(lambda k: jl.init_params(CFG, k),
                             jax.random.PRNGKey(0))
    jspecs = jtraining.fsdp_param_specs(jshapes, dp)
    tspecs = training.fsdp_param_specs(
        tl.init_params(_port_cfg(CFG), device="meta"), dp)
    for k in ("embed", "final_norm"):
        assert tspecs[k] == tuple(jspecs[k]), k
    for i in range(CFG.n_layers):
        for n, js in jspecs["layers"].items():
            js = tuple(js)
            jdim = js.index("dp") if "dp" in js else None
            ts = tspecs["layers"][i][n]
            tdim = ts.index("dp") if "dp" in ts else None
            assert (tdim is None) == (jdim is None), (n, ts, js)
            if jdim is not None:
                assert tdim == jdim - 1, (n, ts, js)


def test_fsdp_specs_shard_embed_axis0():
    """tests/test_llama.py's case: d_model indivisible by dp shards
    embed over V; a layer leaf shards its widest divisible dim."""
    specs = training.fsdp_param_specs(
        {"embed": torch.empty(64, 6, device="meta"),
         "layers": [{"wq": torch.empty(6, 8, device="meta")}] * 2}, dp=8)
    assert specs["embed"] == ("dp", None)
    assert specs["layers"][0]["wq"] == (None, "dp")
    # a tie: the first such dim
    assert training.fsdp_param_specs(
        {"w": torch.empty(8, 8, device="meta")}, 2)["w"] == ("dp", None)


@pytest.mark.parametrize("mesh", ["moe", "tp", "pp", "sp", "ep"])
def test_fsdp_refusals_are_jax_messages(mesh):
    """One device's mesh refuses as JAX's (the check comes first)."""
    cfg = CFG
    kw = {}
    if mesh == "moe":
        cfg = dataclasses.replace(CFG, n_experts=4)
        kw = {"dp": 2}
    elif mesh == "ep":
        kw = {"dp": 2, "ep": 2}
    else:
        kw = {mesh: 2}
    jm = JMeshConfig(**kw)
    with pytest.raises(ValueError) as je:
        jtraining.make_llama_fsdp_step(
            cfg, JParallelMesh(jm, devices=jax.devices()[:jm.n_devices]))

    class _Mesh:
        config = MeshConfig(**kw)
        devices = [torch.device("cpu")]

    with pytest.raises(ValueError) as te:
        training.make_llama_fsdp_step(_port_cfg(cfg), _Mesh())
    assert str(te.value) == str(je.value)
