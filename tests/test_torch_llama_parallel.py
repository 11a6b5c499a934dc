"""The slice as a whole: the port's model-parallel Llama step over tp, sp
(ring and Ulysses), vocab parallelism, experts and the pipeline (pp),
against the JAX package's step at the same MeshConfig and its one-device
baseline.

Rank processes (tests/torch_ranks.py ``llama_mp``, gloo on the CPU) run
``make_llama_train_step`` over ``ParallelMesh(MeshConfig(...))`` for 3
steps from the full JAX weights, each rank on its slice of them
(``convert.llama_shard_params``) and its cut of the global batch
(``TrainStep.shard_batch``); worlds 2 and 4, one launch each.  The JAX
reference is tests/test_llama.py's ``run_steps`` on the virtual CPU
devices: its ``tiny(vocab=64, seq=32)`` model, its batch, ``optax.adamw
(3e-4)`` (the port's default) or ``optax.sgd(0.05)`` (``torch.optim.SGD``
at 0.05), which catches gradients off by a factor of tp or sp that
AdamW's scale invariance hides.

Tolerances are tests/test_llama.py's: atol 1e-4 on the losses of the
dense and vocab-parallel meshes, against the one-device baseline and
against JAX at the same mesh; the MoE meshes track the baseline within
5e-2 (per-shard capacity drops other tokens than one shard does) and
match JAX at the same mesh within 1e-4 (the same shards drop the same
tokens).  The pipeline runs tests/test_llama.py's pp meshes at world 4
(``dp2_pp2``, ``pp2_tp2``), pp 2 and pp 4 (a 4-layer model), and MoE
through the pipeline; with aux_loss_coef 1 the first loss does not scale
with n_microbatches (within tests/test_llama.py's 0.15).  Every rank's
losses are the same bits, and gathering a rank's slices
(``convert.llama_gather_params``) gives the full weights back bit for
bit.
"""

import dataclasses
import json

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
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh

CFG = jl.tiny(vocab=64, seq=32)
MOE = dataclasses.replace(CFG, n_experts=4, expert_top_k=2,
                          capacity_factor=2.0)
_RNG = np.random.RandomState(0)
TOKS = _RNG.randint(0, 64, (8, 32)).astype(np.int32)
TGTS = _RNG.randint(0, 64, (8, 32)).astype(np.int32)
ATOL = 1e-4
MOE_ATOL = 5e-2

#: name -> (jax config, mesh, step options, optimizer)
CONFIGS = {}
for _opt in ("adamw", "sgd"):
    for _name, _mesh, _kw in (
            ("tp2", {"tp": 2}, {}),
            ("sp2", {"sp": 2}, {}),
            ("sp2_tp2", {"sp": 2, "tp": 2}, {}),
            ("dp2_tp2", {"dp": 2, "tp": 2}, {}),
            ("ulysses_sp2_tp2", {"sp": 2, "tp": 2}, {"attn": "ulysses"})):
        CONFIGS[f"{_name}_{_opt}"] = (CFG, _mesh, _kw, _opt)
for _name, _cfg, _mesh in (
        ("vp_dp2_tp2", dataclasses.replace(CFG, vocab_parallel=True),
         {"dp": 2, "tp": 2}),
        ("vp_sp2_tp2", dataclasses.replace(CFG, vocab_parallel=True),
         {"sp": 2, "tp": 2}),
        ("vp_chunk_dp2_tp2", dataclasses.replace(
            CFG, vocab_parallel=True, loss_chunk=16), {"dp": 2, "tp": 2}),
        ("vp_chunk_sp2_tp2", dataclasses.replace(
            CFG, vocab_parallel=True, loss_chunk=8), {"sp": 2, "tp": 2})):
    CONFIGS[_name] = (_cfg, _mesh, {}, "sgd")
CONFIGS["remat_full_sp2_tp2"] = (
    dataclasses.replace(CFG, remat_policy="full", remat_skip_layers=1),
    {"sp": 2, "tp": 2}, {}, "sgd")
CONFIGS["accum2_dp2_tp2"] = (CFG, {"dp": 2, "tp": 2}, {"grad_accum": 2},
                             "sgd")
CONFIGS["moe_dp2_tp2"] = (MOE, {"dp": 2, "tp": 2}, {}, "sgd")
CONFIGS["moe_dp2_ep2"] = (MOE, {"dp": 2, "ep": 2}, {}, "sgd")
CONFIGS["moe_zero1_dp2_tp2"] = (MOE, {"dp": 2, "tp": 2}, {"zero1": True},
                                "sgd")
DEEP = dataclasses.replace(CFG, n_layers=4)
MOE_AUX1 = dataclasses.replace(MOE, aux_loss_coef=1.0)
for _opt in ("adamw", "sgd"):
    CONFIGS[f"dp2_pp2_{_opt}"] = (CFG, {"dp": 2, "pp": 2},
                                  {"n_microbatches": 2}, _opt)
    CONFIGS[f"pp2_tp2_{_opt}"] = (CFG, {"pp": 2, "tp": 2},
                                  {"n_microbatches": 4}, _opt)
CONFIGS["pp2_sgd"] = (CFG, {"pp": 2}, {"n_microbatches": 4}, "sgd")
CONFIGS["pp4_sgd"] = (DEEP, {"pp": 4}, {"n_microbatches": 2}, "sgd")
CONFIGS["remat_pp2_tp2"] = (
    dataclasses.replace(DEEP, remat_policy="full", remat_skip_layers=1),
    {"pp": 2, "tp": 2}, {"n_microbatches": 2}, "sgd")
CONFIGS["moe_dp2_pp2"] = (MOE, {"dp": 2, "pp": 2}, {"n_microbatches": 2},
                          "sgd")
CONFIGS["moe_aux1_pp2_mb2"] = (MOE_AUX1, {"pp": 2}, {"n_microbatches": 2},
                               "sgd")
CONFIGS["moe_aux1_pp2_mb4"] = (MOE_AUX1, {"pp": 2}, {"n_microbatches": 4},
                               "sgd")
#: tests/test_llama.py holds these to each other (the aux invariance
#: test), not to the one-device baseline: with coefficient 1 the
#: per-microbatch load balance is another loss than the whole batch's
NO_BASELINE = {"moe_aux1_pp2_mb2", "moe_aux1_pp2_mb4"}
#: the weights each configuration starts from
WEIGHTS = {"dense": CFG, "moe": MOE, "deep": DEEP}


def _weights_key(jcfg):
    return ("moe" if jcfg.n_experts else
            "deep" if jcfg.n_layers == DEEP.n_layers else "dense")


def _fields(jcfg):
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = f["param_dtype"] = "float32"
    return f


def jax_run(jcfg, mesh, kw, opt, steps=3):
    """tests/test_llama.py's run_steps over the first devices."""
    mc = JMeshConfig(**mesh)
    pmesh = JParallelMesh(mc, devices=jax.devices()[:mc.n_devices])
    optimizer = optax.sgd(0.05) if opt == "sgd" else optax.adamw(3e-4)
    ts = jtraining.make_llama_train_step(jcfg, pmesh, optimizer=optimizer,
                                         **kw)
    params, opt_state = ts.init_fn(jax.random.PRNGKey(0))
    sh = jtraining.make_data_sharding(ts)
    toks = jax.device_put(jnp.asarray(TOKS), sh)
    tgts = jax.device_put(jnp.asarray(TGTS), sh)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = ts.step_fn(params, opt_state, toks, tgts)
        losses.append(float(loss))
    return losses


def _weights(jcfg):
    """The JAX init's full weights, as the JAX step's init_fn makes them."""
    return jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each configuration's losses and round trip, per rank."""
    d = tmp_path_factory.mktemp("llama_mp")
    specs = {}
    for key, jcfg in WEIGHTS.items():
        w = _weights(jcfg)
        flat = {"embed": w["embed"], "final_norm": w["final_norm"],
                **{f"layers.{k}": v for k, v in w["layers"].items()}}
        np.savez(d / f"{key}.npz", **flat)
    for name, (jcfg, mesh, kw, opt) in CONFIGS.items():
        specs[name] = {"cfg": _fields(jcfg), "mesh": mesh, "step_kw": kw,
                       "opt": opt, "weights": _weights_key(jcfg)}
    (d / "llama_mp.json").write_text(json.dumps(specs))
    np.savez(d / "batch.npz", toks=TOKS, tgts=TGTS)
    env = {"LLAMA_MP_DIR": str(d)}
    out = {}
    for world in (2, 4):
        (d / f"w{world}").mkdir()
        ranks = torch_ranks.launch(world, ["llama_mp"], d / f"w{world}",
                                   env=env)
        for name in ranks[0]["llama_mp"]:
            out[name] = [r["llama_mp"][name] for r in ranks]
        out[f"pp_error_{world}"] = out.pop("pp_error")
    assert set(out) == set(CONFIGS) | {"pp_error_2", "pp_error_4"}
    return out


class _Baselines(dict):
    """The one-device JAX losses of a (config, optimizer), run on first
    use."""

    def __missing__(self, key):
        self[key] = jax_run(key[0], {}, {}, key[1])
        return self[key]


@pytest.fixture(scope="module")
def baselines():
    return _Baselines()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_parallel_step_matches_jax(port, baselines, name):
    jcfg, mesh, kw, opt = CONFIGS[name]
    ranks = port[name]
    losses = ranks[0]["losses"]
    for r in ranks:
        assert r["losses"] == losses, (name, [x["losses"] for x in ranks])
        assert r["round_trip"], name
    moe = jcfg.n_experts > 0
    if name not in NO_BASELINE:
        np.testing.assert_allclose(
            losses, baselines[(jcfg, opt)], rtol=0,
            atol=MOE_ATOL if moe else ATOL,
            err_msg=f"{name} vs the one-device baseline")
    same = jax_run(jcfg, mesh, kw, opt)
    np.testing.assert_allclose(losses, same, rtol=0, atol=ATOL,
                               err_msg=f"{name} vs JAX at {mesh}")


def test_step_refuses_pipeline_and_overlap_as_jax(port):
    """A pp mesh refuses a layer count it does not divide and a missing
    n_microbatches with the JAX package's messages, on every rank;
    overlap refuses MoE with the JAX package's message, as it refuses
    model axes."""
    for world in (2, 4):
        for err in port[f"pp_error_{world}"]:
            assert err == ["n_layers=3 must be divisible by pp=2",
                           "pipeline parallelism needs n_microbatches > 0"]
    with pytest.raises(ValueError, match="n_layers=3 must be divisible by "
                                         "pp=2"):
        jtraining.make_llama_train_step(
            dataclasses.replace(CFG, n_layers=3),
            JParallelMesh(JMeshConfig(pp=2), devices=jax.devices()[:2]))
    from horovod_tpu_torch import training
    with pytest.raises(ValueError, match="overlap=True currently composes "
                                         "with dp-only DENSE meshes"):
        training.make_llama_train_step(_port_cfg(MOE), overlap=True,
                                       device="cpu")
    with pytest.raises(ValueError, match="overlap=True currently composes "
                                         "with dp-only DENSE meshes"):
        jtraining.make_llama_train_step(
            MOE, JParallelMesh(JMeshConfig(dp=2),
                               devices=jax.devices()[:2]), overlap=True)


def test_moe_pipeline_aux_invariant_to_microbatch_count(port):
    """tests/test_llama.py's regression: with aux_loss_coef 1 the first
    loss of a MoE pipeline may not scale with n_microbatches (the aux is
    a mean over microbatches, not a sum)."""
    l2 = port["moe_aux1_pp2_mb2"][0]["losses"][0]
    l4 = port["moe_aux1_pp2_mb4"][0]["losses"][0]
    assert abs(l2 - l4) < 0.15, (l2, l4)


def test_baselines_fall_and_meshes_cut_the_batch(port, baselines):
    assert baselines[(CFG, "sgd")][-1] < baselines[(CFG, "sgd")][0]
    # [B/(dp·ep), T/sp] of the global [8, 32] batch on every rank
    for name, (_, mesh, _, _) in CONFIGS.items():
        rows = mesh.get("dp", 1) * mesh.get("ep", 1)
        for r in port[name]:
            assert r["local_batch"] == [8 // rows, 32 // mesh.get("sp", 1)]


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("vp", [False, True])
def test_param_specs_match_jax(moe, vp):
    """Leaf by leaf, the port's spec is JAX's PartitionSpec with the
    stacked layer dim dropped, for tp and the experts over ep; JAX's pp
    entry on that dim is the port's cut of the layer list
    (``leaf_axes``)."""
    jcfg = dataclasses.replace(MOE if moe else CFG, vocab_parallel=vp)
    for par in (jl.ParallelSpec(tp_axis="tp", ep_axis="dp"),
                jl.ParallelSpec(tp_axis="tp", ep_axis="ep"),
                jl.ParallelSpec(tp_axis="tp", pp_axis="pp"),
                jl.ParallelSpec(pp_axis="pp", ep_axis="dp"),
                jl.ParallelSpec()):
        jspec = jl.param_specs(par, jcfg)
        tpar = tl.ParallelSpec(tp_axis=par.tp_axis, ep_axis=par.ep_axis,
                               pp_axis=par.pp_axis)
        tspec = tl.param_specs(tpar, _port_cfg(jcfg))
        assert tspec["embed"] == tuple(jspec["embed"])
        assert tspec["final_norm"] == tuple(jspec["final_norm"])
        assert len(tspec["layers"]) == jcfg.n_layers
        for name in ("embed", "final_norm"):
            assert tl.leaf_axes(tspec, name, tpar) == {
                a for a in tuple(jspec[name]) if a is not None}
        for i, lp in enumerate(tspec["layers"]):
            assert sorted(lp) == sorted(jspec["layers"])
            for n, s in jspec["layers"].items():
                assert tuple(s)[0] == par.pp_axis   # the stacked dim
                assert lp[n] == tuple(s)[1:], (n, lp[n], s)
                assert tl.leaf_axes(tspec, f"layers.{i}.{n}", tpar) == {
                    a for a in tuple(s) if a is not None}


def _port_cfg(jcfg):
    f = _fields(jcfg)
    f["dtype"] = f["param_dtype"] = torch.float32
    return tl.LlamaConfig(**f)


def test_llama3_8b_configs_and_count_params():
    """Llama-3-8B with the tied head: 7.50B parameters, as JAX counts;
    the config-4 training config keeps JAX's fields."""
    for t, j in ((tl.llama3_8b(), jl.llama3_8b()),
                 (tl.llama3_8b_train_cfg(), jl.llama3_8b_train_cfg()),
                 (tl.llama3_8b_train_cfg(2048), jl.llama3_8b_train_cfg(2048))):
        for f in dataclasses.fields(j):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert tl.count_params(t) == jl.count_params(j)
    assert abs(tl.count_params(tl.llama3_8b()) - 7.50e9) / 7.5e9 < 0.01
    assert (tl.LLAMA8B_TP, tl.LLAMA8B_DP) == (jl.LLAMA8B_TP, jl.LLAMA8B_DP)


def test_init_params_tp_is_full_and_checks_divisibility():
    cfg = _port_cfg(CFG)
    from horovod_tpu_torch.tree import tree_leaves
    full = tl.init_params(cfg, seed=1, device="cpu")
    tp2 = tl.init_params(cfg, seed=1, tp=2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp2),
                                                 tree_leaves(full)))
    with pytest.raises(ValueError, match="must divide tp=3"):
        tl.init_params(cfg, tp=3, device="cpu")


def test_shard_params_on_one_device_is_the_identity():
    """At MeshConfig() every leaf is its own full slice (the multi-rank
    cuts and their gather are checked in the launches above)."""
    cfg = _port_cfg(dataclasses.replace(MOE, vocab_parallel=True))
    full = tl.init_params(cfg, seed=2, device="cpu")
    pm = ParallelMesh(MeshConfig(), devices=["cpu"])
    par = tl.ParallelSpec()
    part = convert.llama_shard_params(full, cfg, pm, par)
    back = convert.llama_gather_params(part, cfg, pm, par)
    for a, b, c in zip(full["layers"], part["layers"], back["layers"]):
        for n in a:
            assert torch.equal(a[n], b[n]) and torch.equal(a[n], c[n])
            assert b[n].data_ptr() != a[n].data_ptr()
