"""The port's spec plan against the JAX package's.

The pure functions (``canonicalize_spec``, ``spec_axes``, ``spec_shift``,
``make_spec_plan``, ``sharded_tile_layout``'s spec-keyed tiles) take the
same spec trees on both sides: JAX ``PartitionSpec``s, and the port's
per-dim tuples of the same entries.  The port names a leaf by its dotted
path, JAX by its keystr; the canonical strings are equal.

The whole transform runs at world 4 as gloo rank processes
(``tests/torch_ranks.py`` ``case_spec_plan``: ``MeshConfig(dp=2, tp=2)``)
on ``tests/test_fsdp_compose.py``'s awkward leaves (``w`` (8, 5) sharded
over the model axis, ``b`` (3,), ``n`` (6,)), ``adamw_lp`` with bf16
moments, ``backward_passes_per_step=2``, 4 steps, a 64-byte threshold,
``sharded_update`` off and on.  The JAX reference is its
``DistributedOptimizer(param_specs=...)`` under ONE 2-D ``shard_map``
over 4 virtual CPU devices (mesh data 2 x model 2; the JAX package's own
test nests ``pmap``, which this jax refuses), at that test's tolerances
(rtol 2e-5, atol 2e-6).  ZeRO's per-rank inner-state bytes equal JAX's
``sharded_tile_layout`` tiles exactly (2 bf16 moments a tile element; the
port's step counter is a Python int, JAX's an int32 of 4 bytes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.optim import distributed as jdist
from horovod_tpu.optim.precision import adamw_lp as jadamw_lp
from horovod_tpu.optim.precision import tree_nbytes as jtree_nbytes
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.optim import distributed as tdist
from horovod_tpu_torch.runtime import ReduceOp

import torch_ranks as tr

DATA, MODEL = "fdata", "fmodel"
RTOL, ATOL = 2e-5, 2e-6

#: (JAX PartitionSpec, the port's per-dim spec): the same entries
SPEC_PAIRS = [
    (None, None),
    (P(), ()),
    (P(None, None), (None, None)),
    (P("model"), ("model",)),
    (P(None, "model"), (None, "model")),
    (P(("data", "model")), (("data", "model"),)),
    (P("a", "b"), ("a", "b")),
    (P(None, ("x", "y"), "z"), (None, ("x", "y"), "z")),
]


@pytest.mark.parametrize("jspec,tspec", SPEC_PAIRS)
def test_canonicalize_spec_matches_jax(jspec, tspec):
    want = jfusion.canonicalize_spec(jspec)
    assert tfusion.canonicalize_spec(tspec) == want
    # idempotent on canonical strings, like JAX's
    assert tfusion.canonicalize_spec(want) == want


@pytest.mark.parametrize("s", ["replicated", "model", "1:model",
                               "0:data+model", "0:a,1:b", "0:a+b,2:a"])
def test_string_specs_axes_and_shift_match_jax(s):
    assert tfusion.canonicalize_spec(s) == jfusion.canonicalize_spec(s)
    c = jfusion.canonicalize_spec(s)
    assert tfusion.spec_axes(c) == jfusion.spec_axes(c)
    try:
        want = jfusion.spec_shift(c)
    except ValueError as e:
        with pytest.raises(ValueError, match="leading"):
            tfusion.spec_shift(c)
        assert "leading" in str(e)
    else:
        assert tfusion.spec_shift(c) == want


def _plans(jspecs, tspecs, **kw):
    return (jdist.make_spec_plan(jspecs, DATA, **kw),
            tdist.make_spec_plan(tspecs, DATA, **kw))


def _keys_equal(jplan, tplan):
    """The port's by_name is JAX's, keyed by dotted path."""
    def dotted(k):
        return ".".join(p.strip("[]'") for p in k.replace("][", "]|[")
                        .split("|"))
    return {dotted(k): v for k, v in jplan.by_name.items()} == tplan.by_name


def test_make_spec_plan_with_explicit_model_axes_matches_jax():
    jplan, tplan = _plans(
        {"w": P(MODEL), "n": P(), "layers": {"q": P(None, MODEL)}},
        {"w": (MODEL,), "n": (), "layers": {"q": (None, MODEL)}},
        model_axes=(MODEL,))
    assert tplan.model_axes == jplan.model_axes == (MODEL,)
    assert _keys_equal(jplan, tplan)
    for spec in ("replicated", f"0:{MODEL}", f"0:{DATA}", f"1:{MODEL}"):
        assert tplan.reduce_axes(spec) == jplan.reduce_axes(spec)
    for mod in (jdist, tdist):
        with pytest.raises(ValueError, match="data axis"):
            mod.make_spec_plan({"w": P(MODEL)} if mod is jdist
                               else {"w": (MODEL,)}, DATA,
                               model_axes=(DATA,))


def test_make_spec_plan_infers_model_axes_from_specs_and_env(monkeypatch):
    """The inferred axes: the specs' plus HOROVOD_MODEL_AXES, sorted, the
    data axis dropped; read from the environment on both sides while
    neither runtime is initialized."""
    from horovod_tpu import runtime as jruntime
    from horovod_tpu_torch import runtime as truntime
    # another test module of this process may have initialized either
    # runtime: its config would then shadow the environment
    monkeypatch.setattr(jruntime._state(), "config", None)
    monkeypatch.setattr(truntime._state(), "config", None)
    monkeypatch.delenv("HOROVOD_MODEL_AXES", raising=False)
    jplan, tplan = _plans({"w": P(MODEL), "n": P()},
                          {"w": (MODEL,), "n": ()})
    assert tplan.model_axes == jplan.model_axes == (MODEL,)
    assert _keys_equal(jplan, tplan)
    # all-replicated specs can still name the model axes through the env
    monkeypatch.setenv("HOROVOD_MODEL_AXES", f"zz, {MODEL},{DATA}")
    jplan, tplan = _plans({"n": P()}, {"n": ()})
    assert tplan.model_axes == jplan.model_axes == (MODEL, "zz")
    # a spec naming the data axis drops that axis from its reduction
    jplan, tplan = _plans({"f": P(DATA)}, {"f": (DATA,)})
    assert tplan.reduce_axes(f"0:{DATA}") == jplan.reduce_axes(f"0:{DATA}")


def test_spec_plan_keys_follow_the_ports_layer_list():
    """The port's layers are a list of dicts, its leaves named by dotted
    paths (``tree.tree_paths``); a spec without an entry raises."""
    tplan = tdist.make_spec_plan(
        {"embed": (), "layers": [{"wq": (None, "tp")}, {"wq": (None, "tp")}]},
        "dp")
    assert tplan.by_name == {"embed": "replicated", "layers.0.wq": "1:tp",
                             "layers.1.wq": "1:tp"}
    assert tplan.model_axes == ("tp",)
    with pytest.raises(ValueError, match="no entry"):
        tplan.specs_for(["layers.2.wq"])


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("threshold", [64, 1 << 20])
def test_sharded_tile_layout_with_a_spec_plan_matches_jax(shards, threshold):
    """The spec-keyed ZeRO tiles of the local model shards: JAX's
    ``sharded_tile_layout`` (``optim/distributed.py:736``) and the port's
    give the same buckets, sizes and tiles."""
    local = {"w": (4, 5), "b": (3,), "n": (6,)}
    jlocal = {k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, s in local.items()}
    tlocal = {k: torch.empty(s, device="meta") for k, s in local.items()}
    jl = jdist.sharded_tile_layout(
        jlocal, shards, threshold_bytes=threshold,
        spec_plan=jdist.make_spec_plan({"w": P(MODEL), "b": P(), "n": P()},
                                       DATA, (MODEL,)))
    tl = tdist.sharded_tile_layout(
        tlocal, shards, threshold_bytes=threshold,
        spec_plan=tdist.make_spec_plan({"w": (MODEL,), "b": (), "n": ()},
                                       DATA, (MODEL,)))
    for attr in ("numel", "padded_numel", "shard_numel", "sizes"):
        assert [getattr(b, attr) for b in tl.buckets] == \
            [getattr(b, attr) for b in jl.buckets], attr
    if shards == 2 and threshold == 64:
        assert [b.shard_numel for b in tl.buckets] == [10, 5]


# ---------------------------------------------------------------------------
# the whole transform at world 4 against one 2-D shard_map
# ---------------------------------------------------------------------------

def _jax_spec_run(sharded: bool):
    """JAX's spec-aware DistributedOptimizer under one shard_map over a
    (data 2, model 2) mesh of virtual CPU devices, device (d, m) = d*2+m:
    each device's final parameters ``[2, 2, ...]`` and inner-state
    bytes."""
    D = M = 2
    full = tr.SPEC_FULL
    tx = jdist.DistributedOptimizer(
        jadamw_lp(tr.SPEC_LR), axis_name=DATA,
        threshold_bytes=tr.SPEC_THRESHOLD,
        backward_passes_per_step=tr.SPEC_K, sharded_update=sharded,
        param_specs={"w": P(MODEL), "b": P(), "n": P()},
        model_axes=(MODEL,))
    params = tr.spec_params()
    steps = tr.spec_grads()
    stacked = {k: np.stack([g[k] for g in steps], 1).reshape(
        (D, M, len(steps)) + full[k]) for k in full}
    rows = full["w"][0] // M

    def prog(gw, gb, gn):
        idx = jax.lax.axis_index(MODEL)
        p = {k: jnp.asarray(v) for k, v in params.items()}
        p["w"] = jax.lax.dynamic_slice_in_dim(p["w"], idx * rows, rows, 0)
        s = tx.init(p)
        for st in range(len(steps)):
            g = {"w": gw[0, 0, st], "b": gb[0, 0, st], "n": gn[0, 0, st]}
            gsum = jax.lax.psum(g["w"], MODEL)   # the model's transpose
            g["w"] = jax.lax.dynamic_slice_in_dim(gsum, idx * rows, rows, 0)
            u, s = tx.update(g, s, p)
            p = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
        nb = jnp.asarray(jtree_nbytes(s.inner), jnp.int32)
        return {k: v[None, None] for k, v in p.items()}, nb[None, None]

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(D, M), (DATA, MODEL))
    f = jax.shard_map(prog, mesh=mesh, in_specs=(P(DATA, MODEL),) * 3,
                      out_specs=({k: P(DATA, MODEL) for k in full},
                                 P(DATA, MODEL)),
                      check_vma=False)
    p_out, nb = jax.jit(f)(stacked["w"], stacked["b"], stacked["n"])
    return ({k: np.asarray(v) for k, v in p_out.items()},
            np.asarray(nb))


@pytest.fixture(scope="module")
def spec_world(tmp_path_factory):
    return tr.launch(4, ["spec_plan"], tmp_path_factory.mktemp("spec4"))


@pytest.fixture(scope="module")
def jax_runs():
    return {sharded: _jax_spec_run(sharded) for sharded in (False, True)}


@pytest.mark.parametrize("config", sorted(tr.SPEC_CONFIGS))
def test_spec_transform_at_world_4_matches_jax_shard_map(spec_world,
                                                        jax_runs, config):
    """Every rank's parameters after the steps, against the JAX device at
    the same mesh coordinates: ``w``'s rows of this rank's model shard,
    ``b`` and ``n`` whole.  The mesh-context and overlap configs run the
    same plan, so they are held to JAX the same way."""
    sharded = tr.SPEC_CONFIGS[config].get("sharded_update", False)
    want, _ = jax_runs[sharded]
    for rank, res in enumerate(spec_world):
        dp, tp = res["spec_plan"]["coords"]
        assert (dp, tp) == divmod(rank, 2)
        got = res["spec_plan"][config]["params"]
        for k in tr.SPEC_FULL:
            np.testing.assert_allclose(
                got[k], want[k][dp, tp], rtol=RTOL, atol=ATOL,
                err_msg=f"{config} rank {rank} leaf {k}")


def test_spec_transform_from_the_mesh_context_agrees_bitwise(spec_world):
    """The spec tree from the mesh's context plans as the explicit one:
    the same bits.  (The overlap plan at k=2 reduces the accumulator and
    the last micro-step apart, ``(R(acc) + R(g)) / k`` as in JAX, so it
    is held to JAX above, not to the plain plan's bits.)"""
    for res in spec_world:
        r = res["spec_plan"]
        for a, b in (("plain", "context"), ("sharded", "context_sharded")):
            for k in tr.SPEC_FULL:
                assert np.array_equal(r[a]["params"][k], r[b]["params"][k]), \
                    (a, b, k)


def test_zero_state_bytes_are_the_tiles_exactly(spec_world, jax_runs):
    """Per-rank inner-state bytes under sharded_update: 2 bf16 moments on
    the tiles of JAX's ``sharded_tile_layout`` of the local shards over
    the data axis (JAX adds its 4-byte int32 count), 1/(model x data) of
    the parameters plus padding; the replicated state is larger."""
    local = {"w": jax.ShapeDtypeStruct((4, 5), jnp.float32),
             "b": jax.ShapeDtypeStruct((3,), jnp.float32),
             "n": jax.ShapeDtypeStruct((6,), jnp.float32)}
    layout = jdist.sharded_tile_layout(
        local, 2, threshold_bytes=tr.SPEC_THRESHOLD,
        spec_plan=jdist.make_spec_plan({"w": P(MODEL), "b": P(), "n": P()},
                                       DATA, (MODEL,)))
    tiles = sum(bl.shard_numel for bl in layout.buckets)
    assert tiles == 15
    _, jax_bytes = jax_runs[True]
    assert (jax_bytes == 2 * tiles * 2 + 4).all()
    for res in spec_world:
        r = res["spec_plan"]
        assert r["sharded"]["tiles"] == [bl.shard_numel
                                         for bl in layout.buckets]
        for config in ("sharded", "context_sharded", "overlap_sharded"):
            assert r[config]["state_bytes"] == 2 * tiles * 2, config
        assert r["plain"]["state_bytes"] == 2 * (20 + 3 + 6) * 2


def test_buckets_cross_the_axes_their_specs_leave(spec_world):
    """The bytes each axis carried in the 2 boundaries of the 4 steps:
    the tp-sharded bucket (``w``, 20 fp32 elements) crosses dp only, the
    replicated one (``b`` and ``n``, 9) crosses tp and dp; sharded, the
    replicated bucket's tp hop carries its padded 10 elements and the dp
    hop reduce-scatters both padded buckets."""
    for res in spec_world:
        r = res["spec_plan"]
        assert r["plain"]["bytes"] == {"tp.all_reduce": 2 * 9 * 4,
                                       "dp.all_reduce": 2 * (20 + 9) * 4}
        assert r["sharded"]["bytes"] == {"tp.all_reduce": 2 * 10 * 4,
                                         "dp.psum_scatter": 2 * 30 * 4}


def test_state_partition_specs_of_the_sharded_state(spec_world):
    """``optim.state_partition_specs``: under sharded_update the inner
    state's non-scalar leaves (the moments on the tiles) and the tiles
    vary over the data axis; the accumulator of k=2 varies over it dim 0
    first; ``count`` is replicated (JAX ``state_partition_specs``)."""
    part = spec_world[0]["spec_plan"]["sharded"]["partition"]
    # AdamWLP's state a tile: its step count (a Python int) and moments
    assert part.inner == {f"inner/{i}/{k}": () if k == "count" else ("dp",)
                          for i in range(2) for k in ("count", "mu", "nu")}
    assert part.acc == {"w": ("dp", None), "b": ("dp",), "n": ("dp",)}
    assert part.count == () and part.residual is None
    assert part.tiles == (("dp",), ("dp",))


# ---------------------------------------------------------------------------
# the refusals, the mesh context and the overlap taps' specs
# ---------------------------------------------------------------------------

def test_transform_refusals_match_jax():
    """Without a mesh the port refuses param_specs as JAX does without an
    axis_name; both refuse health with specs, a data-axis spec under
    sharded_update, and an op other than Average or Sum."""
    import optax
    from horovod_tpu_torch.optim import precision
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    make = precision.adamw_lp(1e-2)
    with pytest.raises(ValueError, match="param_specs requires"):
        jdist.DistributedGradientTransform(optax.adam(1e-3),
                                           param_specs={"w": P("m")})
    with pytest.raises(ValueError, match="param_specs requires"):
        tdist.DistributedGradientTransform(make, param_specs={"w": ("tp",)})
    pmesh = ParallelMesh(MeshConfig(), devices=["cpu"])
    with pytest.raises(ValueError, match="health.*param_specs"):
        jdist.DistributedGradientTransform(
            optax.adam(1e-3), axis_name=DATA, health=True,
            param_specs={"w": P(MODEL)})
    with pytest.raises(ValueError, match="health.*param_specs"):
        tdist.DistributedGradientTransform(
            make, health=True, param_specs={"w": ("tp",)}, mesh=pmesh)
    with pytest.raises(ValueError, match="data axis"):
        jdist.DistributedGradientTransform(
            optax.adam(1e-3), axis_name=DATA, sharded_update=True,
            param_specs={"w": P(DATA)})
    with pytest.raises(ValueError, match="data axis"):
        tdist.DistributedGradientTransform(
            make, sharded_update=True, param_specs={"w": ("dp",)},
            mesh=pmesh)
    with pytest.raises(ValueError, match="Average/Sum"):
        tdist.DistributedGradientTransform(
            make, op=ReduceOp.MAX, param_specs={"w": ("tp",)},
            mesh=pmesh)
    with pytest.raises(ValueError, match="not axes of the mesh"):
        tdist.DistributedGradientTransform(
            make, param_specs={"w": ("model",)}, mesh=pmesh)


def test_an_alias_of_the_data_axis_counts_as_the_data_axis(monkeypatch):
    """On a mesh without its own ep axis, ep is dp: a spec naming ep
    shards over the data axis (its bucket runs no collective, and
    sharded_update refuses it), inference drops ep from the model axes
    whether the specs or HOROVOD_MODEL_AXES name it, and an explicit
    model axis ep is refused as the data axis itself."""
    from horovod_tpu_torch.optim import precision
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    pmesh = ParallelMesh(MeshConfig(dp=1), devices=["cpu"])
    specs = {"w": ("ep", None), "n": ()}
    plan = tdist.make_spec_plan(specs, "dp", mesh=pmesh)
    assert plan.model_axes == ()
    assert plan.reduce_axes(plan.by_name["w"]) == ()
    assert plan.reduce_axes(plan.by_name["n"]) == ("dp",)
    assert plan.global_size() == 1
    monkeypatch.setenv("HOROVOD_MODEL_AXES", "ep")
    assert tdist.make_spec_plan({"n": ()}, "dp", mesh=pmesh).model_axes == ()
    with pytest.raises(ValueError, match="data axis"):
        tdist.make_spec_plan(specs, "dp", model_axes=("ep",), mesh=pmesh)
    with pytest.raises(ValueError, match="data axis"):
        tdist.DistributedGradientTransform(
            precision.adamw_lp(1e-3), sharded_update=True,
            param_specs=specs, mesh=pmesh)


def test_flat_collectives_over_one_rank_are_the_identity():
    """The group of a size-1 mesh axis is this rank alone: the flat
    reduce-scatter and all-gather over it return a copy of their input,
    so the spec plan's call sites need no branch for it."""
    from horovod_tpu_torch import runtime
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    solo = tdist._axis_group(ParallelMesh(MeshConfig(dp=1), devices=["cpu"]),
                             "dp")
    assert isinstance(solo, runtime.SubGroup) and solo.size() == 1
    assert solo.rank() == 0
    x = torch.arange(6.0)
    for fn in (collectives.reduce_scatter_flat, collectives.all_gather_flat):
        y = fn(x, solo)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_with_param_specs_is_scoped_and_read_by_the_transform():
    """tests/test_fsdp_compose.py:182-208 and 366-376: specs attached with
    ``with_param_specs`` clear on the block's exit (assigned ones stay),
    and a transform built inside the block takes them (a data-axis spec
    under sharded_update then raises, as in JAX)."""
    from horovod_tpu_torch.optim import precision
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    pmesh = ParallelMesh(MeshConfig(), devices=["cpu"])
    with pmesh.with_param_specs({"w": ("tp",)}):
        assert mesh_mod.current_mesh() is pmesh
        assert pmesh.param_specs is not None
    assert pmesh.param_specs is None and mesh_mod.current_mesh() is None
    pmesh.param_specs = {"w": ("tp",)}      # the lasting form
    with pmesh:
        pass
    assert pmesh.param_specs is not None
    pmesh.param_specs = None
    with pmesh.with_param_specs({"w": ("dp",)}):
        with pytest.raises(ValueError, match="data axis"):
            tdist.DistributedGradientTransform(precision.adamw_lp(1e-3),
                                               sharded_update=True)


def test_spec_buckets_reduce_over_the_right_axes():
    """tests/test_fsdp_compose.py:182-208's jaxpr check, as the port's
    plan: a model-sharded bucket reduces over the data axis alone, a
    replicated one over data and model (JAX's two psums)."""
    jplan = jdist.make_spec_plan({"w": P(MODEL), "n": P()}, DATA)
    tplan = tdist.make_spec_plan({"w": (MODEL,), "n": ()}, DATA)
    jaxpr = str(jax.make_jaxpr(
        lambda g: jdist.fused_reduce_tree(g, DATA, op="average",
                                          threshold_bytes=1 << 20,
                                          spec_plan=jplan),
        axis_env=[(DATA, 2), (MODEL, 2)])(
        {"w": jax.ShapeDtypeStruct((4, 4), jnp.float32),
         "n": jax.ShapeDtypeStruct((3,), jnp.float32)}))
    assert f"axes=('{DATA}',)" in jaxpr
    sigs_axes = {tplan.reduce_axes(s) for s in tplan.by_name.values()}
    assert sigs_axes == {(DATA,), (DATA, MODEL)}
    assert ((f"axes=('{DATA}', '{MODEL}')" in jaxpr)
            or (f"axes=('{MODEL}', '{DATA}')" in jaxpr))


def test_overlap_tap_specs_and_their_collision_check():
    """tests/test_fsdp_compose.py:341-364: the taps' names map to the
    leaves' specs; the port's layers are separate leaves, so a layer
    leaf's spec is the layer dict's own (JAX shifts its stacked leaf's
    down a dim: the same string), and a root leaf and a layer leaf with
    one name but different specs raise."""
    from horovod_tpu.optim import overlap as jov
    from horovod_tpu_torch.optim import overlap as tov
    jsp = jdist.make_spec_plan(
        {"embed": P(), "layers": {"w": P(None, MODEL), "b": P()}}, DATA,
        (MODEL,))
    tsp = tdist.make_spec_plan(
        {"embed": (), "layers": [{"w": (MODEL,), "b": ()},
                                 {"w": (MODEL,), "b": ()}]}, DATA, (MODEL,))
    jplan = jov.OverlapPlan(axis_name=DATA, op="average",
                            threshold_bytes=None, prescale=1.0,
                            postscale=1.0, sharded=False, fmt=None, k=1,
                            spec_plan=jsp)
    tplan = tov.OverlapPlan(process_set=None, op="average",
                            threshold_bytes=None, prescale=1.0,
                            postscale=1.0, sharded=False, fmt=None, k=1,
                            spec_plan=tsp)
    jt, tt = jplan.tap_specs(), tplan.tap_specs()
    assert tt == {"embed": "replicated", "w": f"0:{MODEL}",
                  "b": "replicated"}
    assert jt["['w']"] == tt["w"] and jt["['embed']"] == tt["embed"]
    bad = tdist.make_spec_plan({"w": (MODEL,), "layers": [{"w": (None,)}]},
                               DATA, (MODEL,))
    tplan.spec_plan = bad
    with pytest.raises(ValueError, match="ambiguous"):
        tplan.tap_specs()


# ---------------------------------------------------------------------------
# the tp Llama through the spec plan
# ---------------------------------------------------------------------------

def test_tp_llama_through_the_spec_plan_matches_one_process(tmp_path):
    """The tiny fp32 Llama over dp 2 x tp 2 (``case_spec_llama``), SGD
    through the spec-aware transform with ``llama.param_specs`` on the
    gradients as the model gives them, against one process's train step
    on the whole batch.  With ``model_axes=()`` (the tp ranks share one
    loss: tp is no batch axis) 3 steps are equal within fp32 reordering
    and every byte crosses dp alone.  With tp inferred as a model axis
    the contract counts the tp ranks as batch shards: one step moves
    every tp-sharded leaf exactly half as far and every replicated leaf
    as far (its sum over tp and the tp in the divisor cancel), a factor
    SGD shows where AdamW's normalized step would hide it."""
    import functools
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    ranks = tr.launch(4, ["spec_llama"], tmp_path)
    cfg = llama.tiny()
    ts = training.make_llama_train_step(
        cfg, optimizer=functools.partial(torch.optim.SGD,
                                         lr=tr.SPEC_LLAMA_LR),
        device="cpu")
    params, opt = ts.init_fn(0)

    def flat():
        return {p: t.detach().numpy().copy() for p, t in
                zip(tree_paths(params), tree_leaves(params))}

    init = flat()
    toks, tgts = (torch.from_numpy(x) for x in tr.spec_llama_batch())
    after = []
    for _ in range(tr.SPEC_LLAMA_STEPS):
        params, opt, _loss = ts.step_fn(params, opt, toks, tgts)
        after.append(flat())
    specs = llama.param_specs(
        llama.ParallelSpec(tp_axis="tp", dp_axis="dp"), cfg)
    halves = 0
    for res in ranks:
        got = res["spec_llama"]
        assert list(got["dp_only"]["bytes"]) == ["dp.all_reduce"]
        assert "tp.all_reduce" in got["inferred"]["bytes"]
        for p, w in after[-1].items():
            np.testing.assert_allclose(got["dp_only"]["params"][p], w,
                                       rtol=1e-5, atol=1e-6, err_msg=p)
            half = "tp" in llama.leaf_spec(specs, p)
            np.testing.assert_allclose(
                got["inferred"]["params"][p] - init[p],
                (after[0][p] - init[p]) * (0.5 if half else 1.0),
                rtol=1e-4, atol=1e-7, err_msg=p)
            halves += half
    assert halves == 4 * 2 * 7     # 7 tp-sharded leaves a layer
