"""The port's DistributedGradientTransform against the JAX package's.

2 and 4 real rank processes over gloo (tests/torch_ranks.py
``case_distopt``) run 4 steps of the transform on the JAX package's own
ZeRO and wire test inputs (tests/test_zero.py, tests/test_compression.py:
leaves of 35 and 3 elements, a 64-byte fusion threshold, 16-element scale
blocks, so every bucket pads), each rank with its own gradients, for each
of ``torch_ranks.DISTOPT_CONFIGS``: replicated, ``sharded_update``,
``backward_passes_per_step=2``, both, int8 with error feedback (alone,
sharded, with k=2) and fp8 e4m3.  The JAX reference is its
``DistributedOptimizer`` under ``pmap`` on as many virtual CPU devices with
the same options, and both sides run ``adamw_lp(1e-2)`` with fp32 moments.

Tolerances: every rank ends every step with bit-identical parameters (the
same reduced values are applied everywhere).  Against JAX, 2e-6 absolute
on parameters of magnitude <= 2 after 4 steps of lr 1e-2: the port's
AdamWLP and optax round differently in the last place (the training test
holds them at the same level), and the wire's quantization is the same
math on both sides (tests/test_torch_wire.py).  Sharded against
replicated in the port itself: the same, since each tile runs the same
elementwise update.  Per-rank state bytes under ``sharded_update`` are
exactly the padded tiles' (2 moments x 4 bytes), 1/N of the buckets.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import config as jconfig
from horovod_tpu.optim import precision as jprecision
from horovod_tpu.optim.distributed import \
    DistributedOptimizer as JDistributedOptimizer
import horovod_tpu_torch as hvd
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch.ops.fusion import pad_to_multiple
from horovod_tpu_torch.optim import distributed as tdist

import torch_ranks as tr

AXIS = "zw"
WORLDS = (2, 4)
ATOL = 2e-6


class _Worlds(dict):
    def __init__(self, tmp_path_factory):
        super().__init__()
        self._tmp = tmp_path_factory

    def __missing__(self, world):
        self[world] = tr.launch(world, ["distopt"],
                                self._tmp.mktemp(f"distopt{world}"))
        return self[world]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def jax_traj(n, kw):
    """The parameters after each of 4 steps of the JAX transform."""
    inner = jprecision.adamw_lp(tr.ZLR, mu_dtype=jnp.float32,
                                nu_dtype=jnp.float32)
    kw = dict({"wire_format": "none", "wire_block_size": tr.ZBLOCK}, **kw)
    opt = JDistributedOptimizer(inner, axis_name=AXIS,
                                threshold_bytes=tr.ZTHRESHOLD, **kw)
    devs = jax.devices()[:n]
    params = tr.zparams()
    st = jax.pmap(lambda p, _: opt.init(p), axis_name=AXIS,
                  in_axes=(None, 0), devices=devs)(params, np.zeros(n))

    def step(p, s, g):
        u, ns = opt.update(g, s, p)
        return optax.apply_updates(p, u), ns

    f = jax.pmap(step, axis_name=AXIS, in_axes=(None, 0, 0), devices=devs)
    traj = []
    for i in range(4):
        g = {k: np.stack([tr.zgrads(r, i)[k] for r in range(n)])
             for k in params}
        pstack, st = f(params, st, g)
        params = {k: np.asarray(v[0]) for k, v in pstack.items()}
        traj.append(params)
    return traj


@pytest.mark.parametrize("name", sorted(tr.DISTOPT_CONFIGS))
@pytest.mark.parametrize("world", WORLDS)
def test_transform_matches_jax(ranks, world, name):
    want = jax_traj(world, tr.DISTOPT_CONFIGS[name])
    runs = [r["distopt"][name] for r in ranks[world]]
    for step, w in enumerate(want):
        for key, wv in w.items():
            for r in range(1, world):
                np.testing.assert_array_equal(
                    runs[r]["traj"][step][key], runs[0]["traj"][step][key])
            np.testing.assert_allclose(runs[0]["traj"][step][key], wv,
                                       rtol=0, atol=ATOL,
                                       err_msg=f"step {step} {key}")
    # k=2 accumulates: its first step leaves the parameters alone
    if "k2" in name:
        for key, v in tr.zparams().items():
            np.testing.assert_array_equal(runs[0]["traj"][0][key], v)
    assert runs[0]["residual"] == (name.startswith(("int8", "fp8")))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_replicated_and_state_is_one_over_n(ranks, world):
    got = ranks[world][0]["distopt"]
    for a, b in (("sharded", "replicated"), ("sharded_k2", "k2")):
        for key in tr.zparams():
            np.testing.assert_allclose(got[a]["traj"][-1][key],
                                       got[b]["traj"][-1][key], rtol=0,
                                       atol=ATOL)
    # two buckets (35 and 3 elements), each padded to a multiple of the
    # world; two fp32 moments per tile element
    tiles = sum(pad_to_multiple(n, world) // world for n in (35, 3))
    assert got["sharded"]["state_bytes"] == 2 * 4 * tiles
    assert got["replicated"]["state_bytes"] == 2 * 4 * (35 + 3)
    # int8 tiles are block-aligned: padded to world x 16 elements
    q_tiles = sum(pad_to_multiple(n, world * tr.ZBLOCK) // world
                  for n in (35, 3))
    assert got["int8_sharded"]["state_bytes"] == 2 * 4 * q_tiles


def test_sharded_tile_layout_prices_the_state():
    tree = {"a": torch.empty((7, 5), device="meta"),
            "b": torch.empty((3,), device="meta")}
    layout = tdist.sharded_tile_layout(tree, 4, threshold_bytes=64)
    assert [bl.numel for bl in layout.buckets] == [35, 3]
    assert [bl.shard_numel for bl in layout.buckets] == [9, 1]
    aligned = tdist.sharded_tile_layout(tree, 4, threshold_bytes=64,
                                        align=16)
    assert [bl.shard_numel for bl in aligned.buckets] == [16, 16]


def test_transform_options_and_refusals():
    hvd.init(device="cpu")
    try:
        make = tr._fp32_adamw_lp(1e-2)
        # the health taps compose as in the JAX package: not with overlap,
        # and a cadence of at least 1
        with pytest.raises(ValueError, match="health=True is not "
                                             "supported with overlap"):
            hvd.DistributedGradientTransform(make, health=True,
                                             overlap=True)
        with pytest.raises(ValueError, match="health_check_every must be"):
            hvd.DistributedGradientTransform(make, health=True,
                                             health_check_every=0)
        # the spec plan at world 1 (a mesh of one rank): every axis has
        # size 1, so the spec-aware transform steps the parameters as the
        # plain one does, bit for bit
        from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
        pmesh = ParallelMesh(MeshConfig())
        specs = {k: ("tp",) + (None,) * (np.asarray(v).ndim - 1)
                 if np.asarray(v).ndim else ()
                 for k, v in tr.zparams().items()}
        got = {}
        for name, kw in (("plain", {}), ("spec", {"param_specs": specs,
                                                  "mesh": pmesh})):
            tx = hvd.DistributedGradientTransform(
                make, wire_format="none", threshold_bytes=64, **kw)
            params = {k: tr._t(v) for k, v in tr.zparams().items()}
            state = tx.init(params)
            for step in range(2):
                tx.update({k: tr._t(v) for k, v in
                           tr.zgrads(0, step).items()}, state, params)
            got[name] = params
        assert all(torch.equal(got["plain"][k], got["spec"][k])
                   for k in got["plain"])
        with pytest.raises(ValueError, match="requires a ParallelMesh"):
            hvd.DistributedGradientTransform(make, param_specs=specs)
        # recovery is ported (tests/test_torch_recovery.py): any object
        # with an ``every`` arms the tap, and overlap refuses it as in JAX
        hvd.DistributedGradientTransform(make, recovery=object())
        with pytest.raises(ValueError, match="overlap=True"):
            hvd.DistributedGradientTransform(make, recovery=object(),
                                             overlap=True)
        # Adasum at one rank reduces to the gradient itself
        params = {k: tr._t(v) for k, v in tr.zparams().items()}
        tx = hvd.DistributedGradientTransform(make, op=hvd.Adasum,
                                              wire_format="none")
        grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
        assert all(torch.equal(a, b) for a, b in zip(
            tx.reduce(grads, tx.init(params)), grads.values()))
        with pytest.raises(ValueError, match="factory"):
            hvd.DistributedGradientTransform(None)
        with pytest.raises(ValueError, match="two definitions"):
            hvd.DistributedGradientTransform(
                make, wire_format="int8", compression=hvd.Compression.fp16)
        with pytest.raises(ValueError, match="Average/Sum"):
            hvd.DistributedGradientTransform(make, op=hvd.Max,
                                             sharded_update=True)
        with pytest.raises(ValueError, match="cast compressor"):
            hvd.DistributedGradientTransform(
                make, overlap=True, wire_format="none",
                compression=hvd.Compression.fp16)
        # the cast compressor rides the full-width buckets
        tx = hvd.DistributedGradientTransform(
            make, compression=hvd.Compression.bf16, wire_format="none")
        params = {k: tr._t(v) for k, v in tr.zparams().items()}
        state = tx.init(params)
        tx.update({k: torch.ones_like(v) for k, v in params.items()},
                  state, params)
        assert not torch.equal(params["a"], tr._t(tr.zparams()["a"]))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("env,values", [
    ("HOROVOD_COMPRESSION", ["int8", "FP8_E4M3", " fp8_e5m2 ", "none",
                             "", "int4"]),
    ("HOROVOD_COMPRESSION_BLOCK_SIZE", ["64", "0", "x"]),
    ("HOROVOD_SHARDED_UPDATE", ["1", "true", "0", "no"]),
    ("HOROVOD_OVERLAP", ["1", "on", "0", ""]),
])
def test_a5_knobs_parse_as_in_jax(monkeypatch, env, values):
    """The knobs this slice ports are no longer refused, and parse and
    validate as the JAX package's config does (the same values, the same
    errors)."""
    import os
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    for v in values:
        monkeypatch.setenv(env, v)
        try:
            want = dataclasses.asdict(jconfig.Config.from_env())
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tconfig.Config.from_env()
            continue
        assert dataclasses.asdict(tconfig.Config.from_env()) == want, v
    assert env not in {u[0] for u in tconfig.UNPORTED}
