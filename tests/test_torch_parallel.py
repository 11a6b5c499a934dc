"""Parity of the port's parallel layer with the JAX package's: the mesh,
ring attention over sp, Ulysses, and the in-step ``*_p`` collectives.

Rank processes (tests/torch_ranks.py, gloo on the CPU) run the port at
worlds 2 and 4 in one launch each; the JAX side runs the same functions
under ``shard_map`` on as many of the virtual CPU devices, from the same
numpy inputs.  The ring and Ulysses are compared forward and backward:
each rank differentiates sum(out · cotangent) over its own block, as
tests/test_parallel.py differentiates its local loss.

Tolerances: fp32 on both sides, the same arithmetic in another order:
outputs atol 1e-5 and gradients atol 1e-4, tests/test_parallel.py's.  The
ring's flash cases take the port's tiles through flash_attention_lse
(their plain versions on the CPU, the gate opened to fp32) and merge them
by their lse, where the JAX ring on the CPU takes its blockwise path: the
same exact attention, so the same tolerances.  The bf16 case goes the
port's natural kernel path on bf16 inputs against JAX's fp32 ring of the
same (bf16-rounded) values: both the port's plain kernels and its merge
round to bf16 (out, P and dS), so it is held to 2e-2 of each result's
largest entry.  The ``*_p`` forms move multiples of 1/4 and are exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch_ranks
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel.ring_attention import ring_attention as jring
from horovod_tpu.parallel.ulysses import ulysses_attention as julysses
from horovod_tpu_torch.parallel import mesh as tmesh

CASES = ["mesh", "ring", "ulysses", "p_forms"]
OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4
BF16_REL = 2e-2


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return torch_ranks.Worlds(tmp_path_factory, CASES)


def _mesh(n, name="sp"):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _jax_attend(fn, arrays, n):
    """JAX's out and the gradients of each shard's sum(out · cotangent)."""
    def local(q, k, v, dout):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v), q, k, v)
        return (out,) + vjp(dout.astype(out.dtype))

    f = jax.jit(jax.shard_map(local, mesh=_mesh(n),
                              in_specs=(P(None, "sp"),) * 4,
                              out_specs=(P(None, "sp"),) * 4,
                              check_vma=False))
    return [np.asarray(x, np.float32)
            for x in f(*(jnp.asarray(a) for a in arrays))]


def _assemble(ranks, case, key):
    """The ranks' sequence blocks of one result, in rank order."""
    return np.concatenate([r[key] for r in ranks], axis=1)


def _check(ranks, case, want, rel=None):
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        got = _assemble(ranks, case, key)
        atol = (rel * np.abs(w).max() if rel is not None
                else OUT_ATOL if key == "out" else GRAD_ATOL)
        np.testing.assert_allclose(got, w, rtol=0, atol=atol,
                                   err_msg=f"{case} {key}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(torch_ranks.RING_CASES))
def test_ring_attention_matches_jax(worlds, world, case):
    B, T, H, Hkv, D, causal, dtype, flash = torch_ranks.RING_CASES[case]
    i = list(torch_ranks.RING_CASES).index(case)
    arrays = torch_ranks.attn_inputs(B, T, H, Hkv, D, seed=20 + i)
    if dtype == "bfloat16":
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                  for a in arrays]
    want = _jax_attend(
        lambda q, k, v: jring(q, k, v, "sp", causal=causal), arrays, world)
    ranks = [r["ring"][case] for r in worlds[world]]
    _check(ranks, case, want,
           rel=BF16_REL if dtype == "bfloat16" else None)
    if flash or dtype == "bfloat16":
        # the ring's schedule: rank i runs a causal diagonal tile and, for
        # causal attention, i past tiles, skipping the future ones
        for rank, r in enumerate(ranks):
            assert r["tiles"] == (rank + 1 if causal else world), r
            assert r["causal_tiles"] == (1 if causal else 0), r


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["grouped", "repeated", "refused"])
def test_ulysses_matches_jax(worlds, world, case):
    shape = torch_ranks.ULYSSES_CASES[world][case]
    i = list(torch_ranks.ULYSSES_CASES[world]).index(case)
    ranks = [r["ulysses"][case] for r in worlds[world]]
    if case == "refused":
        for r in ranks:
            assert "not divisible by sp" in r["error"], r
        with pytest.raises(ValueError, match="not divisible"):
            _jax_attend(lambda q, k, v: julysses(q, k, v, "sp"),
                        torch_ranks.attn_inputs(*shape, seed=40 + i), world)
        return
    want = _jax_attend(lambda q, k, v: julysses(q, k, v, "sp"),
                       torch_ranks.attn_inputs(*shape, seed=40 + i), world)
    _check(ranks, case, want)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_coordinates_match_jax_device_reshape(worlds, world):
    """A rank's coordinates and each axis's group are those of device
    ``rank`` in the JAX mesh's ``np.array(devices).reshape(shape)``; ep
    without a dedicated axis is dp's coordinate."""
    results = worlds[world]
    for m, axes in enumerate(torch_ranks.MESHES[world]):
        jm = jmesh.ParallelMesh(jmesh.MeshConfig(**axes),
                                devices=jax.devices()[:world])
        ids = np.vectorize(lambda d: d.id)(jm.mesh.devices)
        assert list(jm.axis_names) == results[0]["mesh"]["meshes"][m][
            "names"]
        for rank, res in enumerate(results):
            got = res["mesh"]["meshes"][m]
            pos = tuple(int(c[0]) for c in np.nonzero(ids == rank))
            assert [got["coords"][a] for a in jm.axis_names] == list(pos)
            assert got["ep_index"] == got["coords"][jm.ep_axis]
            for i, a in enumerate(jm.axis_names):
                line = ids[pos[:i] + (slice(None),) + pos[i + 1:]]
                want = [int(x) for x in line] if len(line) > 1 else None
                assert got["groups"][a] == want, (axes, rank, a)
    assert results[0]["mesh"]["make_mesh_dp"] == world // 2
    # hvd.shutdown() drops the meshes' groups: the runtime forms again on
    # the same port, a new mesh reduces, the old one refuses its groups
    for res in results:
        assert res["mesh"]["psum_after_reinit"] == world * (world + 1) / 2
        assert "has shut down" in res["mesh"]["stale_group"]


def test_factor_mesh_and_config_match_jax():
    for n in (1, 2, 4, 6, 8, 16, 24):
        for want_pp in (True, False):
            j = jmesh.factor_mesh(n, want_pp)
            t = tmesh.factor_mesh(n, want_pp)
            assert (t.dp, t.pp, t.sp, t.tp, t.ep) == (j.dp, j.pp, j.sp,
                                                      j.tp, j.ep)
    for kw in ({}, {"ep": 2}, {"dp": 2, "tp": 4}):
        assert (tmesh.MeshConfig(**kw).axis_sizes()
                == jmesh.MeshConfig(**kw).axis_sizes())
        assert (tmesh.MeshConfig(**kw).n_devices
                == jmesh.MeshConfig(**kw).n_devices)
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.AXIS_ORDER_EP == jmesh.AXIS_ORDER_EP


def _jax_p(world, fn, x_of_rank, check_vma=False):
    """``fn`` on each device of a 1-D mesh ``("dp",)``, its input
    ``x_of_rank(rank)``; returns each device's result."""
    xs = np.stack([x_of_rank(r) for r in range(world)])
    f = jax.jit(jax.shard_map(lambda x: fn(x[0])[None], mesh=_mesh(world,
                                                                   "dp"),
                              in_specs=P("dp"), out_specs=P("dp"),
                              check_vma=check_vma))
    return np.asarray(f(jnp.asarray(xs)))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_p_forms_match_jax(worlds, world, dtype):
    results = worlds[world]
    ops = ["sum", "average", "min", "max", "product"]
    jfns = {f"allreduce_{op}": (lambda op: lambda x: jcoll.allreduce_p(
        x, "dp", op=op))(op) for op in ops}
    jfns["allgather"] = lambda x: jcoll.allgather_p(x, "dp")
    jfns["allgather_scalar"] = lambda x: jcoll.allgather_p(x[0, 0], "dp")
    jfns["broadcast"] = lambda x: jcoll.broadcast_p(x, 1, "dp")
    jfns["alltoall"] = lambda x: jcoll.alltoall_p(x, "dp")
    jfns["reducescatter_sum"] = lambda x: jcoll.reducescatter_p(
        x, "dp", op="sum")
    if dtype == "float32":
        jfns["reducescatter_average"] = lambda x: jcoll.reducescatter_p(
            x, "dp", op="average")
    assert set(results[0]["p_forms"][dtype]) == set(jfns)
    for key, fn in jfns.items():
        want = _jax_p(world, fn, lambda r: torch_ranks.p_input(dtype, r,
                                                               world))
        for rank, res in enumerate(results):
            got = res["p_forms"][dtype][key]
            np.testing.assert_array_equal(got, want[rank], err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("form", ["allreduce", "reducescatter"])
def test_p_forms_gradients_match_jax(worlds, world, form):
    """The gradients of allreduce_p(Average)·w and of reducescatter_p(Sum)²,
    each rank seeding its own, under check_vma as the JAX train step runs:
    psum's transpose (the identity on an invariant cotangent) and
    psum_scatter's (the tiled all-gather)."""
    w = np.arange(2 * world * 3, dtype=np.float32).reshape(2 * world, 3)
    loss = {"allreduce": lambda x: (jcoll.allreduce_p(x, "dp") * w).sum(),
            "reducescatter": lambda x: (jcoll.reducescatter_p(
                x, "dp", op="sum") ** 2).sum()}[form]
    want = _jax_p(world, jax.grad(loss),
                  lambda r: torch_ranks.p_input("float32", r, world),
                  check_vma=True)
    for rank, res in enumerate(worlds[world]):
        np.testing.assert_allclose(res["p_forms"][f"grad_{form}"],
                                   want[rank], rtol=1e-6, atol=0)
