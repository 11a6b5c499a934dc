"""The port's Adasum against the JAX package's.

* ``ops/adasum.py``: ``_adasum_pair`` and ``adasum_tree`` on seeded fp32
  vectors, a zero vector and parallel ones included, against
  ``horovod_tpu/ops/adasum.py`` (rtol 1e-6: the dot products sum in
  another order in XLA and in torch).
* The eager ``allreduce(op=Adasum)`` (one tensor, scaled, a fused group)
  on 2 and 4 real rank processes over gloo (``tests/torch_ranks.py``
  ``case_adasum``), against the JAX package's all-gather and tree
  (``adasum_p``) under ``shard_map`` on as many virtual devices.
* ``DistributedOptimizer(op=Adasum)``: one SGD step, the reduced gradients
  and the weights against the JAX ``fused_reduce_tree`` over the whole
  vector in ``(dtype, index)`` order (one leaf bf16: within a bf16 step),
  and the refusals with the JAX package's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import adasum as jada
from horovod_tpu.optim import distributed as jdist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum as tada

import torch_ranks as tr

WORLDS = (2, 4)
RTOL = 1e-6
BF16_RTOL = 2.0 ** -7


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.Worlds(tmp_path_factory, ["adasum"])


def _vectors(seed, n=64):
    rng = np.random.RandomState(seed)
    a = rng.randn(n).astype(np.float32)
    return {"random": (a, rng.randn(n).astype(np.float32)),
            "zero_left": (np.zeros(n, np.float32), a),
            "zero_both": (np.zeros(n, np.float32), np.zeros(n, np.float32)),
            "parallel": (a, np.float32(3.0) * a),
            "opposite": (a, -a),
            "orthogonal": (np.eye(n, dtype=np.float32)[0],
                           np.eye(n, dtype=np.float32)[1])}


@pytest.mark.parametrize("case", sorted(_vectors(0)))
def test_adasum_pair_matches_jax(case):
    a, b = _vectors(0)[case]
    want = np.asarray(jada._adasum_pair(jnp.asarray(a), jnp.asarray(b)))
    got = tada._adasum_pair(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_adasum_tree_matches_jax(n):
    rng = np.random.RandomState(n)
    vs = [rng.randn(33).astype(np.float32) for _ in range(n)]
    if n > 2:
        vs[1] = np.zeros(33, np.float32)       # the zero-norm guard
        vs[2] = np.float32(2.0) * vs[0]        # parallel to vs[0]
    want = np.asarray(jada.adasum_tree([jnp.asarray(v) for v in vs]))
    got = tada.adasum_tree([torch.from_numpy(v) for v in vs])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_identity_at_world_one():
    """One rank: Adasum is its input times the scales."""
    hvd.init(device="cpu")
    try:
        x = torch.arange(6.0)
        assert torch.equal(hvd.allreduce(x, op=hvd.Adasum), x)
        assert torch.equal(hvd.allreduce(x, op=hvd.Adasum,
                                         prescale_factor=2.0,
                                         postscale_factor=0.5), x)
        y = x.clone()
        assert hvd.allreduce_(y, op=hvd.Adasum) is y and torch.equal(y, x)
    finally:
        hvd.shutdown()


def jax_adasum(xs, pre=None, post=None):
    n = len(xs)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("w",))

    def f(x):
        v = x[0]
        if pre is not None:
            v = v * jnp.float32(pre)
        r = jada.adasum_p(v, "w")
        if post is not None:
            r = r * jnp.float32(post)
        return r[None]

    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("w"),
                              out_specs=P("w"), check_vma=False))
    return np.asarray(g(jnp.asarray(np.stack(xs))))


@pytest.mark.parametrize("world", WORLDS)
def test_eager_adasum_matches_jax(ranks, world):
    xs = [tr.adasum_input(r) for r in range(world)]
    want = jax_adasum(xs)
    scaled = jax_adasum(xs, 0.5, 3.0)
    for r, res in enumerate(ranks[world]):
        got = res["adasum"]
        np.testing.assert_allclose(got["eager"], want[r], rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(got["scaled"], scaled[r], rtol=RTOL,
                                   atol=1e-6)
        # a grouped allreduce is one bucket: Adasum of the fused vector
        np.testing.assert_allclose(
            np.concatenate([got["grp0"], got["grp1"]]), want[r], rtol=RTOL,
            atol=1e-6)
        # every rank ran the same tree on the same gathered rows
        np.testing.assert_array_equal(got["eager"],
                                      ranks[world][0]["adasum"]["eager"])


def jax_fused_tree(world):
    """The JAX ``fused_reduce_tree(op=Adasum)`` of every rank's
    :func:`tr.adasum_grads` (``c`` in bf16, as the port's parameter)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("w",))
    grads = [tr.adasum_grads(r) for r in range(world)]
    stacked = {k: jnp.asarray(np.stack([g[k] for g in grads]))
               for k in grads[0]}
    stacked["c"] = stacked["c"].astype(jnp.bfloat16)

    def f(g):
        red = jdist.fused_reduce_tree({k: v[0] for k, v in g.items()}, "w",
                                      op=jhvd.Adasum)
        return {k: v[None] for k, v in red.items()}

    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("w"),
                              out_specs=P("w"), check_vma=False))
    return {k: np.asarray(v, np.float32) for k, v in g(stacked).items()}


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_optimizer_adasum_matches_jax(ranks, world):
    want = jax_fused_tree(world)
    params = tr.adasum_params()
    for r, res in enumerate(ranks[world]):
        got = res["adasum"]
        for k in ("a", "b"):
            np.testing.assert_allclose(got["reduced"][k], want[k][r],
                                       rtol=RTOL, atol=1e-6)
            np.testing.assert_allclose(
                got["params"][k], params[k] - np.float32(tr.ZLR)
                * want[k][r], rtol=RTOL, atol=1e-6)
        # the bf16 leaf: the same vector, rounded to bf16 on the port's side
        np.testing.assert_allclose(got["reduced"]["c"], want["c"][r],
                                   rtol=BF16_RTOL, atol=1e-3)
        np.testing.assert_allclose(
            got["params"]["c"], params["c"] - tr.ZLR * want["c"][r],
            rtol=BF16_RTOL, atol=1e-2)


def _jax_refusals():
    """The JAX package's messages for the same requests."""
    out = {}
    g = {"a": jnp.zeros((4,))}
    for what, make in (
            ("wire", lambda: jdist.DistributedGradientTransform(
                jax.numpy.zeros, op=jhvd.Adasum, axis_name="w",
                wire_format="int8")),
            ("sharded", lambda: jdist.DistributedGradientTransform(
                jax.numpy.zeros, op=jhvd.Adasum, axis_name="w",
                sharded_update=True)),
            ("overlap", lambda: jdist.DistributedGradientTransform(
                jax.numpy.zeros, op=jhvd.Adasum, axis_name="w",
                overlap=True)),
            ("tree_wire", lambda: jdist.fused_reduce_tree(
                g, "w", op=jhvd.Adasum, wire_format="int8")),
            ("tree_compression", lambda: jdist.fused_reduce_tree(
                g, "w", op=jhvd.Adasum,
                compression=jhvd.Compression.fp16)),
            ("scatter", lambda: jdist.fused_reduce_scatter_tree(
                g, "w", op=jhvd.Adasum))):
        try:
            make()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


def test_refusals_carry_the_jax_messages(ranks):
    want = _jax_refusals()
    got = ranks[2][0]["adasum"]["refusals"]
    assert set(got) == set(want)
    for what in want:
        assert want[what] is not None, what
        assert got[what] == want[what], what
