"""Parity of the port's GPipe loop (``parallel/pipeline.py``) with the
JAX package's ``pipeline_apply`` and with the stages run one after
another (tests/test_parallel.py ``test_pipeline_matches_sequential``).

Rank processes (tests/torch_ranks.py ``pipeline``, gloo on the CPU) run
pp = 2 and pp = 4 stages of tanh(x @ w + b), one stage a rank, on 6
microbatches; the JAX side runs the same stages under ``shard_map`` on as
many virtual CPU devices.  Tolerance: tests/test_parallel.py's atol 1e-5
on the outputs and the aux, 1e-4 on the gradients of the last stage's
loss, as the training step takes it (held against autograd through the
sequential stages: on each rank the stage's own weights, and over the
ranks the sum of the microbatches' gradients, which only stage 0
feeds).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch_ranks
from horovod_tpu.parallel.pipeline import pipeline_apply as jpipeline

OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return torch_ranks.Worlds(tmp_path_factory, ["pipeline"])


def _jax(world, with_aux):
    w, b, x, _ = torch_ranks.pipeline_inputs(world)
    mesh = Mesh(np.array(jax.devices()[:world]), ("pp",))

    def stage(p, xb):
        y = jnp.tanh(xb @ p["w"][0] + p["b"][0])
        return (y, y.sum()) if with_aux else y

    f = jax.jit(jax.shard_map(
        lambda p, x: jpipeline(stage, p, x, "pp", with_aux=with_aux),
        mesh=mesh, in_specs=({"w": P("pp"), "b": P("pp")}, P()),
        out_specs=(P(), P()) if with_aux else P(), check_vma=False))
    return f({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))


def _sequential(world, with_aux):
    """Autograd through the stages in order: out, aux, and the gradients
    of sum(out · cotangent) (+ aux)."""
    w, b, x, cot = (torch.from_numpy(a) for a in
                    torch_ranks.pipeline_inputs(world))
    w.requires_grad_(), b.requires_grad_(), x.requires_grad_()
    h, aux = x, 0.0
    for s in range(world):
        h = torch.tanh(h @ w[s] + b[s])
        aux = aux + h.sum()
    loss = (h * cot).sum() + (aux / x.shape[0] if with_aux else 0.0)
    loss.backward()
    return (h.detach().numpy(), float(aux.detach()) / x.shape[0], w.grad.numpy(),
            b.grad.numpy(), x.grad.numpy())


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_matches_jax_and_sequential(worlds, world, with_aux):
    ranks = [r["pipeline"][f"aux={with_aux}"] for r in worlds[world]]
    out, aux, dw, db, dx = _sequential(world, with_aux)
    want = _jax(world, with_aux)
    jout = np.asarray(want[0] if with_aux else want)
    np.testing.assert_allclose(jout, out, rtol=0, atol=OUT_ATOL)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["out"], jout, rtol=0, atol=OUT_ATOL)
        np.testing.assert_array_equal(res["out"], ranks[0]["out"])
        np.testing.assert_allclose(res["dw"], dw[r], rtol=0, atol=GRAD_ATOL)
        np.testing.assert_allclose(res["db"], db[r], rtol=0, atol=GRAD_ATOL)
        if with_aux:
            assert abs(res["aux"] - float(want[1])) <= OUT_ATOL
            assert abs(res["aux"] - aux) <= OUT_ATOL
    np.testing.assert_allclose(sum(r["dx"] for r in ranks), dx, rtol=0,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_computes_live_ticks_and_joins_every_hop(worlds, world):
    """A stage runs its function once a microbatch (fill and drain ticks
    pass their input on); for each of the n_micro + n_stages - 2 hops
    the loop makes, every rank but the last sends one [2, 4] fp32
    microbatch forward and every rank but the first one cotangent back,
    the masked output sum moves [6, 2, 4] over pp, and the backward runs
    without a hang (this test's launch returned)."""
    n_micro = 6
    for r, res in enumerate(r["pipeline"]["aux=False"]
                            for r in worlds[world]):
        assert res["calls"] == n_micro
        hops = n_micro + world - 2
        sent = hops * 2 * 4 * 4 * ((r < world - 1) + (r > 0))
        assert res["bytes"].get("pp.ppermute", 0) == sent
        assert res["bytes"]["pp.all_reduce"] == n_micro * 2 * 4 * 4
