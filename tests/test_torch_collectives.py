"""Parity of the port's eager collectives with the JAX package's, per rank.

The port runs 2 and 4 real rank processes over gloo (tests/torch_ranks.py,
one launch per world size); each rank passes its own tensor, made from a
numpy seed.  The JAX reference is computed here on the virtual CPU devices:
the same per-rank inputs stacked by ``worker_values`` over a process set of
that size, and worker ``r``'s share of the result taken as rank ``r``'s
expectation.  Every op runs on fp32, fp64, int32, int64 and bf16.

Tolerance: none.  The inputs are multiples of 1/4 below 4 in magnitude (or
small integers), so every sum, the averages over 2 and 4 ranks and the
scale factors 0.5, 4, 2 and 3 are exact in every dtype, whatever the order
of summation.  The uneven allgather has no stacked form in the JAX package
(``worker_values`` stacks equal shapes), so it is held against the
Allgatherv contract, the ranks' rows concatenated in rank order.

Also here: the engine fuses 64 small tensors into fewer buckets, the object
collectives, ``DistributedOptimizer`` over 2 ranks against one process on
the full batch and its options at a world of one in this process, and the
API surface against the JAX package's torch ``__all__``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_torch
import torch_ranks as tr

WORLDS = (2, 4)


class _Worlds(dict):
    """One launch per world size, on the first test that reads it: a
    failed launch of one world leaves the other world's tests alone."""

    def __init__(self, tmp_path_factory):
        super().__init__()
        self._tmp = tmp_path_factory

    def __missing__(self, world):
        cases = ["collectives", "process_set", "join"]
        if world == 2:
            cases.append("optimizer")
        self[world] = tr.launch(world, cases, self._tmp.mktemp(f"w{world}"))
        return self[world]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def _np32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def jax_expected(jhvd, world, dt):
    """{op: [rank 0's expected result, rank 1's, ...]} from the JAX
    package's eager collectives over a process set of ``world`` workers."""
    ps = jhvd.add_process_set(list(range(world)))
    jdt = jnp.bfloat16 if dt == "bfloat16" else np.dtype(dt)
    try:
        with jax.enable_x64(dt in ("float64", "int64")):
            def wv(shape=(4, 6)):
                return jhvd.worker_values(
                    lambda r: tr.base(dt, r, shape).astype(jdt), ps)

            def same(res):
                return [_np32(res)] * world

            def per_worker(res):
                return [_np32(res[r]) for r in range(world)]

            x = wv()
            op, pre, post = tr.scales(dt)
            exp = {
                "sum": same(jhvd.allreduce(x, op=jhvd.Sum, process_set=ps)),
                "min": same(jhvd.allreduce(x, op=jhvd.Min, process_set=ps)),
                "max": same(jhvd.allreduce(x, op=jhvd.Max, process_set=ps)),
                "scaled": same(jhvd.allreduce(
                    x, op=op, prescale_factor=pre, postscale_factor=post,
                    process_set=ps)),
                "ag": same(jhvd.allgather(x, process_set=ps)),
                "bc": same(jhvd.broadcast(x, 1, process_set=ps)),
                "a2a": per_worker(jhvd.alltoall(wv((2 * world, 3)),
                                                process_set=ps)),
                "a2av": per_worker(jhvd.alltoall(
                    wv((sum(tr.a2a_splits(world)), 3)),
                    splits=tr.a2a_splits(world), process_set=ps)),
                "rs": per_worker(jhvd.reducescatter(
                    wv((2 * world, 3)), op=jhvd.Sum, process_set=ps)),
            }
            if dt in tr.FLOATS:
                exp["avg"] = same(jhvd.allreduce(x, process_set=ps))
                exp["rs_avg"] = per_worker(jhvd.reducescatter(
                    wv((2 * world, 3)), process_set=ps))
            g0, g1 = jhvd.grouped_allreduce([x, x[:, :2] * 2], op=jhvd.Sum,
                                            process_set=ps)
            exp["grouped0"], exp["grouped1"] = same(g0), same(g1)
    finally:
        jhvd.remove_process_set(ps)
    for k in ("async", "inplace"):
        exp[k] = exp["sum"]
    exp["bc_inplace"] = exp["bc"]
    # Allgatherv: no stacked form in the JAX package (see module docstring)
    exp["agv"] = [np.concatenate(
        [tr.base(dt, r, (tr.ag_rows(r), 3)) for r in range(world)])] * world
    return exp


@pytest.mark.parametrize("dt", tr.DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_collectives_match_jax_per_rank(hvd, ranks, world, dt):
    exp = jax_expected(hvd, world, dt)
    for r, res in enumerate(ranks[world]):
        got = res["collectives"]
        assert {k.split(".", 1)[1] for k in got if k.startswith(dt + ".")} \
            == set(exp)
        for op, want in exp.items():
            g = got[f"{dt}.{op}"]
            w = want[r].astype(g.dtype)
            assert g.shape == w.shape, (r, op)
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {op}")


@pytest.mark.parametrize("world", WORLDS)
def test_many_small_tensors_fuse(ranks, world):
    for r, res in enumerate(ranks[world]):
        c = res["collectives"]
        assert c["many_tensors"] == 64 and 1 <= c["many_buckets"] < 64
        want = np.stack([np.full(3, sum(i + q for q in range(world)),
                                 np.float32) for i in range(64)])
        np.testing.assert_array_equal(c["many"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_object_collectives(ranks, world):
    for res in ranks[world]:
        assert res["collectives"]["object"] == {"from": 1}
        assert res["collectives"]["objects"] == [("rank", q)
                                                 for q in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_subset_process_set_and_join(ranks, world):
    members = sorted({1, world - 1})
    for r, res in enumerate(ranks[world]):
        got = res["process_set"]["sum"]
        if r in members:
            assert got.tolist() == [float(sum(q + 1 for q in members))] * 2
        else:
            assert got is None
        # rank r ran r + 1 allreduces: step i sums the ranks still active
        assert res["join"]["last"] == world - 1
        assert [s.tolist() for s in res["join"]["sums"]] == [
            [float(sum(q + 1 for q in range(i, world)))] * 3
            for i in range(r + 1)]


def test_distributed_optimizer_matches_single_process(ranks):
    """2 ranks of SGD with momentum on 4 + 4 samples against one process
    on all 8, from rank 0's initial weights (broadcast to rank 1, whose
    own seed differs)."""
    results = [r["optimizer"] for r in ranks[2]]
    for a, b in zip(results[0]["params"], results[1]["params"]):
        np.testing.assert_array_equal(a, b)
    torch.manual_seed(42)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    X, y = (torch.from_numpy(a) for a in tr.optimizer_data())
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(X), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(results[0]["losses"], losses, rtol=1e-6)
    for got, p in zip(results[0]["params"], model.parameters()):
        np.testing.assert_allclose(got, p.detach().numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_api_surface_covers_the_jax_torch_adapter():
    """Every name of the JAX package's torch ``__all__`` is in the port or
    raises naming its ROADMAP item."""
    import horovod_tpu.torch as jtorch
    for name in jtorch.__all__:
        try:
            getattr(hvd_torch, name)
        except NotImplementedError as e:
            assert "ROADMAP.md A" in str(e), name
    from torch.nn.modules.batchnorm import _BatchNorm
    assert issubclass(hvd_torch.SyncBatchNorm, _BatchNorm)
    assert "SyncBatchNorm" in hvd_torch.__all__
    assert hvd_torch.api._resolve_op(None, hvd_torch.Adasum) == \
        hvd_torch.Adasum


def test_distributed_optimizer_options_at_world_one():
    """backward_passes_per_step sums 2 passes before one reduction; the
    predivide factor divides before the sum and multiplies after; a
    synchronize() by hand, then step() under skip_synchronize()."""
    hvd_torch.init(device="cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 2)
        ref = torch.nn.Linear(4, 2)
        ref.load_state_dict(model.state_dict())
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=2, gradient_predivide_factor=2.0)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
        X = torch.randn(2, 8, 4)
        for m in (model, ref):
            for x in X:
                m(x).square().mean().backward()
        # two passes accumulated; the plan reduces in synchronize()
        assert set(opt._passes.values()) == {2} and opt._reduced is None
        opt.synchronize()
        assert opt._reduced is not None
        for m in (model, ref):
            torch.nn.utils.clip_grad_norm_(m.parameters(), 0.5)
        with opt.skip_synchronize():
            opt.step()
        ref_opt.step()
        for a, b in zip(model.parameters(), ref.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        # Adasum at one rank is the identity: the step is plain SGD's
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), op=hvd_torch.Adasum)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
        for m, o in ((model, opt), (ref, ref_opt)):
            o.zero_grad()
            m(X[0]).square().mean().backward()
            o.step()
        for a, b in zip(model.parameters(), ref.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        hvd_torch.shutdown()
