"""Parity of the port's synchronized batch norm with the JAX package's and
with ``torch.nn.BatchNorm2d``.

The functional form (``ops/sync_batch_norm.py``) keeps the JAX package's
conventions and is held against ``horovod_tpu.ops.sync_batch_norm`` on the
same numpy inputs (NHWC there, NCHW here): output, new running statistics
and, through autograd and ``jax.grad``, the gradients of ``sum(y * g)``.
Over 2 and 4 gloo rank processes (tests/torch_ranks.py), each holding its
rows of a global batch, the functional form equals the JAX function on the
whole batch, and ``hvd.SyncBatchNorm`` equals ``torch.nn.BatchNorm2d`` on
it: outputs and input gradients row for row, parameter gradients summed
over the ranks (each rank's are its own rows' part, as in the reference),
running statistics, then eval.

Tolerances: fp32 on both sides, the same arithmetic summed in another
order over at most 72 entries a channel: rtol 1e-5 and atol 1e-5 (1e-6
for the running statistics, which are O(1) averages).  bf16 inputs: the
output is rounded to bf16 on both sides, so within one bf16 step (2^-7
relative, atol 2e-2 at |y| <= ~3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as tr
from horovod_tpu.ops import sync_batch_norm as jsbn
import horovod_tpu_torch as hvd_torch
from horovod_tpu_torch.ops import sync_batch_norm as tsbn

WORLDS = (2, 4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _nhwc(a):
    return np.asarray(a).transpose(0, 2, 3, 1)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _inputs(seed, shape=(4, 6, 5, 5)):
    """x (NCHW, per-channel offset and spread), g, scale, bias, running
    mean and var."""
    rng = np.random.RandomState(seed)
    C = shape[1]
    x = (rng.randn(*shape) * rng.uniform(0.5, 2.0, (1, C, 1, 1))
         + rng.randn(1, C, 1, 1)).astype(np.float32)
    return (x, rng.randn(*shape).astype(np.float32),
            rng.uniform(0.5, 1.5, C).astype(np.float32),
            rng.randn(C).astype(np.float32),
            rng.randn(C).astype(np.float32),
            rng.uniform(0.5, 2.0, C).astype(np.float32))


def _jax(x, g, scale, bias, rm, rv, train, momentum=0.9, eps=1e-5):
    """JAX's sync_batch_norm on the NCHW inputs, with the gradients of
    sum(y * g) by x, scale and bias."""
    def f(x, scale, bias):
        y, m, v = jsbn.sync_batch_norm(x, scale, bias, jnp.asarray(rm),
                                       jnp.asarray(rv), train=train,
                                       momentum=momentum, eps=eps)
        return (y * jnp.asarray(_nhwc(g))).sum(), (y, m, v)

    (_, (y, m, v)), (dx, ds, db) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias))
    return {"y": _nchw(y), "mean": np.asarray(m), "var": np.asarray(v),
            "dx": _nchw(dx), "dscale": np.asarray(ds),
            "dbias": np.asarray(db)}


def _port(x, g, scale, bias, rm, rv, train, momentum=0.9, eps=1e-5):
    xt, st, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias))
    y, m, v = tsbn.sync_batch_norm(xt, st, bt, torch.from_numpy(rm),
                                   torch.from_numpy(rv), train=train,
                                   momentum=momentum, eps=eps)
    (y * torch.from_numpy(g)).sum().backward()
    return {"y": y.detach().numpy(), "mean": m.numpy(), "var": v.numpy(),
            "dx": xt.grad.numpy(), "dscale": st.grad.numpy(),
            "dbias": bt.grad.numpy()}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("momentum,eps", [(0.9, 1e-5), (0.99, 1e-3)])
def test_functional_matches_jax(train, momentum, eps):
    args = _inputs(0)
    want = _jax(*args, train=train, momentum=momentum, eps=eps)
    got = _port(*args, train=train, momentum=momentum, eps=eps)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    if not train:   # eval returns the running statistics unchanged
        np.testing.assert_array_equal(got["mean"], args[4])


def test_bf16_output_matches_jax():
    """bf16 activations: fp32 statistics, the output rounded to bf16."""
    x, g, scale, bias, rm, rv = _inputs(1)
    xb = x.astype(jnp.bfloat16)
    y, m, v = jsbn.sync_batch_norm(jnp.asarray(_nhwc(xb)), scale, bias, rm,
                                   rv)
    yt, mt, vt = tsbn.sync_batch_norm(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(rm), torch.from_numpy(rv))
    assert yt.dtype == torch.bfloat16 and mt.dtype == torch.float32
    np.testing.assert_allclose(yt.float().numpy(),
                               _nchw(np.asarray(y, np.float32)),
                               rtol=2 ** -7, atol=2e-2)
    np.testing.assert_allclose(mt.numpy(), np.asarray(m), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(v), **TOL)


def test_batch_stats_match_jax():
    x = _inputs(2)[0]
    m, v = jsbn.sync_batch_stats(jnp.asarray(_nhwc(x)), (0, 1, 2))
    mt, vt = tsbn.sync_batch_stats(torch.from_numpy(x), (0, 2, 3))
    np.testing.assert_allclose(mt.numpy(), np.asarray(m), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(v), **TOL)


def test_module_at_world_one_is_batch_norm():
    """hvd.SyncBatchNorm under hvd.init() at one rank: torch's BatchNorm2d,
    train and eval, with its running statistics."""
    x, g = (torch.from_numpy(a) for a in _inputs(3)[:2])
    hvd_torch.init(device="cpu")
    try:
        m, ref = hvd_torch.SyncBatchNorm(6), torch.nn.BatchNorm2d(6)
        for mod in (m, ref):
            xi = x.clone().requires_grad_()
            (mod(xi) * g).sum().backward()
            mod.grad_x = xi.grad
        np.testing.assert_allclose(m.grad_x, ref.grad_x, **TOL)
        np.testing.assert_allclose(m.running_var, ref.running_var, **TOL)
        m.eval()
        ref.eval()
        np.testing.assert_allclose(m(x).detach(), ref(x).detach(), **TOL)
    finally:
        hvd_torch.shutdown()


# -- over rank processes ------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.Worlds(tmp_path_factory, ["sync_bn"])


def _torch_reference(kw):
    """torch.nn.BatchNorm2d on the global batches of tr.sbn_batch."""
    m = torch.nn.BatchNorm2d(tr.SBN_C, **kw)
    if m.affine:
        w, b = tr.sbn_affine()
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w))
            m.bias.copy_(torch.from_numpy(b))
    steps = []
    for step in range(tr.SBN_STEPS):
        xg, gg = tr.sbn_batch(step)
        x = torch.from_numpy(xg).requires_grad_()
        y = m(x)
        (y * torch.from_numpy(gg)).sum().backward()
        rec = {"y": y.detach().numpy(), "dx": x.grad.numpy()}
        if m.affine:
            rec.update(dw=m.weight.grad.numpy().copy(),
                       db=m.bias.grad.numpy().copy())
            m.zero_grad()
        if m.track_running_stats:
            rec.update(mean=m.running_mean.numpy().copy(),
                       var=m.running_var.numpy().copy())
        steps.append(rec)
    m.eval()
    return steps, m(torch.from_numpy(tr.sbn_batch(tr.SBN_STEPS)[0])) \
        .detach().numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("config", sorted(tr.SBN_CONFIGS))
def test_module_equals_batch_norm_on_the_global_batch(ranks, world, config):
    results = [r["sync_bn"][config] for r in ranks[world]]
    steps, want_eval = _torch_reference(tr.SBN_CONFIGS[config])
    k = tr.SBN_BATCH // world
    for step, want in enumerate(steps):
        got = [r["steps"][step] for r in results]
        for key in ("y", "dx"):
            np.testing.assert_allclose(
                np.concatenate([g[key] for g in got]), want[key],
                err_msg=f"{key} step {step}", **TOL)
        for key in ("dw", "db"):
            if key in want:
                np.testing.assert_allclose(sum(g[key] for g in got),
                                           want[key], err_msg=key, **TOL)
        for key in ("mean", "var"):
            if key in want:
                for g in got:
                    np.testing.assert_allclose(g[key], want[key],
                                               rtol=1e-6, atol=1e-6,
                                               err_msg=key)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["eval"],
                                   want_eval[r * k:(r + 1) * k], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_functional_over_ranks_equals_jax_on_the_global_batch(ranks, world):
    """The cross-rank sum forward and its transpose backward: each rank's
    rows of the output and input gradient, the summed scale and bias
    gradients, and the running statistics, as JAX on the whole batch."""
    got = [r["sync_bn"]["functional"] for r in ranks[world]]
    xg, gg = tr.sbn_batch(0)
    w, b = tr.sbn_affine()
    want = _jax(xg, gg, w, b, np.full(tr.SBN_C, 0.5, np.float32),
                np.full(tr.SBN_C, 2.0, np.float32), train=True)
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]),
                                   want[key], err_msg=key, **TOL)
    for key in ("dscale", "dbias"):
        np.testing.assert_allclose(sum(g[key] for g in got), want[key],
                                   err_msg=key, **TOL)
    for g in got:
        np.testing.assert_allclose(g["mean"], want["mean"], **TOL)
        np.testing.assert_allclose(g["var"], want["var"], **TOL)
    y_eval = jsbn.sync_batch_norm(
        jnp.asarray(_nhwc(xg)), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(want["mean"]), jnp.asarray(want["var"]), train=False)[0]
    np.testing.assert_allclose(np.concatenate([g["eval"] for g in got]),
                               _nchw(y_eval), **TOL)
