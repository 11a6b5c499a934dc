"""Parity of the port's optimizer and train step with the JAX package's.

``adamw_lp`` is held against the optax chain it replaces over 3 steps, and
``make_llama_train_step`` against the JAX step on a one-device
``MeshConfig(dp=1)`` mesh over 3 steps (the ``run_steps`` shape of
tests/test_llama.py), from the same weights and tokens.

Tolerances: everything is fp32.  The optimizer sees identical inputs, so
parameters agree to the last bits of fp32 (rtol 1e-6 / atol 1e-8) and the
stored bf16 moments to one bf16 step (rtol 2^-7), since an fp32 moment a
few ulps apart can round to the neighbouring bf16 value.  The train step
feeds Adam gradients that differ in summation order, and a bf16 moment
can then round to the neighbouring value, which moves an update by up to
lr·2^-7: over 3 steps of lr 3e-4 that is 7e-6.  Adam also divides by
sqrt(v) + 1e-8, so an entry whose gradient is ~0 (within the rounding of
its sum) can step by up to lr in either direction on either side: such
entries are rare (1 in 4096 of the embedding here).  Parameters are held
to atol 1e-5 on all but 0.1% of entries and to 2·lr per step everywhere;
losses to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import training as jtraining
from horovod_tpu.models import llama as jl
from horovod_tpu.optim import precision as jprecision
from horovod_tpu.parallel.mesh import MeshConfig as JMeshConfig
from horovod_tpu.parallel.mesh import ParallelMesh as JParallelMesh
from horovod_tpu_torch import convert, training
from horovod_tpu_torch.optim import precision
from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
from horovod_tpu_torch.tree import tree_leaves

from test_torch_llama import torch_cfg

SHAPES = [(64, 32), (32,), (8, 4, 16)]


def _optimizer_case(seed=0, steps=3):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.randn(*s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
              for s in SHAPES] for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("mu_dtype,nu_dtype", [
    ("bf16", "bf16"),   # the main path's
    (None, None),       # fp32 moments
])
def test_adamw_lp_matches_optax_chain(mu_dtype, nu_dtype):
    jd = {"bf16": jnp.bfloat16, None: None}
    td = {"bf16": torch.bfloat16, None: None}
    params, grads = _optimizer_case()
    opt = jprecision.adamw_lp(1e-2, mu_dtype=jd[mu_dtype],
                              nu_dtype=jd[nu_dtype])
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.tensor(p) for p in params]
    topt = precision.adamw_lp(1e-2, mu_dtype=td[mu_dtype],
                              nu_dtype=td[nu_dtype])(tp)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        topt.step()
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-8)
    adam = state[0]
    for i, p in enumerate(tp):
        st = topt.state[p]
        assert st["count"] == int(adam.count) == 3
        for name, jm in (("mu", adam.mu[i]), ("nu", adam.nu[i])):
            assert st[name].dtype == (td[mu_dtype] or torch.float32)
            np.testing.assert_allclose(st[name].float().numpy(),
                                       np.asarray(jm, np.float32),
                                       rtol=2 ** -7, atol=1e-30)


def test_tree_nbytes_counts_bf16_moments():
    params = [torch.zeros(s) for s in SHAPES]
    n = sum(p.numel() for p in params)
    opt = precision.adamw_lp(1e-3)(params)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    assert precision.tree_nbytes(params) == 4 * n
    assert precision.tree_nbytes(list(opt.state.values())) == 4 * n


CFG = jl.tiny(vocab=64, seq=32)
_RNG = np.random.RandomState(0)
TOKS = _RNG.randint(0, 64, (8, 32)).astype(np.int32)
TGTS = _RNG.randint(0, 64, (8, 32)).astype(np.int32)


@pytest.mark.parametrize("lp", [True, False])
def test_train_step_trajectory_matches_jax(lp):
    """3 steps of make_llama_train_step with adamw_lp (the main path's
    optimizer) and with each side's default (optax.adamw(3e-4) and the
    port's torch AdamW bound to the same hyper-parameters)."""
    jopt = jprecision.adamw_lp(3e-4) if lp else None
    ts = jtraining.make_llama_train_step(
        CFG, JParallelMesh(JMeshConfig(1, 1, 1, 1)), optimizer=jopt)
    jparams, jstate = ts.init_fn(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.array, jparams)
    jlosses = []
    for _ in range(3):
        jparams, jstate, loss = ts.step_fn(jparams, jstate,
                                           jnp.asarray(TOKS),
                                           jnp.asarray(TGTS))
        jlosses.append(float(loss))

    tts = training.make_llama_train_step(
        torch_cfg(CFG), optimizer=precision.adamw_lp(3e-4) if lp else None,
        device="cpu")
    params = convert.llama_params_from_numpy(np_params, device="cpu")
    opt_state = tts.opt_init(params)
    tlosses = []
    for _ in range(3):
        params, opt_state, loss = tts.step_fn(
            params, opt_state, torch.from_numpy(TOKS), torch.from_numpy(TGTS))
        tlosses.append(loss.item())

    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    got = convert.llama_params_to_numpy(params)
    for path, a in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [k.key for k in path]
        b = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        diff = np.abs(b - np.asarray(a))
        assert (diff > 1e-5).mean() <= 1e-3, (keys, (diff > 1e-5).sum())
        assert diff.max() <= 3 * 2 * 3e-4, (keys, diff.max())


def test_grads_fn_and_init_fn():
    tcfg = torch_cfg(CFG)
    ts = training.make_llama_train_step(tcfg, device="cpu")
    params, opt_state = ts.init_fn(0)
    assert isinstance(opt_state, torch.optim.AdamW)
    assert ts.device == torch.device("cpu") and ts.par.dp_axis is None
    loss, grads = ts.grads_fn(params, torch.from_numpy(TOKS),
                              torch.from_numpy(TGTS))
    assert loss.shape == () and np.isfinite(loss.item())
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.shape == p.shape and p.grad is None


@pytest.mark.parametrize("kw,item", [
    ({"overlap": True}, "A5"),
    ({"zero1": True}, "A5"),
    ({"grad_accum": 2}, "A5"),
    ({"attn": "ulysses"}, "A6"),
])
def test_unported_step_options_raise(kw, item):
    """An option of an unported item raises naming it.  A5's options are
    ported (tests/test_torch_a5_step.py holds them against JAX): without
    hvd.init() zero1 and grad_accum build a one-device step, and overlap,
    which reduces over the runtime's process set, asks for the runtime."""
    if item == "A5":
        if kw.get("overlap"):
            with pytest.raises(ValueError, match=r"hvd\.init\(\)"):
                training.make_llama_train_step(torch_cfg(CFG),
                                               device="cpu", **kw)
        else:
            ts = training.make_llama_train_step(torch_cfg(CFG),
                                                device="cpu", **kw)
            assert ts.mesh.process_set is None
        return
    # A6's Ulysses is ported: on one device (no sp axis) it is local
    # attention, the same step as ring's
    ts = training.make_llama_train_step(torch_cfg(CFG), device="cpu", **kw)
    assert ts.par.attn == "ulysses" and ts.par.sp_axis is None
    params, opt_state = ts.init_fn(0)
    _, _, loss = ts.step_fn(params, opt_state, torch.from_numpy(TOKS),
                            torch.from_numpy(TGTS))
    assert np.isfinite(loss.item())


def test_mesh_is_one_device_until_the_nccl_slice():
    """A process's mesh holds its own device; a mesh of more than one
    device, on any axis, needs the runtime initialized at that size
    (tests/test_torch_dp_step.py and tests/test_torch_llama_parallel.py
    run them)."""
    mesh = ParallelMesh(MeshConfig(), devices=["cpu"])
    assert mesh.axis_names == ("dp", "pp", "sp", "tp")
    assert mesh.axis_size("ep") == 1 and mesh.devices == [torch.device("cpu")]
    assert mesh.process_set is None
    assert mesh.axis_index("tp") == 0 and mesh.group("tp") is None
    with pytest.raises(ValueError, match=r"hvd\.init\(\)"):
        ParallelMesh(MeshConfig(dp=2), devices=["cpu"])
    for axes in ({"tp": 2}, {"sp": 2}, {"pp": 2}, {"ep": 2}):
        with pytest.raises(ValueError, match=r"hvd\.init\(\)"):
            ParallelMesh(MeshConfig(**axes), devices=["cpu"])
