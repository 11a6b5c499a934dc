"""The slice as a whole: the port's Llama step with ``overlap=True``,
``zero1=True`` and ``grad_accum=2`` at dp 2 against the JAX package's.

Two gloo rank processes (tests/torch_ranks.py ``case_dp_step``) each run
``make_llama_train_step`` with one of those options under ``hvd.init()``
on their half of the batch for 3 steps of ``adamw_lp(3e-4)``; rank 1
builds its parameter dicts in reverse key order.  The JAX reference is
``make_llama_train_step`` with the same option on a dp-2 mesh of the
virtual CPU devices, from the same converted weights and batch: 2 layers
at narrow widths, the one-shot loss.  ``overlap`` reduces each layer's
buckets from the grad taps during the backward pass; ``zero1`` keeps half
of the optimizer state of every leaf whose leading axis divides by 2 (all
of them here) on each rank; ``grad_accum=2`` runs two microbatches of 2
rows a rank.

Tolerances: the two ranks agree bit for bit.  Against JAX,
tests/test_torch_dp_step.py's (losses rtol 1e-5; parameters atol 1e-5 on
all but 0.1% of entries and 2·lr per step everywhere).  ZeRO's per-rank
state is half the replicated run's, to the byte.

Also here: the JAX package's composition rules for ``overlap`` (it refuses
``zero1`` and ``grad_accum``), with its message.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import training as jtraining
from horovod_tpu.models import llama as jl
from horovod_tpu.optim import precision as jprecision
from horovod_tpu.parallel.mesh import MeshConfig as JMeshConfig
from horovod_tpu.parallel.mesh import ParallelMesh as JParallelMesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training

import torch_ranks
from test_torch_dp_step import LR, _batch, _flat
from test_torch_llama import torch_cfg

CFG = jl.tiny(vocab=64, seq=32)
#: name -> make_llama_train_step option; "plain" prices zero1's state
OPTIONS = {"overlap": {"overlap": True}, "zero1": {"zero1": True},
           "accum": {"grad_accum": 2}, "plain": {}}


@pytest.fixture(scope="module")
def jax_runs():
    """3 JAX dp-2 steps per option, from one initialization."""
    out = {}
    for name, kw in sorted(OPTIONS.items()):
        ts = jtraining.make_llama_train_step(
            CFG, JParallelMesh(JMeshConfig(dp=2)),
            optimizer=jprecision.adamw_lp(LR), **kw)
        params, state = ts.init_fn(jax.random.PRNGKey(3))
        init = jax.tree_util.tree_map(np.array, params)
        toks, tgts = _batch(CFG.vocab_size, 3)
        losses = []
        for _ in range(3):
            params, state, loss = ts.step_fn(params, state,
                                             jnp.asarray(toks),
                                             jnp.asarray(tgts))
            losses.append(float(loss))
        out[name] = (init, toks, tgts, losses,
                     _flat(jax.tree_util.tree_map(np.array, params)))
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    d = tmp_path_factory.mktemp("a5_step")
    tcfg = torch_cfg(CFG)
    spec = {}
    for name, (init, toks, tgts, _, _) in jax_runs.items():
        fields = {f.name: getattr(tcfg, f.name)
                  for f in dataclasses.fields(tcfg)}
        fields["dtype"] = str(tcfg.dtype).removeprefix("torch.")
        fields["param_dtype"] = str(tcfg.param_dtype).removeprefix("torch.")
        spec[name] = dict(fields, step_kw=OPTIONS[name])
        np.savez(d / f"{name}.npz", toks=toks, tgts=tgts, **_flat(init))
    (d / "dp_step.json").write_text(json.dumps(spec))
    return torch_ranks.launch(2, ["dp_step"], d,
                              env={"DP_STEP_DIR": str(d)})


#: the overlapped step under HOROVOD_SHARDED_UPDATE=1 and
#: HOROVOD_COMPRESSION=int8, the runtime's defaults for its transform
WIRE_ENV = {"HOROVOD_SHARDED_UPDATE": "1", "HOROVOD_COMPRESSION": "int8"}


@pytest.fixture(scope="module")
def port_wire_runs(jax_runs, tmp_path_factory):
    d = tmp_path_factory.mktemp("a5_wire")
    tcfg = torch_cfg(CFG)
    fields = {f.name: getattr(tcfg, f.name)
              for f in dataclasses.fields(tcfg)}
    fields["dtype"] = str(tcfg.dtype).removeprefix("torch.")
    fields["param_dtype"] = str(tcfg.param_dtype).removeprefix("torch.")
    init, toks, tgts, _, _ = jax_runs["plain"]
    np.savez(d / "overlap.npz", toks=toks, tgts=tgts, **_flat(init))
    (d / "dp_step.json").write_text(json.dumps(
        {"overlap": dict(fields, step_kw={"overlap": True})}))
    return torch_ranks.launch(2, ["dp_step"], d,
                              env=dict(WIRE_ENV, DP_STEP_DIR=str(d)))


def test_overlap_composes_with_the_sharded_int8_wire(jax_runs, port_runs,
                                                     port_wire_runs):
    """``overlap=True`` under HOROVOD_SHARDED_UPDATE=1 and
    HOROVOD_COMPRESSION=int8: the ranks stay bit-identical, the state is
    half the replicated step's, and the run stays near JAX's full-width
    dp-2 step: losses within 1e-3 relative, and every weight within
    2·lr a step (Adam moves each weight by about lr a step, whatever the
    wire does to its gradient)."""
    r0, r1 = (r["dp_step"]["overlap"] for r in port_wire_runs)
    assert r0["losses"] == r1["losses"]
    for path, a in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][path], a, err_msg=path)
    # 3 buckets (2 layers, the root), each padded to 2 x 256 elements
    half = r0["state_bytes"] / port_runs[0]["dp_step"]["plain"]["state_bytes"]
    assert 0.5 <= half <= 0.5 + 3 * 512 / 78144, half
    _, _, _, jlosses, jparams = jax_runs["plain"]
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-3)
    for path, want in jparams.items():
        assert np.abs(r0["params"][path] - want).max() <= 3 * 2 * LR, path


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_ranks_stay_bit_identical(port_runs, name):
    r0, r1 = (r["dp_step"][name] for r in port_runs)
    assert r0["order"] != r1["order"]
    assert r0["losses"] == r1["losses"]
    for path, a in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][path], a, err_msg=path)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_a5_step_matches_jax_dp2_step(jax_runs, port_runs, name):
    _, _, _, jlosses, jparams = jax_runs[name]
    got = port_runs[0]["dp_step"][name]
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    assert set(got["params"]) == set(jparams)
    for path, want in jparams.items():
        diff = np.abs(got["params"][path] - want)
        assert (diff > 1e-5).mean() <= 1e-3, (path, (diff > 1e-5).sum())
        assert diff.max() <= 3 * 2 * LR, (path, diff.max())


def test_zero1_keeps_half_the_state(port_runs):
    runs = port_runs[0]["dp_step"]
    assert runs["zero1"]["state_bytes"] * 2 == runs["plain"]["state_bytes"]
    # overlap's transform holds the same replicated state as the plain step
    assert runs["overlap"]["state_bytes"] == runs["plain"]["state_bytes"]


@pytest.mark.parametrize("kw", [{"zero1": True}, {"grad_accum": 2}],
                         ids=["zero1", "grad_accum"])
def test_overlap_composition_errors_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jtraining.make_llama_train_step(
            CFG, JParallelMesh(JMeshConfig(dp=2)), overlap=True, **kw)
    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError) as terr:
            training.make_llama_train_step(torch_cfg(CFG), overlap=True,
                                           **kw)
        assert str(terr.value) == str(jerr.value)
    finally:
        hvd.shutdown()


def test_overlap_needs_the_runtime():
    with pytest.raises(ValueError, match=r"hvd\.init\(\)"):
        training.make_llama_train_step(torch_cfg(CFG), overlap=True,
                                       device="cpu")
    # grad_accum must divide the local batch
    ts = training.make_llama_train_step(torch_cfg(CFG), grad_accum=3,
                                        device="cpu")
    params, state = ts.init_fn(0)
    toks = torch.zeros((4, 32), dtype=torch.long)
    with pytest.raises(ValueError, match="grad_accum=3"):
        ts.step_fn(params, state, toks, toks)
