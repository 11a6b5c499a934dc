"""Parity of the port's planner, response cache, negotiation tokens and
decision function with the JAX package's, and the runtime's lifecycle.

The JAX package's ``ops/fusion.py`` and ``ops/controller.py`` are the
reference: the same ``EntrySig`` lists must give the same fusion plans
(the lists of tests/test_fusion.py's cases, and random ones from the fuzz
suites' generator), the same entries the same wire tokens, and the same
request lists the same ``NegotiationResult`` (or the same
``DivergenceError``).  All of that is exact: plans, tokens and decisions
are discrete.

The lifecycle cases (join with zero contributions, divergence, init →
shutdown → init, a subset process set) run in real rank processes over
gloo (tests/torch_ranks.py) and are held against the semantics the JAX
package documents for ``_decide`` and ``_synthesize``.
"""

import dataclasses
import random
from collections import Counter

import hypothesis.strategies as st
import pytest
import torch
from hypothesis import given, settings

from horovod_tpu.ops import controller as jctl
from horovod_tpu.ops import engine as jengine
from horovod_tpu.ops import fusion as jfusion
import horovod_tpu_torch as hvd
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch.ops import controller as tctl
from horovod_tpu_torch.ops import engine as tengine
from horovod_tpu_torch.ops import fusion as tfusion

import torch_ranks
from _helpers import random_entry_sigs


def _sig(name, shape=(10,), dtype="float32", op="allreduce",
         reduce_op="sum", ps=0, stacked=True, group=-1):
    return dict(name=name, op_type=op, reduce_op=reduce_op, dtype=dtype,
                shape=shape, process_set_id=ps, stacked=stacked,
                group_id=group)


# the EntrySig lists of tests/test_fusion.py's cases
FUSION_CASES = {
    "single_bucket": [_sig("a"), _sig("b"), _sig("c")],
    "threshold": [_sig(n) for n in "abcde"],
    "dtype": [_sig("a"), _sig("b", dtype="bfloat16"), _sig("c")],
    "reduce_op": [_sig("a"), _sig("b", reduce_op="min")],
    "process_set": [_sig("a", ps=0), _sig("b", ps=1)],
    "non_allreduce": [_sig("a", op="allgather"), _sig("b", op="allgather")],
    "group": [_sig("a", group=7), _sig("b", group=7), _sig("c", group=7)],
    "order_1": [_sig("x"), _sig("a"), _sig("m")],
    "order_2": [_sig("a"), _sig("m"), _sig("x")],
    "group_tie": [_sig("g.0", group=1), _sig("g.2", group=1),
                  _sig("g.0", group=2), _sig("g.1", group=2), _sig("solo")],
    "identical_groups": [_sig("g.0", group=1), _sig("g.1", group=1),
                         _sig("g.0", group=2), _sig("g.1", group=2)],
}
THRESHOLDS = (1, 40, 50, 100, 1 << 20)


def _pair(kwargs_list):
    return ([jfusion.EntrySig(**k) for k in kwargs_list],
            [tfusion.EntrySig(**k) for k in kwargs_list])


@pytest.mark.parametrize("case", sorted(FUSION_CASES))
def test_plan_fusion_matches_jax(case):
    jsigs, tsigs = _pair(FUSION_CASES[case])
    for threshold in THRESHOLDS:
        assert tfusion.plan_fusion(tsigs, threshold) == \
            jfusion.plan_fusion(jsigs, threshold)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31), n=st.integers(0, 48),
       threshold=st.sampled_from([1, 64, 4096, 1 << 16, 1 << 26]))
def test_plan_fusion_matches_jax_on_random_lists(seed, n, threshold):
    jsigs = random_entry_sigs(random.Random(seed), n)
    tsigs = [tfusion.EntrySig(**dataclasses.asdict(s)) for s in jsigs]
    assert tfusion.plan_fusion(tsigs, threshold) == \
        jfusion.plan_fusion(jsigs, threshold)


def test_response_cache_matches_jax():
    rng = random.Random(0)
    lists = [random_entry_sigs(rng, rng.randint(1, 6)) for _ in range(6)]
    jcache, tcache = jfusion.ResponseCache(3), tfusion.ResponseCache(3)
    for step in range(40):
        jsigs = lists[rng.randrange(len(lists))]
        tsigs = [tfusion.EntrySig(**dataclasses.asdict(s)) for s in jsigs]
        got, want = tcache.get(tsigs), jcache.get(jsigs)
        assert got == want, step
        if want is None:
            plan = jfusion.plan_fusion(jsigs, 1 << 10)
            jcache.put(jsigs, plan)
            tcache.put(tsigs, plan)
    assert tcache.stats() == jcache.stats()
    assert tfusion.get_planner(None)[0] is tfusion.plan_fusion


def test_torch_dtype_names_have_the_jax_widths():
    for dt in (torch.float32, torch.float64, torch.bfloat16, torch.float16,
               torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64, torch.bool, torch.complex64,
               torch.float8_e4m3fn, torch.float8_e5m2):
        name = tfusion.dtype_name(dt)
        assert tfusion.dtype_nbytes(name) == jfusion.dtype_nbytes(name) \
            == torch.empty(0, dtype=dt).element_size()


class _PS:
    process_set_id = 3


# (name, op, reduce_op, shapes, dtype, prescale, postscale, root, splits,
#  grouped): the entries whose tokens are compared
TOKEN_CASES = [
    ("a", "allreduce", "average", [(4, 6)], "float32", None, None, 0,
     None, False),
    ("g", "allreduce", "sum", [(2,), (3, 1)], "bfloat16", 0.5, 2.0, 0,
     None, True),
    ("ag", "allgather", "average", [(5, 2)], "int64", None, None, 0, None,
     False),
    ("bc", "broadcast", "average", [(3,)], "float64", None, None, 1, None,
     False),
    ("a2a", "alltoall", "average", [(6,)], "int32", None, None, 0,
     [1, 2, 3], False),
    ("rs", "reducescatter", "sum", [(4, 2)], "float32", None, 4.0, 0, None,
     False),
]


@pytest.mark.parametrize("case", TOKEN_CASES, ids=[c[0] for c in TOKEN_CASES])
def test_entry_token_matches_jax(case):
    import numpy as np
    name, op, rop, shapes, dt, pre, post, root, splits, grouped = case
    np_dt = "float32" if dt == "bfloat16" else dt
    je = jengine.TensorTableEntry(
        name, op, [np.zeros(s, np_dt) for s in shapes], _PS(), reduce_op=rop,
        prescale=pre, postscale=post, root_rank=root, splits=splits,
        stacked=False, group_id=5 if grouped else -1)
    if dt == "bfloat16":   # the JAX entry reads the dtype's name only
        import ml_dtypes
        je.arrays = [a.astype(ml_dtypes.bfloat16) for a in je.arrays]
    te = tengine.TensorTableEntry(
        name, op, [torch.zeros(s, dtype=getattr(torch, dt)) for s in shapes],
        _PS(), reduce_op=rop, prescale=pre, postscale=post, root_rank=root,
        splits=splits, group_id=9 if grouped else -1)
    # group ids are per-process counters: the token keeps grouped-or-not
    assert [dataclasses.replace(s, group_id=0) for s in te.sigs()] == \
        [tfusion.EntrySig(**dict(dataclasses.asdict(s), group_id=0))
         for s in je.sigs()]
    assert tctl.entry_token(te) == jctl.entry_token(je)


def _tok(name, shape=(4,), dtype="float32"):
    e = tengine.TensorTableEntry(name, "allreduce",
                                 [torch.zeros(shape, dtype=getattr(torch,
                                                                   dtype))],
                                 _PS())
    return tctl.entry_token(e)


A, B, C = _tok("a"), _tok("b"), _tok("c", (2, 2), "int64")
A_OTHER = _tok("a", (5,))

# (full request lists by process, joined processes, their join seqs)
DECIDE_CASES = {
    "agree": ({0: [A, B], 1: [B, A]}, [], {}),
    "deferral": ({0: [A, B, C], 1: [A]}, [], {}),
    "duplicates": ({0: [A, A, B], 1: [A, B, B]}, [], {}),
    "three_way": ({0: [A, B], 1: [A], 2: [B, C]}, [], {}),
    "joined": ({0: [A, B], 1: []}, [1], {1: 4}),
    "joined_two": ({0: [C], 1: [], 2: []}, [1, 2], {1: 2, 2: 7}),
    "divergent_shape": ({0: [A], 1: [A_OTHER]}, [], {}),
    "aliasing": ({0: [A, A_OTHER], 1: [A]}, [], {}),
}


def _decide(ctl, full, joined, js):
    vals = {q: ({"j": True, "js": js[q]} if q in joined else {})
            for q in full}
    active = [q for q in sorted(full) if q not in joined]
    try:
        res = ctl._decide("gk", full, active, joined, vals, active[0])
    except (jctl.DivergenceError, tctl.DivergenceError) as e:
        return type(e).__name__, str(e)
    return (Counter(res.counts), res.missing, res.all_joined,
            res.last_joiner)


@pytest.mark.parametrize("case", sorted(DECIDE_CASES))
def test_decide_matches_jax(case):
    full, joined, js = DECIDE_CASES[case]
    want = _decide(jctl.Controller(None, None, "t"), full, joined, js)
    got = _decide(tctl.Controller(), full, joined, js)
    assert got == want
    if case == "divergent_shape":
        assert got[0] == "DivergenceError" and "'a'" in got[1]


def test_decide_fails_a_stalled_round_as_divergence():
    """The port's addition: a round in which a member has waited past the
    deadline and tensors are still missing raises on every member."""
    full = {0: [A], 1: [B]}
    vals = {0: {"d": True}, 1: {}}
    with pytest.raises(tctl.DivergenceError, match="'a' is missing on "
                                                   r"ranks \[1\]"):
        tctl.Controller()._decide("gk", full, [0, 1], [], vals, 1)
    res = tctl.Controller()._decide("gk", {0: [A], 1: [A]}, [0, 1], [],
                                    vals, 1)
    assert res.counts == Counter({A: 1})


@pytest.mark.parametrize("env,field,item", tconfig.UNPORTED,
                         ids=[u[0] for u in tconfig.UNPORTED])
def test_unported_knobs_raise_naming_their_item(monkeypatch, env, field,
                                                item):
    value = {"HOROVOD_COMPRESSION": "int8", "HOROVOD_TAIL_POLICY": "stale",
             "HOROVOD_RECOVERY": "parity", "HOROVOD_TIMELINE": "/x.json",
             "HOROVOD_SLO": "cycle_rate>=1"}.get(env, "1")
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tconfig.Config.from_env()


def test_elastic_knob_parses_and_elastic_is_ported(monkeypatch):
    """HOROVOD_ELASTIC=1 validates (its field as the JAX package parses
    it) and no longer names A8; nor does HOROVOD_RECOVERY, ported since
    (``tests/test_torch_recovery.py``)."""
    import os
    from horovod_tpu import config as jconfig
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    c = tconfig.Config.from_env()
    assert c.elastic
    assert dataclasses.asdict(c) == dataclasses.asdict(
        jconfig.Config.from_env())
    unported = {u[0]: u[2] for u in tconfig.UNPORTED}
    assert "HOROVOD_ELASTIC" not in unported
    assert "HOROVOD_RECOVERY" not in unported
    assert "A8" not in unported.values()


def test_config_copies_the_knob_table(monkeypatch):
    import os
    from horovod_tpu import config as jconfig
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    assert dataclasses.asdict(tconfig.Config.from_env()) == \
        dataclasses.asdict(jconfig.Config.from_env())
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "0.5")
    assert dataclasses.asdict(tconfig.Config.from_env()) == \
        dataclasses.asdict(jconfig.Config.from_env())


@pytest.mark.parametrize("controller,device,match", [
    ("nccl", "cpu", "needs a CUDA device"),
    ("mpi", "cpu", "gloo or nccl"),
])
def test_init_rejects_backends_it_cannot_run(monkeypatch, controller, device,
                                             match):
    monkeypatch.setenv("HOROVOD_CONTROLLER", controller)
    with pytest.raises(ValueError, match=match):
        hvd.init(device=device)
    assert not hvd.is_initialized()


def test_world_of_one_without_launcher_env():
    """No launcher env: a world of one on an in-process store, gloo on the
    CPU; every collective still goes through the engine and the group."""
    with pytest.raises(hvd.exceptions.NotInitializedError):
        hvd.rank()
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        assert hvd.gloo_enabled() and hvd.is_homogeneous()
        x = torch.arange(6.0)
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
        assert hvd.join() == 0
        stats = hvd.runtime._state().engine.stats()
        assert stats["buckets"] == 1 and stats["negotiation"]["rounds"] == 0
        # Adasum of one rank's vector is the vector
        assert torch.equal(hvd.allreduce(x, op=hvd.Adasum), x)
        with pytest.raises(ValueError, match="runs on cpu"):
            hvd.allreduce(x.to(torch.device("meta")))
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    return torch_ranks.launch(
        2, ["join", "process_set", "divergence", "reinit"],
        tmp_path_factory.mktemp("lifecycle"))


def test_join_contributes_zeros_and_returns_the_last_joiner(lifecycle):
    # rank 0 runs one allreduce, rank 1 two: the second sums rank 1's 2
    # with rank 0's synthesized zeros
    assert [r["join"]["last"] for r in lifecycle] == [1, 1]
    assert [s.tolist() for s in lifecycle[0]["join"]["sums"]] == [[3] * 3]
    assert [s.tolist() for s in lifecycle[1]["join"]["sums"]] == \
        [[3] * 3, [2] * 3]


def test_divergence_raises_on_every_rank(lifecycle):
    for r in lifecycle:
        d = r["divergence"]
        assert "tensor 'shape' was submitted with mismatched" in d["shape"]
        assert "'only.0' is missing on ranks [1]" in d["name"]
        assert "'only.1' is missing on ranks [0]" in d["name"]
        assert d["after"].tolist() == [2.0, 2.0]


def test_reinit_reads_no_old_rounds(lifecycle):
    for r in lifecycle:
        assert r["reinit"]["first"].tolist() == [3.0]
        assert r["reinit"]["second"].tolist() == [3.0]
        assert r["reinit"]["namespace"] == "g2"


def test_subset_process_set(lifecycle):
    assert lifecycle[0]["process_set"]["sum"] is None
    assert lifecycle[1]["process_set"]["sum"].tolist() == [2.0, 2.0]
    assert lifecycle[0]["process_set"]["ids"] == {0: [0, 1]}


def test_rounds_cost_a_bounded_number_of_store_operations(lifecycle):
    for r in lifecycle:
        neg = r["stats"]["negotiation"]
        assert neg["rounds"] > 0
        # one multi_get per phase gathered: never a get per peer
        assert neg["kv_multi_gets"] <= 2 * neg["rounds"]
        assert neg["kv_sets"] <= 2 * neg["rounds"] + 2
