"""The port's tail policies (``HOROVOD_TAIL_POLICY``) against the JAX
package's.

* ``plan_tail_round``, the pure deadline decision, against the JAX one
  under the same ``collective.dcn`` chaos rules and seeds: masks, waits,
  lateness, the stall inspector's scores, a drop raising under strict.
* ``tail_cross_reduce``, the cross stage's arithmetic, on four real rank
  processes over gloo as two hosts of two (``tests/torch_ranks.py``
  ``case_tail``), against ``tail_allreduce_p`` under ``shard_map`` on a
  (2, 2) mesh with the membership agreed over both axes: bounded under
  each mask and stale over three rounds up to the cap, bit for bit on
  seeded fp32 (every sum is of two values; n/k is 2); an all-ones
  bounded round bit for bit the strict one; a mask two ranks drew
  differently agreed on every rank.
* The engine under ``bounded`` and ``stale`` with host 1 delayed past the
  deadline: the exact results the policy dictates on multiples of 1/4,
  the rounds counted (``hvd_tail_rounds_total``) and timed, and the
  straggler scores of host 1's ranks above host 0's.

The JAX package's own arithmetic tests nest ``pmap``, which jax 0.9
refuses; its ``plan_tail_round`` and stall cases pass and are the ones
this file leans on, with ``tail_allreduce_p`` itself.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu.chaos as jchaos
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import controller as jctl
from horovod_tpu.ops import engine as jengine
from horovod_tpu.stall import StallInspector as JStall
import horovod_tpu_torch as hvd
from horovod_tpu_torch import chaos as tchaos
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.ops import controller as tctl
from horovod_tpu_torch.ops import engine as tengine
from horovod_tpu_torch.stall import StallInspector as TStall

import torch_ranks as tr

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.launch(WORLD, ["tail"], tmp_path_factory.mktemp("tail"),
                     env=tr.HIER_ENV)


# ---------------------------------------------------------------------------
# the deadline decision against the JAX package's
# ---------------------------------------------------------------------------

#: (chaos rule, policy, staleness, max_staleness, rounds)
PLAN_CASES = {
    "strict_waits_out": ("collective.dcn group=1 nth=1 action=delay:0.8",
                         "strict", None, 0, 1),
    "bounded_excludes": ("collective.dcn group=1 nth=1 action=delay:0.8",
                         "bounded", None, 0, 1),
    "bounded_fast_round": ("collective.dcn group=0 nth=1 "
                           "action=delay:0.05", "bounded", None, 0, 1),
    "stale_cap": ("collective.dcn group=1 nth=1 action=delay:0.8", "stale",
                  [0, 2], 2, 1),
    "stale_below_cap": ("collective.dcn group=1 action=delay:0.8", "stale",
                        [0, 1], 2, 2),
    "bounded_drop": ("collective.dcn group=0 times=2 action=drop",
                     "bounded", None, 0, 2),
    "bounded_random": ("collective.dcn prob=0.5 action=delay:0.3",
                       "bounded", None, 0, 6),
    "stale_random_drop": ("collective.dcn prob=0.3 action=drop", "stale",
                          [0, 0, 4], 4, 6),
    "strict_quiet": ("collective.dcn group=9 action=delay:1", "strict",
                     None, 0, 2),
}


def _plan(mod, stall, rule, policy, staleness, max_stal, rounds, chaos):
    chaos.install(chaos.FaultSchedule.parse(rule, seed=7))
    try:
        out = []
        n = len(staleness) if staleness is not None else 2
        for _ in range(rounds):
            present, wait, late = mod.plan_tail_round(
                "t", policy, n, 0.25, max_staleness=max_stal,
                staleness=None if staleness is None
                else np.array(staleness, np.int32), stall=stall)
            out.append((present.tolist(), wait, late))
        return out, stall.straggler_scores()
    finally:
        chaos.uninstall()


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_tail_round_matches_jax(case):
    args = PLAN_CASES[case]
    want = _plan(jcoll, JStall(check_time=1e9, use_native=False), *args,
                 chaos=jchaos)
    got = _plan(tcoll, TStall(check_time=1e9), *args, chaos=tchaos)
    assert got == want


def test_plan_drop_raises_under_strict_as_in_jax():
    for coll, chaos in ((jcoll, jchaos), (tcoll, tchaos)):
        chaos.install(chaos.FaultSchedule.parse(
            "collective.dcn group=0 action=drop"))
        try:
            with pytest.raises(ConnectionError, match="dropped"):
                coll.plan_tail_round("t", "strict", 2, 0.25)
        finally:
            chaos.uninstall()


def test_plan_feeds_every_rank_of_a_late_group():
    """The port keys straggler scores by rank: a late host's lateness
    lands on each of its ranks."""
    tchaos.install(tchaos.FaultSchedule.parse(
        "collective.dcn group=1 action=delay:0.4"))
    try:
        stall = TStall(check_time=1e9)
        tcoll.plan_tail_round("t", "bounded", 2, 0.25, stall=stall,
                              group_ranks=[[0, 1], [2, 3]])
    finally:
        tchaos.uninstall()
    assert stall.straggler_scores() == pytest.approx(
        {0: 0.0, 1: 0.0, 2: 0.1, 3: 0.1})


def test_tail_round_counts_and_records():
    from horovod_tpu_torch import metrics
    before = metrics.registry().counter(
        "hvd_tail_rounds_total", labels=("policy",)).value(policy="bounded")
    tcoll.tail_round("t", "bounded", 2, 0.0)
    assert metrics.registry().counter(
        "hvd_tail_rounds_total", labels=("policy",)).value(
            policy="bounded") == before + 1
    assert 'hvd_tail_rounds_total{policy="bounded"}' in \
        metrics.render_prometheus()
    last = tcoll.TAIL_ROUNDS[-1]
    assert (last["name"], last["policy"], last["excluded"]) == \
        ("t", "bounded", [])


def test_policy_validation_and_required_state():
    assert tcoll.TAIL_POLICIES == jcoll.TAIL_POLICIES
    with pytest.raises(ValueError, match="tail_policy"):
        tcoll.plan_tail_round("t", "lossy", 2, 0.25)
    cross = hvd.runtime.SubGroup([0, 1], None)
    with pytest.raises(ValueError, match="participation mask"):
        tcoll.tail_cross_reduce(torch.zeros(4), cross, "bounded")
    with pytest.raises(ValueError, match="state"):
        tcoll.tail_cross_reduce(torch.zeros(4), cross, "stale", [1, 1])


# ---------------------------------------------------------------------------
# signatures and tokens
# ---------------------------------------------------------------------------

class _PS:
    process_set_id = 0


def _entries(tail="bounded", op_type="allreduce", reduce_op="average"):
    je = jengine.TensorTableEntry(
        "t", op_type, [np.zeros((4,), np.float32)], _PS(),
        reduce_op=reduce_op, stacked=False, tail_policy=tail)
    te = tengine.TensorTableEntry(
        "t", op_type, [torch.zeros(4)], _PS(), reduce_op=reduce_op,
        tail_policy=tail)
    return je, te


@pytest.mark.parametrize("op_type,reduce_op", [
    ("allreduce", "average"), ("allreduce", "sum"), ("allreduce", "min"),
    ("allgather", "average")])
def test_sigs_and_token_carry_the_policy_as_jax(op_type, reduce_op):
    je, te = _entries(op_type=op_type, reduce_op=reduce_op)
    assert te.sigs()[0].tail_policy == je.sigs()[0].tail_policy
    assert tctl.entry_token(te) == jctl.entry_token(je)
    assert json.loads(tctl.entry_token(te))["s"][0][11] == (
        "bounded" if reduce_op in ("average", "sum")
        and op_type == "allreduce" else "strict")


def test_synthesize_takes_the_peers_policy():
    hvd.init(device="cpu")
    try:
        eng = hvd.runtime._state().engine
        base = ["syn", "allreduce", "average", "float32", [3], 0, False,
                -1, None, None, "none", "stale", "replicated"]
        entry = eng._synthesize(json.dumps(
            {"s": [base], "r": 0, "sp": None}, separators=(",", ":"),
            sort_keys=True))
        assert entry.tail_policy == "stale"
        assert entry.sigs()[0].tail_policy == "stale"
    finally:
        hvd.shutdown()


def test_tail_knobs_parse_as_in_jax(monkeypatch):
    import os
    from horovod_tpu import config as jconfig
    from horovod_tpu_torch import config as tconfig
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    for env in (("HOROVOD_TAIL_POLICY", "Bounded"),
                ("HOROVOD_TAIL_DEADLINE_MS", "120"),
                ("HOROVOD_TAIL_MAX_STALENESS", "2"),
                ("HOROVOD_TAIL_BLACKLIST_SCORE", "1.5")):
        monkeypatch.setenv(*env)
    assert tconfig.Config.from_env() == tconfig.Config(
        **{k: v for k, v in vars(jconfig.Config.from_env()).items()})
    monkeypatch.setenv("HOROVOD_TAIL_POLICY", "lossy")
    with pytest.raises(ValueError, match="HOROVOD_TAIL_POLICY"):
        tconfig.Config.from_env()
    assert "HOROVOD_TAIL_POLICY" not in {u[0] for u in tconfig.UNPORTED}


# ---------------------------------------------------------------------------
# the cross stage's arithmetic against tail_allreduce_p at (2, 2)
# ---------------------------------------------------------------------------

def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                             ("cross", "local"))


def jax_tail(chunks, policy, masks, prev=None, staleness=None,
             max_staleness=0):
    """Each rank's ``tail_allreduce_p`` of its chunk over the cross axis,
    ``masks[r]`` its own mask, agreed over both axes."""
    spec = P(("cross", "local"))

    def f(c, m, pv, st):
        red, new_prev, new_st = jcoll.tail_allreduce_p(
            c[0], "cross", policy, present=m[0], prev=pv[0],
            staleness=st[0], max_staleness=max_staleness,
            agree_axes=("local",))
        if new_prev is None:
            new_prev, new_st = pv[0], st[0]
        return red[None], new_prev[None], new_st[None]

    n = len(chunks)
    pv = (np.zeros((n, 2, len(chunks[0])), np.float32) if prev is None
          else np.stack(prev))
    st = (np.zeros((n, 2), np.int32) if staleness is None
          else np.stack(staleness).astype(np.int32))
    g = jax.jit(jax.shard_map(f, mesh=_mesh(), in_specs=(spec,) * 4,
                              out_specs=(spec,) * 3, check_vma=False))
    red, new_prev, new_st = g(jnp.asarray(np.stack(chunks)),
                              jnp.asarray(np.stack(masks), jnp.float32),
                              jnp.asarray(pv), jnp.asarray(st))
    return np.asarray(red), np.asarray(new_prev), np.asarray(new_st)


def _chunks():
    return [tr.hier_input(r, tr.TAIL_CHUNK, seed=41) for r in range(WORLD)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("mask", [(1, 1), (1, 0), (0, 1)])
def test_bounded_cross_stage_bit_for_bit(ranks, mask):
    want = jax_tail(_chunks(), "bounded", [mask] * WORLD)[0]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(_bits(res["tail"][f"bounded{mask}"]),
                                      _bits(want[r]))


def test_all_ones_bounded_is_strict_bit_for_bit(ranks):
    want = jax_tail(_chunks(), "strict", [(1, 1)] * WORLD)[0]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(_bits(res["tail"]["strict"]),
                                      _bits(want[r]))
        np.testing.assert_array_equal(_bits(res["tail"]["bounded(1, 1)"]),
                                      _bits(res["tail"]["strict"]))


def test_membership_agreed_when_draws_differ(ranks):
    """Rank 3 alone drew host 0 late: the allreduce-MIN excludes host 0 on
    every rank, so all sum the same contributions (JAX's pmin)."""
    masks = [(1, 1), (1, 1), (1, 1), (0, 1)]
    want = jax_tail(_chunks(), "bounded", masks)[0]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(_bits(res["tail"]["agreed"]),
                                      _bits(want[r]))
        np.testing.assert_array_equal(_bits(res["tail"]["agreed"]),
                                      _bits(res["tail"]["bounded(0, 1)"]))


def test_stale_rounds_and_cap_bit_for_bit(ranks):
    """Round 1 all present; round 2 host 1 substituted from round 1, its
    counter 1; round 3 at the cap (1): host 1 fresh again, counter 0."""
    chunks = _chunks()
    prev = staleness = None
    for i, (add, mask) in enumerate(((0.0, (1, 1)), (100.0, (1, 0)),
                                     (1000.0, (1, 0)))):
        red, prev_all, st_all = jax_tail(
            [c + np.float32(add) for c in chunks], "stale", [mask] * WORLD,
            prev=prev, staleness=staleness, max_staleness=1)
        prev, staleness = list(prev_all), list(st_all)
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(_bits(res["tail"][f"stale{i}"]),
                                          _bits(red[r]))
            assert res["tail"][f"staleness{i}"] == st_all[r].tolist()
    assert [res["tail"]["staleness1"] for res in ranks] == [[0, 1]] * WORLD


# ---------------------------------------------------------------------------
# the engine under bounded and stale, host 1 late
# ---------------------------------------------------------------------------

def _sum(k=1, hosts=(0, 1)):
    return sum(np.float32(k) * tr.quarter_input(r) for r in range(WORLD)
               if r // 2 in hosts)


def test_engine_bounded_excludes_the_late_host(ranks):
    """All on time: the plain sum; host 1 past the deadline: host 0's sum
    times n/k = 2, on every rank, the round waiting the deadline."""
    want = [_sum(), _sum(2, (0,)) * 2, _sum(3, (0,)) * 2]
    for res in ranks:
        got = res["tail"]["bounded"]
        for g, w in zip(got["results"], want):
            np.testing.assert_array_equal(g, w)
        assert got["counted"] == 3
        assert [r["excluded"] for r in got["rounds"]] == [[], [1], [1]]
        for r in got["rounds"][1:]:
            assert r["seconds"] >= tr.TAIL_DEADLINE_MS / 1000
        assert got["seconds"] >= 2 * tr.TAIL_DEADLINE_MS / 1000


def test_engine_stale_substitutes_then_waits_at_the_cap(ranks):
    """HOROVOD_TAIL_MAX_STALENESS=1: round 2 takes host 1's round-1
    contribution; round 3, at the cap, waits for host 1 (the 0.2 s delay)
    and sums fresh values."""
    want = [_sum(), _sum(2, (0,)) + _sum(1, (1,)), _sum(3)]
    for res in ranks:
        got = res["tail"]["stale"]
        for g, w in zip(got["results"], want):
            np.testing.assert_array_equal(g, w)
        assert got["counted"] == 3
        assert [r["excluded"] for r in got["rounds"]] == [[], [1], []]
        assert got["rounds"][2]["seconds"] >= tr.TAIL_DELAY_S


@pytest.mark.parametrize("policy", ["bounded", "stale"])
def test_late_host_scores_above_the_on_time_one(ranks, policy):
    for res in ranks:
        scores = res["tail"][policy]["scores"]
        assert min(scores[2], scores[3]) > max(scores[0], scores[1])
