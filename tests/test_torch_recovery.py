"""The port's checkpointless recovery against the JAX package's.

Every case of ``tests/test_recovery.py`` on ``horovod_tpu_torch``: the
frame codec, xor and parity groups, the tile store's epoch, newest-wins,
history and duplicate rules, neighbor and parity rebuilds over real RPC,
the kill-mid-push requeue, a stale push dropped, the cadence, the
transform's tap and restore, the serving pre-warm, the driver's
directory, and the e2e SIGKILL under the port's ``ElasticDriver``.  Then
what is new here: the two packages' frames byte for byte on the same
payloads, their parity groups over a grid, the refusals of the restore,
and the tap at world 2 on gloo rank processes (``tests/torch_ranks.py``
``recovery``), where a fresh ``init`` plus ``restore_dist_state`` of the
pulled frame makes the next update bit-identical to the uninterrupted
one.
"""

import functools
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _helpers import free_port

import horovod_tpu_torch as tp
import horovod_tpu_torch.chaos as _chaos
from horovod_tpu.elastic import recovery as J
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch.elastic import discovery
from horovod_tpu_torch.elastic import recovery as R
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.metrics import aggregate
from horovod_tpu_torch.optim import recovery_payload, restore_dist_state
from horovod_tpu_torch.runner.rpc import JsonRpcServer

import torch_ranks


@pytest.fixture(scope="module")
def port():
    tp.init(device="cpu")
    yield tp
    tp.shutdown()


# --- frame codec ------------------------------------------------------------

def _payload():
    return {
        "count": np.int64(7),                       # 0-d scalar
        "inner/0": np.linspace(-3, 3, 17, dtype=np.float32),
        "inner/1": np.arange(12, dtype=np.int32).reshape(3, 4),
        "residual/0": np.array([], dtype=np.float32),  # empty is legal
        "weird": np.frombuffer(b"\x00\x80\x7f\xff", np.uint8),
    }


def test_frame_codec_roundtrip_bit_exact():
    payload = _payload()
    frame = R.encode_frame(payload)
    out = R.decode_frame(frame)
    assert sorted(out) == sorted(payload)
    for name, arr in payload.items():
        got = out[name]
        assert got.dtype == np.asarray(arr).dtype, name
        assert got.shape == np.asarray(arr).shape, name
        assert got.tobytes() == np.asarray(arr).tobytes(), name
    # deterministic: same payload -> same bytes
    assert R.encode_frame(payload) == frame


def test_frame_codec_noncontiguous_input():
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    view = base[:, ::2]                              # non-contiguous
    out = R.decode_frame(R.encode_frame({"v": view}))
    np.testing.assert_array_equal(out["v"], view)
    assert out["v"].shape == view.shape


def test_frame_codec_truncation_raises():
    frame = R.encode_frame({"a": np.ones(8, np.float32)})
    with pytest.raises(ValueError):
        R.decode_frame(frame[:-4])
    with pytest.raises(ValueError):
        R.decode_frame(b"\x00\x01")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_are_byte_identical_to_jax(seed):
    """The same payload encodes to the same bytes in both packages, and
    each decodes the other's frame bit for bit: a frame pushed by one
    package's worker rebuilds in the other's."""
    rng = np.random.default_rng(seed)
    payload = dict(_payload())
    payload.update({
        f"inner/{i}/exp_avg": rng.standard_normal(
            int(rng.integers(1, 64))).astype(np.float32) for i in range(3)})
    payload["inner/9/mu"] = rng.integers(
        0, 2 ** 16, 11, dtype=np.uint16).view(np.dtype("V2"))
    frame = R.encode_frame(payload)
    assert frame == J.encode_frame(payload)
    a, b = R.decode_frame(frame), J.decode_frame(frame)
    assert sorted(a) == sorted(b) == sorted(payload)
    for n in a:
        assert a[n].dtype == b[n].dtype and a[n].shape == b[n].shape
        assert a[n].tobytes() == b[n].tobytes(), n


def test_xor_bytes_pads_and_inverts():
    a, b = b"\x01\x02\x03\x04", b"\xff\x00"
    x = R.xor_bytes(a, b)
    assert len(x) == 4
    assert R.xor_bytes(x, b)[: len(a)] == a
    assert R.xor_bytes(a, a) == b"\x00" * 4
    assert x == J.xor_bytes(a, b)


def test_parity_group_math():
    # 8 ranks, groups of 4: holder is the rank past the group's end
    assert R.parity_group(1, 8, 4) == (0, 4, [0, 1, 2, 3])
    assert R.parity_group(6, 8, 4) == (1, 0, [4, 5, 6, 7])
    # one group spans the fleet: the holder wraps into its own group
    # and is excluded from the member set (it cannot protect itself)
    g, holder, members = R.parity_group(2, 4, 4)
    assert (g, holder) == (0, 0)
    assert members == [1, 2, 3]
    with pytest.raises(ValueError):
        R.parity_group(0, 4, 1)


def test_parity_group_agrees_with_jax_over_a_grid():
    for size in range(1, 13):
        for group in range(2, 9):
            for rank in range(size):
                assert R.parity_group(rank, size, group) == \
                    J.parity_group(rank, size, group), (rank, size, group)


def test_priced_tile_bytes_matches_layout(hvd):
    from horovod_tpu.optim.distributed import sharded_tile_layout as jlayout

    from horovod_tpu_torch.optim.distributed import sharded_tile_layout
    tree = {"w": torch.empty((1024,), device="meta"),
            "b": torch.empty((64,), device="meta")}
    layout = sharded_tile_layout(tree, shards=4)
    per_copy = R.priced_tile_bytes(layout)
    assert per_copy == sum(int(b.shard_numel)
                           for b in layout.buckets) * 4
    # Adam m+v plus error-feedback residuals = 3 protected copies
    assert R.priced_tile_bytes(layout, state_copies=3) == 3 * per_copy
    jtree = {"w": np.zeros((1024,), np.float32),
             "b": np.zeros((64,), np.float32)}
    assert per_copy == J.priced_tile_bytes(jlayout(jtree, shards=4))


# --- tile store versioning --------------------------------------------------

def test_store_refuses_stale_epoch():
    st = R.TileStore()
    assert st.put_own((0, 5), b"x")
    st.set_min_epoch(1)
    assert not st.put_own((0, 6), b"y")            # stale epoch refused
    assert not st.put_replica(3, (0, 6), b"y")
    assert not st.put_parity_member(0, 1, (0, 6), b"y", [1, 2])
    assert st.put_own((1, 0), b"z")
    # watermark only rises
    st.set_min_epoch(0)
    assert st.stats()["min_epoch"] == 1


def test_store_replica_newest_wins():
    st = R.TileStore()
    assert st.put_replica(2, (0, 4), b"new")
    assert not st.put_replica(2, (0, 3), b"older")  # late duplicate
    assert not st.put_replica(2, (0, 4), b"same")
    assert st.get_replica(2) == ((0, 4), b"new")
    assert st.put_replica(2, (1, 0), b"fresh")      # epoch bump wins
    assert st.get_replica(2, min_epoch=1) == ((1, 0), b"fresh")
    st.drop_sources([2])
    assert st.get_replica(2) is None


def test_store_own_history_bounded():
    st = R.TileStore(history=2)
    for s in range(4):
        st.put_own((0, s), bytes([s]))
    assert st.get_own((0, 0)) is None               # evicted
    assert st.get_own() == ((0, 3), b"\x03")        # newest
    assert st.get_own((0, 2)) == ((0, 2), b"\x02")
    assert R.OWN_HISTORY == J.OWN_HISTORY == 4


def test_store_parity_accumulates_and_refuses_duplicates():
    st = R.TileStore()
    f1, f2 = b"\x01\x02\x03", b"\x10\x20"
    assert st.put_parity_member(0, 1, (0, 2), f1, [1, 2])
    assert st.get_parity(0) is None                 # incomplete
    assert not st.put_parity_member(0, 1, (0, 2), f1, [1, 2])  # dup
    assert st.put_parity_member(0, 2, (0, 2), f2, [1, 2])
    acc = st.get_parity(0)
    assert acc["version"] == (0, 2)
    assert acc["members"] == [1, 2]
    assert acc["blob"] == R.xor_bytes(f1, f2)
    # XOR of the blob with the survivor's frame recovers the lost one
    lost = R.xor_bytes(acc["blob"], f2)[: acc["lengths"][1]]
    assert lost == f1


# --- in-process fleets over real RPC ----------------------------------------

def _mk_fleet(size, mode, mod=R, **kw):
    """``size`` agents of package ``mod`` wired over real loopback
    JsonRpcServers."""
    agents, servers = [], []
    server = (JsonRpcServer if mod is R else
              __import__("horovod_tpu.runner.rpc",
                         fromlist=["JsonRpcServer"]).JsonRpcServer)
    for r in range(size):
        a = mod.RecoveryAgent(rank=r, size=size, mode=mode, every=1,
                              pull_deadline_s=5.0, register=False, **kw)
        agents.append(a)
        servers.append(server(a.worker_handlers(), secret=None))
    peers = {r: ("127.0.0.1", s.port) for r, s in enumerate(servers)}
    for a in agents:
        a.update_plan(0, peers)
    return agents, servers


def _close_fleet(servers):
    for s in servers:
        s.close()


def _state(rank, step, n=32):
    """Deterministic per-(rank, step) fp32 state: the 'uninterrupted
    run' oracle the rebuilt frame must match bit for bit."""
    v = np.full((n,), np.float32(rank + 1))
    for s in range(step + 1):
        v = (v * np.float32(1.25) + np.float32(s)).astype(np.float32)
    return v


def test_neighbor_rebuild_bit_exact_vs_uninterrupted():
    agents, servers = _mk_fleet(2, "neighbor")
    try:
        for step in range(3):
            for a in agents:
                assert a.note_boundary(
                    step, {"state": _state(a.rank, step),
                           "count": np.int64(step)})
        # rank 1 dies; a fresh process (empty store) takes its place
        fresh = R.RecoveryAgent(rank=1, size=2, mode="neighbor", every=1,
                                pull_deadline_s=5.0, register=False)
        fresh.update_plan(0, {0: ("127.0.0.1", servers[0].port)},
                          size=2)
        got = fresh.rebuild(min_epoch=0)
        assert fresh.last_rebuild["version"] == [0, 2]
        ref = _state(1, 2)
        assert got["state"].dtype == ref.dtype
        assert got["state"].tobytes() == ref.tobytes()
        assert int(got["count"]) == 2
        assert got["count"].shape == ()              # 0-d survives
    finally:
        _close_fleet(servers)


@pytest.mark.parametrize("lost", [1, 2, 3])
def test_parity_rebuild_bit_exact_vs_uninterrupted(lost):
    """4 ranks, one whole-fleet group: holder 0 accumulates XOR of 1..3;
    the lost member comes back bit for bit, and the holder's blob is the
    JAX package's for the same frames."""
    agents, servers = _mk_fleet(4, "parity", parity_group_size=4)
    jagents, jservers = _mk_fleet(4, "parity", mod=J, parity_group_size=4)
    try:
        for step in range(2):
            for a in agents + jagents:
                a.note_boundary(step, {"state": _state(a.rank, step)})
        # the holder keeps ONE parity blob, not the member frames
        held = agents[0].store.stats()
        assert held["parity_complete"] >= 1
        assert held["replicas"] == {}
        assert agents[0].store.get_parity(0) == \
            jagents[0].store.get_parity(0)
        # rank ``lost`` dies; replacement XOR-reconstructs from holder +
        # peers
        fresh = R.RecoveryAgent(rank=lost, size=4, mode="parity", every=1,
                                parity_group_size=4, pull_deadline_s=5.0,
                                register=False)
        fresh.update_plan(
            0, {r: ("127.0.0.1", s.port)
                for r, s in enumerate(servers) if r != lost}, size=4)
        got = fresh.rebuild(min_epoch=0)
        ref = _state(lost, 1)
        assert got["state"].tobytes() == ref.tobytes()
        assert fresh.last_rebuild["source"] == "parity"
        assert fresh.last_rebuild["version"] == [0, 1]
    finally:
        _close_fleet(servers)
        _close_fleet(jservers)


def test_parity_holder_in_own_group_is_unprotected():
    agents, servers = _mk_fleet(4, "parity", parity_group_size=4)
    try:
        for a in agents:
            a.note_boundary(0, {"state": _state(a.rank, 0)})
        fresh = R.RecoveryAgent(rank=0, size=4, mode="parity", every=1,
                                parity_group_size=4,
                                pull_deadline_s=0.5, register=False)
        fresh.update_plan(0, {r: ("127.0.0.1", s.port)
                              for r, s in enumerate(servers) if r != 0},
                          size=4)
        with pytest.raises(TimeoutError):
            fresh.rebuild(min_epoch=0)
    finally:
        _close_fleet(servers)


def test_kill_mid_push_requeues_and_retries():
    agents, servers = _mk_fleet(2, "neighbor")
    try:
        _chaos.install(_chaos.FaultSchedule.parse(
            "recovery.push rank=0 nth=1 action=error:mid-push kill",
            seed=7))
        try:
            ok = agents[0].note_boundary(
                0, {"state": _state(0, 0)})
        finally:
            _chaos.uninstall()
        assert not ok
        assert agents[0].stats()["pending"] == [0, 0]    # still queued
        assert agents[1].store.get_replica(0) is None    # never landed
        # next flush (chaos gone = transport recovered) delivers it
        assert agents[0].flush()
        assert agents[0].stats()["pending"] is None
        assert agents[1].store.get_replica(0)[0] == (0, 0)
    finally:
        _close_fleet(servers)


def test_stale_push_dropped_not_retried():
    agents, servers = _mk_fleet(2, "neighbor")
    try:
        agents[1].store.set_min_epoch(2)      # holder moved on
        assert agents[0].note_boundary(0, {"state": _state(0, 0)})
        # the holder refused it as stale and the pusher dropped it
        # (retrying garbage forever would wedge the pending slot)
        assert agents[0].stats()["pending"] is None
        assert agents[1].store.get_replica(0) is None
    finally:
        _close_fleet(servers)


def test_cadence_gates_pushes():
    agents, servers = _mk_fleet(2, "neighbor")
    try:
        agents[0].every = 3
        sent = [agents[0].note_boundary(s, {"s": _state(0, s)})
                for s in range(7)]
        assert sent == [True, False, False, True, False, False, True]
        assert agents[1].store.get_replica(0)[0] == (0, 6)
    finally:
        _close_fleet(servers)


# --- optimizer-state tap + restore ------------------------------------------

def _adam(lr=1e-2):
    return functools.partial(torch.optim.Adam, lr=lr)


def test_transform_tap_rebuild_restore_bit_exact(port):
    """The full producer/consumer loop on a real transform: a recovering
    transform's tap pushes at each accumulation boundary; after the
    'loss', the rebuilt+restored state equals an uninterrupted twin's
    bit for bit (same grads -> same state; acc re-zeroed), and so does
    the next update."""
    agents, servers = _mk_fleet(2, "neighbor")
    R.install(agents[0])                  # tap routes through registry
    try:
        def params():
            return {"w": torch.linspace(-1.0, 1.0, 8)}

        p_rec, p_ref = params(), params()
        tx_rec = tp.DistributedGradientTransform(
            _adam(), backward_passes_per_step=2, recovery=agents[0],
            wire_format="none")
        st_rec = tx_rec.init(p_rec)
        tx_ref = tp.DistributedGradientTransform(
            _adam(), backward_passes_per_step=2, wire_format="none")
        st_ref = tx_ref.init(p_ref)
        rng = np.random.default_rng(17)
        for _ in range(4):                # 4 micro-steps = 2 boundaries
            g = torch.from_numpy(rng.normal(size=8).astype(np.float32))
            tx_rec.update({"w": g.clone()}, st_rec, p_rec)
            tx_ref.update({"w": g.clone()}, st_ref, p_ref)
        # the fleet now holds rank 0's boundary-2 frame on rank 1
        assert agents[1].store.get_replica(0)[0] == (0, 2)
        fresh = R.RecoveryAgent(rank=0, size=2, mode="neighbor", every=1,
                                pull_deadline_s=5.0, register=False)
        fresh.update_plan(0, {1: ("127.0.0.1", servers[1].port)},
                          size=2)
        payload = fresh.rebuild(min_epoch=0)
        p_new = {"w": p_ref["w"].clone()}
        st_new = restore_dist_state(tx_ref.init(p_new), payload)
        want = recovery_payload(st_ref)
        got = recovery_payload(st_new)
        assert sorted(got) == sorted(want)
        assert "inner/0/exp_avg" in got and int(got["count"]) == 4
        for name in want:
            assert got[name].tobytes() == want[name].tobytes(), name
        for _ in range(2):
            g = torch.from_numpy(rng.normal(size=8).astype(np.float32))
            tx_ref.update({"w": g.clone()}, st_new, p_new)
            tx_ref.update({"w": g.clone()}, st_ref, p_ref)
        assert torch.equal(p_new["w"], p_ref["w"])
    finally:
        R.uninstall(agents[0])
        _close_fleet(servers)


def test_tap_cadence_counts_boundaries_not_micro_steps(port):
    """k = 1 advances ``count`` with the tap armed (the JAX transform's
    rule) and ``every = 2`` pushes boundaries 2 and 4 only; off-cadence
    boundaries deliver nothing."""
    agents, servers = _mk_fleet(2, "neighbor")
    agents[0].every = 2
    R.install(agents[0])
    seen = []
    note = agents[0].note_boundary
    agents[0].note_boundary = lambda step, payload, rank=None: (
        seen.append(step), note(step, payload, rank=rank))[1]
    try:
        p = {"w": torch.zeros(4)}
        tx = tp.DistributedGradientTransform(
            functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
            recovery=agents[0], wire_format="none")
        st = tx.init(p)
        for _ in range(5):
            tx.update({"w": torch.ones(4)}, st, p)
        assert st.count == 5 and seen == [2, 4]
        assert agents[1].store.get_replica(0)[0] == (0, 4)
    finally:
        R.uninstall(agents[0])
        _close_fleet(servers)


def test_restore_rejects_layout_mismatch(port):
    tx = tp.DistributedGradientTransform(_adam(), wire_format="none")
    p = {"w": torch.zeros((8,))}
    st = tx.init(p)
    tx.update({"w": torch.ones(8)}, st, p)
    payload = recovery_payload(st)
    payload["inner/0/exp_avg"] = np.zeros((4,), np.float32)  # wrong shape
    with pytest.raises(ValueError, match="replacement-at-same-size"):
        restore_dist_state(tx.init({"w": torch.zeros((8,))}), payload)


@pytest.mark.parametrize("edit", ["missing", "dtype", "count"])
def test_restore_refuses_a_missing_key_or_a_dtype(port, edit):
    tx = tp.DistributedGradientTransform(
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        wire_format="none")
    p = {"w": torch.zeros((8,))}
    st = tx.init(p)
    tx.update({"w": torch.ones(8)}, st, p)
    payload = recovery_payload(st)
    if edit == "missing":
        del payload["inner/0/momentum_buffer"]
        match = "missing inner/0/momentum_buffer"
    elif edit == "dtype":
        payload["inner/0/momentum_buffer"] = payload[
            "inner/0/momentum_buffer"].astype(np.float64)
        match = "replacement-at-same-size"
    else:
        del payload["count"]
        match = "step counter"
    with pytest.raises(ValueError, match=match):
        restore_dist_state(tx.init({"w": torch.zeros((8,))}), payload)


def test_recovery_refuses_overlap(port):
    agent = R.RecoveryAgent(rank=0, size=2, mode="neighbor", every=1,
                            register=False)
    with pytest.raises(ValueError, match="overlap=True"):
        tp.DistributedGradientTransform(
            _adam(), overlap=True, recovery=agent, wire_format="none")


def test_bf16_state_travels_as_raw_bytes(port):
    """bfloat16 moments have no numpy dtype: the payload carries their
    bytes (``V2``) and the restore puts the same bits back."""
    from horovod_tpu_torch.optim.precision import adamw_lp
    tx = tp.DistributedGradientTransform(adamw_lp(1e-2), wire_format="none")
    p = {"w": torch.linspace(-1, 1, 6)}
    st = tx.init(p)
    tx.update({"w": torch.linspace(0.5, -0.5, 6)}, st, p)
    payload = recovery_payload(st)
    assert payload["inner/0/mu"].dtype == np.dtype("V2")
    assert int(payload["inner/0/count"]) == 1
    got = restore_dist_state(tx.init({"w": p["w"].clone()}),
                             R.decode_frame(R.encode_frame(payload)))
    mu = got.inner.state[got.inner.param_groups[0]["params"][0]]["mu"]
    assert mu.dtype == torch.bfloat16
    assert torch.equal(mu.view(torch.int16),
                       st.inner.state[p["w"]]["mu"].view(torch.int16))


# --- serving pre-warm on rejoin ---------------------------------------------

def test_rejoin_prewarm_zero_post_rejoin_recompiles():
    """A rejoining serving worker passes its bucket-table warmup as the
    rebuild prewarm hook: every admitted shape is prepared inside
    ``rebuild()``, so post-rejoin traffic hits zero fresh ones."""
    from horovod_tpu_torch.serving.models import toy_echo_forward
    from horovod_tpu_torch.serving.shapes import ShapeBuckets

    agents, servers = _mk_fleet(2, "neighbor")
    try:
        agents[1].note_boundary(0, {"state": _state(1, 0)})
        buckets = ShapeBuckets(batch_buckets=(1, 2), seq_buckets=(8, 16))
        fwd = toy_echo_forward(buckets, burn_dim=8, burn_iters=1,
                               device="cpu")
        fresh = R.RecoveryAgent(rank=1, size=2, mode="neighbor", every=1,
                                pull_deadline_s=5.0, register=False)
        fresh.update_plan(0, {0: ("127.0.0.1", servers[0].port)},
                          size=2)
        fresh.rebuild(min_epoch=0, prewarm=fwd.warmup)
        warm = fwd.compiles
        assert warm == 4                     # every bucket prepared
        for b in buckets.batch_buckets:      # taking traffic: none again
            for s in buckets.seq_buckets:
                fwd(np.zeros((b, s), np.int32), np.ones((b,), np.int32))
        assert fwd.compiles == warm
        assert fwd.recompiles == 0
    finally:
        _close_fleet(servers)


# --- driver-side directory --------------------------------------------------

def test_directory_tracks_and_prunes():
    for mod in (R, J):
        d = mod.RecoveryDirectory()
        d.note({"kind": "push", "src_worker": 1, "src_rank": 1,
                "holder_worker": 2, "holder_rank": 2, "epoch": 0,
                "step": 4, "bytes": 128, "mode": "neighbor"})
        d.note({"kind": "push", "src_worker": 2, "src_rank": 2,
                "holder_worker": 1, "holder_rank": 1, "epoch": 0,
                "step": 4, "bytes": 64, "mode": "neighbor"})
        st = d.stats()
        assert st["protected_workers"] == [1, 2]
        assert st["protected_bytes"] == 192
        # worker 2 leaves: entries where it is source OR holder go away
        d.worker_gone(2)
        st = d.stats()
        assert st["protected_workers"] == []
        d.note({"kind": "rebuilt", "src_worker": 3, "src_rank": 1,
                "holder_worker": 0, "holder_rank": 0, "epoch": 1,
                "step": 4, "bytes": 128, "mode": "neighbor",
                "source": "neighbor", "seconds": 0.2})
        assert d.stats()["rebuilds"][-1]["src_worker"] == 3
        assert d.retain_workers([0]) == 0


def test_recovery_knob_parses_as_in_jax(monkeypatch):
    """HOROVOD_RECOVERY* parse and validate as the JAX package's config
    does, and the knob no longer raises."""
    import dataclasses
    import re

    from horovod_tpu import config as jconfig
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    assert "HOROVOD_RECOVERY" not in {u[0] for u in tconfig.UNPORTED}
    for env, values in (("HOROVOD_RECOVERY", ["neighbor", "PARITY ",
                                              "off", "", "raid5"]),
                        ("HOROVOD_RECOVERY_EVERY", ["4", "0"]),
                        ("HOROVOD_RECOVERY_PARITY_GROUP", ["3", "1"]),
                        ("HOROVOD_RECOVERY_PULL_DEADLINE_S", ["2.5", "0"])):
        for v in values:
            monkeypatch.setenv(env, v)
            try:
                want = dataclasses.asdict(jconfig.Config.from_env())
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    tconfig.Config.from_env()
                continue
            assert dataclasses.asdict(tconfig.Config.from_env()) == want
        monkeypatch.delenv(env)


# --- world 2 on gloo rank processes -----------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.launch(2, ["recovery"],
                              tmp_path_factory.mktemp("recovery"),
                              timeout=240)


@pytest.mark.parametrize("variant", ["sgd", "adamw_lp_int8_k2"])
def test_tap_restore_at_world_2_on_gloo_ranks(ranks, variant):
    """Each rank pushes its ZeRO tile to its ring neighbor at every
    boundary; a fresh agent of the same rank pulls it back, a fresh
    ``init`` plus ``restore_dist_state`` installs it, and the next
    update's weights and state equal the uninterrupted transform's bit
    for bit on both ranks; the tiles differ between the ranks."""
    res = [r["recovery"][variant] for r in ranks]
    for rank, r in enumerate(res):
        assert r["version"] == [0, r["boundaries"]], (rank, r)
        # the frame's counter: the micro-steps taken (k = 1 counts with
        # the tap armed)
        assert r["count"][0] == r["boundaries"] * (
            1 if variant == "sgd" else 2)
        assert r["restored_equal"] and r["next_params_equal"], (rank, r)
        assert r["next_state_equal"], (rank, r)
        assert r["nonzero"], (rank, r)
    assert res[0]["tile"] != res[1]["tile"]
    if variant != "sgd":
        assert any(n.startswith("residual/") for n in res[0]["names"])


def test_tensor_state_sync_keeps_each_ranks_tile(ranks):
    """A TensorState holding the transform's state syncs the weights and
    the step from rank 0 and leaves every rank's tile its own (a
    broadcast would hand rank 1 rank 0's rows)."""
    res = [r["recovery"]["sync"] for r in ranks]
    assert res[0]["params"] == res[1]["params"]
    assert all(r["tile_kept"] and r["dist_is_live"] for r in res)
    assert [r["step"] for r in res] == [0, 0]


# --- e2e: real driver, real processes, pinned SIGKILL seed ------------------

RECOVERY_WORKER = r"""
import json, os, sys, threading, time
import numpy as np
import horovod_tpu_torch.chaos as _chaos
from horovod_tpu_torch.elastic import worker as ew
from horovod_tpu_torch.elastic.recovery import RecoveryAgent
from horovod_tpu_torch.elastic.worker import WorkerNotificationManager

TOTAL = int(os.environ["TEST_TOTAL_STEPS"])
OUT = os.environ["TEST_OUT"]
DONE = OUT + ".rebuilt.json"


def ref_state(rank, step):
    v = np.full((64,), np.float32(rank + 1))
    for s in range(step + 1):
        v = (v * np.float32(1.25) + np.float32(s)).astype(np.float32)
    return v


mgr = WorkerNotificationManager()
mgr.init()
asg = ew.fetch_assignment(min_epoch=0, timeout=120)
rank, size, epoch = asg["rank"], asg["size"], asg["epoch"]
if epoch > 0:
    # replacement incarnations inherit HVD_CHAOS through the spawn env;
    # the pinned seed belongs to the original fleet only
    _chaos.uninstall()
agent = RecoveryAgent(rank=rank, size=size, epoch=epoch,
                      mode="neighbor", every=1, pull_deadline_s=60.0,
                      driver=ew._driver_endpoint(),
                      worker_id=ew.worker_id())

# wait until the driver's plan names every peer's notification endpoint
deadline = time.monotonic() + 90
while True:
    try:
        agent._fetch_plan()
    except Exception:
        pass
    with agent._lock:
        n = len(agent._peers)
    if n >= size:
        break
    if time.monotonic() > deadline:
        sys.exit(3)
    time.sleep(0.2)
ew.record_running()


def _ack_reforms():
    # keep satisfying the driver's epoch release gate (every member must
    # poll each new epoch) and refresh the peer plan across re-forms
    while True:
        try:
            ew.fetch_assignment(timeout=600)
            agent._fetch_plan()
        except Exception:
            return


threading.Thread(target=_ack_reforms, daemon=True).start()

if epoch > 0:
    payload = agent.rebuild(min_epoch=0)
    with open(DONE + ".tmp", "w") as f:
        json.dump({"rank": rank, "epoch": agent.last_rebuild["version"][0],
                   "step": agent.last_rebuild["version"][1],
                   "seconds": agent.last_rebuild["seconds"],
                   "dtype": payload["state"].dtype.str,
                   "state_hex": payload["state"].tobytes().hex()}, f)
    os.replace(DONE + ".tmp", DONE)
else:
    for step in range(TOTAL):
        agent.note_boundary(step, {"state": ref_state(rank, step),
                                   "count": np.int64(step)})
        time.sleep(0.25)

# linger so the survivor's store can serve the replacement's pull, and
# keep the notification/metrics endpoint up until the test finished its
# scrapes (it touches the release file when done)
deadline = time.monotonic() + 120
while not os.path.exists(DONE) and time.monotonic() < deadline:
    time.sleep(0.2)
release = OUT + ".release"
while not os.path.exists(release) and time.monotonic() < deadline:
    time.sleep(0.2)
mgr.close()
"""


def _families(driver, wid):
    """A worker's own metric families, from GET /metrics on its
    notification endpoint (the job-level merge is A9's)."""
    with driver._lock:
        addr, port_ = driver._notif[wid]
    return aggregate.parse_prometheus(aggregate.scrape(addr, port_))


def test_recovery_e2e_sigkill_seed(tmp_path):
    """The acceptance scenario: 2 workers under the port's elastic
    driver, a pinned chaos seed SIGKILLs rank 1 on its 3rd push; the
    driver re-forms, the respawned replacement pulls rank 1's frame from
    the survivor and its rebuilt state is bit-identical to the
    uninterrupted oracle.  The replacement's recovery time and the
    survivor's (non-lethal) injection counter ride the workers' own
    GET /metrics; the driver lists the rebuild at GET /recovery/stats."""
    hostfile = tmp_path / "hosts.txt"
    hostfile.write_text("localhost:2\n")
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(RECOVERY_WORKER)
    out_base = tmp_path / "out"
    done = Path(str(out_base) + ".rebuilt.json")

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        "TEST_TOTAL_STEPS": "8",
        "TEST_OUT": str(out_base),
        "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        # pinned seed: kill rank 1 on its 3rd push (exit code 9 =
        # SIGKILL's code); the rank-0 delay rule is the liveness probe —
        # its injection counter proves the schedule was not inert
        "HVD_CHAOS": ("recovery.push rank=1 nth=3 action=crash:9;"
                      "recovery.push rank=0 nth=1 action=delay:0.01"),
        "HVD_CHAOS_SEED": "17",
    }
    driver = ElasticDriver(
        discovery.HostDiscoveryScript(f"cat {hostfile}"),
        [sys.executable, str(worker_py)],
        min_np=2, port=free_port(), discovery_interval=0.3,
        start_timeout=60.0, blacklist_threshold=8, env=env)

    rc = {}
    t = threading.Thread(target=lambda: rc.update(code=driver.run()),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 240
        i, _ = driver.wait_event(
            "epoch_formed", timeout=deadline - time.monotonic(),
            match=lambda e: e["size"] == 2)
        # the pinned crash: some worker exits with the seed's code
        _, exit_info = driver.wait_event(
            "worker_exit", timeout=deadline - time.monotonic(),
            match=lambda e: e["rc"] == 9, since=i + 1)
        assert exit_info["kind"] == "failure"
        # re-form + fleet rebuild of the lost worker's state
        _, rb = driver.wait_event(
            "worker_rebuilt", timeout=deadline - time.monotonic())
        while not done.exists() and time.monotonic() < deadline:
            time.sleep(0.2)
        rebuilt = json.loads(done.read_text())
        assert rebuilt["rank"] == 1
        assert rebuilt["epoch"] == 0          # frame from the old epoch
        ref = np.full((64,), np.float32(2))
        for s in range(rebuilt["step"] + 1):
            ref = (ref * np.float32(1.25) + np.float32(s)) \
                .astype(np.float32)
        assert rebuilt["dtype"] == ref.dtype.str
        assert rebuilt["state_hex"] == ref.tobytes().hex()
        assert rb["source"] == "neighbor" and rb["rank"] == 1

        # recovery time on the replacement, the live seed on the survivor
        fams = _families(driver, rb["worker_id"])
        rt = sum(v for n, _, v
                 in fams["hvd_recovery_time_seconds"]["samples"]
                 if n.endswith("_count"))
        assert rt >= 1, fams["hvd_recovery_time_seconds"]["samples"]
        assert "hvd_recovery_rebuilds_total" in fams
        survivor = next(w for w in driver._notif if w != rb["worker_id"])
        fams = _families(driver, survivor)
        inj = sum(v for _, lbl, v
                  in fams["hvd_chaos_injections_total"]["samples"]
                  if lbl.get("site") == "recovery.push"
                  and lbl.get("action") == "delay")
        assert inj >= 1, fams["hvd_chaos_injections_total"]["samples"]
        assert "hvd_recovery_snapshots_total" in fams

        # driver directory: the rebuild is on GET /recovery/stats
        rstats = json.loads(aggregate.scrape(
            "127.0.0.1", driver.port, route="recovery/stats"))
        assert any(r["src_rank"] == 1 for r in rstats["rebuilds"]), rstats

        # scrapes done: let the lingering workers exit
        Path(str(out_base) + ".release").touch()
        t.join(timeout=max(10.0, deadline - time.monotonic()))
        assert not t.is_alive(), "driver did not finish"
        assert rc.get("code") == 0, rc
    finally:
        driver._terminate_all()
        driver._server.close()
