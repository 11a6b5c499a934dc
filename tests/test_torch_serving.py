"""The port's serving plane against the JAX package's (tests/test_serving.py).

Shape buckets, plan_fusion-backed admission, the RPC data path, lease
requeue, straggler rotation, the no-recompile accounting, the
hvd_serve_* metric families and the config knobs, each replayed on
``horovod_tpu_torch``'s copy; then the toy echo forward end to end
through a real ``JsonRpcServer``, ``ServingWorker`` and ``ServingPlane``,
and the transport's HMAC signing, metrics registry and chaos schedules
beside the JAX package's.  Left out, and listed in ROADMAP.md: the
elastic driver's ``attach_serving`` (A8) and the pinned hvdsched
schedule (A9).

Every server binds an ephemeral loopback port and closes in a
``finally``; every wait on a socket or thread has its own timeout.
"""

import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.serving.admission import AdmissionQueue, ServeRequest
from horovod_tpu_torch.serving.shapes import (ShapeBuckets, parse_buckets,
                                              parse_mp_axes)

CPU = torch.device("cpu")


def _req(rid, n_tokens, arrival=None, deadline=None):
    return ServeRequest(id=rid,
                        tokens=np.arange(n_tokens, dtype=np.int32),
                        arrival=(time.monotonic() if arrival is None
                                 else arrival),
                        deadline=deadline, seq_bucket=0)


# -- shape buckets ------------------------------------------------------------

def test_shape_bucket_selection_and_overflow():
    b = ShapeBuckets(batch_buckets=(1, 2, 4), seq_buckets=(8, 32))
    assert b.seq_bucket(1) == 8 and b.seq_bucket(8) == 8
    assert b.seq_bucket(9) == 32
    assert b.batch_bucket(3) == 4
    assert b.bucket(3, 9).key == "b4xs32"
    assert len(b) == 6
    with pytest.raises(ValueError, match="largest seq bucket"):
        b.seq_bucket(33)


def test_shape_bucket_padding():
    b = ShapeBuckets(batch_buckets=(1, 2, 4), seq_buckets=(8,))
    rows = [np.array([1, 2, 3], np.int32), np.array([7], np.int32),
            np.array([], np.int32)]
    tokens, lengths = b.pad_batch(rows, 8)
    assert tokens.shape == (4, 8)
    assert list(tokens[0][:3]) == [1, 2, 3] and tokens[0][3:].sum() == 0
    assert list(lengths) == [3, 1, 1, 1]


@pytest.mark.parametrize("spec,ok", [
    ("1, 2,8", (1, 2, 8)), ("", None), ("0", None), ("2,2", None),
    ("8,4", None), ("a,b", None)])
def test_parse_buckets_grammar_matches_jax(spec, ok):
    from horovod_tpu.serving.shapes import parse_buckets as jparse
    if ok is None:
        with pytest.raises(ValueError):
            parse_buckets(spec, "x")
        with pytest.raises(ValueError):
            jparse(spec, "x")
    else:
        assert parse_buckets(spec, "x") == jparse(spec, "x") == ok


@pytest.mark.parametrize("spec", ["", "model:2", " m : 4 ", "a,b:2", "m",
                                  "m:x", "m:1"])
def test_parse_mp_axes_matches_jax(spec):
    from horovod_tpu.serving.shapes import parse_mp_axes as jparse
    try:
        want = jparse(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            parse_mp_axes(spec)
    else:
        assert parse_mp_axes(spec) == want


# -- admission queue (the engine planner, reused) -----------------------------

def test_admission_caps_batches_and_separates_seq_classes():
    b = ShapeBuckets(batch_buckets=(1, 2, 4), seq_buckets=(8, 32))
    q = AdmissionQueue(b, tick_s=0.0, max_batch=4)
    for i in range(6):
        q.submit(_req(f"s{i}", 5))
    for i in range(3):
        q.submit(_req(f"l{i}", 20))
    batches = []
    while True:
        batch = q.take()
        if batch is None:
            break
        batches.append(batch)
    sizes = [(bt.seq_bucket, len(bt.requests)) for bt in batches]
    assert sorted(sizes) == [(8, 2), (8, 4), (32, 3)]
    for bt in batches:
        assert len({r.seq_bucket for r in bt.requests}) == 1
    first = [r.id for r in batches[0].requests]
    assert first == sorted(first)


def test_admission_partial_batch_waits_one_tick():
    b = ShapeBuckets(batch_buckets=(1, 4), seq_buckets=(8,))
    q = AdmissionQueue(b, tick_s=10.0, max_batch=4)
    now = time.monotonic()
    q.submit(_req("a", 3, arrival=now))
    assert q.take(now=now + 1.0) is None
    batch = q.take(now=now + 10.01)
    assert batch is not None and [r.id for r in batch.requests] == ["a"]
    for i in range(4):
        q.submit(_req(f"f{i}", 3, arrival=now))
    assert q.take(now=now + 0.001) is not None


def test_admission_deadline_expires_queued_requests():
    b = ShapeBuckets(batch_buckets=(1,), seq_buckets=(8,))
    dead = []
    q = AdmissionQueue(b, tick_s=0.0, max_batch=1, on_expired=dead.append)
    now = time.monotonic()
    q.submit(_req("dead", 2, arrival=now, deadline=now + 0.5))
    q.submit(_req("live", 2, arrival=now))
    batch = q.take(now=now + 1.0)
    assert [r.id for r in batch.requests] == ["live"]
    assert [r.id for r in dead] == ["dead"]
    assert q.stats()["expired"] == 1


def test_admission_requeue_rejoins_front_of_class():
    b = ShapeBuckets(batch_buckets=(1, 4), seq_buckets=(8,))
    q = AdmissionQueue(b, tick_s=0.0, max_batch=4)
    now = time.monotonic()
    for i in range(4):
        q.submit(_req(f"r{i}", 3, arrival=now))
    first = q.take(now=now + 1)
    q.submit(_req("later", 3, arrival=now))
    q.requeue(first.requests)
    again = q.take(now=now + 2)
    assert [r.id for r in again.requests] == ["r0", "r1", "r2", "r3"]
    assert q.stats()["requeued"] == 4


def test_admission_oldest_class_dispatches_first():
    b = ShapeBuckets(batch_buckets=(1, 4), seq_buckets=(8, 32))
    q = AdmissionQueue(b, tick_s=0.0, max_batch=4)
    now = time.monotonic()
    q.submit(_req("old_long", 20, arrival=now - 5))
    q.submit(_req("new_short", 3, arrival=now))
    batch = q.take(now=now)
    assert [r.id for r in batch.requests] == ["old_long"]


@pytest.mark.parametrize("seed", range(3))
def test_admission_plans_like_jax(seed):
    """Random arrivals over three seq classes and caps: the port's queue
    hands out the JAX package's batches, in the same order."""
    from horovod_tpu.serving.admission import AdmissionQueue as JQueue
    from horovod_tpu.serving.admission import ServeRequest as JRequest
    from horovod_tpu.serving.shapes import ShapeBuckets as JBuckets
    rng = np.random.RandomState(seed)
    ours = AdmissionQueue(ShapeBuckets((1, 2, 4, 8), (8, 16, 32)),
                          tick_s=0.5, max_batch=int(rng.choice([2, 4, 8])))
    theirs = JQueue(JBuckets((1, 2, 4, 8), (8, 16, 32)), tick_s=0.5,
                    max_batch=ours._max_batch)
    now = 100.0
    for i in range(40):
        n, t = int(rng.randint(1, 33)), now + float(rng.rand())
        ours.submit(ServeRequest(f"q{i}", np.zeros(n, np.int32), t, None, 0))
        theirs.submit(JRequest(f"q{i}", np.zeros(n, np.int32), t, None, 0))
    for step in range(40):
        a = ours.take(now=now + 0.1 * step)
        b = theirs.take(now=now + 0.1 * step)
        assert (a is None) == (b is None)
        if a is not None:
            assert [r.id for r in a.requests] == [r.id for r in b.requests]
            assert a.seq_bucket == b.seq_bucket
    assert ours.stats() == theirs.stats()


# -- the serving plane end to end ---------------------------------------------

@pytest.fixture
def plane_srv():
    from horovod_tpu_torch.runner.rpc import JsonRpcServer
    from horovod_tpu_torch.serving.plane import ServingPlane
    plane = ServingPlane(tick_ms=1.0, max_batch=4, seq_buckets="8,16",
                         deadline_ms=0, lease_s=30.0)
    srv = JsonRpcServer(plane.rpc_handlers(), host="127.0.0.1",
                        secret=None)
    try:
        yield plane, srv
    finally:
        plane.close()
        srv.close()


def _toy_worker(plane_srv, worker_id="0", **kw):
    from horovod_tpu_torch.serving.models import toy_echo_forward
    from horovod_tpu_torch.serving.worker import ServingWorker
    plane, srv = plane_srv
    fwd = toy_echo_forward(plane.buckets, burn_dim=16, burn_iters=1,
                           device=CPU)
    w = ServingWorker("127.0.0.1", srv.port, fwd, worker_id=worker_id,
                      wait_s=1.0, secret=None, **kw)
    w.start()
    return w


def _stop(*workers):
    for w in workers:
        w.stop()
    for w in workers:
        w.join(10)
        assert not w._thread.is_alive()


def _rpc(srv, name, payload, timeout=30.0):
    from horovod_tpu_torch.runner.rpc import json_request
    return json_request("127.0.0.1", srv.port, name, payload, secret=None,
                        timeout=timeout)


def test_plane_end_to_end_echo_and_stats(plane_srv):
    import horovod_tpu_torch as hvd
    plane, srv = plane_srv
    w = _toy_worker(plane_srv, warmup=True)
    try:
        payloads = {f"q{i}": list(range(i + 1)) for i in range(10)}
        _rpc(srv, "serve_submit", {"requests": [
            {"id": k, "tokens": v} for k, v in payloads.items()]})
        for rid, toks in payloads.items():
            res = _rpc(srv, "serve_result", {"id": rid, "wait_s": 20.0})
            assert res["done"] and not res.get("expired")
            assert res["output"][:len(toks)] == [t * 2 + 1 for t in toks]
            assert res["latency_s"] >= 0
        st = plane.stats()
        assert st["completed"] == 10 and st["queue"]["submitted"] == 10
        assert st["workers"]["0"]["observations"] >= 1
        fwd = w.stats()["forward"]
        assert fwd["compiles"] == len(plane.buckets) == 6
        assert fwd["recompiles"] == 0
        # the engine's stats carry the serving section while components
        # live in this process
        hvd.init(device="cpu")
        try:
            est = hvd.runtime._state().engine.stats()
        finally:
            hvd.shutdown()
        assert est["serving"]["plane"]["completed"] == 10
        assert est["serving"]["workers"][0]["worker"] == "0"
    finally:
        _stop(w)


def test_plane_drain_fan_in(plane_srv):
    plane, srv = plane_srv
    w = _toy_worker(plane_srv)
    try:
        for i in range(6):
            plane.submit([1, 2, 3], request_id=f"d{i}")
        got = {}
        deadline = time.monotonic() + 20
        while len(got) < 6 and time.monotonic() < deadline:
            got.update(_rpc(srv, "serve_drain", {"wait_s": 2.0})["results"])
        assert sorted(got) == [f"d{i}" for i in range(6)]
    finally:
        _stop(w)


def test_worker_gone_requeues_and_sibling_serves(plane_srv):
    """A worker pulls a lease and vanishes; worker_gone requeues; a live
    worker completes everything — first completion wins."""
    plane, srv = plane_srv
    for i in range(4):
        plane.submit([5, 6, 7], request_id=f"k{i}")
    batch = plane.pull("dead", wait_s=5.0)
    assert batch["rows"] >= 1
    requeued = plane.worker_gone("dead")
    assert requeued == batch["rows"]
    assert plane.stats()["queue"]["requeued"] == requeued
    w = _toy_worker((plane, srv), worker_id="alive")
    try:
        for i in range(4):
            res = plane.result(f"k{i}", wait_s=20.0)
            assert res["done"] and res["worker"] == "alive"
            assert res["output"][:3] == [11, 13, 15]
        late = plane.push("dead", batch["batch_id"],
                          [[0] * 8] * batch["rows"], service_s=0.1)
        assert late.get("stale")
        assert plane.stats()["completed"] == 4
    finally:
        _stop(w)


def test_retain_workers_requeues_departed_epoch_members(plane_srv):
    plane, _srv = plane_srv
    for i in range(2):
        plane.submit([1], request_id=f"e{i}")
    b0 = plane.pull("0", wait_s=5.0)
    assert b0["rows"] >= 1
    assert plane.retain_workers(["1"]) == b0["rows"]


def test_lease_reaper_requeues_silent_death_and_a_worker_serves_it():
    """A lease pulled by a worker that never pushes expires; the reaper
    requeues it and a real worker answers it."""
    from horovod_tpu_torch.runner.rpc import JsonRpcServer
    from horovod_tpu_torch.serving.plane import ServingPlane
    plane = ServingPlane(tick_ms=1.0, max_batch=2, seq_buckets="8",
                         deadline_ms=0, lease_s=0.2)
    srv = JsonRpcServer(plane.rpc_handlers(), host="127.0.0.1",
                        secret=None)
    w = None
    try:
        plane.submit([1, 2], request_id="silent")
        batch = plane.pull("ghost", wait_s=5.0)
        assert batch["rows"] == 1
        deadline = time.monotonic() + 10
        while (plane.stats()["queue"]["requeued"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert plane.stats()["queue"]["requeued"] == 1
        w = _toy_worker((plane, srv), worker_id="live")
        res = plane.result("silent", wait_s=20.0)
        assert res["done"] and res["output"][:2] == [3, 5]
    finally:
        plane.close()
        if w is not None:
            _stop(w)
        srv.close()


def _feed(plane, worker, service_s, n):
    for i in range(n):
        plane.submit([1], request_id=f"{worker}.{i}.{time.monotonic()}")
        batch = plane.pull(worker, wait_s=5.0)
        # backdate the dispatch so the driver-side wall IS the service time
        plane._leases[batch["batch_id"]].t_dispatch = \
            time.monotonic() - service_s
        plane.push(worker, batch["batch_id"], [[3]], service_s=service_s)


def test_straggler_rotation():
    from horovod_tpu_torch.serving.plane import ServingPlane
    plane = ServingPlane(tick_ms=1.0, max_batch=1, seq_buckets="8",
                         deadline_ms=0, straggler_factor=3.0)
    try:
        _feed(plane, "fast", 0.01, 4)
        _feed(plane, "slow", 0.40, 2)
        assert not plane.stats()["workers"]["slow"]["rotated"]
        _feed(plane, "slow", 0.40, 1)
        st = plane.stats()["workers"]
        assert st["slow"]["rotated"] and st["slow"]["rotated_at"]
        assert not st["fast"]["rotated"]
        assert plane.pull("slow", wait_s=0.05).get("rotated")
        assert plane.rotations == 1
    finally:
        plane.close()


def test_rotation_noise_floor():
    from horovod_tpu_torch.serving.plane import (ServingPlane,
                                                 _STRAGGLER_MIN_S)
    plane = ServingPlane(tick_ms=1.0, max_batch=1, seq_buckets="8",
                         deadline_ms=0, straggler_factor=3.0)
    try:
        _feed(plane, "a", 0.001, 4)
        _feed(plane, "b", 0.02, 4)
        st = plane.stats()["workers"]
        assert st["b"]["ewma_s"] < _STRAGGLER_MIN_S
        assert not st["b"]["rotated"] and plane.rotations == 0
    finally:
        plane.close()


def test_worker_gone_prunes_rotation_state():
    from horovod_tpu_torch.serving.plane import ServingPlane
    plane = ServingPlane(tick_ms=1.0, max_batch=1, seq_buckets="8",
                         deadline_ms=0, straggler_factor=3.0)
    try:
        _feed(plane, "ghost", 0.50, 4)
        _feed(plane, "fast", 0.01, 4)
        plane.worker_gone("ghost")
        assert "ghost" not in plane.stats()["workers"]
        _feed(plane, "slow", 0.20, 3)
        assert plane.stats()["workers"]["slow"]["rotated"]
    finally:
        plane.close()


def test_straggler_rotation_end_to_end_through_chaos(plane_srv):
    """Two real workers, one slowed by the ``serve.batch`` chaos site:
    the plane rotates the slow one out while both serve, and every
    answer is right."""
    from horovod_tpu_torch import chaos
    plane, srv = plane_srv
    plane.straggler_factor = 3.0
    plane.set_max_batch(1)
    chaos.install(chaos.FaultSchedule.parse(
        "serve.batch worker=slow action=delay:0.15", seed=1))
    fast = _toy_worker(plane_srv, worker_id="fast")
    slow = _toy_worker(plane_srv, worker_id="slow")
    try:
        deadline = time.monotonic() + 30
        i = 0
        while (not plane.stats()["workers"].get("slow", {}).get("rotated")
               and time.monotonic() < deadline):
            plane.submit([i % 7 + 1], request_id=f"c{i}")
            i += 1
            time.sleep(0.01)
        assert plane.stats()["workers"]["slow"]["rotated"]
        for j in range(i):
            res = plane.result(f"c{j}", wait_s=20.0)
            assert res["done"] and res["output"][0] == 2 * (j % 7 + 1) + 1
        assert chaos.current().stats()["injections"] >= 3
    finally:
        chaos.uninstall()
        _stop(fast, slow)


def test_deadline_expires_before_dispatch():
    from horovod_tpu_torch.serving.plane import ServingPlane
    plane = ServingPlane(tick_ms=1.0, max_batch=1, seq_buckets="8",
                         deadline_ms=40.0, lease_s=1.0)
    try:
        plane.submit([9, 9], request_id="doomed")
        time.sleep(0.15)
        res = plane.result("doomed", wait_s=5.0)
        assert res["done"] and res["expired"]
    finally:
        plane.close()


def test_sweep_expired_duplicate_ids_no_ndarray_eq():
    b = ShapeBuckets(batch_buckets=(1,), seq_buckets=(8,))
    dead = []
    q = AdmissionQueue(b, tick_s=0.0, max_batch=1, on_expired=dead.append)
    now = time.monotonic()
    q.submit(_req("dup", 3, arrival=now, deadline=now + 0.1))
    q.submit(_req("dup", 3, arrival=now, deadline=now + 0.2))
    assert q.sweep_expired(now=now + 0.15) == 1
    assert len(dead) == 1 and q.depth() == 1


def test_completed_ids_dedup_is_bounded(monkeypatch):
    from horovod_tpu_torch.serving import plane as plane_mod
    monkeypatch.setattr(plane_mod, "_COMPLETED_CACHE", 8)
    plane = plane_mod.ServingPlane(tick_ms=1.0, max_batch=1,
                                   seq_buckets="8", deadline_ms=0)
    try:
        for i in range(50):
            plane._finish(f"c{i}", {"done": True})
        assert len(plane._completed_ids) == 8
        assert "c49" in plane._completed_ids
        assert "c0" not in plane._completed_ids
    finally:
        plane.close()


# -- no-recompile accounting --------------------------------------------------

def test_bucketed_forward_compile_accounting():
    from horovod_tpu_torch.serving.models import toy_echo_forward
    b = ShapeBuckets(batch_buckets=(1, 2), seq_buckets=(8, 16))
    fwd = toy_echo_forward(b, burn_dim=8, burn_iters=1, device=CPU)
    assert fwd.warmup() == 4 and fwd.warmup() == 0
    stats = fwd.stats()
    assert stats["compiles"] == 4 and stats["shapes_seen"] == 4
    out = fwd(np.arange(16, dtype=np.int32).reshape(2, 8),
              np.ones((2,), np.int32))
    np.testing.assert_array_equal(out, np.arange(16).reshape(2, 8) * 2 + 1)
    fwd(np.zeros((1, 16), np.int32), np.ones((1,), np.int32))
    stats = fwd.stats()
    assert stats["compiles"] == 4 and stats["recompiles"] == 0
    assert stats["calls"] == 6
    with pytest.raises(ValueError, match="shape buckets"):
        fwd(np.zeros((3, 8), np.int32), np.ones((3,), np.int32))
    # a bucket whose buffers were dropped is prepared again: a recompile
    fwd._bufs.pop((2, 8))
    fwd(np.zeros((2, 8), np.int32), np.ones((2,), np.int32))
    assert fwd.stats()["recompiles"] == 1


def test_llama_bucket_buffers_are_reused():
    """The dense decode forward allocates a bucket's cache on its first
    call and reuses it after; its answers equal sequential decode."""
    from horovod_tpu_torch.models import generate as tg
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.serving.models import llama_decode_forward
    cfg = tl.tiny(vocab=64, seq=64)
    params = tl.init_params(cfg, seed=2, device=CPU)
    b = ShapeBuckets(batch_buckets=(2,), seq_buckets=(8,))
    fwd = llama_decode_forward(params, cfg, 3, b)
    tokens = np.array([[5, 6, 7, 0, 0, 0, 0, 0], [1, 2, 3, 4, 5, 6, 7, 8]],
                      np.int32)
    lengths = np.array([3, 8], np.int32)
    first = fwd(tokens, lengths)
    cache = fwd._bufs[(2, 8)]["cache"]
    assert tuple(cache.k.shape[1:3]) == (2, 11)
    np.testing.assert_array_equal(fwd(tokens, lengths), first)
    assert fwd._bufs[(2, 8)]["cache"].k is cache.k
    for i, (row, n) in enumerate(zip(tokens, lengths)):
        alone = tg.greedy_generate(params, cfg, torch.as_tensor(
            row[None, :n].astype(np.int64)), 3, max_len=11)
        np.testing.assert_array_equal(first[i], alone[0].numpy())
    assert fwd.stats()["compiles"] == 1


def test_classifier_forward_is_not_ported():
    """The test that pinned ``classifier_forward`` as unported now holds
    it against the JAX package's: the same BERT-tiny and MNIST params,
    the same padded batches, the same ``[B, 1]`` argmax labels."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import bert as jb
    from horovod_tpu.models import mnist as jm
    from horovod_tpu.serving import models as jmodels
    from horovod_tpu.serving.shapes import ShapeBuckets as JBuckets
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models import bert as tb
    from horovod_tpu_torch.models import mnist as tm
    from horovod_tpu_torch.serving.models import classifier_forward
    rng = np.random.RandomState(6)
    jbert = jb.tiny(vocab=64, seq=16, num_labels=5)
    tbert = tb.tiny(vocab=64, seq=16, num_labels=5)
    bert_p = jax.tree_util.tree_map(np.asarray, jb.init_params(
        jbert, jax.random.PRNGKey(1)))
    jmc, tmc = jm.MnistConfig(dtype=jnp.float32), tm.MnistConfig(
        dtype=torch.float32)
    mnist_p = jax.tree_util.tree_map(np.asarray, jm.init(
        jmc, jax.random.PRNGKey(2)))
    cases = {
        "bert": (
            lambda p, x: jb.classify(p, x, jbert, jb.ParallelSpec()),
            lambda p, x: tb.classify(p, x, tbert), bert_p,
            convert.bert_params_from_numpy(bert_p, device=CPU), None, None,
            (4, 16), rng.randint(0, 64, (3, 16))),
        "mnist": (
            lambda p, x: jm.forward(p, x, jmc),
            lambda p, x: tm.forward(p, x, tmc), mnist_p,
            convert.mnist_params_from_numpy(mnist_p, device=CPU),
            lambda t: (t.reshape(-1, 28, 28, 1) / 255.0),
            lambda t: (t.view(-1, 1, 28, 28) / 255.0),
            (4, 784), rng.randint(0, 256, (3, 784))),
    }
    for name, (jf, tf, jp, tp, jpre, tpre, (b, s), rows) in cases.items():
        tokens = np.zeros((b, s), np.int32)
        tokens[:len(rows)] = rows
        lengths = np.array([s] * len(rows) + [0] * (b - len(rows)), np.int32)
        want = jmodels.classifier_forward(jf, jax.tree_util.tree_map(
            jnp.asarray, jp), JBuckets((b,), (s,)),
                                          preprocess=jpre)(tokens, lengths)
        got = classifier_forward(tf, tp, ShapeBuckets((b,), (s,)),
                                 preprocess=tpre)(tokens, lengths)
        assert got.shape == (b, 1) and got.dtype == np.int32, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


# -- metrics: edge resolution + job merge -------------------------------------

def test_serve_latency_edges_resolve_sub_ms():
    import bisect

    from horovod_tpu_torch import metrics as _metrics
    from horovod_tpu_torch.metrics.registry import log2_edges
    coarse, fine = log2_edges(-10, 7), log2_edges(-13, 7)
    a, b = 0.0003, 0.0009
    assert bisect.bisect_left(coarse, a) == bisect.bisect_left(coarse, b)
    assert bisect.bisect_left(fine, a) != bisect.bisect_left(fine, b)
    import horovod_tpu_torch.serving.plane   # noqa: F401 - declares
    import horovod_tpu_torch.serving.worker  # noqa: F401
    reg = {f.name: f for f in _metrics.registry().families()}
    for fam in ("hvd_serve_request_latency_seconds",
                "hvd_serve_e2e_latency_seconds",
                "hvd_serve_admission_latency_seconds"):
        assert (reg[fam].lo, reg[fam].hi) == (-13, 7), fam


def _worker_text(depth, lat_bucket_counts, completed):
    cum = 0
    lines = ["# TYPE hvd_serve_requests_total counter",
             f'hvd_serve_requests_total{{outcome="completed"}} {completed}',
             "# TYPE hvd_serve_queue_depth gauge",
             f"hvd_serve_queue_depth {depth}",
             "# TYPE hvd_serve_request_latency_seconds histogram"]
    for e, n in zip(["0.0001220703125", "0.000244140625"],
                    lat_bucket_counts):
        cum += n
        lines.append(
            f'hvd_serve_request_latency_seconds_bucket{{le="{e}"}} {cum}')
    lines += [f'hvd_serve_request_latency_seconds_bucket{{le="+Inf"}} {cum}',
              "hvd_serve_request_latency_seconds_sum 1.0",
              f"hvd_serve_request_latency_seconds_count {cum}"]
    return "\n".join(lines) + "\n"


def test_serve_families_job_merge_matches_jax():
    from horovod_tpu.metrics import aggregate as jagg
    from horovod_tpu_torch.metrics import aggregate
    texts = {"0": _worker_text(3, (2, 1), 5), "1": _worker_text(1, (1, 4), 7)}
    merged = aggregate.merge({w: aggregate.parse_prometheus(t)
                              for w, t in texts.items()})
    reqs = merged["hvd_serve_requests_total"]["samples"]
    assert [v for _, lbl, v in reqs
            if lbl.get("outcome") == "completed"] == [12]
    depth = {(lbl.get("agg"), lbl.get("worker")): v
             for _, lbl, v in merged["hvd_serve_queue_depth"]["samples"]}
    assert depth[("min", "1")] == 1 and depth[("max", "0")] == 3
    assert depth[("sum", None)] == 4
    lat = {lbl.get("le"): v for nm, lbl, v
           in merged["hvd_serve_request_latency_seconds"]["samples"]
           if nm.endswith("_bucket")}
    assert lat["0.0001220703125"] == 3 and lat["0.000244140625"] == 8
    jmerged = jagg.merge({w: jagg.parse_prometheus(t)
                          for w, t in texts.items()})
    assert aggregate.render(merged) == jagg.render(jmerged)
    bad = _worker_text(1, (1, 1), 1).replace("0.000244140625", "0.0005")
    with pytest.raises(ValueError, match="mismatched bucket edges"):
        aggregate.merge({
            "0": aggregate.parse_prometheus(_worker_text(1, (1, 1), 1)),
            "1": aggregate.parse_prometheus(bad)})


def test_worker_metrics_scrape_and_merge_over_http():
    """Two servers expose ``/metrics``; ``scrape_and_merge`` merges them
    and reports a dead endpoint as a comment line, not a failure."""
    import socket

    from horovod_tpu_torch import metrics as _metrics
    from horovod_tpu_torch.metrics import aggregate
    from horovod_tpu_torch.runner.rpc import JsonRpcServer
    servers = [JsonRpcServer({}, host="127.0.0.1", secret=None)
               for _ in range(2)]
    try:
        _metrics.counter("hvd_test_serve_scrapes_total", "test").inc(2)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        eps = {"0": ("127.0.0.1", servers[0].port),
               "1": ("127.0.0.1", servers[1].port),
               "2": ("127.0.0.1", dead)}
        text = aggregate.scrape_and_merge(eps, timeout=2.0)
        assert "aggregated over 2 worker(s)" in text
        assert "worker 2 unreachable" in text
        fams = aggregate.parse_prometheus(text)
        (_, _, v), = fams["hvd_test_serve_scrapes_total"]["samples"]
        assert v == 2 * _metrics.registry().to_dict()[
            "hvd_test_serve_scrapes_total"]["series"][0]["value"]
    finally:
        for s in servers:
            s.close()


def test_metrics_routes_and_flight_recorder(tmp_path, monkeypatch):
    import json
    import urllib.request

    from horovod_tpu_torch import metrics as _metrics
    from horovod_tpu_torch.runner.rpc import JsonRpcServer
    srv = JsonRpcServer({}, host="127.0.0.1", secret=None)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        srv.close()
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER_PATH",
                       str(tmp_path / "f.jsonl"))
    monkeypatch.setattr(_metrics, "RECORDING", True)
    _metrics.event("serve.test", n=1)
    assert _metrics.flight_dump("test") >= 1
    lines = (tmp_path / "f.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["flight_recorder"] == "horovod_tpu_torch"
    assert any(json.loads(x)["kind"] == "serve.test" for x in lines[1:])


def test_metrics_dump_file_per_rank(tmp_path):
    """``HOROVOD_METRICS_DUMP`` takes the rank suffix from HOROVOD_RANK
    when the runtime is not initialized (the JAX package asks jax)."""
    from horovod_tpu_torch import metrics as _metrics
    path = tmp_path / "m.json"
    env = {"HOROVOD_METRICS_DUMP": str(path),
           "HOROVOD_METRICS_DUMP_INTERVAL_S": "0.05",
           "HOROVOD_RANK": "1", "HOROVOD_SIZE": "2"}
    _metrics.init_from_env(env)
    try:
        deadline = time.monotonic() + 10
        while (not (tmp_path / "m.json.1").exists()
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        _metrics.stop_exposition()
    assert (tmp_path / "m.json.1").exists() and not path.exists()


# -- the transport and chaos, beside the JAX package's -----------------------

def test_rpc_hmac_signing_matches_jax_and_rejects_unsigned():
    import urllib.error

    from horovod_tpu.runner import secret as jsecret
    from horovod_tpu_torch.runner import secret
    from horovod_tpu_torch.runner.rpc import JsonRpcServer, json_request
    key = bytes(range(32))
    assert secret.sign(key, "x", "123", b"{}") == \
        jsecret.sign(key, "x", "123", b"{}")
    srv = JsonRpcServer({"echo": lambda p: {"got": p["v"]}},
                        host="127.0.0.1", secret=key)
    try:
        assert json_request("127.0.0.1", srv.port, "echo", {"v": 3},
                            secret=key, timeout=10.0) == {"got": 3}
        with pytest.raises(urllib.error.HTTPError) as e:
            json_request("127.0.0.1", srv.port, "echo", {"v": 3},
                         secret=None, timeout=10.0, retries=0)
        assert e.value.code == 403
    finally:
        srv.close()


@pytest.mark.parametrize("spec", [
    "rpc.request:running nth=1 action=drop",
    "rpc.request prob=0.3 action=delay:0.01; serve.batch every=2 "
    "action=error:boom",
    "serve.batch worker=1 times=2 action=dup"])
def test_chaos_schedules_decide_like_jax(spec):
    from horovod_tpu.chaos.schedule import FaultSchedule as JSchedule
    from horovod_tpu_torch.chaos.schedule import FaultSchedule
    ours, theirs = FaultSchedule.parse(spec, 7), JSchedule.parse(spec, 7)
    for i in range(30):
        site = ("rpc.request", "serve.batch")[i % 2]
        ctx = {"method": "running", "worker": str(i % 3)}
        a, b = ours.decide(site, dict(ctx)), theirs.decide(site, dict(ctx))
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.kind, a.arg, a.rule) == (b.kind, b.arg, b.rule)


# -- config --------------------------------------------------------------------

@pytest.mark.parametrize("var,bad", [
    ("HOROVOD_SERVE_TICK_MS", "-1"), ("HOROVOD_SERVE_MAX_BATCH", "0"),
    ("HOROVOD_SERVE_SEQ_BUCKETS", "64,16"),
    ("HOROVOD_SERVE_BATCH_BUCKETS", "2,2"),
    ("HOROVOD_SERVE_DEADLINE_MS", "-5"), ("HOROVOD_SERVE_LEASE_S", "0"),
    ("HOROVOD_SERVE_STRAGGLER_FACTOR", "0.5"),
    ("HOROVOD_SERVE_KV_BLOCK", "0"), ("HOROVOD_SERVE_MP_AXES", "model")])
def test_serve_config_validation_matches_jax(monkeypatch, var, bad):
    import os

    from horovod_tpu import config as jconfig
    from horovod_tpu_torch import config as tconfig
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv(var, bad)
    with pytest.raises(ValueError) as want:
        jconfig.Config.from_env()
    with pytest.raises(ValueError) as got:
        tconfig.Config.from_env()
    assert str(got.value) == str(want.value)


def test_serve_knobs_parse_and_serve_is_ported(monkeypatch):
    import dataclasses
    import os

    from horovod_tpu import config as jconfig
    from horovod_tpu_torch import config as tconfig
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    for k, v in {"HOROVOD_SERVE": "1", "HOROVOD_SERVE_TICK_MS": "5",
                 "HOROVOD_SERVE_MAX_BATCH": "16",
                 "HOROVOD_SERVE_SEQ_BUCKETS": "16,64",
                 "HOROVOD_SERVE_KV_BLOCK": "32"}.items():
        monkeypatch.setenv(k, v)
    c = tconfig.Config.from_env()
    assert c.serve and (c.serve_tick_ms, c.serve_max_batch) == (5.0, 16)
    assert dataclasses.asdict(c) == dataclasses.asdict(
        jconfig.Config.from_env())
    assert "HOROVOD_SERVE" not in {u[0] for u in tconfig.UNPORTED}


def test_plane_respects_env_defaults(monkeypatch):
    from horovod_tpu_torch.serving.plane import ServingPlane
    monkeypatch.setenv("HOROVOD_SERVE_MAX_BATCH", "2")
    monkeypatch.setenv("HOROVOD_SERVE_SEQ_BUCKETS", "4,8")
    plane = ServingPlane()
    try:
        assert plane.buckets.seq_buckets == (4, 8)
        assert plane.buckets.max_batch == 2
        with pytest.raises(ValueError, match="largest seq bucket"):
            plane.submit(list(range(9)))
    finally:
        plane.close()


def test_serving_stats_registry_is_empty_without_components():
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.serving.plane import ServingPlane
    before = serving.stats()
    plane = ServingPlane(tick_ms=1.0, max_batch=1, seq_buckets="8",
                         deadline_ms=0)
    try:
        assert serving.stats()["plane"]["queue"]["submitted"] == 0
    finally:
        plane.close()
    assert serving.stats() == before
