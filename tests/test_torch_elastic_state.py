"""The port's elastic state, run wrapper and sampler against the JAX
package's (``tests/test_elastic_state.py``, replayed with ``TensorState``
in ``ArrayState``'s place), plus ``TorchState``, the sampler's indices
over seeds, epochs, ranks and a resize, and which errors the run wrapper
treats as a lost peer.  World 1 on the CPU here; the rank-process cases
at world 2 are in ``tests/torch_ranks.py`` (``elastic_state``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu as jhvd
import horovod_tpu_torch as tp
from horovod_tpu.elastic import ArrayState, ObjectState as JObjectState
from horovod_tpu.elastic import ElasticSampler as JSampler
from horovod_tpu.exceptions import HorovodInternalError as JInternalError
from horovod_tpu.exceptions import HostsUpdatedInterrupt as JInterrupt
from horovod_tpu_torch.elastic import (ElasticSampler, ObjectState,
                                       TensorState, TorchState)
from horovod_tpu_torch.elastic import runner as trunner
from horovod_tpu_torch.elastic.worker import HostUpdateResult
from horovod_tpu_torch.exceptions import (HorovodInternalError,
                                          HostsUpdatedInterrupt)

import torch_ranks


@pytest.fixture(scope="module")
def port():
    tp.init(device="cpu")
    yield tp
    tp.shutdown()


# --- the reference's cases, on both packages --------------------------------

def test_object_state_commit_restore(hvd, port):
    for cls in (JObjectState, ObjectState):
        state = cls(epoch=0, batch=5)
        state.epoch = 3
        state.batch = 7
        state.commit()
        state.epoch = 99
        state.restore()
        assert (state.epoch, state.batch) == (3, 7)


def test_object_state_sync(hvd, port):
    for cls in (JObjectState, ObjectState):
        state = cls(epoch=4)
        state.sync()
        assert state.epoch == 4


def test_tensor_state_commit_restore(hvd, port):
    """ArrayState's case: a replaced tree and a scalar roll back."""
    ref = ArrayState(params={"w": jnp.arange(4.0)}, step=0)
    got = TensorState(params={"w": torch.arange(4.0)}, step=0)
    for state, zeros in ((ref, jnp.zeros(4)), (got, torch.zeros(4))):
        state.commit()
        state.params = {"w": zeros}
        state.step = 10
        state.restore()
        assert state.step == 0
    np.testing.assert_array_equal(got.params["w"].numpy(),
                                  np.asarray(ref.params["w"]))


def test_tensor_state_sync(hvd, port):
    ref = ArrayState(params={"w": jnp.ones(3)})
    got = TensorState(params={"w": torch.ones(3)})
    ref.sync()
    got.sync()
    np.testing.assert_array_equal(got.params["w"].numpy(),
                                  np.asarray(ref.params["w"]))


def _restores_on_internal_error(run, error, state):
    calls = []

    @run
    def train(state):
        calls.append(state.step)
        if len(calls) == 1:
            state.step = 55
            raise error("simulated slice preemption")
        return state.step

    return train(state), calls


def test_elastic_run_restores_on_internal_error(hvd, port):
    want = _restores_on_internal_error(jhvd.elastic.run, JInternalError,
                                       JObjectState(step=1))
    got = _restores_on_internal_error(tp.elastic.run, HorovodInternalError,
                                      ObjectState(step=1))
    assert got == want == (1, [1, 1])
    assert tp.is_initialized() and tp.size() == 1   # re-initialized


def _syncs_on_hosts_updated(run, interrupt, state):
    calls = []

    @run
    def train(state):
        calls.append(1)
        if len(calls) == 1:
            raise interrupt(skip_sync=False)
        return "done"

    return train(state), len(calls)


def test_elastic_run_syncs_on_hosts_updated(hvd, port):
    want = _syncs_on_hosts_updated(jhvd.elastic.run, JInterrupt,
                                   JObjectState(step=2))
    got = _syncs_on_hosts_updated(tp.elastic.run, HostsUpdatedInterrupt,
                                  ObjectState(step=2))
    assert got == want == ("done", 2)


def test_elastic_reset_limit(hvd, port):
    for run, error, cls in ((jhvd.elastic.run, JInternalError, JObjectState),
                            (tp.elastic.run, HorovodInternalError,
                             ObjectState)):
        @run(reset_limit=1)
        def train(state):
            raise error("always fails")

        with pytest.raises(RuntimeError, match="reset limit"):
            train(cls(step=0))


def test_state_host_update_raises_interrupt(hvd, port):
    for cls, interrupt in ((JObjectState, JInterrupt),
                           (ObjectState, HostsUpdatedInterrupt)):
        state = cls(step=0)
        state.on_hosts_updated(0.0, 0)  # removal → full sync required
        with pytest.raises(interrupt) as exc_info:
            state.commit()
        assert not exc_info.value.skip_sync


def test_state_removal_only_skips_sync(hvd, port):
    from horovod_tpu.elastic.worker import HostUpdateResult as JResult
    assert (JResult.ADDED, JResult.REMOVED, JResult.MIXED) == (
        HostUpdateResult.ADDED, HostUpdateResult.REMOVED,
        HostUpdateResult.MIXED)
    for cls, interrupt in ((JObjectState, JInterrupt),
                           (ObjectState, HostsUpdatedInterrupt)):
        state = cls(step=0)
        state.on_hosts_updated(0.0, HostUpdateResult.REMOVED)
        with pytest.raises(interrupt) as exc_info:
            state.commit()
        assert exc_info.value.skip_sync
        state.on_hosts_updated(0.0, HostUpdateResult.ADDED)
        with pytest.raises(interrupt) as exc_info:
            state.commit()
        assert not exc_info.value.skip_sync


def test_sampler_partitions_evenly():
    for cls in (JSampler, ElasticSampler):
        s = cls(dataset_size=100, shuffle=False, rank=0, num_replicas=4)
        assert len(s) == 25
        seen = set()
        for r in range(4):
            seen.update(cls(100, shuffle=False, rank=r, num_replicas=4))
        assert seen == set(range(100))


def test_sampler_reshards_remaining_after_resize():
    for cls in (JSampler, ElasticSampler):
        s = cls(dataset_size=20, shuffle=False, rank=0, num_replicas=4)
        s.record_indices(list(range(8)))
        s._explicit_replicas = 2
        s.reset()
        assert set(s.remaining_indices) == set(range(8, 20))
        assert len(s) == 6


def test_sampler_state_dict_roundtrip():
    for cls in (JSampler, ElasticSampler):
        s = cls(dataset_size=10, shuffle=True, seed=3, rank=0,
                num_replicas=2)
        s.set_epoch(2)
        s.record_indices([1, 2, 3])
        s2 = cls(dataset_size=10, shuffle=True, seed=3, rank=0,
                 num_replicas=2)
        s2.load_state_dict(s.state_dict())
        assert s2.epoch == 2
        assert s2.processed_indices == {1, 2, 3}
        assert set(s2.remaining_indices) == set(range(10)) - {1, 2, 3}


# --- the sampler against the reference --------------------------------------

@pytest.mark.parametrize("seed,shuffle", [(0, True), (7, True), (3, False)])
def test_sampler_matches_reference_across_a_resize(seed, shuffle):
    """Indices and state_dict of every rank over two epochs, then a 3 → 2
    resize mid-epoch: the remaining indices' partition equals the
    reference's, and no index is taken twice or dropped."""
    def pair(rank, replicas):
        return (JSampler(50, shuffle=shuffle, seed=seed, rank=rank,
                         num_replicas=replicas),
                ElasticSampler(50, shuffle=shuffle, seed=seed, rank=rank,
                               num_replicas=replicas))

    for epoch in (0, 1):
        for rank in range(3):
            ref, got = pair(rank, 3)
            ref.set_epoch(epoch)
            got.set_epoch(epoch)
            assert list(got) == list(ref)
            assert got.state_dict() == ref.state_dict()
    taken = []
    for rank in range(3):
        ref, got = pair(rank, 3)
        for s in (ref, got):
            s.set_epoch(1)
            s.record_batch(0, 4)
            s.record_batch(1, 4)
        assert got.state_dict() == ref.state_dict()
        sd = got.state_dict()
    taken = sd["processed_indices"]
    assert len(taken) == 24
    after = []
    for rank in range(2):
        ref, got = pair(rank, 2)
        ref.load_state_dict(sd)
        got.load_state_dict(sd)
        assert list(got) == list(ref)
        assert got.remaining_indices == ref.remaining_indices
        after.extend(got)
    assert sorted(set(after) | set(taken)) == list(range(50))
    assert not set(after) & set(taken)


# --- TensorState and TorchState ---------------------------------------------

def test_tensor_state_restores_in_place_for_the_optimizer(port):
    """restore copies into the live tensors an optimizer holds (so its
    next step sees the commit) and drops a failed step's gradients;
    a sync at world 1 keeps the values."""
    w = torch.nn.Parameter(torch.arange(4.0))
    buf = torch.zeros(4)
    opt = torch.optim.SGD([w], lr=0.5, momentum=0.9)
    opt.state[w]["momentum_buffer"] = buf
    state = TensorState(params={"w": w}, opt_state=[buf], step=0,
                        tag="x")
    assert state._trees.keys() == {"params", "opt_state"}
    assert state._scalar_state == {"step": 0, "tag": "x"}
    w.grad = torch.ones(4)
    opt.step()
    state.step = 1
    w.grad = torch.full((4,), 3.0)     # a step that failed halfway
    state.restore()
    assert state.params["w"] is w and state.opt_state[0] is buf
    np.testing.assert_array_equal(w.detach().numpy(), np.arange(4.0))
    np.testing.assert_array_equal(buf.numpy(), np.zeros(4))
    assert w.grad is None and state.step == 0
    state.sync()
    np.testing.assert_array_equal(w.detach().numpy(), np.arange(4.0))


def test_torch_state_commit_restore_sync(port):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = TorchState(model=model, optimizer=opt, epoch=3)
    assert state.model is model and state.optimizer is opt
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state.epoch = 4
    state.restore()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    assert state.epoch == 3 and opt.state_dict()["state"] == {}
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state.epoch = 5
    state.commit()
    after = {k: v.clone() for k, v in model.state_dict().items()}
    state.sync()
    assert state.epoch == 5
    for k, v in model.state_dict().items():
        assert torch.equal(v, after[k])
    assert len(opt.state_dict()["state"]) == 2


def test_elastic_state_at_world_2(tmp_path):
    """Two gloo rank processes: TensorState and TorchState sync rank 0's
    values into rank 1's tensors in place, restore rolls rank 1 back."""
    res = torch_ranks.launch(2, ["elastic_state"], tmp_path)
    r0, r1 = (r["elastic_state"] for r in res)
    for k in ("tensor", "torch", "scalars"):
        assert r0[k] == r1[k], k
    assert r1["same_objects"] and r1["restored"]


# --- which errors are a lost peer --------------------------------------------

_GLOO_CLOSED = ("[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:553] "
                "Connection closed by peer [127.0.0.1]:23690. This is "
                "typically caused by a remote worker crashing.")


@pytest.mark.parametrize("exc,recoverable", [
    (HorovodInternalError("peer died"), True),
    (RuntimeError(_GLOO_CLOSED), True),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/unbound_buffer"
                  ".cc:81] Timed out waiting 60000ms for recv operation to "
                  "complete"), True),
    (RuntimeError("[gloo/transport/tcp/pair.cc] Connection reset by peer"),
     True),
    (dist.DistNetworkError("Failed to recv, got 0 bytes. Connection was "
                           "likely closed."), True),
    (dist.DistStoreError("Socket Timeout"), True),
    (dist.DistBackendError("NCCL communicator was aborted"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("mat1 and mat2 shapes cannot be multiplied"), False),
    (RuntimeError("timed out waiting for my own queue"), False),
    (ValueError("connection string invalid"), False),
    (KeyError("peer"), False),
    (NotImplementedError("gloo connection closed by peer"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException) else "")
def test_is_recoverable_markers(exc, recoverable):
    assert trunner._is_recoverable(exc) is recoverable


def test_is_recoverable_agrees_with_the_reference_where_both_apply():
    """The reference's rules on its own errors and the port's on torch's
    counterparts: a collective failure recovers, a user's error with the
    same words in it surfaces."""
    from horovod_tpu.elastic import runner as jrunner
    pairs = [
        (JInternalError("x"), HorovodInternalError("x")),
        (ValueError("UNKNOWN: Gloo all-reduce failed: connection closed "
                    "by peer"), RuntimeError(_GLOO_CLOSED)),
        (ValueError("connection string invalid"),
         ValueError("connection string invalid")),
        (KeyError("peer"), KeyError("peer")),
    ]
    for ref, got in pairs:
        assert trunner._is_recoverable(got) == jrunner._is_recoverable(ref)


def test_user_runtime_error_surfaces_from_run(port):
    calls = []

    @tp.elastic.run
    def train(state):
        calls.append(1)
        raise RuntimeError("mat1 and mat2 shapes cannot be multiplied")

    with pytest.raises(RuntimeError, match="shapes"):
        train(ObjectState(step=0))
    assert calls == [1]


def test_gloo_transport_error_restores_and_retries(port):
    calls = []

    @tp.elastic.run
    def train(state):
        calls.append(state.step)
        if len(calls) == 1:
            state.step = 9
            raise RuntimeError(_GLOO_CLOSED)
        return state.step

    assert train(ObjectState(step=2)) == 2
    assert calls == [2, 2]


# --- a peer the driver reported dead ------------------------------------------

def _negotiating(ctl):
    """Run one round of ``ctl`` (rank 0 of 2) in a thread, rank 1 silent;
    returns the thread and where its exception lands."""
    import threading
    err = {}

    def run():
        try:
            ctl.negotiate(["tok"], (0, 1))
        except Exception as e:  # noqa: BLE001 - the test reads it
            err["e"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, err


def test_negotiation_stops_waiting_for_a_lost_rank():
    """A SIGKILLed peer writes no leave marker: the driver's notice names
    it, and the round raises at once instead of at its deadline."""
    import time
    from horovod_tpu_torch.ops.controller import Controller
    ctl = Controller(None, dist.HashStore(), rank=0, world=2, deadline_s=60)
    t, err = _negotiating(ctl)
    time.sleep(0.3)
    assert t.is_alive()
    t0 = time.monotonic()
    ctl.mark_superseded([1])
    t.join(5)
    assert not t.is_alive() and time.monotonic() - t0 < 2
    assert isinstance(err["e"], HorovodInternalError)
    assert "rank [1] died" in str(err["e"]) and ctl.lost == {1}


def test_negotiation_waits_a_grace_period_after_a_re_form():
    """Without a named dead rank, a round of a superseded epoch waits at
    most ``superseded_grace_s`` (HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT)."""
    import time
    from horovod_tpu_torch.ops.controller import Controller
    ctl = Controller(None, dist.HashStore(), rank=0, world=2, deadline_s=60)
    ctl.superseded_grace_s = 0.5
    t, err = _negotiating(ctl)
    ctl.mark_superseded()
    t.join(5)
    assert not t.is_alive()
    assert isinstance(err["e"], HorovodInternalError)
    assert "s after the elastic driver re-formed the job" in str(err["e"])


def test_note_superseded_marks_only_an_older_epoch(port, monkeypatch):
    st = tp.runtime._state()
    ctl = st.engine._controller
    monkeypatch.setattr(ctl, "_lost", frozenset())
    monkeypatch.setattr(ctl, "_superseded_at", None)
    tp.runtime.note_superseded(1, [1])      # not elastic: nothing
    assert ctl._superseded_at is None
    monkeypatch.setattr(st, "epoch", 3)
    tp.runtime.note_superseded(3, [0])      # this very epoch: nothing
    assert ctl._superseded_at is None
    tp.runtime.note_superseded(4, [1])      # the next: rank 1 is gone
    assert ctl.lost == {1} and ctl._superseded_at is not None
    tp.runtime.note_superseded(6, [0])      # later: ranks of another epoch
    assert ctl.lost == {1}


def test_notification_listener_drops_an_absorbed_epoch(monkeypatch):
    """A hosts_updated push for an epoch this worker already joined is
    stale (its reset absorbed it); a newer one reaches the states."""
    from horovod_tpu_torch.elastic import worker as tworker
    monkeypatch.setattr(tworker, "_last_epoch", 2)
    mgr = tworker.WorkerNotificationManager()
    try:
        state = ObjectState(step=0)
        mgr.register_listener(state)
        assert mgr._on_update({"timestamp": 1.0, "res": 1, "epoch": 2,
                               "lost": []}) == {"ok": True, "stale": True}
        assert state._host_messages == []
        assert mgr._on_update({"timestamp": 2.0, "res": 2, "epoch": 3,
                               "lost": [1]}) == {"ok": True}
        assert state._host_messages == [(2.0, 2)]
        mgr.remove_listener(state)
    finally:
        mgr.close()


@pytest.mark.parametrize("first_commit", ["before_step", "after_step"])
def test_tensor_state_commits_and_restores_a_transform_state(port,
                                                            first_commit):
    """A ``DistributedGradientTransform`` state in a TensorState is
    per-rank: commit snapshots its optimizer state, count and
    accumulator; restore puts them back in place (the optimizer keeps its
    tensors), and drops state the commit did not hold."""
    import functools

    from horovod_tpu_torch.optim import recovery_payload
    params = {"w": torch.linspace(-1, 1, 12)}
    tx = tp.DistributedGradientTransform(
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        sharded_update=True, backward_passes_per_step=2,
        wire_format="none")
    st = tx.init(params)
    if first_commit == "after_step":
        for _ in range(2):
            tx.update({"w": torch.ones(12)}, st, params)
    state = TensorState(params=params, dist=st, step=0)
    assert state.dist is st
    saved = recovery_payload(st)
    bufs = [v for s in st.inner.state.values() for v in s.values()]
    tx.update({"w": torch.full((12,), 3.0)}, st, params)
    tx.update({"w": torch.full((12,), 5.0)}, st, params)
    tx.update({"w": torch.full((12,), 7.0)}, st, params)   # acc holds 7s
    state.restore()
    got = recovery_payload(st)
    assert sorted(got) == sorted(saved)
    assert all(got[n].tobytes() == saved[n].tobytes() for n in got)
    assert st.count == int(saved["count"])
    assert all(torch.equal(a, torch.zeros_like(a)) for a in st.acc.values())
    assert bufs == [v for s in st.inner.state.values() for v in s.values()]
    if first_commit == "before_step":
        assert not st.inner.state
