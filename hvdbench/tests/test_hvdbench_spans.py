"""The readers of the port's step spans (``engine.wait_ms``,
``engine.queue_ms``, ``host.gc_ms``) on span rings built by hand."""

from __future__ import annotations

import pytest

from hvdbench import cells, spans

READERS = ["engine.wait_ms", "engine.queue_ms", "host.gc_ms"]


def _step(i, t0, profiled=False, wait=0.0, queue=0.0, gc=0.0):
    return {"cat": "step", "name": "step", "t0": t0, "t1": t0 + 1.0,
            "args": {"step": i, "profiled": profiled, "wait_ms": wait,
                     "queue_ms": queue, "gc_ms": gc}}


def _ring(monkeypatch, items):
    snap = {"spans": items, "dropped": 0}
    monkeypatch.setattr(spans, "ring", lambda: snap)
    return snap


def _read(metric, steps):
    return cells.metric_reader(metric)({"window": {"steps": steps}})


def test_wait_and_queue_are_the_window_steps_medians(monkeypatch):
    waits, queues = [1.0, 5.0, 3.0, 9.0, 2.0], [0.5, 0.1, 0.4, 0.2, 0.3]
    _ring(monkeypatch, [_step(i, 2.0 * i, wait=w, queue=q)
                        for i, (w, q) in enumerate(zip(waits, queues))])
    assert _read("engine.wait_ms", 5) == 3.0
    assert _read("engine.queue_ms", 5) == 0.3
    # at most the window's count, the newest: 3, 9, 2
    assert _read("engine.wait_ms", 3) == 3.0
    assert _read("engine.queue_ms", 3) == 0.3


def test_profiled_steps_and_the_capture_warm_up_are_left_out(monkeypatch):
    """Window steps 0-3, the capture's warm-up step 4 (unprofiled), the
    profiled steps 5-7: the readers see steps 0-3 alone."""
    items = [_step(i, 2.0 * i, wait=1.0 + i) for i in range(4)]
    items.append(_step(4, 8.0, wait=500.0))
    items += [_step(i, 2.0 * i, profiled=True, wait=900.0)
              for i in range(5, 8)]
    _ring(monkeypatch, items)
    kept = spans.window_steps(10)
    assert [s["args"]["step"] for s in kept] == [0, 1, 2, 3]
    assert _read("engine.wait_ms", 10) == 2.5


def test_gc_is_the_window_steps_collections_over_their_count(monkeypatch):
    gcs = [0.0, 200.0, 0.0, 40.0]
    items = [_step(i, 2.0 * i, gc=g) for i, g in enumerate(gcs)]
    items += [_step(4, 8.0, gc=100.0),                 # the warm-up step
              _step(5, 10.0, profiled=True, gc=300.0)]  # a profiled one
    _ring(monkeypatch, items)
    assert _read("host.gc_ms", 4) == pytest.approx(240.0 / 4)
    # the newest three steps: 1 to 3
    assert _read("host.gc_ms", 3) == pytest.approx(240.0 / 3)


@pytest.mark.parametrize("metric", READERS)
def test_fewer_than_three_window_steps_raise(monkeypatch, metric):
    _ring(monkeypatch, [_step(0, 0.0), _step(1, 2.0),
                        _step(2, 4.0, profiled=True)])
    with pytest.raises(LookupError):
        _read(metric, 10)


@pytest.mark.parametrize("metric", READERS)
def test_a_port_that_records_steps_but_left_none_raises(monkeypatch,
                                                        metric):
    """The port has the step spans' module, but the ring holds none: a
    step span renamed or taken away, which must not read as nothing."""
    _ring(monkeypatch, [{"cat": "dispatch", "name": "grad", "t0": 0.0,
                         "t1": 1.0, "args": {}}])
    with pytest.raises(LookupError):
        _read(metric, 10)


@pytest.mark.parametrize("metric", READERS)
def test_a_port_without_the_steps_module_has_nothing_to_read(monkeypatch,
                                                             metric):
    monkeypatch.setattr(spans, "STEPS_MODULE",
                        "horovod_tpu_torch.tracing.no_such_module")
    assert spans.ring() is None
    assert _read(metric, 10) is None


def test_the_port_has_the_steps_module():
    assert spans.ring() is not None
