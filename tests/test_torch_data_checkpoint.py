"""The port's data loaders against the JAX package's on the same numpy
arrays (``tests/test_data_loader.py``'s cases), and its checkpoints:
save, restore, ``latest_step`` and asynchronous save in one process and
with two gloo ranks, where rank 0 writes and both restore equal trees."""

import threading

import numpy as np
import pytest
import torch

import horovod_tpu_torch as tp
from horovod_tpu.data import AsyncDataLoaderMixin as JAsyncMixin
from horovod_tpu.data import BaseDataLoader as JBaseLoader
from horovod_tpu.data import ShardedLoader as JShardedLoader
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.data import (AsyncDataLoaderMixin, BaseDataLoader,
                                    ShardedLoader)

import torch_ranks


@pytest.fixture(scope="module")
def port():
    tp.init(device="cpu")
    yield tp
    tp.shutdown()


def _list_loader(base):
    class ListLoader(base):
        def __init__(self, items):
            self.items = list(items)

        def __len__(self):
            return len(self.items)

        def _iterate(self):
            yield from self.items

    return ListLoader


_ListLoader = _list_loader(BaseDataLoader)


class _AsyncListLoader(AsyncDataLoaderMixin, _ListLoader):
    pass


class _JAsyncListLoader(JAsyncMixin, _list_loader(JBaseLoader)):
    pass


def test_base_loader_contract():
    dl = _ListLoader([1, 2, 3])
    assert len(dl) == 3
    assert list(dl) == [1, 2, 3]
    assert list(dl) == [1, 2, 3]  # re-iterable


@pytest.mark.parametrize("queue_size", [0, 1, 3])
def test_async_prefetch_matches_the_reference(queue_size):
    got = _AsyncListLoader(range(20), async_loader_queue_size=queue_size)
    want = _JAsyncListLoader(range(20), async_loader_queue_size=queue_size)
    assert list(got) == list(want) == list(range(20))
    assert list(got) == list(range(20))
    assert got._thread is None         # joined (queue 0: never started)


def test_async_producer_exception_surfaces():
    class _Inner(BaseDataLoader):
        def __len__(self):
            return 1

        def _iterate(self):
            yield 1
            raise RuntimeError("producer exploded")

    class _AsyncBoom(AsyncDataLoaderMixin, _Inner):
        pass

    with pytest.raises(RuntimeError, match="producer exploded"):
        list(_AsyncBoom(async_loader_queue_size=2))


def test_async_abandoned_iteration_reclaims_producer():
    dl = _AsyncListLoader(range(1000), async_loader_queue_size=2)
    it = iter(dl)
    assert next(it) == 0 and next(it) == 1
    t = dl._thread
    dl.close()
    assert t is not None and not t.is_alive()
    assert list(dl) == list(range(1000))
    assert not any(th.name == "hvd-data-loader" and th.is_alive()
                   for th in threading.enumerate())


def _rows(batches):
    return [[np.asarray(a) for a in b] for b in batches]


def test_sharded_loader_matches_the_reference(hvd, port):
    """At world 1 this rank's share is the whole global batch: the JAX
    loader's batches, value for value, on the runtime's device."""
    x = np.arange(64, dtype=np.float32).reshape(32, 2)
    y = np.arange(32, dtype=np.int32)
    got = list(ShardedLoader((x, y), global_batch_size=16))
    want = _rows(JShardedLoader((x, y), global_batch_size=16))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert all(t.device == tp.runtime.device() for t in g)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)


def test_sharded_loader_validation(hvd, port):
    x = np.zeros((10, 2), np.float32)
    for cls in (JShardedLoader, ShardedLoader):
        with pytest.raises(ValueError, match="leading"):
            cls((x, np.zeros(9)), global_batch_size=8)
        with pytest.raises(ValueError, match="at least one"):
            cls((), global_batch_size=8)


def test_sharded_loader_drop_last_false(port):
    x = np.arange(48, dtype=np.float32).reshape(24, 2)
    dl = ShardedLoader((x,), global_batch_size=16, drop_last=False)
    assert len(dl) == 2
    batches = list(dl)
    assert batches[1][0].shape == (8, 2)
    np.testing.assert_array_equal(batches[1][0].numpy(), x[16:])
    assert len(ShardedLoader((x,), global_batch_size=16)) == 1


def test_sharded_async_composition(hvd, port):
    class AsyncSharded(AsyncDataLoaderMixin, ShardedLoader):
        pass

    class JAsyncSharded(JAsyncMixin, JShardedLoader):
        pass

    x = np.arange(32, dtype=np.float32).reshape(32, 1)
    got = list(AsyncSharded((x,), global_batch_size=8,
                            async_loader_queue_size=2))
    want = _rows(JAsyncSharded((x,), global_batch_size=8,
                               async_loader_queue_size=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w[0])


def test_sharded_loader_at_world_2(tmp_path, hvd):
    """Two gloo ranks: rank r gets rows [8r, 8r + 8) of each global batch
    of 16; the ranks' shares, concatenated, are the JAX loader's global
    batches."""
    res = torch_ranks.launch(2, ["sharded_loader"], tmp_path)
    x, y = torch_ranks.loader_data()
    want = _rows(JShardedLoader((x, y), global_batch_size=16))
    for kind in ("plain", "async"):
        shares = [r["sharded_loader"][kind] for r in res]
        assert len(shares[0]) == len(shares[1]) == len(want) == 2
        for i, w in enumerate(want):
            for k in range(2):
                np.testing.assert_array_equal(
                    np.concatenate([np.asarray(shares[r][i][k])
                                    for r in range(2)]), w[k])


# --- checkpoints ----------------------------------------------------------------

def _tree(v):
    return {"w": torch.full((2, 3), v),
            "layers": [{"b": torch.arange(4, dtype=torch.bfloat16) + v}],
            "step": int(v)}


def test_checkpoint_save_restore_latest_step(tmp_path, port):
    d = tmp_path / "ckpt"
    assert checkpoint.latest_step(str(d)) is None
    checkpoint.save(str(d), _tree(1.0), step=3)
    checkpoint.save(str(d), _tree(2.0), step=10)
    assert checkpoint.latest_step(str(d)) == 10
    like = {"w": torch.zeros(2, 3, dtype=torch.float64),
            "layers": [{"b": torch.zeros(4, dtype=torch.bfloat16)}],
            "step": 0}
    r = checkpoint.restore(str(d), like, step=3)
    assert r["w"].dtype == torch.float64 and r["step"] == 1
    np.testing.assert_array_equal(r["w"].numpy(), np.full((2, 3), 1.0))
    assert torch.equal(r["layers"][0]["b"], _tree(1.0)["layers"][0]["b"])
    with pytest.raises(FileExistsError, match="force=True"):
        checkpoint.save(str(d), _tree(5.0), step=3)
    checkpoint.save(str(d), _tree(5.0), step=3, force=True)
    assert checkpoint.restore(str(d), like, step=3)["step"] == 5
    # an unstepped checkpoint at the path itself
    checkpoint.save(str(d / "plain"), {"x": torch.ones(2)})
    assert torch.equal(checkpoint.restore(str(d / "plain"),
                                          {"x": torch.zeros(2)})["x"],
                       torch.ones(2))
    # a directory without a whole file is not a step
    (d / "11").mkdir()
    assert checkpoint.latest_step(str(d)) == 10


def test_checkpoint_asynchronous_save(tmp_path, port):
    d = tmp_path / "ckpt"
    src = _tree(3.0)
    checkpoint.save(str(d), src, step=1, asynchronous=True)
    src["w"].add_(100.0)          # the host copy was taken at save()
    checkpoint.wait()
    r = checkpoint.restore(str(d), _tree(0.0), step=1)
    np.testing.assert_array_equal(r["w"].numpy(), np.full((2, 3), 3.0))
    checkpoint.save(str(d), _tree(4.0), step=2, asynchronous=True)
    checkpoint.save(str(d), _tree(5.0), step=3, asynchronous=True)
    checkpoint.wait()
    assert checkpoint.latest_step(str(d)) == 3
    assert checkpoint.restore(str(d), _tree(0.0), step=2)["step"] == 4


def test_checkpoint_with_two_ranks(tmp_path):
    """Rank 0 writes (its values win), the asynchronous save lands by
    wait(), a forced save overwrites, and both ranks restore equal
    trees onto the exemplar's dtypes."""
    d = tmp_path / "ckpt"
    res = torch_ranks.launch(2, ["checkpoint"], tmp_path,
                             env={"HVD_TEST_CKPT": str(d)})
    r0, r1 = (r["checkpoint"] for r in res)
    assert r0 == r1
    assert r0["latest"] == 2
    assert r0[1]["w"] == np.full((2, 3), 20.0).tolist()
    assert r0[1]["step"] == 20 and r0[2]["step"] == 10
    assert r0[2]["b"] == (np.arange(4) + 10.0).tolist()
    assert (r0[1]["w_dtype"], r0[1]["b_dtype"]) == ("torch.float64",
                                                    "torch.bfloat16")
