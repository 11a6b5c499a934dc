"""The port's parquet reader (``horovod_tpu_torch/data/parquet.py``)
against the JAX package's (``tests/test_data_loader.py``'s nine parquet
cases on the port), and both packages' ``read_shard``/``iter_batches``
on the same files: the same rows in the same order, for every rank,
shuffle buffer and seed.  pyarrow is imported at a call, not at import:
without it a call raises an ImportError naming it."""

import pickle
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu.data import ParquetDataset as JDataset
from horovod_tpu.data import ParquetLoader as JLoader
from horovod_tpu_torch.data import (AsyncDataLoaderMixin, ParquetDataset,
                                    ParquetLoader, write_parquet)


def _write_dataset(path, n=1000, d=3, seed=0, rows_per_group=64):
    rng = np.random.RandomState(seed)
    cols = {f"x{i}": rng.randn(n).astype(np.float32) for i in range(d)}
    cols["y"] = rng.randn(n).astype(np.float32)
    write_parquet(str(path), cols, rows_per_group=rows_per_group)
    return cols


# --- tests/test_data_loader.py's parquet cases -------------------------------

def test_parquet_metadata_and_columns(tmp_path):
    p = tmp_path / "d.parquet"
    _write_dataset(p, n=300, rows_per_group=64)
    ds = ParquetDataset(str(p))
    assert ds.num_rows == 300
    assert set(ds.columns) == {"x0", "x1", "x2", "y"}
    assert ds.feature_columns() == ["x0", "x1", "x2"]
    # row groups honor the requested granule (the out-of-core unit)
    assert len(ds._metadata()) == 5   # ceil(300/64)


def test_parquet_read_shard_equals_strided_rows(tmp_path):
    """read_shard must equal the in-memory path's X[rank::nproc]
    exactly."""
    p = tmp_path / "d.parquet"
    cols = _write_dataset(p, n=257, rows_per_group=32)  # ragged tail
    ds = ParquetDataset(str(p))
    for nproc in (1, 2, 3):
        for rank in range(nproc):
            shard = ds.read_shard(rank, nproc)
            for c, full in cols.items():
                np.testing.assert_array_equal(shard[c], full[rank::nproc])


def test_parquet_read_xy_contract(tmp_path):
    p = tmp_path / "d.parquet"
    cols = _write_dataset(p, n=100, d=2)
    ds = ParquetDataset(str(p), features=["x1", "x0"], label="y")
    X, y = ds.read_xy(0, 2)
    assert X.shape == (50, 2) and y.shape == (50, 1)
    np.testing.assert_array_equal(X[:, 0], cols["x1"][0::2])  # order kept
    np.testing.assert_array_equal(X[:, 1], cols["x0"][0::2])


def test_parquet_directory_of_shards(tmp_path):
    a = {"x0": np.arange(10, dtype=np.float32),
         "y": np.zeros(10, dtype=np.float32)}
    b = {"x0": np.arange(10, 16, dtype=np.float32),
         "y": np.ones(6, dtype=np.float32)}
    write_parquet(str(tmp_path / "part-000.parquet"), a, rows_per_group=4)
    write_parquet(str(tmp_path / "part-001.parquet"), b, rows_per_group=4)
    ds = ParquetDataset(str(tmp_path))
    assert ds.num_rows == 16
    np.testing.assert_array_equal(
        ds.read_shard(0, 1)["x0"], np.arange(16, dtype=np.float32))


def test_parquet_iter_batches_streams_all_rows(tmp_path):
    p = tmp_path / "d.parquet"
    cols = _write_dataset(p, n=640, rows_per_group=64)
    ds = ParquetDataset(str(p))
    # unshuffled single worker: batches reproduce the file order exactly
    got = np.concatenate([b["x0"] for b in ds.iter_batches(32)])
    np.testing.assert_array_equal(got, cols["x0"])
    # 2-worker row-group shard: together they cover every row exactly once
    all_rows = np.concatenate(
        [b["x0"] for r in range(2) for b in ds.iter_batches(32, r, 2)])
    np.testing.assert_array_equal(np.sort(all_rows), np.sort(cols["x0"]))


def test_parquet_iter_batches_windowed_shuffle(tmp_path):
    p = tmp_path / "d.parquet"
    cols = _write_dataset(p, n=512, rows_per_group=64)
    ds = ParquetDataset(str(p))
    batches = list(ds.iter_batches(32, shuffle_buffer=128, seed=7))
    got = np.concatenate([b["x0"] for b in batches])
    assert len(got) == 512
    # a shuffle happened...
    assert not np.array_equal(got, cols["x0"])
    # ...but it is a permutation (every row exactly once)
    np.testing.assert_array_equal(np.sort(got), np.sort(cols["x0"]))
    # rows stay aligned across columns after shuffling
    idx = np.argsort(got)
    ygot = np.concatenate([b["y"] for b in batches])[idx]
    np.testing.assert_array_equal(ygot, cols["y"][np.argsort(cols["x0"])])
    # deterministic for a fixed seed
    again = np.concatenate(
        [b["x0"] for b in ds.iter_batches(32, shuffle_buffer=128, seed=7)])
    np.testing.assert_array_equal(got, again)


def test_parquet_iter_batches_drop_last(tmp_path):
    p = tmp_path / "d.parquet"
    _write_dataset(p, n=100, rows_per_group=32)
    ds = ParquetDataset(str(p))
    dropped = list(ds.iter_batches(32))
    assert [len(b["x0"]) for b in dropped] == [32, 32, 32]
    kept = list(ds.iter_batches(32, drop_last=False))
    assert [len(b["x0"]) for b in kept] == [32, 32, 32, 4]


class _AsyncParquetLoader(AsyncDataLoaderMixin, ParquetLoader):
    pass


def test_parquet_loader_contract_and_async(tmp_path):
    p = tmp_path / "d.parquet"
    cols = _write_dataset(p, n=320, rows_per_group=64)
    ds = ParquetDataset(str(p))
    dl = ParquetLoader(ds, batch_size=32, rank=1, nproc=2)
    assert len(dl) == ds.shard_rows(1, 2) // 32
    rows = np.concatenate([b["x0"] for b in dl])
    # rank 1's row-group shard, in order
    exp = np.concatenate([cols["x0"][64:128], cols["x0"][192:256]])
    np.testing.assert_array_equal(rows, exp)
    adl = _AsyncParquetLoader(ds, batch_size=32, async_loader_queue_size=2)
    got = np.concatenate([b["x0"] for b in adl])
    np.testing.assert_array_equal(got, cols["x0"])
    adl.close()


def test_parquet_dataset_pickles_as_handle(tmp_path):
    p = tmp_path / "d.parquet"
    _write_dataset(p, n=64)
    ds = ParquetDataset(str(p), features=["x0"], label="y")
    blob = pickle.dumps(ds)
    # the handle is tiny: the path rides the payload, never the data
    assert len(blob) < 512
    ds2 = pickle.loads(blob)
    assert ds2.num_rows == 64 and ds2.feature_columns() == ["x0"]


# --- against the JAX package ------------------------------------------------

def _same(a, b):
    assert sorted(a) == sorted(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        np.testing.assert_array_equal(a[c], b[c])


@pytest.mark.parametrize("n,rows_per_group", [(257, 32), (640, 64)])
def test_read_shard_and_batches_match_jax(tmp_path, n, rows_per_group):
    """The same file read by both packages: ``read_shard`` and
    ``read_xy`` of every rank, and ``iter_batches`` (plain, windowed
    shuffle under two seeds, keeping the ragged last batch) give the
    same rows in the same order."""
    p = tmp_path / "d.parquet"
    _write_dataset(p, n=n, rows_per_group=rows_per_group, seed=n)
    ours, theirs = ParquetDataset(str(p)), JDataset(str(p))
    assert ours.num_rows == theirs.num_rows and \
        ours.columns == theirs.columns
    for nproc in (1, 2, 3):
        for rank in range(nproc):
            _same(ours.read_shard(rank, nproc),
                  theirs.read_shard(rank, nproc))
            for a, b in zip(ours.read_xy(rank, nproc),
                            theirs.read_xy(rank, nproc)):
                np.testing.assert_array_equal(a, b)
            assert ours.shard_rows(rank, nproc) == \
                theirs.shard_rows(rank, nproc)
            for kw in ({}, {"shuffle_buffer": 96, "seed": 3},
                       {"shuffle_buffer": 40, "seed": 11,
                        "drop_last": False}):
                got = list(ours.iter_batches(16, rank, nproc, **kw))
                want = list(theirs.iter_batches(16, rank, nproc, **kw))
                assert len(got) == len(want), kw
                for a, b in zip(got, want):
                    _same(a, b)
    got = [b["x1"] for b in ParquetLoader(ours, 16, 1, 2, seed=5,
                                          shuffle_buffer=32)]
    want = [b["x1"] for b in JLoader(theirs, 16, 1, 2, seed=5,
                                     shuffle_buffer=32)]
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_files_written_by_either_package_read_alike(tmp_path):
    from horovod_tpu.data import write_parquet as jwrite
    rng = np.random.RandomState(4)
    cols = {"a": rng.randn(70).astype(np.float32),
            "y": rng.randint(0, 9, 70).astype(np.int64)}
    write_parquet(str(tmp_path / "t.parquet"), cols, rows_per_group=16)
    jwrite(str(tmp_path / "j.parquet"), cols, rows_per_group=16)
    _same(ParquetDataset(str(tmp_path / "j.parquet")).read_shard(),
          JDataset(str(tmp_path / "t.parquet")).read_shard())


def test_without_pyarrow_a_call_names_it(tmp_path):
    """``import horovod_tpu_torch.data`` needs no pyarrow; a call
    without it raises an ImportError that names it."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pyarrow.parquet'] = None\n"
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch.data import ParquetDataset, write_parquet\n"
        "try:\n"
        "    write_parquet('x.parquet', {'a': [1]})\n"
        "except ImportError as e:\n"
        "    assert 'pyarrow' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
        "try:\n"
        "    ParquetDataset('x.parquet').num_rows\n"
        "except ImportError as e:\n"
        "    assert 'pyarrow' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(
                             __import__("pathlib").Path(
                                 __file__).resolve().parents[1])})
    assert res.returncode == 0, res.stdout + res.stderr
