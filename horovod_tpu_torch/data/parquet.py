"""Out-of-core parquet datasets: the estimators' on-disk data plane.

Counterpart: ``horovod_tpu/data/parquet.py``, copied (it imports only
numpy; pyarrow is imported inside the functions, so ``import
horovod_tpu_torch`` works where pyarrow is absent, and a call there
raises an ``ImportError`` naming it).  The reader yields numpy arrays on
the host, as the JAX package's does; moving a batch to the card is the
caller's ``torch.from_numpy(...).to(device)``.

Reference parity: the reference's Spark estimators never ship training
data through the task payload — the Store materializes the DataFrame as
parquet and every worker reads back only its shard through Petastorm
(``horovod/spark/common/store.py`` + petastorm readers; SURVEY.md §2.2
Spark row).  This module is that data flow rebuilt for this stack:

* :func:`write_parquet` materializes named numpy columns with a chosen
  row-group size (the out-of-core granule);
* :class:`ParquetDataset` is a cheap, picklable handle (path + column
  selection) workers open themselves — the launcher payload carries the
  path, never the data;
* :meth:`ParquetDataset.read_shard` streams row groups and keeps only
  this worker's strided rows (``global_row % nproc == rank``), so the
  result is EXACTLY the ``X[rank::nproc]`` shard of the in-memory path
  — estimator loss histories from disk and from memory are identical —
  while peak memory is one row group plus the worker's own shard;
* :meth:`ParquetDataset.iter_batches` goes further: row-group-sharded
  windowed-shuffle streaming for datasets whose SHARD exceeds memory
  (peak = one row group + shuffle buffer + one batch).
  :class:`ParquetLoader` wraps it in the :class:`BaseDataLoader`
  contract (composable with :class:`AsyncDataLoaderMixin`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .data_loader import BaseDataLoader


def _pyarrow():
    """``(pyarrow, pyarrow.parquet)``, or an ImportError naming pyarrow."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.data's parquet reader needs pyarrow, which "
            "is not installed here") from e
    return pa, pq


def write_parquet(path: str, columns: Dict[str, np.ndarray],
                  rows_per_group: int = 4096) -> None:
    """Materialize named numpy columns as one parquet file.

    ``rows_per_group`` sets the row-group size — the unit of streaming
    I/O and of :meth:`ParquetDataset.iter_batches` sharding; pick it so
    one group fits comfortably in memory (reference: the Spark store's
    parquet materialization step).
    """
    pa, pq = _pyarrow()
    if not columns:
        raise ValueError("need at least one column")
    n = len(next(iter(columns.values())))
    if any(len(v) != n for v in columns.values()):
        raise ValueError("columns must share their leading dimension")
    table = pa.table({k: pa.array(np.asarray(v)) for k, v in columns.items()})
    pq.write_table(table, path, row_group_size=rows_per_group)


class ParquetDataset:
    """Handle to a parquet file or a directory of ``*.parquet`` shards.

    Picklable by (path, columns) — a worker that receives this handle
    opens the files itself and reads only its shard; the handle is what
    rides the launcher's cloudpickle payload.

    Args:
      path: a ``.parquet`` file or a directory of them (sorted by name,
        concatenated in order — the multi-writer layout).
      features: feature column names, stacked in order into the 2-D
        ``X`` matrix by :meth:`read_xy`.  Default: every column except
        ``label``.
      label: label column name for :meth:`read_xy` (default ``"y"``).
    """

    def __init__(self, path: str, features: Optional[Sequence[str]] = None,
                 label: str = "y"):
        self.path = path
        self.label = label
        self._features = list(features) if features is not None else None
        self._files: Optional[List[str]] = None
        self._meta = None

    def __reduce__(self):
        return (ParquetDataset, (self.path, self._features, self.label))

    # -- metadata -----------------------------------------------------------

    def _file_list(self) -> List[str]:
        if self._files is None:
            if os.path.isdir(self.path):
                self._files = sorted(
                    os.path.join(self.path, f)
                    for f in os.listdir(self.path)
                    if f.endswith(".parquet"))
                if not self._files:
                    raise FileNotFoundError(
                        f"no *.parquet files under {self.path}")
            else:
                self._files = [self.path]
        return self._files

    def _metadata(self):
        """[(file, row_group_index, num_rows, global_offset), ...]"""
        pq = _pyarrow()[1]
        if self._meta is None:
            meta, off = [], 0
            for f in self._file_list():
                md = pq.ParquetFile(f).metadata
                for g in range(md.num_row_groups):
                    rows = md.row_group(g).num_rows
                    meta.append((f, g, rows, off))
                    off += rows
            self._meta = meta
        return self._meta

    @property
    def num_rows(self) -> int:
        m = self._metadata()
        return (m[-1][2] + m[-1][3]) if m else 0

    @property
    def columns(self) -> List[str]:
        pq = _pyarrow()[1]
        schema = pq.ParquetFile(self._file_list()[0]).schema_arrow
        return list(schema.names)

    def feature_columns(self) -> List[str]:
        if self._features is not None:
            return list(self._features)
        return [c for c in self.columns if c != self.label]

    # -- streaming reads ----------------------------------------------------

    def _iter_row_groups(self, columns: Sequence[str],
                         groups: Optional[Sequence[int]] = None
                         ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Yield ``(global_offset, {col: ndarray})`` one row group at a
        time — the only place that touches pyarrow readers."""
        pq = _pyarrow()[1]
        meta = self._metadata()
        take = range(len(meta)) if groups is None else groups
        open_file, pf = None, None
        for gi in take:
            fname, g, _rows, off = meta[gi]
            if fname != open_file:
                pf = pq.ParquetFile(fname)
                open_file = fname
            tbl = pf.read_row_group(g, columns=list(columns))
            yield off, {c: tbl.column(c).to_numpy(zero_copy_only=False)
                        for c in columns}

    def read_shard(self, rank: int = 0, nproc: int = 1,
                   columns: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
        """This worker's strided rows (``global_row % nproc == rank``),
        streamed row group by row group.

        The result equals ``{c: col[rank::nproc]}`` of the full dataset
        — the same shard the in-memory estimator path takes — without
        any process ever holding the full dataset.
        """
        cols = list(columns) if columns is not None else self.columns
        parts: Dict[str, List[np.ndarray]] = {c: [] for c in cols}
        for off, data in self._iter_row_groups(cols):
            start = (rank - off) % nproc
            for c in cols:
                parts[c].append(data[c][start::nproc])
        return {c: (np.concatenate(parts[c]) if parts[c]
                    else np.empty((0,))) for c in cols}

    def read_xy(self, rank: int = 0, nproc: int = 1
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Shard as ``(X, y)``: feature columns stacked into a 2-D float
        matrix (order = ``features``), label as an ``(n, 1)`` column —
        the estimator contract."""
        feats = self.feature_columns()
        shard = self.read_shard(rank, nproc, columns=feats + [self.label])
        X = np.column_stack([shard[c] for c in feats])
        y = shard[self.label].reshape(-1, 1)
        return X, y

    def iter_batches(self, batch_size: int, rank: int = 0, nproc: int = 1,
                     columns: Optional[Sequence[str]] = None,
                     shuffle_buffer: int = 0, seed: int = 0,
                     drop_last: bool = True
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream batches from this worker's ROW-GROUP shard
        (``groups[rank::nproc]``) with an optional windowed shuffle.

        For shards too large to materialize: peak memory is one row
        group + ``shuffle_buffer`` rows + one batch.  With a nonzero
        buffer the row-group visit order is permuted per epoch
        (``seed``) and rows are permuted within each
        leftover+row-group window — the streaming analog of a full
        permutation (Petastorm's reader semantics, not bit-identical to
        the in-memory shuffle).  Per-batch cost is a slice; the merge +
        window permutation happens once per row group.
        """
        cols = list(columns) if columns is not None else self.columns
        n_groups = len(self._metadata())
        mine = list(range(rank, n_groups, nproc))
        rng = np.random.RandomState(seed)
        if shuffle_buffer > 0:
            rng.shuffle(mine)
        merged: Optional[Dict[str, np.ndarray]] = None
        cursor = 0

        def held() -> int:
            return 0 if merged is None else len(merged[cols[0]]) - cursor

        for _off, data in self._iter_row_groups(cols, groups=mine):
            # fold the unemitted leftover into the fresh group; one
            # concatenate + (shuffled mode) one permutation per group
            if merged is None or held() == 0:
                merged = dict(data)
            else:
                merged = {c: np.concatenate([merged[c][cursor:], data[c]])
                          for c in cols}
            cursor = 0
            if shuffle_buffer > 0:
                perm = rng.permutation(len(merged[cols[0]]))
                merged = {c: merged[c][perm] for c in cols}
            # drain down to the buffer watermark so later groups still
            # have rows to mix with; batches are O(batch) slices
            while held() - batch_size >= shuffle_buffer:
                yield {c: merged[c][cursor:cursor + batch_size]
                       for c in cols}
                cursor += batch_size
        while held() >= batch_size:
            yield {c: merged[c][cursor:cursor + batch_size] for c in cols}
            cursor += batch_size
        if not drop_last and held():
            yield {c: merged[c][cursor:] for c in cols}

    def shard_rows(self, rank: int = 0, nproc: int = 1) -> int:
        """Row count of this worker's row-group shard (iter_batches)."""
        meta = self._metadata()
        return sum(meta[g][2] for g in range(rank, len(meta), nproc))


class ParquetLoader(BaseDataLoader):
    """:class:`BaseDataLoader` over :meth:`ParquetDataset.iter_batches`
    (compose with :class:`AsyncDataLoaderMixin` for background
    prefetch)::

        class Prefetching(AsyncDataLoaderMixin, ParquetLoader): ...
    """

    def __init__(self, dataset: ParquetDataset, batch_size: int,
                 rank: int = 0, nproc: int = 1,
                 columns: Optional[Sequence[str]] = None,
                 shuffle_buffer: int = 0, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.nproc = rank, nproc
        self.columns = columns
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return self.dataset.shard_rows(
            self.rank, self.nproc) // self.batch_size

    def _iterate(self):
        epoch, self._epoch = self._epoch, self._epoch + 1
        return self.dataset.iter_batches(
            self.batch_size, self.rank, self.nproc, columns=self.columns,
            shuffle_buffer=self.shuffle_buffer, seed=self.seed + epoch)
