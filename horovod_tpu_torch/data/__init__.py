"""Data-loading utilities (counterpart: ``horovod_tpu/data/``; reference:
``horovod/data/`` + the Spark store's parquet materialization / petastorm
read-back).  The parquet reader needs pyarrow, imported at its first
call."""

from .data_loader import AsyncDataLoaderMixin, BaseDataLoader, ShardedLoader  # noqa: F401,E501
from .parquet import ParquetDataset, ParquetLoader, write_parquet  # noqa: F401,E501

__all__ = ["BaseDataLoader", "AsyncDataLoaderMixin", "ShardedLoader",
           "ParquetDataset", "ParquetLoader", "write_parquet"]
