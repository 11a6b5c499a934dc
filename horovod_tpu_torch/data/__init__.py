"""Data-loading utilities (counterpart: ``horovod_tpu/data/``; reference:
``horovod/data/``).  The parquet reader (``data/parquet.py``) is not
ported yet (ROADMAP.md A8)."""

from .data_loader import AsyncDataLoaderMixin, BaseDataLoader, ShardedLoader  # noqa: F401,E501

__all__ = ["BaseDataLoader", "AsyncDataLoaderMixin", "ShardedLoader"]
