"""Artifact store for estimator training runs.

Counterpart: ``horovod_tpu/estimator/store.py``, copied; reference parity:
``horovod/spark/common/store.py`` (SURVEY.md §2.2) — the reference's
``Store`` abstracts where intermediate training data, checkpoints, and
logs live (HDFS/S3/local) for its Spark estimators.  A filesystem backend
(a bucket mounted as a filesystem is one too) and an fsspec backend for
remote URLs.  A checkpoint is one pickle; the estimators put CPU tensors
in it, so it loads on a machine without a card.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Any, Optional


class Store:
    """Where estimator runs keep checkpoints and logs."""

    def checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def save_checkpoint(self, run_id: str, obj: Any):
        raise NotImplementedError

    def load_checkpoint(self, run_id: str) -> Any:
        raise NotImplementedError

    def exists(self, run_id: str) -> bool:
        raise NotImplementedError

    @staticmethod
    def create(prefix_path: Optional[str] = None,
               **storage_options) -> "Store":
        """Dispatch on the path scheme (reference: Store.create returns
        HDFSStore/S3Store/GCSStore/LocalStore by URL).  ``gs://``,
        ``s3://``, ``hdfs://``, ``memory://`` (tests) and every other
        fsspec protocol go to :class:`RemoteStore`; bare paths and
        ``file://`` stay on :class:`FilesystemStore`."""
        if prefix_path and "://" in prefix_path:
            scheme = prefix_path.split("://", 1)[0]
            if scheme not in ("file", "local"):
                return RemoteStore(prefix_path, **storage_options)
            prefix_path = prefix_path.split("://", 1)[1]
        if storage_options:
            raise ValueError(
                f"storage_options {sorted(storage_options)} only apply "
                f"to remote URLs (gs://, s3://, ...), not filesystem "
                f"path {prefix_path!r}")
        return FilesystemStore(prefix_path)


class FilesystemStore(Store):
    """Filesystem-backed store (reference: LocalStore/FilesystemStore)."""

    def __init__(self, prefix_path: Optional[str] = None):
        self._own = prefix_path is None
        self.prefix_path = (prefix_path if prefix_path is not None
                            else tempfile.mkdtemp(prefix="hvd_store_"))
        os.makedirs(self.prefix_path, exist_ok=True)

    def _run_dir(self, run_id: str) -> str:
        d = os.path.join(self.prefix_path, run_id)
        os.makedirs(d, exist_ok=True)
        return d

    def checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self._run_dir(run_id), "checkpoint.pkl")

    def logs_path(self, run_id: str) -> str:
        d = os.path.join(self._run_dir(run_id), "logs")
        os.makedirs(d, exist_ok=True)
        return d

    def save_checkpoint(self, run_id: str, obj: Any):
        path = self.checkpoint_path(run_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, path)

    def load_checkpoint(self, run_id: str) -> Any:
        with open(self.checkpoint_path(run_id), "rb") as f:
            return pickle.load(f)

    def exists(self, run_id: str) -> bool:
        return os.path.exists(self.checkpoint_path(run_id))

    def cleanup(self):
        if self._own:
            shutil.rmtree(self.prefix_path, ignore_errors=True)


class RemoteStore(Store):
    """fsspec-backed store for cloud/remote URLs (reference:
    ``horovod/spark/common/store.py`` HDFSStore/S3Store — the remote
    backends the estimators checkpoint through).

    A training job on preemptible machines needs its checkpoints off
    them — ``gs://bucket/prefix`` or ``s3://...``.  Any fsspec protocol
    works; ``memory://`` backs the tests.  Credentials/config ride through
    ``storage_options`` to the fsspec filesystem.
    """

    def __init__(self, prefix_url: str, **storage_options):
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover - baked into image
            raise ImportError(
                "RemoteStore needs fsspec (for gs:// install gcsfs, "
                "s3:// needs s3fs); use FilesystemStore for local "
                "paths") from e
        self.prefix_path = prefix_url.rstrip("/")
        self._fs, self._root = fsspec.core.url_to_fs(
            self.prefix_path, **storage_options)
        self._fs.makedirs(self._root, exist_ok=True)

    def checkpoint_path(self, run_id: str) -> str:
        # pure path computation: probes (exists) must not issue write
        # RPCs or materialize directories for runs that never happened.
        # Returned WITH the protocol — the Store contract (reference:
        # get_checkpoint_path returns full URLs) hands out paths any
        # fsspec-aware consumer can use directly.
        return self._fs.unstrip_protocol(
            f"{self._root}/{run_id}/checkpoint.pkl")

    def logs_path(self, run_id: str) -> str:
        d = f"{self._root}/{run_id}/logs"
        self._fs.makedirs(d, exist_ok=True)
        return self._fs.unstrip_protocol(d)

    def save_checkpoint(self, run_id: str, obj: Any):
        # object stores PUT atomically per key; directory-like backends
        # get tmp+mv (fsspec implements mv as copy+rm where the backend
        # has no rename)
        self._fs.makedirs(f"{self._root}/{run_id}", exist_ok=True)
        path = self.checkpoint_path(run_id)
        tmp = path + ".tmp"
        with self._fs.open(tmp, "wb") as f:
            pickle.dump(obj, f)
        self._fs.mv(tmp, path)

    def load_checkpoint(self, run_id: str) -> Any:
        with self._fs.open(self.checkpoint_path(run_id), "rb") as f:
            return pickle.load(f)

    def exists(self, run_id: str) -> bool:
        return self._fs.exists(self.checkpoint_path(run_id))

    def cleanup(self):
        pass  # remote prefixes are never owned by the process


LocalStore = FilesystemStore  # reference alias
