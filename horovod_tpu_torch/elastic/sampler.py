"""Elastic data sampler: reshards the dataset when membership changes.

Counterpart: ``horovod_tpu/elastic/sampler.py``, copied (its indices,
``state_dict`` and re-partitioning are the reference's).  Reference
parity: ``horovod/torch/elastic/sampler.py`` ``ElasticSampler`` —
partitions indices over workers, tracks processed indices within the epoch,
and re-partitions the *remaining* indices over the new worker set after a
reset, so no sample is dropped or duplicated across a resize.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional


class ElasticSampler:
    def __init__(self, dataset_size: int, shuffle: bool = True,
                 seed: int = 0, rank: Optional[int] = None,
                 num_replicas: Optional[int] = None):
        self.dataset_size = dataset_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_num = 0
        self._explicit_rank = rank
        self._explicit_replicas = num_replicas
        self.processed_indices: set = set()
        self.reset()

    @property
    def rank(self) -> int:
        if self._explicit_rank is not None:
            return self._explicit_rank
        from .. import runtime
        return runtime.rank() if runtime.is_initialized() else 0

    @property
    def num_replicas(self) -> int:
        if self._explicit_replicas is not None:
            return self._explicit_replicas
        from .. import runtime
        return runtime.size() if runtime.is_initialized() else 1

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.processed_indices.clear()
        self.processed_num = 0
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int):
        """Mark a batch of indices processed (call after each step).

        Batches are drawn from the current *padded remaining* order (the
        order ``__iter__`` yields, interleaved across workers), so that is
        what gets marked — NOT the full-epoch order, which would re-mark
        already-processed samples after a mid-epoch reset.
        """
        start = batch_idx * batch_size * self.num_replicas
        end = min(start + batch_size * self.num_replicas, len(self._padded))
        for i in range(start, end):
            self.processed_indices.add(self._padded[i])
        self.processed_num = len(self.processed_indices)

    def record_indices(self, indices: List[int]):
        self.processed_indices.update(indices)
        self.processed_num = len(self.processed_indices)

    def reset(self):
        """Re-partition remaining indices over the current worker set.

        Called on elastic reset: already-processed indices are excluded so
        the epoch continues where it left off on the new topology.
        """
        indices = list(range(self.dataset_size))
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(indices)
        self._epoch_indices = indices
        self.remaining_indices = [
            i for i in indices if i not in self.processed_indices]
        n = self.num_replicas
        # pad so every worker sees the same count (reference behavior)
        total = ((len(self.remaining_indices) + n - 1) // n) * n
        pad = total - len(self.remaining_indices)
        padded = self.remaining_indices + self.remaining_indices[:pad]
        self._padded = padded
        self._local = padded[self.rank::n] if padded else []

    def __iter__(self) -> Iterator[int]:
        return iter(self._local)

    def __len__(self) -> int:
        return len(self._local)

    # elastic State integration --------------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch,
                "processed_indices": sorted(self.processed_indices)}

    def load_state_dict(self, sd: dict):
        self.epoch = sd["epoch"]
        self.processed_indices = set(sd["processed_indices"])
        self.processed_num = len(self.processed_indices)
        self.reset()
