"""Data loader base classes.

Counterpart: ``horovod_tpu/data/data_loader.py``; reference parity:
``horovod/data/data_loader_base.py`` (SURVEY.md §2.2) —
``BaseDataLoader`` (the iteration contract used by the elastic sampler
examples) and ``AsyncDataLoaderMixin`` (a background thread prefetches
batches through a bounded queue so host-side data prep overlaps device
compute), both copied.

:class:`ShardedLoader` composes the base contract with the ranks: each
batch of a global batch size is split over the ranks of a process set,
and each rank gets its contiguous share on the runtime's device (the JAX
package places the whole batch sharded over its mesh, which holds the
same rows in the same order).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

_STOP = object()


class BaseDataLoader:
    """Iteration contract (reference: BaseDataLoader).

    Subclasses implement :meth:`__len__` and :meth:`_iterate`; users
    iterate the loader itself.  ``batch_size`` and epoch restarts are the
    subclass's business — this base only fixes the surface the rest of
    the framework (elastic sampler, examples) relies on.
    """

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self._iterate()


class AsyncDataLoaderMixin:
    """Background-thread prefetch (reference: AsyncDataLoaderMixin).

    Mix in BEFORE the loader class::

        class MyAsyncLoader(AsyncDataLoaderMixin, MyLoader): ...

    ``async_loader_queue_size`` bounds prefetch depth (0 = synchronous
    passthrough).  ``close()`` joins the worker thread; iteration
    re-raises any producer exception at the consumption point.
    """

    def __init__(self, *args, async_loader_queue_size: int = 4, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        super().__init__(*args, **kwargs)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_requested: Optional[threading.Event] = None

    def _producer(self, q: queue.Queue, stop: threading.Event):
        def bounded_put(item) -> bool:
            # stays responsive to close(): a consumer that abandons
            # iteration must not strand this thread on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for batch in super()._iterate():
                if not bounded_put(batch):
                    return
        except Exception as e:  # noqa: BLE001 - re-raised on the consumer
            bounded_put(e)
        finally:
            # the consumer waits for _STOP on normal completion, so it
            # must be delivered (the queue may be full right now); only
            # close() skips the wait, and it sets `stop`
            bounded_put(_STOP)

    def _iterate(self) -> Iterator[Any]:
        if self.async_loader_queue_size <= 0:
            yield from super()._iterate()
            return
        self.close()  # reclaim a producer from an abandoned iteration
        q = queue.Queue(self.async_loader_queue_size)
        stop = threading.Event()
        self._queue, self._stop_requested = q, stop
        self._thread = threading.Thread(
            target=self._producer, args=(q, stop),
            name="hvd-data-loader", daemon=True)
        self._thread.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self.close()

    def close(self):
        """Stop and join the prefetch thread (reference: shutdown_async)."""
        t, self._thread = self._thread, None
        stop, self._stop_requested = self._stop_requested, None
        if t is not None and t.is_alive():
            if stop is not None:
                stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)


class ShardedLoader(BaseDataLoader):
    """Shard a dataset over the ranks, one batch at a time.

    Every global batch of ``global_batch_size`` rows is split evenly over
    the ranks of ``process_set`` in rank order; this rank gets its share
    of each array on the runtime's device (rank r of n: rows
    ``[r * b / n, (r + 1) * b / n)`` of the batch).

    Args:
      arrays: tuple of same-length arrays or tensors (e.g. (x, y)).
      global_batch_size: rows per step across ALL ranks; must divide by
        the rank count.
      process_set: the ranks to shard over; defaults to the global set.
      drop_last: drop the trailing partial batch (default True — the
        JAX package's static shapes).
    """

    def __init__(self, arrays, global_batch_size: int, process_set=None,
                 drop_last: bool = True):
        import torch
        from .. import runtime
        self._arrays = tuple(torch.as_tensor(a) for a in arrays)
        if not self._arrays:
            raise ValueError("need at least one array")
        n = len(self._arrays[0])
        if any(len(a) != n for a in self._arrays):
            raise ValueError("arrays must share their leading dimension")
        ps = process_set or runtime._get_global_process_set()
        if not ps.included():
            raise ValueError(f"this rank is not in {ps}")
        if global_batch_size % ps.size():
            raise ValueError(
                f"global_batch_size {global_batch_size} not divisible by "
                f"{ps.size()} workers")
        if not drop_last and (n % global_batch_size) % ps.size():
            raise ValueError(
                f"drop_last=False needs the trailing batch "
                f"({n % global_batch_size} rows) divisible by "
                f"{ps.size()} workers for the batch sharding")
        self._bs = global_batch_size
        self._n = n
        self._drop_last = drop_last
        self._rank, self._size = ps.rank(), ps.size()
        self._device = runtime.device()

    def __len__(self) -> int:
        full, rem = divmod(self._n, self._bs)
        return full if (self._drop_last or rem == 0) else full + 1

    def _iterate(self):
        for i in range(len(self)):
            lo = i * self._bs
            share = (min(self._bs, self._n - lo)) // self._size
            lo += self._rank * share
            yield tuple(a[lo:lo + share].to(self._device, non_blocking=True)
                        for a in self._arrays)
