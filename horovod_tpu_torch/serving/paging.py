"""Paged KV cache: block-allocated serving memory with prefix reuse.

The dense serving decode pays ``batch x bucket_max`` KV bytes for every
micro-batch regardless of actual prompt lengths — a 5-token request in
a 128-token bucket holds 128 slots of HBM hostage for its whole decode.
This module prices KV by what rows actually use: a fixed pool of
``block_size``-token blocks (``models/generate.py PagedKVCache``), a
host-side :class:`BlockAllocator` handing block ids to rows, and a
per-row block-index table the device-side forward reads/writes through.
Row ``b`` holds ``ceil((length_b + max_new) / block)`` REAL blocks;
table entries past that point at a shared trash block whose logical
positions exceed every query position the row ever attends.

Prefix reuse: blocks fully covered by a request's PROMPT are immutable
after prefill (decode writes start past the prompt), so the allocator
content-addresses them — a chained digest per block position — and a
request whose prompt head matches a cached chain shares those blocks
instead of allocating fresh ones.  Divergence is copy-on-write at the
first divergent block: since the serving prefill rewrites every private
block wholly from the row's own tokens, the "copy" is free — the
diverging row simply gets a fresh block there (shared blocks receive
only value-identical duplicate writes: same tokens, same absolute
positions, same weights).  Completed requests release their refcounts;
zero-ref prefix blocks stay CACHED (reusable across completed
requests) until allocation pressure evicts them LRU-first — so
:meth:`BlockAllocator.assign` only raises :class:`BlocksExhausted`
when live references truly exceed the pool, which
:class:`PagedDecodeForward`'s constructor sizing guard makes
impossible mid-batch (exhaustion surfaces at admission, never as a
device OOM).

Accounting is EXACT, the ``sharded_tile_layout`` precedent: one block's
bytes are ``pool_nbytes / n_blocks`` with zero remainder, and
``tools/bench_serve.py --paged`` gates the allocator's ledger against
``tree_nbytes`` of the live pool.

Counterpart: ``horovod_tpu/serving/paging.py``.  The allocator and the
byte helpers are copied; :class:`PagedDecodeForward` keeps the pool as
two device tensors that live as long as the forward and that every
call writes in place (JAX donates the pool's buffers to each call for
the same effect), so no call copies the pool.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import metrics as _metrics
from .worker import BucketedForward

# -- metric families (docs/metrics.md; sites guard on _metrics.ACTIVE) --------
_m_kv_blocks = _metrics.gauge(
    "hvd_serve_kv_blocks",
    "Paged-KV pool blocks by state (allocated = live request refs, "
    "cached = zero-ref prefix blocks kept for reuse, free = never "
    "written or evicted)", labels=("state",))
_m_kv_bytes = _metrics.gauge(
    "hvd_serve_kv_bytes",
    "Paged-KV pool bytes: allocated = blocks live requests reference "
    "x exact per-block bytes; capacity = the whole pool",
    labels=("kind",))
_m_kv_reuse = _metrics.counter(
    "hvd_serve_kv_reuse_total",
    "Prompt-head blocks served from the prefix cache instead of a "
    "fresh allocation (the shared-prompt memory win bench_serve's "
    "--paged reuse gate measures)")


class BlocksExhausted(RuntimeError):
    """The pool cannot cover an allocation even after evicting every
    zero-ref cached prefix block.  Admission-level: the caller rejects
    the request; a dispatched batch never sees this (the forward's
    constructor guarantees worst-case batch coverage)."""


def row_blocks(length: int, max_new_tokens: int, block_size: int) -> int:
    """REAL blocks a row of true prompt ``length`` needs to decode
    ``max_new_tokens`` — the per-row paged cost, vs the dense path's
    unconditional ``bucket_max``."""
    return -(-(int(length) + int(max_new_tokens)) // int(block_size))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kv_block_nbytes(cfg, block_size: int, dtype=None) -> int:
    """Exact bytes of ONE pool block across all layers (k + v)."""
    itemsize = _itemsize(dtype or cfg.dtype)
    return (2 * cfg.n_layers * int(block_size) * cfg.n_kv_heads
            * cfg.head_dim * itemsize)


def dense_kv_nbytes(cfg, batch: int, max_len: int, dtype=None) -> int:
    """Exact bytes of the dense ``[batch, max_len]`` KV cache the paged
    pool replaces (``init_kv_cache``'s k + v buffers)."""
    itemsize = _itemsize(dtype or cfg.dtype)
    return (2 * cfg.n_layers * int(batch) * int(max_len)
            * cfg.n_kv_heads * cfg.head_dim * itemsize)


class BlockHandle:
    """One request's block grant: the ordered REAL block ids (logical
    block ``j`` of the row lives in pool block ``blocks[j]``) and how
    many of them came from the prefix cache."""

    __slots__ = ("blocks", "shared")

    def __init__(self, blocks: Tuple[int, ...], shared: int):
        self.blocks = blocks
        self.shared = shared


class BlockAllocator:
    """Host-side pool bookkeeping: refcounts, prefix cache, free list.

    Block 0 is the reserved TRASH block — never granted, the sink for
    pad rows and per-row table tails (garbage lands there; no real
    row's mask ever lets it be read).  All mutable state is guarded by
    ``_lock`` (``stats()`` is read from RPC threads while the worker
    thread assigns/releases).
    """

    def __init__(self, n_blocks: int, block_size: int,
                 block_nbytes: int = 0):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.block_nbytes = int(block_nbytes)
        self._lock = threading.Lock()
        # pop() takes from the end: keep ids ascending for determinism
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._digest_of: Dict[int, bytes] = {}
        self._cache: Dict[bytes, int] = {}
        self._evictable: "OrderedDict[bytes, int]" = OrderedDict()
        self.reuse_hits = 0
        self.fresh = 0
        self.evictions = 0
        self.releases = 0
        self.peak_in_use = 0

    @property
    def capacity(self) -> int:
        """Grantable blocks (the pool minus the trash block)."""
        return self.n_blocks - 1

    def can_admit(self, n_blocks_needed: int) -> bool:
        """Admission guard: can this request EVER be granted?  Cached
        prefix blocks are evictable, so only live references bound an
        allocation — but a request needing more than the whole pool
        must be rejected up front, never retried."""
        return int(n_blocks_needed) <= self.capacity

    def _alloc_one_locked(self) -> int:
        if self._free:
            return self._free.pop()
        if self._evictable:
            digest, blk = self._evictable.popitem(last=False)  # LRU
            del self._cache[digest]
            del self._digest_of[blk]
            self.evictions += 1
            return blk
        raise BlocksExhausted(
            f"paged KV pool exhausted: {len(self._refs)} blocks live "
            f"of {self.capacity} grantable and nothing left to evict")

    def _release_locked(self, blocks):
        for blk in blocks:
            r = self._refs.get(blk, 0) - 1
            if r > 0:
                self._refs[blk] = r
                continue
            self._refs.pop(blk, None)
            digest = self._digest_of.get(blk)
            if digest is not None:
                # cached prefix block: keep the content mapping so an
                # identical future prompt head reuses it (evicted only
                # under allocation pressure, LRU)
                self._evictable[digest] = blk
                self._evictable.move_to_end(digest)
            else:
                self._free.append(blk)

    def assign(self, tokens, n_blocks_needed: int) -> BlockHandle:
        """Grant ``n_blocks_needed`` REAL blocks for a row whose true
        (unpadded) prompt is ``tokens``.  Blocks fully covered by the
        prompt are matched against the prefix cache by chained content
        digest; the rest (the first divergent block, the partial prompt
        tail, the decode tail) are fresh and private.  Atomic: on
        exhaustion every block taken so far is returned before
        :class:`BlocksExhausted` propagates."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int64).reshape(-1)
        n_blocks_needed = int(n_blocks_needed)
        bs = self.block_size
        # only COMPLETE prompt blocks are immutable after prefill
        # (decode writes start at position len(prompt), which lands in
        # the first incomplete block) — those are the shareable ones
        full = min(tokens.size // bs, n_blocks_needed)
        with self._lock:
            taken, shared = [], 0
            fresh_taken = set()
            try:
                digest = b""
                for j in range(full):
                    digest = hashlib.sha1(
                        digest + tokens[j * bs:(j + 1) * bs].tobytes()
                    ).digest()
                    blk = self._cache.get(digest)
                    if blk is not None:
                        self._refs[blk] = self._refs.get(blk, 0) + 1
                        self._evictable.pop(digest, None)
                        shared += 1
                    else:
                        blk = self._alloc_one_locked()
                        self._refs[blk] = 1
                        self._cache[digest] = blk
                        self._digest_of[blk] = digest
                        fresh_taken.add(blk)
                    taken.append(blk)
                for _ in range(n_blocks_needed - full):
                    blk = self._alloc_one_locked()
                    self._refs[blk] = 1
                    fresh_taken.add(blk)
                    taken.append(blk)
            except BlocksExhausted:
                # atomic rollback.  Fresh blocks were NEVER written
                # (prefill runs only after a successful grant), so any
                # digest recorded for them this call must be purged —
                # caching them would hand garbage to a future identical
                # prompt.  Cache-hit blocks just drop the added ref.
                for blk in taken:
                    if blk in fresh_taken:
                        d = self._digest_of.pop(blk, None)
                        if d is not None:
                            self._cache.pop(d, None)
                        self._refs.pop(blk, None)
                        self._free.append(blk)
                    else:
                        self._release_locked([blk])
                raise
            self.fresh += len(fresh_taken)
            self.reuse_hits += shared
            self.peak_in_use = max(self.peak_in_use, len(self._refs))
            return BlockHandle(tuple(taken), shared)

    def release(self, handle: BlockHandle):
        """Request completion: drop one reference per granted block.
        Private blocks return to the free list; prefix blocks move to
        the evictable cache."""
        with self._lock:
            self._release_locked(handle.blocks)
            self.releases += 1

    def stats(self) -> dict:
        with self._lock:
            in_use = len(self._refs)
            return {
                "capacity": self.capacity,
                "block_size": self.block_size,
                "block_nbytes": self.block_nbytes,
                "in_use": in_use,
                "cached": len(self._evictable),
                "free": len(self._free),
                "peak_in_use": self.peak_in_use,
                "reuse_hits": self.reuse_hits,
                "fresh": self.fresh,
                "evictions": self.evictions,
                "releases": self.releases,
                "bytes_in_use": in_use * self.block_nbytes,
                "bytes_capacity": self.capacity * self.block_nbytes,
            }


class PagedDecodeForward(BucketedForward):
    """Bucketed llama decode through a persistent paged KV pool.

    Same serving contract as ``models.llama_decode_forward`` (padded
    ``(tokens, lengths)`` in, ``[B, max_new_tokens]`` ids out, buffers
    per shape bucket) but the cache is a pool that outlives the call:
    real rows get allocator-granted block tables, pad rows and table
    tails point at the trash block, and completed rows release their
    blocks — prefix blocks staying cached for reuse across requests.
    ``wants_rows`` makes the serving worker pass ``n_rows`` so pad rows
    never allocate.  The weights are cast to ``cfg.dtype`` once, here
    (``models.generate.cast_params``); the pool lives on their device.

    Sizing guard: the pool must cover the WORST admitted batch
    (``max_batch`` rows of ``max_seq``) so a dispatched batch can never
    exhaust mid-flight — over-long requests were already rejected at
    admission by the seq buckets, making :class:`BlocksExhausted` an
    admission-time error by construction.
    """

    wants_rows = True

    def __init__(self, params, cfg, max_new_tokens: int, buckets,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 dtype=None):
        from ..models.generate import (cast_params, init_paged_kv_cache,
                                       paged_greedy_decode)
        if buckets.max_seq + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"largest seq bucket {buckets.max_seq} + max_new_tokens "
                f"{max_new_tokens} exceeds the model's max_seq_len "
                f"{cfg.max_seq_len}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._cfg = cfg
        self._new = int(max_new_tokens)
        self._bs = int(block_size)
        worst = buckets.max_batch * row_blocks(buckets.max_seq,
                                              max_new_tokens, block_size)
        min_blocks = 1 + worst   # + the trash block
        if n_blocks is None:
            # default headroom: one worst-case batch again, as prefix
            # cache residency (reuse needs blocks that SURVIVE release)
            n_blocks = min_blocks + worst
        if n_blocks < min_blocks:
            raise ValueError(
                f"n_blocks={n_blocks} cannot cover the worst admitted "
                f"batch ({buckets.max_batch} rows x "
                f"{row_blocks(buckets.max_seq, max_new_tokens, block_size)}"
                f" blocks + 1 trash = {min_blocks}): a dispatched batch "
                f"would OOM — reject at admission instead")
        params = cast_params(params, cfg)
        device = params["embed"].device
        self.pool = init_paged_kv_cache(cfg, int(n_blocks), self._bs,
                                        dtype=dtype, device=device)
        self.pool_nbytes = int(self.pool.k.nbytes) + int(self.pool.v.nbytes)
        blk_bytes, rem = divmod(self.pool_nbytes, int(n_blocks))
        if rem:
            raise AssertionError(
                f"pool of {self.pool_nbytes} B is not {n_blocks} equal "
                f"blocks")
        self.allocator = BlockAllocator(int(n_blocks), self._bs,
                                        block_nbytes=blk_bytes)
        self._last: dict = {}

        def fn(bufs):
            out, _ = paged_greedy_decode(
                params, cfg, bufs["tokens"], bufs["lengths"],
                bufs["tables"], self.pool, max_new_tokens)
            return out

        super().__init__(fn, buckets, device=device)

    def max_blocks(self, seq: int) -> int:
        """Block-table width for a ``seq``-bucket batch (static per
        bucket: part of the bucket's shape)."""
        return row_blocks(seq, self._new, self._bs)

    def __call__(self, tokens: np.ndarray, lengths: np.ndarray,
                 n_rows: Optional[int] = None):
        shape = tuple(np.shape(tokens))
        self._check_bucket(shape)
        B, S = shape
        n_rows = B if n_rows is None else int(n_rows)
        M = self.max_blocks(S)
        tables = np.zeros((B, M), np.int32)   # trash block everywhere
        handles = []
        try:
            for i in range(n_rows):
                ln = int(lengths[i])
                need = row_blocks(ln, self._new, self._bs)
                h = self.allocator.assign(
                    np.asarray(tokens[i, :ln]), need)
                handles.append(h)
                tables[i, :need] = h.blocks
        except BlocksExhausted:
            for h in handles:
                self.allocator.release(h)
            raise
        try:
            # the host copy of the output waits for the device: the
            # blocks are released below only after the batch ran
            out = self._run(shape, {"tokens": tokens, "lengths": lengths,
                                    "tables": tables})
        finally:
            # ledger BEFORE release: the batch's live working set is
            # what the byte gate compares against the dense equivalent
            st = self.allocator.stats()
            self._last = {
                "rows": n_rows,
                "blocks": sum(len(h.blocks) for h in handles),
                "shared": sum(h.shared for h in handles),
                "in_use": st["in_use"],
                "bytes_in_use": st["bytes_in_use"],
            }
            if _metrics.ACTIVE:
                _m_kv_blocks.set(st["in_use"], state="allocated")
                _m_kv_blocks.set(st["cached"], state="cached")
                _m_kv_blocks.set(st["free"], state="free")
                _m_kv_bytes.set(st["bytes_in_use"], kind="allocated")
                _m_kv_bytes.set(st["bytes_capacity"], kind="capacity")
                reused = sum(h.shared for h in handles)
                if reused:
                    _m_kv_reuse.inc(reused)
            for h in handles:
                self.allocator.release(h)
        return out

    def kv_summary(self) -> dict:
        """Compact KV ledger the worker rides along on ``serve_push``
        (surfaces on the plane's ``GET /serve/stats``)."""
        st = self.allocator.stats()
        return {"block_size": st["block_size"],
                "block_nbytes": st["block_nbytes"],
                "in_use": st["in_use"], "cached": st["cached"],
                "free": st["free"], "peak_in_use": st["peak_in_use"],
                "reuse_hits": st["reuse_hits"],
                "bytes_in_use": st["bytes_in_use"],
                "bytes_capacity": st["bytes_capacity"]}

    def stats(self) -> dict:
        out = super().stats()
        out["kv"] = self.allocator.stats()
        out["kv"]["pool_nbytes"] = self.pool_nbytes
        out["kv"]["last"] = dict(self._last)
        return out
