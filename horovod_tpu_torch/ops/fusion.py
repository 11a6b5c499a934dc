"""Fusion planner and response cache.

Counterpart: ``horovod_tpu/ops/fusion.py``, copied: ``EntrySig`` (the
negotiation Request), ``plan_fusion`` (deterministic buckets up to
``HOROVOD_FUSION_THRESHOLD`` bytes, grouped entries atomic),
``ResponseCache``, the sharding-spec fingerprints (``canonicalize_spec``,
``spec_axes``, ``spec_shift``: what ``EntrySig.spec`` holds), and the
distributed optimizer's bucket layouts (``pad_to_multiple``,
``BucketLayout``, ``plan_bucket_layouts``) and overlapped dispatch order
(``DispatchSchedule``, ``plan_dispatch``) give the same plans for the same
signatures, which tests/test_torch_controller.py and
tests/test_torch_overlap.py hold against the JAX package.  Torch dtypes
enter by their names without the ``torch.`` prefix (:func:`dtype_name`),
which are the JAX package's names for the same element widths.  The JAX
package's native ``_hvd_core`` is not ported: this pure-Python planner is
the one it is parity-checked against.

The execution side (pack a bucket, one collective, unpack) is
``ops/collectives.allreduce_arrays``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

_DTYPE_BYTES = {
    "float32": 4, "float64": 8, "float16": 2, "bfloat16": 2,
    "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "int32": 4, "uint32": 4, "int64": 8, "uint64": 8, "bool": 1,
    # fp8 wire/storage dtypes (quantized collectives; EQuARX-class wire
    # formats) — these used to fall through to the 4-byte guess, which
    # mis-sized buckets 4x against HOROVOD_FUSION_THRESHOLD
    "float8_e4m3fn": 1, "float8_e5m2": 1, "float8_e4m3": 1,
    "float8_e3m4": 1, "float8_e4m3fnuz": 1, "float8_e5m2fnuz": 1,
    "complex64": 8, "complex128": 16,
}


def dtype_nbytes(dtype: str) -> int:
    """Element width the planner packs buckets with.

    Unknown dtypes RAISE instead of guessing 4 bytes: a silent guess
    mis-sizes every bucket holding that dtype against the fusion
    threshold (and did, for fp8, until the entries above were added).
    """
    try:
        return _DTYPE_BYTES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unknown dtype {dtype!r} in fusion planning: add its element "
            f"width to ops.fusion._DTYPE_BYTES (guessing would mis-size "
            f"buckets against HOROVOD_FUSION_THRESHOLD)") from None


def dtype_name(dtype) -> str:
    """The planner's name of a torch dtype (``torch.bfloat16`` →
    ``"bfloat16"``); strings pass through."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class EntrySig:
    """Signature of one pending collective (the negotiation Request).

    Reference: ``horovod/common/message.cc`` Request — (rank, name, dtype,
    shape, op type).  ``group_id`` carries the reference's GroupTable
    semantics: entries sharing a group fuse atomically.
    """
    name: str
    op_type: str          # allreduce | allgather | broadcast | alltoall | ...
    reduce_op: str        # sum | average | ...
    dtype: str
    shape: Tuple[int, ...]
    process_set_id: int
    stacked: bool
    group_id: int = -1    # -1 = ungrouped
    # scale factors participate in fusion compatibility: entries with
    # different prescale/postscale must not share one fused collective
    prescale: Optional[float] = None
    postscale: Optional[float] = None
    # negotiated quantized wire format ("none" = full-width).  A fused
    # bucket is ONE staged collective, so mixed-format entries must
    # never share a bucket; the field rides the negotiation token like
    # every other signature field, and being part of the (astuple)
    # ResponseCache key it invalidates cached plans on a format change.
    wire_format: str = "none"
    # layer/topology key for overlapped dispatch (ROADMAP item 3): the
    # backward pass materializes gradients one layer at a time, so a
    # bucket spanning layers could only dispatch after its LAST layer's
    # gradients exist — the exposed-latency problem again.  Entries with
    # different layer keys therefore never fuse (-1 = no layer identity:
    # the eager engine and the non-overlapped in-jit path, where the
    # whole plan dispatches at once and existing plans must not change).
    layer: int = -1
    # negotiated straggler tolerance for the DCN stage of a hierarchical
    # reduce (OptiReduce; "strict" = wait for every host).  A fused
    # bucket runs ONE deadline gate and one participation mask, so
    # mixed-policy entries must never share a bucket; like wire_format
    # the field rides the negotiation token (field 11) and, being part
    # of the (astuple) ResponseCache key, invalidates cached plans on a
    # policy change.
    tail_policy: str = "strict"
    # canonicalized PartitionSpec fingerprint over the mesh axes
    # ("replicated" = no model-axis sharding — every pre-existing plan).
    # A model-sharded entry's gradient arrives PRE-reduced over the
    # axes its spec names (the model's gather-transpose collectives did
    # that), so its bucket reduces over a DIFFERENT axis set than a
    # replicated bucket — mixed-spec entries must never fuse, and like
    # wire_format/tail_policy before it the field rides the negotiation
    # token (field 12) so every process agrees which axes each bucket
    # reduces over; the (astuple) ResponseCache key invalidates cached
    # plans on a spec change.
    spec: str = "replicated"

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * dtype_nbytes(self.dtype)

    def bucket_key(self) -> Tuple:
        """Entries sharing this key may fuse into one collective."""
        return (self.op_type, self.reduce_op, self.dtype,
                self.process_set_id, self.stacked,
                1.0 if self.prescale is None else self.prescale,
                1.0 if self.postscale is None else self.postscale,
                self.wire_format, self.layer, self.tail_policy,
                self.spec)


def canonicalize_spec(spec) -> str:
    """Canonical string fingerprint of one leaf's sharding spec (JAX
    ``ops.fusion.canonicalize_spec``).

    A spec is the port's per-dim form (a tuple, one entry a dim: an axis
    name, a tuple of axis names, or None; ``()`` for a replicated leaf,
    as ``models.llama.param_specs`` writes them), None, or a string.
    ``"replicated"`` for None, an empty spec or an all-None one; else
    ``"<dim>:<axis>[+<axis>],<dim>:<axis>"`` over the sharded dims in
    order, e.g. ``(None, "tp")`` → ``"1:tp"`` and ``(("dp", "tp"),)`` →
    ``"0:dp+tp"``: JAX's string for the matching ``PartitionSpec``, the
    string the negotiation token's field 12 carries.  Canonical strings
    pass through; a bare axis name shards dim 0."""
    if spec is None:
        return "replicated"
    if isinstance(spec, str):
        if spec == "replicated" or ":" in spec:
            return spec
        return f"0:{spec}"
    parts = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        axes = tuple(str(a) for a in axes if a is not None)
        if axes:
            parts.append(f"{dim}:{'+'.join(axes)}")
    return ",".join(parts) if parts else "replicated"


def spec_axes(canonical: str) -> Tuple[str, ...]:
    """The mesh axes a canonical spec shards over, in spec order, each
    once; ``()`` for ``"replicated"``."""
    if canonical == "replicated":
        return ()
    axes: List[str] = []
    for part in canonical.split(","):
        for a in part.split(":", 1)[1].split("+"):
            if a and a not in axes:
                axes.append(a)
    return tuple(axes)


def spec_shift(canonical: str) -> str:
    """The canonical spec of a leading-dim slice of a leaf with
    ``canonical`` (a stacked ``[L, ...]`` leaf's layer): every dim index
    one lower.  A spec sharding dim 0 raises: its slice has no dim to
    carry the sharding.  (The port's layers are separate leaves, so its
    own plans never shift: the function is kept for parity with the JAX
    package, for specs written for a stacked tree.)"""
    if canonical == "replicated":
        return canonical
    parts = []
    for part in canonical.split(","):
        dim, names = part.split(":", 1)
        if int(dim) == 0:
            raise ValueError(
                f"spec {canonical!r} shards the leading (scan) dimension: "
                f"a per-layer slice of this leaf has no dim to carry the "
                f"sharding, so the stacked leaf cannot be layer-sliced "
                f"under this spec")
        parts.append(f"{int(dim) - 1}:{names}")
    return ",".join(parts)


def plan_fusion(entries: Sequence[EntrySig],
                threshold_bytes: int) -> List[List[int]]:
    """Deterministically bucket entries for fused dispatch.

    Returns a list of buckets, each a list of indices into ``entries``.
    Ordering rule: entries are processed in sorted (bucket_key, name) order —
    the same total order on every process, which is the property the
    reference's coordinator-negotiation protocol exists to guarantee
    (controller.cc ComputeResponseList): all ranks must execute the same
    collectives in the same order each cycle.

    Grouped entries (same ``group_id``) always land in one bucket regardless
    of the threshold (reference: group_table.cc all-or-nothing fusion).
    Only allreduce fuses; other op types dispatch one bucket per entry.

    Within a bucket key, grouped entries sort CONTIGUOUSLY ahead of
    ungrouped ones: an ungrouped entry whose name interleaves a group's
    members must not sit between them, or a threshold flush would split
    the group (all-or-nothing would break).  Groups order by their
    MINIMUM MEMBER NAME, never by ``group_id`` — group ids are
    per-process counters (a joined process renumbers synthesized groups,
    see engine join synthesis), and the whole point of this sort is an
    identical plan on every process.  Two groups CAN share a minimum
    member name (grouped submissions expand to ``name.0``, ``name.1``,
    so two groups submitted under one explicit ``name=`` collide), so
    the tie breaks on the group's full sorted member-name tuple — still
    cross-process stable, and it keeps each group contiguous instead of
    interleaving the tied groups' members by bare name.
    """
    group_names: Dict[int, List[str]] = {}
    group_first: Dict[int, int] = {}
    for idx, e in enumerate(entries):
        if e.group_id != -1:
            group_names.setdefault(e.group_id, []).append(e.name)
            group_first.setdefault(e.group_id, idx)
    # the sorted member tuple IS the ordering key: its first element is
    # the minimum member name, and the remaining elements break ties.
    # Two groups with IDENTICAL member tuples (the same name= submitted
    # twice in one cycle) order by first submission index — the same
    # cross-process contract the controller's counts-based negotiation
    # uses to pair duplicate tokens (instance k with every peer's
    # instance k), so the plan still matches on every process.
    group_key = {g: (tuple(sorted(names)), group_first[g])
                 for g, names in group_names.items()}
    order = sorted(
        range(len(entries)),
        key=lambda i: (entries[i].bucket_key(),
                       (0,) + group_key[entries[i].group_id]
                       if entries[i].group_id != -1 else (1, (), -1),
                       entries[i].name, i))
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_key: Optional[Tuple] = None
    cur_bytes = 0
    cur_group = -1

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            buckets.append(cur)
        cur, cur_bytes = [], 0

    for i in order:
        e = entries[i]
        fusable = e.op_type == "allreduce"
        key = e.bucket_key()
        if not fusable:
            flush()
            buckets.append([i])
            cur_key = None
            continue
        same_group = e.group_id != -1 and e.group_id == cur_group and cur
        if (key != cur_key
                or (cur_bytes + e.nbytes > threshold_bytes and not same_group
                    and cur)):
            flush()
            cur_key = key
        cur.append(i)
        cur_bytes += e.nbytes
        cur_group = e.group_id
    flush()
    return buckets


def pad_to_multiple(numel: int, parts: int) -> int:
    """Smallest multiple of ``parts`` that is >= ``numel``.

    A reduce-scatter splits a flat bucket evenly across the mesh axis, so
    the buffer is zero-padded up to this size before the collective (the
    ZeRO-style sharded-update path; arXiv:2004.13336)."""
    if parts <= 0:
        raise ValueError(f"parts must be positive, got {parts}")
    return -(-numel // parts) * parts


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Flat-buffer layout of one planned fusion bucket, shard-aware.

    The planner's bucket (``plan_fusion``) decides *which* entries fuse;
    this records *where* each entry lives in the flattened buffer plus the
    padding a ``shards``-way reduce-scatter needs — the slice metadata the
    sharded-update path uses to carve per-worker tiles and to reassemble
    the full buffer after the allgather.
    """
    indices: Tuple[int, ...]      # entry indices, planner (bucket) order
    sizes: Tuple[int, ...]        # per-entry element counts, same order
    numel: int                    # sum(sizes)
    padded_numel: int             # numel rounded up to a multiple of shards
    shard_numel: int              # padded_numel // shards (per-worker tile)


def plan_bucket_layouts(entries: Sequence[EntrySig],
                        buckets: Sequence[Sequence[int]],
                        shards: int, align: int = 1) -> List[BucketLayout]:
    """Compute the padded flat-buffer layout of every planned bucket.

    ``buckets`` is ``plan_fusion`` output over ``entries``; ``shards`` is
    the mesh-axis size the buckets will be reduce-scattered over.  The
    layout is pure plan metadata (trace-time only) — the bucketing itself
    is unchanged, keeping the single cross-process ordering contract.

    ``align`` > 1 additionally makes every shard a multiple of ``align``
    elements (pad to ``shards * align``): the quantized wire path needs
    block-aligned tiles so per-block scales route with their blocks.
    """
    layouts: List[BucketLayout] = []
    for bucket in buckets:
        sizes = tuple(entries[i].numel for i in bucket)
        numel = sum(sizes)
        padded = pad_to_multiple(numel, shards * max(int(align), 1))
        layouts.append(BucketLayout(
            indices=tuple(bucket), sizes=sizes, numel=numel,
            padded_numel=padded, shard_numel=padded // shards))
    return layouts


@dataclasses.dataclass(frozen=True)
class DispatchSchedule:
    """Explicit dispatch order of a layer-aware fusion plan.

    ``plan_fusion`` decides *what* fuses; this records *when* each bucket
    may go to the wire under overlapped dispatch (ROADMAP item 3): the
    backward pass produces gradients in reverse layer order, so a
    bucket's collective can dispatch the moment its layer's backward
    step completes.  ``order`` lists bucket indices in dispatch order —
    descending layer first (layer L-1's gradients materialize first in
    backprop), then the layer-less (-1) buckets, whose members (embeds,
    final norms — parameters used outside the scanned stack) only
    complete at the very end of the backward pass.  Pure plan metadata:
    the traced program realizes this order structurally (the collectives
    sit inside the backward scan), and the boundary fallback path
    executes buckets in this order so both paths are one reviewable
    schedule.
    """
    order: Tuple[int, ...]        # bucket indices, dispatch order
    layers: Tuple[int, ...]       # layer key per bucket, plan order


def plan_dispatch(entries: Sequence[EntrySig],
                  buckets: Sequence[Sequence[int]]) -> DispatchSchedule:
    """Compute the overlapped dispatch schedule of a fusion plan.

    ``buckets`` is ``plan_fusion`` output over ``entries``; because
    ``layer`` participates in ``bucket_key``, every bucket has exactly
    one layer key.  Ties (several buckets on one layer — e.g. the
    float32 and bfloat16 buckets of the same layer) keep plan order,
    which is deterministic cross-process.
    """
    layers = tuple(entries[bucket[0]].layer for bucket in buckets)
    for bi, bucket in enumerate(buckets):
        for i in bucket:
            if entries[i].layer != layers[bi]:
                raise ValueError(
                    f"bucket {bi} spans layers {layers[bi]} and "
                    f"{entries[i].layer}: a bucket can only dispatch "
                    f"when its LAST layer's gradients exist, so the "
                    f"planner must never fuse across layers (is layer "
                    f"missing from bucket_key()?)")
    order = sorted(
        range(len(buckets)),
        # descending layer; layer -1 (no layer identity: gradients
        # complete only at the end of backprop) dispatches last
        key=lambda b: (0, -layers[b], b) if layers[b] >= 0 else (1, 0, b))
    return DispatchSchedule(order=tuple(order), layers=layers)


class ResponseCache:
    """LRU cache of fusion plans keyed by the cycle's entry signatures.

    Reference: ``horovod/common/response_cache.cc`` — in steady state the
    same tensors arrive every cycle, so ranks skip full negotiation and
    exchange only a cache-hit bit vector.  Here the cached value is the
    fusion plan; a hit skips the planner (and, multi-process, the
    name-exchange round in the engine).
    """

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._cache: "OrderedDict[Tuple, List[List[int]]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(entries: Sequence[EntrySig]) -> Tuple:
        return tuple(dataclasses.astuple(e) for e in entries)

    def get(self, entries: Sequence[EntrySig]) -> Optional[List[List[int]]]:
        if self.capacity <= 0:
            return None
        k = self.key(entries)
        plan = self._cache.get(k)
        if plan is not None:
            self._cache.move_to_end(k)
            self.hits += 1
            return plan
        self.misses += 1
        return None

    def put(self, entries: Sequence[EntrySig], plan: List[List[int]]):
        if self.capacity <= 0:
            return
        k = self.key(entries)
        self._cache[k] = plan
        self._cache.move_to_end(k)
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)

    def clear(self):
        self._cache.clear()

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._cache)}


def get_planner(cfg):
    """Return ``(plan_fn, cache)``: :func:`plan_fusion` and a
    :class:`ResponseCache` of ``cfg.cache_capacity`` plans."""
    cap = cfg.cache_capacity if cfg is not None else 1024
    return plan_fusion, ResponseCache(cap)
