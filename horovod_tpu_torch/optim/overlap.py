"""Overlapped gradient dispatch: each layer's buckets reduced during backprop.

Counterpart: ``horovod_tpu/optim/overlap.py``.  The non-overlapped step
runs the whole backward pass and only then reduces its buckets, so the
card waits out the gradient plane between the last gradient and the
optimizer.  The backward pass produces gradients layer by layer, last layer
first; this module reduces each layer's buckets as they are produced:

* :func:`grad_tap` is an ``autograd.Function`` that is the identity on a
  layer's fp32 weight dict (and, through :func:`tap_root`, on the leaves
  outside the layer stack).  Outside an armed context it returns its
  argument untouched.  Inside one, its backward hands the layer's
  cotangents to the armed dispatch and returns no gradient to autograd:
  the dispatch owns those buffers from then on and reduces them in place.
* :func:`overlapped_backprop` arms the taps with a
  ``DistributedGradientTransform(overlap=True)``'s plan.  Wrap the forward
  and backward passes of the step in it; ``tx.update`` then takes the
  reduced gradients from the dispatch.
* The plan is the transform's layer-aware fusion plan (:func:`build_layout`):
  a leaf under ``params[layers_key][i]`` carries layer key ``i``, so no
  bucket spans two layers, and the ``DispatchSchedule`` orders buckets by
  descending layer, the root (``layer=-1``) buckets last.  A bucket is
  issued on the plan's CUDA stream once all its leaves have arrived and
  every bucket before it in the schedule has been issued: every rank then
  issues the same collectives in the same order without a negotiation
  round, which is what the JAX package gets from its static in-jit
  schedule.  Where no tap fires, the transform runs the same plan at the
  step boundary (:func:`reduce_full`, :func:`scatter_tiles`), so both
  paths land on the same weights.

Composition, as in the JAX package: under ``sharded_update`` each bucket is
reduce-scattered during backprop and only this rank's tile is kept (the
raw cotangents are freed as their bucket goes out); the updated tiles are
gathered at the step boundary.  With a wire format the early buckets
quantize without error feedback (the residual is state the backward pass
cannot thread).  With ``backward_passes_per_step > 1`` pass
``count=state.count``: the taps dispatch only on the accumulation
boundary.

Under a spec plan (``param_specs``) each bucket carries its leaves' spec
and reduces over the mesh's axes as ``optim.distributed`` describes; the
port's layers are separate leaves, so a layer leaf's spec is the layer
dict's own, with no dim to shift.  Under ``HOROVOD_TRACE`` the boundary
staging (:func:`reduce_full`, :func:`scatter_tiles`) records an
``overlap`` span off every round's path (``round=-1``).

Streams: a tap records an event on the stream autograd runs it on; the
plan's stream waits for it before reading the cotangents, which then
carry ``record_stream`` so the caching allocator does not reuse them
early.  ``tx.update`` makes the caller's stream wait for the last bucket
before the optimizer reads a gradient.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import tracing as _tracing
from ..analysis import recorder as _rec
from ..compression import quantizable
from ..ops import collectives
from ..ops.fusion import (EntrySig, dtype_name, plan_bucket_layouts,
                          plan_dispatch, plan_fusion)
from ..runtime import ReduceOp
from ..tree import tree_map

logger = logging.getLogger("horovod_tpu_torch")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OverlapPlan:
    """The dispatch recipe of one ``overlap=True`` transform, shared by its
    ``update`` and the taps armed by :func:`overlapped_backprop`.
    ``layout`` and ``index`` (leaf tensor id → plan entry) are set by the
    transform's ``init``."""
    process_set: Any
    op: str
    threshold_bytes: Optional[int]
    prescale: float
    postscale: float
    sharded: bool
    fmt: Any                      # compression.WireFormat or None
    k: int                        # backward_passes_per_step
    layers_key: str = "layers"
    layout: Any = None
    index: Dict[int, int] = dataclasses.field(default_factory=dict)
    # a committed dispatch whose reduced gradients tx.update has not read
    _pending: Any = None
    _stream: Any = None
    # measurement (off by default): CUDA events at each bucket's issue and
    # at the backward's end, and the wire's quantization error; read
    # through ``last.stats()`` after the step
    time_device: bool = False
    last: Any = None
    # the transform's optim.distributed.SpecPlan (None: the replicated
    # plan over process_set, which is then the data axis's group)
    spec_plan: Any = None

    def tap_specs(self):
        """The canonical spec of each tap-level leaf name (None without a
        spec plan): a layer leaf's name within its layer dict (its
        ``layers.<i>.`` prefix dropped) and a root leaf's path.  The
        port's layers are separate leaves, so a layer leaf's spec is used
        as it is (the JAX package shifts a stacked leaf's down a dim).  A
        name that a root leaf and a layer leaf, or two layers, share with
        different specs is ambiguous and raises."""
        if self.spec_plan is None:
            return None
        merged: Dict[str, str] = {}
        for name, spec in self.spec_plan.by_name.items():
            parts = name.split(".")
            key = (".".join(parts[2:]) if len(parts) > 2
                   and parts[0] == self.layers_key and parts[1].isdigit()
                   else name)
            if key in merged and merged[key] != spec:
                raise ValueError(
                    f"overlap + param_specs: tap-level leaf name {key} is "
                    f"ambiguous: leaves of the root and of the "
                    f"{self.layers_key!r} stack share it with different "
                    f"specs ({merged[key]} vs {spec}); rename one of the "
                    f"leaves")
            merged[key] = spec
        return merged

    def consume(self):
        """The committed dispatch since the last consume, or None."""
        d, self._pending = self._pending, None
        if d is not None:
            self.last = d
        return d

    def stream(self, device: torch.device):
        if device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream


#: transform update function -> OverlapPlan (weak: dies with the transform)
_TRANSFORMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def register_transform(update_fn, plan: OverlapPlan) -> None:
    _TRANSFORMS[update_fn] = plan


def plan_for(tx) -> OverlapPlan:
    """The :class:`OverlapPlan` of a transform built with ``overlap=True``
    (raises for any other)."""
    plan = _TRANSFORMS.get(getattr(tx, "update", None))
    if plan is None:
        raise ValueError(
            "overlapped_backprop() needs a DistributedGradientTransform/"
            "DistributedOptimizer built with overlap=True (or "
            "HOROVOD_OVERLAP=1): this transformation has no overlap "
            "dispatch plan")
    return plan


# ---------------------------------------------------------------------------
# layer-aware layout
# ---------------------------------------------------------------------------

class OverlapLayout(NamedTuple):
    """Layer-aware plan of one gradient tree: every leaf one entry (the
    port's layers are separate tensors, where the JAX tree stacks them),
    its layer key the index under ``layers_key`` or -1; ``dispatch`` the
    reverse-layer order."""
    skeleton: Any                          # the tree, leaves None
    order: Tuple[int, ...]                 # path-sorted -> tree order
    names: Tuple[str, ...]                 # path-sorted leaf paths
    shapes: Tuple[Tuple[int, ...], ...]
    layers: Tuple[int, ...]                # layer key per entry
    buckets: Tuple[Any, ...]               # ops.fusion.BucketLayout
    dispatch: Any                          # ops.fusion.DispatchSchedule
    bucket_wire: Tuple[str, ...]           # wire format name per bucket
    bucket_spec: Tuple[str, ...]           # canonical spec per bucket

    def fingerprint(self) -> Tuple:
        return (self.shapes, self.layers, self.buckets)


def _layer_of(name: str, layers_key: str) -> int:
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == layers_key and parts[1].isdigit():
        return int(parts[1])
    return -1


def build_layout(tree, plan: OverlapPlan,
                 shards: int) -> Tuple[list, OverlapLayout]:
    """Plan ``tree`` for layer-aware dispatch; ``shards`` is the set's size
    under ``sharded_update``, else 1.  Returns ``(path_sorted_leaves,
    layout)``.  (The JAX package also plans each tap's own subtree; here
    every tap feeds the one plan over the whole tree.)"""
    from .distributed import _resolve_threshold, _tree_leaves_sorted
    leaves, names, order = _tree_leaves_sorted(tree)
    layers = [_layer_of(n, plan.layers_key) for n in names]
    specs = (plan.spec_plan.specs_for(names) if plan.spec_plan is not None
             else ["replicated"] * len(names))
    sigs = [EntrySig(
        name=names[i], op_type="allreduce", reduce_op=str(plan.op),
        dtype=dtype_name(leaf.dtype), shape=tuple(leaf.shape),
        process_set_id=0, stacked=False, prescale=plan.prescale,
        postscale=plan.postscale,
        wire_format=(plan.fmt.name if plan.fmt is not None
                     and quantizable(leaf.dtype) else "none"),
        layer=layers[i], spec=specs[i]) for i, leaf in enumerate(leaves)]
    buckets = plan_fusion(sigs, _resolve_threshold(plan.threshold_bytes))
    align = plan.fmt.block_size if plan.fmt is not None else 1
    return leaves, OverlapLayout(
        skeleton=tree_map(lambda _: None, tree), order=tuple(order),
        names=tuple(names), shapes=tuple(tuple(x.shape) for x in leaves),
        layers=tuple(layers),
        buckets=tuple(plan_bucket_layouts(sigs, buckets, max(shards, 1),
                                          align=align)),
        dispatch=plan_dispatch(sigs, buckets),
        bucket_wire=tuple(sigs[b[0]].wire_format for b in buckets),
        bucket_spec=tuple(sigs[b[0]].spec for b in buckets))


def _bucket_id(layout: OverlapLayout, b: int) -> int:
    """Bucket ``b``'s ordinal among its layer's buckets: the id the JAX
    package's per-tap plan gives it (its ``hvd_bucket<i>`` scope), which
    the schedule recorder records."""
    layers = layout.dispatch.layers
    return [i for i in range(len(layers))
            if layers[i] == layers[b]].index(b)


def _shards(plan: OverlapPlan) -> int:
    return plan.process_set.size() if plan.sharded else 1


def _leaves_for(tree, layout: Optional[OverlapLayout], plan: OverlapPlan):
    if layout is None:
        return build_layout(tree, plan, _shards(plan))
    from .distributed import _tree_leaves_sorted
    return _tree_leaves_sorted(tree)[0], layout


# ---------------------------------------------------------------------------
# one bucket (shared by the taps and the boundary path)
# ---------------------------------------------------------------------------

def _spec_hops(plan: OverlapPlan, spec: str):
    """(data-axis hop?, model axes to sum over first) of a bucket with
    ``spec`` under the plan's spec plan."""
    sp = plan.spec_plan
    r_axes = sp.reduce_axes(spec)
    return sp.data_axis in r_axes, [a for a in r_axes if a != sp.data_axis]


def _reduce_bucket_(parts: List[torch.Tensor], bl, wire: str,
                    plan: OverlapPlan, errors: Optional[list] = None,
                    spec: str = "replicated") -> None:
    """Full-width (or feedback-free quantized) reduction of one bucket,
    written back into ``parts``.  With ``errors`` (a list), a quantized
    bucket appends the squared norms of its quantization error and of its
    contribution (a measurement: nothing is fed back)."""
    from .distributed import _allreduce_flat_, _bucket_flat, _split_into
    ps = plan.process_set
    buf = _bucket_flat(parts, bl.numel, pad=False)
    if plan.prescale != 1.0:
        buf = buf * torch.tensor(plan.prescale).to(buf.dtype)
    sp = plan.spec_plan
    if sp is not None:
        data, m_axes = _spec_hops(plan, spec)
        global_n = sp.global_size()
        if plan.fmt is not None and wire != "none" and data:
            # only the data hop quantizes
            buf = sp.sum_over(buf, m_axes)
            red, res = collectives.quantized_allreduce(
                buf, ps, plan.fmt, op=plan.op,
                error_feedback=errors is not None, denom=global_n)
            if errors is not None:
                errors.append((res.float().square().sum(),
                               buf.float().square().sum()))
        else:
            red = sp.sum_over(buf, ([sp.data_axis] if data else [])
                              + m_axes)
            if plan.op == ReduceOp.AVERAGE:
                red = red / global_n
        if plan.postscale != 1.0:
            collectives._scale_(red, plan.postscale)
        _split_into(red, parts)
        return
    if plan.fmt is not None and wire != "none":
        red, res = collectives.quantized_allreduce(
            buf, ps, plan.fmt, op=plan.op, error_feedback=errors is not None)
        if errors is not None:
            errors.append((res.float().square().sum(),
                           buf.float().square().sum()))
        buf = red
        if plan.postscale != 1.0:
            collectives._scale_(buf, plan.postscale)
    else:
        _allreduce_flat_(buf, ps, plan.op, 1.0, plan.postscale)
    _split_into(buf, parts)


def _scatter_bucket(parts: List[torch.Tensor], bl, wire: str,
                    plan: OverlapPlan, errors: Optional[list] = None,
                    spec: str = "replicated") -> torch.Tensor:
    """This rank's reduced tile of one bucket (``errors`` as in
    :func:`_reduce_bucket_`)."""
    from .distributed import _bucket_flat
    ps = plan.process_set
    buf = _bucket_flat(parts, bl.padded_numel)
    if plan.prescale != 1.0:
        buf = buf * torch.tensor(plan.prescale).to(buf.dtype)
    sp = plan.spec_plan
    if sp is not None:
        # a replicated bucket's model hops first; a model-sharded one
        # arrives summed over its spec's axes
        buf = sp.sum_over(buf, _spec_hops(plan, spec)[1])
    if plan.fmt is not None and wire != "none":
        tile, res = collectives.quantized_sum_scatter(
            buf.float(), ps, plan.fmt, error_feedback=errors is not None)
        if errors is not None:
            errors.append((res.square().sum(), buf.float().square().sum()))
        tile = tile.to(buf.dtype)
    else:
        tile = collectives.reduce_scatter_flat(buf, ps)
    if plan.op == ReduceOp.AVERAGE and sp is not None:
        tile = tile / sp.global_size()
    elif plan.op == ReduceOp.AVERAGE and ps.size() > 1:   # x / 1 is x
        tile = tile / ps.size()
    if plan.postscale != 1.0:
        collectives._scale_(tile, plan.postscale)
    return tile


def _parts(leaves, bl):
    return [leaves[i] for i in bl.indices]


# ---------------------------------------------------------------------------
# plan execution at the step boundary
# ---------------------------------------------------------------------------

def reduce_full(tree, plan: OverlapPlan,
                layout: Optional[OverlapLayout] = None):
    """Full-width reduction of ``tree`` under the layer-aware plan, in
    dispatch order, in place; returns ``tree``.  The same buckets and
    staging as the taps' dispatch."""
    t_stage = _tracing.now() if _tracing.ACTIVE else 0.0
    leaves, layout = _leaves_for(tree, layout, plan)
    for b in layout.dispatch.order:
        bl = layout.buckets[b]
        if _rec.ARMED:
            _rec.set_bucket(_bucket_id(layout, b))
        _reduce_bucket_(_parts(leaves, bl), bl, layout.bucket_wire[b], plan,
                        spec=layout.bucket_spec[b])
    if _rec.ARMED:
        _rec.set_bucket(None)
    if _tracing.ACTIVE:
        # off every round's path (round=-1): when and how the overlap
        # plan staged its buckets at the boundary
        _tracing.span("overlap", "reduce_full", t_stage, _tracing.now(),
                      round=-1, phase="bwd" if active() else "boundary",
                      buckets=len(layout.buckets))
    return tree



def scatter_tiles(tree, plan: OverlapPlan,
                  layout: Optional[OverlapLayout] = None):
    """Reduce-scatter ``tree`` under the layer-aware plan: this rank's tile
    of each bucket (plan order), and the layout."""
    t_stage = _tracing.now() if _tracing.ACTIVE else 0.0
    leaves, layout = _leaves_for(tree, layout, plan)
    tiles: List[Optional[torch.Tensor]] = [None] * len(layout.buckets)
    for b in layout.dispatch.order:
        bl = layout.buckets[b]
        if _rec.ARMED:
            _rec.set_bucket(_bucket_id(layout, b))
        tiles[b] = _scatter_bucket(_parts(leaves, bl), bl,
                                   layout.bucket_wire[b], plan,
                                   spec=layout.bucket_spec[b])
    if _rec.ARMED:
        _rec.set_bucket(None)
    if _tracing.ACTIVE:
        _tracing.span("overlap", "scatter_tiles", t_stage, _tracing.now(),
                      round=-1, phase="bwd" if active() else "boundary",
                      buckets=len(layout.buckets))
    return tuple(tiles), layout


def scatter_place(tree, plan: OverlapPlan):
    """Reduce-scatter, each tile written into an otherwise-zero buffer of
    its bucket's padded size and split to the tree's shapes (the JAX
    cotangent form); :func:`carve_tiles` recovers the tiles exactly."""
    from .distributed import _unflatten
    tiles, layout = scatter_tiles(tree, plan)
    rank = plan.process_set.rank()
    out: List[Optional[torch.Tensor]] = [None] * len(layout.shapes)
    for bl, tile in zip(layout.buckets, tiles):
        full = tile.new_zeros(bl.padded_numel)
        full[rank * bl.shard_numel:(rank + 1) * bl.shard_numel] = tile
        _split_entries(full, bl, layout, out)
    return _unflatten(layout, out)


def carve_tiles(tree, plan: OverlapPlan,
                layout: Optional[OverlapLayout] = None):
    """This rank's tile of each bucket of ``tree``, without a collective:
    the tiles the 1/N update runs against, or, from :func:`scatter_place`'s
    output, the reduce-scattered tiles."""
    from .distributed import _tile_of
    leaves, layout = _leaves_for(tree, layout, plan)
    rank = plan.process_set.rank()
    return tuple(_tile_of(_parts(leaves, bl), bl, rank)
                 for bl in layout.buckets), layout


def _split_entries(full, bl, layout, out):
    off = 0
    for i, sz in zip(bl.indices, bl.sizes):
        out[i] = full[off:off + sz].view(layout.shapes[i])
        off += sz


def gather_updates(tiles, layout: OverlapLayout, plan: OverlapPlan,
                   out=None):
    """The full tree from every rank's tiles: one all-gather a bucket.
    With ``out`` (a tree like the planned one) the values are copied into
    its leaves and ``out`` is returned."""
    from .distributed import _tree_leaves_sorted, _unflatten
    if len(tiles) != len(layout.buckets):
        raise ValueError(
            f"got {len(tiles)} tile(s) for a layout of "
            f"{len(layout.buckets)} bucket(s): tiles and layout come from "
            f"different plans")
    pieces: List[Optional[torch.Tensor]] = [None] * len(layout.shapes)
    dst = _tree_leaves_sorted(out)[0] if out is not None else None
    for b, (bl, tile) in enumerate(zip(layout.buckets, tiles)):
        if _rec.ARMED:
            _rec.set_bucket(_bucket_id(layout, b))
        full = collectives.all_gather_flat(tile, plan.process_set)
        if dst is None:
            _split_entries(full, bl, layout, pieces)
        else:
            from .distributed import _split_into
            _split_into(full, [dst[i] for i in bl.indices])
    if _rec.ARMED:
        _rec.set_bucket(None)
    return out if out is not None else _unflatten(layout, pieces)


# ---------------------------------------------------------------------------
# the dispatch armed by overlapped_backprop
# ---------------------------------------------------------------------------

class _Dispatch:
    """One armed backward pass: the cotangents as they arrive, the
    buckets issued in schedule order, their tiles under sharded_update."""

    def __init__(self, plan: OverlapPlan):
        self.plan = plan
        self.layout = plan.layout
        n = len(self.layout.shapes)
        self.bufs: List[Optional[torch.Tensor]] = [None] * n
        self.arrived = [False] * n
        self.ready: List[Any] = [None] * n     # CUDA event per entry
        self.tiles: List[Optional[torch.Tensor]] = \
            [None] * len(self.layout.buckets)
        self.next = 0                          # position in dispatch.order
        self.issued: List[int] = []            # bucket ids, issue order
        self.fired = 0                         # tap backwards that ran
        self.open = True
        self.done = None                       # last bucket's CUDA event
        # measurement (plan.time_device)
        self.issue_events: List[Any] = []      # (bucket, event)
        self.errors: Optional[list] = [] if plan.time_device else None
        self.bwd_end = None                    # event at finish()
        self.issue_s = 0.0                     # host seconds issuing
        self.finish_s = 0.0                    # host seconds in finish()
        self._lock = threading.Lock()

    def arrive(self, entries: List[int], cts) -> None:
        """A tap's backward: its leaves' cotangents, then every bucket that
        is now ready in schedule order."""
        ev = None
        if cts and cts[0].is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(cts[0].device))
        with self._lock:
            self.fired += 1
            for e, ct in zip(entries, cts):
                if self.arrived[e]:
                    raise ValueError(
                        f"overlap: leaf {self.layout.names[e]} reached two "
                        f"grad taps; every leaf must be covered by exactly "
                        f"one tap")
                # reduced in place: an expanded or strided cotangent
                # (the gradient of a sum) gets a buffer of its own
                self.bufs[e] = ct if ct.is_contiguous() else ct.contiguous()
                self.arrived[e], self.ready[e] = True, ev
            self._issue_ready()

    def _issue_ready(self):
        order = self.layout.dispatch.order
        while self.next < len(order):
            b = order[self.next]
            bl = self.layout.buckets[b]
            if not all(self.arrived[i] for i in bl.indices):
                return
            self._issue(b, bl)
            self.issued.append(b)
            self.next += 1

    def _issue(self, b: int, bl) -> None:
        t0 = time.perf_counter()
        if _rec.ARMED:
            _rec.set_bucket(_bucket_id(self.layout, b))
        parts = [self.bufs[i] for i in bl.indices]
        stream = self.plan.stream(parts[0].device)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            if stream is not None:
                for ev in {id(self.ready[i]): self.ready[i]
                           for i in bl.indices}.values():
                    stream.wait_event(ev)
                for t in parts:
                    t.record_stream(stream)
                if self.plan.time_device:
                    iev = torch.cuda.Event(enable_timing=True)
                    iev.record(stream)
                    self.issue_events.append((b, iev))
            wire = self.layout.bucket_wire[b]
            spec = self.layout.bucket_spec[b]
            if self.plan.sharded:
                self.tiles[b] = _scatter_bucket(parts, bl, wire, self.plan,
                                                self.errors, spec=spec)
                for i in bl.indices:      # the tile is all this rank keeps
                    self.bufs[i] = None
            else:
                _reduce_bucket_(parts, bl, wire, self.plan, self.errors,
                                spec=spec)
            if stream is not None:
                self.done = torch.cuda.Event(enable_timing=
                                             self.plan.time_device)
                self.done.record(stream)
        if _rec.ARMED:
            _rec.set_bucket(None)
        self.issue_s += time.perf_counter() - t0

    def finish(self):
        """Every bucket issued; the caller's stream ordered after the last.
        Returns the reduced leaves (path-sorted) or, under sharded_update,
        the tiles (plan order)."""
        t0 = time.perf_counter()
        # the taps' backwards may have run on autograd's device threads:
        # read what they wrote, and issue the rest, under their lock
        with self._lock:
            if self.plan.time_device and self.done is not None:
                # after the backward's last kernel on the caller's stream
                self.bwd_end = torch.cuda.Event(enable_timing=True)
                self.bwd_end.record()
            missing = [n for n, a in zip(self.layout.names, self.arrived)
                       if not a]
            if missing:
                raise ValueError(
                    f"overlap: grad taps fired but leaves {missing} never "
                    f"reached one; every leaf must be covered by exactly "
                    f"one tap (the port's Llama taps each layer's weights "
                    f"and, with tap_root, the rest)")
            self._issue_ready()
            out = list(self.tiles if self.plan.sharded else self.bufs)
            # the caller owns the gradients now: a dispatch kept for its
            # stats (plan.last) must not hold a step's worth of them
            self.bufs = [None] * len(self.bufs)
            self.tiles = [None] * len(self.tiles)
            done = self.done
        if done is not None:
            cur = torch.cuda.current_stream(out[0].device)
            cur.wait_event(done)
            for t in out:
                t.record_stream(cur)
        self.finish_s = time.perf_counter() - t0
        return out

    def stats(self) -> dict:
        """What a measured dispatch saw (``plan.time_device``; synchronize
        the card first): buckets and their layer keys in issue order, how
        many were issued on the device before the backward's last kernel,
        the device ms from that kernel to the last bucket's end (the
        exposed plane), the host ms spent issuing and in ``finish()``, and
        the wire's relative quantization error."""
        with self._lock:    # what the issuing threads wrote
            issued, issue_s = list(self.issued), self.issue_s
            issue_events = list(self.issue_events)
            bwd_end, done = self.bwd_end, self.done
        layers = [self.layout.dispatch.layers[b] for b in issued]
        out = {"buckets": len(issued), "bucket_layers": layers,
               "issue_host_ms": 1e3 * issue_s,
               "finish_host_ms": 1e3 * self.finish_s}
        if bwd_end is not None:
            out["issued_before_backward_end"] = sum(
                1 for _, ev in issue_events if ev.elapsed_time(bwd_end) > 0)
            out["exposed_device_ms"] = max(0.0, bwd_end.elapsed_time(done))
        if self.errors:
            err = sum(e for e, _ in self.errors)
            total = sum(c for _, c in self.errors)
            out["quantization_error_rel"] = float((err / total).sqrt())
        return out


def plane_bytes(layout: OverlapLayout, fmt) -> Tuple[int, int]:
    """(wire bytes, full-width bytes) of one step's buckets through the
    scatter and gather stages: the quantized payloads and their fp32
    scales where a bucket is quantized, 4 bytes an element where not."""
    wire = full = 0
    for bl, w in zip(layout.buckets, layout.bucket_wire):
        full += 2 * 4 * bl.numel
        wire += (2 * fmt.wire_nbytes(bl.padded_numel)
                 if fmt is not None and w != "none" else 2 * 4 * bl.numel)
    return wire, full


_ACTIVE: Optional[_Dispatch] = None


def active() -> bool:
    """True while an :func:`overlapped_backprop` context is armed."""
    return _ACTIVE is not None


@contextlib.contextmanager
def overlapped_backprop(tx, count=None, fire=None):
    """Arm the model's grad taps with ``tx``'s dispatch plan::

        with hvd.overlapped_backprop(tx):
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        tx.update(grads, state, params)

    Both passes run inside the context.  With ``backward_passes_per_step >
    1`` pass ``count=state.count``: the taps dispatch only on the step that
    completes the accumulation.  ``fire=False`` (k == 1) disarms the taps
    for one step, so the transform runs the same plan at the boundary (an
    A/B of the two schedules on the same weights).

    Coverage contract: once any tap fires, ``tx.update`` takes every
    gradient from the dispatch, so every parameter must be covered by
    exactly one tap (the port's Llama taps each layer's weights and the
    rest through :func:`tap_root`); a leaf no tap reached raises there.
    No tap firing logs a warning and leaves the reduction to the step
    boundary.  Contexts do not nest, and a backward pass that raises
    inside the context commits nothing.
    """
    global _ACTIVE
    plan = plan_for(tx)
    if _ACTIVE is not None:
        raise RuntimeError(
            "overlapped_backprop contexts do not nest: one backward pass "
            "has one dispatch plan")
    if plan.layout is None:
        raise ValueError("overlapped_backprop: call tx.init(params) first; "
                         "the plan is laid out over those parameters")
    if plan.k > 1:
        if fire is not None:
            raise ValueError(
                "overlapped_backprop: with backward_passes_per_step > 1 "
                "the gate is the accumulation boundary; pass "
                "count=state.count, not an explicit fire")
        if count is None:
            raise ValueError(
                f"overlapped_backprop: backward_passes_per_step={plan.k} "
                f"gates the tap dispatch on the accumulation boundary; "
                f"pass count=state.count")
        fire = (int(count) + 1) % plan.k == 0
    if plan._pending is not None:
        logger.warning(
            "overlapped_backprop: discarding a dispatch that tx.update "
            "never read; arm the context and call tx.update in the same "
            "step")
        plan.consume()
    token = _Dispatch(plan)
    token.open = fire is None or bool(fire)
    _ACTIVE = token
    try:
        yield token
    except BaseException:
        token.open = False
        _ACTIVE = None
        raise
    _ACTIVE = None
    token.open = False
    if token.fired:
        plan._pending = token
    elif fire is None or fire:
        logger.warning(
            "overlapped_backprop: no grad taps fired inside the context: "
            "the model's backward pass has no tap sites (the port's Llama "
            "taps its layers; custom models call optim.overlap.grad_tap), "
            "so the reduction runs un-overlapped at the step boundary")


class _Tap(torch.autograd.Function):
    """The identity; its backward hands the cotangents to the dispatch."""

    @staticmethod
    def forward(ctx, token, entries, *tensors):
        ctx.token, ctx.entries = token, entries
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *cts):
        token = ctx.token
        if not token.open:      # the context closed before this backward
            return (None, None) + cts
        token.arrive(ctx.entries, list(cts))
        return (None, None) + (None,) * len(cts)


def grad_tap(tree):
    """The identity on ``tree`` (a dict of parameter tensors); inside an
    armed :func:`overlapped_backprop` its backward dispatches the
    cotangents (see the module docstring).  Models call it on each layer's
    weights; outside a context it returns ``tree`` unchanged."""
    token = _ACTIVE
    if token is None or not token.open or not tree:
        return tree
    names = list(tree)
    tensors = [tree[n] for n in names]
    try:
        entries = [token.plan.index[id(t)] for t in tensors]
    except KeyError:
        raise ValueError(
            "grad_tap: a tapped tensor is not a leaf of the parameters "
            "the transform was initialized with (tx.init(params)); tap "
            "the parameter tensors themselves") from None
    return dict(zip(names, _Tap.apply(token, entries, *tensors)))


def tap_root(params, layers_key: Optional[str] = None):
    """Tap every top-level leaf of ``params`` outside the layer stack as
    one tap: the tap wraps the value, so every use (the tied embedding's
    lookup and head) adds to one cotangent before it is dispatched.  The
    identity outside an armed context; inside one ``params`` must be a
    dict (a leaf left untapped would go unreduced)."""
    if _ACTIVE is None:
        return params
    if not isinstance(params, dict):
        raise TypeError(
            f"tap_root needs a dict param tree to split the layer stack "
            f"from the root leaves, got {type(params).__name__}: tap the "
            f"other leaves with grad_tap")
    if layers_key is None:
        layers_key = _ACTIVE.plan.layers_key
    rest = {k: v for k, v in params.items() if k != layers_key}
    if not rest:
        return params
    return {**params, **grad_tap(rest)}
