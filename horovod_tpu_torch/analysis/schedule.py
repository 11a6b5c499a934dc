"""The port's collective schedules, held against the pinned snapshots
(HVD211) and across world sizes and ranks (HVD210).

Counterpart: ``horovod_tpu/analysis/schedule.py`` (``tools/hvdsched``).
The JAX package traces each builtin entry point to a jaxpr and walks it;
the eager port has no jaxpr, so it RECORDS: the recorder
(``analysis/recorder.py``) is armed around one step of each entry, rebuilt
on the port's API with the JAX entry's shapes, dtypes, ``_THRESHOLD``
(1024 B) and pinned knobs, and every data-plane collective reports there
as it is issued.  Each entry runs on real gloo ranks on the CPU, one
spawned world per size (:func:`record_worlds`): the 1-D entries at
``workers`` 2 and 4, the 2-D ones (``fsdp``, ``tail``, ``serve_mp``) at
2×2 and 4×2.

**Comparison with a pinned snapshot** (``tests/schedules/<entry>.json``,
read and never written) covers ``index``, ``prim``, ``axes``,
``inputs``, ``outputs``, ``bucket`` and ``params``, after these rules
turn the snapshot into the port's expected records
(:func:`expected_records`):

1. ``path`` is erased: it is a jaxpr notion (a newer jax renames
   ``pjit<inner>``), and the port's records carry none.
2. A run of records whose path lies in a ``scan:`` body stands for one
   run per scan iteration: the port unrolls the layers (a list of
   per-layer dicts), so it issues the run once per layer (``layers`` of
   the entry), in reverse layer order during the backward and before
   the root leaves' records.
3. A record under ``cond:branches[k]`` is expected exactly when the
   entry takes that branch (``taken`` of the entry): the health
   sentinel's gather at ``health_check_every=1``.
4. A deliberate difference of the port (:data:`DIFFERENCES`, each
   pinned by a test) rewrites the snapshot's records of its entry into
   the port's form.

Any other mismatch is a finding (HVD211).  **Consistency** (HVD210)
holds each entry's canonical schedule (shapes and axis sizes erased) at
the two sizes equal, and, the port's own hazard (eager code can issue a
collective on one rank only), every rank of one world to the same full
schedule, shapes included.

CLI::

    python -m horovod_tpu_torch.analysis.schedule --check --consistency
    python -m horovod_tpu_torch.analysis.schedule --emit distopt_step
    python -m horovod_tpu_torch.analysis.schedule --update OUT_DIR

``--update`` writes the recorded schedules to a directory the caller
names and refuses ``tests/schedules/``, which belongs to the JAX package.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from . import recorder
from .report import Finding

#: Snapshot format version (JAX ``schedule.FORMAT``).
FORMAT = 1

#: The repo root: the directory holding the port's package.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# schedule model (JAX's, with its JSON layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveRecord:
    """One collective in issue order."""
    index: int
    prim: str
    axes: List[str]
    inputs: List[str]            # "float32[8x16]" aval strings
    outputs: List[str]
    path: str                    # the JAX sub-jaxpr context; "" here
    bucket: Optional[int]        # fusion bucket id
    params: Dict[str, Any]

    def as_dict(self) -> dict:
        return {"index": self.index, "prim": self.prim, "axes": self.axes,
                "inputs": self.inputs, "outputs": self.outputs,
                "path": self.path, "bucket": self.bucket,
                "params": self.params}

    @classmethod
    def from_dict(cls, r: dict) -> "CollectiveRecord":
        return cls(index=r["index"], prim=r["prim"], axes=list(r["axes"]),
                   inputs=list(r["inputs"]), outputs=list(r["outputs"]),
                   path=r.get("path", ""), bucket=r["bucket"],
                   params=dict(r["params"]))

    def canonical(self) -> Tuple:
        """Shape-and-mesh-erased identity for HVD210 comparisons."""
        params = {k: v for k, v in self.params.items()
                  if k not in ("axis_size", "perm")}
        return (self.prim, tuple(self.axes), self.path, self.bucket,
                tuple(sorted((k, json.dumps(v)) for k, v in params.items())))


@dataclasses.dataclass
class Schedule:
    entry: str
    axis_env: List[Tuple[str, int]]
    records: List[CollectiveRecord]

    def to_json(self) -> str:
        payload = {
            "format": FORMAT,
            "entry": self.entry,
            "axis_env": [[n, int(s)] for n, s in self.axis_env],
            "records": [r.as_dict() for r in self.records],
        }
        return json.dumps(payload, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "Schedule":
        data = json.loads(text)
        if int(data.get("format", -1)) != FORMAT:
            raise ValueError(
                f"schedule snapshot format {data.get('format')} != "
                f"supported format {FORMAT}")
        return cls(entry=data["entry"],
                   axis_env=[(n, int(s)) for n, s in data["axis_env"]],
                   records=[CollectiveRecord.from_dict(r)
                            for r in data["records"]])

    def canonical(self) -> List[Tuple]:
        return [r.canonical() for r in self.records]


def diff_schedules(expected: Schedule, actual: Schedule) -> List[str]:
    """Human-readable unified diff of two schedules' JSON forms (empty
    when identical)."""
    exp, act = expected.to_json().splitlines(), actual.to_json().splitlines()
    return list(difflib.unified_diff(
        exp, act, fromfile=f"expected/{expected.entry}",
        tofile=f"actual/{actual.entry}", lineterm=""))


# ---------------------------------------------------------------------------
# from a pinned snapshot to the port's expected records
# ---------------------------------------------------------------------------

def _renumber(records: List[CollectiveRecord]) -> List[CollectiveRecord]:
    return [dataclasses.replace(r, index=i) for i, r in enumerate(records)]


def _scan_path(path: str) -> Optional[str]:
    """The ``scan:`` body a record's path lies in, else None."""
    parts = path.split("/")
    for i, p in enumerate(parts):
        if p.startswith("scan:"):
            return "/".join(parts[:i + 1])
    return None


def _branch(path: str) -> Optional[str]:
    """The innermost ``cond:branches[k]`` of a record's path, else None."""
    hits = [p for p in path.split("/") if p.startswith("cond:branches[")]
    return hits[-1] if hits else None


def _unroll_scans(records, layers: int):
    """Rule 2: each maximal run of records in one scan body, once per
    layer, in place."""
    out: List[CollectiveRecord] = []
    i = 0
    while i < len(records):
        body = _scan_path(records[i].path)
        if body is None:
            out.append(records[i])
            i += 1
            continue
        j = i
        while j < len(records) and _scan_path(records[j].path) == body:
            j += 1
        out.extend(records[i:j] * layers)
        i = j
    return out


def _flat_gathers(records, entry) -> List[CollectiveRecord]:
    """Deliberate difference: an untiled ``all_gather`` of ``X[s]``
    (JAX's stacked ``[n, s]`` rows) is the port's tiled gather of the
    flattened ``X[prod s]`` into ``X[n * prod s]``: the port's planned
    collectives move 1-D buffers (``ops/collectives.all_gather_flat``)."""
    from .wire import _AVAL_RE

    def flat(a):
        dtype, dims = _AVAL_RE.match(a).groups()
        numel = 1
        for d in (dims.split("x") if dims else []):
            numel *= int(d)
        return f"{dtype}[{numel}]"

    out = []
    for r in records:
        if r.prim == "all_gather" and r.params.get("tiled") is False:
            r = dataclasses.replace(
                r, inputs=[flat(a) for a in r.inputs],
                outputs=[flat(a) for a in r.outputs],
                params=dict(r.params, tiled=True, all_gather_dimension=0))
        out.append(r)
    return out


def _one_agreement(records, entry) -> List[CollectiveRecord]:
    """Deliberate difference of the tail policy's stages: JAX agrees on
    the host mask with a ``pmin`` over ``workers`` and then one over
    ``hvd_local``; the port agrees in ONE all-reduce MIN over the whole
    process set, which spans both axes (``ops/collectives._agree_min``)."""
    out: List[CollectiveRecord] = []
    for r in records:
        prev = out[-1] if out else None
        if (r.prim == "pmin" and prev is not None and prev.prim == "pmin"
                and prev.axes == ["workers"] and r.axes == ["hvd_local"]
                and prev.bucket == r.bucket):
            out[-1] = dataclasses.replace(prev,
                                          axes=["workers", "hvd_local"])
            continue
        out.append(r)
    return out


def _serve_mp_port_form(records, entry) -> List[CollectiveRecord]:
    """Deliberate difference of ``MeshSlicedForward``: the group's leader
    broadcasts each batch (a header of three int64, the tokens, the
    lengths) before the weights move, and the port's per-layer leaves are
    gathered one at a time in its tree order, each as JAX's stacked
    leaf's record without the layer dim (the gather dim one lower)."""
    from .wire import _AVAL_RE
    ctx = _serve_mp_ctx()
    paths = ctx["leaf_paths"]
    names = sorted({p.split(".", 2)[2] for p in paths
                    if p.startswith("layers.")})
    roots = sorted(p for p in paths if not p.startswith("layers."))
    # JAX's tree order: the root leaves and the stacked layer leaves,
    # every key sorted ("embed" < "final_norm" < "layers")
    jax_names = [p for p in roots if p < "layers"] + [
        f"layers.{n}" for n in names] + [p for p in roots if p > "layers"]
    if len(jax_names) != len(records):
        return records      # not the tree this rule knows: no rewrite
    by_name = dict(zip(jax_names, records))

    def unstack(a):
        dtype, dims = _AVAL_RE.match(a).groups()
        return f"{dtype}[{'x'.join(dims.split('x')[1:])}]"

    out = [dataclasses.replace(
        records[0], prim="pbroadcast", inputs=[a], outputs=[a],
        bucket=None, params={"source": 0})
        for a in ("int64[3]", *ctx["batch_avals"])]
    for p in paths:
        if p.startswith("layers."):
            r = by_name[f"layers.{p.split('.', 2)[2]}"]
            r = dataclasses.replace(
                r, inputs=[unstack(a) for a in r.inputs],
                outputs=[unstack(a) for a in r.outputs],
                params=dict(r.params, all_gather_dimension=int(
                    r.params["all_gather_dimension"]) - 1))
        else:
            r = by_name[p]
        out.append(r)
    return out


#: entry -> the deliberate differences that rewrite its snapshot into the
#: port's form, in order (each a deliberate difference pinned by a test)
DIFFERENCES: Dict[str, Tuple[Callable, ...]] = {
    "health_distopt_step": (_flat_gathers,),
    "tail_distopt_step": (_one_agreement, _flat_gathers),
    "serve_mp_forward_step": (_serve_mp_port_form,),
}


def expected_records(entry: "Entry", snapshot: Schedule
                     ) -> List[CollectiveRecord]:
    """The records the port must issue for ``entry``, from the JAX
    package's pinned ``snapshot`` (rules 1–4 of the module docstring)."""
    recs = [r for r in snapshot.records
            if _branch(r.path) is None or _branch(r.path) in entry.taken]
    recs = _unroll_scans(recs, entry.layers)
    recs = [dataclasses.replace(r, path="") for r in recs]
    for rule in DIFFERENCES.get(entry.name, ()):
        recs = rule(recs, entry)
    return _renumber(recs)


# ---------------------------------------------------------------------------
# the builtin entries, on the port's API
# ---------------------------------------------------------------------------

_AXIS = "workers"
#: Small threshold so the representative gradient tree splits into
#: multiple buckets: the snapshot then pins bucket ORDER, not just count.
_THRESHOLD = 1024
#: toy layer stack of the overlapped entry (layers, width, vocab rows)
_OVERLAP_L, _OVERLAP_D, _OVERLAP_V = 3, 8, 5
#: the fixed second axis of the 2-D entries (the checks vary the first)
_FSDP_MODEL = _TAIL_LOCAL = _SERVE_MP = 2


@dataclasses.dataclass
class Entry:
    """One builtin entry: ``build(n)`` sets the entry up on this rank
    (``n``: the size of the varied ``workers`` axis) and returns the step
    to record, the axis names the recording renames, and the mesh it
    resolves groups through.  ``second``: the fixed second axis of a 2-D
    entry; ``layers``: rule 2's scan iterations; ``taken``: rule 3's
    branches."""
    name: str
    build: Callable
    doc: str
    second: Optional[Tuple[str, int]] = None
    layers: int = 1
    taken: Tuple[str, ...] = ()

    def world(self, n: int) -> int:
        return n * (self.second[1] if self.second else 1)

    def axis_env(self, n: int) -> List[Tuple[str, int]]:
        return [(_AXIS, n)] + ([self.second] if self.second else [])


def _grads(shapes=None):
    """The JAX entry's representative mixed-dtype gradient tree, from a
    seed: float32 splits across two buckets at ``_THRESHOLD`` while
    bfloat16 fuses into one."""
    import torch
    gen = torch.Generator().manual_seed(0)
    shapes = shapes or {"dense/bias": ((16,), torch.float32),
                        "dense/kernel": ((8, 16), torch.float32),
                        "embed/table": ((32, 8), torch.bfloat16),
                        "head/bias": ((4,), torch.bfloat16),
                        "head/kernel": ((64, 4), torch.float32)}
    return {k: torch.randn(s, generator=gen).to(dt)
            for k, (s, dt) in shapes.items()}


def _adam(params):
    import torch
    return torch.optim.Adam(params, lr=1e-3)


def _transform(**kw):
    from ..optim.distributed import DistributedGradientTransform
    # every rewrite pinned off unless the entry pins it on: the schedule
    # must not flip with the operator's HOROVOD_* environment
    pinned = dict(threshold_bytes=_THRESHOLD, sharded_update=False,
                  wire_format="none", overlap=False, health=False)
    pinned.update(kw)
    return DistributedGradientTransform(_adam, **pinned)


def _transform_step(**kw):
    import torch
    tx = _transform(**kw)
    grads = _grads()
    params = {k: torch.zeros_like(v) for k, v in grads.items()}
    state = tx.init(params)
    return lambda: tx.update(grads, state, params)


def _entry_fused_reduce(n):
    """The fusion-buffer path: one psum per planned bucket."""
    from ..optim.distributed import fused_reduce_tree
    grads = _grads()
    return lambda: fused_reduce_tree(grads, op="average",
                                     threshold_bytes=_THRESHOLD)


def _entry_distopt_step(n):
    """A full DistributedGradientTransform update (Adam inner)."""
    return _transform_step()


def _entry_jit_fused_reduce(n):
    """JAX's fused_reduce_tree under jax.jit; eager, the same plan as a
    Sum (the jaxpr path the snapshot records is erased, rule 1)."""
    from ..optim.distributed import fused_reduce_tree
    grads = _grads()
    return lambda: fused_reduce_tree(grads, op="sum",
                                     threshold_bytes=_THRESHOLD)


def _entry_sharded_distopt_step(n):
    """The ZeRO step: per bucket reduce_scatter, 1/N update, all_gather."""
    return _transform_step(sharded_update=True)


def _entry_quantized_distopt_step(n):
    """The int8 wire: per bucket all_to_all of int8 tiles and fp32
    scales, fp32 accumulation, all_gather of the quantized tiles."""
    return _transform_step(wire_format="int8", wire_block_size=16)


def _entry_overlapped_distopt_step(n):
    """Overlapped dispatch: the toy's grad taps reduce each layer's
    buckets during the backward, in reverse layer order, and the root
    leaves' bucket at its end (rule 2 unrolls JAX's scan body)."""
    import torch
    from ..optim import overlap as ov
    from ..tree import tree_leaves, tree_map
    L, D, V = _OVERLAP_L, _OVERLAP_D, _OVERLAP_V
    gen = torch.Generator().manual_seed(0)

    def leaf(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * 0.1).to(
            dtype).requires_grad_()

    params = {"embed": leaf(V, D),
              "layers": [{"b": leaf(D), "s": leaf(D, dtype=torch.bfloat16),
                          "w": leaf(D, D)} for _ in range(L)],
              "final_norm": leaf(D)}
    x = torch.randn(2, V, generator=gen)
    tx = _transform(overlap=True)
    state = tx.init(params)
    leaves = tree_leaves(params)

    def loss():
        p = ov.tap_root(params)
        h = x @ p["embed"]
        for lp in p["layers"]:
            lp = ov.grad_tap(lp)
            h = torch.tanh(h @ lp["w"] + lp["b"]) * lp["s"].to(h.dtype)
        return (h * p["final_norm"]).sum()

    def step():
        with ov.overlapped_backprop(tx):
            grads = torch.autograd.grad(loss(), leaves, allow_unused=True)
        it = iter(grads)
        tx.update(tree_map(lambda _: next(it), params), state, params)
    return step


def _entry_health_distopt_step(n):
    """The health-tapped step: local taps, plus the sentinel's one
    all_gather of the per-bucket checksums (health_check_every=1: the
    first update takes the sentinel's branch)."""
    return _transform_step(health=True, health_check_every=1)


def _fsdp_specs():
    return {"dense/kernel": ("tp", None), "dense/bias": (None,),
            "embed/table": ("tp", None), "head/bias": (None,),
            "head/kernel": (None, "tp")}


def _entry_fsdp_distopt_step(n):
    """param_specs over a (data × model) mesh with the ZeRO update:
    model-sharded buckets reduce-scatter their local shard over the data
    axis alone; replicated ones sum over the model axis first; every
    bucket's update all-gathers over the data axis."""
    import torch
    from ..parallel.mesh import MeshConfig, ParallelMesh
    mesh = ParallelMesh(MeshConfig(dp=n, tp=_FSDP_MODEL))
    grads = _grads({"dense/kernel": ((4, 16), torch.float32),
                    "dense/bias": ((16,), torch.float32),
                    "embed/table": ((16, 8), torch.bfloat16),
                    "head/bias": ((4,), torch.bfloat16),
                    "head/kernel": ((64, 2), torch.float32)})
    params = {k: torch.zeros_like(v) for k, v in grads.items()}
    tx = _transform(sharded_update=True, param_specs=_fsdp_specs(),
                    model_axes=("tp",), mesh=mesh)
    state = tx.init(params)
    return (lambda: tx.update(grads, state, params)), {"tp": "hvd_model"}, \
        mesh


def _entry_tail_distopt_step(n):
    """The tail-tolerant hierarchical reduce under the ``stale`` policy
    (max staleness 3): per bucket a reduce-scatter within the host, the
    ranks' agreement on the host mask, the DCN stage's all-gather of
    per-host chunks, the all-gather within the host; then Adam."""
    from .. import runtime
    from ..optim.distributed import fused_reduce_tree
    ps = runtime._get_global_process_set()
    ps._hier_shape = (n, _TAIL_LOCAL)
    cfg = runtime._state().config
    cfg.hierarchical_allreduce = True
    cfg.tail_policy = "stale"
    cfg.tail_max_staleness = 3
    ps.hier_groups()        # made outside the recording, on every rank
    grads = _grads()
    params = [g.clone() for g in grads.values()]
    opt = _adam(params)

    def step():
        fused_reduce_tree(grads, op="average", threshold_bytes=_THRESHOLD)
        for p, g in zip(params, grads.values()):
            p.grad = g
        opt.step()
    return step


def _tiny_llama():
    from ..models import llama
    return llama.tiny(vocab=64, seq=32), llama


def _entry_serve_forward_step(n):
    """Serving is pure data parallelism: one batched ragged decode issues
    no collective, so the pinned schedule is empty."""
    import torch
    from ..models.generate import batched_greedy_decode
    cfg, llama = _tiny_llama()
    params = llama.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([16, 9])
    return lambda: batched_greedy_decode(params, cfg, tokens, lengths,
                                         max_new_tokens=4, max_len=20)


def _entry_serve_mp_forward_step(n):
    """Model-parallel serving: ``MeshSlicedForward`` over slices of 2
    ranks, the weights gathered over ``hvd_serve_mp`` inside the call,
    sharded by ``fsdp_param_specs`` as FSDP training shards them."""
    import numpy as np
    from ..serving.shapes import ShapeBuckets
    from ..serving.worker import MeshSlicedForward
    cfg, llama = _tiny_llama()
    params = llama.init_params(cfg, seed=0, device="cpu")
    fwd = MeshSlicedForward(params, cfg, max_new_tokens=4,
                            buckets=ShapeBuckets((2,), (16,)),
                            mp=_SERVE_MP)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (2, 16)).astype(np.int64)
    lengths = np.array([16, 9], np.int64)
    if fwd.group.rank() == 0:
        return lambda: fwd(tokens, lengths)
    return fwd


def _serve_mp_ctx() -> Dict[str, Any]:
    """What ``_serve_mp_port_form`` needs: the port's leaf paths in tree
    order and the broadcast batch's avals."""
    from ..tree import tree_paths
    cfg, llama = _tiny_llama()
    return {"leaf_paths": tree_paths(llama.init_params(cfg, seed=0,
                                                       device="cpu")),
            "batch_avals": ("int64[2x16]", "int64[2]")}


def _entry(name, build, **kw) -> Entry:
    doc = (build.__doc__ or "").strip().splitlines()[0]
    return Entry(name=name, build=build, doc=doc, **kw)


#: entry name -> Entry: the JAX package's 11 builtin entries on the port
BUILTIN_ENTRIES: Dict[str, Entry] = {e.name: e for e in (
    _entry("fused_reduce", _entry_fused_reduce),
    _entry("distopt_step", _entry_distopt_step),
    _entry("jit_fused_reduce", _entry_jit_fused_reduce),
    _entry("sharded_distopt_step", _entry_sharded_distopt_step),
    _entry("quantized_distopt_step", _entry_quantized_distopt_step),
    _entry("overlapped_distopt_step", _entry_overlapped_distopt_step,
           layers=_OVERLAP_L),
    _entry("tail_distopt_step", _entry_tail_distopt_step,
           second=("hvd_local", _TAIL_LOCAL)),
    _entry("health_distopt_step", _entry_health_distopt_step,
           taken=("cond:branches[1]",)),
    _entry("fsdp_distopt_step", _entry_fsdp_distopt_step,
           second=("hvd_model", _FSDP_MODEL)),
    _entry("serve_forward_step", _entry_serve_forward_step),
    _entry("serve_mp_forward_step", _entry_serve_mp_forward_step,
           second=("hvd_serve_mp", _SERVE_MP)),
)}


def _entry_rank_conditional(n):
    """A toy step with a rank-conditional collective: rank 1 reduces by
    MAX where the others reduce by MIN (gloo pairs the calls, the
    schedules differ)."""
    import torch
    from .. import runtime
    from ..ops import collectives
    ps = runtime._get_global_process_set()
    op = "max" if runtime.rank() == 1 else "min"
    return lambda: collectives.allreduce_arrays([torch.ones(4)], ps, op=op)


#: entries the checks do not run by default (tests name them)
TOY_ENTRIES: Dict[str, Entry] = {
    "rank_conditional": _entry("rank_conditional",
                               _entry_rank_conditional),
}

#: Mesh sizes the consistency check records every entry at (HVD210).
_CONSISTENCY_SIZES = (2, 4)
#: The size the snapshots were traced at.
_SNAPSHOT_SIZE = 2


def _lookup(name: str) -> Entry:
    return BUILTIN_ENTRIES.get(name) or TOY_ENTRIES[name]


def record_entry(name: str, n: int) -> Schedule:
    """Record one step of entry ``name`` on this rank (the runtime up at
    the entry's world size for ``n``)."""
    entry = _lookup(name)
    built = entry.build(n)
    if not isinstance(built, tuple):
        built = (built,)
    step, axis_names, mesh = (tuple(built) + (None, None))[:3]
    with recorder.recording(axis_names=axis_names, mesh=mesh) as rec:
        if mesh is not None:
            with mesh:
                step()
        else:
            step()
    return Schedule(entry=name, axis_env=entry.axis_env(n),
                    records=[CollectiveRecord.from_dict(r)
                             for r in rec.records])


# ---------------------------------------------------------------------------
# spawned worlds
# ---------------------------------------------------------------------------

def _plan(world: int, entries: Iterable[str],
          sizes: Sequence[int]) -> List[Tuple[str, int]]:
    """The (entry, n) pairs a world of ``world`` ranks records: each
    entry at each of ``sizes`` whose world it is."""
    return [(name, n) for name in entries for n in sizes
            if _lookup(name).world(n) == world]


def worlds_for(entries: Iterable[str], sizes: Sequence[int]) -> List[int]:
    return sorted({_lookup(name).world(n) for name in entries
                   for n in sizes})


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _excerpt(log: str) -> str:
    """A rank's first Python traceback (its cause), else its tail."""
    i = log.find("Traceback")
    return log[i:i + 3000] if i >= 0 else log[-3000:]


def _launch(world: int, plan, out: str, timeout: float
            ) -> Tuple[bool, str]:
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("HOROVOD_")}
    spec = json.dumps(plan)
    procs = []
    for r in range(world):
        env = dict(base, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(world),
                   HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                   HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                   HOROVOD_CYCLE_TIME="0.1",
                   HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="120",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [_ROOT] + [p for p in [base.get("PYTHONPATH")]
                                  if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.analysis.schedule",
             "--rank-worker", out, "--plan", spec],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True))
    deadline = time.monotonic() + timeout
    expired = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            expired = True
            break
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    logs = [_excerpt(p.communicate()[0].decode(errors="replace"))
            for p in procs]
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if expired or bad:
        return False, (f"world {world}: {'timed out' if expired else ''} "
                       f"ranks {bad}\n" + "\n".join(
                           f"--- rank {r}\n{log}"
                           for r, log in enumerate(logs)))
    return True, ""


def record_worlds(entries: Optional[Iterable[str]] = None,
                  sizes: Sequence[int] = _CONSISTENCY_SIZES,
                  timeout: float = 300.0
                  ) -> Dict[Tuple[str, int], List[Schedule]]:
    """Record every entry at every size, one spawned world of gloo ranks
    on the CPU per world size; returns ``{(entry, n): [rank 0's schedule,
    rank 1's, ...]}``."""
    entries = list(entries or sorted(BUILTIN_ENTRIES))
    out: Dict[Tuple[str, int], List[Schedule]] = {}
    for world in worlds_for(entries, sizes):
        plan = _plan(world, entries, sizes)
        with tempfile.TemporaryDirectory(prefix="hvdsched-") as tmp:
            for attempt in range(3):
                ok, log = _launch(world, plan, tmp, timeout)
                if ok or "EADDRINUSE" not in log:
                    break
            if not ok:
                raise RuntimeError(f"recording the schedules failed: {log}")
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.json"),
                          encoding="utf-8") as f:
                    got = json.load(f)
                for name, n in plan:
                    out.setdefault((name, n), []).append(
                        Schedule.from_json(json.dumps(got[f"{name}@{n}"])))
    return out


def _rank_worker(out: str, plan) -> int:
    """One rank of a spawned world: record each planned entry."""
    import horovod_tpu_torch as hvd
    from .. import runtime
    hvd.init(device="cpu")
    got = {}
    try:
        for name, n in plan:
            got[f"{name}@{n}"] = json.loads(record_entry(name, n).to_json())
            # each entry from the same runtime state: a pinned knob or a
            # forced hierarchy of one entry does not leak into the next
            runtime._get_global_process_set()._hier_shape = None
            runtime._state().config = type(runtime._state().config
                                           ).from_env()
        rank = hvd.rank()
    finally:
        hvd.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w",
              encoding="utf-8") as f:
        json.dump(got, f)
    return 0


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def snapshot_dir() -> str:
    return os.path.join(_ROOT, "tests", "schedules")


def snapshot_path(name: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory or snapshot_dir(), f"{name}.json")


def load_snapshot(name: str, directory: Optional[str] = None) -> Schedule:
    with open(snapshot_path(name, directory), encoding="utf-8") as f:
        return Schedule.from_json(f.read())


def check_snapshot(name: str, actual: Schedule,
                   directory: Optional[str] = None) -> List[Finding]:
    """HVD211 when the port's recorded schedule of ``name`` is not what
    its pinned snapshot implies (:func:`expected_records`)."""
    path = snapshot_path(name, directory)
    try:
        snap = load_snapshot(name, directory)
    except FileNotFoundError:
        return [Finding("HVD211", path, 1, 0,
                        f"no pinned snapshot for entry '{name}'")]
    except (ValueError, KeyError) as exc:
        return [Finding("HVD211", path, 1, 0,
                        f"unreadable snapshot: {exc}")]
    expected = Schedule(entry=name, axis_env=snap.axis_env,
                        records=expected_records(_lookup(name), snap))
    actual = Schedule(entry=name, axis_env=actual.axis_env,
                      records=_renumber([dataclasses.replace(r, path="")
                                         for r in actual.records]))
    diff = diff_schedules(expected, actual)
    if not diff:
        return []
    head = next((l for l in diff if l.startswith(("+", "-"))
                 and not l.startswith(("+++", "---"))), "")
    return [Finding("HVD211", path, 1, 0,
                    f"the port's collective schedule for entry '{name}' "
                    f"differs from its pinned snapshot "
                    f"({len(expected.records)} -> {len(actual.records)} "
                    f"records; first change: {head.strip()!r})")]


def check_consistency(variants: Sequence[Tuple[str, Schedule]]
                      ) -> List[Finding]:
    """HVD210 when any variant's canonical (shape/mesh-erased) schedule
    differs from the first — the cross-configuration invariant."""
    findings: List[Finding] = []
    if not variants:
        return findings
    base_label, base = variants[0]
    base_canon = base.canonical()
    for label, sched in variants[1:]:
        canon = sched.canonical()
        if canon == base_canon:
            continue
        detail = f"{len(base_canon)} vs {len(canon)} collectives"
        for i, (a, b) in enumerate(zip(base_canon, canon)):
            if a != b:
                detail = (f"record {i}: {a[0]} over {a[1]} vs "
                          f"{b[0]} over {b[1]}")
                break
        findings.append(Finding(
            "HVD210", base.entry, 1, 0,
            f"collective schedule differs between configuration "
            f"'{base_label}' and '{label}' ({detail}); every replica "
            f"must issue the same collectives in the same order, or the "
            f"ranks deadlock against each other"))
    return findings


def check_ranks(name: str, n: int, per_rank: Sequence[Schedule]
                ) -> List[Finding]:
    """HVD210 when a rank of one world recorded another full schedule
    (shapes included) than rank 0: eager code issued a collective on some
    ranks only, or another one."""
    findings: List[Finding] = []
    base = [r.as_dict() for r in per_rank[0].records]
    for rank, sched in enumerate(per_rank[1:], start=1):
        mine = [r.as_dict() for r in sched.records]
        if mine == base:
            continue
        i = next((i for i, (a, b) in enumerate(zip(base, mine)) if a != b),
                 min(len(base), len(mine)))
        a = base[i] if i < len(base) else None
        b = mine[i] if i < len(mine) else None

        def what(r):
            return ("nothing" if r is None else
                    f"{r['prim']} over {r['axes']} of {r['inputs']}")
        findings.append(Finding(
            "HVD210", name, 1, 0,
            f"rank {rank} of a world at {_AXIS}={n} issued another "
            f"schedule than rank 0 (record {i}: rank 0 {what(a)}, rank "
            f"{rank} {what(b)}; {len(base)} vs {len(mine)} collectives); "
            f"every rank must issue the same collectives in the same "
            f"order, or NCCL deadlocks"))
    return findings


def check_builtin_snapshots(recorded, directory: Optional[str] = None,
                            entries: Optional[Iterable[str]] = None
                            ) -> List[Finding]:
    findings: List[Finding] = []
    for name in (entries or sorted(BUILTIN_ENTRIES)):
        findings.extend(check_snapshot(
            name, recorded[(name, _SNAPSHOT_SIZE)][0], directory))
    return findings


def check_builtin_consistency(recorded,
                              entries: Optional[Iterable[str]] = None
                              ) -> List[Finding]:
    findings: List[Finding] = []
    for name in (entries or sorted(BUILTIN_ENTRIES)):
        for n in _CONSISTENCY_SIZES:
            findings.extend(check_ranks(name, n, recorded[(name, n)]))
        findings.extend(check_consistency(
            [(f"{_AXIS}={n}", recorded[(name, n)][0])
             for n in _CONSISTENCY_SIZES]))
    return findings


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _refuses(directory: str) -> bool:
    """True for the JAX package's snapshot directory (or inside it)."""
    d, pinned = os.path.realpath(directory), os.path.realpath(snapshot_dir())
    return d == pinned or d.startswith(pinned + os.sep)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.schedule",
        description="the port's collective schedules, recorded on gloo "
                    "ranks on the CPU and held against the JAX package's "
                    "pinned snapshots (HVD211) and across world sizes and "
                    "ranks (HVD210)")
    parser.add_argument("--list", action="store_true",
                        help="list the builtin entries")
    parser.add_argument("--emit", metavar="ENTRY",
                        help="print the recorded JSON schedule of an entry "
                             f"at {_AXIS}={_SNAPSHOT_SIZE}")
    parser.add_argument("--check", action="store_true",
                        help="hold every entry against its pinned snapshot "
                             "(exit 1 on a finding)")
    parser.add_argument("--consistency", action="store_true",
                        help=f"record every entry at {_AXIS} sizes "
                             f"{list(_CONSISTENCY_SIZES)} and require "
                             f"identical canonical schedules, and every "
                             f"rank's schedule identical (HVD210)")
    parser.add_argument("--dir", metavar="DIR", default=None,
                        help="snapshot directory to read "
                             "(default: tests/schedules/)")
    parser.add_argument("--update", metavar="OUT_DIR",
                        help="write the recorded schedules to OUT_DIR "
                             "(never tests/schedules/, the JAX package's)")
    parser.add_argument("--rank-worker", metavar="OUT", help=argparse.SUPPRESS)
    parser.add_argument("--plan", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.rank_worker:
        return _rank_worker(args.rank_worker, json.loads(args.plan))
    if args.list:
        print("builtin schedule entries:")
        for name, entry in sorted(BUILTIN_ENTRIES.items()):
            print(f"  {name:24s} {entry.doc}")
        return 0
    if args.update and _refuses(args.update):
        parser.error(f"--update refuses {args.update}: tests/schedules/ "
                     f"holds the JAX package's pinned snapshots, which the "
                     f"port reads and never writes; name another directory")
    if args.emit:
        if args.emit not in BUILTIN_ENTRIES:
            parser.error(f"unknown entry {args.emit!r} (see --list)")
        rec = record_worlds([args.emit], sizes=(_SNAPSHOT_SIZE,))
        print(rec[(args.emit, _SNAPSHOT_SIZE)][0].to_json(), end="")
        return 0
    if args.update:
        rec = record_worlds(sizes=(_SNAPSHOT_SIZE,))
        os.makedirs(args.update, exist_ok=True)
        for name in sorted(BUILTIN_ENTRIES):
            sched = rec[(name, _SNAPSHOT_SIZE)][0]
            path = snapshot_path(name, args.update)
            with open(path, "w", encoding="utf-8") as f:
                f.write(sched.to_json())
            print(f"hvdsched: recorded {path} "
                  f"({len(sched.records)} collective(s))")
        return 0
    if args.check or args.consistency:
        sizes = _CONSISTENCY_SIZES if args.consistency else (_SNAPSHOT_SIZE,)
        rec = record_worlds(sizes=sizes)
        findings: List[Finding] = []
        if args.check:
            findings.extend(check_builtin_snapshots(rec, args.dir))
        if args.consistency:
            findings.extend(check_builtin_consistency(rec))
        for f in findings:
            print(f.format_text())
        if findings:
            print(f"\nhvdsched: {len(findings)} finding(s)")
            return 1
        kinds = [k for k, on in (("snapshots", args.check),
                                 ("consistency", args.consistency)) if on]
        print(f"hvdsched: {len(BUILTIN_ENTRIES)} entries clean "
              f"({' + '.join(kinds)})")
        return 0
    parser.error("nothing to do (try --check, --consistency, --emit ENTRY, "
                 "--update OUT_DIR or --list)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
