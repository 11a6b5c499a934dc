"""Checkpointless elastic recovery: rebuild a lost worker from the fleet.

Counterpart: ``horovod_tpu/elastic/recovery.py``, copied (it imports only
numpy) over the port's ``chaos``, ``metrics`` and ``runner/rpc.py``: the
same frame bytes, parity groups, store rules, RPC payloads, metric
families and chaos sites.  The producer is the port's
``DistributedGradientTransform(recovery=agent)``, which hands this rank's
post-update state to :func:`deliver_boundary` from the host (the JAX
transform's in-jit tap does it through ``jax.debug.callback``).

Optimizer state is ZeRO-sharded 1/N per worker, so the fleet already
*is* a distributed copy of the job — this module makes that redundancy
explicit.  At a configurable accumulation-boundary cadence each worker
pushes a versioned snapshot *frame* of its per-worker state (ZeRO shard
tiles, error-feedback residuals, the boundary counter) to a peer over
the existing signed keep-alive RPC plane:

* ``neighbor`` mode — the full frame is replicated to the ring neighbor
  ``(rank + 1) % size`` (simple, 1x redundancy bytes);
* ``parity`` mode — workers form XOR parity groups of
  ``HOROVOD_RECOVERY_PARITY_GROUP`` members; each member sends its frame
  to the group's *holder*, which XOR-accumulates them into a single
  parity blob (``~1/G`` the held bytes; rebuild additionally pulls every
  surviving member's own frame of the same version).

Frames are versioned by ``(elastic epoch, boundary step)`` so a re-form
can tell a fresh tile from a stale one: stores refuse puts/gets below
their ``min_epoch`` watermark, and a departed worker's tiles are pruned
from the driver's :class:`RecoveryDirectory` on ``worker_gone`` /
``retain_workers`` so churn cannot accrete ghost versions that shadow a
live peer's fresher push.

On re-form the replacement worker calls :meth:`RecoveryAgent.rebuild`:
it asks the driver for the current peer plan (``recovery_plan`` RPC),
pulls its lost frame from the surviving replica (or XOR-reconstructs it
from the parity holder plus surviving members) under a configurable
deadline, optionally pre-warms serving bucket compiles before taking
traffic, and returns the decoded payload for
:func:`horovod_tpu_torch.optim.distributed.restore_dist_state`.

Serialization is deterministic and bit-exact: a frame is an 8-byte
big-endian header length, a JSON header (names sorted, dtype strings,
shapes, byte sizes), then the concatenated raw array bytes — the
round-trip is ``tobytes``/``frombuffer``, never a float cast.  Frames
ride JSON RPC base64-encoded; XOR parity operates on the raw frame
bytes zero-padded to the longest member frame.

Scope (as the JAX package documents it in docs/elastic.md): recovery covers
replacement-at-same-size re-forms — a resize changes the tile layout
and falls back to fresh initialization.  In-flight accumulation buckets
are *not* protected (they are zero at every boundary by construction);
at cadence E a rebuild loses at most E boundaries of progress.

Env contract: docs/env.md (``HOROVOD_RECOVERY*``); metric families:
docs/metrics.md (``hvd_recovery_*``); chaos sites ``recovery.push`` /
``recovery.rebuild``.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import chaos as _chaos
from .. import metrics as _metrics
from ..runner.rpc import json_request

logger = logging.getLogger("horovod_tpu_torch")

#: Valid HOROVOD_RECOVERY modes (config.py validates against this).
RECOVERY_MODES = ("off", "neighbor", "parity")

#: Surviving own-frame versions each worker keeps locally so a parity
#: rebuild can pull the exact version the parity blob was built from.
OWN_HISTORY = 4

# -- metric families (docs/metrics.md; sites guard on _metrics.ACTIVE) --------
_m_snapshots = _metrics.counter(
    "hvd_recovery_snapshots_total",
    "Redundancy snapshots pushed to a peer", labels=("mode",))
_m_bytes = _metrics.counter(
    "hvd_recovery_bytes_total",
    "Redundancy frame bytes moved over the RPC plane",
    labels=("direction",))
_m_lag = _metrics.histogram(
    "hvd_recovery_lag_seconds",
    "Age of a snapshot when it lands on its replica holder",
    lo=-10, hi=6)
_m_time = _metrics.histogram(
    "hvd_recovery_time_seconds",
    "Wall time to rebuild a lost worker's state from the fleet",
    lo=-10, hi=8)
_m_protected = _metrics.gauge(
    "hvd_recovery_protected_bytes",
    "Bytes currently protected by the recovery plane", labels=("kind",))
_m_rebuilds = _metrics.counter(
    "hvd_recovery_rebuilds_total",
    "Completed fleet rebuilds of a lost worker's state",
    labels=("source",))
_m_stale = _metrics.counter(
    "hvd_recovery_stale_refused_total",
    "Snapshot puts/gets refused for carrying a stale elastic epoch")
_m_requeues = _metrics.counter(
    "hvd_recovery_push_requeues_total",
    "Snapshot pushes that failed and were requeued for the next boundary")


# -- frame codec (deterministic, bit-exact) -----------------------------------

def encode_frame(payload: Dict[str, np.ndarray]) -> bytes:
    """Serialize ``{name: array}`` to one deterministic byte frame.

    Layout: 8-byte big-endian header length, JSON header (sorted names,
    dtype strings, shapes, per-array byte sizes), concatenated raw array
    bytes.  Same payload → same bytes, on any host.
    """
    names = sorted(payload)
    raw = [np.asarray(payload[n]) for n in names]
    # shapes recorded BEFORE ascontiguousarray: it promotes 0-d to 1-d
    shapes = [list(a.shape) for a in raw]
    arrs = [np.ascontiguousarray(a) for a in raw]
    header = {
        "names": names,
        "dtypes": [a.dtype.str for a in arrs],
        "shapes": shapes,
        "sizes": [a.nbytes for a in arrs],
    }
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode("utf-8")
    return (len(hdr).to_bytes(8, "big") + hdr
            + b"".join(a.tobytes() for a in arrs))


def decode_frame(frame: bytes) -> Dict[str, np.ndarray]:
    """Invert :func:`encode_frame` bit-exactly (``frombuffer`` copy)."""
    if len(frame) < 8:
        raise ValueError("recovery frame truncated (no header length)")
    hlen = int.from_bytes(frame[:8], "big")
    header = json.loads(frame[8:8 + hlen].decode("utf-8"))
    out: Dict[str, np.ndarray] = {}
    off = 8 + hlen
    for name, dt, shape, size in zip(header["names"], header["dtypes"],
                                     header["shapes"], header["sizes"]):
        chunk = frame[off:off + size]
        if len(chunk) != size:
            raise ValueError(f"recovery frame truncated at {name!r}")
        out[name] = np.frombuffer(chunk, dtype=np.dtype(dt)) \
            .reshape(shape).copy()
        off += size
    return out


def xor_bytes(a: bytes, b: bytes) -> bytes:
    """XOR two byte strings, zero-padding the shorter to the longer."""
    n = max(len(a), len(b))
    av = np.frombuffer(a.ljust(n, b"\x00"), dtype=np.uint8)
    bv = np.frombuffer(b.ljust(n, b"\x00"), dtype=np.uint8)
    return (av ^ bv).tobytes()


def parity_group(rank: int, size: int, group_size: int
                 ) -> Tuple[int, int, List[int]]:
    """``(group, holder, members)`` for XOR parity.

    Groups are contiguous rank ranges of ``group_size``; the holder is
    the rank just past the group's end (mod size), so for any
    ``size > group_size`` the holder stores parity for state it does not
    itself own.  When the holder falls inside its own group (only
    possible when one group spans the whole fleet) its frame is excluded
    from the parity set — a holder cannot protect itself.
    """
    if group_size < 2:
        raise ValueError("parity group size must be >= 2")
    g = rank // group_size
    start = g * group_size
    end = min(start + group_size, size)
    holder = end % size
    members = [r for r in range(start, end) if r != holder]
    return g, holder, members


def priced_tile_bytes(layout, dtype_bytes: int = 4,
                      state_copies: int = 1) -> int:
    """Exact per-worker redundancy frame body bytes for a
    :class:`~horovod_tpu_torch.optim.distributed.ShardedLayout` — the same
    ``buckets[i].shard_numel`` arithmetic that prices the ZeRO shards
    themselves, times the number of protected state copies (e.g. Adam
    m+v = 2, plus 1 if error-feedback residuals are on)."""
    return sum(int(b.shard_numel) for b in layout.buckets) \
        * int(dtype_bytes) * int(state_copies)


# -- worker-side versioned store ----------------------------------------------

class TileStore:
    """Thread-safe versioned store for redundancy frames.

    Three keyspaces: *own* frames (this worker's history, bounded to
    :data:`OWN_HISTORY` versions, pulled by parity rebuilds), *replica*
    frames (a neighbor's full frame, newest version wins), and *parity*
    accumulators keyed by ``(group, version)`` (XOR-accumulated member
    frames; complete once every expected member arrived).  Versions are
    ``(epoch, step)`` tuples; anything below the ``min_epoch`` watermark
    is refused and counted in ``hvd_recovery_stale_refused_total``.
    """

    def __init__(self, history: int = OWN_HISTORY):
        self._lock = threading.Lock()
        self._history = max(int(history), 1)
        self._min_epoch = 0
        self._own: "OrderedDict[Tuple[int, int], bytes]" = OrderedDict()
        # src rank -> (version, frame)
        self._replicas: Dict[int, Tuple[Tuple[int, int], bytes]] = {}
        # (group, version) -> {"blob", "arrived", "expected", "lengths"}
        self._parity: Dict[Tuple[int, Tuple[int, int]], dict] = {}

    def _stale(self, version: Tuple[int, int]) -> bool:
        with self._lock:
            min_epoch = self._min_epoch
        if version[0] < min_epoch:
            if _metrics.ACTIVE:
                _m_stale.inc()
            if _metrics.RECORDING:
                _metrics.event("recovery.stale_refused",
                               epoch=version[0], step=version[1],
                               min_epoch=min_epoch)
            return True
        return False

    def set_min_epoch(self, epoch: int):
        """Raise the staleness watermark (a re-form moved the fleet to
        ``epoch``; frames older than the previous epoch are garbage)."""
        with self._lock:
            self._min_epoch = max(self._min_epoch, int(epoch))

    def put_own(self, version: Tuple[int, int], frame: bytes):
        version = (int(version[0]), int(version[1]))
        if self._stale(version):
            return False
        with self._lock:
            self._own[version] = frame
            self._own.move_to_end(version)
            while len(self._own) > self._history:
                self._own.popitem(last=False)
        return True

    def get_own(self, version: Optional[Tuple[int, int]] = None,
                min_epoch: int = 0) -> Optional[Tuple[Tuple[int, int],
                                                      bytes]]:
        with self._lock:
            if version is not None:
                version = (int(version[0]), int(version[1]))
                frame = self._own.get(version)
                return (version, frame) if frame is not None else None
            best = None
            for v, frame in self._own.items():
                if v[0] >= min_epoch and (best is None or v > best[0]):
                    best = (v, frame)
            return best

    def put_replica(self, src: int, version: Tuple[int, int],
                    frame: bytes) -> bool:
        """Store a neighbor's frame; newest version wins.  Returns False
        (refused) for stale epochs or versions older than what is
        already held — a late duplicate must never shadow a fresher
        push."""
        version = (int(version[0]), int(version[1]))
        if self._stale(version):
            return False
        with self._lock:
            held = self._replicas.get(int(src))
            if held is not None and held[0] >= version:
                return False
            self._replicas[int(src)] = (version, frame)
        return True

    def get_replica(self, src: int, min_epoch: int = 0
                    ) -> Optional[Tuple[Tuple[int, int], bytes]]:
        with self._lock:
            held = self._replicas.get(int(src))
        if held is None or held[0][0] < int(min_epoch):
            return None
        return held

    def drop_sources(self, ranks: Sequence[int]):
        """Prune replica frames held *for* the given source ranks."""
        with self._lock:
            for r in ranks:
                self._replicas.pop(int(r), None)

    def put_parity_member(self, group: int, src: int,
                          version: Tuple[int, int], frame: bytes,
                          members: Sequence[int]) -> bool:
        """XOR-accumulate one member's frame into the group accumulator
        for ``version``.  Complete once every rank in ``members``
        arrived; duplicate arrivals are refused (XOR would cancel)."""
        version = (int(version[0]), int(version[1]))
        if self._stale(version):
            return False
        key = (int(group), version)
        with self._lock:
            acc = self._parity.get(key)
            if acc is None:
                acc = {"blob": b"", "arrived": set(),
                       "expected": {int(m) for m in members},
                       "lengths": {}}
                self._parity[key] = acc
                # keep the accumulator map bounded: drop versions older
                # than the newest OWN_HISTORY for this group
                versions = sorted(v for (g, v) in self._parity
                                  if g == int(group))
                for v in versions[:-OWN_HISTORY]:
                    self._parity.pop((int(group), v), None)
            if int(src) in acc["arrived"]:
                return False
            acc["arrived"].add(int(src))
            acc["lengths"][int(src)] = len(frame)
            acc["blob"] = xor_bytes(acc["blob"], frame)
        return True

    def get_parity(self, group: int, min_epoch: int = 0
                   ) -> Optional[dict]:
        """Newest *complete* parity accumulator for ``group`` at or
        above ``min_epoch``: ``{"version", "blob", "lengths",
        "members"}``."""
        with self._lock:
            best = None
            for (g, v), acc in self._parity.items():
                if g != int(group) or v[0] < int(min_epoch):
                    continue
                if acc["arrived"] != acc["expected"]:
                    continue
                if best is None or v > best["version"]:
                    best = {"version": v, "blob": acc["blob"],
                            "lengths": dict(acc["lengths"]),
                            "members": sorted(acc["expected"])}
            return best

    def stats(self) -> dict:
        with self._lock:
            return {
                "min_epoch": self._min_epoch,
                "own_versions": [list(v) for v in self._own],
                "replicas": {str(s): list(v[0])
                             for s, v in self._replicas.items()},
                "parity_complete": sum(
                    1 for acc in self._parity.values()
                    if acc["arrived"] == acc["expected"]),
                "held_bytes": sum(len(v[1])
                                  for v in self._replicas.values())
                + sum(len(acc["blob"])
                      for acc in self._parity.values()),
            }


# -- worker-side agent --------------------------------------------------------

class RecoveryAgent:
    """Per-worker redundancy agent: snapshots out, rebuilds in.

    ``note_boundary`` is the producer hook (wired to the optimizer's
    accumulation boundary via ``DistributedGradientTransform(...,
    recovery=agent)``); ``handle_push`` / ``handle_pull`` are the RPC
    consumer side (served from the worker notification server);
    ``rebuild`` is the re-form consumer.  ``peers`` may be a static
    ``{rank: (addr, port)}`` map (tests) — otherwise the driver's
    ``recovery_plan`` RPC is consulted and re-consulted on epoch bumps.
    """

    def __init__(self, rank: int, size: int, epoch: int = 0,
                 mode: Optional[str] = None,
                 every: Optional[int] = None,
                 parity_group_size: Optional[int] = None,
                 pull_deadline_s: Optional[float] = None,
                 driver: Optional[Tuple[str, int]] = None,
                 peers: Optional[Dict[int, Tuple[str, int]]] = None,
                 worker_id: Optional[int] = None,
                 store: Optional[TileStore] = None,
                 register: bool = True):
        if mode is None or every is None or parity_group_size is None \
                or pull_deadline_s is None:
            from ..config import Config
            cfg = Config.from_env()
            mode = cfg.recovery if mode is None else mode
            every = cfg.recovery_every if every is None else every
            parity_group_size = (cfg.recovery_parity_group
                                 if parity_group_size is None
                                 else parity_group_size)
            pull_deadline_s = (cfg.recovery_pull_deadline_s
                               if pull_deadline_s is None
                               else pull_deadline_s)
        if mode not in RECOVERY_MODES:
            raise ValueError(
                f"recovery mode must be one of {RECOVERY_MODES}, "
                f"got {mode!r}")
        self.rank = int(rank)
        self.size = int(size)
        self.epoch = int(epoch)
        self.mode = mode
        self.every = max(int(every), 1)
        self.parity_group_size = max(int(parity_group_size), 2)
        self.pull_deadline_s = float(pull_deadline_s)
        self.driver = driver
        self.worker_id = self.rank if worker_id is None else int(worker_id)
        self.store = store if store is not None else TileStore()
        self._peers: Dict[int, Tuple[str, int]] = dict(peers or {})
        self._wids: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._boundaries = 0
        # (version, frame) awaiting (re)delivery — kill-mid-push leaves
        # it here; the next boundary (or an explicit flush) retries it,
        # a newer snapshot supersedes it.
        self._pending: Optional[Tuple[Tuple[int, int], bytes]] = None
        self.last_rebuild: Optional[dict] = None
        if register:
            install(self)

    # -- peer plan ------------------------------------------------------------

    def update_plan(self, epoch: int,
                    peers: Dict[int, Tuple[str, int]],
                    wids: Optional[Dict[int, int]] = None,
                    size: Optional[int] = None):
        with self._lock:
            self._peers = {int(r): (a, int(p))
                           for r, (a, p) in peers.items()}
        # epoch/size/_wids are rebound whole (atomic reference swaps) so
        # hot-path readers (note_boundary, holder_rank, _note_driver) can
        # read them lock-free; only the _peers map is mutated under _lock.
        if wids:
            self._wids = {int(r): int(w) for r, w in wids.items()}
        if size is not None:
            self.size = int(size)
        self.epoch = int(epoch)
        self.store.set_min_epoch(self.epoch)

    def _fetch_plan(self):
        if self.driver is None:
            return
        reply = json_request(self.driver[0], self.driver[1],
                             "recovery_plan", {"worker_id": self.worker_id},
                             timeout=10.0)
        peers = {int(r): (a, int(p))
                 for r, (a, p) in (reply.get("peers") or {}).items()}
        if peers:
            # the plan's epoch is informational for min_epoch gating of
            # *future* pushes; rebuild pulls still accept the previous
            # epoch's frames (min_epoch passed explicitly per pull)
            with self._lock:
                self._peers = peers
            # whole-reference rebinds, lock-free for readers (see
            # update_plan)
            self._wids = {int(r): int(w) for r, w in
                          (reply.get("wids") or {}).items()}
            self.epoch = int(reply.get("epoch", self.epoch))
            self.size = int(reply.get("size", self.size))

    def _endpoint(self, rank: int) -> Optional[Tuple[str, int]]:
        with self._lock:
            ep = self._peers.get(int(rank))
        if ep is None and self.driver is not None:
            try:
                self._fetch_plan()
            except Exception:  # noqa: BLE001 - plan refresh best effort
                logger.debug("recovery plan fetch failed", exc_info=True)
            with self._lock:
                ep = self._peers.get(int(rank))
        return ep

    def holder_rank(self) -> int:
        """The rank holding redundancy for this worker's frames."""
        if self.mode == "parity":
            return parity_group(self.rank, self.size,
                                self.parity_group_size)[1]
        return (self.rank + 1) % self.size

    # -- producer side --------------------------------------------------------

    def note_boundary(self, step: int, payload: Dict[str, np.ndarray],
                      rank: Optional[int] = None) -> bool:
        """Record a boundary snapshot; at the configured cadence encode
        and push it to this worker's holder.  Returns True if a push was
        attempted and delivered."""
        if rank is not None and int(rank) != self.rank:
            return False
        if self.mode == "off" or self.size < 2:
            return False
        self._boundaries += 1
        # gate on the boundary ordinal itself (the in-jit tap gates the
        # same way, so a cadence-gated delivery is never re-gated here)
        if int(step) % self.every:
            return False
        version = (self.epoch, int(step))
        frame = encode_frame(payload)
        self.store.put_own(version, frame)
        if _metrics.ACTIVE:
            _m_protected.set(len(frame), kind="own")
        with self._lock:
            self._pending = (version, frame)  # newest supersedes
        return self.flush()

    def flush(self) -> bool:
        """(Re)try the pending push; keep it queued on failure."""
        with self._lock:
            pending = self._pending
        if pending is None:
            return True
        version, frame = pending
        t0 = time.monotonic()
        try:
            ok = self._push_one(version, frame)
        except Exception:  # noqa: BLE001 - redundancy must not kill steps
            logger.warning("recovery push (%d,%d) failed; requeued",
                           version[0], version[1], exc_info=True)
            ok = False
        if ok:
            with self._lock:
                if self._pending is not None \
                        and self._pending[0] == version:
                    self._pending = None
            if _metrics.ACTIVE:
                _m_snapshots.inc(mode=self.mode)
                _m_bytes.inc(len(frame), direction="push")
                _m_lag.observe(time.monotonic() - t0)
            if _metrics.RECORDING:
                _metrics.event("recovery.pushed", rank=self.rank,
                               epoch=version[0], step=version[1],
                               bytes=len(frame), mode=self.mode)
            self._note_driver("push", version, len(frame))
            return True
        if _metrics.ACTIVE:
            _m_requeues.inc()
        if _metrics.RECORDING:
            _metrics.event("recovery.push_requeued", rank=self.rank,
                           epoch=version[0], step=version[1])
        return False

    def _push_one(self, version: Tuple[int, int], frame: bytes) -> bool:
        if _chaos.ACTIVE:
            _chaos.fire("recovery.push", rank=self.rank,
                        step=version[1], epoch=version[0])
        holder = self.holder_rank()
        payload = {"src": self.rank, "epoch": version[0],
                   "step": version[1],
                   "body": base64.b64encode(frame).decode("ascii")}
        if self.mode == "parity":
            group, holder, members = parity_group(
                self.rank, self.size, self.parity_group_size)
            if self.rank not in members:
                # a holder inside its own group cannot protect itself
                return True
            payload.update({"kind": "parity", "group": group,
                            "members": members})
        ep = self._endpoint(holder)
        if ep is None:
            return False
        reply = json_request(ep[0], ep[1], "recovery_push", payload,
                             timeout=15.0, retries=1)
        if not reply.get("ok"):
            if reply.get("stale"):
                # the fleet moved on; this frame is garbage, not retryable
                return True
            return False
        return True

    def _note_driver(self, kind: str, version: Tuple[int, int],
                     nbytes: int, source: str = "",
                     seconds: float = 0.0):
        if self.driver is None:
            return
        holder = self.holder_rank()
        note = {"kind": kind, "src_worker": self.worker_id,
                "src_rank": self.rank, "holder_rank": holder,
                "holder_worker": self._wids.get(holder, holder),
                "epoch": version[0], "step": version[1],
                "bytes": int(nbytes), "mode": self.mode}
        if kind == "rebuilt":
            note.update({"source": source, "seconds": round(seconds, 6)})
        try:
            json_request(self.driver[0], self.driver[1],
                         "recovery_note", note, timeout=5.0, retries=1)
        except Exception:  # noqa: BLE001 - bookkeeping is best effort
            logger.debug("recovery note failed", exc_info=True)

    # -- consumer side (RPC handlers) -----------------------------------------

    def handle_push(self, payload: dict) -> dict:
        version = (int(payload["epoch"]), int(payload["step"]))
        frame = base64.b64decode(payload["body"])
        if payload.get("kind") == "parity":
            ok = self.store.put_parity_member(
                int(payload["group"]), int(payload["src"]), version,
                frame, payload.get("members") or ())
        else:
            ok = self.store.put_replica(int(payload["src"]), version,
                                        frame)
        if ok and _metrics.ACTIVE:
            _m_bytes.inc(len(frame), direction="recv")
            _m_protected.set(self.store.stats()["held_bytes"],
                             kind="held")
        return {"ok": bool(ok), "stale": not ok}

    def handle_pull(self, payload: dict) -> dict:
        kind = payload.get("kind", "replica")
        min_epoch = int(payload.get("min_epoch", 0))
        if kind == "replica":
            held = self.store.get_replica(int(payload["src"]), min_epoch)
            if held is None:
                return {"ok": False}
            version, frame = held
        elif kind == "own":
            version_req = payload.get("version")
            held = self.store.get_own(
                tuple(version_req) if version_req else None, min_epoch)
            if held is None:
                return {"ok": False}
            version, frame = held
        elif kind == "parity":
            acc = self.store.get_parity(int(payload["group"]), min_epoch)
            if acc is None:
                return {"ok": False}
            if _metrics.ACTIVE:
                _m_bytes.inc(len(acc["blob"]), direction="pull")
            return {"ok": True, "epoch": acc["version"][0],
                    "step": acc["version"][1],
                    "body": base64.b64encode(acc["blob"]).decode("ascii"),
                    "lengths": {str(r): n
                                for r, n in acc["lengths"].items()},
                    "members": acc["members"]}
        else:
            return {"ok": False, "error": f"unknown pull kind {kind!r}"}
        if _metrics.ACTIVE:
            _m_bytes.inc(len(frame), direction="pull")
        return {"ok": True, "epoch": version[0], "step": version[1],
                "body": base64.b64encode(frame).decode("ascii")}

    def worker_handlers(self) -> dict:
        """RPC handler dict for this agent's own notification server."""
        return {"recovery_push": self.handle_push,
                "recovery_pull": self.handle_pull}

    # -- rebuild --------------------------------------------------------------

    def rebuild(self, min_epoch: int = 0,
                prewarm: Optional[Callable[[], object]] = None
                ) -> Dict[str, np.ndarray]:
        """Reconstruct this worker's lost frame from the fleet.

        Polls peers under ``HOROVOD_RECOVERY_PULL_DEADLINE_S``; raises
        ``TimeoutError`` when no frame of epoch >= ``min_epoch`` could
        be assembled in time.  ``prewarm`` (e.g. a serving worker's
        bucket-table warmup) runs after the frame lands and before this
        method returns, so recovery never rides a request's p99.
        """
        if self.mode == "off":
            raise RuntimeError("recovery mode is off; nothing to rebuild")
        t0 = time.monotonic()
        if _chaos.ACTIVE:
            _chaos.fire("recovery.rebuild", rank=self.rank,
                        epoch=self.epoch)
        if _metrics.RECORDING:
            _metrics.event("recovery.rebuild_start", rank=self.rank,
                           epoch=self.epoch, mode=self.mode)
        deadline = t0 + self.pull_deadline_s
        last_err: Optional[str] = None
        while True:
            try:
                got = (self._pull_replica(min_epoch)
                       if self.mode == "neighbor"
                       else self._pull_parity(min_epoch))
            except Exception as exc:  # noqa: BLE001 - retried to deadline
                got, last_err = None, repr(exc)
            if got is not None:
                version, frame = got
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"recovery rebuild deadline "
                    f"({self.pull_deadline_s}s) exceeded for rank "
                    f"{self.rank} (mode={self.mode}, "
                    f"min_epoch={min_epoch}, last_err={last_err})")
            time.sleep(0.2)
        payload = decode_frame(frame)
        dt = time.monotonic() - t0
        if _metrics.ACTIVE:
            _m_time.observe(dt)
            _m_rebuilds.inc(source=self.mode)
        if _metrics.RECORDING:
            _metrics.event("recovery.rebuilt", rank=self.rank,
                           epoch=version[0], step=version[1],
                           seconds=round(dt, 6), source=self.mode)
        self._note_driver("rebuilt", version, len(frame),
                          source=self.mode, seconds=dt)
        # re-seed the local history so the next boundary versions on
        self.store.put_own(version, frame)
        self.last_rebuild = {"version": list(version),
                             "seconds": dt, "source": self.mode}
        if prewarm is not None:
            prewarm()
        return payload

    def _pull_replica(self, min_epoch: int
                      ) -> Optional[Tuple[Tuple[int, int], bytes]]:
        holder = (self.rank + 1) % self.size
        ep = self._endpoint(holder)
        if ep is None:
            return None
        reply = json_request(ep[0], ep[1], "recovery_pull",
                             {"kind": "replica", "src": self.rank,
                              "min_epoch": int(min_epoch)},
                             timeout=15.0, retries=1)
        if not reply.get("ok"):
            return None
        version = (int(reply["epoch"]), int(reply["step"]))
        return version, base64.b64decode(reply["body"])

    def _pull_parity(self, min_epoch: int
                     ) -> Optional[Tuple[Tuple[int, int], bytes]]:
        group, holder, members = parity_group(
            self.rank, self.size, self.parity_group_size)
        if self.rank not in members:
            return None  # holder-inside-group frames are unprotected
        ep = self._endpoint(holder)
        if ep is None:
            return None
        reply = json_request(ep[0], ep[1], "recovery_pull",
                             {"kind": "parity", "group": group,
                              "min_epoch": int(min_epoch)},
                             timeout=15.0, retries=1)
        if not reply.get("ok"):
            return None
        version = (int(reply["epoch"]), int(reply["step"]))
        blob = base64.b64decode(reply["body"])
        for peer in members:
            if peer == self.rank:
                continue
            pep = self._endpoint(peer)
            if pep is None:
                return None
            own = json_request(pep[0], pep[1], "recovery_pull",
                               {"kind": "own", "version": list(version),
                                "min_epoch": int(min_epoch)},
                               timeout=15.0, retries=1)
            if not own.get("ok"):
                return None
            blob = xor_bytes(blob, base64.b64decode(own["body"]))
        my_len = int(reply["lengths"].get(str(self.rank), 0))
        if my_len <= 0 or my_len > len(blob):
            return None
        return version, blob[:my_len]

    def stats(self) -> dict:
        with self._lock:
            pending = (list(self._pending[0])
                       if self._pending is not None else None)
        return {"rank": self.rank, "size": self.size,
                "epoch": self.epoch, "mode": self.mode,
                "every": self.every, "boundaries": self._boundaries,
                "pending": pending, "last_rebuild": self.last_rebuild,
                "store": self.store.stats()}


# -- process-global agent registry (one agent per real worker process) --------

_AGENTS: List[RecoveryAgent] = []


def install(agent: RecoveryAgent):
    _AGENTS.append(agent)


def uninstall(agent: Optional[RecoveryAgent] = None):
    if agent is None:
        _AGENTS.clear()
    elif agent in _AGENTS:
        _AGENTS.remove(agent)


def current_agent() -> Optional[RecoveryAgent]:
    return _AGENTS[-1] if _AGENTS else None


def push_handler(payload: dict) -> dict:
    """Module-level ``recovery_push`` handler (worker notification
    server wiring; dispatches to the process's installed agent)."""
    agent = current_agent()
    if agent is None:
        return {"ok": False, "stale": False,
                "error": "no recovery agent installed"}
    return agent.handle_push(payload)


def pull_handler(payload: dict) -> dict:
    """Module-level ``recovery_pull`` handler."""
    agent = current_agent()
    if agent is None:
        return {"ok": False, "error": "no recovery agent installed"}
    return agent.handle_pull(payload)


def deliver_boundary(step: int, rank: int,
                     payload: Dict[str, np.ndarray]):
    """Host-side sink for the optimizer's boundary tap: route the
    snapshot to every installed agent (each filters by rank, so
    multi-agent in-process tests and one-agent real workers both
    work)."""
    for agent in list(_AGENTS):
        try:
            agent.note_boundary(step, payload, rank=rank)
        except Exception:  # noqa: BLE001 - redundancy must not kill steps
            logger.warning("recovery boundary delivery failed",
                           exc_info=True)


# -- driver-side directory ----------------------------------------------------

class RecoveryDirectory:
    """Driver-side map of who holds redundancy for whom.

    Updated by workers' ``recovery_note`` RPCs; pruned on
    ``worker_gone`` / ``retain_workers`` (mirroring the serving plane's
    rotation-state prune) so churn cannot accrete ghost tile versions
    that shadow a live peer's fresher push.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # src worker id -> {"holder", "epoch", "step", "bytes", ...}
        self._tiles: Dict[int, dict] = {}
        self._rebuilds: List[dict] = []

    def note(self, payload: dict) -> dict:
        kind = payload.get("kind", "push")
        if kind == "rebuilt":
            entry = {k: payload.get(k) for k in
                     ("src_worker", "src_rank", "epoch", "step",
                      "bytes", "source", "seconds")}
            with self._lock:
                self._rebuilds.append(entry)
                del self._rebuilds[:-50]
            if _metrics.RECORDING:
                _metrics.event("recovery.worker_rebuilt", **entry)
            return {"ok": True}
        src = int(payload["src_worker"])
        with self._lock:
            self._tiles[src] = {
                "holder": int(payload.get("holder_worker",
                                          payload.get("holder_rank", -1))),
                "src_rank": int(payload.get("src_rank", src)),
                "epoch": int(payload["epoch"]),
                "step": int(payload["step"]),
                "bytes": int(payload.get("bytes", 0)),
                "mode": payload.get("mode", ""),
            }
            fleet = sum(t["bytes"] for t in self._tiles.values())
        if _metrics.ACTIVE:
            _m_protected.set(fleet, kind="fleet")
        return {"ok": True}

    def worker_gone(self, worker) -> int:
        """Prune every entry the departed worker sourced *or* held."""
        wid = int(worker)
        with self._lock:
            gone = [s for s, t in self._tiles.items()
                    if s == wid or t["holder"] == wid]
            for s in gone:
                self._tiles.pop(s, None)
            fleet = sum(t["bytes"] for t in self._tiles.values())
        if gone:
            if _metrics.ACTIVE:
                _m_protected.set(fleet, kind="fleet")
            if _metrics.RECORDING:
                _metrics.event("recovery.tiles_pruned", worker=wid,
                               pruned=len(gone), reason="worker_gone")
        return len(gone)

    def retain_workers(self, live) -> int:
        """Keep only entries whose source *and* holder are still
        assigned (re-form path)."""
        keep = {int(w) for w in live}
        with self._lock:
            gone = [s for s, t in self._tiles.items()
                    if s not in keep or t["holder"] not in keep]
            for s in gone:
                self._tiles.pop(s, None)
            fleet = sum(t["bytes"] for t in self._tiles.values())
        if gone:
            if _metrics.ACTIVE:
                _m_protected.set(fleet, kind="fleet")
            if _metrics.RECORDING:
                _metrics.event("recovery.tiles_pruned",
                               pruned=len(gone), reason="retain_workers")
        return len(gone)

    def stats(self) -> dict:
        with self._lock:
            return {
                "protected_workers": sorted(self._tiles),
                "protected_bytes": sum(t["bytes"]
                                       for t in self._tiles.values()),
                "tiles": {str(s): dict(t)
                          for s, t in self._tiles.items()},
                "rebuilds": list(self._rebuilds),
            }
