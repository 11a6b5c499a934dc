"""Cross-process coordination controller: the negotiation protocol.

Counterpart: ``horovod_tpu/ops/controller.py``, whose protocol this keeps:
every rank announces the tensors it has ready; the set that is ready on
*all* ranks of a process set is ordered deterministically and dispatched
this cycle, stragglers stay queued, and divergence (a tensor some ranks
never submit, or submit with a different signature) is *diagnosed* with
tensor names and ranks instead of hanging the job.  Once a cycle's
signature has been negotiated, identical later cycles exchange a 40-byte
digest instead of the full request list (the reference's response-cache
bit vector).

The protocol is symmetric (no rank-0 coordinator): each rank publishes its
request list under a sequence-numbered key and reads every peer's, and all
ranks evaluate the same deterministic decision function (:meth:`_decide`)
over the same data.  Rounds are lazy: a rank negotiates only when it has
pending entries or has joined.

The transport is the ``torch.distributed`` store that rank 0 hosts (the
JAX package uses the jax coordination service's key-value store).  A
round costs each member ONE ``set`` plus ``check`` polls and ONE
``multi_get`` of all its peers' keys, never a per-peer get: O(N) bytes and
O(1) store operations per rank per round.  Leave markers are read through
a counter at a bounded interval while waiting.  Round keys are deleted as
rounds age out and at shutdown, and the keys live under a prefix per
runtime incarnation, so ``init → shutdown → init`` cannot read old rounds.

Rounds are scoped per **member group** (the sorted ranks of the entry's
process set) with a round counter each, so a collective on a subset never
waits on non-members.

Under the elastic driver a SIGKILLed peer writes no leave marker; the
driver's re-form notice (``runtime.note_superseded``) names the dead
ranks, and a round stops waiting for them at once, and for any peer
``superseded_grace_s`` after the notice, raising
``HorovodInternalError``.  (The JAX package gets this bound from the
coordination service's heartbeat.)

``join()`` semantics (reference: JoinOp): a joined rank keeps answering
global-group rounds with an empty request list and a joined flag;
collectives ready on every *non-joined* rank dispatch, with joined ranks
synthesizing zero contributions.  The round in which every rank has joined
resolves ``join()`` everywhere, returning the last joiner.

A round also carries the autotuner's parameters (``params``): the lowest
active member's published point is the round's, on every member.  The
stall inspector (``stall.py``) hears which ranks a round finds missing,
and the rounds are counted in the JAX controller's metric families
(``hvd_negotiation_rounds_total{kind}``, its duration histogram, and
``hvd_kv_ops_total{op}`` for the store operations).  Under
``HOROVOD_TRACE`` each round is a ``negotiate`` span tagged with its
round id and group key (``NegotiationResult.seq``, ``.group``): the key
that lines the ranks' spans up in the merged job trace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import metrics as _metrics
from .. import tracing as _tracing
from ..exceptions import HorovodInternalError, StallError

logger = logging.getLogger("horovod_tpu_torch")

# -- metric families (the JAX controller's; sites guard on _metrics.ACTIVE)
_m_neg_rounds = _metrics.counter(
    "hvd_negotiation_rounds_total",
    "Negotiation rounds by outcome (fast = hash-only steady state)",
    labels=("kind",))
_m_neg_dur = _metrics.histogram(
    "hvd_negotiation_duration_seconds",
    "Wall time of one negotiation round", labels=("kind",), lo=-17, hi=6)
_m_kv_ops = _metrics.counter(
    "hvd_kv_ops_total", "Negotiation-transport KV operations",
    labels=("op",))


@dataclasses.dataclass
class NegotiationResult:
    """Outcome of one negotiation round (the ResponseList analog)."""
    # token -> number of instances every participant is ready to dispatch
    counts: "Counter[str]" = dataclasses.field(default_factory=Counter)
    # tensor name -> ranks that have NOT submitted it (stall diagnosis)
    missing: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    all_joined: bool = False
    last_joiner: int = -1       # rank of the last rank to join
    fast: bool = False          # hash-only round (response-cache steady state)
    # per-rank payloads published with the round (allgather row counts):
    # {rank: {key: value}}
    aux: Dict[int, dict] = dataclasses.field(default_factory=dict)
    # the tuned parameters the round agreed (the lowest active publisher's)
    params: Optional[dict] = None
    # the round's id in its member group and the group's key: the trace's
    # cross-rank correlation key (seq advances in lockstep on every member)
    seq: int = -1
    group: str = ""


def entry_token(entry) -> str:
    """Canonical wire identity of a pending entry (the Request analog).

    The JAX package's encoding, field for field: per-tensor signatures plus
    the entry's root and splits.  Allgather's dim 0 is wildcarded (ranks
    may contribute different row counts; the round's ``aux`` carries them).
    """
    def wire_shape(s):
        shape = list(s.shape)
        if s.op_type == "allgather" and shape:
            shape[0] = -1
        return shape

    sigs = [[s.name, s.op_type, s.reduce_op, s.dtype, wire_shape(s),
             s.process_set_id, bool(s.stacked),
             -1 if s.group_id == -1 else 0,
             s.prescale, s.postscale, s.wire_format, s.tail_policy,
             s.spec]
            for s in entry.sigs()]
    splits = (None if entry.splits is None
              else [int(x) for x in entry.splits])
    return json.dumps({"s": sigs, "r": int(entry.root_rank), "sp": splits},
                      separators=(",", ":"), sort_keys=True)


def token_fields(token: str) -> dict:
    return json.loads(token)


def token_names(token: str) -> List[str]:
    return [s[0] for s in json.loads(token)["s"]]


class DivergenceError(HorovodInternalError):
    """Raised on every rank when ranks submit incompatible collectives:
    one name with two signatures, or names some rank never submits."""


class Controller:
    """Per-process negotiation endpoint over a ``torch.distributed`` store.

    ``store`` holds this incarnation's keys (a ``PrefixStore``), ``rank``
    is this process's global rank and ``world`` the world size.  A round
    waits at most ``deadline_s`` for its peers, and a tensor that peers
    leave unmatched for longer than that fails as a divergence.
    """

    def __init__(self, cfg=None, store=None, rank: int = 0, world: int = 1,
                 deadline_s: float = 300.0, stall=None, core=None):
        self.store = store
        self.stall = stall
        # the native core hvd.init() loaded: its negotiate_decide does the
        # readiness arithmetic (None: the Python loop of _decide_counts)
        self._core = core
        self.rank = rank
        self.world = world
        self.deadline_s = float(deadline_s)
        # _lock guards quick mutable state only; it is never held across a
        # peer wait.  _round_lock serializes whole rounds so per-group
        # sequence numbers publish in order.
        self._lock = threading.RLock()
        self._round_lock = threading.Lock()
        self._seq: Dict[str, int] = {}
        # LRU set of fully-negotiated (group, cycle-hash) signatures
        self._hash_cache: "OrderedDict[Tuple[str, str], None]" = OrderedDict()
        cap = getattr(cfg, "cache_capacity", 1024) if cfg is not None else 1024
        self._cache_capacity = int(cap)
        self.joined = False
        self._join_seq: Optional[int] = None
        self._left = False
        self._forced_off = (cfg is not None
                            and not getattr(cfg, "controller_enabled", True))
        self._warn_s = (cfg.stall_check_time
                        if cfg is not None and not cfg.stall_check_disable
                        else 60.0)
        self._poll_max_s = 0.002
        self._left_check_grace_s = 0.5
        self._left_check_s = 2.0
        # elastic: ranks the driver reported dead, and when this
        # incarnation's epoch was superseded (runtime.note_superseded)
        self._lost: frozenset = frozenset()
        self._superseded_at: Optional[float] = None
        self.superseded_grace_s = 10.0
        self.rounds = 0
        self.fast_rounds = 0
        self.full_rounds = 0
        self.tokens_deferred = 0
        self.cache_evictions = 0
        # store op counters (pin the O(1)-operations-per-round bound)
        self.kv_sets = 0
        self.kv_checks = 0
        self.kv_multi_gets = 0
        self.kv_left_checks = 0
        self.kv_deletes = 0

    # -- lifecycle -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return not (self._forced_off or self._left) and self.world > 1

    def _key(self, group: str, rest: str) -> str:
        return f"{group}/{rest}"

    def leave(self):
        """Announce departure so peers mid-negotiation fail fast instead of
        waiting out the deadline."""
        if self._left:
            return
        self._left = True
        if self.world <= 1:
            return
        try:
            self.store.set(f"left/{self.rank}", "1")
            self.store.add("left_n", 1)
            with self._lock:
                self.kv_sets += 2
        except (RuntimeError, ValueError):   # the store may be gone
            logger.debug("could not publish leave marker", exc_info=True)

    def mark_superseded(self, lost=()):
        """The elastic driver re-formed the job past this incarnation's
        epoch; ``lost`` are ranks whose processes died."""
        with self._lock:
            self._lost = self._lost | frozenset(int(r) for r in lost)
            if self._superseded_at is None:
                self._superseded_at = time.monotonic()

    @property
    def lost(self) -> frozenset:
        with self._lock:
            return self._lost

    def set_joined(self, joined: bool):
        with self._lock:
            self.joined = joined
            if not joined:
                self._join_seq = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "rounds": self.rounds,
                "fast_rounds": self.fast_rounds,
                "full_rounds": self.full_rounds,
                "tokens_deferred": self.tokens_deferred,
                "cached_cycles": len(self._hash_cache),
                "cache_capacity": self._cache_capacity,
                "cache_evictions": self.cache_evictions,
                "kv_sets": self.kv_sets,
                "kv_checks": self.kv_checks,
                "kv_multi_gets": self.kv_multi_gets,
                "kv_left_checks": self.kv_left_checks,
                "kv_deletes": self.kv_deletes,
            }

    # -- steady-state cache (LRU set; caller must hold self._lock) -----------
    def _cache_touch(self, gk: str, h: str) -> bool:
        key = (gk, h)
        if key in self._hash_cache:
            self._hash_cache.move_to_end(key)
            return True
        return False

    def _cache_put(self, gk: str, h: str):
        if self._cache_capacity <= 0:
            return
        self._hash_cache[(gk, h)] = None
        self._hash_cache.move_to_end((gk, h))
        while len(self._hash_cache) > self._cache_capacity:
            self._hash_cache.popitem(last=False)
            self.cache_evictions += 1

    # -- the round -----------------------------------------------------------
    def negotiate(self, tokens: List[str], procs: Tuple[int, ...],
                  aux: Optional[dict] = None, stalled: bool = False,
                  params: Optional[dict] = None) -> NegotiationResult:
        """Run one negotiation round over ``tokens`` with the member ranks
        ``procs`` (sorted).  Blocks until every member has published the
        same round (at most ``deadline_s``) and returns the deterministic
        dispatch decision, identical on every member.

        ``aux`` is a small per-rank payload returned per rank in
        ``NegotiationResult.aux`` (allgather row counts).  ``stalled`` says
        that some entry here has waited past the deadline for its peers:
        if the round still finds tensors missing, every member raises
        :class:`DivergenceError` in this same round.  ``params`` is this
        rank's view of the tuned parameters; the round returns the lowest
        active publisher's as ``NegotiationResult.params``.
        """
        if not _metrics.ACTIVE and not _tracing.ACTIVE:
            return self._negotiate(tokens, procs, aux, stalled, params)
        t0 = time.monotonic()
        span_t0 = _tracing.now() if _tracing.ACTIVE else 0.0
        kind = "error"
        res = None
        try:
            res = self._negotiate(tokens, procs, aux, stalled, params)
            kind = ("joined" if res.all_joined
                    else "fast" if res.fast else "full")
            return res
        finally:
            if _metrics.ACTIVE:
                _m_neg_rounds.inc(kind=kind)
                _m_neg_dur.observe(time.monotonic() - t0, kind=kind)
            if _tracing.ACTIVE:
                # the round id is the cross-rank correlation key: seq
                # advances in lockstep on every member of the group, so the
                # driver's merge lines this span up with the peers' without
                # a shared clock
                seq = res.seq if res is not None else -1
                _tracing.span(
                    "negotiate", f"round{seq}", span_t0, _tracing.now(),
                    round=seq, kind=kind,
                    group=res.group if res is not None else "",
                    tokens=len(tokens))

    def _negotiate(self, tokens, procs, aux, stalled, params
                   ) -> NegotiationResult:
        gk = "g" + hashlib.sha1(
            ",".join(map(str, procs)).encode()).hexdigest()[:12]
        res = self._negotiate_round(gk, tokens, procs, aux, stalled, params)
        res.group = gk
        return res

    def _negotiate_round(self, gk, tokens, procs, aux, stalled, params
                         ) -> NegotiationResult:
        me = self.rank
        if me not in procs:
            raise HorovodInternalError(
                f"rank {me} negotiating for a group it is not a member of: "
                f"{procs}")
        my_sorted = sorted(tokens)
        h = hashlib.sha1("\n".join(my_sorted).encode()).hexdigest()

        with self._round_lock:
            with self._lock:
                seq = self._seq.get(gk, 0)
                self._seq[gk] = seq + 1
                if self.joined and self._join_seq is None:
                    self._join_seq = seq
                joined = self.joined
                join_seq = self._join_seq
                cached = self._cache_touch(gk, h)

            val: dict = {"h": h}
            if joined:
                val["j"] = True
                val["js"] = join_seq
            if aux:
                val["x"] = aux
            if params is not None:
                val["p"] = params
            if stalled:
                val["d"] = True
            if not cached or joined:
                val["e"] = my_sorted
            self._set(self._key(gk, f"{seq}/a/{me}"), val)
            # age out this rank's keys of round seq-4 while peers publish
            self._cleanup(gk, seq - 4, me)

            vals: Dict[int, dict] = {me: val}
            for q, raw in self._gather_round(
                    gk, seq, "a", [q for q in procs if q != me],
                    tokens).items():
                vals[q] = json.loads(raw)

            joined_ps = sorted(q for q in vals if vals[q].get("j"))
            active = [q for q in procs if q not in joined_ps]
            aux_by_proc = {q: vals[q]["x"] for q in vals if "x" in vals[q]}
            agreed = next((vals[q]["p"] for q in active if "p" in vals[q]),
                          None)
            with self._lock:
                self.rounds += 1

            if not active:
                # every rank has joined: resolve join() everywhere
                last = max((vals[q].get("js", 0), q) for q in joined_ps)[1]
                return NegotiationResult(all_joined=True, last_joiner=last,
                                         seq=seq)

            hashes = {vals[q]["h"] for q in active}
            if len(hashes) == 1 and not joined_ps:
                # steady state: identical cycles on every member
                fast = all("e" not in vals[q] for q in active)
                with self._lock:
                    self._cache_put(gk, h)
                    if fast:
                        self.fast_rounds += 1
                    else:
                        self.full_rounds += 1
                return NegotiationResult(counts=Counter(tokens), fast=fast,
                                         aux=aux_by_proc, params=agreed,
                                         seq=seq)

            # mismatch (or join in progress): full request lists needed
            with self._lock:
                self.full_rounds += 1
            if "e" not in val:
                self._set(self._key(gk, f"{seq}/b/{me}"), my_sorted)
            full: Dict[int, List[str]] = {}
            need_b = []
            for q in procs:
                if "e" in vals[q]:
                    full[q] = vals[q]["e"]
                elif q == me:
                    full[q] = my_sorted
                else:
                    need_b.append(q)
            for q, raw in self._gather_round(gk, seq, "b", need_b,
                                             tokens).items():
                full[q] = json.loads(raw)

            result = self._decide(gk, full, active, joined_ps, vals, me)
            result.aux = aux_by_proc
            result.params = agreed
            result.seq = seq
            return result

    # -- decision function (identical on every member) -----------------------
    def _decide(self, gk: str, full: Dict[int, List[str]],
                active: List[int], joined_ps: List[int],
                vals: Dict[int, dict], me: int) -> NegotiationResult:
        counters = {q: Counter(full[q]) for q in full}
        all_tokens = sorted(set().union(*[set(c) for c in counters.values()]))

        # the same tensor name submitted with incompatible signatures by
        # disjoint sets of ranks is a hard error; a rank holding several
        # versions of a name itself is aliasing (call-site auto names),
        # which the intersection/requeue path handles
        by_name: Dict[Tuple[str, int], Dict[str, set]] = {}
        for q in active:
            for t in counters[q]:
                for s in token_fields(t)["s"]:
                    by_name.setdefault((s[0], s[5]), {}).setdefault(
                        t, set()).add(q)
        for (name, ps_id), versions in by_name.items():
            if len(versions) < 2:
                continue
            holders = Counter()
            for qs in versions.values():
                holders.update(qs)
            if any(c > 1 for c in holders.values()):
                continue
            desc = "; ".join(
                f"processes {sorted(qs)} submitted "
                f"{json.dumps([s for s in token_fields(t)['s'] if s[0] == name])}"
                for t, qs in sorted(versions.items()))
            raise DivergenceError(
                f"tensor '{name}' was submitted with mismatched "
                f"signatures across processes: {desc}. All processes "
                f"must request collectives with identical "
                f"name/dtype/shape/op.")

        counts, missing, deferred = self._decide_counts(
            full, active, counters, all_tokens)
        with self._lock:
            self.tokens_deferred += deferred
        if self.stall is not None:
            for name, lagging in missing.items():
                self.stall.record_missing(name, lagging)

        stalled = sorted(q for q in active if vals.get(q, {}).get("d"))
        if missing and stalled:
            desc = "; ".join(f"'{name}' is missing on ranks {lag}"
                             for name, lag in sorted(missing.items()))
            raise DivergenceError(
                f"ranks {stalled} waited more than {self.deadline_s:.0f} s "
                f"(HOROVOD_STALL_SHUTDOWN_TIME_SECONDS) for their peers to "
                f"submit the same collectives: {desc}")

        if not missing and not joined_ps:
            my_sorted = sorted(full[me])
            h = hashlib.sha1("\n".join(my_sorted).encode()).hexdigest()
            with self._lock:
                self._cache_put(gk, h)

        last = -1
        if joined_ps:
            last = max((vals[q].get("js", 0), q) for q in joined_ps)[1]
        return NegotiationResult(counts=counts, missing=missing,
                                 last_joiner=last)

    def _decide_counts(self, full, active, counters, all_tokens):
        """Token dispatch counts (min over active members), per-name
        lagging ranks, and the deferred total: the native core's
        ``negotiate_decide`` when loaded (reference: controller.cc
        ComputeResponseList), else the same arithmetic in Python."""
        if self._core is not None:
            counts_d, lagging, deferred = self._core.negotiate_decide(
                full, list(active))
            missing: Dict[str, List[int]] = {}
            for t, procs in lagging.items():
                for name in token_names(t):
                    missing[name] = procs
            return Counter(counts_d), missing, deferred
        counts = Counter()
        missing = {}
        deferred = 0
        for t in all_tokens:
            k = min(counters[q][t] for q in active)
            if k > 0:
                counts[t] = k
            peak = max(counters[q][t] for q in active)
            lagging = [q for q in active if counters[q][t] < peak]
            if lagging:
                for name in token_names(t):
                    missing[name] = lagging
            deferred += max(counters[q][t] for q in counters) - k
        return counts, missing, deferred

    # -- transport -----------------------------------------------------------
    def _set(self, key: str, value) -> None:
        self.store.set(key, json.dumps(value, separators=(",", ":")))
        with self._lock:
            self.kv_sets += 1
        if _metrics.ACTIVE:
            _m_kv_ops.inc(op="set")

    def _check_left(self, seq: int, waiting_for: List[int]) -> None:
        """Raise if a rank we wait on has left: one counter read, and a
        marker check only when some rank has left."""
        with self._lock:
            self.kv_left_checks += 1
        if _metrics.ACTIVE:
            _m_kv_ops.inc(op="left_check")
        if self.store.add("left_n", 0) == 0:
            return
        for p in waiting_for:
            if self.store.check([f"left/{p}"]):
                raise HorovodInternalError(
                    f"rank {p} left the job while negotiation round {seq} "
                    f"was waiting for {waiting_for} (peer shutdown or "
                    f"failure)")

    def _check_superseded(self, seq: int, waiting_for: List[int]) -> None:
        """Raise if a rank we wait on died, or if we have waited
        ``superseded_grace_s`` since the driver re-formed the job."""
        with self._lock:
            lost = sorted(self._lost & set(waiting_for))
            since = self._superseded_at
        if lost:
            raise HorovodInternalError(
                f"rank {lost} died while negotiation round {seq} was "
                f"waiting for {waiting_for} (the elastic driver re-formed "
                f"the job)")
        if time.monotonic() - since > self.superseded_grace_s:
            raise HorovodInternalError(
                f"negotiation round {seq} still waits for {waiting_for} "
                f"{self.superseded_grace_s:.0f} s after the elastic driver "
                f"re-formed the job")

    def _gather_round(self, gk: str, seq: int, phase: str, need: List[int],
                      pending_tokens: List[str]) -> Dict[int, str]:
        """The round keys of the ``need`` members: ``check`` polls (one
        store operation each, backing off to 2 ms) until all exist, then
        one ``multi_get``.  Raises :class:`StallError` after the deadline,
        naming the ranks and this rank's pending tensors."""
        if not need:
            return {}
        keys = [self._key(gk, f"{seq}/{phase}/{q}") for q in need]
        t0 = time.monotonic()
        delay = 5e-5
        next_left_check = self._left_check_grace_s
        warned = False
        while True:
            with self._lock:
                self.kv_checks += 1
                # read with its writer's lock (runtime.note_superseded runs
                # on the elastic worker's notification thread)
                superseded = self._superseded_at is not None
            if _metrics.ACTIVE:
                _m_kv_ops.inc(op="check")
            if self.store.check(keys):
                raw = self.store.multi_get(keys)
                with self._lock:
                    self.kv_multi_gets += 1
                if _metrics.ACTIVE:
                    _m_kv_ops.inc(op="multi_get")
                return {q: v.decode() for q, v in zip(need, raw)}
            if superseded:
                self._check_superseded(seq, [q for q, k in zip(need, keys)
                                             if not self.store.check([k])])
            waited = time.monotonic() - t0
            if waited >= next_left_check:
                # a rank that left has published all it ever will: only
                # the ranks whose key is still missing can strand us
                self._check_left(seq, [q for q, k in zip(need, keys)
                                       if not self.store.check([k])])
                next_left_check = waited + self._left_check_s
            names = None
            if not warned and waited > self._warn_s:
                warned = True
                names = sorted({n for t in pending_tokens
                                for n in token_names(t)})
                # the ranks whose key is still missing, not every peer
                late = [q for q, k in zip(need, keys)
                        if not self.store.check([k])]
                if self.stall is not None:
                    for n in names:
                        self.stall.record_missing(n, late)
                logger.warning(
                    "Negotiation round %d has waited %.0fs for ranks %s to "
                    "announce their ready tensors. Pending here: %s.", seq,
                    waited, late, names)
            if waited > self.deadline_s:
                names = sorted({n for t in pending_tokens
                                for n in token_names(t)})
                if _metrics.RECORDING:
                    _metrics.event("stall.abort", where="negotiation",
                                   seq=seq, waiting_for=need, tensors=names)
                raise StallError(
                    f"negotiation round {seq} waited {waited:.0f}s for "
                    f"ranks {need} (> HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="
                    f"{self.deadline_s:.0f}); pending tensors here: "
                    f"{names}; aborting")
            time.sleep(delay)
            delay = min(delay * 2, self._poll_max_s)

    def _cleanup(self, gk: str, seq: int, me: int):
        """Delete this rank's keys of round ``seq`` of group ``gk``."""
        if seq < 0:
            return
        for phase in ("a", "b"):
            self.store.delete_key(self._key(gk, f"{seq}/{phase}/{me}"))
            with self._lock:
                self.kv_deletes += 1
            if _metrics.ACTIVE:
                _m_kv_ops.inc(op="delete")

    def cleanup_keys(self):
        """At shutdown, before the ranks meet: delete the round keys this
        rank still owns except each group's last round, which a peer may
        still be reading (it can finish that round after this rank has).
        :meth:`release` deletes the rest once every rank has arrived."""
        try:
            self._delete_rounds(keep_last=True)
        except (RuntimeError, ValueError):   # a peer's store may be gone
            logger.debug("namespace cleanup skipped", exc_info=True)

    def release(self):
        """After every rank has reached shutdown: delete the last round's
        keys and, once all have left, the leave markers.  Then drop the
        store: rank 0's server must close with the runtime, even while an
        exception's traceback still holds this controller, or a re-init
        cannot listen again."""
        try:
            if self.world > 1:
                self._delete_rounds(keep_last=False)
                if self.store.add("left_n", 0) >= self.world:
                    for p in range(self.world):
                        self.store.delete_key(f"left/{p}")
                    self.store.delete_key("left_n")
        except (RuntimeError, ValueError):   # a peer's store may be gone
            logger.debug("namespace cleanup skipped", exc_info=True)
        finally:
            self.store = None

    def _delete_rounds(self, keep_last: bool):
        if self.world <= 1 or self.store is None:
            return
        with self._lock:
            seqs = dict(self._seq)
        for gk, next_seq in seqs.items():
            last = next_seq - 1 if keep_last else next_seq
            for s in range(max(0, next_seq - 4), last):
                self._cleanup(gk, s, self.rank)
