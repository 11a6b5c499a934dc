"""Health evaluator: edge-triggered verdicts over the numerics taps.

Counterpart: ``horovod_tpu/health/evaluate.py``, copied: the same
verdicts, baselines, edge gates and metric families.  The taps
(``health/taps.py``, the engine's dispatch hook, and the divergence
sentinel) deliver raw observations — per-bucket gradient norms,
nonfinite counts, error-feedback residual norms, staleness counters,
loss values, and cross-replica checksum rows.  This module turns them
into **verdicts**: edge-triggered findings with ``(worker, bucket,
step)`` attribution that feed the metric families, the flight
recorder, and the ``on_unhealthy`` hook — the difference between "the
loss curve went bad an hour ago" and "rank 2's bucket 1 went NaN at
step 1841".

Verdict catalog:

* ``nonfinite``            — a bucket's local gradient buffer carries
  NaN/Inf lanes (pre-reduction, so the *contributing* worker is named
  before the sum smears the NaN across every replica).
* ``grad_explosion``       — a bucket's l2 norm exceeds
  ``HOROVOD_HEALTH_GRAD_FACTOR`` × its own EWMA baseline (after a
  warmup of ``_WARMUP`` observations).
* ``loss_spike``           — a reported loss exceeds
  ``HOROVOD_HEALTH_LOSS_FACTOR`` × the loss EWMA.
* ``residual_drift``       — the quantized wire's error-feedback
  residual norm exceeds ``HOROVOD_HEALTH_RESIDUAL_FACTOR`` × the
  bucket's gradient-norm EWMA.
* ``replica_desync``       — the divergence sentinel's allgathered
  per-bucket checksums (float sum + bit-pattern xor) disagree across
  the replicas; the verdict names the minority replica(s) and bucket.
* ``staleness_saturated``  — under ``tail_policy=stale``, a
  cross-group's substitution counter sits at
  ``HOROVOD_TAIL_MAX_STALENESS``.
* ``slo_breach``           — an SLO rule of ``metrics/slo.py`` crossed
  into breach.

Edge triggering: each (kind, worker, bucket) fires ONCE when its
condition becomes true and re-arms when the condition clears (norm
ratios re-arm below half the bar) — a 10k-step NaN run produces one
verdict, not 10k.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch")

# -- metric families (docs/metrics.md; sites guard on _metrics.ACTIVE) --------
_m_verdicts = _metrics.counter(
    "hvd_health_verdicts_total",
    "Edge-triggered training-health verdicts, by kind "
    "(docs/observability.md 'Training health')", labels=("kind",))
_m_nonfinite = _metrics.counter(
    "hvd_health_nonfinite_total",
    "Nonfinite gradient lanes observed by the numerics taps, by fusion "
    "bucket and contributing worker", labels=("bucket", "worker"))
_m_grad_norm = _metrics.gauge(
    "hvd_health_grad_norm",
    "Last observed per-bucket local gradient l2 norm (numerics taps), "
    "by contributing worker — without the worker label a stacked/"
    "multi-replica delivery would be last-writer-wins and the series "
    "would show an arbitrary peer's norm", labels=("bucket", "worker"))
# the per-bucket families hold a series a (bucket, worker) of the plan: one
# rank's 66 buckets of the 1B Llama pass the registry's default bound of
# 64, which would fold two of them into the overflow series
for _fam in (_m_nonfinite, _m_grad_norm):
    _fam.max_series = 4096
_m_checksums = _metrics.counter(
    "hvd_health_checksum_rounds_total",
    "Divergence-sentinel checksum comparisons, by outcome",
    labels=("outcome",))

#: EWMA weight of one norm/loss observation (matches stall.EWMA_ALPHA's
#: regime: a few observations to adapt, one spike decays away).
EWMA_ALPHA = 0.2

#: Observations a baseline needs before explosion/spike verdicts can
#: fire (a cold EWMA compares garbage against garbage).
_WARMUP = 5

#: Verdict ring bound: a long unhealthy run keeps the newest evidence.
_MAX_VERDICTS = 256


class Verdict(dict):
    """One health finding.  A dict subclass so snapshots/JSON need no
    conversion; keys: kind, worker, bucket, step, detail, wall (plus
    kind-specific extras, e.g. ``group`` on staleness verdicts).
    ``worker=-1`` means "no single rank is implicated" (e.g. a
    cross-GROUP staleness saturation)."""

    def __init__(self, kind: str, worker: int, bucket: Optional[int],
                 step: int, detail: str, **extra):
        super().__init__(kind=str(kind), worker=int(worker),
                         bucket=(None if bucket is None else int(bucket)),
                         step=int(step), detail=str(detail),
                         wall=round(time.time(), 3), **extra)


class HealthEvaluator:
    """Ingests tap observations, maintains EWMA baselines, and emits
    edge-triggered verdicts.  Thread-safe: the engine thread, the
    transform's taps, and RPC snapshot reads all converge here."""

    def __init__(self, grad_factor: float = 10.0,
                 loss_factor: float = 4.0,
                 residual_factor: float = 4.0,
                 on_unhealthy: Optional[Callable] = None):
        self.grad_factor = float(grad_factor)
        self.loss_factor = float(loss_factor)
        self.residual_factor = float(residual_factor)
        self.on_unhealthy = on_unhealthy
        self._lock = threading.Lock()
        self.process = 0
        self.host = ""
        self._verdicts: List[Verdict] = []
        self._counts: Dict[str, int] = {}
        # (kind, worker, bucket, ...) currently-firing conditions (edge
        # gate; keys carry the bucket NAME past the attribution fields)
        self._active: Dict[Tuple, Verdict] = {}
        # per-(worker, bucket NAME) gradient-norm EWMA + observation
        # count.  NAME, not index: the eager engine's plan index is
        # per-cycle (bucket 0 is a different tensor every drain), and
        # two health-enabled transforms in one process collide on
        # indices — an index-keyed baseline would blend unrelated
        # tensors' norms and fire spurious explosions
        self._grad_ewma: Dict[Tuple[int, str], Tuple[float, int]] = {}
        self._bucket_names: Dict[int, str] = {}
        self._loss_ewma: Optional[float] = None
        self._loss_obs = 0
        self._last_step = -1
        self._stats_ingested = 0
        self._checksum_rounds = 0
        # sentinel dedup: every rank that delivers the same gathered
        # checksum matrix compares it once, keyed by CONTENT (see
        # ingest_checksums).  A dict-as-ordered-
        # set: eviction must drop the OLDEST keys (set iteration order
        # is hash-arbitrary and could evict the in-flight round,
        # letting sibling devices recount it)
        self._checksum_seen: Dict = {}

    # -- ingestion -----------------------------------------------------------

    def ingest_bucket(self, step: int, worker: int, bucket: int,
                      name: str, l2: float, max_abs: float,
                      nonfinite: int):
        """One numerics-tap observation of a bucket's LOCAL (this
        worker's pre-reduction) flat gradient buffer."""
        step, worker, bucket = int(step), int(worker), int(bucket)
        name = str(name)
        l2, nonfinite = float(l2), int(nonfinite)
        fired: List[Verdict] = []
        with self._lock:
            self._stats_ingested += 1
            self._last_step = max(self._last_step, step)
            self._bucket_names.setdefault(bucket, name)
            # edge keys carry the NAME only — the eager engine's plan
            # index maps to a different tensor every cycle, so a key
            # embedding the index could never be cleared by the same
            # tensor arriving under another index (stuck verdict); the
            # index stays verdict ATTRIBUTION, via _fire_locked's
            # bucket argument
            key_nf = ("nonfinite", worker, name)
            if nonfinite > 0:
                v = self._fire_locked(key_nf, step,
                                      f"{nonfinite} nonfinite lane(s) in "
                                      f"bucket {bucket} ({name}), "
                                      f"max_abs={max_abs}",
                                      bucket=bucket)
                if v is not None:
                    fired.append(v)
            else:
                self._active.pop(key_nf, None)
            ewma, n_obs = self._grad_ewma.get((worker, name), (0.0, 0))
            key_ex = ("grad_explosion", worker, name)
            if nonfinite == 0:
                if (n_obs >= _WARMUP and ewma > 0.0
                        and l2 > self.grad_factor * ewma):
                    v = self._fire_locked(
                        key_ex, step,
                        f"bucket {bucket} ({name}) l2={l2:.4g} vs "
                        f"EWMA baseline {ewma:.4g} "
                        f"(> {self.grad_factor:g}x)", bucket=bucket)
                    if v is not None:
                        fired.append(v)
                elif (key_ex in self._active
                      and ewma > 0.0
                      and l2 < self.grad_factor * ewma / 2.0):
                    self._active.pop(key_ex, None)   # re-arm after decay
                # nonfinite observations never feed the baseline (the
                # EWMA would become NaN and disarm every later check)
                self._grad_ewma[(worker, name)] = (
                    ewma + EWMA_ALPHA * (l2 - ewma), n_obs + 1)
        if _metrics.ACTIVE:
            # labeled by bucket NAME: the eager plan index maps to a
            # different tensor every cycle, which would make an
            # index-labeled series swing between unrelated tensors
            _m_grad_norm.set(l2, bucket=name, worker=str(worker))
            if nonfinite > 0:
                _m_nonfinite.inc(nonfinite, bucket=name,
                                 worker=str(worker))
        self._publish(fired)

    def ingest_residual(self, step: int, worker: int, bucket: int,
                        norm: float, name: Optional[str] = None):
        """Error-feedback residual norm of a quantized bucket (the
        carried quantization error; bounded in a healthy run)."""
        step, worker, bucket = int(step), int(worker), int(bucket)
        norm = float(norm)
        fired: List[Verdict] = []
        with self._lock:
            name = (str(name) if name is not None
                    else self._bucket_names.get(bucket, str(bucket)))
            ewma, n_obs = self._grad_ewma.get((worker, name), (0.0, 0))
            key = ("residual_drift", worker, name)
            if norm != norm:
                # a NaN residual is the terminal drift state (the raw
                # gradients may still be finite, so no nonfinite
                # verdict covers it) — `NaN > bar` is False, so an
                # explicit arm is required or the one residual that
                # most needs a verdict produces none
                v = self._fire_locked(
                    key, step,
                    f"bucket {bucket} error-feedback residual norm is "
                    f"NaN: the quantized wire's carried error is "
                    f"destroyed and feedback can no longer converge",
                    bucket=bucket)
                if v is not None:
                    fired.append(v)
            elif (n_obs >= _WARMUP and ewma > 0.0
                    and norm > self.residual_factor * ewma):
                v = self._fire_locked(
                    key, step,
                    f"bucket {bucket} error-feedback residual norm "
                    f"{norm:.4g} vs gradient EWMA {ewma:.4g} "
                    f"(> {self.residual_factor:g}x): the quantized wire "
                    f"is accumulating error faster than feedback "
                    f"re-injects it", bucket=bucket)
                if v is not None:
                    fired.append(v)
            elif (key in self._active and ewma > 0.0
                  and norm < self.residual_factor * ewma / 2.0):
                self._active.pop(key, None)
        self._publish(fired)

    def ingest_staleness(self, step: int, name: str, counters,
                         cap: int, bucket: Optional[int] = None):
        """Per-cross-group substitution counters of a ``stale`` tail
        bucket; a counter AT the cap means the tolerance budget for
        that group is spent (every further round waits the host out).

        The edge key includes the bucket NAME: two stale buckets must
        not fire/clear each other's state (one would flood a verdict
        per round).  No single worker rank is implicated — the verdict
        carries ``worker=-1`` with the cross-group in ``group``."""
        fired: List[Verdict] = []
        cap = int(cap)
        with self._lock:
            # groups beyond this delivery (the cross-group count shrank
            # at an elastic re-form) must not stay active forever
            for k in [k for k in self._active
                      if k[0] == "staleness_saturated"
                      and len(k) == 5 and k[3] == str(name)
                      and k[4] >= len(counters)]:
                self._active.pop(k, None)
            for g, c in enumerate(counters):
                key = ("staleness_saturated", -1, bucket, str(name),
                       int(g))
                if cap > 0 and int(c) >= cap:
                    v = self._fire_locked(
                        key, int(step),
                        f"cross-group {g} substituted from stale state "
                        f"{int(c)} consecutive round(s) (cap {cap}) in "
                        f"{name}: the round now blocks on the host",
                        group=int(g))
                    if v is not None:
                        fired.append(v)
                else:
                    self._active.pop(key, None)
        self._publish(fired)

    def ingest_checksums(self, step: int, replica: int, names, sums,
                         xors):
        """One divergence-sentinel round: ``sums``/``xors`` are
        ``[axis_size, n_buckets]`` matrices (every replica's per-bucket
        param/opt-state checksum, allgathered).  Rows must agree; a
        disagreeing bucket column convicts the minority replica(s)."""
        step = int(step)
        fired: List[Verdict] = []
        mismatch = False
        with self._lock:
            # a delivery of the same gathered matrix twice compares
            # each round ONCE.  The dedup key is the
            # round's CONTENT (step + bucket names + xor matrix), not
            # the bare step: an elastic re-init restarts the step
            # counter (while this evaluator deliberately survives),
            # and two health-enabled transforms in one process share
            # the evaluator — a bare-step key would silently drop
            # their rounds forever
            key = (step, tuple(names),
                   tuple(tuple(int(x) for x in row) for row in xors))
            if key in self._checksum_seen:
                return
            self._checksum_seen[key] = None
            while len(self._checksum_seen) > 1024:   # drop oldest
                del self._checksum_seen[next(iter(self._checksum_seen))]
            self._checksum_rounds += 1
            self._last_step = max(self._last_step, step)
            n = len(xors)
            for b in range(len(xors[0]) if n else 0):
                # the xor is the EXACT fingerprint and the comparison
                # key (a float-sum compare would call identical NaN
                # buffers diverged: NaN != NaN); the sums only ride the
                # detail as the magnitude hint
                col = [int(xors[r][b]) for r in range(n)]
                name = (names[b] if b < len(names)
                        else self._bucket_names.get(b, str(b)))

                def _desync_keys(match):
                    # keys carry the bucket NAME (stable across eager
                    # cycles and transforms, unlike the plan index)
                    return [k for k in self._active
                            if k[0] == "replica_desync"
                            and len(k) > 2 and k[2] == name
                            and match(k)]

                if len(set(col)) <= 1:
                    # clear EVERY desync key for this bucket, not just
                    # r < n: after an elastic downsize a convicted
                    # replica index beyond the new axis size would
                    # otherwise stay active forever (stuck verdict)
                    for k in _desync_keys(lambda k: True):
                        self._active.pop(k, None)
                    continue
                mismatch = True
                counts: Dict = {}
                for v in col:
                    counts[v] = counts.get(v, 0) + 1
                top = max(counts.values())
                tied = [v for v, c in counts.items() if c == top]
                if len(tied) > 1:
                    # even split (e.g. a rack fault diverging exactly
                    # half the replicas): there IS no majority to
                    # trust, and tie-breaking by insertion order would
                    # deterministically convict whichever half sorts
                    # first — report the split itself, no single
                    # culprit (worker=-1)
                    for k in _desync_keys(lambda k: k[1] != -1):
                        self._active.pop(k, None)   # superseded
                    groups = {v: [r for r in range(n) if col[r] == v]
                              for v in tied}
                    v = self._fire_locked(
                        ("replica_desync", -1, name), step,
                        f"bucket {b} ({name}) checksums split with no "
                        f"majority: " + "; ".join(
                            f"replicas {rs} xor {v:#010x}"
                            for v, rs in sorted(groups.items())),
                        bucket=b)
                    if v is not None:
                        fired.append(v)
                    continue
                # convict the minority: the replica(s) whose checksum
                # differs from the most common row value.  Keys for
                # replicas NOT currently convicted clear (a previously
                # convicted replica that re-agrees — or one removed by
                # a resize — must not hold the verdict)
                majority = max(counts, key=counts.get)
                maj_row = next(r for r in range(n) if col[r] == majority)
                odd = [r for r in range(n) if col[r] != majority]
                for k in _desync_keys(lambda k: k[1] not in odd):
                    self._active.pop(k, None)
                for r in odd:
                    v = self._fire_locked(
                        ("replica_desync", r, name), step,
                        f"replica {r} checksum of bucket {b} ({name}) "
                        f"diverges from the majority "
                        f"(xor {col[r]:#010x} vs {majority:#010x}, "
                        f"sum {float(sums[r][b]):.6g} vs "
                        f"{float(sums[maj_row][b]):.6g})", bucket=b)
                    if v is not None:
                        fired.append(v)
        if _metrics.ACTIVE:
            _m_checksums.inc(outcome="mismatch" if mismatch else "agree")
        self._publish(fired)

    def note_loss(self, value, step: Optional[int] = None):
        """Feed one training-loss observation (the user loop's hook:
        ``horovod_tpu.health.note_loss``)."""
        value = float(value)
        fired: List[Verdict] = []
        with self._lock:
            step = self._last_step if step is None else int(step)
            key = ("loss_spike", self.process, None)
            key_nf = ("nonfinite", self.process, None, "loss")
            if value != value or value in (float("inf"), float("-inf")):
                v = self._fire_locked(key_nf, step, f"loss is {value}")
                if v is not None:
                    fired.append(v)
            else:
                # a finite loss clears the nonfinite-loss condition so
                # a later, distinct NaN episode fires a NEW verdict
                self._active.pop(key_nf, None)
                ewma = self._loss_ewma
                if (self._loss_obs >= _WARMUP and ewma is not None
                        and abs(ewma) > 0.0
                        and value > self.loss_factor * abs(ewma)):
                    v = self._fire_locked(
                        key, step,
                        f"loss {value:.4g} vs EWMA {ewma:.4g} "
                        f"(> {self.loss_factor:g}x)")
                    if v is not None:
                        fired.append(v)
                elif (key in self._active and ewma is not None
                      and value < self.loss_factor * abs(ewma) / 2.0):
                    self._active.pop(key, None)
                self._loss_ewma = (value if ewma is None
                                   else ewma + EWMA_ALPHA * (value - ewma))
                self._loss_obs += 1
        self._publish(fired)

    def ingest_slo(self, rule: str, detail: str,
                   step: Optional[int] = None, clear: bool = False):
        """Feed one SLO watchdog edge (``metrics.slo`` rides the health
        plane here so ONE plane owns "is the job OK"): a breach becomes
        an edge-triggered ``slo_breach`` verdict — visible to
        ``/health/job``, the flight recorder, and ``on_unhealthy`` like
        any other condition — and ``clear=True`` re-arms the rule's
        condition so a later, distinct episode fires a NEW verdict."""
        fired: List[Verdict] = []
        with self._lock:
            step = self._last_step if step is None else int(step)
            key = ("slo_breach", self.process, None, rule)
            if clear:
                self._active.pop(key, None)
            else:
                v = self._fire_locked(key, step, detail, rule=rule)
                if v is not None:
                    fired.append(v)
        self._publish(fired)

    # -- verdict plumbing ----------------------------------------------------

    _UNSET = object()

    def _fire_locked(self, key: Tuple, step: int, detail: str,
                     bucket=_UNSET, **extra) -> Optional[Verdict]:
        """Fire the condition identified by ``key`` edge-triggered
        (caller holds the lock).  ``key[0]``/``key[1]`` are the kind
        and worker; ``bucket`` is the verdict's ATTRIBUTION (falling
        back to ``key[2]`` when that element is an index) and is
        deliberately NOT required in the key — the eager engine's
        plan index maps to a different tensor every cycle, so
        index-bearing keys could never re-arm.  Returns the new
        Verdict or None if already firing."""
        if key in self._active:
            return None
        kind, worker = key[0], key[1]
        if bucket is HealthEvaluator._UNSET:
            bucket = (key[2] if len(key) > 2
                      and (key[2] is None or isinstance(key[2], int))
                      else None)
        v = Verdict(kind, worker, bucket, step, detail, **extra)
        self._active[key] = v
        self._verdicts.append(v)
        if len(self._verdicts) > _MAX_VERDICTS:
            del self._verdicts[:len(self._verdicts) - _MAX_VERDICTS]
        self._counts[kind] = self._counts.get(kind, 0) + 1
        return v

    def _publish(self, fired: List[Verdict]):
        """Metrics + flight recorder + hook, OUTSIDE the lock (the hook
        may RPC; the flight event serializes fields)."""
        for v in fired:
            logger.warning(
                "health verdict: %s at step %d (worker %s, bucket %s): "
                "%s", v["kind"], v["step"], v["worker"], v["bucket"],
                v["detail"])
            if _metrics.ACTIVE:
                _m_verdicts.inc(kind=v["kind"])
            if _metrics.RECORDING:
                # verdicts are flight events: they ride the last-200
                # FAILURE-report tail, so a driver log shows WHY a
                # worker died of NaN, not just that it did
                _metrics.event("health.verdict", **v)
            if self.on_unhealthy is not None:
                try:
                    self.on_unhealthy(dict(v))
                except Exception:  # noqa: BLE001 - observability must
                    # not fail the training path
                    logger.warning("on_unhealthy hook failed",
                                   exc_info=True)

    # -- exposition ----------------------------------------------------------

    @property
    def healthy(self) -> bool:
        with self._lock:
            return not self._active

    def verdicts(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = [dict(v) for v in self._verdicts]
        return out[-limit:] if limit else out

    def summary(self) -> dict:
        """The compact ``engine.stats()["health"]`` section."""
        with self._lock:
            return {
                "healthy": not self._active,
                "verdicts": len(self._verdicts),
                "active": len(self._active),
                "kinds": dict(self._counts),
                "last_step": self._last_step,
            }

    def snapshot(self) -> dict:
        """The ``health_pull`` RPC payload (and ``GET /health``)."""
        with self._lock:
            # keyed by bucket NAME (the stable identity; the last seen
            # plan index rides alongside for cross-referencing)
            buckets = {
                name: {"bucket": b}
                for b, name in self._bucket_names.items()}
            for (w, name), (ewma, n_obs) in self._grad_ewma.items():
                d = buckets.setdefault(name, {})
                d.setdefault("grad_ewma", {})[str(w)] = round(ewma, 6)
                d.setdefault("observations", {})[str(w)] = n_obs
            out = {
                "process": self.process,
                "host": self.host,
                "healthy": not self._active,
                "active": [dict(v) for v in self._active.values()],
                "verdicts": [dict(v) for v in self._verdicts[-64:]],
                "counts": dict(self._counts),
                "last_step": self._last_step,
                "loss_ewma": self._loss_ewma,
                "checks": {
                    "stats_ingested": self._stats_ingested,
                    "checksum_rounds": self._checksum_rounds,
                    "loss_observations": self._loss_obs,
                },
                "buckets": buckets,
            }
        # the trace/metrics cross-reference hvddoctor prints: the stall
        # inspector's per-peer straggler EWMA, when a runtime is live
        try:
            from .. import runtime
            insp = runtime._state().stall_inspector
            if insp is not None and not insp.disabled:
                out["straggler_scores"] = {
                    str(k): round(v, 6)
                    for k, v in insp.straggler_scores().items()}
        except Exception:  # noqa: BLE001 - exposition must not raise
            pass
        return out

    def reset(self):
        """Drop all state (tests; elastic re-init keeps history)."""
        with self._lock:
            self._verdicts.clear()
            self._counts.clear()
            self._active.clear()
            self._grad_ewma.clear()
            self._bucket_names.clear()
            self._loss_ewma = None
            self._loss_obs = 0
            self._last_step = -1
            self._stats_ingested = 0
            self._checksum_rounds = 0
            self._checksum_seen.clear()
