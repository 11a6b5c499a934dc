"""Online autotuning of the engine's parameters.

Counterpart: ``horovod_tpu/autotune.py``, copied (numpy only), after the
reference's ``horovod/common/parameter_manager.cc``: Bayesian
optimization (a Gaussian-process surrogate with expected improvement) over
the fusion threshold, the cycle time, and the response-cache,
hierarchical-allreduce and quantized-wire switches, scored by the bytes a
second the engine's cycles move, through warm-up, sampling and tuned
phases, logged to ``HOROVOD_AUTOTUNE_LOG``.  A sample budget bounds the
search; after convergence a sustained score drop re-enters sampling.

In a job of more than one rank only rank 0's tuner learns; the engine
publishes its current point in every round of the global process set
(keys ``t``, ``c``, ``ca``, ``hi``, ``cp``) and every rank applies the
point the round agreed, so the fusion plans stay identical
(``ops/engine.py``).
"""

from __future__ import annotations

import logging
import math
import time
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("horovod_tpu_torch")

_MIB = 1024 * 1024
# candidate grids: log2 bucket bytes 1 MiB..512 MiB × cycle time ms ×
# response-cache on/off × hierarchical-allreduce on/off × quantized-wire
# compression on/off (the reference's parameter_manager tunes the same
# categorical knobs alongside the numeric pair)
_THRESH_GRID = [float(e) for e in range(20, 30)]
_CYCLE_GRID_MS = [0.0, 0.5, 1.0, 2.0, 5.0, 10.0]
_BIN = (0.0, 1.0)


def _make_grid(cycle_grid, cache_flags=_BIN, hier_flags=_BIN,
               comp_flags=_BIN):
    """Candidate points in normalized coordinates (threshold exponent,
    cycle index, cache flag, hier flag, compression flag) — the cycle
    dim uses its INDEX so the RBF sees uniform spacing despite the
    geometric ms grid."""
    return [(t, float(ci), ca, hi, cp) for t in _THRESH_GRID
            for ci in range(len(cycle_grid))
            for ca in cache_flags for hi in hier_flags
            for cp in comp_flags]


class _GP:
    """Tiny Gaussian process (RBF kernel) for N-D expected improvement."""

    def __init__(self, length_scales=(1.5, 1.0, 0.6, 0.6, 0.6),
                 noise: float = 1e-2):
        self.ls = np.asarray(length_scales)
        self.noise = noise
        self.xs: List[Tuple[float, ...]] = []
        self.ys: List[float] = []

    def add(self, x: Tuple[float, ...], y: float):
        self.xs.append(tuple(x))
        self.ys.append(y)

    def _k(self, a, b):
        a = np.asarray(a, float)[:, None, :] / self.ls
        b = np.asarray(b, float)[None, :, :] / self.ls
        return np.exp(-0.5 * np.sum((a - b) ** 2, axis=-1))

    def posterior(self, xq) -> Tuple[np.ndarray, np.ndarray]:
        X = np.asarray(self.xs, float)
        y = np.asarray(self.ys)
        mu0 = y.mean() if len(y) else 0.0
        K = self._k(X, X) + self.noise * np.eye(len(X))
        Ks = self._k(xq, X)
        sol = np.linalg.solve(K, y - mu0)
        mu = Ks @ sol + mu0
        v = 1.0 + self.noise - np.sum(Ks * np.linalg.solve(K, Ks.T).T, axis=1)
        return mu, np.sqrt(np.maximum(v, 1e-12))

    def suggest(self, grid) -> Tuple[float, ...]:
        unseen = [p for p in grid if p not in set(self.xs)]
        if not unseen:
            return grid[0]
        if not self.xs:
            return unseen[len(unseen) // 2]
        mu, sd = self.posterior(unseen)
        best = max(self.ys)
        z = (mu - best) / sd
        ei = sd * (z * _ndtr(z) + _npdf(z))
        return unseen[int(np.argmax(ei))]


def _ndtr(z):
    return 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))


def _npdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


class ParameterManager:
    """Warmup → sample → tuned lifecycle, scoring by bytes/sec throughput.

    Tunes (fusion threshold, cycle time) jointly — reference:
    ParameterManager's joint tunable set.  The configured cycle time is
    added to the candidate grid and is the starting point, so enabling
    autotune never silently changes the user's setting before the tuner
    actually moves it.
    """

    def __init__(self, cfg, hier_available: bool = True):
        self.cfg = cfg
        self.warmup_remaining = cfg.autotune_warmup_samples
        self.steps_per_sample = cfg.autotune_steps_per_sample
        self.max_samples = getattr(cfg, "autotune_max_samples", 20)
        # tuned-state regression watch (reference: parameter_manager
        # re-tunes when observed throughput regresses): a sustained score
        # drop > retune_drop for retune_windows consecutive windows
        # re-enters sampling instead of keeping stale parameters forever
        self.retune_drop = getattr(cfg, "autotune_retune_drop", 0.2)
        self.retune_windows = getattr(cfg, "autotune_retune_windows", 3)
        self._regress_count = 0
        self.retunes = 0
        self._gp = _GP()
        self._cycle_grid = sorted(set(_CYCLE_GRID_MS)
                                  | {float(cfg.cycle_time_ms)})
        # cache_capacity <= 0 hard-disables ResponseCache.get/put, so the
        # cache dimension would be inert — pin it off instead of letting
        # the GP converge to a value that cannot take effect; same for the
        # hierarchical flag when the process set has no valid
        # (groups, group_size) factorization (single host / prime sizes).
        # The compression dimension explores only when the operator opted
        # into a quantized wire (HOROVOD_COMPRESSION != none): the tuner
        # may turn LOSSY compression off for throughput, but never on —
        # gradient precision is not its call to make.
        cache_flags = _BIN if cfg.cache_capacity > 0 else (0.0,)
        hier_flags = _BIN if hier_available else (
            1.0 if getattr(cfg, "hierarchical_allreduce", False) else 0.0,)
        comp_configured = getattr(cfg, "compression", "none") != "none"
        comp_flags = _BIN if comp_configured else (0.0,)
        self._grid = _make_grid(self._cycle_grid, cache_flags=cache_flags,
                                hier_flags=hier_flags,
                                comp_flags=comp_flags)
        self._current = (math.log2(cfg.fusion_threshold_bytes),
                         float(self._cycle_grid.index(
                             float(cfg.cycle_time_ms))),
                         1.0 if cfg.cache_capacity > 0 else 0.0,
                         1.0 if getattr(cfg, "hierarchical_allreduce",
                                        False) else 0.0,
                         1.0 if comp_configured else 0.0)
        self._sample_bytes = 0
        self._sample_time = 0.0
        self._sample_steps = 0
        self._tuned = False
        self._best: Optional[Tuple[Tuple[float, float], float]] = None
        self._log_file = open(cfg.autotune_log, "w") if cfg.autotune_log \
            else None
        if self._log_file:
            self._log_file.write(
                "timestamp,fusion_threshold_bytes,cycle_time_ms,"
                "cache,hierarchical,compression,score_bytes_per_sec,"
                "phase\n")

    def current_fusion_threshold(self) -> int:
        return int(2 ** self._current[0])

    def current_cycle_time_ms(self) -> float:
        return self._cycle_grid[int(self._current[1])]

    def current_cache_enabled(self) -> bool:
        return bool(self._current[2])

    def current_hierarchical(self) -> bool:
        return bool(self._current[3])

    def current_compression(self) -> bool:
        # len guard: a LIVE engine's background loop reads the tuner
        # between a test pinning _current to a (threshold, cycle) pair
        # (test_engine_reads_tuned_cycle_time) and restoring it — the
        # categorical dims must degrade to off, not IndexError, there
        return bool(self._current[4]) if len(self._current) > 4 else False

    @property
    def tuned(self) -> bool:
        return self._tuned

    def record_cycle(self, nbytes: int, elapsed_s: float):
        if self._tuned:
            self._watch_regression(nbytes, elapsed_s)
            return
        self._sample_bytes += nbytes
        self._sample_time += elapsed_s
        self._sample_steps += 1
        if self._sample_steps < self.steps_per_sample:
            return
        score = self._sample_bytes / max(self._sample_time, 1e-9)
        phase = "warmup" if self.warmup_remaining > 0 else "sample"
        # log row pairs the score with the parameters it was MEASURED at
        # (self._current moves to the next suggestion below)
        measured = self._current
        if self.warmup_remaining > 0:
            self.warmup_remaining -= 1
        else:
            self._gp.add(self._current, score)
            if self._best is None or score > self._best[1]:
                self._best = (self._current, score)
            if (len(self._gp.xs) >= self.max_samples
                    or len(self._gp.xs) >= len(self._grid)):
                # converge: lock in the best observed point
                self._current = self._best[0]
                self._tuned = True
                phase = "tuned"
                logger.info(
                    "autotune converged: fusion_threshold=%d bytes "
                    "(%.1f MiB), cycle_time=%.1f ms, cache=%s, "
                    "hierarchical=%s, compression=%s, score=%.3g B/s",
                    self.current_fusion_threshold(),
                    self.current_fusion_threshold() / _MIB,
                    self.current_cycle_time_ms(),
                    self.current_cache_enabled(),
                    self.current_hierarchical(),
                    self.current_compression(), self._best[1])
            else:
                self._current = self._gp.suggest(self._grid)
        self._log_row(measured, score, phase)
        self._sample_bytes = 0
        self._sample_time = 0.0
        self._sample_steps = 0

    def _log_row(self, point, score: float, phase: str):
        if not self._log_file:
            return
        thr = int(2 ** point[0])
        cyc = self._cycle_grid[int(point[1])]
        self._log_file.write(
            f"{time.time():.3f},{thr},{cyc:g},{int(point[2])},"
            f"{int(point[3])},{int(point[4])},{score:.6g},{phase}\n")
        self._log_file.flush()

    def _watch_regression(self, nbytes: int, elapsed_s: float):
        """Tuned-state monitoring: keep scoring windows; a sustained drop
        below (1 - retune_drop) x the converged score for retune_windows
        consecutive windows means the workload shifted (sequence-length
        change, elastic resize) — discard the stale surrogate and re-enter
        warmup -> sample from the current point."""
        if (self.retune_drop <= 0 or self.retune_windows <= 0
                or self._best is None):
            return
        self._sample_bytes += nbytes
        self._sample_time += elapsed_s
        self._sample_steps += 1
        if self._sample_steps < self.steps_per_sample:
            return
        score = self._sample_bytes / max(self._sample_time, 1e-9)
        self._sample_bytes = 0
        self._sample_time = 0.0
        self._sample_steps = 0
        if score < (1.0 - self.retune_drop) * self._best[1]:
            self._regress_count += 1
        else:
            self._regress_count = 0
        self._log_row(self._current, score, "tuned")
        if self._regress_count >= self.retune_windows:
            logger.info(
                "autotune re-entering sampling: tuned score %.3g B/s "
                "regressed to %.3g B/s for %d consecutive windows "
                "(workload shift)", self._best[1], score,
                self._regress_count)
            self._tuned = False
            self._gp = _GP()           # stale observations: new workload
            self._best = None
            self.warmup_remaining = self.cfg.autotune_warmup_samples
            self._regress_count = 0
            self.retunes += 1
            self._log_row(self._current, score, "retune")
