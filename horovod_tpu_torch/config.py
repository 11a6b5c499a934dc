"""Typed runtime configuration with Horovod-compatible environment variables.

Counterpart: ``horovod_tpu/config.py``, whose knob table this copies: the
same ``HOROVOD_*`` names, defaults and meanings, parsed once at
``hvd.init()``.  The port keeps its own copy because importing any module
of the JAX package imports jax.

A knob whose feature the port does not have yet raises
``NotImplementedError`` naming its ROADMAP.md item when it is set to
anything but its default (:data:`UNPORTED`), so a job never runs without a
feature it asked for.  ``HOROVOD_COMPRESSION`` (with its block size and
``HOROVOD_COMPRESSION_DCN_ONLY``), ``HOROVOD_SHARDED_UPDATE`` and
``HOROVOD_OVERLAP`` are parsed and validated as in the JAX package and
read by ``optim/distributed.py`` (the transform's defaults) and the
engine (the eager wire format); the ``HOROVOD_SERVE_*`` knobs likewise,
read by ``serving/plane.py``; ``HOROVOD_ELASTIC`` by ``runtime.init``
(the elastic driver's epoch assignment); ``HOROVOD_HIERARCHICAL_*`` and
``HOROVOD_TAIL_*`` by the engine and the transform; ``HOROVOD_TIMELINE*``,
``HOROVOD_STALL_*`` and ``HOROVOD_AUTOTUNE*`` by ``runtime.init``;
``HOROVOD_RECOVERY*`` by ``elastic/recovery.RecoveryAgent`` (its
defaults); ``HOROVOD_HEALTH*`` by ``health/`` and the transform,
``HOROVOD_TIMESERIES*`` and ``HOROVOD_SLO`` (validated here by
``metrics.slo.parse_rules``) by ``metrics/timeseries.py`` and
``metrics/slo.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

#: HOROVOD_COMPRESSION's quantized wire formats (the JAX package's
#: ``compression.WIRE_FORMATS``)
WIRE_FORMATS = ("fp8_e4m3", "fp8_e5m2", "int8")
#: HOROVOD_TAIL_POLICY's values (the JAX package's
#: ``ops.collectives.TAIL_POLICIES``)
TAIL_POLICIES = ("strict", "bounded", "stale")

#: (environment variable, Config field, ROADMAP.md item) of every knob
#: whose feature is not ported yet (none now)
UNPORTED = ()


def check_ported(c: "Config") -> None:
    """Raise for a knob of :data:`UNPORTED` set away from its default."""
    default = Config()
    for env, field, item in UNPORTED:
        value = getattr(c, field)
        if value != getattr(default, field):
            raise NotImplementedError(
                f"{env}={os.environ.get(env)!r} selects a feature the port "
                f"does not have yet (ROADMAP.md {item}); unset it")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}")


def _env_bool(name: str, default: bool, environ=os.environ) -> bool:
    raw = environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _env_str(name: str, default: Optional[str]) -> Optional[str]:
    raw = os.environ.get(name)
    return default if raw in (None, "") else raw


@dataclasses.dataclass
class Config:
    """Runtime configuration snapshot (taken once at ``hvd.init()``)."""

    # --- fusion (reference: fusion_buffer_manager.cc, default 64 MiB) ---
    fusion_threshold_bytes: int = 64 * 1024 * 1024
    # --- coordination cycle (reference: HOROVOD_CYCLE_TIME, ms) ---
    cycle_time_ms: float = 1.0
    # --- response cache (reference: response_cache.cc) ---
    cache_capacity: int = 1024
    # --- timeline (reference: timeline.cc) ---
    timeline_path: Optional[str] = None
    timeline_mark_cycles: bool = False
    # --- stall inspector (reference: stall_inspector.cc; seconds) ---
    stall_check_time: float = 60.0
    stall_shutdown_time: float = 0.0  # 0 = never abort
    stall_check_disable: bool = False
    # --- autotune (reference: parameter_manager.cc) ---
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_max_samples: int = 20
    # tuned-state regression watch: re-enter sampling when the rolling
    # score drops > retune_drop for retune_windows consecutive windows
    # (0 disables). Reference: parameter_manager re-tunes on regression.
    autotune_retune_drop: float = 0.2
    autotune_retune_windows: int = 3
    # --- logging ---
    log_level: str = "warning"
    log_timestamp: bool = False
    # --- elastic ---
    elastic: bool = False
    # --- launcher-provided topology (reference: §3.4 env contract) ---
    rank: Optional[int] = None
    size: Optional[int] = None
    local_rank: Optional[int] = None
    local_size: Optional[int] = None
    cross_rank: Optional[int] = None
    cross_size: Optional[int] = None
    hostname: Optional[str] = None
    # rendezvous: the address and port of rank 0's TCPStore
    rendezvous_addr: Optional[str] = None
    rendezvous_port: Optional[int] = None
    controller: Optional[str] = None
    # explicit process topology from the hvdrun launcher (read and kept;
    # the port runs one process per GPU, so rank and size decide)
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # --- additions of the JAX package ---
    # mesh axis name used for the data-parallel worker axis (unused here)
    worker_axis: str = "workers"
    # run the control plane on the native C++ core (native/core.cpp, built
    # at first use; a failed build raises at init); False: the pure-Python
    # planner, decision, timeline writer and stall tracker
    use_native_core: bool = True
    # cross-process negotiation controller (reference: controller.cc);
    # HOROVOD_TPU_CONTROLLER=0 falls back to assumed-identical submission
    controller_enabled: bool = True
    # operations forced on/off
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # ZeRO-style sharded weight update on the in-jit path (reduce-scatter
    # → 1/N optimizer step → allgather; arXiv:2004.13336).  Default for
    # DistributedGradientTransform(sharded_update=None) when axis_name
    # is set; per-chip optimizer state drops to total/N + padding.
    sharded_update: bool = False
    # overlapped gradient dispatch on the in-jit path (ROADMAP item 3):
    # layer-aware fusion buckets dispatched inside the backward scan the
    # moment their gradients materialize (via the models' grad taps and
    # optim.overlap.overlapped_backprop), hiding DCN latency behind the
    # remaining backprop compute.  Default for
    # DistributedGradientTransform(overlap=None) when axis_name is set.
    overlap: bool = False
    # negotiated quantized wire format for summable allreduces
    # (EQuARX-class block-scaled int8/fp8; "none" disables).  Rides every
    # EntrySig through negotiation, so all processes must configure the
    # same value; the in-jit DistributedGradientTransform reads it as its
    # wire_format default (with error feedback), the eager engine applies
    # it per fused bucket at dispatch.
    compression: str = "none"
    # elements per fp32 scale block (wire overhead = 4/block_size B/elem)
    compression_block_size: int = 256
    # restrict the quantized wire to the cross-group (DCN) stage of the
    # hierarchical allreduce — the OptiReduce prescription: compress where
    # bandwidth is scarcest, keep ICI full-precision.  Off = quantize the
    # whole fused reduction even on flat (single-stage) meshes.
    compression_dcn_only: bool = True
    # model (parameter-sharding) mesh axes of a 2-D+ (data x model)
    # mesh, comma-separated ("" = none: pure DP).  A spec-aware
    # DistributedGradientTransform (param_specs=...) infers its model
    # axes from the specs themselves; this names them when the spec
    # tree alone cannot — e.g. every leaf replicated on a mesh that
    # STILL has a model axis, where replicated buckets must reduce over
    # (data + model) while the specs name no axis at all.
    model_axes: str = ""
    # negotiated straggler tolerance for the DCN stage of the
    # hierarchical allreduce (OptiReduce's tail prescription): "strict"
    # waits for every host; "bounded" proceeds at the deadline with the
    # k contributions present (n/k scale correction); "stale"
    # substitutes a missing host's previous-round chunk under a
    # staleness cap.  Rides every EntrySig/negotiation token (field 11),
    # so all processes must configure the same value; applies only where
    # a DCN stage exists (hierarchical path).
    tail_policy: str = "strict"
    # deadline (milliseconds) the bounded/stale DCN stage waits before
    # proceeding without stragglers
    tail_deadline_ms: float = 250.0
    # max consecutive rounds a host may be substituted-from-stale before
    # the round waits it out (0 = never substitute)
    tail_max_staleness: int = 4
    # straggler-score bar: a host whose stall-inspector EWMA lateness
    # score (seconds) crosses this feeds the elastic blacklist as a SOFT
    # failure before it dies outright (0 disables)
    tail_blacklist_score: float = 0.0
    # training-health telemetry master switch (docs/observability.md
    # "Training health"): the evaluator, the eager engine's dispatch
    # numerics taps, the health_pull RPC, and tap-compiled callbacks'
    # host deliveries.  0 = one false branch at every site.
    health: bool = True
    # in-jit numerics taps + divergence sentinel default for
    # DistributedGradientTransform(health=None).  A SCHEDULE property
    # like sharded_update (the sentinel adds an allgather to the
    # compiled step — pinned as the health_distopt_step hvdsched
    # entry), so it is an explicit opt-in; `health` above vetoes.
    health_taps: bool = False
    # divergence-sentinel cadence: param/opt-state checksums are
    # allgathered and compared across the axis every N-th step
    health_check_every: int = 32
    # verdict thresholds: grad-norm explosion fires past
    # grad_factor x the bucket's own EWMA baseline; loss spike past
    # loss_factor x the loss EWMA; residual drift past
    # residual_factor x the gradient EWMA (all after a short warmup)
    health_grad_factor: float = 10.0
    health_loss_factor: float = 4.0
    health_residual_factor: float = 4.0
    # time-series sampler (docs/metrics.md "Time series"): a bounded
    # on-worker ring of per-window metric DELTAS behind GET /timeseries
    # and the driver's merged /timeseries/job.  0 = one false branch at
    # every ride-along site, no sampler thread.
    timeseries: bool = True
    # window length (seconds): one ring entry per period
    timeseries_every_s: float = 10.0
    # ring capacity (windows): at the defaults, 15 minutes of history
    timeseries_window: int = 90
    # SLO watchdog rules over the windows, comma-separated
    # "signal<=value[@Nw]" / "signal>=value[@Nw]" (e.g.
    # "serve_p99_s<=0.5@3w,cycle_rate>=10@5w"); "" disables.  Breaches
    # are edge-triggered and ride the health plane (slo_breach
    # verdicts).
    slo: str = ""
    # --- serving plane (docs/serving.md; env table in docs/env.md) ---
    # attach a ServingPlane to the elastic driver (run_elastic_launcher)
    serve: bool = False
    # admission tick (ms): the request-batching window — the serving
    # analog of HOROVOD_CYCLE_TIME.  A micro-batch dispatches when it
    # fills its batch cap or its oldest request has waited one tick.
    serve_tick_ms: float = 2.0
    # batch cap: most rows one micro-batch may carry (the fusion byte
    # cap restated — the admission planner maps it onto plan_fusion's
    # threshold)
    serve_max_batch: int = 8
    # admitted shape buckets (comma-separated ascending ints).  Every
    # batch pads up to the smallest (batch, seq) bucket that fits, so
    # steady-state serving never recompiles; "" batch buckets default
    # to powers of two up to serve_max_batch.
    serve_batch_buckets: str = ""
    serve_seq_buckets: str = "32,64,128"
    # default per-request deadline (ms): a request still QUEUED past it
    # fails as "expired" instead of wasting a batch slot; 0 = no bound.
    # Dispatched requests always complete (a late answer still lands).
    serve_deadline_ms: float = 1000.0
    # lease: how long a dispatched micro-batch may stay un-pushed
    # before the plane requeues its requests (silent-worker-death
    # backstop; the elastic reaper requeues eagerly on a known death)
    serve_lease_s: float = 10.0
    # straggler rotation: a worker whose batch-service EWMA exceeds
    # this factor x the median of its peers stops receiving pulls
    # (>= 2 active workers; never the last one).  0 disables.
    serve_straggler_factor: float = 3.0
    # paged KV cache: tokens per pool block (serving/paging.py).  The
    # granularity knob: smaller blocks waste fewer slots per row but
    # deepen the block table; per-row cost is ceil((len+new)/block)
    # blocks instead of bucket-max.
    serve_kv_block: int = 16
    # model-parallel serving mesh: "" = DP-only (every worker a full
    # replica), or "name:degree" (e.g. "model:2") — the worker group
    # serves as one mesh slice with params sharded degree-ways
    # (serving/worker.py MeshSlicedForward).  Single axis for now.
    serve_mp_axes: str = ""
    # --- checkpointless recovery (docs/elastic.md "Checkpointless
    # recovery"; env table in docs/env.md) ---
    # peer-redundancy mode for the per-worker ZeRO tile snapshots:
    # "off" (no redundancy), "neighbor" (full frame replicated to the
    # ring neighbor), "parity" (XOR parity groups — ~1/G the held
    # bytes; rebuild needs every surviving group member)
    recovery: str = "off"
    # snapshot cadence: push every N-th accumulation boundary.  The
    # staleness/traffic tradeoff — at cadence E a rebuild loses at most
    # E boundaries of progress while redundancy wire bytes shrink 1/E.
    recovery_every: int = 1
    # rebuild pull deadline (seconds): how long a rejoining worker
    # polls peers for its lost frame before giving up
    recovery_pull_deadline_s: float = 30.0
    # XOR parity group size (parity mode only; >= 2)
    recovery_parity_group: int = 4

    @staticmethod
    def from_env() -> "Config":
        c = Config()
        c.fusion_threshold_bytes = _env_int(
            "HOROVOD_FUSION_THRESHOLD", c.fusion_threshold_bytes)
        c.cycle_time_ms = _env_float("HOROVOD_CYCLE_TIME", c.cycle_time_ms)
        c.cache_capacity = _env_int("HOROVOD_CACHE_CAPACITY", c.cache_capacity)
        c.timeline_path = _env_str("HOROVOD_TIMELINE", c.timeline_path)
        c.timeline_mark_cycles = _env_bool(
            "HOROVOD_TIMELINE_MARK_CYCLES", c.timeline_mark_cycles)
        c.stall_check_time = _env_float(
            "HOROVOD_STALL_CHECK_TIME_SECONDS", c.stall_check_time)
        c.stall_shutdown_time = _env_float(
            "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", c.stall_shutdown_time)
        c.stall_check_disable = _env_bool(
            "HOROVOD_STALL_CHECK_DISABLE", c.stall_check_disable)
        c.autotune = _env_bool("HOROVOD_AUTOTUNE", c.autotune)
        c.autotune_log = _env_str("HOROVOD_AUTOTUNE_LOG", c.autotune_log)
        c.autotune_warmup_samples = _env_int(
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", c.autotune_warmup_samples)
        c.autotune_steps_per_sample = _env_int(
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", c.autotune_steps_per_sample)
        c.autotune_max_samples = _env_int(
            "HOROVOD_AUTOTUNE_MAX_SAMPLES", c.autotune_max_samples)
        c.autotune_retune_drop = _env_float(
            "HOROVOD_AUTOTUNE_RETUNE_DROP", c.autotune_retune_drop)
        c.autotune_retune_windows = _env_int(
            "HOROVOD_AUTOTUNE_RETUNE_WINDOWS", c.autotune_retune_windows)
        c.log_level = _env_str("HOROVOD_LOG_LEVEL", c.log_level) or "warning"
        c.log_timestamp = _env_bool("HOROVOD_LOG_TIMESTAMP", c.log_timestamp)
        c.elastic = _env_bool("HOROVOD_ELASTIC", c.elastic)
        c.rank = _env_int("HOROVOD_RANK", -1)
        c.rank = None if c.rank < 0 else c.rank
        c.size = _env_int("HOROVOD_SIZE", -1)
        c.size = None if c.size < 0 else c.size
        c.local_rank = _env_int("HOROVOD_LOCAL_RANK", -1)
        c.local_rank = None if c.local_rank < 0 else c.local_rank
        c.local_size = _env_int("HOROVOD_LOCAL_SIZE", -1)
        c.local_size = None if c.local_size < 0 else c.local_size
        c.cross_rank = _env_int("HOROVOD_CROSS_RANK", -1)
        c.cross_rank = None if c.cross_rank < 0 else c.cross_rank
        c.cross_size = _env_int("HOROVOD_CROSS_SIZE", -1)
        c.cross_size = None if c.cross_size < 0 else c.cross_size
        c.hostname = _env_str("HOROVOD_HOSTNAME", c.hostname)
        c.rendezvous_addr = _env_str(
            "HOROVOD_GLOO_RENDEZVOUS_ADDR", c.rendezvous_addr)
        port = _env_int("HOROVOD_GLOO_RENDEZVOUS_PORT", -1)
        c.rendezvous_port = None if port < 0 else port
        c.controller = _env_str("HOROVOD_CONTROLLER", c.controller)
        c.num_processes = _env_int("HOROVOD_NUM_PROCESSES", -1)
        c.num_processes = None if c.num_processes < 0 else c.num_processes
        c.process_id = _env_int("HOROVOD_PROCESS_ID", -1)
        c.process_id = None if c.process_id < 0 else c.process_id
        c.use_native_core = _env_bool(
            "HOROVOD_TPU_NATIVE_CORE", c.use_native_core)
        c.controller_enabled = _env_bool(
            "HOROVOD_TPU_CONTROLLER", c.controller_enabled)
        c.hierarchical_allreduce = _env_bool(
            "HOROVOD_HIERARCHICAL_ALLREDUCE", c.hierarchical_allreduce)
        c.hierarchical_allgather = _env_bool(
            "HOROVOD_HIERARCHICAL_ALLGATHER", c.hierarchical_allgather)
        c.sharded_update = _env_bool(
            "HOROVOD_SHARDED_UPDATE", c.sharded_update)
        c.overlap = _env_bool("HOROVOD_OVERLAP", c.overlap)
        c.compression = (_env_str("HOROVOD_COMPRESSION", c.compression)
                         or "none").strip().lower()
        if c.compression not in ("none",) + WIRE_FORMATS:
            raise ValueError(
                f"HOROVOD_COMPRESSION must be one of "
                f"{('none',) + WIRE_FORMATS}, got {c.compression!r}")
        c.compression_block_size = _env_int(
            "HOROVOD_COMPRESSION_BLOCK_SIZE", c.compression_block_size)
        if c.compression_block_size <= 0:
            raise ValueError(
                f"HOROVOD_COMPRESSION_BLOCK_SIZE must be positive, got "
                f"{c.compression_block_size}")
        c.compression_dcn_only = _env_bool(
            "HOROVOD_COMPRESSION_DCN_ONLY", c.compression_dcn_only)
        c.model_axes = (_env_str("HOROVOD_MODEL_AXES", c.model_axes)
                        or "").strip()
        for _ax in c.model_axes.split(","):
            # strip BEFORE the emptiness filter: "tp, " yields a
            # whitespace segment that the consumer (make_spec_plan)
            # also ignores, so it must validate clean here too
            if _ax.strip() and not _ax.strip().isidentifier():
                raise ValueError(
                    f"HOROVOD_MODEL_AXES must be comma-separated mesh "
                    f"axis names, got {c.model_axes!r}")
        c.tail_policy = (_env_str("HOROVOD_TAIL_POLICY", c.tail_policy)
                         or "strict").strip().lower()
        if c.tail_policy not in TAIL_POLICIES:
            raise ValueError(
                f"HOROVOD_TAIL_POLICY must be one of {TAIL_POLICIES}, "
                f"got {c.tail_policy!r}")
        c.tail_deadline_ms = _env_float(
            "HOROVOD_TAIL_DEADLINE_MS", c.tail_deadline_ms)
        if c.tail_deadline_ms <= 0:
            raise ValueError(
                f"HOROVOD_TAIL_DEADLINE_MS must be positive, got "
                f"{c.tail_deadline_ms}")
        c.tail_max_staleness = _env_int(
            "HOROVOD_TAIL_MAX_STALENESS", c.tail_max_staleness)
        if c.tail_max_staleness < 0:
            raise ValueError(
                f"HOROVOD_TAIL_MAX_STALENESS must be >= 0, got "
                f"{c.tail_max_staleness}")
        c.tail_blacklist_score = _env_float(
            "HOROVOD_TAIL_BLACKLIST_SCORE", c.tail_blacklist_score)
        if c.tail_blacklist_score < 0:
            raise ValueError(
                f"HOROVOD_TAIL_BLACKLIST_SCORE must be >= 0, got "
                f"{c.tail_blacklist_score}")
        c.health = _env_bool("HOROVOD_HEALTH", c.health)
        c.health_taps = _env_bool("HOROVOD_HEALTH_TAPS", c.health_taps)
        c.health_check_every = _env_int(
            "HOROVOD_HEALTH_CHECK_EVERY", c.health_check_every)
        if c.health_check_every < 1:
            raise ValueError(
                f"HOROVOD_HEALTH_CHECK_EVERY must be >= 1, got "
                f"{c.health_check_every}")
        c.health_grad_factor = _env_float(
            "HOROVOD_HEALTH_GRAD_FACTOR", c.health_grad_factor)
        c.health_loss_factor = _env_float(
            "HOROVOD_HEALTH_LOSS_FACTOR", c.health_loss_factor)
        c.health_residual_factor = _env_float(
            "HOROVOD_HEALTH_RESIDUAL_FACTOR", c.health_residual_factor)
        for _name, _v in (("HOROVOD_HEALTH_GRAD_FACTOR",
                           c.health_grad_factor),
                          ("HOROVOD_HEALTH_LOSS_FACTOR",
                           c.health_loss_factor),
                          ("HOROVOD_HEALTH_RESIDUAL_FACTOR",
                           c.health_residual_factor)):
            if _v <= 1.0:
                raise ValueError(
                    f"{_name} must be > 1 (a bar at or below the "
                    f"baseline fires on every step), got {_v}")
        c.timeseries = _env_bool("HOROVOD_TIMESERIES", c.timeseries)
        c.timeseries_every_s = _env_float(
            "HOROVOD_TIMESERIES_EVERY_S", c.timeseries_every_s)
        if c.timeseries_every_s <= 0:
            raise ValueError(
                f"HOROVOD_TIMESERIES_EVERY_S must be positive, got "
                f"{c.timeseries_every_s}")
        c.timeseries_window = _env_int(
            "HOROVOD_TIMESERIES_WINDOW", c.timeseries_window)
        if c.timeseries_window < 2:
            raise ValueError(
                f"HOROVOD_TIMESERIES_WINDOW must be >= 2 (one window "
                f"of history is no trend), got {c.timeseries_window}")
        c.slo = (_env_str("HOROVOD_SLO", c.slo) or "").strip()
        if c.slo:
            from .metrics.slo import parse_rules
            try:
                parse_rules(c.slo)
            except ValueError as e:
                raise ValueError(f"HOROVOD_SLO invalid: {e}") from None
        c.serve = _env_bool("HOROVOD_SERVE", c.serve)
        c.serve_tick_ms = _env_float(
            "HOROVOD_SERVE_TICK_MS", c.serve_tick_ms)
        if c.serve_tick_ms < 0:
            raise ValueError(
                f"HOROVOD_SERVE_TICK_MS must be >= 0, got "
                f"{c.serve_tick_ms}")
        c.serve_max_batch = _env_int(
            "HOROVOD_SERVE_MAX_BATCH", c.serve_max_batch)
        if c.serve_max_batch < 1:
            raise ValueError(
                f"HOROVOD_SERVE_MAX_BATCH must be >= 1, got "
                f"{c.serve_max_batch}")
        c.serve_batch_buckets = (_env_str(
            "HOROVOD_SERVE_BATCH_BUCKETS", c.serve_batch_buckets)
            or "").strip()
        c.serve_seq_buckets = (_env_str(
            "HOROVOD_SERVE_SEQ_BUCKETS", c.serve_seq_buckets)
            or "").strip()
        from .serving.shapes import parse_buckets
        if c.serve_batch_buckets:
            parse_buckets(c.serve_batch_buckets,
                          "HOROVOD_SERVE_BATCH_BUCKETS")
        parse_buckets(c.serve_seq_buckets, "HOROVOD_SERVE_SEQ_BUCKETS")
        c.serve_deadline_ms = _env_float(
            "HOROVOD_SERVE_DEADLINE_MS", c.serve_deadline_ms)
        if c.serve_deadline_ms < 0:
            raise ValueError(
                f"HOROVOD_SERVE_DEADLINE_MS must be >= 0 (0 disables), "
                f"got {c.serve_deadline_ms}")
        c.serve_lease_s = _env_float(
            "HOROVOD_SERVE_LEASE_S", c.serve_lease_s)
        if c.serve_lease_s <= 0:
            raise ValueError(
                f"HOROVOD_SERVE_LEASE_S must be positive, got "
                f"{c.serve_lease_s}")
        c.serve_straggler_factor = _env_float(
            "HOROVOD_SERVE_STRAGGLER_FACTOR", c.serve_straggler_factor)
        if c.serve_straggler_factor != 0 and c.serve_straggler_factor <= 1:
            raise ValueError(
                f"HOROVOD_SERVE_STRAGGLER_FACTOR must be 0 (off) or > 1 "
                f"(a bar at or below the peer median rotates every "
                f"worker), got {c.serve_straggler_factor}")
        c.serve_kv_block = _env_int(
            "HOROVOD_SERVE_KV_BLOCK", c.serve_kv_block)
        if c.serve_kv_block < 1:
            raise ValueError(
                f"HOROVOD_SERVE_KV_BLOCK must be >= 1, got "
                f"{c.serve_kv_block}")
        c.serve_mp_axes = (_env_str(
            "HOROVOD_SERVE_MP_AXES", c.serve_mp_axes) or "").strip()
        from .serving.shapes import parse_mp_axes
        parse_mp_axes(c.serve_mp_axes)   # validate at config time
        c.recovery = ((_env_str("HOROVOD_RECOVERY", c.recovery)
                       or "off").strip().lower())
        from .elastic.recovery import RECOVERY_MODES
        if c.recovery not in RECOVERY_MODES:
            raise ValueError(
                f"HOROVOD_RECOVERY must be one of "
                f"{'/'.join(RECOVERY_MODES)}, got {c.recovery!r}")
        c.recovery_every = _env_int(
            "HOROVOD_RECOVERY_EVERY", c.recovery_every)
        if c.recovery_every < 1:
            raise ValueError(
                f"HOROVOD_RECOVERY_EVERY must be >= 1, got "
                f"{c.recovery_every}")
        c.recovery_pull_deadline_s = _env_float(
            "HOROVOD_RECOVERY_PULL_DEADLINE_S", c.recovery_pull_deadline_s)
        if c.recovery_pull_deadline_s <= 0:
            raise ValueError(
                f"HOROVOD_RECOVERY_PULL_DEADLINE_S must be positive, "
                f"got {c.recovery_pull_deadline_s}")
        c.recovery_parity_group = _env_int(
            "HOROVOD_RECOVERY_PARITY_GROUP", c.recovery_parity_group)
        if c.recovery_parity_group < 2:
            raise ValueError(
                f"HOROVOD_RECOVERY_PARITY_GROUP must be >= 2, got "
                f"{c.recovery_parity_group}")
        check_ported(c)
        return c
