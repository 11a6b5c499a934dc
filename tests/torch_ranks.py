"""Multi-process cases for the port's runtime, run as real rank processes.

The test process calls :func:`launch`, which starts ``world`` processes of
this file over gloo on the CPU (the launcher's env contract:
``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_GLOO_RENDEZVOUS_*``) with a
hard timeout, runs the named cases in each, and returns each rank's
results.  The rank processes import neither jax nor horovod_tpu: inputs
come from numpy seeds defined here, so the test process can rebuild them
for the JAX package.  Run by hand::

    python tests/torch_ranks.py OUT_DIR CASE [CASE ...]   # with the env
"""

import dataclasses
import functools
import json
import os
import pathlib
import pickle
import signal
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

DTYPES = ("float32", "float64", "int32", "int64", "bfloat16")
FLOATS = ("float32", "float64", "bfloat16")


#: how many times :func:`launch` starts a world again whose rank 0 could
#: not listen on its port (another process took it after it was chosen)
LAUNCH_ATTEMPTS = 3


def free_port():
    """A port the kernel has just handed out; rank 0's store binds it a
    moment later, and :func:`launch` retries when someone took it."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, cases, tmp_path, port=None, env=None, timeout=300):
    """Run ``cases`` in ``world`` rank processes; returns each rank's
    ``{case: result}``.  Kills every rank and raises when one fails or the
    launch outlives ``timeout`` seconds.  ``port`` is the first attempt's
    rendezvous port (default: a free one); a launch whose rank 0 found its
    port taken (EADDRINUSE) starts again on a new one."""
    for attempt in range(LAUNCH_ATTEMPTS):
        ok, result = _launch_once(world, cases, pathlib.Path(tmp_path),
                                  port or free_port(), env, timeout)
        if ok:
            return result
        if "EADDRINUSE" not in result or attempt == LAUNCH_ATTEMPTS - 1:
            raise AssertionError(result)
        port = None


def retried(launch, attempts=LAUNCH_ATTEMPTS):
    """``launch()``, started again when it raises RuntimeError (its
    workers failed): for the JAX package's reference launches
    (``horovod_tpu.runner.run``), whose port, chosen free, can be taken
    before their workers bind it seconds later, as :func:`launch`'s can."""
    for attempt in range(attempts):
        try:
            return launch()
        except RuntimeError:
            if attempt == attempts - 1:
                raise


class Worlds(dict):
    """``worlds[n]``: each rank's results of ``cases`` at world size ``n``,
    launched on the first read, so a failed launch of one world leaves
    the tests of another alone."""

    def __init__(self, tmp_path_factory, cases):
        super().__init__()
        self._tmp = tmp_path_factory
        self._cases = list(cases)

    def __missing__(self, world):
        self[world] = launch(world, self._cases,
                             self._tmp.mktemp(f"w{world}"))
        return self[world]


def _host_env(env, rank):
    """A host layout's per-rank variables: with ``HOROVOD_LOCAL_SIZE`` in
    ``env``, rank ``r`` is local rank ``r % L`` of host ``r // L``."""
    if not env or "HOROVOD_LOCAL_SIZE" not in env:
        return {}
    n_local = int(env["HOROVOD_LOCAL_SIZE"])
    return {"HOROVOD_LOCAL_RANK": str(rank % n_local),
            "HOROVOD_CROSS_RANK": str(rank // n_local)}


def _launch_once(world, cases, tmp_path, port, env, timeout):
    out = tmp_path / f"ranks{world}-{port}"
    out.mkdir()
    procs = []
    for r in range(world):
        e = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(world),
                 HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                 HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                 HOROVOD_CYCLE_TIME="0.1",
                 HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="120",
                 PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                 **(env or {}), **_host_env(env, r))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(out), *cases], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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
    logs = [p.communicate()[0].decode(errors="replace")[-3000:]
            for p in procs]
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if expired or bad:
        return False, (f"ranks of {cases} on port {port} "
                       + (f"outlived {timeout} s" if expired
                          else f"failed {bad}") + ":\n" + "\n".join(logs))
    return True, [pickle.loads((out / f"rank{r}.pkl").read_bytes())
                  for r in range(world)]


# -- inputs (numpy only: the test process rebuilds them for JAX) ------------

def base(dtype, rank, shape=(4, 6), seed=0):
    """Rank ``rank``'s tensor: multiples of 1/4 (integers for int dtypes),
    exact in bf16 and in every sum of a few of them."""
    rng = np.random.RandomState(seed + 100 * rank)
    v = rng.randint(-16, 16, shape).astype(np.float64)
    if dtype in FLOATS:
        v = v / 4
    return v.astype("float32" if dtype == "bfloat16" else dtype)


def scales(dtype):
    """(op, prescale, postscale) of the scaled-allreduce case: the JAX
    package casts a factor to the tensor's dtype, so ints get int ones."""
    return ("average", 0.5, 4.0) if dtype in FLOATS else ("sum", 2.0, 3.0)


def ag_rows(rank):
    return rank + 1


def a2a_splits(world):
    return [(2 * j + 1) % 4 for j in range(world)]


# -- the cases ---------------------------------------------------------------

def _np(t):
    import torch
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def case_collectives(hvd, rank, world):
    """Every op on every dtype of :data:`DTYPES`."""
    import torch
    out = {}
    for dt in DTYPES:
        tdt = getattr(torch, dt)

        def t(a):
            return torch.from_numpy(np.asarray(a)).to(tdt)

        x = t(base(dt, rank))
        op, pre, post = scales(dt)
        r = {
            "sum": hvd.allreduce(x, op=hvd.Sum, name=f"{dt}.sum"),
            "min": hvd.allreduce(x, op=hvd.Min, name=f"{dt}.min"),
            "max": hvd.allreduce(x, op=hvd.Max, name=f"{dt}.max"),
            "scaled": hvd.allreduce(x, op=op, prescale_factor=pre,
                                    postscale_factor=post,
                                    name=f"{dt}.scaled"),
        }
        if dt in FLOATS:
            r["avg"] = hvd.allreduce(x, name=f"{dt}.avg")
        g = hvd.grouped_allreduce([x, x[:2] * 2], op=hvd.Sum,
                                  name=f"{dt}.grouped")
        r["grouped0"], r["grouped1"] = g
        h = hvd.allreduce_async(x, op=hvd.Sum, name=f"{dt}.async")
        r["async"] = hvd.synchronize(h)
        assert hvd.poll(h)
        y = x.clone()
        assert hvd.allreduce_(y, op=hvd.Sum, name=f"{dt}.inplace") is y
        r["inplace"] = y
        r["ag"] = hvd.allgather(x, name=f"{dt}.ag")
        r["agv"] = hvd.allgather(t(base(dt, rank, (ag_rows(rank), 3))),
                                 name=f"{dt}.agv")
        r["bc"] = hvd.broadcast(x, 1, name=f"{dt}.bc")
        z = x.clone()
        hvd.broadcast_(z, 1, name=f"{dt}.bc_")
        r["bc_inplace"] = z
        r["a2a"] = hvd.alltoall(t(base(dt, rank, (2 * world, 3))),
                                name=f"{dt}.a2a")
        splits = a2a_splits(world)
        r["a2av"] = hvd.alltoall(t(base(dt, rank, (sum(splits), 3))),
                                 splits=splits, name=f"{dt}.a2av")
        r["rs"] = hvd.reducescatter(t(base(dt, rank, (2 * world, 3))),
                                    op=hvd.Sum, name=f"{dt}.rs")
        if dt in FLOATS:
            r["rs_avg"] = hvd.reducescatter(
                t(base(dt, rank, (2 * world, 3))), name=f"{dt}.rs_avg")
        out.update({f"{dt}.{k}": _np(v) for k, v in r.items()})
    # 64 small tensors in one call of the engine: fewer buckets than tensors
    eng = hvd.runtime._state().engine
    before = eng.stats()
    hs = eng.submit([hvd.api.TensorTableEntry(
        f"many.{i}", "allreduce", [torch.full((3,), float(i + rank))],
        hvd.runtime._get_global_process_set(), reduce_op=hvd.Sum)
        for i in range(64)])
    out["many"] = np.stack([_np(h.synchronize()) for h in hs])
    after = eng.stats()
    out["many_buckets"] = after["buckets"] - before["buckets"]
    out["many_tensors"] = after["tensors"] - before["tensors"]
    out["object"] = hvd.broadcast_object({"from": rank}, root_rank=1)
    out["objects"] = hvd.allgather_object(("rank", rank))
    hvd.barrier()
    return out


def case_native_core(hvd, rank, world):
    """:func:`case_collectives` on the native core (the default), then
    again after a re-init under ``HOROVOD_TPU_NATIVE_CORE=0``; each run's
    results, the engine's plans as ``(sigs, threshold, buckets)`` (the
    planner the engine calls, wrapped), and which objects served it."""
    def run():
        eng = hvd.runtime._state().engine
        plan_fn, plans = eng._plan_fn, []

        def recording(sigs, threshold):
            buckets = plan_fn(sigs, threshold)
            plans.append((list(sigs), threshold, buckets))
            return buckets

        eng._plan_fn = recording
        out = case_collectives(hvd, rank, world)
        eng._plan_fn = plan_fn
        return {"out": out, "plans": plans,
                "objects": [type(eng._cache).__module__,
                            type(eng.stall._native).__module__,
                            getattr(eng.timeline._core, "__name__", None),
                            getattr(eng._controller._core, "__name__",
                                    None)],
                "planner": plan_fn.__module__ or type(plan_fn).__module__}

    on = run()
    hvd.shutdown()
    os.environ["HOROVOD_TPU_NATIVE_CORE"] = "0"
    try:
        hvd.init(device="cpu")
        off = run()
    finally:
        del os.environ["HOROVOD_TPU_NATIVE_CORE"]
    return {"on": on, "off": off}


def case_process_set(hvd, rank, world):
    """A subset process set (ranks 1 and world - 1): members reduce among
    themselves."""
    import torch
    ps = hvd.add_process_set(sorted({1, world - 1}))
    res = None
    if ps.included():
        res = _np(hvd.allreduce(torch.full((2,), float(rank + 1)),
                                op=hvd.Sum, process_set=ps))
    hvd.barrier()
    hvd.remove_process_set(ps)
    return {"sum": res, "ids": hvd.runtime.get_process_set_ids_and_ranks()}


def case_join(hvd, rank, world):
    """Uneven batches: rank r runs r + 1 allreduces, then joins; a joined
    rank contributes zeros.  Every rank's join returns the last joiner."""
    import torch
    sums = [_np(hvd.allreduce(torch.full((3,), float(rank + 1)), op=hvd.Sum,
                              name=f"step{i}"))
            for i in range(rank + 1)]
    last = hvd.join()
    return {"sums": sums, "last": last}


def case_divergence(hvd, rank, world):
    """One name with two shapes fails at once; names the other ranks never
    submit fail after the negotiation deadline; both on every rank, and
    the runtime still works after."""
    import torch
    from horovod_tpu_torch.ops.controller import DivergenceError
    out = {}
    try:
        hvd.allreduce(torch.ones(2 + rank), name="shape")
    except DivergenceError as e:
        out["shape"] = str(e)
    hvd.runtime._state().engine._controller.deadline_s = 1.0
    try:
        hvd.allreduce(torch.ones(2), name=f"only.{rank}")
    except DivergenceError as e:
        out["name"] = str(e)
    out["after"] = _np(hvd.allreduce(torch.ones(2), op=hvd.Sum, name="ok"))
    return out


def case_reinit(hvd, rank, world):
    """init → shutdown → init, then collectives again."""
    import torch
    first = _np(hvd.allreduce(torch.ones(1) * (rank + 1), op=hvd.Sum))
    hvd.shutdown()
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    second = _np(hvd.allreduce(torch.ones(1) * (rank + 1), op=hvd.Sum))
    return {"first": first, "second": second,
            "namespace": hvd.runtime._state().namespace}


def optimizer_data():
    rng = np.random.RandomState(0)
    X = rng.randn(8, 4).astype(np.float32)
    y = (X @ rng.randn(4, 1)).astype(np.float32)
    return X, y


def case_optimizer(hvd, rank, world):
    """3 SGD steps of DistributedOptimizer on this rank's shard of a batch
    of 8, after broadcasting rank 0's parameters and optimizer state."""
    import torch
    torch.manual_seed(42 + rank)   # ranks start apart; broadcast aligns
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    X, y = optimizer_data()
    n = 8 // world
    Xt = torch.from_numpy(X[rank * n:(rank + 1) * n])
    yt = torch.from_numpy(y[rank * n:(rank + 1) * n])
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(Xt), yt)
        loss.backward()
        opt.step()
        losses.append(hvd.allreduce(loss.detach(), name="loss").item())
    return {"losses": losses,
            "params": [_np(p) for p in model.parameters()]}


def case_dp_step(hvd, rank, world):
    """3 steps of make_llama_train_step with adamw_lp(3e-4) at dp = world
    on this rank's shard of the batch, for each config of
    ``dp_step.json``; the test process writes it, with the weights (JAX
    layout, flattened by path) and the batch, to ``$DP_STEP_DIR``.  A
    config's ``step_kw`` (``zero1``, ``grad_accum``, ``overlap``) goes to
    make_llama_train_step."""
    import torch
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.optim import precision
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    d = pathlib.Path(os.environ["DP_STEP_DIR"])
    out = {}
    for name, fields in json.loads((d / "dp_step.json").read_text()).items():
        step_kw = fields.pop("step_kw", {})
        data = np.load(d / f"{name}.npz")
        fields = dict(fields, dtype=getattr(torch, fields["dtype"]),
                      param_dtype=getattr(torch, fields["param_dtype"]))
        cfg = llama.LlamaConfig(**fields)
        tree = {"embed": data["embed"], "final_norm": data["final_norm"],
                "layers": {k.split(".", 1)[1]: data[k] for k in data.files
                           if k.startswith("layers.")}}
        params = convert.llama_params_from_numpy(tree, device="cpu")
        if rank % 2:
            # another leaf order: negotiation must pair the submissions
            params = _reversed_keys(params)
        ts = training.make_llama_train_step(
            cfg, optimizer=precision.adamw_lp(3e-4), device="cpu", **step_kw)
        opt_state = ts.opt_init(params)
        n = data["toks"].shape[0] // world
        toks = torch.from_numpy(data["toks"][rank * n:(rank + 1) * n])
        tgts = torch.from_numpy(data["tgts"][rank * n:(rank + 1) * n])
        losses = []
        for _ in range(3):
            params, opt_state, loss = ts.step_fn(params, opt_state, toks,
                                                 tgts)
            losses.append(loss.item())
        flat = convert.llama_params_to_numpy(params)
        out[name] = {"losses": losses, "order": tree_paths(params),
                     "params": dict(zip(tree_paths(flat),
                                        tree_leaves(flat))),
                     "state_bytes": precision.tree_nbytes(
                         list(opt_state.state.values())
                         if hasattr(opt_state, "state") else
                         list(opt_state.inner.state.values()))}
    return out


# -- the distributed optimizer (A5) ------------------------------------------
# the JAX package's tests/test_zero.py and tests/test_compression.py inputs:
# 35 and 3 elements, a 64-byte fusion threshold (two buckets), a 16-element
# scale block, so every bucket pads at every world size

ZTHRESHOLD = 64
ZBLOCK = 16
ZLR = 1e-2
#: name -> DistributedGradientTransform options, 4 steps each
DISTOPT_CONFIGS = {
    "replicated": {},
    "sharded": {"sharded_update": True},
    "k2": {"backward_passes_per_step": 2},
    "sharded_k2": {"sharded_update": True, "backward_passes_per_step": 2},
    "int8": {"wire_format": "int8"},
    "int8_sharded": {"wire_format": "int8", "sharded_update": True},
    "int8_k2": {"wire_format": "int8", "backward_passes_per_step": 2},
    "fp8_e4m3": {"wire_format": "fp8_e4m3"},
}


def zparams():
    return {"a": np.linspace(-1.0, 1.0, 35).reshape(7, 5).astype(np.float32),
            "b": np.arange(3, dtype=np.float32)}


def zgrads(rank, step):
    """Rank ``rank``'s gradients at ``step`` (tests/test_compression.py's
    ``_grad_stack`` row, scaled by 1 + step / 4)."""
    f = np.float32(1.0 + 0.25 * step)
    return {"a": np.sin(np.arange(35, dtype=np.float32) + rank)
            .reshape(7, 5) * f,
            "b": np.full((3,), float(rank + 1), np.float32) * f}


def wire_input(rank, n=37):
    """Rank ``rank``'s input of the quantized collectives: 37 elements
    (never a multiple of world x block) over six decades, one zero block."""
    rng = np.random.RandomState(7 + 100 * rank)
    x = (rng.randn(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    x[16:32] = 0.0
    return x


def wire_residual(rank, n=37):
    return (np.random.RandomState(9 + 100 * rank).randn(n) * 1e-2).astype(
        np.float32)


def _t(a):
    import torch
    return torch.from_numpy(np.array(a))


def _fp32_adamw_lp(lr):
    import torch
    from horovod_tpu_torch.optim import precision
    return precision.adamw_lp(lr, mu_dtype=torch.float32,
                              nu_dtype=torch.float32)


def case_wire(hvd, rank, world):
    """The quantized collectives per format (sum with error feedback,
    average, the sum-scatter of a padded buffer), and an eager allreduce
    through the engine under HOROVOD_COMPRESSION=int8 with
    HOROVOD_COMPRESSION_DCN_ONLY=0 (set by the test)."""
    from horovod_tpu_torch import compression
    from horovod_tpu_torch.ops import collectives
    ps = hvd.runtime._get_global_process_set()
    x, r0 = _t(wire_input(rank)), _t(wire_residual(rank))
    out = {}
    for name in compression.WIRE_FORMATS:
        fmt = compression.resolve_wire_format(name, ZBLOCK)
        s, res = collectives.quantized_allreduce(
            x, ps, fmt, op=hvd.Sum, residual=r0, error_feedback=True)
        avg, _ = collectives.quantized_allreduce(x, ps, fmt, op=hvd.Average)
        flat = torch_pad(x, world * ZBLOCK)
        tile, tres = collectives.quantized_sum_scatter(flat, ps, fmt,
                                                       error_feedback=True)
        out[name] = {"sum": _np(s), "res": _np(res), "avg": _np(avg),
                     "tile": _np(tile), "tile_res": _np(tres)}
    out["eager"] = _np(hvd.allreduce(x, op=hvd.Sum, name="eager.int8"))
    out["eager_avg"] = _np(hvd.allreduce(x, name="eager.int8.avg"))
    return out


def torch_pad(x, multiple):
    import torch
    pad = (-x.numel()) % multiple
    return torch.cat([x, x.new_zeros(pad)])


def case_distopt(hvd, rank, world):
    """4 steps of DistributedGradientTransform on :func:`zparams` for each
    of :data:`DISTOPT_CONFIGS`, this rank's gradients :func:`zgrads`; per
    config the parameters after each step, the inner state's bytes and
    whether the residual is carried."""
    from horovod_tpu_torch.optim import precision
    out = {}
    for name, kw in DISTOPT_CONFIGS.items():
        kw = dict({"wire_format": "none", "wire_block_size": ZBLOCK}, **kw)
        tx = hvd.DistributedGradientTransform(
            _fp32_adamw_lp(ZLR), threshold_bytes=ZTHRESHOLD, **kw)
        params = {k: _t(v) for k, v in zparams().items()}
        state = tx.init(params)
        traj = []
        for step in range(4):
            grads = {k: _t(v) for k, v in zgrads(rank, step).items()}
            state = tx.update(grads, state, params)
            traj.append({k: _np(v).copy() for k, v in params.items()})
        out[name] = {"traj": traj,
                     "state_bytes": precision.tree_nbytes(
                         list(state.inner.state.values())),
                     "residual": state.residual is not None}
    return out


# the spec plan at world 4 (data 2 x model 2): tests/test_fsdp_compose.py's
# awkward leaves, ``w`` sharded over the model axis on dim 0
SPEC_FULL = {"w": (8, 5), "b": (3,), "n": (6,)}
SPEC_SPECS = {"w": ("tp",), "b": (), "n": ()}
SPEC_STEPS, SPEC_K, SPEC_LR, SPEC_THRESHOLD = 4, 2, 1e-2, 64
SPEC_CONFIGS = {
    "plain": {},
    "sharded": {"sharded_update": True},
    # the same transforms with their specs from the mesh's context
    "context": {},
    "context_sharded": {"sharded_update": True},
    # the layer-aware plan of overlap=True, run at the step boundary
    "overlap": {"overlap": True},
    "overlap_sharded": {"overlap": True, "sharded_update": True},
}


def spec_params():
    """tests/test_fsdp_compose.py ``_full_params``."""
    rng = np.random.default_rng(7)
    return {k: np.asarray(rng.standard_normal(s) * 0.1, np.float32)
            for k, s in SPEC_FULL.items()}


def spec_grads():
    """tests/test_fsdp_compose.py ``_full_grads(4, 4)``: per step, every
    device's gradients ``[4, ...]`` (device ``d * 2 + m``)."""
    rng = np.random.default_rng(11)
    return [{k: (rng.standard_normal((4,) + s, dtype=np.float64)
                 * 1e-2).astype(np.float32) for k, s in SPEC_FULL.items()}
            for _ in range(SPEC_STEPS)]


def spec_rank_grads(step_grads, dp, tp):
    """Device ``(dp, tp)``'s gradients as the model hands them over: ``w``
    summed over the model axis (its gather's transpose) and cut to this
    rank's rows, the replicated leaves its own."""
    g = {k: v[dp * 2 + tp] for k, v in step_grads.items()}
    rows = SPEC_FULL["w"][0] // 2
    full_w = step_grads["w"][dp * 2] + step_grads["w"][dp * 2 + 1]
    g["w"] = full_w[tp * rows:(tp + 1) * rows]
    return g


def case_spec_plan(hvd, rank, world):
    """DistributedGradientTransform(param_specs=...) over MeshConfig(dp=2,
    tp=2), 4 steps of adamw_lp(1e-2) (bf16 moments) with k=2 and a
    64-byte threshold, per :data:`SPEC_CONFIGS`: the parameters after the
    steps, the inner state's bytes, the bytes each axis carried, and
    ``state_partition_specs`` of the sharded state."""
    from horovod_tpu_torch.optim import precision
    from horovod_tpu_torch.optim.distributed import state_partition_specs
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    pmesh = ParallelMesh(MeshConfig(dp=2, tp=2))
    dp, tp = pmesh.axis_index("dp"), pmesh.axis_index("tp")
    rows = SPEC_FULL["w"][0] // 2
    out = {"coords": (dp, tp)}
    for name, kw in SPEC_CONFIGS.items():
        common = dict(threshold_bytes=SPEC_THRESHOLD, wire_format="none",
                      backward_passes_per_step=SPEC_K, model_axes=("tp",),
                      **kw)
        if name.startswith("context"):
            with pmesh.with_param_specs(SPEC_SPECS):
                tx = hvd.DistributedGradientTransform(
                    precision.adamw_lp(SPEC_LR), **common)
            assert pmesh.param_specs is None     # scoped to the block
        else:
            tx = hvd.DistributedGradientTransform(
                precision.adamw_lp(SPEC_LR), param_specs=SPEC_SPECS,
                mesh=pmesh, **common)
        params = {k: _t(v) for k, v in spec_params().items()}
        params["w"] = params["w"][tp * rows:(tp + 1) * rows].clone()
        state = tx.init(params)
        ax.reset_bytes()
        for g in spec_grads():
            state = tx.update({k: _t(v) for k, v in
                               spec_rank_grads(g, dp, tp).items()},
                              state, params)
        out[name] = {"params": {k: _np(v).copy() for k, v in
                                params.items()},
                     "state_bytes": precision.tree_nbytes(
                         list(state.inner.state.values())),
                     "bytes": dict(ax.BYTES)}
        if name == "sharded":
            out[name]["partition"] = state_partition_specs(
                state, "dp", sharded_update=True)
            out[name]["tiles"] = [t.numel() for t in state.tiles]
    return out


SPEC_LLAMA_STEPS, SPEC_LLAMA_LR, SPEC_LLAMA_BATCH = 3, 0.05, (8, 16)


def spec_llama_batch():
    """(tokens, targets) of the global batch of :func:`case_spec_llama`."""
    rng = np.random.RandomState(21)
    return tuple(rng.randint(0, 256, SPEC_LLAMA_BATCH).astype(np.int64)
                 for _ in range(2))


def case_spec_llama(hvd, rank, world):
    """The tiny fp32 Llama over MeshConfig(dp=2, tp=2) (vocab_parallel
    off) trained by SGD through DistributedGradientTransform(
    param_specs=llama.param_specs(par, cfg)) on the gradients as the
    model gives them: with ``model_axes=()`` for 3 steps (``dp_only``)
    and with the model axes inferred from the specs (tp) for 1
    (``inferred``); the full parameters after the steps, gathered over
    tp, and the bytes each axis carried."""
    import torch
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.tree import tree_leaves, tree_map, tree_paths
    cfg = llama.tiny()
    pmesh = ParallelMesh(MeshConfig(dp=2, tp=2))
    ts = training.make_llama_train_step(cfg, pmesh, device="cpu")
    specs = llama.param_specs(ts.par, cfg)
    toks, tgts = (ts.shard_batch(torch.from_numpy(x))
                  for x in spec_llama_batch())
    out = {}
    for name, model_axes, steps in (("dp_only", (), SPEC_LLAMA_STEPS),
                                    ("inferred", None, 1)):
        params, _ = ts.init_fn(0)
        leaves = training.trainable_leaves(params)
        tx = hvd.DistributedGradientTransform(
            functools.partial(torch.optim.SGD, lr=SPEC_LLAMA_LR),
            param_specs=specs, model_axes=model_axes, mesh=pmesh,
            wire_format="none")
        state = tx.init(params)
        t_bytes = {}
        for _ in range(steps):
            with pmesh:
                loss = llama.loss_fn(params, toks, tgts, cfg, ts.par)
                g = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(g), params)
            b0 = dict(ax.BYTES)
            tx.update(grads, state, params)
            for k, v in ax.BYTES.items():
                t_bytes[k] = t_bytes.get(k, 0) + v - b0.get(k, 0)
        full = convert.llama_gather_params(params, cfg, pmesh, ts.par)
        out[name] = {"params": {p: _np(t.detach()).copy() for p, t in
                                zip(tree_paths(full), tree_leaves(full))},
                     "bytes": {k: v for k, v in t_bytes.items() if v}}
    return out


def case_tracing(hvd, rank, world):
    """Three grouped allreduces through the engine with negotiation, this
    rank named host ``host<rank>``: its span buffer's snapshot, the
    engine's counters and one clock sample."""
    import torch
    from horovod_tpu_torch import tracing
    eng = hvd.runtime._state().engine
    st0 = eng.stats()
    tracing.buffer().clear()
    tracing.set_identity(host=f"host{rank}")
    for i in range(3):
        hvd.grouped_allreduce([torch.full((4,), float(rank)),
                               torch.ones(3)], name=f"trace{i}")
    # the cycle span closes after the handles resolve: wait for it
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and sum(
            s["cat"] == "cycle" for s in tracing.buffer().snapshot()[
                "spans"]) < eng.stats()["cycles"] - st0["cycles"]:
        time.sleep(0.01)
    st = eng.stats()
    return {"snapshot": tracing.buffer().snapshot(),
            **{k: st[k] - st0[k] for k in ("cycles", "executes",
                                           "buckets")}}


def case_step_spans(hvd, rank, world):
    """Two steps of a tiny data-parallel Llama (the engine's gradient
    plane): the span ring's snapshot once every cycle span is in."""
    import torch
    from horovod_tpu_torch import tracing, training
    from horovod_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=64,
                            max_seq_len=16, dtype=torch.float32,
                            param_dtype=torch.float32)
    ts = training.make_llama_train_step(cfg, device="cpu")
    params, opt = ts.init_fn(0)
    gen = torch.Generator().manual_seed(rank)
    toks = torch.randint(0, 64, (2, 16), generator=gen)
    eng = hvd.runtime._state().engine
    tracing.buffer().clear()
    c0 = eng.stats()["cycles"]
    for _ in range(2):
        ts.step_fn(params, opt, toks, toks)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and sum(
            s["cat"] == "cycle" for s in tracing.buffer().snapshot()[
                "spans"]) < eng.stats()["cycles"] - c0:
        time.sleep(0.01)
    return {"snapshot": tracing.buffer().snapshot()}


# the overlap toy: tests/test_overlap.py's model with its layers unstacked
TOY_L, TOY_D, TOY_V = 3, 8, 5
OVERLAP_CONFIGS = {
    "plain": {},
    "sharded": {"sharded_update": True},
    "int8": {"wire_format": "int8"},
    "int8_sharded": {"wire_format": "int8", "sharded_update": True},
}


def toy_params():
    """tests/test_overlap.py ``_toy_params``: embed, layers w and b
    (stacked [L, ...] there), final_norm."""
    rng = np.random.default_rng(0)
    return {"embed": rng.standard_normal((TOY_V, TOY_D)).astype(np.float32),
            "layers": {"w": (rng.standard_normal((TOY_L, TOY_D, TOY_D))
                             * 0.1).astype(np.float32),
                       "b": np.zeros((TOY_L, TOY_D), np.float32)},
            "final_norm": np.ones((TOY_D,), np.float32)}


def toy_batches(world, steps, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((world, 2, 5)).astype(np.float32)
            for _ in range(steps)]


def toy_loss(params, x):
    from horovod_tpu_torch.optim import overlap as ov
    params = ov.tap_root(params)
    h = x @ params["embed"]
    for lp in params["layers"]:
        lp = ov.grad_tap(lp)
        h = (h @ lp["w"] + lp["b"]).tanh()
    return ((h * params["final_norm"]) ** 2).sum()


def _toy_torch_params():
    t = toy_params()
    return {"embed": _t(t["embed"]).requires_grad_(),
            "layers": [{"w": _t(t["layers"]["w"][i]).requires_grad_(),
                        "b": _t(t["layers"]["b"][i]).requires_grad_()}
                       for i in range(TOY_L)],
            "final_norm": _t(t["final_norm"]).requires_grad_()}


def _toy_traj(hvd, tx, rank, xs, mode):
    """Steps of ``tx`` on the toy from :func:`toy_params`; ``mode`` armed
    (grad taps in overlapped_backprop, with the accumulation count),
    unarmed (the boundary path) or off (a transform without overlap)."""
    import torch
    from horovod_tpu_torch.tree import tree_leaves, tree_map
    params = _toy_torch_params()
    state = tx.init(params)
    leaves = tree_leaves(params)
    for xb in xs:
        x = _t(xb[rank])
        if mode == "armed":
            with hvd.overlapped_backprop(tx, **({"count": state.count}
                                                if tx_k(tx) > 1 else {})):
                grads = torch.autograd.grad(toy_loss(params, x), leaves,
                                            allow_unused=True)
        else:
            grads = torch.autograd.grad(toy_loss(params, x), leaves)
        it = iter(grads)
        tx.update(tree_map(lambda _: next(it), params), state, params)
    return {"embed": _np(params["embed"]),
            "final_norm": _np(params["final_norm"]),
            "w": np.stack([_np(lp["w"]) for lp in params["layers"]]),
            "b": np.stack([_np(lp["b"]) for lp in params["layers"]])}


def tx_k(tx):
    from horovod_tpu_torch.optim import overlap as ov
    try:
        return ov.plan_for(tx).k
    except ValueError:
        return 1


def case_overlap(hvd, rank, world):
    """The toy under DistributedGradientTransform(overlap=True) per
    :data:`OVERLAP_CONFIGS`, armed and unarmed, 3 steps; the same with
    backward_passes_per_step=2 (4 steps, plain and sharded) against the
    non-overlapped transform; and DistributedOptimizer's hook dispatch."""
    import torch
    out = {}
    xs = toy_batches(world, 3, 1)
    for name, kw in OVERLAP_CONFIGS.items():
        kw = dict({"wire_format": "none", "wire_block_size": ZBLOCK}, **kw)
        for mode in ("armed", "unarmed"):
            tx = hvd.DistributedGradientTransform(
                _fp32_adamw_lp(ZLR), threshold_bytes=256, overlap=True, **kw)
            out[f"{name}.{mode}"] = _toy_traj(hvd, tx, rank, xs, mode)
    tx = hvd.DistributedGradientTransform(
        _fp32_adamw_lp(ZLR), threshold_bytes=256, overlap=False,
        wire_format="none")
    out["off"] = _toy_traj(hvd, tx, rank, xs, "off")
    # the plan's tiles three ways: scattered, carved from the placed
    # (zero-filled) scatter, and this rank's slice of the summed tree
    from horovod_tpu_torch.optim import overlap as ov
    tx = hvd.DistributedGradientTransform(
        _fp32_adamw_lp(ZLR), threshold_bytes=256, overlap=True,
        sharded_update=True, op=hvd.Sum, wire_format="none")
    tx.init(_toy_torch_params())
    plan = ov.plan_for(tx)
    grads = {k: (_t(v) * (rank + 1)) if not isinstance(v, dict) else
             [{"w": _t(v["w"][i]) * (rank + 1), "b": _t(v["b"][i]) + rank}
              for i in range(TOY_L)] for k, v in toy_params().items()}
    scattered = ov.scatter_tiles(grads, plan, plan.layout)[0]
    carved = ov.carve_tiles(ov.scatter_place(grads, plan), plan,
                            plan.layout)[0]
    out["tiles"] = {"scattered": [_np(t).copy() for t in scattered],
                    "carved": [_np(t).copy() for t in carved],
                    "gathered": {k: _np(v).copy() if not isinstance(v, list)
                                 else [{n: _np(x).copy() for n, x in
                                        lp.items()} for lp in v]
                                 for k, v in ov.gather_updates(
                                     scattered, plan.layout, plan).items()}}
    xs4 = toy_batches(world, 4, 2)
    for sharded in (False, True):
        tx = hvd.DistributedGradientTransform(
            _fp32_adamw_lp(ZLR), threshold_bytes=256, overlap=True,
            backward_passes_per_step=2, sharded_update=sharded,
            wire_format="none")
        out[f"k2.{sharded}"] = _toy_traj(hvd, tx, rank, xs4, "armed")
    tx = hvd.DistributedGradientTransform(
        _fp32_adamw_lp(ZLR), threshold_bytes=256, overlap=False,
        backward_passes_per_step=2, wire_format="none")
    out["k2.off"] = _toy_traj(hvd, tx, rank, xs4, "off")
    # DistributedOptimizer: hooks issue the same plan's buckets
    from horovod_tpu_torch.optim import precision
    for ov_on in (False, True):
        params = _toy_torch_params()
        named = [("embed", params["embed"]),
                 ("final_norm", params["final_norm"])] + [
            (f"layers.{i}.{k}", lp[k]) for i, lp in enumerate(
                params["layers"]) for k in ("w", "b")]
        opt = hvd.DistributedOptimizer(
            precision.AdamWLP([p for _, p in named], lr=ZLR,
                              mu_dtype=torch.float32,
                              nu_dtype=torch.float32),
            named_parameters=named, threshold_bytes=256, overlap=ov_on,
            wire_format="none")
        for xb in xs:
            opt.zero_grad()
            loss = toy_loss(params, _t(xb[rank]))
            loss.backward()
            opt.step()
        out[f"distopt.{ov_on}"] = {
            "embed": _np(params["embed"]),
            "final_norm": _np(params["final_norm"]),
            "w": np.stack([_np(lp["w"]) for lp in params["layers"]]),
            "b": np.stack([_np(lp["b"]) for lp in params["layers"]])}
    return out


# -- the classifier models (A6) ---------------------------------------------

SBN_C = 5
SBN_BATCH = 8
SBN_STEPS = 2
#: hvd.SyncBatchNorm options, each held against torch.nn.BatchNorm2d
SBN_CONFIGS = {
    "affine": {},
    "no_affine": {"affine": False},
    "cumulative": {"momentum": None},
    "untracked": {"track_running_stats": False},
}


def sbn_batch(step):
    """Step ``step``'s global batch ``[8, C, 3, 3]``, each channel with its
    own offset and spread, and the upstream gradient."""
    rng = np.random.RandomState(30 + step)
    x = (rng.randn(SBN_BATCH, SBN_C, 3, 3)
         * rng.uniform(0.5, 2.0, (1, SBN_C, 1, 1))
         + rng.randn(1, SBN_C, 1, 1)).astype(np.float32)
    return x, rng.randn(SBN_BATCH, SBN_C, 3, 3).astype(np.float32)


def sbn_affine():
    """(weight, bias) of the affine configs."""
    return (np.linspace(0.5, 1.5, SBN_C).astype(np.float32),
            np.linspace(-1.0, 1.0, SBN_C).astype(np.float32))


def _rows(rank, world, n):
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def case_sync_bn(hvd, rank, world):
    """hvd.SyncBatchNorm on this rank's rows of :func:`sbn_batch`, per
    :data:`SBN_CONFIGS`: SBN_STEPS training steps (output, input and
    parameter gradients of ``sum(y * g)``, running statistics), then eval;
    and the functional ``sync_batch_norm`` over the global process set,
    train (with gradients) and eval."""
    import torch
    from horovod_tpu_torch.ops.sync_batch_norm import sync_batch_norm
    rows = _rows(rank, world, SBN_BATCH)
    out = {}
    for name, kw in SBN_CONFIGS.items():
        m = hvd.SyncBatchNorm(SBN_C, **kw)
        if m.affine:
            w, b = sbn_affine()
            with torch.no_grad():
                m.weight.copy_(_t(w))
                m.bias.copy_(_t(b))
        steps = []
        for step in range(SBN_STEPS):
            xg, gg = sbn_batch(step)
            x = _t(xg[rows]).requires_grad_()
            y = m(x)
            (y * _t(gg[rows])).sum().backward()
            rec = {"y": _np(y), "dx": _np(x.grad)}
            if m.affine:
                rec.update(dw=_np(m.weight.grad).copy(),
                           db=_np(m.bias.grad).copy())
                m.zero_grad()
            if m.track_running_stats:   # copies: the buffers change in place
                rec.update(mean=_np(m.running_mean).copy(),
                           var=_np(m.running_var).copy())
            steps.append(rec)
        m.eval()
        out[name] = {"steps": steps,
                     "eval": _np(m(_t(sbn_batch(SBN_STEPS)[0][rows])))}
    ps = hvd.runtime._get_global_process_set()
    xg, gg = sbn_batch(0)
    w, b = sbn_affine()
    x, scale, bias = (_t(xg[rows]).requires_grad_(), _t(w).requires_grad_(),
                      _t(b).requires_grad_())
    rm, rv = _t(np.full(SBN_C, 0.5, np.float32)), _t(np.full(SBN_C, 2.0,
                                                             np.float32))
    y, mean, var = sync_batch_norm(x, scale, bias, rm, rv, process_set=ps)
    (y * _t(gg[rows])).sum().backward()
    y_eval = sync_batch_norm(x.detach(), scale.detach(), bias.detach(),
                             mean, var, process_set=ps, train=False)[0]
    out["functional"] = {"y": _np(y), "mean": _np(mean), "var": _np(var),
                         "dx": _np(x.grad), "dscale": _np(scale.grad),
                         "dbias": _np(bias.grad), "eval": _np(y_eval)}
    return out


def resnet_cfg():
    import torch
    from horovod_tpu_torch.models import resnet
    return resnet.ResNetConfig(variant=18, num_classes=10, width=8,
                               dtype=torch.float32)


CLS_BATCH = 8
CLS_STEPS = 2


def classifier_batch(step, img=32):
    rng = np.random.RandomState(40 + step)
    return (rng.randn(CLS_BATCH, 3, img, img).astype(np.float32),
            rng.randint(0, 10, CLS_BATCH).astype(np.int64))


def resnet_step(device, sync_bn=True):
    """The port's classifier step over ResNet-18 at width 8 (its mesh: the
    runtime's when initialized) and its initial weights from seed 0."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import resnet
    cfg = resnet_cfg()
    return training.make_classifier_train_step(
        lambda p, s, x, train, process_set: resnet.forward(
            p, s, x, cfg, train=train, process_set=process_set),
        lambda seed: resnet.init(cfg, seed, device=device),
        sync_bn=sync_bn, device=device)


def case_classifier(hvd, rank, world):
    """The ResNet classifier step at dp = world on this rank's rows of
    :func:`classifier_batch`: CLS_STEPS steps with sync_bn=True (losses,
    accuracies, parameters and state after), and one with sync_bn=False
    (the state after it)."""
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    rows = _rows(rank, world, CLS_BATCH)

    def flat(tree):
        return {p: _np(t).copy() for p, t in zip(tree_paths(tree),
                                                 tree_leaves(tree))}

    out = {}
    for sync_bn, steps in ((True, CLS_STEPS), (False, 1)):
        ts = resnet_step("cpu", sync_bn)
        params, state, opt_state = ts.init_fn(0)
        losses, accs = [], []
        for step in range(steps):
            x, y = classifier_batch(step)
            params, state, opt_state, loss, acc = ts.step_fn(
                params, state, opt_state, _t(x[rows]), _t(y[rows]))
            losses.append(loss.item())
            accs.append(acc.item())
        out[f"sync_bn={sync_bn}"] = {"losses": losses, "accuracy": accs,
                                     "params": flat(params),
                                     "state": flat(state)}
    return out


def bert_cfg():
    from horovod_tpu_torch.models import bert
    return bert.tiny(vocab=64, seq=16)


BERT_BATCH = 8
BERT_STEPS = 3


def bert_batch(step):
    rng = np.random.RandomState(50 + step)
    return (rng.randint(0, 64, (BERT_BATCH, 16)).astype(np.int64),
            rng.randint(0, 2, BERT_BATCH).astype(np.int64))


#: name -> mesh of each BERT model-parallel run, by world
BERT_MP_MESHES = {2: {"tp2": {"tp": 2}, "sp2": {"sp": 2}},
                  4: {"sp2_tp2": {"sp": 2, "tp": 2}}}


def case_bert_mp(hvd, rank, world):
    """BERT's encoder (and, without sp, its classifier) over each mesh of
    :data:`BERT_MP_MESHES` at ``world``, from the JAX weights in
    ``$BERT_MP_DIR`` cut by convert.bert_shard_params, on this rank's
    sequence block: the hidden states, the logits, and the gradients of
    sum(h · cotangent) over the block (plus sum(logits · cotangent)) by
    leaf path; the gather round trip and the refusals."""
    import torch
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.models.llama import ParallelSpec
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    d = pathlib.Path(os.environ["BERT_MP_DIR"])
    spec = json.loads((d / "bert_mp.json").read_text())
    cfg = bert.BertConfig(**dict(spec["cfg"], dtype=torch.float32,
                                 param_dtype=torch.float32))
    data = np.load(d / "weights.npz")
    tree = {k: data[k] for k in data.files if not k.startswith("layers.")}
    tree["layers"] = {k.split(".", 1)[1]: data[k] for k in data.files
                      if k.startswith("layers.")}
    full = convert.bert_params_from_numpy(tree, device="cpu")
    io = np.load(d / "inputs.npz")
    out = {}
    for name, axes in BERT_MP_MESHES[world].items():
        pmesh = ParallelMesh(MeshConfig(**axes))
        par = ParallelSpec(tp_axis="tp" if "tp" in axes else None,
                           sp_axis="sp" if "sp" in axes else None)
        params = convert.bert_shard_params(full, cfg, pmesh, par)
        back = convert.bert_gather_params(params, cfg, pmesh, par)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        sp, i = pmesh.axis_size("sp"), pmesh.axis_index("sp")
        t = io["toks"].shape[1] // sp
        block = slice(i * t, (i + 1) * t)
        toks = torch.from_numpy(io["toks"][:, block]).long()
        with pmesh:
            h = bert.encode(params, toks, cfg, par)
            loss = (h * torch.from_numpy(io["cot"][:, block])).sum()
            logits = None
            if par.sp_axis is None:
                logits = bert.classify(params, toks, cfg, par)
                loss = loss + (logits * torch.from_numpy(
                    io["cot_logits"])).sum()
            loss.backward()
        out[name] = {
            "h": _np(h), "logits": None if logits is None else _np(logits),
            "grads": {p: _np(t.grad if t.grad is not None
                             else torch.zeros_like(t))
                      for p, t in zip(tree_paths(params),
                                      tree_leaves(params))},
            "round_trip": all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(back), tree_leaves(full)))}
    return out


def case_bert_overlap(hvd, rank, world):
    """BERT tiny at dp = world on this rank's rows of :func:`bert_batch`,
    BERT_STEPS steps from seed 0: make_dp_finetune_step(reduce_grads=True)
    and the same model under overlapped_backprop with an overlapped
    DistributedGradientTransform; the losses and parameters of each."""
    import torch
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.tree import tree_leaves, tree_map, tree_paths
    cfg = bert_cfg()
    rows = _rows(rank, world, BERT_BATCH)
    batches = [tuple(_t(a[rows]) for a in bert_batch(s))
               for s in range(BERT_STEPS)]

    def flat(tree):
        return {p: _np(t).copy() for p, t in zip(tree_paths(tree),
                                                 tree_leaves(tree))}

    ts = bert.make_dp_finetune_step(cfg, bert.finetune_optimizer,
                                    reduce_grads=True)
    params, opt_state = ts.init_fn(0)
    plain = []
    for toks, labels in batches:
        params, opt_state, loss = ts.step_fn(params, opt_state, toks,
                                             labels)
        plain.append(loss.item())
    out = {"plain": {"losses": plain, "params": flat(params)}}

    tx = hvd.DistributedGradientTransform(bert.finetune_optimizer,
                                          overlap=True)
    params = bert.init_params(cfg, 0, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    state = tx.init(params)
    losses = []
    for toks, labels in batches:
        with hvd.overlapped_backprop(tx):
            loss = bert.loss_fn(params, toks, labels, cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(grads)
        tx.update(tree_map(lambda _: next(it), params), state, params)
        losses.append(hvd.allreduce(loss.detach(), name="loss").item())
    out["overlap"] = {"losses": losses, "params": flat(params)}
    return out


def _reversed_keys(tree):
    if isinstance(tree, dict):
        return {k: _reversed_keys(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, list):
        return [_reversed_keys(v) for v in tree]
    return tree


def case_elastic_state(hvd, rank, world):
    """TensorState and TorchState: rank-dependent values, then sync (rank
    0's in place everywhere) and restore (back to the synced commit)."""
    import torch
    from horovod_tpu_torch.elastic import TensorState, TorchState
    w = torch.nn.Parameter(torch.full((3,), float(rank + 1)))
    bn = {"mean": torch.full((2,), 10.0 * (rank + 1))}
    buf = [torch.full((3,), -1.0 * rank)]
    st = TensorState(params={"w": w}, state=bn, opt_state=buf, step=rank,
                     tag=f"r{rank}")
    st.sync()
    same = (st.params["w"] is w and st.state["mean"] is bn["mean"]
            and st.opt_state[0] is buf[0])
    tensor = [_np(w).tolist(), _np(bn["mean"]).tolist(),
              _np(buf[0]).tolist()]
    scalars = dict(st._scalar_state)
    with torch.no_grad():
        w.add_(5.0)
    st.restore()
    restored = bool(torch.equal(w.detach(), torch.ones(3)))
    torch.manual_seed(rank)
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if rank == 0:
        model(torch.ones(1, 2)).sum().backward()
        opt.step()
    ts = TorchState(model=model, optimizer=opt, epoch=rank)
    ts.sync()
    torch_vals = {k: _np(v).tolist() for k, v in model.state_dict().items()}
    torch_vals["momentum"] = [
        _np(s["momentum_buffer"]).tolist()
        for _, s in sorted(opt.state_dict()["state"].items())]
    torch_vals["epoch"] = ts.epoch
    return {"tensor": tensor, "scalars": scalars, "same_objects": same,
            "restored": restored, "torch": torch_vals}


def case_checkpoint(hvd, rank, world):
    """checkpoint.save (rank 0 writes), an asynchronous save, a forced
    overwrite, latest_step and restore onto another dtype, on every rank;
    the directory is HVD_TEST_CKPT."""
    import torch
    from horovod_tpu_torch import checkpoint
    d = os.environ["HVD_TEST_CKPT"]

    def tree(v):
        return {"w": torch.full((2, 3), v),
                "layers": [{"b": torch.arange(4, dtype=torch.bfloat16) + v}],
                "step": int(v)}

    checkpoint.save(d, tree(float(rank)), step=1)
    checkpoint.save(d, tree(10.0 + rank), step=2, asynchronous=True)
    checkpoint.wait()
    latest = checkpoint.latest_step(d)
    checkpoint.save(d, tree(20.0 + rank), step=1, force=True)
    like = {"w": torch.zeros(2, 3, dtype=torch.float64),
            "layers": [{"b": torch.zeros(4, dtype=torch.bfloat16)}],
            "step": 0}
    out = {"latest": latest}
    for step in (1, 2):
        r = checkpoint.restore(d, like, step=step)
        out[step] = {"w": _np(r["w"]).tolist(), "w_dtype": str(r["w"].dtype),
                     "b": _np(r["layers"][0]["b"]).tolist(),
                     "b_dtype": str(r["layers"][0]["b"].dtype),
                     "step": r["step"]}
    return out


def case_sharded_loader(hvd, rank, world):
    """This rank's ShardedLoader batches (plain and asynchronous)."""
    from horovod_tpu_torch.data import AsyncDataLoaderMixin, ShardedLoader

    class AsyncSharded(AsyncDataLoaderMixin, ShardedLoader):
        pass

    x, y = loader_data()
    plain = [[_np(a).tolist() for a in b]
             for b in ShardedLoader((x, y), global_batch_size=16)]
    prefetched = [[_np(a).tolist() for a in b] for b in AsyncSharded(
        (x, y), global_batch_size=16, async_loader_queue_size=2)]
    return {"plain": plain, "async": prefetched}


def loader_data():
    return (np.arange(64, dtype=np.float32).reshape(32, 2),
            np.arange(32, dtype=np.int32))


# -- the hierarchy, the tail policies, Adasum and the engine's tools ---------

#: a world of 4 as two hosts of two, both hierarchical paths on, and the
#: wire's 16-element scale block (test_torch_wire.py's bounds)
HIER_ENV = {"HOROVOD_LOCAL_SIZE": "2", "HOROVOD_CROSS_SIZE": "2",
            "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
            "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
            "HOROVOD_COMPRESSION_BLOCK_SIZE": str(ZBLOCK)}
#: the tail cases' deadline and straggler delay (s)
TAIL_DEADLINE_MS = 50
TAIL_DELAY_S = 0.2
#: the tail arithmetic's chunk length
TAIL_CHUNK = 8


def hier_input(rank, n=37, seed=11):
    """Rank ``rank``'s seeded fp32 vector (37: not a multiple of the host
    size, so the hierarchical path pads)."""
    return np.random.RandomState(seed + 100 * rank).randn(n).astype(
        np.float32)


def quarter_input(rank, n=12):
    """Multiples of 1/4: exact in every sum and n/k correction here."""
    return base("float32", rank, (n,), seed=5)


def adasum_input(rank, n=11):
    """Rank ``rank``'s Adasum contribution: seeded, with rank 1 a zero
    vector and rank 3 parallel to rank 0 (the tree's guarded cases)."""
    if rank == 1:
        return np.zeros(n, np.float32)
    if rank == 3:
        return 2.5 * adasum_input(0, n)
    return np.random.RandomState(23 + 100 * rank).randn(n).astype(np.float32)


def adasum_params():
    return {"a": np.linspace(-1.0, 1.0, 35).reshape(7, 5).astype(np.float32),
            "b": np.arange(3, dtype=np.float32),
            "c": np.linspace(0.5, 2.0, 4).astype(np.float32)}


def adasum_grads(rank):
    """Rank ``rank``'s gradients of :func:`adasum_params`; ``c`` is bf16
    on the port's side, so the whole vector mixes dtypes."""
    rng = np.random.RandomState(31 + 100 * rank)
    return {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in adasum_params().items()}


def _reinit(hvd, **env):
    """shutdown, then ``env`` set (None unsets), then init on the CPU."""
    hvd.shutdown()
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    hvd.init(device="cpu")


def _counter(name, **labels):
    from horovod_tpu_torch import metrics
    fam = metrics.snapshot().get("families", {}).get(name, {})
    return sum(s["value"] for s in fam.get("series", ())
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _tensors_to_np(d):
    import torch
    return {k: (_np(v) if torch.is_tensor(v) else v) for k, v in d.items()}


def case_hier(hvd, rank, world):
    """The hierarchical allreduce (Sum, Average, scaled, the pad path, a
    fused bucket) and allgather through the engine at (2, 2), then the
    int8 cross stage under HOROVOD_COMPRESSION=int8."""
    from horovod_tpu_torch.ops import collectives
    ps = hvd.runtime._get_global_process_set()
    local, cross = ps.hier_groups()
    x = _t(hier_input(rank))
    before = _counter("hvd_tail_rounds_total", policy="strict")
    out = {"shape": ps.hier_shape(), "local": local.ranks,
           "cross": cross.ranks,
           "sum": hvd.allreduce(x, op=hvd.Sum, name="h.sum"),
           "avg": hvd.allreduce(x, name="h.avg"),
           "scaled": hvd.allreduce(x, op=hvd.Average, prescale_factor=0.5,
                                   postscale_factor=4.0, name="h.scaled")}
    out["grp0"], out["grp1"] = hvd.grouped_allreduce(
        [x[:12].reshape(3, 4), x[12:]], op=hvd.Sum, name="h.grp")
    out["ag"] = hvd.allgather(_t(hier_input(rank, 6)).reshape(3, 2),
                              name="h.ag")
    out["agv"] = hvd.allgather(
        _t(hier_input(rank, 2 * (rank + 1))).reshape(rank + 1, 2),
        name="h.agv")
    out["strict_rounds"] = (_counter("hvd_tail_rounds_total",
                                     policy="strict") - before)
    # the test hook: a forced (4, 1) layout, its groups made at first use
    ps._hier_shape = (4, 1)
    out["forced"] = hvd.allreduce(_t(quarter_input(rank)), op=hvd.Sum,
                                  name="h.forced")
    out["forced_cross"] = ps.hier_groups()[1].ranks
    ps._hier_shape = None
    wire0 = _counter("hvd_wire_bytes_total", format="int8")
    _reinit(hvd, HOROVOD_COMPRESSION="int8")
    out["int8"] = hvd.allreduce(_t(hier_input(rank, 64)), op=hvd.Sum,
                                name="h.int8")
    out["int8_wire_bytes"] = (_counter("hvd_wire_bytes_total",
                                       format="int8") - wire0)
    _reinit(hvd, HOROVOD_COMPRESSION=None)
    return _tensors_to_np(out)


def case_tail(hvd, rank, world):
    """The cross stage's policies on known chunks at (2, 2) (bounded under
    each mask, a mask two ranks drew differently, three stale rounds up
    to the cap), then the engine under HOROVOD_TAIL_POLICY=bounded and
    stale with host 1 delayed past the deadline."""
    import time
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.ops import collectives as C
    ps = hvd.runtime._get_global_process_set()
    _, cross = ps.hier_groups()
    chunk = _t(hier_input(rank, TAIL_CHUNK, seed=41))
    out = {"strict": C.tail_cross_reduce(chunk, cross, "strict")[0]}
    for mask in ((1, 1), (1, 0), (0, 1)):
        out[f"bounded{mask}"] = C.tail_cross_reduce(
            chunk, cross, "bounded", list(mask), ps)[0]
    # rank 3 alone saw host 0 late: the agreement excludes it everywhere
    out["agreed"] = C.tail_cross_reduce(
        chunk, cross, "bounded", [0, 1] if rank == 3 else [1, 1], ps)[0]
    prev = chunk.new_zeros((2, TAIL_CHUNK))
    stal = [0, 0]
    for i, (add, mask) in enumerate(((0.0, (1, 1)), (100.0, (1, 0)),
                                     (1000.0, (1, 0)))):
        red, prev, stal = C.tail_cross_reduce(
            chunk + add, cross, "stale", list(mask), ps, prev=prev,
            staleness=stal, max_staleness=1)
        out[f"stale{i}"], out[f"staleness{i}"] = red, stal.tolist()
    late = chaos.FaultSchedule.parse(
        f"collective.dcn group=1 action=delay:{TAIL_DELAY_S}")
    x = _t(quarter_input(rank))
    for policy in ("bounded", "stale"):
        _reinit(hvd, HOROVOD_TAIL_POLICY=policy,
                HOROVOD_TAIL_DEADLINE_MS=str(TAIL_DEADLINE_MS),
                HOROVOD_TAIL_MAX_STALENESS="1")
        n0 = _counter("hvd_tail_rounds_total", policy=policy)
        res = [hvd.allreduce(x, op=hvd.Sum, name=f"t.{policy}")]
        chaos.install(late)
        try:
            t0 = time.monotonic()
            for k in (2, 3):
                res.append(hvd.allreduce(x * k, op=hvd.Sum,
                                         name=f"t.{policy}"))
            seconds = time.monotonic() - t0
        finally:
            chaos.uninstall()
        out[policy] = {
            "results": [_np(r) for r in res], "seconds": seconds,
            "rounds": [dict(r) for r in C.TAIL_ROUNDS],
            "counted": _counter("hvd_tail_rounds_total",
                                policy=policy) - n0,
            "scores": hvd.runtime._state().stall_inspector
            .straggler_scores()}
    _reinit(hvd, HOROVOD_TAIL_POLICY=None, HOROVOD_TAIL_DEADLINE_MS=None,
            HOROVOD_TAIL_MAX_STALENESS=None)
    return _tensors_to_np(out)


def case_adasum(hvd, rank, world):
    """Eager Adasum (one tensor, scaled, a fused group) and one SGD step
    of DistributedOptimizer(op=Adasum), with the refusals."""
    import torch
    x = _t(adasum_input(rank))
    out = {"eager": hvd.allreduce(x, op=hvd.Adasum, name="ad"),
           "scaled": hvd.allreduce(x, op=hvd.Adasum, prescale_factor=0.5,
                                   postscale_factor=3.0, name="ad.scaled")}
    out["grp0"], out["grp1"] = hvd.grouped_allreduce(
        [x[:4], x[4:]], op=hvd.Adasum, name="ad.grp")
    params = {k: torch.nn.Parameter(_t(v).to(
        torch.bfloat16 if k == "c" else torch.float32))
        for k, v in adasum_params().items()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params.values(), lr=ZLR),
                                   named_parameters=params.items(),
                                   op=hvd.Adasum)
    for k, g in adasum_grads(rank).items():
        params[k].grad = _t(g).to(params[k].dtype)
    opt.synchronize()
    out["reduced"] = {k: _np(p.grad) for k, p in params.items()}
    with opt.skip_synchronize():
        opt.step()
    out["params"] = {k: _np(p) for k, p in params.items()}
    refusals = {}
    for what, make in (
            ("wire", lambda: hvd.DistributedGradientTransform(
                lambda ls: torch.optim.SGD(ls, lr=0.1), op=hvd.Adasum,
                wire_format="int8")),
            ("sharded", lambda: hvd.DistributedGradientTransform(
                lambda ls: torch.optim.SGD(ls, lr=0.1), op=hvd.Adasum,
                sharded_update=True)),
            ("overlap", lambda: hvd.DistributedGradientTransform(
                lambda ls: torch.optim.SGD(ls, lr=0.1), op=hvd.Adasum,
                overlap=True)),
            ("tree_wire", lambda: hvd.optim.distributed.fused_reduce_tree(
                {"a": x.clone()}, op=hvd.Adasum, wire_format="int8")),
            ("tree_compression",
             lambda: hvd.optim.distributed.fused_reduce_tree(
                 {"a": x.clone()}, op=hvd.Adasum,
                 compression=hvd.Compression.fp16)),
            ("scatter", lambda: hvd.fused_reduce_scatter_tree(
                {"a": x.clone()}, op=hvd.Adasum))):
        try:
            make()
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    out["refusals"] = refusals
    return _tensors_to_np(out)


def case_tools(hvd, rank, world):
    """The engine's tools across ranks: autotuned parameters agreed in
    every round (HOROVOD_AUTOTUNE, one cycle a sample), a timeline per
    rank, and a stall: rank 1 submits one tensor 1.5 s late under
    HOROVOD_STALL_CHECK_TIME_SECONDS=0.5, which rank 0's log names."""
    import json
    import logging
    import tempfile
    import time
    import torch
    path = os.path.join(tempfile.mkdtemp(), f"timeline{rank}.json")
    _reinit(hvd, HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
            HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="1",
            HOROVOD_AUTOTUNE_MAX_SAMPLES="5", HOROVOD_TIMELINE=path,
            HOROVOD_TIMELINE_MARK_CYCLES="1",
            HOROVOD_STALL_CHECK_TIME_SECONDS="0.5")
    eng = hvd.runtime._state().engine
    applied = []
    for i in range(10):
        hvd.allreduce(torch.full((4,), float(rank + i)), name=f"tune{i % 2}")
        applied.append(dict(eng._negotiated_params or {}))
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger("horovod_tpu_torch").addHandler(Keep())
    if rank == 1:
        time.sleep(1.5)
    late = _np(hvd.allreduce(torch.ones(2), op=hvd.Sum, name="late"))
    stats = eng.stats()
    hvd.stop_timeline()
    events = json.loads(open(path).read())
    out = {"applied": applied, "autotune": stats["autotune"],
           "stall": stats["stall"], "late": late, "log": records,
           "events": events}
    _reinit(hvd, HOROVOD_AUTOTUNE=None,
            HOROVOD_AUTOTUNE_WARMUP_SAMPLES=None,
            HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE=None,
            HOROVOD_AUTOTUNE_MAX_SAMPLES=None, HOROVOD_TIMELINE=None,
            HOROVOD_TIMELINE_MARK_CYCLES=None,
            HOROVOD_STALL_CHECK_TIME_SECONDS=None)
    return out


def case_recovery(hvd, rank, world):
    """Checkpointless recovery at world 2: each rank's ZeRO transform
    pushes its tile to its ring neighbor at every boundary; a fresh agent
    of the same rank pulls it back, a fresh ``init`` plus
    ``restore_dist_state`` installs it, and one more boundary runs on the
    restored transform and on the uninterrupted one.  Variants: SGD with
    momentum; ``adamw_lp`` (bfloat16 moments) over the int8 wire (error
    feedback residuals) with 2 micro-steps a boundary."""
    import functools

    import torch
    from horovod_tpu_torch.elastic import recovery as R
    from horovod_tpu_torch.optim import recovery_payload, restore_dist_state
    from horovod_tpu_torch.optim.precision import adamw_lp
    from horovod_tpu_torch.runner.rpc import JsonRpcServer
    variants = {
        "sgd": (functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
                dict(wire_format="none"), 3),
        "adamw_lp_int8_k2": (adamw_lp(1e-2),
                             dict(wire_format="int8", wire_block_size=8,
                                  backward_passes_per_step=2), 4),
    }
    shapes = {"a": (37,), "b": (4, 6), "c": (64,)}
    rng = np.random.RandomState(11)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def grads(step):
        g = np.random.RandomState(1000 * step + rank)
        return {k: torch.from_numpy(g.randn(*s).astype(np.float32))
                for k, s in shapes.items()}

    def same(a, b):
        # ``count``: at k = 1 only a transform with the tap armed counts
        a, b = ({n: v for n, v in x.items() if n != "count"} for x in (a, b))
        return sorted(a) == sorted(b) and all(
            a[n].dtype == b[n].dtype and a[n].tobytes() == b[n].tobytes()
            for n in a)

    out = {}
    for name, (inner, kw, micro) in variants.items():
        k = kw.get("backward_passes_per_step", 1)
        agent = R.RecoveryAgent(rank=rank, size=world, mode="neighbor",
                                every=1, pull_deadline_s=30.0,
                                register=False)
        srv = JsonRpcServer(agent.worker_handlers(), secret=None)
        ports = hvd.allgather_object(srv.port, name=f"rec.{name}.ports")
        peers = {r: ("127.0.0.1", p) for r, p in enumerate(ports)}
        agent.update_plan(0, peers)
        R.install(agent)
        params = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
        twin = {n: t.clone() for n, t in params.items()}
        tx = hvd.DistributedGradientTransform(inner, sharded_update=True,
                                              recovery=agent, **kw)
        st = tx.init(params)
        ref_tx = hvd.DistributedGradientTransform(inner, sharded_update=True,
                                                  **kw)
        ref_st = ref_tx.init(twin)
        for step in range(micro):
            g = grads(step)
            tx.update({n: t.clone() for n, t in g.items()}, st, params)
            ref_tx.update(g, ref_st, twin)
        # the loss: a fresh process of this rank pulls its frame back
        fresh = R.RecoveryAgent(rank=rank, size=world, mode="neighbor",
                                every=1, pull_deadline_s=30.0,
                                register=False)
        fresh.update_plan(0, peers)
        payload = fresh.rebuild(min_epoch=0)
        hvd.barrier()
        R.uninstall(agent)
        srv.close()
        new = {n: t.clone() for n, t in twin.items()}
        new_tx = hvd.DistributedGradientTransform(inner,
                                                  sharded_update=True, **kw)
        new_st = restore_dist_state(new_tx.init(new), payload)
        restored = same(recovery_payload(new_st), recovery_payload(ref_st))
        for step in range(micro, micro + k):
            g = grads(step)
            new_tx.update({n: t.clone() for n, t in g.items()}, new_st, new)
            ref_tx.update(g, ref_st, twin)
        want = recovery_payload(ref_st)
        out[name] = {
            "version": fresh.last_rebuild["version"],
            "count": [int(payload["count"]), new_st.count],
            "boundaries": micro // k,
            "names": sorted(payload),
            "restored_equal": restored,
            "next_params_equal": all(torch.equal(new[n], twin[n])
                                     for n in new),
            "next_state_equal": same(recovery_payload(new_st), want),
            "nonzero": any(any(want[n].tobytes()) for n in want
                           if n.startswith("inner/")),
            "tile": sorted((n, want[n].tobytes().hex()) for n in want
                           if n.startswith("inner/")),
        }
    # a TensorState keeps the transform's per-rank state out of sync():
    # rank 1's weights become rank 0's, its tile stays its own
    from horovod_tpu_torch.elastic import TensorState
    params = {n: torch.from_numpy(v.copy()) * (rank + 1)
              for n, v in init.items()}
    tx = hvd.DistributedGradientTransform(
        variants["sgd"][0], sharded_update=True, wire_format="none")
    st = tx.init(params)
    tx.update(grads(0), st, params)
    before = recovery_payload(st)
    state = TensorState(params=params, dist=st, step=rank)
    state.sync()
    out["sync"] = {
        "params": _np(params["a"]).tolist(),
        "tile_kept": same(recovery_payload(state.dist), before),
        "dist_is_live": state.dist is st, "step": state.step}
    return out


# -- the parallel layouts (A6): the mesh, the axis collectives, the ring,
# Ulysses, the in-step *_p forms, the model-parallel Llama ---------------

#: (dp, sp, tp, ep) meshes whose coordinates and groups case_mesh reports,
#: by world size
MESHES = {
    2: [{"tp": 2}, {"sp": 2}, {"dp": 2}, {"ep": 2}],
    4: [{"dp": 4}, {"dp": 2, "tp": 2}, {"sp": 2, "tp": 2},
        {"dp": 2, "sp": 2}, {"dp": 2, "ep": 2}, {"ep": 2, "tp": 2}],
}


def case_mesh(hvd, rank, world):
    """Each mesh of :data:`MESHES`: this rank's coordinates, the ranks of
    its group on every axis, and ``make_mesh``'s default dp."""
    from horovod_tpu_torch.parallel.mesh import (MeshConfig, ParallelMesh,
                                                 make_mesh)
    out = []
    for axes in MESHES[world]:
        m = ParallelMesh(MeshConfig(**axes))
        out.append({"axes": axes, "names": list(m.axis_names),
                    "coords": m.coords,
                    "ep_index": m.axis_index("ep"),
                    "groups": {a: (m.group(a).ranks if m.group(a) else None)
                               for a in m.axis_names}})
    made = make_mesh(tp=2)
    # a re-init on the same store port: the meshes' groups (and with them
    # rank 0's store) must not outlive the runtime, and a mesh made under
    # the old runtime refuses its groups
    import torch
    from horovod_tpu_torch.parallel import axis as ax
    _reinit(hvd)
    try:
        made.group("tp")
        stale = None
    except ValueError as e:
        stale = str(e)
    with ParallelMesh(MeshConfig(tp=world)):
        total = ax.psum(torch.tensor([float(rank + 1)]), "tp").item()
    return {"meshes": out, "make_mesh_dp": made.config.dp,
            "stale_group": stale, "psum_after_reinit": total}


#: name -> (B, T, H, Hkv, D, causal, dtype, flash): the ring's inputs;
#: ``flash`` takes the tiles through flash_attention_lse (the plain
#: versions on the CPU) even at fp32, which the kernels' gate refuses
RING_CASES = {
    "causal": (2, 64, 4, 4, 16, True, "float32", False),
    "noncausal": (2, 64, 4, 4, 16, False, "float32", False),
    "gqa": (1, 32, 4, 2, 8, True, "float32", False),
    "flash_causal": (1, 128, 4, 2, 64, True, "float32", True),
    "flash_noncausal": (1, 128, 4, 2, 64, False, "float32", True),
    "flash_bf16": (1, 256, 4, 2, 64, True, "bfloat16", False),
}

#: name -> (B, T, H, Hkv, D) for Ulysses at each world (causal, fp32)
ULYSSES_CASES = {
    2: {"grouped": (2, 32, 4, 2, 16), "repeated": (2, 32, 4, 1, 16),
        "refused": (1, 32, 3, 3, 16)},
    4: {"grouped": (2, 32, 8, 4, 16), "repeated": (2, 32, 8, 2, 16),
        "refused": (1, 32, 2, 2, 16)},
}


def attn_inputs(B, T, H, Hkv, D, seed):
    """q ``[B, T, H, D]``, k, v ``[B, T, Hkv, D]`` and a cotangent for the
    output, fp32."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.normal(size=(B, T, H, D)).astype(f),
            rng.normal(size=(B, T, Hkv, D)).astype(f),
            rng.normal(size=(B, T, Hkv, D)).astype(f),
            rng.normal(size=(B, T, H, D)).astype(f))


def _attend(fn, arrays, dtype, rank, world):
    """This rank's sequence block of ``arrays`` through ``fn(q, k, v)``:
    its output block and the gradients of sum(out * cotangent)."""
    import torch
    n = arrays[0].shape[1] // world
    q, k, v, dout = (torch.from_numpy(a[:, rank * n:(rank + 1) * n].copy())
                     .to(getattr(torch, dtype)) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = fn(q, k, v)
    (out.float() * dout.float()).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


def case_ring(hvd, rank, world):
    """ring_attention over sp = world for each of :data:`RING_CASES`, with
    the flash launches (plain versions on the CPU) each ran."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    mesh = ParallelMesh(MeshConfig(sp=world))
    gate, tile = fa.unsupported_reason, fa.flash_attention_lse
    tiles = []

    def counted(*a, **kw):
        tiles.append(kw.get("causal"))
        return tile(*a, **kw)

    out = {}
    for i, (name, (B, T, H, Hkv, D, causal, dtype, flash)) in enumerate(
            RING_CASES.items()):
        if flash:
            fa.unsupported_reason = lambda q, k, v: None
        fa.flash_attention_lse = counted
        tiles.clear()
        try:
            with mesh:
                out[name] = _attend(
                    lambda q, k, v: ring_attention(q, k, v, "sp",
                                                   causal=causal),
                    attn_inputs(B, T, H, Hkv, D, seed=20 + i), dtype,
                    rank, world)
        finally:
            fa.unsupported_reason, fa.flash_attention_lse = gate, tile
        out[name]["tiles"] = len(tiles)
        out[name]["causal_tiles"] = sum(bool(c) for c in tiles)
    return out


def case_ulysses(hvd, rank, world):
    """ulysses_attention over sp = world for each case of
    :data:`ULYSSES_CASES`; a refused case returns its error."""
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = ParallelMesh(MeshConfig(sp=world))
    out = {}
    for i, (name, shape) in enumerate(ULYSSES_CASES[world].items()):
        try:
            with mesh:
                out[name] = _attend(
                    lambda q, k, v: ulysses_attention(q, k, v, "sp"),
                    attn_inputs(*shape, seed=40 + i), "float32", rank,
                    world)
        except ValueError as e:
            out[name] = {"error": str(e)}
    return out


def p_input(dtype, rank, world):
    """Rank ``rank``'s input of the *_p forms: ``[2·world, 3]`` multiples of
    1/4 (exact in every sum), positive for the product."""
    return (base(dtype, rank, shape=(2 * world, 3), seed=7) % 3 + 1
            if dtype in ("int32", "int64")
            else base(dtype, rank, shape=(2 * world, 3), seed=7))


def case_p_forms(hvd, rank, world):
    """The in-step *_p forms over MeshConfig(dp=world) on fp32 and int32
    inputs, and the gradients of psum-based ones."""
    import torch
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    out = {}
    with ParallelMesh(MeshConfig(dp=world)):
        for dtype in ("float32", "int32"):
            x = torch.from_numpy(p_input(dtype, rank, world))
            r = {f"allreduce_{op}": _np(hvd.allreduce_p(x, "dp", op=op))
                 for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Max,
                            hvd.Product)}
            r["allgather"] = _np(hvd.allgather_p(x, "dp"))
            r["allgather_scalar"] = _np(hvd.allgather_p(x[0, 0], "dp"))
            r["broadcast"] = _np(hvd.broadcast_p(x, 1, "dp"))
            r["alltoall"] = _np(hvd.alltoall_p(x, "dp"))
            for op in (hvd.Sum, hvd.Average):
                if dtype == "float32" or op == hvd.Sum:
                    r[f"reducescatter_{op}"] = _np(
                        hvd.reducescatter_p(x, "dp", op=op))
            out[dtype] = r
        w = torch.arange(6 * world, dtype=torch.float32).view(2 * world, 3)
        for key, loss in (
                ("grad_allreduce", lambda x: (hvd.allreduce_p(
                    x, "dp", op=hvd.Average) * w).sum()),
                ("grad_reducescatter", lambda x: (hvd.reducescatter_p(
                    x, "dp", op=hvd.Sum) ** 2).sum())):
            x = torch.from_numpy(p_input("float32", rank, world))
            x.requires_grad_(True)
            loss(x).backward()
            out[key] = _np(x.grad)
    return out


# the Llama configurations of tests/test_torch_llama_parallel.py: the test
# process writes llama_mp.json (name -> config fields, mesh, step options,
# optimizer), the full weights and the global batch to $LLAMA_MP_DIR

def pipeline_inputs(n_stages, seed=0):
    """tests/test_parallel.py's pipeline: per-stage affine weights ``w
    [S, 4, 4]``, ``b [S, 4]``, 6 microbatches ``x [6, 2, 4]``, and a
    cotangent for the output."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return ((rng.normal(size=(n_stages, 4, 4)) * 0.5).astype(f),
            rng.normal(size=(n_stages, 4)).astype(f),
            rng.normal(size=(6, 2, 4)).astype(f),
            rng.normal(size=(6, 2, 4)).astype(f))


def case_pipeline(hvd, rank, world):
    """pipeline_apply over pp = world, each rank one stage of
    tanh(x @ w + b), with and without an aux (each live tick's sum of
    y): the output, the aux, and the gradients of the last stage's
    sum(out · cotangent) (plus the aux) for this rank's stage weights and
    the microbatches;
    the hop bytes of one call, and the stage's calls."""
    import torch
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.parallel.pipeline import pipeline_apply
    w, b, x, cot = pipeline_inputs(world)
    out = {}
    for with_aux in (False, True):
        calls = [0]

        def stage_fn(p, xb):
            calls[0] += 1
            y = torch.tanh(xb @ p["w"] + p["b"])
            return (y, y.sum()) if with_aux else y

        p = {"w": torch.from_numpy(w[rank].copy()).requires_grad_(),
             "b": torch.from_numpy(b[rank].copy()).requires_grad_()}
        xs = torch.from_numpy(x.copy()).requires_grad_()
        ax.reset_bytes()
        with ParallelMesh(MeshConfig(pp=world)):
            res = pipeline_apply(stage_fn, p, xs, "pp", with_aux=with_aux)
            y, aux = res if with_aux else (res, None)
            loss = (y * torch.from_numpy(cot)).sum()
            if with_aux:
                loss = loss + aux
            # the training step's loss: the last stage's alone
            (loss * float(rank == world - 1)).backward()
        out[f"aux={with_aux}"] = {
            "out": _np(y), "aux": None if aux is None else aux.item(),
            "dw": _np(p["w"].grad), "db": _np(p["b"].grad),
            "dx": _np(xs.grad), "calls": calls[0], "bytes": dict(ax.BYTES)}
    return out


def _llama_weights(path, device="cpu"):
    """The port's params from a flat ``.npz`` of JAX-layout weights
    (``embed``, ``final_norm``, ``layers.<name>`` stacked)."""
    from horovod_tpu_torch import convert
    data = np.load(path)
    tree = {"embed": data["embed"], "final_norm": data["final_norm"],
            "layers": {k.split(".", 1)[1]: data[k] for k in data.files
                       if k.startswith("layers.")}}
    return convert.llama_params_from_numpy(tree, device=device)


#: name -> (overlap, optimizer) of each FSDP run
FSDP_RUNS = {"sgd": (False, "sgd"), "sgd_overlap": (True, "sgd"),
             "adamw": (False, "adamw"), "adamw_overlap": (True, "adamw")}


def case_fsdp(hvd, rank, world):
    """make_llama_fsdp_step at dp = world from the JAX weights in
    ``$FSDP_DIR`` for 3 steps of each of :data:`FSDP_RUNS` on this rank's
    rows of the batch: the losses, this rank's parameter and optimizer
    state bytes, the full params gathered back after the steps, and the
    per-dp collective bytes of a step (``parallel.axis.BYTES``)."""
    import torch
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import axis as ax
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.tree import tree_leaves, tree_map, tree_paths
    d = pathlib.Path(os.environ["FSDP_DIR"])
    cfg = llama.tiny(vocab=64, seq=32)
    batch = np.load(d / "batch.npz")
    out = {}
    for name, (overlap, opt) in FSDP_RUNS.items():
        pmesh = ParallelMesh(MeshConfig(dp=world))
        factory = (functools.partial(torch.optim.SGD, lr=0.05)
                   if opt == "sgd" else None)
        ts = training.make_llama_fsdp_step(cfg, pmesh, optimizer=factory,
                                           overlap=overlap, device="cpu")
        full = _llama_weights(d / "dense.npz")
        with pmesh:
            params = tree_map(lambda t: t.clone().contiguous(),
                              training.spec_shard(full, ts.specs, "dp"))
        opt_state = ts.opt_init(params)
        toks, tgts = (ts.shard_batch(torch.from_numpy(batch[k]))
                      for k in ("toks", "tgts"))
        losses, step_bytes = [], None
        for i in range(3):
            ax.reset_bytes()
            params, opt_state, loss = ts.step_fn(params, opt_state, toks,
                                                 tgts)
            losses.append(loss.item())
            step_bytes = dict(ax.BYTES)
        inner = opt_state.inner if overlap else opt_state
        state_bytes = sum(t.numel() * t.element_size()
                          for st in inner.state.values()
                          for t in st.values()
                          if torch.is_tensor(t) and t.dim() > 0)
        tile_bytes = (sum(t.numel() * t.element_size()
                          for t in opt_state.tiles) if overlap else 0)
        with pmesh, torch.no_grad():
            back = training.spec_all_gather(params, ts.specs, "dp")
        out[name] = {
            "losses": losses,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "state_bytes": state_bytes, "tile_bytes": tile_bytes,
            "shapes": {p: list(t.shape) for p, t in
                       zip(tree_paths(params), tree_leaves(params))},
            "final": {p: _np(t) for p, t in
                      zip(tree_paths(back), tree_leaves(back))},
            "step_bytes": step_bytes}
    return out


#: world -> the mp degrees each launch serves at (mp = world, and at
#: world 4 also two slices of mp 2)
MP_SERVE_DEGREES = {2: (2,), 4: (4, 2)}


def case_mp_serve(hvd, rank, world):
    """mp_llama_decode_forward over ``mp`` ranks of each degree of
    :data:`MP_SERVE_DEGREES` from the JAX weights in ``$MP_SERVE_DIR``
    (``llama.tiny(vocab=64, seq=64)``): the leader's batch
    (tests/test_paging.py's two ragged rows) and a batch of one, the
    outputs on every rank, the forward's stats; at mp = world the same
    model behind a ServingPlane, the leader's ServingWorker answering
    requests while the followers follow."""
    import torch
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.serving.models import mp_llama_decode_forward
    from horovod_tpu_torch.serving.shapes import ShapeBuckets
    d = pathlib.Path(os.environ["MP_SERVE_DIR"])
    cfg = llama.tiny(vocab=64, seq=64)
    params = _llama_weights(d / "params.npz")
    io = np.load(d / "inputs.npz")
    out = {}
    b = ShapeBuckets(batch_buckets=(1, 2), seq_buckets=(8,))
    for mp in MP_SERVE_DEGREES[world]:
        fwd = mp_llama_decode_forward(params, cfg, 4, b, mp=mp)
        lead = fwd.group.rank() == 0
        two = fwd(io["tokens"], io["lengths"]) if lead else fwd()
        one = (fwd(io["tokens"][1:], io["lengths"][1:]) if lead
               else fwd())
        if lead:
            fwd.close()
        else:
            assert fwd.follow() == 0
        out[f"mp{mp}"] = {"two": two, "one": one, "stats": fwd.stats(),
                          "ranks": fwd.ranks}
    # through the plane: the slice's leader serves, the others follow
    fwd = mp_llama_decode_forward(params, cfg, 4, b, mp=world)
    if fwd.group.rank() == 0:
        from horovod_tpu_torch.runner.rpc import JsonRpcServer, json_request
        from horovod_tpu_torch.serving.plane import ServingPlane
        from horovod_tpu_torch.serving.worker import ServingWorker
        plane = ServingPlane(tick_ms=1.0, max_batch=2, seq_buckets="8",
                             batch_buckets="1,2", deadline_ms=0)
        srv = JsonRpcServer(plane.rpc_handlers(), host="127.0.0.1",
                            secret=None)
        w = ServingWorker("127.0.0.1", srv.port, fwd, worker_id="mp",
                          wait_s=1.0, secret=None, warmup=True)
        answers = {}
        try:
            w.start()
            for i in range(3):
                row = io["tokens"][i % 2][:int(io["lengths"][i % 2])]
                json_request("127.0.0.1", srv.port, "serve_submit",
                             {"id": f"r{i}", "tokens": row.tolist()},
                             secret=None, timeout=10.0)
            for i in range(3):
                res = json_request("127.0.0.1", srv.port, "serve_result",
                                   {"id": f"r{i}", "wait_s": 30.0},
                                   secret=None, timeout=40.0)
                answers[f"r{i}"] = res.get("output")
        finally:
            plane.close()
            w.stop()
            w.join(30)
            srv.close()
            fwd.close()
        out["plane"] = {"answers": answers,
                        "recompiles": fwd.stats()["recompiles"]}
    else:
        out["plane"] = {"followed": fwd.follow()}
    return out


def case_llama_mp(hvd, rank, world):
    """3 steps of make_llama_train_step over each configuration of
    ``llama_mp.json`` whose mesh spans ``world`` ranks, from the full JAX
    weights sharded by convert.llama_shard_params, on this rank's cut of
    the global batch; the losses, and whether llama_gather_params gives
    the full weights back bit for bit."""
    import torch
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel.mesh import MeshConfig, ParallelMesh
    from horovod_tpu_torch.tree import tree_leaves
    d = pathlib.Path(os.environ["LLAMA_MP_DIR"])
    out = {}
    for name, spec in json.loads((d / "llama_mp.json").read_text()).items():
        mc = MeshConfig(**spec["mesh"])
        if mc.n_devices != world:
            continue
        fields = dict(spec["cfg"], dtype=getattr(torch, spec["cfg"]["dtype"]),
                      param_dtype=getattr(torch,
                                          spec["cfg"]["param_dtype"]))
        cfg = llama.LlamaConfig(**fields)
        data = np.load(d / f"{spec['weights']}.npz")
        tree = {"embed": data["embed"], "final_norm": data["final_norm"],
                "layers": {k.split(".", 1)[1]: data[k] for k in data.files
                           if k.startswith("layers.")}}
        full = convert.llama_params_from_numpy(tree, device="cpu")
        pmesh = ParallelMesh(mc)
        opt = (functools.partial(torch.optim.SGD, lr=0.05)
               if spec["opt"] == "sgd" else None)
        ts = training.make_llama_train_step(cfg, pmesh, optimizer=opt,
                                            device="cpu", **spec["step_kw"])
        params = convert.llama_shard_params(full, cfg, pmesh, ts.par)
        back = convert.llama_gather_params(params, cfg, pmesh, ts.par)
        round_trip = all(torch.equal(a, b) for a, b in
                         zip(tree_leaves(back), tree_leaves(full)))
        opt_state = ts.opt_init(params)
        batch = np.load(d / "batch.npz")
        toks, tgts = (ts.shard_batch(torch.from_numpy(batch[k]))
                      for k in ("toks", "tgts"))
        losses = []
        for _ in range(3):
            params, opt_state, loss = ts.step_fn(params, opt_state, toks,
                                                 tgts)
            losses.append(loss.item())
        out[name] = {"losses": losses, "round_trip": round_trip,
                     "local_batch": list(toks.shape)}
    # a pp mesh refuses a layer count it does not divide, and a pipeline
    # step without n_microbatches
    errors = []
    pm = ParallelMesh(MeshConfig(pp=2, dp=world // 2))
    for n_layers in (3, 2):
        try:
            ts = training.make_llama_train_step(
                dataclasses.replace(llama.tiny(), n_layers=n_layers), pm,
                device="cpu")
            params, _ = ts.init_fn(0)
            ts.grads_fn(params, *(ts.shard_batch(torch.zeros(
                (2 * world, 8), dtype=torch.int64)) for _ in range(2)))
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["pp_error"] = errors
    return out


#: DistributedGradientTransform options the health taps are held against
#: the JAX package's under (4 steps each, health_check_every=2)
HEALTH_CONFIGS = {
    "replicated": {},
    "sharded": {"sharded_update": True},
    "int8": {"wire_format": "int8"},
    "k2": {"backward_passes_per_step": 2},
}


def health_rule_runs(world):
    """name -> (steps, chaos rule, the update it is installed for, ranks
    whose weights start 1 ulp off) of :func:`case_health`'s runs beyond
    the configs: rank ``world - 1``'s contribution NaN'd in bucket 1 at
    every update, scaled x1e6 in bucket 0 after the evaluator's warm-up,
    and the last rank's weights perturbed (a minority of one at world 3,
    an even split at world 2)."""
    last = world - 1
    return {
        "nan": (2, f"collective.corrupt bucket=1 action=nan:{last}", 1,
                ()),
        "scale": (7, f"collective.corrupt bucket=0 nth=1 "
                     f"action=scale:{last}", 7, ()),
        "perturbed": (1, None, None, (last,)),
    }


def case_health(hvd, rank, world):
    """The health-armed transform on :func:`zparams` with this rank's
    :func:`zgrads`: for each of :data:`HEALTH_CONFIGS`, then each of
    :func:`health_rule_runs`, a fresh evaluator recording every bucket and
    residual observation, and its verdicts and summary."""
    import torch
    from horovod_tpu_torch import chaos, health

    class Recording(health.HealthEvaluator):
        def __init__(self):
            super().__init__()
            self.obs, self.res = [], []

        def ingest_bucket(self, step, worker, bucket, name, l2, max_abs,
                          nonfinite):
            self.obs.append((int(step), int(worker), int(bucket), str(name),
                             float(l2), float(max_abs), int(nonfinite)))
            super().ingest_bucket(step, worker, bucket, name, l2, max_abs,
                                  nonfinite)

        def ingest_residual(self, step, worker, bucket, norm, name=None):
            self.res.append((int(step), int(worker), int(bucket),
                             float(norm)))
            super().ingest_residual(step, worker, bucket, norm, name=name)

    def run(kw, steps, rule=None, rule_step=None, perturbed=()):
        ev = Recording()
        old = health.swap_evaluator(ev)
        params = {k: torch.from_numpy(v.copy()) for k, v in
                  zparams().items()}
        if rank in perturbed:
            params["b"][0] = torch.nextafter(params["b"][0],
                                             torch.tensor(1e9))
        kw = dict({"wire_format": "none", "wire_block_size": ZBLOCK}, **kw)
        tx = hvd.DistributedGradientTransform(
            _fp32_adamw_lp(ZLR), threshold_bytes=ZTHRESHOLD, health=True,
            health_check_every=2 if rule is None and not perturbed else 1,
            **kw)
        state = tx.init(params)
        try:
            for i in range(steps):
                if rule is not None and i + 1 == rule_step:
                    chaos.install(chaos.FaultSchedule.parse(rule, seed=7))
                grads = {k: torch.from_numpy(v)
                         for k, v in zgrads(rank, i).items()}
                tx.update(grads, state, params)
        finally:
            chaos.uninstall()
            health.swap_evaluator(old)
        return {"obs": ev.obs, "res": ev.res,
                "verdicts": [{k: v[k] for k in ("kind", "worker", "bucket",
                                                "step", "detail")}
                             for v in ev.verdicts()],
                "summary": ev.summary(),
                "checksum_rounds": ev.snapshot()["checks"][
                    "checksum_rounds"]}

    out = {name: run(kw, 4) for name, kw in HEALTH_CONFIGS.items()}
    for name, (steps, rule, at, perturbed) in \
            health_rule_runs(world).items():
        out[name] = run({}, steps, rule, at, perturbed)
    return out


def _case(name):
    """``case_<name>`` of this file, or ``case_<fn>`` of the module a
    ``module:fn`` name names (a file beside this one)."""
    if ":" in name:
        import importlib
        module, fn = name.split(":")
        return getattr(importlib.import_module(module), f"case_{fn}")
    return globals()[f"case_{name}"]


def main(out_dir, cases):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    rank, world = hvd.rank(), hvd.size()
    results = {c: _case(c)(hvd, rank, world) for c in cases}
    results["stats"] = hvd.runtime._state().engine.stats()
    hvd.shutdown()
    (pathlib.Path(out_dir) / f"rank{rank}.pkl").write_bytes(
        pickle.dumps(results))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
