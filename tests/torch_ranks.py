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
                 **(env or {}))
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


def main(out_dir, cases):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    rank, world = hvd.rank(), hvd.size()
    results = {c: globals()[f"case_{c}"](hvd, rank, world) for c in cases}
    results["stats"] = hvd.runtime._state().engine.stats()
    hvd.shutdown()
    (pathlib.Path(out_dir) / f"rank{rank}.pkl").write_bytes(
        pickle.dumps(results))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
