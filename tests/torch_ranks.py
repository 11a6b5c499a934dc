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


def launch(world, cases, tmp_path, port, env=None, timeout=120):
    """Run ``cases`` in ``world`` rank processes; returns each rank's
    ``{case: result}``.  Kills every rank and raises when one fails or the
    launch outlives ``timeout`` seconds."""
    out = pathlib.Path(tmp_path) / f"ranks{world}-{port}"
    out.mkdir()
    procs = []
    for r in range(world):
        e = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(world),
                 HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                 HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                 HOROVOD_CYCLE_TIME="0.1",
                 HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="30",
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
    assert not expired and not bad, (
        f"ranks of {cases} " + (f"outlived {timeout} s" if expired
                                else f"failed {bad}") + ":\n"
        + "\n".join(logs))
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
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
    layout, flattened by path) and the batch, to ``$DP_STEP_DIR``."""
    import torch
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.optim import precision
    from horovod_tpu_torch.tree import tree_leaves, tree_paths
    d = pathlib.Path(os.environ["DP_STEP_DIR"])
    out = {}
    for name, fields in json.loads((d / "dp_step.json").read_text()).items():
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
            cfg, optimizer=precision.adamw_lp(3e-4), device="cpu")
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
                                        tree_leaves(flat)))}
    return out


def _reversed_keys(tree):
    if isinstance(tree, dict):
        return {k: _reversed_keys(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, list):
        return [_reversed_keys(v) for v in tree]
    return tree


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
