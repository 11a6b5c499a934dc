"""Run one benchmark cell once and print its result line.

    python3 -m hvdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic, limits
and per-layer metrics are found by name (``cells.py``).  Every rank runs
under ``hvd.init()`` over NCCL, one process a card; a cell on several
cards is started through the port's own launcher
(``python -m horovod_tpu_torch.runner -np <chips>``), and this process
prints rank 0's result.

A run: set-up (the port's kernels built or loaded, the seeded weights and
batch pool made on the card, the step object built and driven through its
first ``check_steps`` steps, which warm every shape the window uses and
whose readings ``check.py`` holds against the reference); the window, a
fixed number of steps back to back that fills ``--seconds`` at the
checked steps' pace, each step ending when its loss is read with
``.item()``; with ``--trace 1`` a few more steps under the profiler, read
by the per-layer metrics; then, with the program's state freed, the
plain reference over the checked steps.  The last line of standard output
is the result; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T0 = time.time()  # the run's set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from hvdbench import cells, check, trace, weights  # noqa: E402

#: top-level module names that may not be loaded once the window closed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "horovod_tpu"})
#: set in each rank's environment by the launching process
CHILD_ENV = "HVDBENCH_CHILD"
T0_ENV = "HVDBENCH_T0"
RESULT_ENV = "HVDBENCH_RESULT"
GROUP_PORT_ENV = "HVDBENCH_GROUP_PORT"
#: the profiled steps cover at least this long, and at least 3 steps
TRACE_SECONDS = 2.0
#: the launcher's ranks get this long (the first run in a checkout builds)
LAUNCH_TIMEOUT_S = 1150


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="hvdbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cell: cells.Cell, rank_cmd: List[str]) -> int:
    """Start ``rank_cmd`` on ``cell.chips`` ranks through the port's
    launcher, their output on this process's standard error, and print
    rank 0's result."""
    workdir = tempfile.mkdtemp(prefix="hvdbench-")
    result = os.path.join(workdir, "result.json")
    env = dict(os.environ, **{CHILD_ENV: "1", T0_ENV: repr(T0),
                              RESULT_ENV: result,
                              GROUP_PORT_ENV: str(free_port())})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(cell.chips), "-p", str(free_port()), *rank_cmd]
    proc = subprocess.Popen(cmd, env=env, stdout=sys.stderr,
                            stderr=sys.stderr)
    try:
        rc = proc.wait(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGINT)  # the launcher ends its ranks
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        rc = 124
    try:
        if rc != 0 or not os.path.exists(result):
            print(f"hvdbench: the ranks exited with {rc}", file=sys.stderr)
            return rc or 1
        with open(result) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return emit(out)


def emit(out: Optional[Dict], path: Optional[str] = None) -> int:
    """Print (or, in a launched rank 0, write to ``path``) a result: the
    compared numbers last on standard error, the line last on standard
    output; nothing where a forbidden module is loaded."""
    if out is None:
        return 0
    bad = forbidden_modules()
    if bad:
        print(f"hvdbench: loaded in the process that prints the result: "
              f"{bad}", file=sys.stderr)
        return 3
    if path:
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    sys.stdout.flush()
    for line in out["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]))
    sys.stdout.flush()
    return 0


def _wrap_entries(calls: Dict[str, list]):
    """Put the harness's ranges around the port's attention and
    cross-entropy entries, recording each call's shape; returns the undo."""
    from torch.profiler import record_function
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_xent as fx
    flash, xent = fa.flash_attention, fx.fused_xent_mean

    def flash_attention(q, k, v, causal=True, sm_scale=None):
        B, T, H, D = q.shape
        calls["flash"].append((B, T, H, k.shape[2], D, bool(causal)))
        with record_function(trace.FLASH_RANGE):
            return flash(q, k, v, causal=causal, sm_scale=sm_scale)

    def fused_xent_mean(h, w_embed, targets):
        calls["xent"].append((h.shape[0] * h.shape[1], w_embed.shape[0],
                              h.shape[2]))
        with record_function(trace.XENT_RANGE):
            return xent(h, w_embed, targets)

    fa.flash_attention, fx.fused_xent_mean = flash_attention, fused_xent_mean

    def undo():
        fa.flash_attention, fx.fused_xent_mean = flash, xent
    return undo


def _traced(step, first: int, k: int, engine, cuda: bool):
    """``k`` steps from pool index ``first`` under the profiler, after one
    warm-up step: the reduced capture, the attention and cross-entropy
    calls' shapes, and the engine's dispatch host ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler import schedule
    calls = {"flash": [], "xent": []}
    undo = _wrap_entries(calls)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=k, repeat=1)) as prof:
            for j in range(k + 1):
                if j == 1:
                    calls["flash"].clear()
                    calls["xent"].clear()
                    d0 = engine.stats()["dispatch_ms"]
                with record_function(trace.STEP_RANGE):
                    step(first + j)
                prof.step()
            dispatch_ms = engine.stats()["dispatch_ms"] - d0
    finally:
        undo()
    return trace.reduce(trace.Events.from_profiler(prof)), calls, dispatch_ms


def run_rank(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device_kind: str, t0: float) -> Optional[Dict]:
    """One rank of a run; rank 0 returns ``{"line": ..., "lines": ...}``,
    the others None.  ``device_kind`` is ``"cuda"`` on the card (NCCL) or
    ``"cpu"`` (gloo; the tests')."""
    import gc
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import runtime

    marks = {"imports": time.time() - t0}
    cuda = device_kind == "cuda"
    hvd.init() if cuda else hvd.init(device="cpu")
    marks["init"] = time.time() - t0
    rank, size = hvd.rank(), hvd.size()
    dev = runtime.device()
    fam, cfg, traffic = cell.family, cell.config, cell.traffic
    build_s = 0.0
    if cuda:
        from horovod_tpu_torch.ops import _build
        build_s = _build.build_all()
    marks["build"] = time.time() - t0
    lay, n_layers = fam.layout(cfg), fam.n_layers(cfg)
    params = weights.tree(lay, n_layers, seed, dev)
    ts = fam.make_step(cfg, device=None if cuda else "cpu")
    opt = ts.opt_init(params)
    pool = fam.batches(cfg, traffic, seed, rank, dev)
    marks["state"] = time.time() - t0

    def step(i: int) -> float:
        _, _, loss = ts.step_fn(params, opt, *pool[i % len(pool)])
        return loss.item()

    # the checked steps: the window's own call and feed, distinct rows
    n_check = traffic["check_steps"]
    prog = {"losses": []}
    check_s = []
    for i in range(n_check):
        t = time.perf_counter()
        prog["losses"].append(step(i))
        check_s.append(time.perf_counter() - t)
        if i == 0:
            prog["grad_norms"] = {
                p: float(fam.grad_from_state(opt, w).norm())
                for p, w in weights.items(params)}
    marks["check_steps"] = time.time() - t0
    if rank == 0:
        prog["change_norms"] = weights.change_norms(params, lay, n_layers,
                                                    seed, dev)
    pace = statistics.median(check_s[1:] or check_s)
    n = hvd.broadcast(torch.tensor([max(3, math.ceil(seconds / pace))],
                                   device=dev), 0, name="hvdbench.steps")
    n = int(n.item())

    setup_s = time.time() - t0
    step_ms, failed = [], 0
    w0 = time.perf_counter()
    for s in range(n):
        t = time.perf_counter()
        loss = step(n_check + s)
        step_ms.append(1e3 * (time.perf_counter() - t))
        failed += not math.isfinite(loss)
    window_s = time.perf_counter() - w0

    mine = {"peak": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    if traced:
        k = max(3, math.ceil(TRACE_SECONDS / pace))
        red, calls, dispatch_ms = _traced(step, n_check + n, k,
                                          runtime._state().engine, cuda)
        mine.update(busy_s=red["busy_s"], window_s=red["window_s"])

    del ts, opt, params, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    hvd.shutdown()

    group = None
    per_rank = [mine]
    if size > 1:
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"tcp://127.0.0.1:{os.environ[GROUP_PORT_ENV]}",
            rank=rank, world_size=size, device_id=dev if cuda else None)
        group = dist.group.WORLD
        per_rank = [None] * size
        dist.all_gather_object(per_rank, mine)
    r0 = time.perf_counter()
    try:
        ref = check.reference_readings(
            fam, cfg, seed, [fam.batches(cfg, traffic, seed, rank, dev)],
            n_check, dev, group=group, world=size)
    finally:
        if group is not None:
            dist.destroy_process_group()
    reference_s = time.perf_counter() - r0
    if rank != 0:
        return None

    found = check.numbers(prog, ref)
    correct, checks, lines = check.judge(found, cell.limits, failed)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": size,
              "memory_peak_bytes": max(r["peak"] for r in per_rank)}
    line = {"correct": correct, "attempted": n, "failed": failed}
    tokens = fam.tokens_per_batch(traffic)
    if not traced:
        e2e = {"tokens_per_s_per_chip": n * tokens / window_s,
               "step_ms_p90": statistics.quantiles(
                   step_ms, n=10, method="inclusive")[8],
               "peak_mem_gib": device["memory_peak_bytes"] / 2 ** 30,
               "setup_s": setup_s}
        line["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                       "unit": m["unit"]}
                           for m in cell.end_to_end}
    else:
        ctx = {"chips": cell.chips, "trace": red, "calls": calls,
               "engine_dispatch_ms": dispatch_ms,
               "window": {"steps": n, "seconds": window_s,
                          "flops": n * size * fam.model_flops(cfg,
                                                              traffic)}}
        line["metrics"] = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(ctx)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        device["busy_s"] = statistics.fmean(r["busy_s"] for r in per_rank)
        device["window_s"] = statistics.fmean(r["window_s"]
                                              for r in per_rank)
        line["breakdown"] = {"device_ops": red["device_ops"],
                             "idle_gaps": red["idle_gaps"]}
    line["device"] = device
    line["timings"] = {"build_s": build_s, "setup_marks_s": marks,
                       "check_steps_s": check_s, "window_s": window_s,
                       "step_ms": step_ms,
                       "reference_s": reference_s}
    line["readings"] = {k: v for k, (v, _) in found.items()}
    line["checks"] = checks
    lines = [f"losses program {prog['losses']}",
             f"losses reference {ref['losses']}"] + lines
    return {"line": line, "lines": lines}


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    try:
        cell = cells.load(args.workload)
        if cell.chips > 1 and CHILD_ENV not in os.environ:
            return launch(cell, [sys.executable, "-m", "hvdbench.run",
                                 *(sys.argv[1:] if argv is None else argv)])
        import torch
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell.chips:
            print(f"hvdbench: {args.workload} needs {cell.chips} CUDA "
                  f"device(s); torch sees {found}", file=sys.stderr)
            return 2
        out = run_rank(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", float(os.environ.get(T0_ENV, T0)))
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc()
        return 1
    return emit(out, os.environ.get(RESULT_ENV))


if __name__ == "__main__":
    sys.exit(main())
