"""A CPU run of a cell for the tests: ``run.run_rank`` on the CPU (gloo),
a cell on several ranks started through the port's launcher by
``run.launch`` as on the card, with the fault named by ``--fault`` planted
in the timed path first.

    python cpu_rank.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--fault NAME]
"""

from __future__ import annotations

import argparse
import os
import sys

from hvdbench import cells, run


def plant(fault: str) -> None:
    """Break the port's timed path underneath the harness."""
    import torch
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import bert
    if fault == "state_unchanged":
        # every optimizer step returns the state it was given
        from horovod_tpu_torch.optim import precision
        for cls in (torch.optim.Optimizer, torch.optim.AdamW,
                    precision.AdamWLP):
            cls.step = lambda self, closure=None: None
    elif fault == "half_batch":
        # the step sees the first half of its batch: the mean over the rest
        for mod, name in ((training, "make_llama_train_step"),
                          (bert, "make_dp_finetune_step")):
            make = getattr(mod, name)

            def halved(*a, _make=make, **kw):
                ts = _make(*a, **kw)
                step = ts.step_fn

                def step_fn(params, opt, x, y):
                    return step(params, opt, x[:x.shape[0] // 2],
                                y[:y.shape[0] // 2])
                ts.step_fn = step_fn
                return ts
            setattr(mod, name, halved)
    elif fault == "no_exchange":
        # the engine's reduction left out: each rank keeps its own sums
        def local(tensors, names, ps, scale):
            del names, ps, scale
        training.sum_scaled_ = local
        bert.sum_scaled_ = local
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--fault", default="")
    args = p.parse_args()
    cell = cells.load(args.workload)
    if cell.chips > 1 and run.CHILD_ENV not in os.environ:
        return run.launch(cell, [sys.executable, os.path.abspath(__file__),
                                 *sys.argv[1:]])
    plant(args.fault)
    out = run.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                       "cpu", float(os.environ.get(run.T0_ENV, run.T0)))
    return run.emit(out, os.environ.get(run.RESULT_ENV))


if __name__ == "__main__":
    sys.exit(main())
