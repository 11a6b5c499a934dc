"""What decides ``correct``: the program's first steps against the plain
reference's, on the same seeded weights and batches.

The window's step object is driven through its first ``check_steps`` steps
in set-up.  Their readings: each step's loss, each leaf's norm of the
first gradient as the optimizer got it (worked out from its state after
one step), and each leaf's norm of its change over the checked steps.  The
reference (``reference/``, fp32) follows the same steps from the same
weights on the same batches, over every rank's batches together where the
cell has several ranks, and gives the same readings.  The numbers
compared:

``loss_gap``
    the largest ``|loss − reference loss| / |reference loss|`` of the steps;
``loss_gap_first``
    the same of the first step alone, which no update has moved yet;
``grad_gap``
    the worst leaf's ``|norm − reference norm|`` of the first gradient,
    over the larger of the reference's norm of that leaf and of the median
    leaf;
``change_gap``
    the same of the change over the checked steps, leaving out the leaves
    whose reference gradient is under a thousandth of the median leaf's
    (a key bias under softmax: it moves by round-off alone);
``grad_gap_median``, ``change_gap_median``
    the median leaf's gap of each, steady from seed to seed where a few
    noisy leaves make the worst leaf swing.

A cell's limits file names the numbers it compares, each with its limit;
the others are printed as readings.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import weights
from .reference import fp32_matmuls
from .reference import optim as ref_optim

#: below this share of the median leaf's reference gradient a leaf's
#: change is round-off
STILL_LEAF = 1e-3

Readings = Dict[str, object]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None
              ) -> List[Tuple[float, str]]:
    """Each leaf's ``(gap, path)`` by the rule in the module docstring,
    sorted."""
    paths = list(keep if keep is not None else ref)
    med = statistics.median(ref[p] for p in paths)
    return sorted((abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30), p)
                  for p in paths)


def numbers(prog: Readings, ref: Readings) -> Dict[str, Tuple[float, str]]:
    """The compared numbers, each with what it was worst at."""
    steps = [(abs(a - b) / abs(b), f"step {i + 1}") for i, (a, b) in
             enumerate(zip(prog["losses"], ref["losses"]))]
    med = statistics.median(ref["grad_norms"].values())
    moving = [p for p, g in ref["grad_norms"].items() if g >= STILL_LEAF * med]
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": max(steps), "loss_gap_first": steps[0],
            "grad_gap": grad[-1], "change_gap": change[-1],
            "grad_gap_median": grad[len(grad) // 2],
            "change_gap_median": change[len(change) // 2]}


def judge(found: Dict[str, Tuple[float, str]], limits: Dict[str, float],
          failed: int) -> Tuple[bool, Dict, List[str]]:
    """(correct, the result line's checks, the lines for standard error):
    the numbers ``limits`` names are compared, the others only shown."""
    checks, ok = {}, failed == 0
    lines = [f"reading {name} {value!r} (at {where}; not compared)"
             for name, (value, where) in found.items() if name not in limits]
    for name, (value, where) in found.items():
        if name not in limits:
            continue
        limit = limits[name]
        ok = ok and value <= limit
        checks[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"({'ok' if value <= limit else 'OVER'}; at {where})")
    checks["failed_steps"] = {"value": failed, "limit": 0}
    lines.append(f"check failed_steps {failed} limit 0")
    return ok, checks, lines


def reference_readings(family, cfg: Dict, seed: int, shards: List[list],
                       steps: int, device, mm=None, group=None,
                       world: int = 1) -> Readings:
    """The reference's readings over ``steps`` steps from the seeded
    weights.  ``shards``: the batch pools this process computes, each a
    list of step batches; a step's loss and gradient are their mean, then
    the mean over the ``world`` processes of ``group`` (which compute the
    other shards).  ``mm`` is the product (fp32 when None)."""
    import torch.distributed as dist
    fp32_matmuls()
    mm = mm or torch.matmul
    lay, n = family.layout(cfg), family.n_layers(cfg)
    params = weights.tree(lay, n, seed, device)
    named = weights.items(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    opt = ref_optim.make(cfg["run_as"]["optimizer"])
    losses, grad_norms = [], None
    for i in range(steps):
        grads = [torch.zeros_like(p) for p in leaves]
        loss = torch.zeros((), device=device)
        for pool in shards:
            ls = family.reference_loss(params, pool[i], cfg, mm)
            for acc, g in zip(grads, torch.autograd.grad(ls, leaves)):
                acc.add_(g, alpha=1.0 / len(shards))
            loss += ls.detach() / len(shards)
        if group is not None:
            for g in grads + [loss]:
                dist.all_reduce(g, group=group)
                g.div_(world)
        losses.append(float(loss))
        if i == 0:
            grad_norms = {p: float(g.norm())
                          for (p, _), g in zip(named, grads)}
        opt.step(leaves, grads)
        del grads
    change = weights.change_norms(params, lay, n, seed, device)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
