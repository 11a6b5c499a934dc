"""Readings that set the limits' upper ends: the lower-precision control
and the planted faults, each in the program's place against the fp32
reference, at a cell's own sizes.

    python3 -m hvdbench.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed with the compared numbers (``check.py``) of
each variant below, judged against the cell's limits as a run judges the
program (``correct``, and each limit's ``checks``):

``control``
    the reference with every matrix product on fp8 operands
    (``reference/precision.Fp8Matmul``), the precision below the bf16 the
    configurations state;
``half_batch``
    the fp32 reference with half of every batch left out, the mean taken
    over the rest;
``no_exchange``
    (cells on several ranks) the fp32 reference over rank 0's batches
    alone: the exchange between chips left out.

A state left unchanged reads 1 by ``change_gap`` and needs no run.  Every
rank's batches are computed here in turn on one card, so the readings are
of the cell's whole batch.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from hvdbench import cells, check
from hvdbench.reference.precision import Fp8Matmul


def _half(pool):
    return [tuple(t[:t.shape[0] // 2] for t in batch) for batch in pool]


def readings(cell: cells.Cell, seed: int, device) -> dict:
    fam, cfg, traffic = cell.family, cell.config, cell.traffic
    steps = traffic["check_steps"]
    pools = [fam.batches(cfg, traffic, seed, r, device)
             for r in range(cell.chips)]

    def run(shards, mm=None):
        return check.reference_readings(fam, cfg, seed, shards, steps,
                                        device, mm=mm)

    ref = run(pools)
    out = {"seed": seed, "reference_losses": ref["losses"]}
    variants = {"control": (pools, Fp8Matmul()),
                "half_batch": ([_half(p) for p in pools], None)}
    if len(pools) > 1:
        variants["no_exchange"] = (pools[:1], None)
    for name, (shards, mm) in variants.items():
        found = check.numbers(run(shards, mm), ref)
        correct, checks, _ = check.judge(found, cell.limits, 0)
        out[name] = {"correct": correct, "checks": checks,
                     **{k: {"value": v, "worst_at": w}
                        for k, (v, w) in found.items()}}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="hvdbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, e.g. 11,12,13")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    cell = cells.load(args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, device)), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
