"""Shared data-parallel training loop for the estimator workers.

Counterpart: ``horovod_tpu/estimator/_worker.py``.  Runs inside the
processes ``runner.run`` launches, each with the runtime initialized on
its device.  The Torch and Lightning estimators both drive this loop;
they differ only in how a batch becomes a loss (``loss_of_batch``) and in
what they send back.

The per-epoch step count is the GLOBAL MINIMUM of every rank's batch
count (``X[rank::size]`` shards differ by up to one sample): each
``opt.step()`` issues gradient all-reduces, so ranks must take exactly
the same number of steps or the collectives desynchronize.

``validation`` (reference: the Spark estimators' ``validation`` param)
holds out that fraction of each rank's shard before training; the
per-epoch validation loss is reduced as a (sum, count) pair so ranks
with differently-sized (even empty) validation shards stay in lockstep.

The shards, the split and the shuffles are the JAX package's, drawn on
the CPU from the same seeds; each batch moves to the device as it is
taken, so a fit on the card sees the batches a CPU fit sees.
"""

from __future__ import annotations

from typing import Callable, Dict, List


def run_data_parallel_training(model, optimizer,
                               loss_of_batch: Callable,
                               X, y, epochs: int, batch_size: int,
                               seed: int, shuffle: bool = True,
                               validation: float = 0.0,
                               pre_sharded: bool = False
                               ) -> Dict[str, List[float]]:
    """Train ``model`` (already on this rank's device) data-parallel;
    returns per-epoch histories ``{"loss": [...], "val_loss": [...]}``
    (``val_loss`` empty when ``validation`` is 0).

    ``loss_of_batch(model, xb, yb, step_idx) -> scalar torch loss``
    (``step_idx`` is the within-epoch batch index — Lightning's
    ``training_step`` contract receives it).

    ``pre_sharded=True`` means ``X``/``y`` are already THIS rank's shard
    (the on-disk data plane reads ``rank::size`` rows itself); otherwise
    the global arrays are strided here.
    """
    import numpy as np
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.runtime import device

    rank, size = hvd.rank(), hvd.size()
    dev = device()
    opt = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    if pre_sharded:
        Xs = torch.from_numpy(np.ascontiguousarray(X))
        ys = torch.from_numpy(np.ascontiguousarray(y))
    else:
        Xs = torch.from_numpy(np.ascontiguousarray(X[rank::size]))
        ys = torch.from_numpy(np.ascontiguousarray(y[rank::size]))
    Xv = yv = None
    if validation > 0.0:
        n_val = int(len(Xs) * validation)
        split_gen = torch.Generator().manual_seed(seed + 977)
        perm = torch.randperm(len(Xs), generator=split_gen)
        Xv, yv = Xs[perm[:n_val]], ys[perm[:n_val]]
        Xs, ys = Xs[perm[n_val:]], ys[perm[n_val:]]
    gen = torch.Generator().manual_seed(seed + rank)
    steps_per_epoch = int(hvd.allreduce(
        torch.tensor(float(len(Xs) // batch_size), device=dev), op=hvd.Min,
        name="estimator.steps_per_epoch"))

    history: Dict[str, List[float]] = {"loss": [], "val_loss": []}
    for _ in range(epochs):
        order = (torch.randperm(len(Xs), generator=gen) if shuffle
                 else torch.arange(len(Xs)))
        epoch_loss = 0.0
        for s in range(steps_per_epoch):
            idx = order[s * batch_size:(s + 1) * batch_size]
            opt.zero_grad()
            loss = loss_of_batch(model, Xs[idx].to(dev), ys[idx].to(dev), s)
            loss.backward()
            opt.step()
            epoch_loss += float(loss.detach())
        avg = hvd.allreduce(
            torch.tensor(epoch_loss / max(steps_per_epoch, 1), device=dev),
            name="estimator.epoch_loss")
        history["loss"].append(float(avg))

        if validation > 0.0:
            vsum, vcnt = 0.0, 0
            model.eval()
            with torch.no_grad():
                for s in range(0, len(Xv), batch_size):
                    xb, yb = Xv[s:s + batch_size], yv[s:s + batch_size]
                    vsum += float(loss_of_batch(
                        model, xb.to(dev), yb.to(dev),
                        s // batch_size)) * len(xb)
                    vcnt += len(xb)
            model.train()
            # (sum, count) reduce: ranks may hold different (even zero)
            # validation counts without desynchronizing
            tot = hvd.allreduce(torch.tensor([vsum, float(vcnt)], device=dev),
                                op=hvd.Sum, name="estimator.val_loss")
            history["val_loss"].append(
                float(tot[0]) / max(float(tot[1]), 1.0))
    return history
