"""An elastic worker of the port for the integration tests: run by the
elastic driver as ``python tests/torch_elastic_worker.py`` on the CPU.

Each step allreduces ones (the sum must equal the world size) and appends
a JSON record to ``$TEST_OUT.<worker id>``; ``TEST_MODE=resnet`` also
takes a training step of a tiny ResNet held in a ``TensorState`` and
records the digest of the state at every commit, restore and sync.  Imports neither jax
nor horovod_tpu.
"""

import functools
import hashlib
import json
import os
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.elastic import ObjectState, TensorState, worker
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.tree import tree_leaves, tree_paths

TOTAL = int(os.environ["TEST_TOTAL_STEPS"])
MODE = os.environ.get("TEST_MODE", "sum")
OUT = os.environ["TEST_OUT"] + "." + os.environ["HOROVOD_ELASTIC_WORKER_ID"]
CFG = resnet.ResNetConfig(variant=18, num_classes=10, width=8,
                          dtype=torch.float32)


def record(**rec):
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def digest(state) -> str:
    """sha256 of every leaf's bytes, by sorted path (a step returns the
    batch-norm state in another key order than ``resnet.init``)."""
    h = hashlib.sha256()
    for name in ("params", "state"):
        tree = getattr(state, name)
        for _, t in sorted(zip(tree_paths(tree), tree_leaves(tree)),
                           key=lambda pt: pt[0]):
            h.update(t.detach().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


class RecordedState(TensorState):
    def restore(self):
        super().restore()
        record(restore=True, epoch=worker._last_epoch, rank=hvd.rank(),
               digest=digest(self))

    def sync(self):
        super().sync()
        record(sync=True, epoch=worker._last_epoch, rank=hvd.rank(),
               size=hvd.size(), digest=digest(self))


def make_state():
    if MODE != "resnet":
        return ObjectState(step=0)
    # the first formation starts from one seed; a worker spawned later
    # starts elsewhere, and only its sync makes it equal to the others
    seed = 0 if worker._last_epoch == 0 else 1 + worker.worker_id()
    params, bn = resnet.init(CFG, seed, device="cpu")
    return RecordedState(params=params, state=bn, step=0)


@hvd.elastic.run
def train(state):
    if MODE == "resnet":
        ts = training.make_classifier_train_step(
            lambda p, s, x, train, process_set: resnet.forward(
                p, s, x, CFG, train=train, process_set=process_set),
            lambda seed: resnet.init(CFG, seed, device="cpu"),
            optimizer=functools.partial(torch.optim.SGD, lr=0.05),
            device="cpu")
        opt = ts.opt_init(state.params)
    while state.step < TOTAL:
        n = hvd.size()
        total = hvd.allreduce(torch.ones(1), op=hvd.Sum, name="ones")
        if MODE == "resnet":
            gen = torch.Generator().manual_seed(100 * state.step + hvd.rank())
            x = torch.randn(4, 3, 16, 16, generator=gen)
            y = torch.randint(0, 10, (4,), generator=gen)
            _, state.state, _, loss, _ = ts.step_fn(state.params, state.state,
                                                    opt, x, y)
        record(step=state.step, rank=hvd.rank(), size=n,
               sum=float(total.item()), epoch=worker._last_epoch)
        state.step += 1
        time.sleep(0.2)
        state.save()                   # state.commit(), with a record
        if MODE == "resnet":
            record(commit=True, at=state.step, epoch=worker._last_epoch,
                   rank=hvd.rank(), digest=digest(state))
        state.check_host_updates()
    return state.step


hvd.init(device="cpu")
train(make_state())
hvd.shutdown()
