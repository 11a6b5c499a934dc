"""Train-step assembly for the Llama model.

Counterpart: ``horovod_tpu/training.py``.  The JAX package compiles one
``shard_map`` program per step; here the step is eager PyTorch: loss and
gradients by autograd (attention through the flash kernels), the gradient
plane, then the optimizer's in-place update.

The step is data-parallel and non-overlapped (the JAX ``shard_step``).
When the runtime is initialized (``hvd.init()``; the mesh then holds the
global process set), the gradient plane is the engine's: every gradient
leaf, in leaf order, and the loss are submitted at once as in-place
allreduces (op Sum, postscale 1/(dp·sp), as the JAX step scales after its
psum), which the engine plans into buckets of ``HOROVOD_FUSION_THRESHOLD``
bytes and reduces over NCCL, or gloo, at every world size, 1 included.
Without ``hvd.init()`` the step runs on one device and reduces nothing.
``overlap=True``, ``zero1``, ``grad_accum > 1`` and ``attn="ulysses"``
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from . import DeviceLike, api, resolve_device, runtime
from .models import llama as llama_mod
from .models.llama import LlamaConfig, ParallelSpec
from .parallel.mesh import MeshConfig, ParallelMesh
from .tree import tree_leaves, tree_map, tree_paths

#: ``optax.adamw(3e-4)``, the JAX step's default optimizer
default_optimizer = functools.partial(torch.optim.AdamW, lr=3e-4,
                                      weight_decay=1e-4, eps=1e-8)


@dataclasses.dataclass
class TrainStep:
    """A training step over one model and mesh."""
    step_fn: Callable   # (params, opt_state, tokens, targets) -> (params, opt_state, loss)
    init_fn: Callable   # (seed) -> (params, opt_state)
    opt_init: Callable  # (params) -> opt_state
    grads_fn: Callable  # (params, tokens, targets) -> (loss, grads)
    par: ParallelSpec
    mesh: ParallelMesh
    device: torch.device


def _axis_or_none(pmesh: ParallelMesh, name: str) -> Optional[str]:
    return name if pmesh.config.axis_sizes()[name] > 1 else None


def make_llama_parallel_spec(pmesh: ParallelMesh, attn: str = "ring",
                             use_ep: bool = False) -> ParallelSpec:
    ep = pmesh.ep_axis if use_ep else None
    if ep is not None and pmesh.axis_size(ep) <= 1:
        ep = None
    return ParallelSpec(
        dp_axis=_axis_or_none(pmesh, "dp"),
        tp_axis=_axis_or_none(pmesh, "tp"),
        sp_axis=_axis_or_none(pmesh, "sp"),
        pp_axis=_axis_or_none(pmesh, "pp"),
        ep_axis=ep,
        attn=attn)


def make_llama_train_step(cfg: LlamaConfig,
                          pmesh: Optional[ParallelMesh] = None,
                          optimizer: Optional[Callable[..., Any]] = None,
                          attn: str = "ring",
                          n_microbatches: int = 0,
                          zero1: bool = False,
                          grad_accum: int = 0,
                          overlap: bool = False,
                          device: DeviceLike = None) -> TrainStep:
    """Build the data-parallel Llama train step.

    ``optimizer`` is a factory called with the list of parameters
    (``optim.precision.adamw_lp(lr)`` or a ``torch.optim`` class bound to
    its hyper-parameters); the default matches ``optax.adamw(3e-4)``.
    The mesh defaults to ``MeshConfig(dp=hvd.size())`` when the runtime is
    initialized, else to one device: ``device``, or the CUDA device when
    ``device`` is None (raising without one; pass ``device="cpu"``).
    """
    for flag, on, item in (("overlap=True", overlap, "A5"),
                           ("zero1=True", zero1, "A5"),
                           (f"grad_accum={grad_accum}", grad_accum > 1, "A5"),
                           ("attn='ulysses'", attn == "ulysses", "A6")):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md {item})")
    if pmesh is None and runtime.is_initialized():
        pmesh = ParallelMesh(MeshConfig(dp=runtime.size()))
    if pmesh is None:
        pmesh = ParallelMesh(MeshConfig(), devices=[resolve_device(device)])
    elif device is not None and torch.device(device) != pmesh.devices[0]:
        raise ValueError(f"device={device} is not the mesh's device "
                         f"{pmesh.devices[0]}")
    device = pmesh.devices[0]
    par = make_llama_parallel_spec(pmesh, attn, use_ep=cfg.n_experts > 0)
    llama_mod.check_slice(cfg, par)
    make_opt = optimizer if optimizer is not None else default_optimizer
    dp, sp = pmesh.config.dp, pmesh.config.sp
    if device.type == "cuda":
        # full fp32 matmuls: the fp32 loss head and the parity checks
        # against the CPU assume them (TF32 keeps ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def reduce_grads(loss, grads):
        # dp and sp average the per-shard mean losses: the summed gradient
        # needs a uniform 1/(dp·sp), and the loss (the JAX step's
        # _mean_loss) the mean over dp (sp is 1 here), the same factor.
        # One submission, so one cycle plans every leaf; the loss rides in
        # a gradient bucket.
        if pmesh.process_set is None:
            return loss, grads   # one device, no runtime: nothing to sum
        loss = loss.clone()
        leaves = tree_leaves(grads) + [loss]
        names = [f"grad.{p}" for p in tree_paths(grads)] + ["loss"]
        for h in api._allreduce_each_async_(
                leaves, names, op=runtime.Sum,
                postscale_factor=1.0 / (dp * sp),
                process_set=pmesh.process_set):
            h.synchronize()
        return loss, grads

    def local_loss(params, tokens, targets):
        return llama_mod.loss_fn(params, tokens, targets, cfg, par,
                                 n_microbatches)

    def loss_and_grads(params, tokens, targets):
        loss = local_loss(params, tokens, targets)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def grads_fn(params, tokens, targets):
        return reduce_grads(*loss_and_grads(params, tokens, targets))

    def step_fn(params, opt_state, tokens, targets):
        loss, grads = reduce_grads(*loss_and_grads(params, tokens, targets))
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    def opt_init(params):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return make_opt(leaves)

    def init_fn(seed: int = 0):
        params = llama_mod.init_params(cfg, seed, device=device)
        return params, opt_init(params)

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     grads_fn=grads_fn, par=par, mesh=pmesh, device=device)
