"""Train-step assembly: the Llama step and the image-classifier step.

Counterpart: ``horovod_tpu/training.py``.  The JAX package compiles one
``shard_map`` program per step; here the step is eager PyTorch: loss and
gradients by autograd (attention through the flash kernels), the gradient
plane, then the optimizer's in-place update.

The step is data-parallel.  When the runtime is initialized (``hvd.init()``;
the mesh then holds the global process set), the gradient plane is:

* by default the engine's: every gradient leaf, in leaf order, and the loss
  are submitted at once as in-place allreduces (op Sum, postscale
  1/(dp·sp), as the JAX step scales after its psum), which the engine plans
  into buckets of ``HOROVOD_FUSION_THRESHOLD`` bytes and reduces over NCCL,
  or gloo, at every world size, 1 included;
* with ``zero1=True`` (ZeRO stage 1) each leaf whose leading axis divides by
  dp is reduce-scattered along it, this rank updates its rows with 1/dp of
  their optimizer state, and the updated rows are all-gathered; the other
  leaves and the loss go through the engine as above;
* with ``overlap=True``, ``DistributedGradientTransform(op=Average,
  overlap=True)``: the model's grad taps dispatch each layer's buckets
  during the backward pass (``optim/overlap.py``), composed with
  ``HOROVOD_COMPRESSION`` and ``HOROVOD_SHARDED_UPDATE``.

``grad_accum=k`` sums the losses and gradients of k microbatches of B/k,
scales them by 1/k, then reduces once and updates once.  Without
``hvd.init()`` the step runs on one device and reduces nothing.

Over a mesh with model axes (tp, sp, a dedicated ep, or MoE experts on
an aliased ep = dp > 1) the step runs the model inside the mesh's
context, each rank on its slice of the params (``param_specs``) and its
cut of the batch (:meth:`TrainStep.shard_batch`), and the gradient rule
is derived from ``param_specs``: a leaf's gradient is summed over each
data axis it is replicated on (dp, sp, a dedicated ep), not over an axis
it is sharded on, and every leaf is scaled by 1/(dp·sp·ep), with the
loss riding along as a replicated leaf.  tp needs no reduction: the
model's copy_to/reduce_from pairs leave tp-replicated and tp-sharded
gradients complete, and the backward all-to-all has already summed the
experts'.  Each axis reduces one flat buffer over its group, outside the
engine.  ``zero1`` there shards the optimizer state of the leaves not
sharded over dp by a reduce-scatter over dp, as on the dp-only path.
Over pp each rank holds its stage's layers and runs the GPipe loop in
``n_microbatches`` microbatches; only the last stage's loss is real and
a masked sum broadcasts it over pp, and the leaves every stage holds (the
tied embedding, the final norm) have their gradients summed over pp.

:func:`make_classifier_train_step` is the data-parallel step of the image
classifiers (ResNet, MNIST): batch norm synchronized over dp through the
model's forward, then the gradients, the loss and the accuracy averaged
through the engine in one submission.

The spec-aware gradient transform (``DistributedGradientTransform(
param_specs=llama.param_specs(par, cfg), model_axes=())`` over the mesh)
takes the model's gradients as they are: the tp ranks share one loss, so
tp is no batch axis and every bucket sums over dp alone.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from . import DeviceLike, api, resolve_device, runtime
from .models import llama as llama_mod
from .models.llama import LlamaConfig, ParallelSpec
from .ops import collectives
from .optim import overlap as overlap_mod
from .optim.distributed import DistributedGradientTransform
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
    # the overlapped step's DistributedGradientTransform (its plan is
    # optim.overlap.plan_for(transform)); None for the other steps
    transform: Any = None
    # this rank's cut of a global [B, T] batch (JAX make_data_sharding)
    shard_batch: Callable = None
    # the FSDP steps' storage specs (fsdp_param_specs); None elsewhere
    specs: Any = None


def sum_scaled_(tensors, names, ps, scale: float) -> None:
    """Allreduce ``tensors`` in place over ``ps`` in one engine submission
    (op Sum, postscale ``scale``), so one cycle plans them into buckets
    together; returns when every one is reduced.  ``names`` must be the
    same on every rank."""
    for h in api._allreduce_each_async_(tensors, names, op=runtime.Sum,
                                        postscale_factor=scale,
                                        process_set=ps):
        h.synchronize()


def resolve_mesh(pmesh: Optional[ParallelMesh],
                 device: DeviceLike = None) -> ParallelMesh:
    """A step's mesh: ``pmesh``; else ``MeshConfig(dp=hvd.size())`` when
    the runtime is initialized; else one device, ``device`` or the CUDA
    device when None (raising without one).  A ``device`` other than the
    mesh's raises."""
    if pmesh is None and runtime.is_initialized():
        pmesh = ParallelMesh(MeshConfig(dp=runtime.size()))
    if pmesh is None:
        return ParallelMesh(MeshConfig(), devices=[resolve_device(device)])
    if device is not None and torch.device(device) != pmesh.devices[0]:
        raise ValueError(f"device={device} is not the mesh's device "
                         f"{pmesh.devices[0]}")
    return pmesh


def trainable_leaves(params):
    """The leaves of ``params``, each set to require a gradient."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


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


def data_cut(pmesh: ParallelMesh, par: ParallelSpec):
    """``cut(x)``: this rank's ``[B/(dp·ep), T/sp]`` block of a global
    ``[B, T]`` batch, the batch split over dp (and a dedicated ep, dp
    major) and the sequence over sp (JAX ``data_spec``)."""
    c = pmesh.config
    rows = c.dp * (c.ep or 1)
    row = pmesh.axis_index("dp") * (c.ep or 1) + (
        pmesh.axis_index("ep") if c.ep else 0)

    def cut(x):
        B, T = x.shape[0], x.shape[1]
        if B % rows or T % c.sp:
            raise ValueError(f"batch {tuple(x.shape)} does not split over "
                             f"{rows} data shards and sp={c.sp}")
        b, t = B // rows, T // c.sp
        s = pmesh.axis_index("sp")
        return x[row * b:(row + 1) * b, s * t:(s + 1) * t]

    return cut


def make_llama_train_step(cfg: LlamaConfig,
                          pmesh: Optional[ParallelMesh] = None,
                          optimizer: Optional[Callable[..., Any]] = None,
                          attn: str = "ring",
                          n_microbatches: int = 0,
                          zero1: bool = False,
                          grad_accum: int = 0,
                          overlap: bool = False,
                          device: DeviceLike = None) -> TrainStep:
    """Build the Llama train step over ``pmesh`` (``zero1``,
    ``grad_accum`` and ``overlap`` as the module docstring says, with the
    JAX package's composition rules: ``overlap`` refuses ``zero1``,
    ``grad_accum``, MoE and meshes other than dp-only, and needs
    ``hvd.init()``).

    ``optimizer`` is a factory called with the list of parameters
    (``optim.precision.adamw_lp(lr)`` or a ``torch.optim`` class bound to
    its hyper-parameters); the default matches ``optax.adamw(3e-4)``.
    The mesh defaults to ``MeshConfig(dp=hvd.size())`` when the runtime is
    initialized, else to one device: ``device``, or the CUDA device when
    ``device`` is None (raising without one; pass ``device="cpu"``).
    ``step_fn`` takes this rank's cut of the batch (``shard_batch``);
    ``init_fn`` returns this rank's slice of the params.
    """
    pmesh = resolve_mesh(pmesh, device)
    device = pmesh.devices[0]
    par = make_llama_parallel_spec(pmesh, attn, use_ep=cfg.n_experts > 0)
    c = pmesh.config
    dp, sp, tp = c.dp, c.sp, c.tp
    ep = c.ep or 1  # a dedicated ep axis multiplies the data parallelism
    if cfg.n_experts > 0 and par.ep_axis is not None:
        ep_size = pmesh.axis_size(par.ep_axis)
        if cfg.n_experts % ep_size:
            raise ValueError(f"n_experts={cfg.n_experts} must divide over "
                             f"{par.ep_axis}={ep_size}")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp
                   or cfg.d_ff % tp):
        raise ValueError(
            f"n_heads={cfg.n_heads}, n_kv_heads={cfg.n_kv_heads} and "
            f"d_ff={cfg.d_ff} must all be divisible by tp={tp}")
    if c.pp > 1 and cfg.n_layers % c.pp:
        raise ValueError(
            f"n_layers={cfg.n_layers} must be divisible by pp={c.pp}")
    if overlap:
        if (tp > 1 or sp > 1 or c.pp > 1 or ep > 1 or zero1 or grad_accum > 1
                or cfg.n_experts > 0):
            raise ValueError(
                "overlap=True currently composes with dp-only DENSE meshes "
                "(the grad taps psum every leaf over dp, but MoE aliases "
                "ep onto dp so expert weights are dp-SHARDED — averaging "
                "them across ranks holding different experts would "
                "corrupt training; tp/sp/pp need the transpose-inserted "
                "psums of the check_vma path) — drop --tp/--sp/--pp/"
                "--zero1/--grad-accum/--moe")
        if pmesh.process_set is None:
            raise ValueError("overlap=True reduces over the runtime's "
                             "process set: call hvd.init() first")
    llama_mod.check_slice(cfg, par)
    make_opt = optimizer if optimizer is not None else default_optimizer
    if device.type == "cuda":
        # full fp32 matmuls: the fp32 loss head and the parity checks
        # against the CPU assume them (TF32 keeps ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # model axes, or experts sharded over dp: the spec-derived step
    model_parallel = (tp > 1 or sp > 1 or c.pp > 1 or ep > 1
                      or par.ep_axis is not None)
    if model_parallel:
        return _model_parallel_step(cfg, pmesh, par, make_opt, zero1,
                                    grad_accum, n_microbatches, device)

    ps = pmesh.process_set
    scale = 1.0 / (dp * sp)
    use_zero = bool(zero1) and dp > 1 and ps is not None

    def zero_rows(p):
        """This rank's rows of a leaf whose leading axis divides by dp
        (None for the others): a view, so the optimizer updates them in
        place."""
        if p.dim() == 0 or p.shape[0] % dp:
            return None
        n = p.shape[0] // dp
        return p.detach()[ps.rank() * n:(ps.rank() + 1) * n]

    def reduce_grads(loss, grads, zero=False):
        # dp and sp average the per-shard mean losses: the summed gradient
        # needs a uniform 1/(dp·sp), and the loss (the JAX step's
        # _mean_loss) the mean over dp (sp is 1 here), the same factor.
        # One submission, so one cycle plans every leaf; the loss rides in
        # a gradient bucket.  With ``zero`` the ZeRO leaves are
        # reduce-scattered first, in path order (the same on every rank),
        # and come back as their rows.
        if ps is None:
            return loss, grads   # one device, no runtime: nothing to sum
        loss = loss.clone()
        paths, leaves = tree_paths(grads), tree_leaves(grads)
        rows = {}
        if zero:
            for path, g in sorted(zip(paths, leaves), key=lambda x: x[0]):
                if g.dim() and g.shape[0] % dp == 0:
                    r = collectives.reduce_scatter_flat(g.reshape(-1), ps)
                    collectives._scale_(r, scale)
                    rows[path] = r.view((g.shape[0] // dp,) + g.shape[1:])
        rest = [(p, g) for p, g in zip(paths, leaves) if p not in rows]
        sum_scaled_([g for _, g in rest] + [loss],
                    [f"grad.{p}" for p, _ in rest] + ["loss"], ps, scale)
        if rows:
            it = iter(paths)
            grads = tree_map(lambda g: rows.get(next(it), g), grads)
        return loss, grads

    def local_loss(params, tokens, targets):
        return llama_mod.loss_fn(params, tokens, targets, cfg, par,
                                 n_microbatches)

    loss_and_grads = _loss_and_grads(local_loss, grad_accum)

    def grads_fn(params, tokens, targets):
        return reduce_grads(*loss_and_grads(params, tokens, targets))

    if overlap:
        tx = DistributedGradientTransform(make_opt, op=runtime.Average,
                                          process_set=ps, overlap=True)

        def step_fn(params, opt_state, tokens, targets):
            leaves = tree_leaves(params)
            with overlap_mod.overlapped_backprop(tx):
                loss = local_loss(params, tokens, targets)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            it = iter(grads)
            tx.update(tree_map(lambda _: next(it), params), opt_state,
                      params)
            loss = api.allreduce(loss.detach(), op=runtime.Average,
                                 name="loss", process_set=ps)
            return params, opt_state, loss

        def opt_init(params):
            trainable_leaves(params)
            return tx.init(params)
    else:
        def step_fn(params, opt_state, tokens, targets):
            loss, grads = reduce_grads(
                *loss_and_grads(params, tokens, targets), zero=use_zero)
            _apply(params, grads, opt_state, use_zero)
            if use_zero:
                _gather_rows(params, opt_state.hvd_rows, ps)
            return params, opt_state, loss

        def opt_init(params):
            return _make_opt(make_opt, params,
                             zero_rows if use_zero else None)

    def init_fn(seed: int = 0):
        params = llama_mod.init_params(cfg, seed, device=device)
        return params, opt_init(params)

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     grads_fn=grads_fn, par=par, mesh=pmesh, device=device,
                     transform=tx if overlap else None,
                     shard_batch=data_cut(pmesh, par))


def _loss_and_grads(local_loss, grad_accum: int):
    """``(params, tokens, targets) -> (loss, grads)`` of one pass, or with
    ``grad_accum=k`` of k microbatches of B/k, their losses and gradients
    summed, then scaled by 1/k (the JAX step's lax.scan of
    value_and_grad)."""

    def one_pass(params, tokens, targets):
        loss = local_loss(params, tokens, targets)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def loss_and_grads(params, tokens, targets):
        if grad_accum <= 1:
            return one_pass(params, tokens, targets)
        k = grad_accum
        B = tokens.shape[0]
        if B % k:
            raise ValueError(
                f"local batch {B} not divisible by grad_accum={k}")
        mb = B // k
        loss, grads = one_pass(params, tokens[:mb], targets[:mb])
        for i in range(1, k):
            l_i, g_i = one_pass(params, tokens[i * mb:(i + 1) * mb],
                                targets[i * mb:(i + 1) * mb])
            loss = loss + l_i
            for a, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                a.add_(g)
            del g_i
        inv_k = 1.0 / k
        for g in tree_leaves(grads):
            collectives._scale_(g, inv_k)
        return loss * inv_k, grads

    return loss_and_grads


def _make_opt(make_opt, params, zero_rows=None):
    """The optimizer over ``params``' leaves or, with ``zero_rows``
    (leaf → this rank's row view or None), over the ZeRO rows; the views
    ride along as ``opt.hvd_rows``."""
    leaves = trainable_leaves(params)
    if zero_rows is None:
        return make_opt(leaves)
    views = [zero_rows(p) for p in leaves]
    opt = make_opt([v if v is not None else p
                    for p, v in zip(leaves, views)])
    opt.hvd_rows = views
    return opt


def _apply(params, grads, opt_state, zero: bool) -> None:
    """Set each leaf's (or ZeRO row view's) gradient, step, clear."""
    views = opt_state.hvd_rows if zero else None
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        (views[i] if views and views[i] is not None else p).grad = g
    opt_state.step()
    opt_state.zero_grad(set_to_none=True)


def _gather_rows(params, views, group) -> None:
    """Every rank's updated ZeRO rows back into the full leaves, in path
    order (the same on every rank)."""
    with torch.no_grad():
        for _, p, r in sorted(zip(tree_paths(params), tree_leaves(params),
                                  views), key=lambda x: x[0]):
            if r is not None:
                p.view(-1).copy_(collectives.all_gather_flat(
                    r.reshape(-1), group))


def _model_parallel_step(cfg: LlamaConfig, pmesh: ParallelMesh,
                         par: ParallelSpec, make_opt, zero1: bool,
                         grad_accum: int, n_microbatches: int,
                         device: torch.device) -> TrainStep:
    """The step over a mesh with model axes: the module docstring's
    spec-derived gradient rule."""
    from . import convert
    from .parallel import axis as ax
    c = pmesh.config
    dp = c.dp
    scale = 1.0 / (dp * c.sp * (c.ep or 1))
    specs = llama_mod.param_specs(par, cfg)
    # the data axes, each reduced over its group in this order
    data_axes = [a for a in ("sp", "ep", "dp")
                 if a in pmesh.axis_names and pmesh.axis_size(a) > 1
                 and pmesh.group(a) is not None]
    dp_group = pmesh.group("dp")
    use_zero = bool(zero1) and dp > 1

    def axes_of(path):
        return llama_mod.leaf_axes(specs, path, par)

    def zero_leaf(path, p):
        return (use_zero and "dp" not in axes_of(path) and p.dim() > 0
                and p.shape[0] % dp == 0)

    def reduce_grads(loss, grads, zero=False):
        paths, leaves = tree_paths(grads), tree_leaves(grads)
        leaves = list(leaves) + [loss]
        owned = [axes_of(p) for p in paths] + [set()]
        zeroed = {i for i, (p, g) in enumerate(zip(paths, leaves))
                  if zero and zero_leaf(p, g)}
        for a in data_axes:
            if a == "dp" and zeroed:
                for i in sorted(zeroed, key=lambda i: paths[i]):
                    g = leaves[i]
                    r = collectives.reduce_scatter_flat(g.reshape(-1),
                                                        dp_group)
                    leaves[i] = r.view((g.shape[0] // dp,) + g.shape[1:])
            idx = [i for i, o in enumerate(owned)
                   if a not in o and not (a == "dp" and i in zeroed)]
            if not idx:
                continue
            flat = torch.cat([leaves[i].reshape(-1).float() for i in idx])
            flat = ax._all_reduce(flat, pmesh.group(a), a)
            for i, chunk in zip(idx, flat.split(
                    [leaves[i].numel() for i in idx])):
                leaves[i] = chunk.view(leaves[i].shape).to(leaves[i].dtype)
        if par.pp_axis is not None:
            # the leaves every stage holds: the stages' contributions sum
            # (the loss is already the same on every stage)
            idx = [i for i, o in enumerate(owned[:-1]) if "pp" not in o]
            flat = torch.cat([leaves[i].reshape(-1).float() for i in idx])
            flat = ax._all_reduce(flat, pmesh.group("pp"), "pp")
            for i, chunk in zip(idx, flat.split(
                    [leaves[i].numel() for i in idx])):
                leaves[i] = chunk.view(leaves[i].shape).to(leaves[i].dtype)
        if scale != 1.0:
            leaves = [t.clone() for t in leaves]
            for t in leaves:
                collectives._scale_(t, scale)
        it = iter(leaves)
        grads = tree_map(lambda _: next(it), grads)
        return next(it), grads

    def local_loss(params, tokens, targets):
        loss = llama_mod.loss_fn(params, tokens, targets, cfg, par,
                                 n_microbatches)
        if par.pp_axis is not None:
            # only the last stage's loss is real: a masked sum over pp
            # (identity backward, JAX's psum) gives it to every stage
            last = pmesh.axis_index("pp") == c.pp - 1
            loss = ax.reduce_from(loss * float(last), par.pp_axis)
        return loss

    loss_and_grads = _loss_and_grads(local_loss, grad_accum)

    def run(params, tokens, targets):
        # the backward's collectives find the mesh through their ctx; the
        # forward's (and a rematerialized block's) through the context
        with pmesh:
            return loss_and_grads(params, tokens, targets)

    def grads_fn(params, tokens, targets):
        return reduce_grads(*run(params, tokens, targets))

    def zero_rows_of(params):
        paths = iter(tree_paths(params))

        def rows(p):
            path = next(paths)
            if not zero_leaf(path, p):
                return None
            n = p.shape[0] // dp
            i = pmesh.axis_index("dp")
            return p.detach()[i * n:(i + 1) * n]

        return rows

    def step_fn(params, opt_state, tokens, targets):
        loss, grads = reduce_grads(*run(params, tokens, targets),
                                   zero=use_zero)
        _apply(params, grads, opt_state, use_zero)
        if use_zero:
            _gather_rows(params, opt_state.hvd_rows, dp_group)
        return params, opt_state, loss

    def opt_init(params):
        return _make_opt(make_opt, params,
                         zero_rows_of(params) if use_zero else None)

    def init_fn(seed: int = 0):
        full = llama_mod.init_params(cfg, seed, tp=c.tp, device=device)
        params = convert.llama_shard_params(full, cfg, pmesh, par)
        del full
        return params, opt_init(params)

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     grads_fn=grads_fn, par=par, mesh=pmesh, device=device,
                     shard_batch=data_cut(pmesh, par))


def fsdp_param_specs(param_shapes, dp: int, axis: str = "dp"):
    """FSDP shardings (JAX ``training.fsdp_param_specs``): each leaf of
    ``param_shapes`` (tensors, of any device, or anything with a
    ``shape``) shards its largest dp-divisible dim over ``axis``, the
    first such dim on a tie; a leaf with none stays replicated (``()``).
    The specs are per dim, as ``models.llama.param_specs``'s.  JAX never
    shards a stacked layer leaf's scan dim 0; the port's per-layer leaves
    have no such dim, so every dim may shard and a layer leaf's dim is
    JAX's minus 1."""
    def spec_for(t):
        dims = tuple(t.shape)
        best, best_i = 0, None
        for i, d in enumerate(dims):
            if d % dp == 0 and d > best:
                best, best_i = d, i
        if best_i is None:
            return ()
        return tuple(axis if i == best_i else None for i in range(len(dims)))

    return tree_map(spec_for, param_shapes)


def _spec_dim(spec, axis: str):
    """The dim ``spec`` shards over ``axis`` (None for none)."""
    return spec.index(axis) if axis in spec else None


def spec_all_gather(tree, specs, axis: str):
    """The full value of every leaf whose spec names ``axis``: a tiled
    all-gather over the axis's group of the current mesh along that dim,
    whose backward reduce-scatters the cotangent (JAX's transpose of a
    tiled ``all_gather``); other leaves pass through.  Run inside ``with
    pmesh:``."""
    from .parallel import axis as ax
    paths = iter(tree_paths(tree))

    def gather(t):
        dim = _spec_dim(llama_mod.leaf_spec(specs, next(paths)), axis)
        return t if dim is None else ax.all_gather_scatter(t, axis, dim)

    return tree_map(gather, tree)


def spec_shard(tree, specs, axis: str):
    """This rank's slice of every leaf whose spec names ``axis``, along
    that dim (views; the inverse of :func:`spec_all_gather`).  Run inside
    ``with pmesh:``."""
    from .parallel import axis as ax
    n, i = ax.axis_size(axis), ax.axis_index(axis)
    paths = iter(tree_paths(tree))

    def shard(t):
        dim = _spec_dim(llama_mod.leaf_spec(specs, next(paths)), axis)
        if dim is None:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, i * size, size)

    return tree_map(shard, tree)


def _fsdp_refuse(cfg: LlamaConfig, pmesh: ParallelMesh) -> None:
    """The JAX package's refusals, with its messages."""
    if cfg.n_experts > 0:
        raise ValueError(
            "make_llama_fsdp_step does not support MoE: expert "
            "parallelism aliases the ep axis onto dp, so expert "
            "weights are dp-SHARDED by routing — FSDP's dp-gathered "
            "working copy (and any dp-averaging gradient plane) would "
            "mix weights of DIFFERENT experts across ranks; use "
            "make_llama_train_step for MoE")
    for a in ("tp", "pp", "sp"):
        if getattr(pmesh.config, a) > 1:
            raise ValueError(
                f"make_llama_fsdp_step does not compose with {a}>1: "
                f"the model is sharded over the {a!r} axis, but this "
                f"step only gathers/scatters over dp — use "
                f"make_llama_train_step (optionally with zero1) for "
                f"{a} meshes")
    if (pmesh.config.ep or 1) > 1:
        raise ValueError(
            "make_llama_fsdp_step does not compose with a dedicated "
            "ep axis: expert routing shards weights over ep, which "
            "this step does not gather over — use "
            "make_llama_train_step for MoE/ep meshes")


def make_llama_fsdp_step(cfg: LlamaConfig,
                         pmesh: Optional[ParallelMesh] = None,
                         optimizer: Optional[Callable[..., Any]] = None,
                         overlap: bool = False,
                         device: DeviceLike = None) -> TrainStep:
    """Fully sharded data parallelism (ZeRO-3 class; JAX
    ``training.make_llama_fsdp_step``): the params, their gradients and
    the optimizer state live as 1/dp shards by :func:`fsdp_param_specs`.

    With ``overlap=False`` the root leaves are gathered before the model
    and each layer's weights just in time inside its (rematerialized)
    block, so one layer is resident unsharded at a time (a recompute
    gathers it again); the gathers' backward reduce-scatters the
    gradients, which are averaged over dp (a replicated leaf's by an
    all-reduce), and the optimizer steps the shards.  With
    ``overlap=True`` one gather makes the working copy, the model's grad
    taps reduce-scatter each layer's buckets in the backward pass
    (``DistributedGradientTransform(overlap=True, sharded_update=True)``,
    its 1/dp tiles the optimizer state), and the updated copy is sliced
    back into the shards; the working copy's storage is freed between
    steps, its tensors kept (the taps know the leaves by identity).

    ``step_fn(params, opt_state, tokens, targets)`` takes this rank's
    shards and its rows of the batch (``shard_batch``) and returns the
    loss averaged over dp.  The mesh, the optimizer factory and
    ``device`` as in :func:`make_llama_train_step`; MoE, tp, pp, sp and a
    dedicated ep raise with the JAX package's messages.
    """
    pmesh = resolve_mesh(pmesh, device)
    _fsdp_refuse(cfg, pmesh)
    device = pmesh.devices[0]
    dp = pmesh.config.dp
    make_opt = optimizer if optimizer is not None else default_optimizer
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    shapes = llama_mod.init_params(cfg, device="meta")
    specs = fsdp_param_specs(shapes, dp)
    par = ParallelSpec()
    if overlap:
        return _make_llama_fsdp_overlap_step(cfg, pmesh, make_opt, specs,
                                             par, device)

    def gather_layer(lp):
        return spec_all_gather(lp, specs["layers"][0], "dp")

    def loss_and_grads(params, tokens, targets):
        leaves = tree_leaves(params)
        with pmesh:
            root = spec_all_gather(
                {k: params[k] for k in ("embed", "final_norm")},
                {k: specs[k] for k in ("embed", "final_norm")}, "dp")
            loss = llama_mod.loss_fn(dict(params, **root), tokens, targets,
                                     cfg, par, gather=gather_layer)
            grads = list(torch.autograd.grad(loss, leaves))
        return loss.detach(), grads

    # the leaves no dim of which divides by dp: whole on every rank
    rep = [i for i, p in enumerate(tree_paths(shapes))
           if _spec_dim(llama_mod.leaf_spec(specs, p), "dp") is None]

    def reduce(loss, grads):
        """The loss and the replicated leaves' gradients summed over dp,
        then every gradient and the loss scaled by 1/dp."""
        from .parallel import axis as ax
        group = pmesh.group("dp")
        parts = [grads[i] for i in rep] + [loss.reshape(1)]
        if group is not None:
            flat = ax._all_reduce(torch.cat([t.reshape(-1).float()
                                             for t in parts]), group, "dp")
            parts = [c.view(t.shape).to(t.dtype) for c, t in zip(
                flat.split([t.numel() for t in parts]), parts)]
        for i, t in zip(rep, parts):
            grads[i] = t
        loss = parts[-1].reshape(())
        if dp > 1:
            grads = [g.mul_(1.0 / dp) if g.is_floating_point() else g
                     for g in grads]
            loss = loss / dp
        return loss, grads

    def grads_fn(params, tokens, targets):
        loss, grads = reduce(*loss_and_grads(params, tokens, targets))
        it = iter(grads)
        return loss, tree_map(lambda _: next(it), params)

    def step_fn(params, opt_state, tokens, targets):
        loss, grads = reduce(*loss_and_grads(params, tokens, targets))
        _apply(params, grads, opt_state, False)
        return params, opt_state, loss

    def opt_init(params):
        return _make_opt(make_opt, params)

    def init_fn(seed: int = 0):
        params = _fsdp_shards(cfg, seed, pmesh, specs, device)
        return params, opt_init(params)

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     grads_fn=grads_fn, par=par, mesh=pmesh, device=device,
                     shard_batch=data_cut(pmesh, par), specs=specs)


def _fsdp_shards(cfg: LlamaConfig, seed: int, pmesh: ParallelMesh, specs,
                 device: torch.device):
    """This rank's shards of ``init_params(cfg, seed)``: new contiguous
    tensors (the full params are dropped)."""
    full = llama_mod.init_params(cfg, seed, device=device)
    with pmesh:
        return tree_map(lambda t: t.clone().contiguous(),
                        spec_shard(full, specs, "dp"))


def _make_llama_fsdp_overlap_step(cfg: LlamaConfig, pmesh: ParallelMesh,
                                  make_opt, specs, par: ParallelSpec,
                                  device: torch.device) -> TrainStep:
    """FSDP storage with the overlapped gradient plane (see
    :func:`make_llama_fsdp_step`)."""
    from .parallel import axis as ax
    ps = pmesh.process_set
    if ps is None:
        raise ValueError("overlap=True reduces over the runtime's "
                         "process set: call hvd.init() first")
    tx = DistributedGradientTransform(make_opt, op=runtime.Average,
                                      process_set=ps, overlap=True,
                                      sharded_update=True)
    work = {}

    def materialize(params):
        """The working copy's tensors (made once, kept) holding the
        gathered full values."""
        with pmesh, torch.no_grad():
            full = spec_all_gather(params, specs, "dp")
        if not work:
            work["tree"] = tree_map(lambda t: t.detach().requires_grad_(),
                                    full)
        else:
            for w, f in zip(tree_leaves(work["tree"]), tree_leaves(full)):
                w.data = f
        return work["tree"]

    def release(params):
        """The updated working copy sliced back into the shards, its
        storage freed."""
        with pmesh, torch.no_grad():
            for p, s in zip(tree_leaves(params), tree_leaves(
                    spec_shard(work["tree"], specs, "dp"))):
                p.copy_(s)
        for w in tree_leaves(work["tree"]):
            w.data = w.data.new_empty(0)

    def step_fn(params, opt_state, tokens, targets):
        full = materialize(params)
        leaves = tree_leaves(full)
        with overlap_mod.overlapped_backprop(tx):
            loss = llama_mod.loss_fn(full, tokens, targets, cfg, par)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(grads)
        tx.update(tree_map(lambda _: next(it), full), opt_state, full)
        release(params)
        loss = loss.detach()
        if pmesh.config.dp > 1:
            loss = ax._all_reduce(loss, pmesh.group("dp"), "dp") / \
                pmesh.config.dp
        return params, opt_state, loss

    def opt_init(params):
        state = tx.init(materialize(params))
        for w in tree_leaves(work["tree"]):
            w.data = w.data.new_empty(0)
        return state

    def init_fn(seed: int = 0):
        params = _fsdp_shards(cfg, seed, pmesh, specs, device)
        return params, opt_init(params)

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     grads_fn=None, par=par, mesh=pmesh, device=device,
                     transform=tx, shard_batch=data_cut(pmesh, par),
                     specs=specs)


#: ``optax.sgd(0.1, momentum=0.9)``, the JAX classifier step's default:
#: torch's SGD with dampening 0 and no Nesterov keeps the same trace
default_classifier_optimizer = functools.partial(torch.optim.SGD, lr=0.1,
                                                 momentum=0.9)


@dataclasses.dataclass
class ClassifierTrainStep:
    """A data-parallel image-classifier step (BASELINE configs 1, 2, 5)."""
    step_fn: Callable   # (params, state, opt_state, images, labels) ->
    #                     (params, state, opt_state, loss, accuracy)
    init_fn: Callable   # (seed) -> (params, state, opt_state)
    eval_fn: Callable   # (params, state, images) -> logits
    opt_init: Callable  # (params) -> opt_state
    mesh: ParallelMesh
    device: torch.device


def make_classifier_train_step(forward_fn: Callable, model_init_fn: Callable,
                               pmesh: Optional[ParallelMesh] = None,
                               optimizer: Optional[Callable[..., Any]] = None,
                               sync_bn: bool = True,
                               device: DeviceLike = None
                               ) -> ClassifierTrainStep:
    """The data-parallel training step of an image classifier.

    ``forward_fn(params, state, images, train, process_set)`` returns
    ``(logits, new_state)``: stateless models pass ``state`` through.
    ``model_init_fn(seed)`` returns ``(params, state)``, which ``init_fn``
    moves to the step's device.  With ``sync_bn`` the forward gets the dp
    process set, over which batch norm computes its statistics; without
    it each rank normalizes over its own batch and the new batch-norm
    state is averaged over dp, so the replicas stay equal.

    ``optimizer`` is a factory called with the list of parameters; the
    default matches ``optax.sgd(0.1, momentum=0.9)``.  The mesh as in
    :func:`make_llama_train_step`.
    """
    pmesh = resolve_mesh(pmesh, device)
    device = pmesh.devices[0]
    ps, dp = pmesh.process_set, pmesh.config.dp
    reduce = ps is not None and dp > 1
    bn_ps = ps if (sync_bn and reduce) else None
    make_opt = optimizer if optimizer is not None \
        else default_classifier_optimizer

    def step_fn(params, state, opt_state, images, labels):
        logits, state = forward_fn(params, state, images, train=True,
                                   process_set=bn_ps)
        loss = F.cross_entropy(logits, labels.long())
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        loss.backward()
        loss = loss.detach()
        if reduce:
            # the per-rank means, summed and scaled by 1/dp: the gradient
            # of the global batch's mean loss, its loss and its accuracy
            grads = [p.grad for p in tree_leaves(params)]
            sum_scaled_(grads + [loss, acc],
                        [f"grad.{p}" for p in tree_paths(params)]
                        + ["loss", "accuracy"], ps, 1.0 / dp)
            stats = tree_leaves(state)
            if not sync_bn and stats:
                sum_scaled_(stats, [f"state.{p}" for p in tree_paths(state)],
                            ps, 1.0 / dp)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, state, opt_state, loss, acc

    def eval_fn(params, state, images):
        with torch.no_grad():
            return forward_fn(params, state, images, train=False,
                              process_set=None)[0]

    def opt_init(params):
        return make_opt(trainable_leaves(params))

    def init_fn(seed: int = 0):
        params, state = tree_map(lambda t: t.to(device), model_init_fn(seed))
        return params, state, opt_init(params)

    return ClassifierTrainStep(step_fn=step_fn, init_fn=init_fn,
                               eval_fn=eval_fn, opt_init=opt_init,
                               mesh=pmesh, device=device)
