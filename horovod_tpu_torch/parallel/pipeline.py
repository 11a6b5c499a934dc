"""Pipeline parallelism: GPipe microbatch streaming over the pp axis.

Counterpart: ``horovod_tpu/parallel/pipeline.py``.  Each rank of a pp line
holds one stage's parameters; ``n_micro + n_stages - 1`` ticks stream the
microbatches through the stages, one ``parallel.axis.ppermute`` hop from
stage s to s + 1 a tick, and autograd runs the hops backwards.

The JAX loop runs every stage on every tick inside one compiled scan,
fill and drain ticks on clamped garbage.  Here a stage computes only on
its live ticks (stage s at tick t when ``0 <= t - s < n_micro``) and
passes its input through on the others, so a rank launches its stage's
kernels ``n_micro`` times a step.  Every rank still joins every hop but
the last tick's (whose result JAX discards too): a hop is a matched send
and receive over gloo, and its backward runs the reverse pair, so every
received tensor is tied to the result (:class:`_Tie`) and every passed-on
input to the stage parameters, and each rank runs every hop's backward in
the same order, zero cotangents included.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import axis as ax


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``deps`` joined to its graph: each gets a
    zero cotangent, so the backward of the hop that made it runs on this
    rank when its peers run theirs."""

    @staticmethod
    def forward(ctx, out, *deps):
        ctx.meta = [(d.shape, d.dtype, d.device) for d in deps]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, dout):
        return (dout,) + tuple(torch.zeros(s, dtype=dt, device=dev)
                               for s, dt, dev in ctx.meta)


def _anchor(stage_params, like: torch.Tensor) -> torch.Tensor:
    """A zero of ``like``'s dtype that depends on the stage parameters
    needing a gradient (a plain zero when none does)."""
    from ..tree import tree_leaves
    parts = [p.reshape(-1)[:1].sum() for p in tree_leaves(stage_params)
             if isinstance(p, torch.Tensor) and p.requires_grad]
    if not parts or not torch.is_grad_enabled():
        return like.new_zeros(())
    return (torch.stack(parts).sum() * 0).to(like.dtype)


def pipeline_apply(stage_fn: Callable, stage_params, microbatches,
                   axis_name: str = "pp", with_aux: bool = False):
    """Run ``microbatches`` (``[n_micro, mb, ...]``, the same on every
    stage) through the pipeline of ``axis_name``'s stages.

    ``stage_fn(stage_params, x)`` returns ``y`` of ``x``'s shape, or with
    ``with_aux`` ``(y, aux_scalar)``: the aux is summed over this stage's
    live ticks, over the stages, and averaged over the microbatches (it
    is scale-free, as a load-balance fraction is).  Returns the
    ``[n_micro, mb, ...]`` outputs on every stage (with ``with_aux``,
    ``(outputs, aux)``): the last stage's, broadcast by a masked sum over
    pp.  The caller's loss is the last stage's (the training step's
    masked sum gives the others a zero cotangent): the outputs' backward
    is the identity, so the last stage's cotangent enters its retired
    microbatches, and the aux's sums its cotangent over pp, so every
    stage's aux gets the last stage's, as JAX's transposes give it.
    With one stage every microbatch runs directly.
    """
    n_stages = ax.axis_size(axis_name)
    n_micro = microbatches.shape[0]

    def run(x):
        out = stage_fn(stage_params, x)
        return out if with_aux else (out, None)

    if n_stages == 1:
        outs, auxes = zip(*(run(microbatches[i]) for i in range(n_micro)))
        out = torch.stack(outs)
        if with_aux:
            return out, torch.stack([a.float() for a in auxes]).sum() / n_micro
        return out

    stage = ax.axis_index(axis_name)
    last = n_stages - 1
    ticks = n_micro + n_stages - 1
    perm = [(i, i + 1) for i in range(last)]   # the last stage sends nothing
    anchor = _anchor(stage_params, microbatches)
    incoming = microbatches[0] * 0
    aux_total = (microbatches[0].float() * 0).sum()
    retired = [None] * n_micro
    received = []
    for t in range(ticks):
        x = microbatches[min(t, n_micro - 1)] if stage == 0 else incoming
        if 0 <= t - stage < n_micro:
            y, aux = run(x)
            if with_aux:
                aux_total = aux_total + aux.float()
            if stage == last:
                retired[t - last] = y
        else:
            y = x + anchor       # fill or drain: passed on, not computed
        if t < ticks - 1:
            incoming = ax.ppermute(y, axis_name, perm)
            received.append(incoming)
    outputs = (torch.stack(retired) if stage == last
               else microbatches * 0)
    outputs = _Tie.apply(outputs, *received)
    outputs = ax.reduce_from(outputs, axis_name)
    if with_aux:
        aux = ax.reduce_from(ax.copy_to(aux_total, axis_name), axis_name)
        return outputs, aux / n_micro
    return outputs
