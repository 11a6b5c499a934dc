"""Data-parallel optimizer wrapping and state broadcast.

Counterpart: ``DistributedOptimizer``, ``broadcast_parameters`` and
``broadcast_optimizer_state`` of ``horovod_tpu/torch/__init__.py`` (after
``horovod/torch/optimizer.py`` and ``functions.py``).  Each parameter's
``register_post_accumulate_grad_hook`` submits its gradient's allreduce as
autograd produces it; the engine negotiates and fuses them, and ``step()``
synchronizes.  Adasum and the JAX package's bucketed, sharded and
quantized distributed optimizer are ROADMAP.md A5.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .. import api
from ..compression import Compression
from ..runtime import Average


def broadcast_parameters(params, root_rank: int = 0, process_set=None):
    """Broadcast parameters from ``root_rank`` to every rank, in place.

    ``params`` is a ``state_dict()`` or an iterable of ``(name, tensor)``
    pairs such as ``model.named_parameters()``.
    """
    items = list(params.items()) if hasattr(params, "items") else list(params)
    handles = [api.broadcast_async_(p.data, root_rank, name=f"bp.{name}",
                                    process_set=process_set)
               for name, p in items if torch.is_tensor(p)]
    for h in handles:
        h.synchronize()


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set=None):
    """Install ``root_rank``'s optimizer state on every rank (the other
    ranks may hold none before their first ``step()``)."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("broadcast_optimizer_state does not support LBFGS")
    state = api.broadcast_object(optimizer.state_dict(), root_rank,
                                 name="opt_state", process_set=process_set)
    optimizer.load_state_dict(state)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Methods grafted onto a dynamic subclass of the wrapped optimizer's
    class (the reference's trick, so ``isinstance`` checks keep working)."""

    def _hvd_init(self, named_parameters, compression,
                  backward_passes_per_step, op, gradient_predivide_factor,
                  process_set):
        if gradient_predivide_factor != 1.0 and op != Average:
            raise ValueError(
                "gradient_predivide_factor requires op == Average")
        api._resolve_op(None, op)   # Adasum raises, naming its item
        self._compression = compression
        self._bpps = int(backward_passes_per_step)
        self._op = op
        self._process_set = process_set
        # divide before the cross-rank sum, multiply back after
        self._prescale = 1.0 / gradient_predivide_factor
        self._postscale = gradient_predivide_factor
        self._handles = {}
        self._passes = {}
        self._should_synchronize = True

        named = list(named_parameters) if named_parameters is not None \
            else []
        names_only = [nm for nm, _ in named]
        dup = {n for n in names_only if names_only.count(n) > 1}
        if dup:
            raise ValueError(f"duplicate parameter names: {sorted(dup)}")
        self._param_names = {p: nm for nm, p in named}
        # deterministic group-order names for the rest: identical on every
        # rank running the same model, which negotiation requires
        for gi, group in enumerate(self.param_groups):
            for pi, p in enumerate(group["params"]):
                self._param_names.setdefault(p, f"group{gi}.param{pi}")
        self._hook_refs = [
            p.register_post_accumulate_grad_hook(self._make_hook(p))
            for g in self.param_groups for p in g["params"]
            if p.requires_grad]
        self._passes = {p: 0 for g in self.param_groups
                        for p in g["params"] if p.requires_grad}

    def _make_hook(self, p):
        def hook(param):
            self._passes[p] += 1
            if self._passes[p] % self._bpps:
                return
            wire, ctx = self._compression.compress(param.grad)
            submit = (api.allreduce_async_ if wire is param.grad
                      else api.allreduce_async)
            h = submit(wire, name="ar." + self._param_names[p], op=self._op,
                       prescale_factor=self._prescale,
                       postscale_factor=self._postscale,
                       process_set=self._process_set)
            self._handles[p] = (h, ctx)
        return hook

    def synchronize(self):
        """Wait for every submitted gradient allreduce and write the
        reduced gradients into ``p.grad`` (reference: synchronize)."""
        for p, (h, ctx) in list(self._handles.items()):
            out = h.synchronize()
            if out is not p.grad:
                p.grad.copy_(self._compression.decompress(out, ctx))
        self._handles.clear()

    @contextmanager
    def skip_synchronize(self):
        """Wrap ``step()`` when ``synchronize()`` was called by hand (e.g.
        before gradient clipping)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            self.synchronize()
        # explicit base call: these methods live on a dynamic subclass
        return self._hvd_base.step(self, closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "zero_grad called with allreduces in flight; call "
                "optimizer.step() (or synchronize()) first")
        return self._hvd_base.zero_grad(self, *args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op=Average,
                         gradient_predivide_factor: float = 1.0,
                         process_set=None):
    """Wrap a torch optimizer with cross-rank gradient averaging.

    Hooks submit each gradient's allreduce as autograd accumulates it;
    ``step()`` waits for them.  ``backward_passes_per_step`` accumulates
    that many local backward passes per reduction.
    """
    base = optimizer.__class__
    cls = type(base.__name__, (base,), dict(_DistributedOptimizer.__dict__))
    optimizer.__class__ = cls
    optimizer._hvd_base = base
    optimizer._hvd_init(named_parameters, compression,
                        backward_passes_per_step, op,
                        gradient_predivide_factor, process_set)
    return optimizer
