"""Adasum: scale-invariant gradient combining.

Counterpart: ``horovod_tpu/ops/adasum.py``, after the reference's
``horovod/common/ops/adasum/adasum.h``: instead of a plain sum, two
gradient vectors merge by subtracting out the projection of each onto the
other,

    adasum(a, b) = (1 - a·b / (2|a|²)) a  +  (1 - a·b / (2|b|²)) b,

applied in a binary tree over the ranks (the reference's power-of-two
recursion).  As in the JAX package, the contributions are all-gathered
once over the set's group and every rank runs the same tree locally, so
the result is the same on every rank; a bucket's tensors are flattened
and concatenated first (Adasum is defined over the fused vector, not per
tensor).  The dot products and norms are taken in the tensor's dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def _adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dot = torch.dot(a, b)
    na = torch.dot(a, a)
    nb = torch.dot(b, b)
    one = torch.ones((), dtype=dot.dtype, device=dot.device)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * na), one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * nb), one)
    return ca.to(a.dtype) * a + cb.to(b.dtype) * b


def adasum_tree(contribs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Binary combining tree over 1-D contributions, in order: pairs
    (0, 1), (2, 3), ... at each level, an odd last one carried up."""
    level = list(contribs)
    while len(level) > 1:
        nxt = [_adasum_pair(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def adasum_flat(flat: torch.Tensor, ps) -> torch.Tensor:
    """Adasum of every rank's 1-D ``flat`` over ``ps``: one all-gather,
    then :func:`adasum_tree` in rank order, the same on every rank."""
    from .collectives import all_gather_flat
    n = ps.size()
    rows = all_gather_flat(flat.contiguous(), ps).view(n, -1)
    return adasum_tree([rows[i] for i in range(n)])


def adasum_arrays(tensors: Sequence[torch.Tensor], ps,
                  prescale_factor: Optional[float] = None,
                  postscale_factor: Optional[float] = None
                  ) -> List[torch.Tensor]:
    """Adasum of one fused bucket (tensors of one dtype): flattened and
    concatenated, prescaled, combined over the set, postscaled and split
    back; new tensors.  At world 1 it is the identity times the scales."""
    from .collectives import _scale_
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("a fused Adasum takes tensors of one dtype")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if prescale_factor is not None:
        _scale_(flat, prescale_factor)
    red = adasum_flat(flat, ps)
    if postscale_factor is not None:
        _scale_(red, postscale_factor)
    return [v.view(t.shape) for v, t in
            zip(red.split([t.numel() for t in tensors]), tensors)]
