"""Seeded weights, made on the device in one call a kind of leaf.

A family names its leaves as ``(name, shape, init)`` for the tree's root
before the layers, for each layer, and for the root after the layers.
``init`` is ``("normal", fan_in)`` (standard normal times
``fan_in ** -0.5``), ``"ones"`` or ``"zeros"``.  Each kind is drawn for all
layers at once, ``[n_layers, *shape]``, from one ``torch.Generator`` on the
device seeded from ``--seed``, then split into one tensor a layer; the same
seed gives the same weights, so a reference and a check can make them
again instead of keeping a copy.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from .cells import seed_for

Leaf = Tuple[str, Tuple[int, ...], object]


def _draw(gen, n: int, shape, init, device) -> torch.Tensor:
    full = (n,) + tuple(shape)
    if init == "ones":
        return torch.ones(full, device=device)
    if init == "zeros":
        return torch.zeros(full, device=device)
    kind, fan_in = init
    if kind != "normal":
        raise ValueError(f"unknown init {init!r}")
    return torch.randn(full, generator=gen, device=device).mul_(fan_in ** -0.5)


def kinds(layout: Dict[str, Sequence[Leaf]], n_layers: int, seed: int,
          device) -> Iterator[Tuple[List[str], torch.Tensor]]:
    """``(paths, stacked values)`` kind by kind, in the order the leaves
    are drawn: the root's leaves (before and after the layers), then each
    layer kind.  ``stacked[i]`` is the leaf at ``paths[i]``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "weights"))
    for name, shape, init in (list(layout["root_first"])
                              + list(layout["root_last"])):
        yield [name], _draw(gen, 1, shape, init, device)
    for name, shape, init in layout["layer"]:
        yield ([f"layers.{i}.{name}" for i in range(n_layers)],
               _draw(gen, n_layers, shape, init, device))


def tree(layout: Dict[str, Sequence[Leaf]], n_layers: int, seed: int,
         device) -> Dict:
    """The weights as a tree: the root's leaves, ``"layers"`` (a list of
    dicts, one a layer) where the layout puts it, each leaf its own
    tensor."""
    flat = {}
    for paths, stacked in kinds(layout, n_layers, seed, device):
        for path, value in zip(paths, stacked):
            flat[path] = value.clone()
        del stacked
    out = {name: flat[name] for name, _, _ in layout["root_first"]}
    out["layers"] = [{name: flat[f"layers.{i}.{name}"]
                      for name, _, _ in layout["layer"]}
                     for i in range(n_layers)]
    out.update({name: flat[name] for name, _, _ in layout["root_last"]})
    return out


def items(tree_: Dict) -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` of a weights tree, in its order."""
    out = []
    for key, value in tree_.items():
        if key == "layers":
            out += [(f"layers.{i}.{n}", w) for i, lp in enumerate(value)
                    for n, w in lp.items()]
        else:
            out.append((key, value))
    return out


@torch.no_grad()
def change_norms(tree_: Dict, layout, n_layers: int, seed: int,
                 device) -> Dict[str, float]:
    """``|leaf − its seeded start|`` of every leaf, the start made again
    kind by kind."""
    now = dict(items(tree_))
    out = {}
    for paths, start in kinds(layout, n_layers, seed, device):
        for path, s in zip(paths, start):
            out[path] = float((now[path].detach().float() - s).norm())
        del start
    return out
