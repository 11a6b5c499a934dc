"""Model parameters between the JAX package's layout and the port's.

Counterpart: none.  Arrays cross as numpy, so JAX never runs here.

* Llama and BERT: the JAX trees stack the layers on a leading axis
  (``{"layers": {name: [L, ...]}}``); the port keeps the same leaves as a
  list of per-layer dicts.  Only the stacking differs: every weight keeps
  its ``[in, out]`` layout, and a mixture of experts' leaves (``router
  [L, D, E]``, ``we_* [L, E, D, F]``) cross the same way.
  :func:`llama_shard_params` cuts a rank's slice of the full params by
  ``models.llama.param_specs`` over a model-parallel mesh (over pp, the
  stage's layers), and :func:`llama_gather_params` gathers the slices
  back; :func:`bert_shard_params` and :func:`bert_gather_params` do the
  same by ``models.bert.param_specs``.
* ResNet and MNIST: the trees have the same structure (ResNet's params and
  batch-norm state alike); convolution weights go from JAX's HWIO to
  torch's OIHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .tree import tree_map, tree_paths


def _leaf_fn(device: DeviceLike, dtype: Optional[torch.dtype]):
    device = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    return leaf


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _unstack(tree: Dict, leaf, keys) -> Dict:
    """A JAX tree with stacked ``layers`` → the port's, leaf by leaf, its
    top-level keys in the order of ``keys`` (JAX sorts a dict's keys)."""
    stacked = tree["layers"]
    n_layers = len(next(iter(stacked.values())))
    return {k: ([{name: leaf(w[i]) for name, w in stacked.items()}
                 for i in range(n_layers)] if k == "layers"
                else leaf(tree[k])) for k in keys}


def _restack(params: Dict) -> Dict:
    """The port's tree → the JAX layout: the layer list stacked again."""
    return {k: ({name: np.stack([_to_numpy(lp[name]) for lp in v])
                 for name in v[0]} if k == "layers" else _to_numpy(v))
            for k, v in params.items()}


def llama_params_from_numpy(tree: Dict, device: DeviceLike = None,
                            dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX-layout numpy arrays → the port's parameters on ``device``
    (default: the CUDA device), cast to ``dtype`` when given."""
    return _unstack(tree, _leaf_fn(device, dtype),
                    ("embed", "layers", "final_norm"))


def llama_params_to_numpy(params: Dict) -> Dict:
    """The port's parameters → JAX-layout numpy arrays (bf16 as fp32)."""
    return _restack(params)


def _cut(full: Dict, specs: Dict, leaf_spec, pmesh) -> Dict:
    """Each leaf of ``full`` cut to this rank's chunk along every dim its
    spec names an axis for; new contiguous tensors."""
    def cut(path, t):
        for dim, name in enumerate(leaf_spec(specs, path)):
            if name is not None:
                n = t.shape[dim] // pmesh.axis_size(name)
                t = t.narrow(dim, pmesh.axis_index(name) * n, n)
        return t.detach().clone().contiguous()

    paths = iter(tree_paths(full))
    return tree_map(lambda t: cut(next(paths), t), full)


def _gather(params: Dict, specs: Dict, leaf_spec, pmesh) -> Dict:
    """The inverse of :func:`_cut`: a tiled all-gather over each sharded
    dim's axis (collective)."""
    from .parallel import axis as ax

    def gather(path, t):
        t = t.detach()
        for dim, name in enumerate(leaf_spec(specs, path)):
            g = pmesh.group(name) if name is not None else None
            if g is not None:
                t = ax._gather(t, g, name, dim)
        return t

    paths = iter(tree_paths(params))
    return tree_map(lambda t: gather(next(paths), t), params)


def llama_shard_params(full: Dict, cfg, pmesh, par) -> Dict:
    """This rank's slice of the full Llama params (the port's tree) over
    ``pmesh``: over pp the layer list is cut to this rank's stage, and
    every dim that ``models.llama.param_specs(par, cfg)`` names an axis
    for is cut to this rank's chunk along it (tp columns or rows, ep
    experts, vp vocab rows).  The slices are new contiguous tensors."""
    from .models import llama
    specs = llama.param_specs(par, cfg)
    if par.pp_axis is not None:
        n = len(full["layers"]) // pmesh.axis_size(par.pp_axis)
        s = pmesh.axis_index(par.pp_axis)
        full = dict(full, layers=full["layers"][s * n:(s + 1) * n])
    return _cut(full, specs, llama.leaf_spec, pmesh)


def llama_gather_params(params: Dict, cfg, pmesh, par) -> Dict:
    """The full Llama params from every rank's slice: the inverse of
    :func:`llama_shard_params`, a tiled all-gather over each sharded
    dim's axis, then over pp the stages' layer lists in stage order
    (collective: every rank of the mesh calls it)."""
    from .models import llama
    from .parallel import axis as ax
    specs = llama.param_specs(par, cfg)
    out = _gather(params, specs, llama.leaf_spec, pmesh)
    g = pmesh.group(par.pp_axis) if par.pp_axis is not None else None
    if g is not None:
        # every stage's layers, in stage order
        stages = [{n: ax._gather(w.unsqueeze(0), g, par.pp_axis, 0)
                   for n, w in lp.items()} for lp in out["layers"]]
        out["layers"] = [{n: st[n][s] for n in st}
                         for s in range(g.size()) for st in stages]
    return out


# the order of the port's init_params
_BERT_KEYS = ("word_embed", "pos_embed", "type_embed", "embed_norm_w",
              "embed_norm_b", "layers", "pooler_w", "pooler_b", "cls_w",
              "cls_b")


def bert_params_from_numpy(tree: Dict, device: DeviceLike = None,
                           dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX-layout BERT arrays (``layers`` stacked ``[L, ...]``) → the
    port's parameters on ``device`` (default: the CUDA device)."""
    return _unstack(tree, _leaf_fn(device, dtype), _BERT_KEYS)


def bert_params_to_numpy(params: Dict) -> Dict:
    """The port's BERT parameters → JAX-layout numpy arrays."""
    return _restack(params)


def bert_shard_params(full: Dict, cfg, pmesh, par) -> Dict:
    """This rank's tp slice of the full BERT params over ``pmesh``, by
    ``models.bert.param_specs(par, cfg)`` (q/k/v and ``w_in`` columns with
    their biases, ``wo``/``w_out`` rows); new contiguous tensors."""
    from .models import bert, llama
    return _cut(full, bert.param_specs(par, cfg), llama.leaf_spec, pmesh)


def bert_gather_params(params: Dict, cfg, pmesh, par) -> Dict:
    """The full BERT params from every rank's slice (collective): the
    inverse of :func:`bert_shard_params`."""
    from .models import bert, llama
    return _gather(params, bert.param_specs(par, cfg), llama.leaf_spec,
                   pmesh)


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _conv_tree_from_numpy(tree, device, dtype):
    leaf = _leaf_fn(device, dtype)
    return tree_map(lambda a: leaf(_hwio_to_oihw(np.asarray(a))), tree)


def _conv_tree_to_numpy(tree):
    return tree_map(lambda t: np.ascontiguousarray(
        _oihw_to_hwio(_to_numpy(t))), tree)


def resnet_params_from_numpy(params: Dict, state: Dict,
                             device: DeviceLike = None,
                             dtype: Optional[torch.dtype] = None
                             ) -> Tuple[Dict, Dict]:
    """The JAX package's ResNet ``(params, state)`` as numpy → the port's
    on ``device`` (default: the CUDA device): HWIO convolutions as OIHW."""
    return (_conv_tree_from_numpy(params, device, dtype),
            _conv_tree_from_numpy(state, device, dtype))


def resnet_params_to_numpy(params: Dict, state: Dict) -> Tuple[Dict, Dict]:
    """The port's ResNet ``(params, state)`` → the JAX layout as numpy."""
    return _conv_tree_to_numpy(params), _conv_tree_to_numpy(state)


def mnist_params_from_numpy(params: Dict, device: DeviceLike = None,
                            dtype: Optional[torch.dtype] = None) -> Dict:
    """The JAX package's MNIST params as numpy → the port's on ``device``
    (default: the CUDA device): HWIO convolutions as OIHW."""
    return _conv_tree_from_numpy(params, device, dtype)


def mnist_params_to_numpy(params: Dict) -> Dict:
    """The port's MNIST params → the JAX layout as numpy."""
    return _conv_tree_to_numpy(params)
