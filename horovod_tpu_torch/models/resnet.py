"""ResNet v1.5 family in PyTorch: BASELINE.md config 2, and the elastic
config 5's model.

Counterpart: ``horovod_tpu/models/resnet.py``.  bf16 activations over fp32
parameters and batch-norm statistics, synchronized batch norm over the
data-parallel process set (``ops/sync_batch_norm.py``, the JAX package's
conventions), and the last batch-norm scale of each residual block
initialized to zero.  The convolutions are ``F.conv2d`` (cuDNN on the
card), as the JAX package's are ``lax.conv`` outside any Pallas kernel.

PyTorch idiom where JAX has its own: images are NCHW tensors held in
``torch.channels_last`` memory (NHWC in memory, what cuDNN's tensor-core
convolutions read) and convolution weights are OIHW (``convert.py`` takes
the JAX package's HWIO across).  XLA's ``"SAME"`` padding puts the odd
pixel of a strided window at the end (a 7×7/2 stem at 224 pads 2 before
and 3 after, a 3×3/2 convolution or max-pool 0 and 1), which no symmetric
``padding=`` gives: :func:`same_pads` computes the pads as
``lax.padtype_to_pads`` does and :func:`conv_same` pads explicitly where
they differ, with ``-inf`` for the pool.

Parameters and running statistics are separate trees of the same shape
(``init() -> (params, state)``); ``forward`` returns the updated state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from ..ops.sync_batch_norm import sync_batch_norm
from ..tree import tree_leaves

# variant -> (blocks per stage, bottleneck?)
VARIANTS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    variant: int = 50
    num_classes: int = 1000
    width: int = 64              # stem channels; stage i has width * 2^i
    bn_momentum: float = 0.9     # decay of the old running value (JAX's)
    bn_eps: float = 1e-5
    dtype: Any = torch.bfloat16  # activation / compute dtype

    @property
    def stage_blocks(self):
        return VARIANTS[self.variant][0]

    @property
    def bottleneck(self) -> bool:
        return VARIANTS[self.variant][1]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of XLA's ``"SAME"`` for a window of
    ``k`` at ``stride`` over ``size`` pixels: ``ceil(size / stride)``
    outputs, the odd pixel after."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return pad // 2, pad - pad // 2


def _pads(x, k: int, stride: int):
    (t, b), (l, r) = (same_pads(x.shape[2], k, stride),
                      same_pads(x.shape[3], k, stride))
    return t, b, l, r


def conv_same(x, w, stride: int = 1):
    """``lax.conv_general_dilated(x, w, stride, "SAME")`` in NCHW/OIHW:
    ``w`` cast to x's dtype, padded explicitly where the pads differ."""
    t, b, l, r = _pads(x, w.shape[2], stride)
    w = w.to(x.dtype)
    if t == b and l == r:
        return F.conv2d(x, w, stride=stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def max_pool_same(x, k: int = 3, stride: int = 2):
    """``lax.reduce_window(x, -inf, max, k×k, stride, "SAME")``."""
    t, b, l, r = _pads(x, k, stride)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), k,
                        stride)


def init(cfg: ResNetConfig, seed: int = 0,
         device: DeviceLike = None) -> Tuple[Dict, Dict]:
    """The ``(params, state)`` pair from a ``torch.Generator`` seeded with
    ``seed``, on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def conv(k, cin, cout):
        # He-normal over fan-out, as the reference examples initialize
        return randn(cout, cin, k, k).mul_((2.0 / (k * k * cout)) ** 0.5)

    def bn(c, zero_scale=False):
        scale = torch.zeros(c, device=device) if zero_scale \
            else torch.ones(c, device=device)
        return ({"scale": scale, "bias": torch.zeros(c, device=device)},
                {"mean": torch.zeros(c, device=device),
                 "var": torch.ones(c, device=device)})

    params: Dict = {"stem": conv(7, 3, cfg.width)}
    state: Dict = {}
    params["stem_bn"], state["stem_bn"] = bn(cfg.width)
    cin = cfg.width
    expand = 4 if cfg.bottleneck else 1
    for i, n_blocks in enumerate(cfg.stage_blocks):
        cmid = cfg.width * 2 ** i
        cout = cmid * expand
        blocks_p, blocks_s = [], []
        for b in range(n_blocks):
            convs = ([(1, cin, cmid), (3, cmid, cmid), (1, cmid, cout)]
                     if cfg.bottleneck else [(3, cin, cmid), (3, cmid, cout)])
            p, s = {}, {}
            for j, (k, ci, co) in enumerate(convs):
                p[f"conv{j}"] = conv(k, ci, co)
                p[f"bn{j}"], s[f"bn{j}"] = bn(co, j == len(convs) - 1)
            if b == 0 and (cin != cout or i > 0):
                p["proj"] = conv(1, cin, cout)
                p["proj_bn"], s["proj_bn"] = bn(cout)
            blocks_p.append(p)
            blocks_s.append(s)
            cin = cout
        params[f"stage{i}"] = blocks_p
        state[f"stage{i}"] = blocks_s
    params["fc"] = {"w": randn(cin, cfg.num_classes).mul_(cin ** -0.5),
                    "b": torch.zeros(cfg.num_classes, device=device)}
    return params, state


def _bn(x, p, s, cfg: ResNetConfig, train: bool, process_set):
    y, mean, var = sync_batch_norm(
        x, p["scale"], p["bias"], s["mean"], s["var"],
        process_set=process_set, train=train, momentum=cfg.bn_momentum,
        eps=cfg.bn_eps)
    return y, {"mean": mean, "var": var}


def _block(x, p, s, cfg: ResNetConfig, stride: int, train: bool,
           process_set):
    ns = {}
    shortcut = x
    if "proj" in p:
        shortcut = conv_same(x, p["proj"], stride)
        shortcut, ns["proj_bn"] = _bn(shortcut, p["proj_bn"], s["proj_bn"],
                                      cfg, train, process_set)
    y = x
    n_convs = 3 if cfg.bottleneck else 2
    for i in range(n_convs):
        # v1.5: the stride sits on the 3x3 conv (index 1 of a bottleneck,
        # 0 of a basic block)
        st = stride if i == (1 if cfg.bottleneck else 0) else 1
        y = conv_same(y, p[f"conv{i}"], st)
        y, ns[f"bn{i}"] = _bn(y, p[f"bn{i}"], s[f"bn{i}"], cfg, train,
                              process_set)
        if i < n_convs - 1:
            y = F.relu(y)
    return F.relu(y + shortcut), ns


def forward(params, state, images, cfg: ResNetConfig, train: bool = True,
            process_set=None):
    """images ``[B, 3, H, W]`` (any float dtype) -> (fp32 logits ``[B,
    classes]``, new state).  ``process_set``: the data-parallel ranks whose
    batch the batch norm synchronizes over (None: this rank's)."""
    x = images.to(dtype=cfg.dtype, memory_format=torch.channels_last)
    x = conv_same(x, params["stem"], 2)
    new_state: Dict = {}
    x, new_state["stem_bn"] = _bn(x, params["stem_bn"], state["stem_bn"],
                                  cfg, train, process_set)
    x = max_pool_same(F.relu(x))
    for i in range(len(cfg.stage_blocks)):
        blocks_ns = []
        for b, (bp, bs) in enumerate(zip(params[f"stage{i}"],
                                         state[f"stage{i}"])):
            stride = 2 if (b == 0 and i > 0) else 1
            x, bns = _block(x, bp, bs, cfg, stride, train, process_set)
            blocks_ns.append(bns)
        new_state[f"stage{i}"] = blocks_ns
    x = x.float().mean((2, 3))
    logits = x @ params["fc"]["w"] + params["fc"]["b"]
    return logits, new_state


def num_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))
