"""MNIST convnet in PyTorch: BASELINE.md config 1 (``pytorch_mnist.py``'s
capacity).

Counterpart: ``horovod_tpu/models/mnist.py``.  Two 3×3 stride-2 ``"SAME"``
convolutions (28 -> 14 -> 7, each padding 0 before and 1 after, as XLA
does), then fc1 and fc2; bf16 compute over fp32 parameters, the last
product in fp32.  Stateless: ``forward(params, images) -> logits``.
Images are NCHW, convolution weights OIHW (``convert.py`` takes the JAX
package's HWIO across), and the feature map is flattened in NHWC order so
that fc1's rows are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from .resnet import conv_same


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    num_classes: int = 10
    c1: int = 32
    c2: int = 64
    hidden: int = 128
    dtype: Any = torch.bfloat16


def init(cfg: MnistConfig = MnistConfig(), seed: int = 0,
         device: DeviceLike = None) -> Dict:
    """He-normal parameters from a ``torch.Generator`` seeded with
    ``seed``, on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def he(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device)
        return w.mul_((2.0 / fan_in) ** 0.5)

    flat = 7 * 7 * cfg.c2
    return {
        "conv1": he((cfg.c1, 1, 3, 3), 9),
        "conv2": he((cfg.c2, cfg.c1, 3, 3), 9 * cfg.c1),
        "fc1": {"w": he((flat, cfg.hidden), flat),
                "b": torch.zeros(cfg.hidden, device=device)},
        "fc2": {"w": he((cfg.hidden, cfg.num_classes), cfg.hidden),
                "b": torch.zeros(cfg.num_classes, device=device)},
    }


def forward(params, images, cfg: MnistConfig = MnistConfig()):
    """images ``[B, 1, 28, 28]`` -> fp32 logits ``[B, classes]``."""
    x = images.to(dtype=cfg.dtype, memory_format=torch.channels_last)
    for name in ("conv1", "conv2"):
        x = F.relu(conv_same(x, params[name], 2))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"]["w"].to(x.dtype)
               + params["fc1"]["b"].to(x.dtype))
    return x.float() @ params["fc2"]["w"] + params["fc2"]["b"]
