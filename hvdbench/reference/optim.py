"""Plain references of the two optimizer updates the benchmark's
configurations run, one step over lists of fp32 parameters and gradients.

``adamw_lp``: AdamW whose two moments are *stored* in bf16 (the
algorithm's own definition: ``horovod_tpu/optim/precision.py``'s
``scale_by_adam_lp`` → ``add_decayed_weights`` → ``scale_by_learning_rate``)::

    m = mu·b1 + g·(1 − b1),  v = nu·b2 + g²·(1 − b2)      (fp32 from the stored bf16)
    p ← p − lr·(m/(1 − b1^t) / (sqrt(v/(1 − b2^t)) + eps) + wd·p)
    mu, nu ← bf16(m), bf16(v)

``adamw``: ``torch.optim.AdamW``'s published update (Loshchilov and Hutter,
decoupled weight decay)::

    p ← p·(1 − lr·wd);  m = b1·m + (1 − b1)·g;  v = b2·v + (1 − b2)·g²
    p ← p − lr·(m/(1 − b1^t)) / (sqrt(v)/sqrt(1 − b2^t) + eps)
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


class AdamWLP:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, \
            weight_decay
        self.t = 0
        self.state: Dict[int, tuple] = {}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        self.t += 1
        # optax computes the corrections in fp32
        t = torch.tensor(float(self.t))
        bc1 = float(1.0 - torch.tensor(self.b1) ** t)
        bc2 = float(1.0 - torch.tensor(self.b2) ** t)
        for i, (p, g) in enumerate(zip(params, grads)):
            mu, nu = self.state.get(i, (None, None))
            m = g * (1 - self.b1) if mu is None else \
                mu.float() * self.b1 + g * (1 - self.b1)
            v = g * g * (1 - self.b2) if nu is None else \
                nu.float() * self.b2 + g * g * (1 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))
            self.state[i] = (m.to(torch.bfloat16), v.to(torch.bfloat16))


class AdamW:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, \
            weight_decay
        self.t = 0
        self.state: Dict[int, tuple] = {}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2_sqrt = math.sqrt(1 - self.b2 ** self.t)
        for i, (p, g) in enumerate(zip(params, grads)):
            m, v = self.state.get(i, (torch.zeros_like(p),
                                      torch.zeros_like(p)))
            p.mul_(1 - self.lr * self.wd)
            m = m * self.b1 + g * (1 - self.b1)
            v = v * self.b2 + g * g * (1 - self.b2)
            p.sub_(self.lr * (m / bc1) / (v.sqrt() / bc2_sqrt + self.eps))
            self.state[i] = (m, v)


def make(spec: Dict):
    """The update a configuration's ``optimizer`` entry names:
    ``{"name": "adamw_lp" | "adamw", "lr": ..., "weight_decay": ...}``."""
    kind = {"adamw_lp": AdamWLP, "adamw": AdamW}[spec["name"]]
    return kind(lr=spec["lr"], weight_decay=spec["weight_decay"],
                eps=spec.get("eps", 1e-8))
