"""A Llama-architecture decoder with a tied head, trained by the port's
``training.make_llama_train_step`` and checked against
``reference/decoder.py``.

The configuration file uses Hugging Face ``LlamaConfig`` key names;
``run_as`` says how the port runs it.  Traffic of kind ``causal_lm``:
``batch`` sequences of ``seq`` uniform token ids a rank, each with its
next-token targets.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..cells import seed_for
from ..reference import decoder
from ..roofline import model_flops as count_flops


def _dims(cfg: Dict):
    D = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return D, H, Hkv, D // H, cfg["intermediate_size"], \
        cfg["num_hidden_layers"], cfg["vocab_size"]


def n_layers(cfg: Dict) -> int:
    return cfg["num_hidden_layers"]


def layout(cfg: Dict):
    """The weights' leaves (``weights.py``), in the port's tree."""
    D, H, Hkv, Dh, F, _, V = _dims(cfg)
    return {
        "root_first": [("embed", (V, D), ("normal", D))],
        "layer": [("attn_norm", (D,), "ones"),
                  ("wq", (D, H * Dh), ("normal", D)),
                  ("wk", (D, Hkv * Dh), ("normal", D)),
                  ("wv", (D, Hkv * Dh), ("normal", D)),
                  ("wo", (H * Dh, D), ("normal", H * Dh)),
                  ("mlp_norm", (D,), "ones"),
                  ("w_gate", (D, F), ("normal", D)),
                  ("w_up", (D, F), ("normal", D)),
                  ("w_down", (F, D), ("normal", F))],
        "root_last": [("final_norm", (D,), "ones")],
    }


def batches(cfg: Dict, traffic: Dict, seed: int, rank: int,
            device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The rank's pool: ``(tokens, targets)`` ``[batch, seq]`` pairs, the
    targets the next token of each position."""
    out = []
    for i in range(traffic["pool"]):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_for(seed, "batch", rank, i))
        s = torch.randint(0, cfg["vocab_size"],
                          (traffic["batch"], traffic["seq"] + 1),
                          generator=gen, device=device)
        out.append((s[:, :-1].contiguous(), s[:, 1:].contiguous()))
    return out


def tokens_per_batch(traffic: Dict) -> int:
    return traffic["batch"] * traffic["seq"]


def model_flops(cfg: Dict, traffic: Dict) -> float:
    """Model operations of one rank's step (``roofline.model_flops``)."""
    D, H, Hkv, Dh, F, L, V = _dims(cfg)
    per_layer = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D + 3 * D * F
    return count_flops(L * per_layer + V * D, L, traffic["seq"], H * Dh,
                       True, tokens_per_batch(traffic))


def make_step(cfg: Dict, device=None):
    """The port's train step (under ``hvd.init()``, over its world)."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.optim import precision
    run = cfg["run_as"]
    D, H, Hkv, Dh, F, L, V = _dims(cfg)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    lcfg = llama.LlamaConfig(
        vocab_size=V, d_model=D, n_layers=L, n_heads=H, n_kv_heads=Hkv,
        d_ff=F, rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        max_seq_len=cfg["max_position_embeddings"],
        dtype=dtypes[run["compute_dtype"]],
        param_dtype=dtypes[run["param_dtype"]], remat=run["remat"],
        remat_policy=run["remat_policy"], fused_xent=run["fused_xent"])
    opt = run["optimizer"]
    if opt["name"] != "adamw_lp":
        raise ValueError(f"the llama family runs adamw_lp, not {opt['name']}")
    factory = precision.adamw_lp(opt["lr"], eps=opt["eps"],
                                 weight_decay=opt["weight_decay"])
    return training.make_llama_train_step(lcfg, optimizer=factory,
                                          device=device)


def grad_from_state(opt, p: torch.Tensor) -> torch.Tensor:
    """The gradient AdamW-LP got at its first step: ``mu / (1 − b1)``
    (zero where the optimizer holds no state for ``p``)."""
    st = opt.state.get(p)
    if not st:
        return torch.zeros_like(p)
    return st["mu"].float() / (1.0 - opt.param_groups[0]["b1"])


def reference_loss(params: Dict, batch, cfg: Dict, mm):
    tokens, targets = batch
    return decoder.loss(params, tokens, targets, cfg, mm)

