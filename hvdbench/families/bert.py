"""BERT with a sequence-classification head, fine-tuned by the port's
``models.bert.make_dp_finetune_step(reduce_grads=True)`` and checked
against ``reference/bert.py``.

The configuration file uses google-research/bert's key names; ``run_as``
says how the port runs it.  Traffic of kind ``classify``: ``batch``
sequences of ``seq`` uniform token ids a rank, each with a uniform label
in ``[0, num_labels)``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from ..cells import seed_for
from ..reference import bert as reference
from ..roofline import model_flops as count_flops


def _dims(cfg: Dict):
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return D, H, D // H, cfg["intermediate_size"], \
        cfg["num_hidden_layers"], cfg["vocab_size"]


def n_layers(cfg: Dict) -> int:
    return cfg["num_hidden_layers"]


def layout(cfg: Dict):
    """The weights' leaves (``weights.py``), in the port's tree."""
    D, H, Dh, F, _, V = _dims(cfg)
    labels = cfg["num_labels"]
    return {
        "root_first": [
            ("word_embed", (V, D), ("normal", D)),
            ("pos_embed", (cfg["max_position_embeddings"], D),
             ("normal", D)),
            ("type_embed", (cfg["type_vocab_size"], D), ("normal", D)),
            ("embed_norm_w", (D,), "ones"), ("embed_norm_b", (D,), "zeros")],
        "layer": [
            ("attn_norm_w", (D,), "ones"), ("attn_norm_b", (D,), "zeros"),
            ("wq", (D, H * Dh), ("normal", D)), ("bq", (H * Dh,), "zeros"),
            ("wk", (D, H * Dh), ("normal", D)), ("bk", (H * Dh,), "zeros"),
            ("wv", (D, H * Dh), ("normal", D)), ("bv", (H * Dh,), "zeros"),
            ("wo", (H * Dh, D), ("normal", H * Dh)), ("bo", (D,), "zeros"),
            ("mlp_norm_w", (D,), "ones"), ("mlp_norm_b", (D,), "zeros"),
            ("w_in", (D, F), ("normal", D)), ("b_in", (F,), "zeros"),
            ("w_out", (F, D), ("normal", F)), ("b_out", (D,), "zeros")],
        "root_last": [
            ("pooler_w", (D, D), ("normal", D)), ("pooler_b", (D,), "zeros"),
            ("cls_w", (D, labels), ("normal", D)),
            ("cls_b", (labels,), "zeros")],
    }


def batches(cfg: Dict, traffic: Dict, seed: int, rank: int,
            device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The rank's pool: ``(tokens [batch, seq], labels [batch])``."""
    out = []
    for i in range(traffic["pool"]):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_for(seed, "batch", rank, i))
        toks = torch.randint(0, cfg["vocab_size"],
                             (traffic["batch"], traffic["seq"]),
                             generator=gen, device=device)
        labels = torch.randint(0, cfg["num_labels"], (traffic["batch"],),
                               generator=gen, device=device)
        out.append((toks, labels))
    return out


def tokens_per_batch(traffic: Dict) -> int:
    return traffic["batch"] * traffic["seq"]


def model_flops(cfg: Dict, traffic: Dict) -> float:
    """Model operations of one rank's step (``roofline.model_flops``): the
    encoder's products a token; the pooler and the classifier a sequence
    (they see its [CLS] token alone); the embedding tables none."""
    D, H, Dh, F, L, _ = _dims(cfg)
    per_layer = 4 * D * H * Dh + 2 * D * F
    return count_flops(L * per_layer, L, traffic["seq"], H * Dh, False,
                       tokens_per_batch(traffic),
                       D * D + D * cfg["num_labels"], traffic["batch"])


def make_step(cfg: Dict, device=None):
    """The port's fine-tune step (under ``hvd.init()``, over its world),
    the gradients averaged through the engine."""
    from horovod_tpu_torch.models import bert
    run = cfg["run_as"]
    D, H, Dh, F, L, V = _dims(cfg)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    bcfg = bert.BertConfig(
        vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=F,
        max_seq_len=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        norm_eps=cfg["layer_norm_eps"], num_labels=cfg["num_labels"],
        dtype=dtypes[run["compute_dtype"]],
        param_dtype=dtypes[run["param_dtype"]], remat=run["remat"])
    opt = run["optimizer"]
    if opt["name"] != "adamw":
        raise ValueError(f"the bert family runs adamw, not {opt['name']}")
    factory = functools.partial(torch.optim.AdamW, lr=opt["lr"],
                                weight_decay=opt["weight_decay"],
                                eps=opt["eps"])
    return bert.make_dp_finetune_step(bcfg, factory, reduce_grads=True,
                                      device=device)


def grad_from_state(opt, p: torch.Tensor) -> torch.Tensor:
    """The gradient AdamW got at its first step: ``exp_avg / (1 − b1)``
    (zero where the optimizer holds no state for ``p``)."""
    st = opt.state.get(p)
    if not st:
        return torch.zeros_like(p)
    return st["exp_avg"].float() / (1.0 - opt.param_groups[0]["betas"][0])


def reference_loss(params: Dict, batch, cfg: Dict, mm):
    tokens, labels = batch
    return reference.loss(params, tokens, labels, cfg, mm)
