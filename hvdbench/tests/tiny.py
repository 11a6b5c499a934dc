"""A copy of the harness with tiny cells beside the real ones, for the CPU
tests: the same families, metrics and checks at toy widths."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from hvdbench import cells

TINY_LLAMA = {
    "family": "llama", "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 2, "num_key_value_heads": 1,
    "intermediate_size": 256, "vocab_size": 256,
    "max_position_embeddings": 64, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "tie_word_embeddings": True,
    "run_as": {"compute_dtype": "bfloat16", "param_dtype": "float32",
               "fused_xent": True, "remat": True, "remat_policy": "dots",
               "optimizer": {"name": "adamw_lp", "lr": 3e-4,
                             "weight_decay": 1e-4, "eps": 1e-8}}}
TINY_BERT = {
    "family": "bert", "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 2, "intermediate_size": 256, "vocab_size": 256,
    "max_position_embeddings": 64, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "num_labels": 4,
    "run_as": {"compute_dtype": "bfloat16", "param_dtype": "float32",
               "remat": True,
               "optimizer": {"name": "adamw", "lr": 5e-5,
                             "weight_decay": 1e-4, "eps": 1e-8}}}
TRAFFIC = {
    "tiny-lm": {"kind": "causal_lm", "batch": 2, "seq": 64,
                "pool": 4, "check_steps": 3},
    "tiny-lm-dp2": {"kind": "causal_lm", "batch": 2, "seq": 64,
                    "pool": 4, "check_steps": 3},
    "tiny-cls": {"kind": "classify", "batch": 4, "seq": 64,
                 "pool": 4, "check_steps": 3},
}
#: the tiny cells' limits: the bf16 program against the fp32 reference
#: on the CPU reads well under these, every fault far over one
LIMITS = {"loss_gap": 0.02, "grad_gap": 0.2, "change_gap": 0.2}
CELLS = {"tiny-llama.tiny-lm": ("tiny-llama", "tiny-lm", 1),
         "tiny-llama.tiny-lm-dp2": ("tiny-llama", "tiny-lm-dp2", 2),
         "tiny-bert.tiny-cls": ("tiny-bert", "tiny-cls", 1)}


def make_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``hvdbench/`` with the tiny
    cells added as new files and entries."""
    shutil.copytree(cells.HERE, tmp / "hvdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = cells.benchmark()
    here = tmp / "hvdbench"
    for name, body in (("tiny-llama", TINY_LLAMA), ("tiny-bert", TINY_BERT)):
        (here / "configs" / f"{name}.json").write_text(json.dumps(body))
    for name, body in TRAFFIC.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(body))
    for cell, (config, traffic, chips) in CELLS.items():
        (here / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": chips,
                                   "why": "CPU test"})
        for m in bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
