"""The yardstick's arithmetic: the card's peaks, the work a layer needs, and
the model operations a step needs.

Frozen here so that a change to the program cannot move it.  The roofline
counts follow ``chip_smoke.py``'s ``attention_work``/``bound`` and
``xent_bound``, re-based to the *layer's* necessary work rather than each
kernel's: a later change that splits, fuses or renames kernels leaves them
valid.  Every least time is the larger of the operations at the bf16 peak
and the bytes (inputs read once, outputs written once) at the memory rate.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """Least seconds for ``flops`` operations and ``nbytes`` bytes."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attention_pairs(B: int, T: int, H: int, causal: bool) -> int:
    """Score entries the mask keeps, over the batch and the heads."""
    kept = T * (T + 1) // 2 if causal else T * T
    return B * H * kept


def attention_work(B: int, T: int, H: int, Hkv: int, D: int, causal: bool,
                   backward: bool):
    """(operations, bytes) of one attention call, as FlashAttention-2
    counts them: the forward is 2 products over the kept scores, the
    backward 2.5 times the forward's operations.  The forward reads q, k, v
    and writes o and lse; the backward reads q, k, v, o, dO and lse and
    writes dq, dk and dv (bf16 tensors, fp32 lse)."""
    pairs = attention_pairs(B, T, H, causal)
    fwd_flops = 2 * 2 * pairs * D
    q = B * T * H * D
    kv = B * T * Hkv * D
    rows = B * H * T
    if not backward:
        return fwd_flops, 2 * (2 * q + 2 * kv) + 4 * rows
    return 2.5 * fwd_flops, 2 * (3 * q + 2 * kv) + 4 * rows \
        + 2 * (q + 2 * kv)


def xent_work(N: int, V: int, D: int, backward: bool):
    """(operations, bytes) of the vocabulary cross-entropy over ``N``
    tokens: the forward is one product (the logits) and writes the lse;
    the backward recomputes the logits and forms dh and dW (3 products).
    h (bf16), the fp32 table W and the int32 targets are read once; dh
    (bf16), dW (fp32) and the lse are written once."""
    products = 3 if backward else 1
    flops = 2 * products * N * V * D
    nbytes = 2 * N * D + 4 * V * D + 4 * N
    nbytes += (4 * N + 2 * N * D + 4 * V * D) if backward else 4 * N
    return flops, nbytes


def model_flops(matmul_params_per_token: int, attn_layers: int, T: int,
                d_model: int, causal: bool, tokens: int,
                matmul_params_per_seq: int = 0, sequences: int = 0) -> float:
    """Model operations of a training step, recomputation not counted: 6
    operations a token for each parameter that enters a matrix product (a
    tied table once, as the head; lookup tables not at all), 6 a sequence
    for the parameters applied to one token of it (a pooler, a
    classifier), and attention's 6·L·T·d_model a token when causal,
    12·L·T·d_model when not."""
    attn = (6 if causal else 12) * attn_layers * T * d_model
    return (6 * matmul_params_per_token + attn) * tokens \
        + 6 * matmul_params_per_seq * sequences
