"""The work a training step needs, reckoned from the batch and the model's
shapes alone (never from the program's buffers), and the data-sheet peaks
it is held against.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense bf16 989 TFLOP/s,
HBM3 3.35 TB/s (at the 700 W power limit).

``shape`` is a configuration's ``shape`` dict (``configs/<name>.json``):
n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab_size,
tie_embeddings, gated_mlp.  A batch is described by ``tokens`` (its
non-padding tokens) and ``segments`` (every packed segment's length).
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2
F32_BYTES = 4


def matmul_params(shape: Dict) -> int:
    """N: the parameters of every matrix a step multiplies: each layer's
    q, k, v and output projections and its MLP, and the output head once
    (tied or not); the embedding lookup is no product and is not counted."""
    d, dh = shape["d_model"], shape["head_dim"]
    hq, hkv = shape["n_heads"], shape["n_kv_heads"]
    attn = d * hq * dh * 2 + d * hkv * dh * 2
    mlp = (3 if shape.get("gated_mlp", True) else 2) * d * shape["d_ff"]
    return shape["n_layers"] * (attn + mlp) + shape["vocab_size"] * d


def causal_pairs(segments: Sequence[int]) -> int:
    """Sum over segments of L(L+1)/2: the (query, key) pairs causal
    attention within each segment computes."""
    return sum(L * (L + 1) // 2 for L in segments)


def model_flops(shape: Dict, tokens: int, segments: Sequence[int]) -> float:
    """A training step's model FLOPs: 6·N·tokens for the products plus
    12·layers·heads·head_dim·pairs for attention (forward 4·dh per pair
    and head, backward twice that); remat recompute is not counted."""
    return 6.0 * matmul_params(shape) * tokens + 12.0 * shape["n_layers"] \
        * shape["n_heads"] * shape["head_dim"] * causal_pairs(segments)


def ca_fwd_work(shape: Dict, tokens: int, segments: Sequence[int]):
    """(FLOPs, bytes) one layer's attention forward needs: QK^T and PV over
    the causal pairs; q, k, v and out read or written once at the batch's
    token count in bf16, and the f32 lse written once."""
    hq, hkv, dh = shape["n_heads"], shape["n_kv_heads"], shape["head_dim"]
    flops = 4.0 * dh * hq * causal_pairs(segments)
    nbytes = tokens * (2 * hq * dh + 2 * hkv * dh) * BF16_BYTES \
        + tokens * hq * F32_BYTES
    return flops, nbytes


def ca_bwd_work(shape: Dict, tokens: int, segments: Sequence[int]):
    """(FLOPs, bytes) one layer's attention backward needs: 2.5 times the
    forward's FLOPs (dS from dO·V^T, dQ, dK, dV and the recomputed
    Q·K^T); q, k, v, out, dout and lse read once, dq, dk and dv written
    once."""
    hq, hkv, dh = shape["n_heads"], shape["n_kv_heads"], shape["head_dim"]
    flops = 2.5 * 4.0 * dh * hq * causal_pairs(segments)
    reads = tokens * (3 * hq * dh + 2 * hkv * dh) * BF16_BYTES \
        + tokens * hq * F32_BYTES
    writes = tokens * (hq * dh + 2 * hkv * dh) * BF16_BYTES
    return flops, reads + writes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FLOPs at the
    bf16 peak and the bytes at the HBM rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
