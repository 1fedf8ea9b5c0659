"""Llama-3-8B — the paper's own 8B experiment model (Table 2).

32L, d_model=4096, 32 heads, head_dim=128, GQA kv=8, d_ff=14336,
vocab=128256.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="llama3-8b",
    family="dense",
    source="paper Table 2 / arXiv:2407.21783",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=("global",),
    rope_theta=500000.0,
    subquadratic=False,
))
