"""Llama-34B — the paper's own 34B experiment model (Table 2 + Table 5).

48L, d_model=8192, 64 heads, head_dim=128, GQA kv=16 (h_kv=2048),
d_ff=22016, vocab=128256.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="llama3-34b",
    family="dense",
    source="paper Table 2/5",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=16,
    head_dim=128,
    d_ff=22016,
    vocab_size=128256,
    layer_pattern=("global",),
    rope_theta=500000.0,
    subquadratic=False,
))
