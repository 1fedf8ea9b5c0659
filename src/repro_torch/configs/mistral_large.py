"""mistral-large-123b [dense].

[hf:mistralai/Mistral-Large-Instruct-2407] 88L, d_model=12288, 96 q heads
(GQA kv=8, head_dim=128), d_ff=28672, vocab=32768.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    layer_pattern=("global",),
    rope_theta=1000000.0,
    subquadratic=False,
))
