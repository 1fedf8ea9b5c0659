"""smollm-360m [dense] — llama-architecture small model.

[hf:HuggingFaceTB/SmolLM-135M family card] 32L, d_model=960, 15 q heads
(GQA kv=5, head_dim=64), d_ff=2560, vocab=49152.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    layer_pattern=("global",),
    tie_embeddings=True,
    subquadratic=False,
))
