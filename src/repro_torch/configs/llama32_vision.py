"""llama-3.2-vision-11b [vlm] — cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision] 40L, d_model=4096, 32 q heads
(GQA kv=8, head_dim=128), d_ff=14336, vocab=128256; every 5th layer adds
cross-attention to projected vision-patch embeddings.  The ViT/projector
frontend is a stub: ``input_specs()`` supplies patch embeddings of shape
(B, n_patches, d_model) per DESIGN.md §7.
"""
from .base import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=("global", "global", "global", "global", "cross"),
    cross_attn_period=5,
    # vision memory: stubbed patch embeddings (e.g. 4 tiles x ~1601 patches)
    encoder=EncoderConfig(n_layers=0, n_ctx=6404, causal=False),
    rope_theta=500000.0,
    subquadratic=False,
))
