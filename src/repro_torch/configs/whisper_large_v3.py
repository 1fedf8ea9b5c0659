"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed.

[arXiv:2212.04356] Robust speech recognition (Whisper). Backbone: 32
encoder + 32 decoder layers, d_model=1280, 20 heads (MHA, kv=20,
head_dim=64), d_ff=5120 (GELU), vocab=51866, LayerNorm, learned/sinusoidal
positions (no RoPE).  The mel-spectrogram + conv feature extractor is a
stub: ``input_specs()`` supplies precomputed frame embeddings
(B, 1500, 1280) per DESIGN.md §7.  Decoder layers cross-attend encoder
output every layer.
"""
from .base import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=32,                      # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    layer_pattern=("cross",),         # every decoder layer cross-attends
    encoder=EncoderConfig(n_layers=32, n_ctx=1500, causal=False),
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    use_rope=False,
    subquadratic=False,
))
