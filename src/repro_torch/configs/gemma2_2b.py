"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118] Gemma 2 technical report. 26L, d_model=2304, 8 q heads
(GQA kv=4, head_dim=256), d_ff=9216 (GeGLU), vocab=256000, sliding window
4096 on local layers, attn softcap 50, final softcap 30.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    activation="gelu",
    post_norms=True,
    scale_embed=True,
    tie_embeddings=True,
    # half the layers are 4K-window; global layers read the full cache but
    # per-token decode cost is linear -> long_500k runs (DESIGN.md §6).
    subquadratic=True,
))
