"""mamba2-370m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060] Transformers are SSMs. 48L, d_model=1024, d_state=128,
expand=2 (d_inner=2048), head_dim=64, vocab=50280.

CAD applicability: NONE — there is no core attention to disaggregate; the
context-dependent op is the SSD chunked scan whose compute is O(l·d_state),
linear in tokens, so packing-induced quadratic imbalance does not arise
(DESIGN.md §5).
"""
from .base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    arch_id="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  chunk_size=256, conv_width=4),
    use_rope=False,
    tie_embeddings=True,
    subquadratic=True,
))
