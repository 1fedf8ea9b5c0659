"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427] Griffin / RecurrentGemma. 38L, d_model=4096, 16 q heads
(MQA kv=1, head_dim=256), d_ff=12288, vocab=256000, local window 2048.

Griffin's pattern is (rglru, rglru, local) repeated; 38 is not a multiple
of 3, matching the real model which ends on two recurrent blocks.  We
encode this as a 19-slot period — 6x(rglru, rglru, local) plus one extra
rglru — repeated twice (2 x 19 = 38 layers, 12 local-attn, 26 recurrent).
"""
from .base import ModelConfig, RGLRUConfig, register

_PERIOD = ("rglru", "rglru", "local") * 6 + ("rglru",)

CONFIG = register(ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=_PERIOD,            # 19-slot period, n_layers = 2*19
    window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, block_width=256),
    activation="gelu",
    scale_embed=True,
    tie_embeddings=True,
    subquadratic=True,
))
