"""llama4-maverick-400b-a17b [moe] — 128 routed experts, top-1 routing.

[hf:meta-llama/Llama-4-Scout-17B-16E family card] 48L, d_model=5120,
40 q heads (GQA kv=8, head_dim=128), per-expert d_ff=8192, vocab=202048,
MoE 128e top-1, early-fusion multimodal (text backbone here).

Expert parallelism: 128 experts divide the 16-way "data" axis, so this
config exercises the EP all-to-all path (DESIGN.md §4).
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=("global",),
    moe=MoEConfig(n_experts=128, top_k=1, n_shared_experts=1,
                  d_ff_expert=8192, expert_parallel=True),
    rope_theta=500000.0,
    subquadratic=False,
))
