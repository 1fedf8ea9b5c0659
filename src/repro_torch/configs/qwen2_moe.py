"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L, d_model=2048, 16 q heads (GQA kv=16 ==
MHA), per-expert d_ff=1408, vocab=151936, 60 routed experts top-4 plus 4
always-on shared experts.

60 experts do NOT divide the 16-way "data" axis -> experts stay replicated
on "data" with d_model FSDP-sharded; exercises the dense-dispatch MoE path
(DESIGN.md §4).
"""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    layer_pattern=("global",),
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4,
                  d_ff_expert=1408, expert_parallel=False),
    subquadratic=False,
))
