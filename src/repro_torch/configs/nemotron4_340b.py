"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP.

[arXiv:2402.16819] Nemotron-4. 96L, d_model=18432, 96 q heads (GQA kv=8,
head_dim=192), d_ff=73728 (squared-ReLU, 2-matrix MLP), vocab=256000.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    layer_pattern=("global",),
    activation="relu2",
    gated_mlp=False,
    subquadratic=False,
))
