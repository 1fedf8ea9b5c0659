"""Architecture config registry.  ``get_config("<arch-id>")`` or
``get_config("<arch-id>-reduced")`` for smoke-test variants."""
from .base import (EncoderConfig, ModelConfig, MoEConfig, RGLRUConfig,
                   SSMConfig, get_config, list_archs, register)

# the architectures of the assignment (the reference's tuple, in its
# order): the dry run's default
ASSIGNED_ARCHS = (
    "gemma2-2b",
    "mamba2-370m",
    "llama4-maverick-400b-a17b",
    "qwen2-moe-a2.7b",
    "smollm-360m",
    "llama-3.2-vision-11b",
    "mistral-large-123b",
    "nemotron-4-340b",
    "whisper-large-v3",
    "recurrentgemma-9b",
)
# the architectures the port serves: the dense stacks, the recurrent
# hybrids (mamba2's SSD, recurrentgemma's RG-LRU with local attention) and
# the MoE stacks (routed experts with shared ones); not the cross-attention
# archs, which serve only with a memory the HTTP launcher cannot give them
SERVE_ARCHS = ("llama3-8b", "llama3-34b", "smollm-360m", "gemma2-2b",
               "mistral-large-123b", "nemotron-4-340b", "mamba2-370m",
               "recurrentgemma-9b", "qwen2-moe-a2.7b",
               "llama4-maverick-400b-a17b")
# the paper's own models (Table 2)
PAPER_ARCHS = ("llama3-8b", "llama3-34b")

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "EncoderConfig", "get_config", "list_archs", "register",
           "ASSIGNED_ARCHS", "SERVE_ARCHS", "PAPER_ARCHS"]
