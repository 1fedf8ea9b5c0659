"""Architecture config registry.  ``get_config("<arch-id>")`` or
``get_config("<arch-id>-reduced")`` for smoke-test variants."""
from .base import (EncoderConfig, ModelConfig, MoEConfig, RGLRUConfig,
                   SSMConfig, get_config, list_archs, register)

# the architectures the port serves: the dense stacks and the recurrent
# hybrids (mamba2's SSD, recurrentgemma's RG-LRU with local attention)
SERVE_ARCHS = ("llama3-8b", "llama3-34b", "smollm-360m", "gemma2-2b",
               "mistral-large-123b", "nemotron-4-340b", "mamba2-370m",
               "recurrentgemma-9b")
# the paper's own models (Table 2)
PAPER_ARCHS = ("llama3-8b", "llama3-34b")

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "EncoderConfig", "get_config", "list_archs", "register",
           "SERVE_ARCHS", "PAPER_ARCHS"]
