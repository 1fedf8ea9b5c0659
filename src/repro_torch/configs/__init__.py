"""Architecture config registry.  ``get_config("<arch-id>")`` or
``get_config("<arch-id>-reduced")`` for smoke-test variants."""
from .base import (EncoderConfig, ModelConfig, MoEConfig, RGLRUConfig,
                   SSMConfig, get_config, list_archs, register)

# the architectures the serving slice runs: dense attention-only stacks
SERVE_ARCHS = ("llama3-8b", "smollm-360m", "gemma2-2b")

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "EncoderConfig", "get_config", "list_archs", "register",
           "SERVE_ARCHS"]
