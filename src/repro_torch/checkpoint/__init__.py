"""Checkpoints (the port of ``repro.checkpoint``)."""
from repro_torch.checkpoint import ckpt

__all__ = ["ckpt"]
