"""Parallelism context for the port's training step.

The port of ``repro.parallel.ParallelContext``, cut to one card: the
attention implementation, the CAD context, rematerialization and the
ping-pong flag.  The reference's mesh and sharding rules (``ctx.cons``)
have nothing to shard on one card and come with the multi-card slice
(ROADMAP queue 1 items 4 and 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """What the model's forward reads besides weights and batch.

    attn_impl: "ref" | "cad" (``xla`` and ``pallas`` raise, see
               ``core.attention``)
    cad:       the :class:`~repro_torch.core.dispatch.CADContext` (pool
               geometry + this step's plan) when attn_impl == "cad"
    remat:     re-run each layer's forward in the backward
               (``torch.utils.checkpoint``) instead of keeping its
               activations
    pingpong:  split each rank's rows into two nano-batches (paper §4.1)
    """
    attn_impl: str = "ref"
    cad: Any = None
    pingpong: bool = False
    remat: bool = True
