"""Parallelism context for the port's training step.

The port of ``repro.parallel.ParallelContext``: the attention
implementation, the CAD context, rematerialization and the CAD group.
The reference names its ranks by a device mesh and the sharding rules'
``cad_axis``; here the ranks of the dispatch are a ``torch.distributed``
process group (``group``), one rank per attention server, joined by
:func:`repro_torch.launch.mesh.join_group`.  ``group=None`` is the
single-process pool (``core.dispatch._global_sim``).

Tensor-parallel head sharding over a ``"model"`` axis (the reference's
``ShardingRules`` and ``ctx.cons``) is ROADMAP queue 1 item 12: the port
has no such axis, and every rank of the group holds every head.

The ping-pong flag lives in one place, ``CADContext.pingpong`` (the
reference also keeps ``ParallelContext.pingpong``, which nothing reads).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """What the model's forward reads besides weights and batch.

    attn_impl: "ref" | "xla" | "pallas" | "cad" (see
               ``core.attention.core_attention``)
    cad:       the :class:`~repro_torch.core.dispatch.CADContext` (pool
               geometry + this step's plan) when attn_impl == "cad"
    remat:     re-run each layer's forward in the backward
               (``torch.utils.checkpoint``) instead of keeping its
               activations
    group:     the CAD process group (one rank per attention server), or
               None: every server simulated in this process
    """
    attn_impl: str = "ref"
    cad: Any = None
    remat: bool = True
    group: Any = None

