"""Pipeline parallelism with CAD across stages (paper §4.1, Figure 8).

The port of ``repro.pipeline_par.pipeline``.  A GPipe schedule run as
*ticks*: at tick t, stage s runs microbatch t - s, and every stage runs
the same phase in a tick, active or not (the paper's adjustment that lets
a device switch between layer compute and attention serving).  The
reference scans over ticks inside a ``shard_map`` over a ``"stage"``
axis; here each stage is one process of a ``torch.distributed`` group
(the stage group), and the tick loop is Python.  The stage group is also
the CAD group (``ParallelContext.group``): the reference's ``"stage"``
axis is both.

CAD across stages: core attention has no weights, so the CA-tasks of the
microbatches that live at different stages in one tick are alike, and
``tick_schedules`` balances them over the whole stage pool with one plan
a tick.  In warm-up and drain the idle stages carry no load of their own
and the scheduler gives them other stages' tasks: the idle devices serve
attention, with no special case in the plan machinery.

The backward is autograd through the ticks, the mirror of the forward:
the stage shift (``_Shift``, one ``all_to_all_single``) sends the
gradient back along the reverse rotation, and the replication of the
last stage's outputs (``_SumOverGroup``) sums the ranks' gradients.  The
graph is built by masking (``torch.where``), never by branching on the
rank, so every rank builds the same graph and reaches every collective,
forward and backward, in the same order.

``_tick_sim`` runs the same ticks, masks and plans with every stage in
one process, each tick's CA exchange served by ``_global_sim``: the
oracle the group's outputs and gradients are held against.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
from torch import nn

from repro_torch.core.cost_model import CommModel
from repro_torch.core.plan import CADConfig, plan_from_schedule
from repro_torch.core.scheduler import schedule
from repro_torch.models import layers as L

# segment-id offset of microbatch m in a tick's plan, so that documents of
# different microbatches stay distinct (the reference's)
MB_SEG_OFFSET = 100000


def split_stages(layers, n_stages: int, period: int = 1) \
        -> List[nn.ModuleList]:
    """The counterpart of the reference's reshape of its scan-over-groups
    params ``[G, ...]`` to ``[n_stages, G / n_stages, ...]``: stage s gets
    its contiguous slice of ``layers`` (a model's ``Transformer.layers``,
    layer l = pattern slot ``l % period`` of group ``l // period``), as
    modules shared with ``layers``.  Raises where the layers do not split
    into whole pattern periods per stage (the reference asserts)."""
    n = len(layers)
    if n_stages < 1 or n % (n_stages * period):
        raise ValueError(f"{n} layers do not split into {n_stages} stages "
                         f"of whole {period}-layer pattern periods")
    per = n // n_stages
    return [nn.ModuleList(layers[s * per:(s + 1) * per])
            for s in range(n_stages)]


def tick_schedules(segs_mb: np.ndarray, n_stages: int, cadcfg: CADConfig,
                   comm: CommModel, tolerance: float = 0.1):
    """Host-side: one CAD plan per pipeline tick.

    ``segs_mb`` [n_micro, tokens_mb]: each microbatch's packed segment
    ids.  At tick t, stage s holds microbatch t - s (its ids offset by
    ``m * MB_SEG_OFFSET``); an inactive stage holds a zero chunk, and the
    scheduler offloads the busy stages' CA-tasks onto it.  Returns the
    plans stacked with a leading ``n_ticks`` dim (each plan's own leading
    dim is the stage / server dim) and per tick ``{"tick", "moves",
    "comm_bytes", "loads"}``."""
    n_micro, tokens = segs_mb.shape
    n_ticks = n_micro + n_stages - 1
    plans, stats = [], []
    for t in range(n_ticks):
        segs_tick = np.zeros((n_stages, tokens), segs_mb.dtype)
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                seg = segs_mb[m]
                segs_tick[s] = np.where(seg > 0, seg + m * MB_SEG_OFFSET, 0)
        sch = schedule(segs_tick, blk=cadcfg.blk, n_servers=n_stages,
                       comm=comm, caps=cadcfg.caps(), tolerance=tolerance)
        plans.append(plan_from_schedule(cadcfg, sch))
        stats.append({"tick": t, "moves": sch.n_moves,
                      "comm_bytes": sch.comm_bytes,
                      "loads": sch.loads.copy()})
    stacked = {k: np.stack([p[k] for p in plans]) for k in plans[0].keys()}
    return stacked, stats


def _tick_plan(plans, t: int):
    return None if plans is None else {k: v[t] for k, v in plans.items()}


class _Shift(torch.autograd.Function):
    """Activations one stage along the ring ``s -> (s + 1) % n``: one
    ``all_to_all_single`` whose splits send the whole of ``x`` (rows on
    dim 0) to the next stage and nothing elsewhere, and take the previous
    stage's.  The backward runs the transposed splits: the gradient goes
    back to the previous stage (the reverse rotation, the mirrored
    pipeline)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        n = dist.get_world_size(group)
        s = dist.get_rank(group)
        rows = x.shape[0]
        to_next = [0] * n
        to_next[(s + 1) % n] = rows
        from_prev = [0] * n
        from_prev[(s - 1) % n] = rows
        ctx.group, ctx.to_next, ctx.from_prev = group, to_next, from_prev
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(),
                               output_split_sizes=from_prev,
                               input_split_sizes=to_next, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(),
                               output_split_sizes=ctx.to_next,
                               input_split_sizes=ctx.from_prev,
                               group=ctx.group)
        return out, None


class _SumOverGroup(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group``: every rank gets the sum.  The
    backward is the same sum of the ranks' gradients (the transpose of a
    sum handed to every rank), so a loss computed once, on one rank, with
    zero gradients from the others, gives the unpipelined gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def pipeline_apply(h_mb: torch.Tensor, stage_fn: Callable, *, n_stages: int,
                   group, plans=None) -> torch.Tensor:
    """Run the pipeline on this process's stage of ``group`` (one process
    per stage; rank s is stage s).

    h_mb   [n_micro, Bm, S, D] microbatch inputs (the same on every rank;
           only stage 0 reads them)
    stage_fn(h, m, tick_plan) -> h: this stage's layers on h [Bm, S, D],
           the input of microbatch m; called at every tick, active or not,
           so every rank reaches every collective of it in the same order
    plans  optional per-tick CAD plans with a leading ``n_ticks`` dim
           (``tick_schedules``, as host arrays or tensors); the tick's plan
           (every stage's rows) is passed to ``stage_fn``

    Returns [n_micro, Bm, S, D]: the last stage's outputs, replicated to
    every rank by a masked sum over the group.  Its backward sums the
    ranks' gradients: compute the loss on one rank and call
    ``torch.autograd.backward`` on every rank, the others with zero
    gradients.  Parameters that some stages do not touch (embed, unembed,
    final norm) then hold part of their gradient on some ranks only:
    ``sum_grads_over_stages`` completes them."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n != n_stages:
        raise ValueError(f"the stage group has {n} ranks, the pipeline "
                         f"{n_stages} stages")
    sid = dist.get_rank(group)
    n_micro = h_mb.shape[0]
    n_ticks = n_micro + n_stages - 1
    dev = h_mb.device

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=dev)

    zeros = torch.zeros_like(h_mb[0])
    h_buf = zeros
    outs = [zeros] * n_micro
    first, last = flag(sid == 0), flag(sid == n_stages - 1)
    for t in range(n_ticks):
        m = t - sid
        active = flag(0 <= m < n_micro)
        m_c = min(max(m, 0), n_micro - 1)
        h_in = torch.where(first, h_mb[m_c], h_buf)
        h_out = torch.where(active, stage_fn(h_in, m_c, _tick_plan(plans, t)),
                            zeros)
        # collect at the last stage
        outs[m_c] = torch.where(active & last, h_out, outs[m_c])
        # rotate activations to the next stage (after the last tick no
        # stage reads them: every rank skips that shift)
        if t < n_ticks - 1:
            h_buf = _Shift.apply(h_out, group)
    return _SumOverGroup.apply(torch.where(last, torch.stack(outs),
                                           torch.zeros_like(h_mb)), group)


def sum_grads_over_stages(params, group) -> None:
    """Sum each parameter's gradient over the stage group, in place, the
    missing ones as zeros: for the parameters every stage holds (embed,
    unembed, final norm) that only some stages use (stage 0 alone reads
    the embedded inputs; the loss rank alone unembeds)."""
    import torch.distributed as dist
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad, group=group)


def model_stage_fn(model, layers, ctx, segment_ids, positions) -> Callable:
    """A ``stage_fn`` for ``pipeline_apply``: ``layers`` (this stage's
    slice of ``model.layers``, ``split_stages``) on microbatch m's
    ``segment_ids[m]`` / ``positions[m]`` [Bm, S], each layer under
    ``torch.utils.checkpoint`` with ``ctx.remat``, the tick's plan bound
    into ``ctx``'s CAD context (the dispatch takes this rank's row of it:
    ``ctx.group`` is the stage group).  MoE auxiliary losses are dropped,
    as the reference's pipeline drops them.

    Under ``ctx.remat`` each layer's CA exchanges run again in the
    backward, when autograd first needs that layer's saved tensors.  Every
    rank built the same graph, and autograd orders its nodes by the graph
    alone, so every rank recomputes the same layer at the same point of
    the backward and reaches its exchanges in the same order."""
    def stage_fn(h, m, tick_plan):
        c = ctx if tick_plan is None else ctx.cad.bind_plan(ctx, tick_plan)
        batch = {"segment_ids": segment_ids[m], "positions": positions[m]}
        return model._run_layers(layers, h, batch, c, hooked=False)[0]
    return stage_fn


# ------------------------------------------------------------- the oracle
def _tick_sim(h_mb: torch.Tensor, tick_fn: Callable, *, n_stages: int,
              plans=None) -> torch.Tensor:
    """``pipeline_apply`` with every stage in this process: the same
    ticks, masks and plans, ``tick_fn(hs, ms, tick_plan) -> hs`` running
    every stage's step of a tick at once (lists over the stages).  Returns
    the last stage's outputs [n_micro, Bm, S, D]."""
    n_micro = h_mb.shape[0]
    n_ticks = n_micro + n_stages - 1
    dev = h_mb.device
    zeros = torch.zeros_like(h_mb[0])
    bufs = [zeros] * n_stages
    outs = [zeros] * n_micro
    for t in range(n_ticks):
        ms = [t - s for s in range(n_stages)]
        m_c = [min(max(m, 0), n_micro - 1) for m in ms]
        h_in = [torch.where(torch.tensor(s == 0, device=dev), h_mb[m_c[s]],
                            bufs[s]) for s in range(n_stages)]
        h_out = tick_fn(h_in, m_c, _tick_plan(plans, t))
        h_out = [torch.where(torch.tensor(0 <= ms[s] < n_micro, device=dev),
                             h_out[s], zeros) for s in range(n_stages)]
        last = n_stages - 1
        if 0 <= ms[last] < n_micro:
            outs[m_c[last]] = h_out[last]
        bufs = [h_out[(s - 1) % n_stages] for s in range(n_stages)]
    return torch.stack(outs)


def _lockstep_tick_fn(model, stages, ctx, segment_ids, positions) \
        -> Callable:
    """``_tick_sim``'s ``tick_fn`` for a model's stages (``split_stages``)
    of ``global`` layers: layer j of every stage in turn, each stage's
    norm and q/k/v projections on its own rows, one core-attention call
    over the stages' rows stacked rank-major (with ``ctx.group`` None and
    the tick's plan bound, the single-process dispatch: ``_global_sim``),
    then each stage's output projection and the block's tail.  The
    operations of ``Transformer._block_train`` for a ``global`` layer, on
    the shapes each rank of the group gives them."""
    from repro_torch.core.attention import core_attention
    from repro_torch.core.dispatch import _plan_tensors
    cfg = model.cfg
    for st in stages:
        for blk in st:
            if blk.kind != "global" or cfg.post_norms:
                raise ValueError("the lockstep oracle takes global layers "
                                 "without post-norms")

    def tick_fn(hs, ms, tick_plan):
        c = ctx if tick_plan is None else ctx.cad.bind_plan(
            ctx, _plan_tensors(tick_plan, hs[0].device))
        seg = torch.cat([segment_ids[m] for m in ms])
        pos = torch.cat([positions[m] for m in ms])
        for j in range(len(stages[0])):
            blks = [st[j] for st in stages]
            qkv = [L.qkv_proj(b.attn, L.norm_apply(b.norm1, h, cfg.norm),
                              cfg, positions[m] if cfg.use_rope else None)
                   for b, h, m in zip(blks, hs, ms)]
            o = core_attention(*(torch.cat(x) for x in zip(*qkv)), seg, pos,
                               seg, pos, causal=True, window=0,
                               softcap=cfg.attn_logit_softcap, ctx=c)
            rows = hs[0].shape[0]
            hs = [model._attn_residual_tail(
                b, h, o[i * rows:(i + 1) * rows].reshape(
                    h.shape[:2] + (cfg.n_heads * cfg.head_dim,))
                @ b.attn["wo"])[0]
                for i, (b, h) in enumerate(zip(blks, hs))]
        return hs
    return tick_fn
