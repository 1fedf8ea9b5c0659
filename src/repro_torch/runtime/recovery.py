"""Recovery sub-plans: re-dispatch a failed server's CA tasks.

The port's copy of ``repro.runtime.recovery`` (numpy only).

Core attention is stateless (the paper's central observation): a CA
task is a pure function of the q block and its document's kv prefix,
both of which the *data ranks* still hold when an attention server
dies.  Recovery is therefore just planning again — a **sub-plan** over
exactly the lost q blocks, built by the very same
``plan_from_assignment`` machinery as the primary plan, so every
capacity check, kv-prefix invariant and dispatch-array layout is
shared with the normal path.

Exactly-once + bit-identical merging: a sub-plan's tasks are the lost
blocks and nothing else, so scattering its outputs touches exactly the
blocks the primary scatter left empty; the merge is a bitwise *select*
per block (``core.dispatch.merge_recovered``), never a floating-point
accumulation across executions.  Because every kernel in the path
computes a task identically regardless of which server runs it, the
merged step output is bit-identical to a fault-free run of the same
batch on the reduced pool (DESIGN.md §9; asserted by
``tests/test_torch_elastic.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import CommModel, CostModel, MemoryModel
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import CADConfig, StepPlan, plan_from_assignment
from repro_torch.core.scheduler import (block_costs,
                                        layout_from_segments,
                                        streamed_doc_ids)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def assignment_of_plan(cfg: CADConfig, plan) -> np.ndarray:
    """Recover the per-block server assignment from a plan's dispatch
    arrays — what would *actually execute*, not what a scheduler
    claims.  Blocks not appearing as tasks (padding) keep their home
    rank."""
    d, nb = cfg.n_servers, cfg.nb
    assign = np.arange(d * nb) // nb
    q_send = np.asarray(plan["q_send_idx"])
    for src in range(d):
        for dst in range(d):
            for c in q_send[src, dst]:
                if c >= 0:
                    assign[src * nb + int(c)] = dst
    return assign


def lost_block_mask(cfg: CADConfig, plan, failed: Iterable[int],
                    doc_of: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean [D*NB]: live q blocks whose serving server failed."""
    assign = assignment_of_plan(cfg, plan)
    failed = set(int(s) for s in failed)
    lost = np.isin(assign, sorted(failed))
    if doc_of is not None:
        lost &= doc_of >= 0
    else:
        # blocks with no task on any server are padding, never lost
        live = np.zeros(cfg.n_servers * cfg.nb, bool)
        kv_len = np.asarray(plan["task_kv_len"])
        q_home = np.asarray(plan["q_home_idx"])
        for s in range(cfg.n_servers):
            for slot in range(kv_len.shape[1]):
                if kv_len[s, slot] > 0:
                    g = _task_q_block(cfg, q_home, plan, s, slot)
                    if g is not None:
                        live[g] = True
        lost &= live
    return lost


def _task_q_block(cfg, q_home, plan, server, slot):
    nb, cq = cfg.nb, cfg.cq
    if slot < nb:
        idx = int(q_home[server, slot])
        return server * nb + idx if idx >= 0 else None
    src, c = divmod(slot - nb, cq)
    idx = int(np.asarray(plan["q_send_idx"])[src, server, c])
    return src * nb + idx if idx >= 0 else None


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """A recovery sub-plan: the typed StepPlan whose only live tasks
    are the lost blocks, the [D*NB] lost-block mask to merge by, and
    the per-survivor modeled time the recovery adds."""
    plan: StepPlan
    lost: np.ndarray                    # [D*NB] bool
    assign: np.ndarray                  # [G] full assignment (lost only
    #                                     meaningful where ``lost``)
    added_time: Dict[int, float]        # survivor -> modeled seconds

    @property
    def n_blocks(self) -> int:
        return int(self.lost.sum())


def build_recovery_plan(cfg: CADConfig, segment_ids: np.ndarray, plan,
                        failed: Iterable[int], *,
                        allowed: Iterable[int],
                        base_loads: Optional[Dict[int, float]] = None,
                        cost_model: Optional[CostModel] = None,
                        speeds: Optional[np.ndarray] = None,
                        mem_model: Optional[MemoryModel] = None,
                        budgets: Optional[np.ndarray] = None,
                        base_resident: Optional[Dict[int, float]] = None,
                        stream_chunk: Optional[int] = None,
                        mask: Optional[MaskSpec] = None) \
        -> Optional[RecoveryPlan]:
    """Build the sub-plan that recomputes every task lost on ``failed``
    onto ``allowed`` survivors.

    Each maximal contiguous run of lost blocks within one document is
    dealt whole to the survivor with the least (base + already-added)
    modeled time — contiguous runs keep each kv prefix send a single
    range, the comm-minimal granularity of the primary scheduler.
    ``base_loads`` carries the survivors' primary-serve times so
    recovery lands on the least-busy endpoints first.  Returns ``None``
    when the failure lost no live tasks (nothing to recover).

    With ``budgets`` (per-endpoint HBM bytes, defaulting to
    ``cfg.budgets()``; ``base_resident`` carries the survivors'
    primary resident bytes) destination choice is memory-aware:
    survivors whose resident bytes would overflow are skipped while
    any in-budget survivor remains.  When *no* survivor fits — a
    recovery has nowhere cheaper to go — the least-loaded survivor
    takes the run anyway: with ``stream_chunk`` set, dispatch streams
    the kv prefix chunkwise so hardware residency stays bounded; a
    lost task is never dropped for memory (DESIGN.md §11).

    ``mask`` is the session's :class:`~repro_torch.core.mask.MaskSpec`: run
    pricing and the incremental kv view both use *live*-block costs
    (DESIGN.md §12), so doc-masked recovery lands where the real
    compute is cheapest — area pricing would deal deep (area-heavy,
    mask-cheap) runs as if they were expensive and skew the survivor
    balance.  Every elastic pricing path must consume mask-aware costs
    (DESIGN.md §9)."""
    failed = sorted({int(s) for s in failed})
    allowed = sorted({int(s) for s in allowed})
    if not allowed:
        raise ValueError("recovery needs at least one surviving server")
    if set(allowed) & set(failed):
        raise ValueError(f"survivors {allowed} overlap failures {failed}")
    docs, doc_of, bi_of = layout_from_segments(segment_ids, cfg.blk,
                                               cfg.n_servers)
    lost = lost_block_mask(cfg, plan, failed, doc_of)
    if not lost.any():
        return None
    speeds = cfg.speeds() if speeds is None \
        else np.asarray(speeds, np.float64)
    cost = block_costs(doc_of, bi_of, cfg.blk, cost_model, mask)
    loads = {s: float((base_loads or {}).get(s, 0.0)) for s in allowed}
    added = {s: 0.0 for s in allowed}

    if budgets is None:
        budgets = cfg.budgets()
    chunk = cfg.stream_chunk if stream_chunk is None else int(stream_chunk)
    mem = streamed = resident = kv_need = None
    if budgets is not None:
        budgets = np.asarray(budgets, np.float64)
        mem = mem_model or MemoryModel(CommModel(1, 1, 1))
        streamed = set(streamed_doc_ids(docs, cfg.blk, mem, budgets,
                                        stream_chunk=chunk,
                                        allowed=allowed))
        q_unit = mem.q_bytes(cfg.blk) + mem.residual_bytes(cfg.blk)
        resident = {s: float((base_resident or {}).get(s, 0.0))
                    for s in allowed}
        kv_need = {s: {} for s in allowed}

    def mem_add(s: int, dc: int, pref: int, n_q: int) -> float:
        """Incremental resident bytes if survivor ``s`` takes a run of
        ``n_q`` blocks of doc ``dc`` needing kv prefix ``pref`` — the
        ``live_kv_bytes`` view under a mask (prefix-live difference),
        reducing exactly to the dense increment when the mask is
        trivial."""
        p = min(pref, chunk) if dc in streamed else pref
        have = min(kv_need[s].get(dc, 0), p)
        kv = mem.live_kv_bytes(p * cfg.blk, mask, cfg.blk) \
            - mem.live_kv_bytes(have * cfg.blk, mask, cfg.blk)
        return q_unit * n_q + max(0.0, kv)

    assign = np.arange(cfg.n_servers * cfg.nb) // cfg.nb
    masked_doc_of = np.where(lost, doc_of, -1)
    # maximal contiguous lost runs, document-pure, dealt to the least
    # loaded survivor (deterministic tie-break: lowest slot)
    g = 0
    G = cfg.n_servers * cfg.nb
    while g < G:
        if not lost[g]:
            g += 1
            continue
        dc = int(doc_of[g])
        h = g
        while h < G and lost[h] and int(doc_of[h]) == dc:
            h += 1
        run_cost = float(cost[g:h].sum())
        pool = allowed
        if mem is not None:
            pref = int(bi_of[h - 1]) + 1
            fits = [s for s in allowed
                    if resident[s] + mem_add(s, dc, pref, h - g)
                    <= budgets[s]]
            pool = fits or allowed     # never drop a lost task
        dst = min(pool,
                  key=lambda s: (loads[s] + run_cost / speeds[s], s))
        assign[g:h] = dst
        loads[dst] += run_cost / speeds[dst]
        added[dst] += run_cost / speeds[dst]
        if mem is not None:
            resident[dst] += mem_add(dst, dc, pref, h - g)
            p = min(pref, chunk) if dc in streamed else pref
            kv_need[dst][dc] = max(kv_need[dst].get(dc, 0), p)
        g = h
    sub = plan_from_assignment(cfg, assign, masked_doc_of, bi_of, docs)
    out = RecoveryPlan(plan=sub, lost=lost, assign=assign,
                       added_time={s: t for s, t in added.items()
                                   if t > 0})
    # narrate the sub-plan itself (DESIGN.md §14): the executor times
    # and spans its *execution*; this is the planning decision
    obs_trace.get_recorder().instant(
        "recovery.plan", "planner",
        args={"failed": failed, "n_blocks": out.n_blocks,
              "destinations": sorted(out.added_time)})
    reg = obs_metrics.get_registry()
    reg.counter("cad_recovery_plans_total",
                "recovery sub-plans built").inc()
    reg.counter("cad_recovery_blocks_planned_total",
                "lost q blocks routed to survivors").inc(out.n_blocks)
    return out


def recovery_tasks(cfg: CADConfig, rec: RecoveryPlan,
                   mask: Optional[MaskSpec] = None) \
        -> Dict[int, Tuple[Tuple[int, int], ...]]:
    """Per-survivor (q_tokens, kv_tokens) task shapes of a recovery
    sub-plan — calibrator food and modeled-time input.  With ``mask``
    the kv lengths are the tasks' *live* kv tokens, matching the grid
    cells masked primary serves calibrate (DESIGN.md §12)."""
    from repro_torch.core.dispatch import iter_plan_tasks
    out: Dict[int, list] = {}
    for s, _slot, qt, kvt in iter_plan_tasks(cfg, rec.plan, mask):
        out.setdefault(s, []).append((qt, kvt))
    return {s: tuple(v) for s, v in out.items()}
