"""Pluggable plan policies for the attention service.

The port's copy of ``repro.cad.planner`` (numpy only).

A *planner* maps a packed batch's document layout to a
:class:`~repro_torch.core.plan.StepPlan` plus scheduling statistics.  Policies
are registered by name so every plan-building site — the data pipeline,
benchmarks, launch dry-runs, examples — selects behavior with a single
``plan_policy="..."`` string:

  identity    every block served at home (no disaggregation; the
              fixed-packing baseline expressed as a CAD plan)
  per_doc_cp  head-tail per-document context parallelism (paper §2.2,
              DISTFLASHATTN-style) as a registered policy
  balanced    the communication-aware greedy scheduler (paper §4.2)
  ring        DISTFLASHATTN-style ring / context parallelism: each
              endpoint owns the p-th contiguous kv shard of every
              document (DESIGN.md §13) — the external baseline CAD's
              planners are measured against in benchmarks/cad_vs_ring

All planners build their dispatch arrays through the same
``plan_from_assignment``, so two policies that produce the same
assignment produce bit-identical plans.

``comm`` calibrates comm-volume accounting (and, for ``balanced``, the
scheduler's bytes-per-FLOP scoring) to the model's head geometry; with
``comm=None`` reported ``comm_bytes`` is 0 and ``balanced`` falls back
to a unit-size byte model — pass the real ``CommModel`` whenever stats
are compared across call sites.  ``build_plan=False`` skips the
dispatch-array construction (and its capacity checks) for
analysis-only callers that never dispatch.

Heterogeneous pools and runtime calibration (DESIGN.md §3): every
policy accepts ``cost_model`` (a measured/calibrated latency grid;
``None`` = relative FLOPs) and ``speeds`` (per-server speed factors;
``None`` = ``cfg.speeds()``).  Reported ``loads`` are per-server
modeled *time* — assigned cost over speed — so stats stay comparable
across policies on a heterogeneous pool; ``balanced`` additionally
balances against per-server capacity, giving a 0.5x server half the
FLOPs.

Mask-structured tasks (DESIGN.md §12): every policy accepts ``mask`` —
a :class:`~repro_torch.core.mask.MaskSpec` that reprices q-blocks by their
*live* kv blocks.  ``balanced`` then splits documents along the mask
structure (per-server live-block time balances instead of rectangle
area); the fixed layouts report honestly-masked loads so policy
comparisons under sparse masks stay meaningful.

Elastic membership (DESIGN.md §9): every policy accepts ``exclude`` — a
set of servers (drained or dead pool members) that must not hold CA
tasks.  Documents homed on an excluded server are evacuated to the
survivors; the dispatch geometry (array shapes) never changes, so one
compiled executable serves every membership epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import CommModel, CostModel, MemoryModel
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import CADConfig, PlanMemoryError, StepPlan, \
    head_tail_assignment, identity_assignment, plan_from_assignment, \
    ring_assignment
from repro_torch.core.scheduler import assignment_resident_bytes, \
    block_costs, check_exclude, layout_from_segments, schedule, \
    streamed_doc_ids


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """A planner's output: the typed plan, the raw per-block assignment
    (for analysis/benchmarks), per-server loads, and summary stats.
    ``plan`` is None when the planner ran with ``build_plan=False``
    (analysis-only callers that never dispatch).  ``loads`` is modeled
    per-server time (cost / speed); with the homogeneous default and no
    cost model it equals relative FLOPs.  ``resident_bytes`` is the
    per-server modeled HBM working set (populated whenever a memory
    model was in play — always when ``cfg.server_hbm`` is set);
    ``streamed`` names docs whose kv streams in chunks (DESIGN.md
    §11)."""
    plan: Optional[StepPlan]
    assign: np.ndarray            # [G] server per global q-block
    loads: np.ndarray             # [S] per-server modeled time
    stats: Dict[str, float]       # comm_bytes, n_moves, load_max_over_mean
    resident_bytes: Optional[np.ndarray] = None   # [S] modeled HBM bytes
    streamed: Tuple[int, ...] = ()                # doc ids streaming kv


# planner signature:
#   (cfg, segment_ids, *, comm, tolerance, build_plan, cost_model,
#    speeds, exclude, mem_model, budgets, stream_chunk, mask)
#   -> PlanResult
Planner = Callable[..., PlanResult]

_PLANNERS: Dict[str, Planner] = {}


def register_planner(name: str) -> Callable[[Planner], Planner]:
    """Decorator: register ``fn`` under ``name`` in the policy registry."""
    def deco(fn: Planner) -> Planner:
        _PLANNERS[name] = fn
        return fn
    return deco


def get_planner(name: str) -> Planner:
    try:
        return _PLANNERS[name]
    except KeyError:
        raise KeyError(f"unknown plan policy {name!r}; registered: "
                       f"{sorted(_PLANNERS)}") from None


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_PLANNERS))


def _resolve_speeds(cfg: CADConfig, speeds) -> np.ndarray:
    return cfg.speeds() if speeds is None \
        else np.asarray(speeds, np.float64)


def _evacuate_whole_docs(assign: np.ndarray, docs,
                         exclude: Tuple[int, ...],
                         allowed: Tuple[int, ...]) -> np.ndarray:
    """Deterministic fallback evacuation for the fixed-layout policies
    (identity / per_doc_cp): whole documents homed on an excluded server
    are dealt round-robin over the survivors, in document order."""
    i = 0
    for d in docs:
        if d.home in exclude:
            assign[d.g0:d.g0 + d.n_blocks] = allowed[i % len(allowed)]
            i += 1
    return assign


def _loads_of(assign: np.ndarray, doc_of: np.ndarray, bi_of: np.ndarray,
              blk: int, n_servers: int,
              cost_model: Optional[CostModel] = None,
              speeds: Optional[np.ndarray] = None,
              mask: Optional[MaskSpec] = None) -> np.ndarray:
    cost = block_costs(doc_of, bi_of, blk, cost_model, mask)
    loads = np.zeros(n_servers)
    live = doc_of >= 0
    np.add.at(loads, assign[live].astype(np.int64), cost[live])
    return loads if speeds is None else loads / speeds


def _migration_bytes(cfg: CADConfig, assign: np.ndarray, docs,
                     doc_of: np.ndarray, bi_of: np.ndarray,
                     comm: Optional[CommModel]) -> float:
    """Comm volume implied by an assignment (one layer, forward
    direction): offloaded q blocks + the deduplicated kv prefixes each
    server must receive — the same counting the dispatch send slots
    realize, without building the plan arrays."""
    if comm is None:
        return 0.0
    d, nb = cfg.n_servers, cfg.nb
    home = identity_assignment(cfg)
    live = doc_of >= 0
    n_q = int((assign[live] != home[live]).sum())
    needs: list = [dict() for _ in range(d)]
    for g in np.nonzero(live)[0]:
        s = int(assign[g])
        dc = int(doc_of[g])
        needs[s][dc] = max(needs[s].get(dc, 0), int(bi_of[g]) + 1)
    n_kv = 0
    for s in range(d):
        for dc, pref in needs[s].items():
            g0 = docs[dc].g0
            n_kv += sum(1 for g in range(g0, g0 + pref) if g // nb != s)
    return float(comm.migration_bytes(n_q * cfg.blk, n_kv * cfg.blk))


def _stats(loads: np.ndarray, comm_bytes: float, n_moves: int,
           resident: Optional[np.ndarray] = None,
           allowed: Optional[Tuple[int, ...]] = None) -> Dict[str, float]:
    st = {"comm_bytes": float(comm_bytes), "n_moves": int(n_moves),
          "load_max_over_mean": float(loads.max()
                                      / max(loads.mean(), 1e-9))}
    if resident is not None:
        r = resident if allowed is None else resident[list(allowed)]
        st["peak_resident_bytes"] = float(r.max())
        st["resident_max_over_mean"] = float(r.max()
                                             / max(r.mean(), 1e-9))
    return st


def _mem_setup(cfg: CADConfig, comm: Optional[CommModel], mem_model,
               budgets, stream_chunk):
    """Resolve the memory-planning inputs: explicit kwargs win, else the
    config's ``server_hbm``/``stream_chunk``.  Returns (mem, budgets,
    chunk) with ``mem`` None only when memory is wholly unconstrained
    AND no model was requested (resident stats are then skipped)."""
    budgets = cfg.budgets() if budgets is None \
        else np.asarray(budgets, np.float64)
    chunk = cfg.stream_chunk if stream_chunk is None else int(stream_chunk)
    if mem_model is None and budgets is None:
        return None, None, chunk
    mem = mem_model if mem_model is not None else MemoryModel(
        comm if comm is not None
        else CommModel(n_heads=1, head_dim=1, n_kv_heads=1))
    return mem, budgets, chunk


def _check_fixed_layout_memory(policy: str, cfg: CADConfig, assign, docs,
                               doc_of, bi_of, mem, budgets, chunk,
                               allowed: Tuple[int, ...]):
    """Memory accounting for the fixed-layout policies (identity /
    per_doc_cp).  Their assignments are not re-splittable by
    construction, so a budget overflow is immediately terminal:
    :class:`PlanMemoryError` — the caller should pick ``balanced``
    (which re-splits) or raise the budget."""
    if mem is None:
        return None, ()
    streamed = () if budgets is None else streamed_doc_ids(
        docs, cfg.blk, mem, budgets, stream_chunk=chunk, allowed=allowed)
    resident = assignment_resident_bytes(
        assign, doc_of, bi_of, cfg.blk, cfg.n_servers, mem,
        streamed=streamed, stream_chunk=chunk)
    if budgets is not None:
        for s in allowed:
            if resident[s] > budgets[s]:
                raise PlanMemoryError(
                    s, float(resident[s]), float(budgets[s]),
                    detail=f"{policy} is a fixed layout and cannot "
                           f"re-split; use plan_policy='balanced'")
    return resident, streamed


@register_planner("identity")
def identity_planner(cfg: CADConfig, segment_ids: np.ndarray, *,
                     comm: Optional[CommModel] = None,
                     tolerance: float = 0.0,
                     build_plan: bool = True,
                     cost_model: Optional[CostModel] = None,
                     speeds: Optional[np.ndarray] = None,
                     exclude: Optional[Iterable[int]] = None,
                     mem_model: Optional[MemoryModel] = None,
                     budgets: Optional[np.ndarray] = None,
                     stream_chunk: Optional[int] = None,
                     mask: Optional[MaskSpec] = None) -> PlanResult:
    docs, doc_of, bi_of = layout_from_segments(segment_ids, cfg.blk,
                                               cfg.n_servers)
    exclude = check_exclude(exclude, cfg.n_servers)
    allowed = tuple(s for s in range(cfg.n_servers) if s not in exclude)
    assign = identity_assignment(cfg)
    n_moves = 0
    if exclude:
        assign = _evacuate_whole_docs(assign, docs, exclude, allowed)
        home = identity_assignment(cfg)
        live = doc_of >= 0
        n_moves = int((assign[live] != home[live]).sum())
    mem, budgets, chunk = _mem_setup(cfg, comm, mem_model, budgets,
                                     stream_chunk)
    resident, streamed = _check_fixed_layout_memory(
        "identity", cfg, assign, docs, doc_of, bi_of, mem, budgets,
        chunk, allowed)
    plan = plan_from_assignment(cfg, assign, doc_of, bi_of, docs) \
        if build_plan else None
    loads = _loads_of(assign, doc_of, bi_of, cfg.blk, cfg.n_servers,
                      cost_model, _resolve_speeds(cfg, speeds), mask)
    return PlanResult(plan=plan, assign=assign, loads=loads,
                      stats=_stats(loads, _migration_bytes(
                          cfg, assign, docs, doc_of, bi_of, comm)
                          if exclude else 0.0, n_moves,
                          resident, allowed),
                      resident_bytes=resident, streamed=streamed)


@register_planner("per_doc_cp")
def per_doc_cp_planner(cfg: CADConfig, segment_ids: np.ndarray, *,
                       comm: Optional[CommModel] = None,
                       tolerance: float = 0.0,
                       build_plan: bool = True,
                       cost_model: Optional[CostModel] = None,
                       speeds: Optional[np.ndarray] = None,
                       exclude: Optional[Iterable[int]] = None,
                       mem_model: Optional[MemoryModel] = None,
                       budgets: Optional[np.ndarray] = None,
                       stream_chunk: Optional[int] = None,
                       mask: Optional[MaskSpec] = None) \
        -> PlanResult:
    """Head-tail per-document CP (paper §2.2 as a special-case plan).
    The dealing order is the paper's fixed head-tail pairing — speed-
    oblivious by construction — but loads/stats are still reported in
    modeled time so heterogeneous-pool comparisons stay honest.  With
    ``exclude`` the head-tail deal runs over the surviving servers."""
    docs, doc_of, bi_of = layout_from_segments(segment_ids, cfg.blk,
                                               cfg.n_servers)
    exclude = check_exclude(exclude, cfg.n_servers)
    allowed = tuple(s for s in range(cfg.n_servers) if s not in exclude)
    servers = allowed if exclude else None
    assign = head_tail_assignment(cfg, docs, servers)
    mem, budgets, chunk = _mem_setup(cfg, comm, mem_model, budgets,
                                     stream_chunk)
    resident, streamed = _check_fixed_layout_memory(
        "per_doc_cp", cfg, assign, docs, doc_of, bi_of, mem, budgets,
        chunk, allowed)
    plan = plan_from_assignment(cfg, assign, doc_of, bi_of, docs) \
        if build_plan else None
    loads = _loads_of(assign, doc_of, bi_of, cfg.blk, cfg.n_servers,
                      cost_model, _resolve_speeds(cfg, speeds), mask)
    n_moves = int((assign != identity_assignment(cfg)).sum())
    return PlanResult(
        plan=plan, assign=assign, loads=loads,
        stats=_stats(loads, _migration_bytes(cfg, assign, docs, doc_of,
                                             bi_of, comm), n_moves,
                     resident, allowed),
        resident_bytes=resident, streamed=streamed)


@register_planner("ring")
def ring_planner(cfg: CADConfig, segment_ids: np.ndarray, *,
                 comm: Optional[CommModel] = None,
                 tolerance: float = 0.0,
                 build_plan: bool = True,
                 cost_model: Optional[CostModel] = None,
                 speeds: Optional[np.ndarray] = None,
                 exclude: Optional[Iterable[int]] = None,
                 mem_model: Optional[MemoryModel] = None,
                 budgets: Optional[np.ndarray] = None,
                 stream_chunk: Optional[int] = None,
                 mask: Optional[MaskSpec] = None) -> PlanResult:
    """Ring / context-parallel attention (DISTFLASHATTN, DESIGN.md §13)
    as a registered policy: every document is cut into P contiguous kv
    shards and shard ``p`` is owned by the ``p``-th allowed server, so
    q blocks rotate through P ring passes at execution time
    (``dispatch.ring_attention``).  Sequence-contiguous and
    workload-oblivious by construction — under causal attention the
    tail-shard endpoints carry quadratically more compute, the
    imbalance CAD's ``balanced`` planner is quantified against in
    ``benchmarks/cad_vs_ring.py``.  Loads/stats are reported in modeled
    time with mask-aware live-block pricing like every other policy,
    so the comparison measures what the kernels execute.  With
    ``exclude`` the ring shrinks to the surviving servers."""
    docs, doc_of, bi_of = layout_from_segments(segment_ids, cfg.blk,
                                               cfg.n_servers)
    exclude = check_exclude(exclude, cfg.n_servers)
    allowed = tuple(s for s in range(cfg.n_servers) if s not in exclude)
    servers = allowed if exclude else None
    assign = ring_assignment(cfg, docs, servers)
    mem, budgets, chunk = _mem_setup(cfg, comm, mem_model, budgets,
                                     stream_chunk)
    resident, streamed = _check_fixed_layout_memory(
        "ring", cfg, assign, docs, doc_of, bi_of, mem, budgets,
        chunk, allowed)
    plan = plan_from_assignment(cfg, assign, doc_of, bi_of, docs) \
        if build_plan else None
    loads = _loads_of(assign, doc_of, bi_of, cfg.blk, cfg.n_servers,
                      cost_model, _resolve_speeds(cfg, speeds), mask)
    n_moves = int((assign != identity_assignment(cfg)).sum())
    return PlanResult(
        plan=plan, assign=assign, loads=loads,
        stats=_stats(loads, _migration_bytes(cfg, assign, docs, doc_of,
                                             bi_of, comm), n_moves,
                     resident, allowed),
        resident_bytes=resident, streamed=streamed)


@register_planner("balanced")
def balanced_planner(cfg: CADConfig, segment_ids: np.ndarray, *,
                     comm: Optional[CommModel] = None,
                     tolerance: float = 0.1,
                     build_plan: bool = True,
                     cost_model: Optional[CostModel] = None,
                     speeds: Optional[np.ndarray] = None,
                     exclude: Optional[Iterable[int]] = None,
                     mem_model: Optional[MemoryModel] = None,
                     budgets: Optional[np.ndarray] = None,
                     stream_chunk: Optional[int] = None,
                     mask: Optional[MaskSpec] = None) \
        -> PlanResult:
    """The paper's communication-aware greedy scheduler (§4.2), balancing
    modeled time across per-server capacities (calibrated cost model +
    speed factors) when provided; ``exclude`` withdraws drained/dead
    pool members from the balance (DESIGN.md §9).  With HBM budgets
    (``cfg.server_hbm`` or explicit ``budgets``) assignments are
    re-split until every endpoint's resident bytes fit (DESIGN.md §11),
    raising :class:`PlanMemoryError` only when no feasible split
    exists."""
    if comm is None:
        comm = CommModel(n_heads=1, head_dim=1, n_kv_heads=1)
    mem, budgets, chunk = _mem_setup(cfg, comm, mem_model, budgets,
                                     stream_chunk)
    sch = schedule(segment_ids, blk=cfg.blk, n_servers=cfg.n_servers,
                   comm=comm, caps=cfg.caps(), tolerance=tolerance,
                   speeds=_resolve_speeds(cfg, speeds),
                   cost_model=cost_model, exclude=exclude,
                   mem_model=mem, budgets=budgets, stream_chunk=chunk,
                   mask=mask)
    plan = plan_from_assignment(cfg, sch.assign, sch.doc_of_block,
                                sch.bi_of_block, sch.docs) \
        if build_plan else None
    allowed = tuple(s for s in range(cfg.n_servers)
                    if s not in set(sch.exclude))
    return PlanResult(plan=plan, assign=sch.assign, loads=sch.loads,
                      stats=_stats(sch.loads, sch.comm_bytes, sch.n_moves,
                                   sch.resident_bytes, allowed),
                      resident_bytes=sch.resident_bytes,
                      streamed=sch.streamed)
