"""Static-shape dispatch plans.

The port's copy of ``repro.core.plan``.  A :class:`StepPlan` holds int32
arrays — *data*, not shapes — so one dispatch code path serves every
step's schedule (DESIGN.md §3).  The reference registers the plan
dataclasses as JAX pytrees; here they are plain dataclasses of host
numpy arrays, and ``to(device)`` makes the int32 tensors the dispatch
reads, once per step.  Layout per rank r (leading axis D):

  q_home_idx   [D, NB]        local q-block ids this rank serves itself
  q_send_idx   [D, D, CQ]     [src, dst] local q-block ids sent src->dst
  kv_send_idx  [D, D, CKV]    [src, dst] local kv-block ids sent src->dst
  kv_gather    [D, NKV]       [server] dense kv buffer: index into the
                              concat(local NB blocks, recv D*CKV slots)
  task_kv_start[D, T]         [server] per task slot: first kv buffer blk
  task_kv_len  [D, T]         [server] blocks of context (0 = empty slot)

Task slots: t in [0, NB) are home tasks (aligned with q_home_idx);
t in [NB + r*CQ + c] is the task received from rank r slot c (aligned with
q_send_idx[r, server, c]).  T = NB + D*CQ.  All pads are -1 (idx) / 0
(len).

Plan builders:
  identity_plan          — every block served at home (baseline; equals
                           plain per-rank attention when docs don't span
                           ranks)
  per_document_cp_plan   — head-tail per-document context parallelism
                           (§2.2) expressed as a CAD plan: the paper's
                           framing of CP as a special case
  plan_from_schedule     — the scheduler's balanced assignment
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import (Caps, Doc, Schedule,
                                        layout_from_segments,
                                        ring_shard_size)

PLAN_FIELDS = ("q_home_idx", "q_send_idx", "kv_send_idx", "kv_gather",
               "task_kv_start", "task_kv_len")


class PlanMemoryError(RuntimeError):
    """No feasible split fits every endpoint's HBM budget.

    Sibling of :class:`PlanCapacityError`, but for the *memory*
    constraint (DESIGN.md §11): raised only after the planner has
    exhausted re-splitting (and, when enabled, chunked KV streaming) —
    some server's resident bytes necessarily exceed its budget.
    """

    def __init__(self, server: int, resident_bytes: float,
                 budget_bytes: float, detail: str = ""):
        self.server = server
        self.resident_bytes = float(resident_bytes)
        self.budget_bytes = float(budget_bytes)
        extra = f" ({detail})" if detail else ""
        super().__init__(
            f"no feasible split: endpoint {server} needs "
            f"{self.resident_bytes:.4g} resident bytes, HBM budget is "
            f"{self.budget_bytes:.4g}{extra} — raise CADConfig."
            f"server_hbm, enable/shrink stream_chunk, or add servers")


class PlanCapacityError(RuntimeError):
    """A plan build exceeded a static dispatch capacity.

    The compiled dispatch has fixed shapes (CQ/CKV per (src, dst) pair,
    NKV kv-buffer slots per server); an assignment that needs more slots
    cannot be expressed.  Unlike a bare ``assert`` this survives
    ``python -O`` and reports which capacity broke and by how much.
    """

    def __init__(self, capacity: str, src: int, dst: int, needed: int,
                 available: int):
        self.capacity = capacity
        self.src = src
        self.dst = dst
        self.needed = needed
        self.available = available
        super().__init__(
            f"{capacity} capacity exceeded on (src={src}, dst={dst}): "
            f"needed {needed} block slots, only {available} available "
            f"(raise CADConfig.{capacity.lower()} or loosen the schedule)")


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One step's dispatch plan.

    Field layouts are documented in the module docstring above; fields
    are int32 numpy arrays on the host, or int32 tensors after
    :meth:`to`.  ``StepPlan`` supports ``plan["q_send_idx"]``-style
    access so dispatch helpers work identically on dict plans and typed
    plans.
    """
    q_home_idx: Any
    q_send_idx: Any
    kv_send_idx: Any
    kv_gather: Any
    task_kv_start: Any
    task_kv_len: Any

    def __getitem__(self, key: str):
        if key not in PLAN_FIELDS:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in PLAN_FIELDS

    def __iter__(self) -> Iterator[str]:
        return iter(PLAN_FIELDS)

    def keys(self) -> Tuple[str, ...]:
        return PLAN_FIELDS

    def items(self) -> Iterator[Tuple[str, Any]]:
        return ((k, getattr(self, k)) for k in PLAN_FIELDS)

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in PLAN_FIELDS}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StepPlan":
        return cls(**{k: d[k] for k in PLAN_FIELDS})

    def to(self, device) -> "StepPlan":
        """The plan as int32 tensors on ``device`` (one copy per field)."""
        return StepPlan(**{k: torch.as_tensor(np.asarray(v, np.int32),
                                              device=device)
                           for k, v in self.items()})


@dataclasses.dataclass(frozen=True)
class PingPongPlan:
    """The two nano-batch plans of a ping-pong step (paper §4.1) — a
    first-class pair rather than a tuple convention."""
    ping: StepPlan
    pong: StepPlan

    def __iter__(self):
        return iter((self.ping, self.pong))

    def __getitem__(self, i: int):
        return (self.ping, self.pong)[i]

    def to(self, device) -> "PingPongPlan":
        return PingPongPlan(self.ping.to(device), self.pong.to(device))


def _validated_per_server(name: str, values, n_servers: int) \
        -> Tuple[float, ...]:
    """Validate a per-server float list (speeds, HBM budgets): right
    length, every entry > 0.  Errors name the endpoint index AND the
    offending value — with dozens of pool members, "must be > 0, got
    <whole tuple>" is not actionable."""
    vals = tuple(float(v) for v in values)
    if len(vals) != n_servers:
        raise ValueError(
            f"{name} needs {n_servers} entries, got {len(vals)}")
    for i, v in enumerate(vals):
        if not v > 0:             # also catches NaN
            raise ValueError(
                f"{name}[{i}] must be > 0, got {v} for endpoint {i}")
    return vals


@dataclasses.dataclass(frozen=True)
class CADConfig:
    """Attention-server pool description: geometry (static dispatch
    capacities) plus per-server compute capacity.  ``server_speeds``
    holds relative speed factors — a 0.5 entry is a half-speed server
    that should receive half the FLOPs; ``None`` means a homogeneous
    pool.  Speeds only steer host-side planning (load targets are
    proportional to speed); the dispatch arrays and compiled shapes are
    speed-independent.

    ``server_hbm`` gives each endpoint an HBM budget in bytes
    (DESIGN.md §11); ``None`` means unconstrained.  Budgets, like
    speeds, steer planning only — the planners reject or re-split
    assignments whose modeled resident bytes exceed a budget.
    ``stream_chunk`` (kv blocks, 0 = off) enables chunked KV streaming
    for tasks whose context cannot fit any single endpoint's budget:
    the server consumes the kv range chunk by chunk with a running
    (out, lse) accumulation, bounding kv residency by one chunk."""
    n_servers: int
    blk: int
    nb: int               # q/kv blocks per rank
    cq: int
    ckv: int
    nkv: int
    server_speeds: Optional[Tuple[float, ...]] = None
    server_hbm: Optional[Tuple[float, ...]] = None   # bytes per endpoint
    stream_chunk: int = 0                            # kv blocks (0 = off)

    def __post_init__(self):
        if self.server_speeds is not None:
            object.__setattr__(self, "server_speeds", _validated_per_server(
                "server_speeds", self.server_speeds, self.n_servers))
        if self.server_hbm is not None:
            object.__setattr__(self, "server_hbm", _validated_per_server(
                "server_hbm", self.server_hbm, self.n_servers))
        if self.stream_chunk < 0:
            raise ValueError(
                f"stream_chunk is a kv-block count, must be >= 0, got "
                f"{self.stream_chunk}")

    @property
    def n_tasks(self) -> int:
        return self.nb + self.n_servers * self.cq

    def caps(self) -> Caps:
        return Caps(cq=self.cq, ckv=self.ckv, nkv=self.nkv)

    def speeds(self) -> np.ndarray:
        """Per-server speed factors as an array (1.0 = homogeneous)."""
        if self.server_speeds is None:
            return np.ones(self.n_servers)
        return np.asarray(self.server_speeds, np.float64)

    def budgets(self) -> Optional[np.ndarray]:
        """Per-endpoint HBM budgets in bytes; None = unconstrained."""
        if self.server_hbm is None:
            return None
        return np.asarray(self.server_hbm, np.float64)

    @classmethod
    def default(cls, n_servers: int, tokens_per_rank: int, blk: int = 128,
                max_doc_tokens: int = 0, server_speeds=None,
                server_hbm=None, stream_chunk: int = 0):
        """Per-pair capacities must cover a full document's kv prefix
        (its blocks live on one home rank): ckv >= max_doc_blocks, else
        the scheduler cannot offload long-document tails — the exact case
        CAD exists for (EXPERIMENTS.md §Perf P10)."""
        nb = tokens_per_rank // blk
        per = max(1, -(-nb // n_servers))
        mdb = min(nb, max(1, (max_doc_tokens or tokens_per_rank) // blk))
        cq = max(2 * per, mdb)
        ckv = max(2 * per, mdb)
        nkv = nb + min(n_servers * ckv, 4 * nb)
        return cls(n_servers=n_servers, blk=blk, nb=nb, cq=cq, ckv=ckv,
                   nkv=nkv,
                   server_speeds=None if server_speeds is None
                   else tuple(server_speeds),
                   server_hbm=None if server_hbm is None
                   else tuple(server_hbm),
                   stream_chunk=int(stream_chunk))


def empty_plan(cfg: CADConfig) -> Dict[str, np.ndarray]:
    d, nb = cfg.n_servers, cfg.nb
    return {
        "q_home_idx": -np.ones((d, nb), np.int32),
        "q_send_idx": -np.ones((d, d, cfg.cq), np.int32),
        "kv_send_idx": -np.ones((d, d, cfg.ckv), np.int32),
        "kv_gather": -np.ones((d, cfg.nkv), np.int32),
        "task_kv_start": np.zeros((d, cfg.n_tasks), np.int32),
        "task_kv_len": np.zeros((d, cfg.n_tasks), np.int32),
    }


def plan_from_assignment(cfg: CADConfig, assign: np.ndarray,
                         doc_of: np.ndarray, bi_of: np.ndarray,
                         docs) -> StepPlan:
    """Build the dispatch arrays from a per-block server assignment.

    Raises :class:`PlanCapacityError` when the assignment needs more
    send/buffer slots than the static shapes provide."""
    d, nb = cfg.n_servers, cfg.nb
    plan = empty_plan(cfg)
    q_cnt = np.zeros((d, d), np.int64)

    # ---- q routing + per-server doc needs
    # needs[s][doc_id] = max prefix blocks required on server s
    needs = [dict() for _ in range(d)]
    # remote task bookkeeping: for each (g) served remotely remember its
    # send slot (src rank, c) so task metadata lands in the right slot.
    task_slot_of_g = {}
    for g in range(d * nb):
        dc = int(doc_of[g])
        if dc < 0:
            continue
        s = int(assign[g])
        home = g // nb
        bi = int(bi_of[g])
        needs[s][dc] = max(needs[s].get(dc, 0), bi + 1)
        if s == home:
            # home task slot == local block index (stable, simple)
            plan["q_home_idx"][home, g % nb] = g % nb
            task_slot_of_g[g] = (s, g % nb)
        else:
            c = q_cnt[home, s]
            if c >= cfg.cq:
                raise PlanCapacityError("CQ", home, s, int(c) + 1, cfg.cq)
            plan["q_send_idx"][home, s, c] = g % nb
            q_cnt[home, s] = c + 1
            task_slot_of_g[g] = (s, nb + home * cfg.cq + c)

    # ---- kv routing + dense buffer per server
    kv_cnt = np.zeros((d, d), np.int64)
    for s in range(d):
        # needed global kv blocks, sorted: prefix ranges of each doc
        needed = []
        for dc, pref in needs[s].items():
            g0 = docs[dc].g0
            needed.extend(range(g0, g0 + pref))
        needed = sorted(set(needed))
        if len(needed) > cfg.nkv:
            raise PlanCapacityError("NKV", s, s, len(needed), cfg.nkv)
        # source slot for each needed block
        buf_pos_of_g = {}
        for pos, g in enumerate(needed):
            src = g // nb
            if src == s:
                slot = g % nb                       # local
            else:
                c = kv_cnt[src, s]
                if c >= cfg.ckv:
                    raise PlanCapacityError("CKV", src, s, int(c) + 1,
                                            cfg.ckv)
                plan["kv_send_idx"][src, s, c] = g % nb
                kv_cnt[src, s] = c + 1
                slot = nb + src * cfg.ckv + c       # recv layout
            plan["kv_gather"][s, pos] = slot
            buf_pos_of_g[g] = pos

        # ---- per-task metadata
        for dc, pref in needs[s].items():
            g0 = docs[dc].g0
            start = buf_pos_of_g[g0]
            # contiguity invariant: prefix occupies consecutive buffer slots
            assert buf_pos_of_g[g0 + pref - 1] == start + pref - 1
            for g in range(g0, g0 + docs[dc].n_blocks):
                if int(assign[g]) != s or int(doc_of[g]) != dc:
                    continue
                srv, slot = task_slot_of_g[g]
                assert srv == s
                bi = int(bi_of[g])
                plan["task_kv_start"][s, slot] = start
                plan["task_kv_len"][s, slot] = bi + 1
    return StepPlan.from_dict(plan)


def identity_assignment(cfg: CADConfig) -> np.ndarray:
    """Every block served at its home rank."""
    return (np.arange(cfg.n_servers * cfg.nb) // cfg.nb).astype(np.int64)


def head_tail_assignment(cfg: CADConfig, docs,
                         servers: Optional[Tuple[int, ...]] = None) \
        -> np.ndarray:
    """Head-tail per-document CP (paper §2.2): each doc's blocks are dealt
    to servers in the 0,1,...,D-1,D-1,...,1,0 pairing order.  ``servers``
    restricts the deal to a surviving subset of the pool (elastic
    membership, DESIGN.md §9); the default is the full pool."""
    srv = list(range(cfg.n_servers)) if servers is None else list(servers)
    assign = identity_assignment(cfg)
    ht = srv + srv[::-1]                               # head-tail order
    for doc in docs:
        for j, g in enumerate(doc.blocks()):
            assign[g] = ht[j % len(ht)]
    return assign


def ring_assignment(cfg: CADConfig, docs,
                    servers: Optional[Tuple[int, ...]] = None) \
        -> np.ndarray:
    """Ring / context-parallel sharding (DISTFLASHATTN baseline,
    DESIGN.md §13): each document's blocks are cut into contiguous
    shards of :func:`ring_shard_size` blocks and shard ``p`` is owned by
    the ``p``-th allowed server — endpoint ``p`` holds the ``p``-th kv
    shard of *every* document, the classic sequence-contiguous CP
    layout.  Under causal attention the tail shards see quadratically
    more context than the head shards, which is exactly the imbalance
    ``benchmarks/cad_vs_ring.py`` quantifies CAD's planners against.
    ``servers`` restricts the deal to a surviving subset of the pool."""
    srv = list(range(cfg.n_servers)) if servers is None else list(servers)
    assign = identity_assignment(cfg)
    for doc in docs:
        L = ring_shard_size(doc.n_blocks, len(srv))
        for j, g in enumerate(doc.blocks()):
            assign[g] = srv[j // L]
    return assign


def identity_plan(cfg: CADConfig, segment_ids: np.ndarray) -> StepPlan:
    docs, doc_of, bi_of = layout_from_segments(segment_ids, cfg.blk,
                                               cfg.n_servers)
    return plan_from_assignment(cfg, identity_assignment(cfg), doc_of,
                                bi_of, docs)


def per_document_cp_plan(cfg: CADConfig, segment_ids: np.ndarray) \
        -> StepPlan:
    docs, doc_of, bi_of = layout_from_segments(segment_ids, cfg.blk,
                                               cfg.n_servers)
    return plan_from_assignment(cfg, head_tail_assignment(cfg, docs),
                                doc_of, bi_of, docs)


def plan_from_schedule(cfg: CADConfig, sched: Schedule) -> StepPlan:
    return plan_from_assignment(cfg, sched.assign, sched.doc_of_block,
                                sched.bi_of_block, sched.docs)
