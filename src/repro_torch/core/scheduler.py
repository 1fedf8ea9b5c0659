"""Communication-aware greedy CA-task scheduler (paper §4.2 + App. B).

The port's copy of ``repro.core.scheduler`` (numpy only); its trace and
metrics calls go to ``repro_torch.obs``.

Host-side, numpy.  Input: the packed batch's document layout (one packed
chunk per data rank; documents are 128-block aligned by the data pipeline
and never span ranks).  Output: an assignment of every 128-token q-block
to an attention server, which ``plan.build_plan`` turns into static-shape
dispatch arrays.

Algorithm (faithful to the paper):
  1. ideal per-server load  F̄ = Σ FLOPs / n_servers; servers split into
     surplus (> F̄) and deficit (< F̄); the worst deficit is served first.
  2. for each deficit destination: evaluate candidate Items (doc-shard
     ranges resident on surplus servers), ΔF_max = min(F_item, surplus,
     deficit); the shard moved is the Item's *latest* blocks (suffix) —
     under the causal mask these carry the most FLOPs per byte of kv
     prefix, the comm-minimal choice of App. B at block granularity;
     score E = ΔF_max / V_comm, pick the best candidate.
  3. stop when every load is within (1±ε)·F̄ or no move improves.

Heterogeneous pools and measured costs (DESIGN.md §3): ``speeds`` gives
per-server relative speed factors and ``cost_model`` a (runtime-
calibrated) latency model; balancing then runs in *time* units — each
server's load is its assigned cost divided by its speed, and the ideal
target is equal time, i.e. FLOPs proportional to speed (a 0.5x server
receives half the work).  With both left at their defaults the
arithmetic reduces exactly to the homogeneous relative-FLOPs balance.

Mask-structured tasks (DESIGN.md §12): an optional ``mask``
(:class:`~repro_torch.core.mask.MaskSpec`) reprices every q-block by its
*live* kv blocks (``live_block_table``) instead of its dense causal
prefix; the same greedy suffix loop then splits documents along the
mask structure — under a sliding window the deep-suffix blocks stop
dominating, under dilation only every ``rate``-th kv block is paid for
— so per-server *live-block time* balances rather than rectangle area.

Capacities (per-pair q/kv send slots, per-server kv buffer slots) mirror
the static shapes of the compiled dispatch; moves that would overflow a
capacity are rejected (TPU adaptation — see DESIGN.md §3).

Memory budgets (DESIGN.md §11): ``budgets`` gives each endpoint an HBM
budget in bytes and makes memory a second constraint next to time — a
destination is only eligible while its modeled resident working set
(q/o + residuals per held block, plus each needed doc kv prefix once)
stays within budget, and a post-balance repair phase moves doc-range
suffixes off servers born over budget by their own home layout.
Documents whose final task fits no endpoint (the kv prefix alone
overflows every budget) are marked ``streamed``: the dispatch layer
consumes their kv in ``stream_chunk``-block chunks, so their planned
kv residency is one chunk.  ``PlanMemoryError`` is raised only when no
feasible split exists.

Elastic pools (DESIGN.md §9): ``exclude`` names servers that must not
hold CA tasks this step — drained or dead members of an elastic pool.
Core attention is stateless, so excluding a server never loses data:
its *data-rank* half keeps holding (and sending) q/k/v shards; only its
attention-serving capacity is withdrawn.  Documents homed on an
excluded server are dealt whole to the least-loaded surviving server
first (whole docs keep the kv prefix send contiguous and cap-checked),
then the ordinary greedy loop balances among the survivors.  The
dispatch geometry — array shapes keyed by ``n_servers`` — never
changes, so one compiled executable serves every membership epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import CommModel, CostModel, MemoryModel
from repro_torch.core.mask import MaskSpec, live_block_mask, live_block_table
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class Doc:
    """A document in the packed global stream, 128-aligned, single-rank."""
    doc_id: int
    home: int            # rank holding it
    g0: int              # first global block index
    n_blocks: int

    def blocks(self):
        return range(self.g0, self.g0 + self.n_blocks)


@dataclasses.dataclass(frozen=True)
class Caps:
    cq: int              # q blocks per (src, dst) pair
    ckv: int             # kv blocks per (src, dst) pair
    nkv: int             # dense kv buffer blocks per server (incl. local)


@dataclasses.dataclass
class Schedule:
    """Scheduler output: per-block server assignment + stats.
    ``loads`` is per-server modeled *time*: assigned cost (relative
    FLOPs, or seconds under a calibrated cost model) divided by the
    server's speed factor — identical to relative FLOPs for the
    homogeneous default.  ``resident_bytes`` is per-server modeled HBM
    working set (DESIGN.md §11), populated whenever a memory model was
    in play; ``streamed`` names documents whose kv must be consumed in
    ``stream_chunk``-block chunks because their final task fits no
    single endpoint's budget."""
    assign: np.ndarray           # [G] server per global q-block
    docs: List[Doc]
    doc_of_block: np.ndarray     # [G] doc index (-1 = padding block)
    bi_of_block: np.ndarray      # [G] block-in-doc index
    n_servers: int
    nb: int                      # blocks per rank
    blk: int
    loads: np.ndarray            # [S] final per-server modeled time
    comm_bytes: float
    n_moves: int
    speeds: Optional[np.ndarray] = None   # [S] speed factors (None = 1)
    exclude: Tuple[int, ...] = ()         # servers barred from tasks
    resident_bytes: Optional[np.ndarray] = None  # [S] modeled HBM bytes
    budgets: Optional[np.ndarray] = None         # [S] HBM budgets, bytes
    streamed: Tuple[int, ...] = ()               # doc ids streaming kv


def layout_from_segments(segment_ids: np.ndarray, blk: int,
                         n_servers: int) -> Tuple[List[Doc], np.ndarray,
                                                  np.ndarray]:
    """Derive the Doc table from [R, L] per-rank packed segment ids.
    Blocks are document-pure by pipeline construction (trailing padding
    inside a doc's last block carries segment 0 and is handled by -1
    positions downstream)."""
    r, l = segment_ids.shape
    assert r == n_servers, (r, n_servers)
    assert l % blk == 0
    nb = l // blk
    seg_b = segment_ids.reshape(r, nb, blk)
    lead = seg_b[:, :, 0]
    docs: List[Doc] = []
    doc_of = -np.ones(r * nb, np.int64)
    bi_of = np.zeros(r * nb, np.int64)
    for rank in range(r):
        prev = None
        for i in range(nb):
            s = int(lead[rank, i])
            g = rank * nb + i
            if s == 0:
                prev = None
                continue
            nz = seg_b[rank, i][seg_b[rank, i] != 0]
            assert (nz == s).all(), \
                "blocks must be document-pure (pipeline aligns docs)"
            if prev != s:
                docs.append(Doc(len(docs), rank, g, 1))
                prev = s
            else:
                docs[-1].n_blocks += 1
            doc_of[g] = docs[-1].doc_id
            bi_of[g] = g - docs[-1].g0
    return docs, doc_of, bi_of


def block_costs(doc_of: np.ndarray, bi_of: np.ndarray, blk: int,
                cost_model: Optional[CostModel] = None,
                mask: Optional[MaskSpec] = None) -> np.ndarray:
    """Per-q-block CA cost for live blocks, 0 for padding.  Default:
    relative FLOPs ``live_blocks(bi)·blk²`` — for the dense-causal mask
    ``live_blocks(bi) == bi + 1`` and this reduces to the historic
    (bi+1)·blk².  A non-trivial ``mask`` prices the block by its *live*
    kv blocks only (DESIGN.md §12): a sliding-window or dilated task
    costs what its kernel actually iterates, not its rectangle area.
    With a (runtime-calibrated) ``cost_model``: predicted seconds for a
    blk-token shard against its live context.  The single cost formula
    shared by the scheduler and the plan-policy load accounting
    (repro_torch.cad.planner)."""
    live = doc_of >= 0
    max_blocks = int(bi_of[live].max()) + 1 if live.any() else 1
    tbl = live_block_table(mask, max_blocks, blk)   # live kv blocks per bi
    if cost_model is None:
        out = np.zeros(len(doc_of))
        out[live] = tbl[bi_of[live]] * float(blk * blk)
        return out
    out = np.zeros(len(doc_of))
    out[live] = cost_model.predict(blk, tbl[bi_of[live]] * blk)
    return out


def ring_shard_size(n_blocks: int, n_ring: int) -> int:
    """Contiguous kv-shard length (in blocks) of a DISTFLASHATTN-style
    ring split of an ``n_blocks``-long document over ``n_ring``
    endpoints: shard ``p`` covers in-doc blocks ``[p*L, (p+1)*L)``
    clipped to the document.  Shared by the ring planner
    (``repro_torch.cad.planner``), the ring pass geometry (``core.dispatch``)
    and :func:`ring_pass_costs` so all three agree on shard
    boundaries."""
    return -(-max(int(n_blocks), 1) // max(int(n_ring), 1))


def ring_pass_costs(docs: List[Doc], blk: int, n_servers: int, *,
                    servers: Optional[Iterable[int]] = None,
                    cost_model: Optional[CostModel] = None,
                    mask: Optional[MaskSpec] = None) -> np.ndarray:
    """Per-(ring pass, endpoint) modeled compute of the DISTFLASHATTN
    ring schedule (DESIGN.md §13): ``costs[t, s]`` is what endpoint
    ``s`` executes during synchronous ring pass ``t``.

    Each document is cut into ``P`` contiguous kv shards of
    :func:`~repro_torch.core.plan.ring_shard_size` blocks; a q block in shard
    ``i`` consumes kv shard ``(i - t) % P`` at pass ``t``.  Causal-dead
    and mask-dead (q block, kv shard) pairs cost zero — the pass is
    skipped exactly, mirroring ``dispatch.ring_pass_geometry`` — and
    live work is priced per live kv block like :func:`block_costs`, so
    ``costs.sum(0)`` equals the ring assignment's per-endpoint loads.

    Because the ring barriers between passes, the schedule's modeled
    step time is ``sum_t max_s costs[t, s] / speed[s]`` — the quantity
    ``benchmarks/cad_vs_ring.py`` compares against CAD's
    ``max_s sum_t`` (no inner barrier)."""
    allowed = tuple(range(n_servers)) if servers is None \
        else tuple(servers)
    P = len(allowed)
    costs = np.zeros((P, n_servers))
    for d in docs:
        n = d.n_blocks
        L = ring_shard_size(n, P)
        lbm = live_block_mask(mask, n, n, blk)          # [n, n] bool
        pad = P * L - n
        counts = np.pad(lbm, ((0, 0), (0, pad))) \
            .reshape(n, P, L).sum(-1)                   # [n, P] live blocks
        shard_q = np.arange(n) // L                     # q shard per row
        owner = np.asarray(allowed)[shard_q]            # endpoint per row
        for t in range(P):
            j = (shard_q - t) % P
            live = np.take_along_axis(counts, j[:, None], 1)[:, 0]
            if cost_model is None:
                c = live * float(blk * blk)
            else:
                c = np.where(live > 0,
                             cost_model.predict(blk, live * blk), 0.0)
            np.add.at(costs[t], owner, c)
    return costs


def _bi_cost_table(blk: int, max_blocks: int,
                   cost_model: Optional[CostModel],
                   mask: Optional[MaskSpec] = None) -> np.ndarray:
    """cost of block-in-doc index bi, for bi in [0, max_blocks)."""
    ctx = live_block_table(mask, max_blocks, blk)   # live kv blocks per bi
    if cost_model is None:
        return (ctx * (blk * blk)).astype(np.float64)
    return np.asarray(cost_model.predict(blk, ctx * blk), np.float64)


def check_exclude(exclude: Optional[Iterable[int]],
                  n_servers: int) -> Tuple[int, ...]:
    """Validate an excluded-server set; returns it sorted.  At least one
    server must survive — an empty pool cannot serve attention."""
    ex = tuple(sorted({int(s) for s in (exclude or ())}))
    for s in ex:
        if not 0 <= s < n_servers:
            raise ValueError(f"excluded server {s} outside pool of "
                             f"{n_servers}")
    if len(ex) >= n_servers:
        raise ValueError(
            f"cannot exclude all {n_servers} servers — the attention "
            f"pool needs at least one surviving endpoint")
    return ex


def streamed_doc_ids(docs: List[Doc], blk: int, mem: MemoryModel,
                     budgets: np.ndarray, *, stream_chunk: int,
                     allowed: Optional[Iterable[int]] = None,
                     mask: Optional[MaskSpec] = None) \
        -> Tuple[int, ...]:
    """Documents that must stream their kv: the doc's *final* task (one
    q block against the full causal prefix) overflows EVERY allowed
    endpoint's HBM budget, so no re-split can help — causal attention
    needs the whole prefix resident for that task unless it is consumed
    in chunks (DESIGN.md §11).  With streaming disabled such a doc is
    unplannable: :class:`~repro_torch.core.plan.PlanMemoryError` at planning
    time, not an OOM at step time.

    ``mask`` switches the final task's pricing to the ``live_kv_bytes``
    view (DESIGN.md §12) — the elastic pricing paths pass the session's
    MaskSpec here; planners keep the default dense-prefix ledger."""
    idx = list(range(len(budgets))) if allowed is None else list(allowed)
    cap = float(budgets[idx].max())
    cap_srv = int(idx[int(np.argmax(budgets[idx]))])
    out = []
    for d in docs:
        need = mem.task_bytes(blk, d.n_blocks * blk, mask, blk)
        if need > cap:
            if stream_chunk <= 0:
                # circular-safe
                from repro_torch.core.plan import PlanMemoryError
                raise PlanMemoryError(
                    cap_srv, need, cap,
                    detail=f"doc {d.doc_id} final task needs its full "
                           f"{d.n_blocks}-block kv prefix resident and "
                           f"streaming is off")
            out.append(d.doc_id)
    return tuple(out)


def assignment_resident_bytes(assign: np.ndarray, doc_of: np.ndarray,
                              bi_of: np.ndarray, blk: int, n_servers: int,
                              mem: MemoryModel, *,
                              streamed: Iterable[int] = (),
                              stream_chunk: int = 0,
                              mask: Optional[MaskSpec] = None) \
        -> np.ndarray:
    """Per-server modeled HBM working set of an assignment: every live
    q block contributes its q/o shard plus backward residuals, and each
    (server, doc) pair contributes the doc's needed kv prefix exactly
    once — the same deduplicated counting ``plan_from_assignment``'s
    kv-gather buffer realizes.  Streamed docs' kv residency is bounded
    by one ``stream_chunk`` of blocks.

    ``mask`` switches kv pricing to the ``live_kv_bytes`` view
    (DESIGN.md §12): planners leave it unset — the dense prefix remains
    the residency ledger's unit because the dispatch gather buffer
    realizes the contiguous range — while the elastic pricing paths
    (``executor._recovery_memory``) pass the session's MaskSpec so
    recovery destinations are weighed by live bandwidth (DESIGN.md §9).
    """
    streamed = set(streamed)
    res = np.zeros(n_servers)
    q_unit = mem.q_bytes(blk) + mem.residual_bytes(blk)
    needs: List[Dict[int, int]] = [dict() for _ in range(n_servers)]
    for g in np.nonzero(doc_of >= 0)[0]:
        s = int(assign[g])
        dc = int(doc_of[g])
        res[s] += q_unit
        needs[s][dc] = max(needs[s].get(dc, 0), int(bi_of[g]) + 1)
    for s in range(n_servers):
        for dc, pref in needs[s].items():
            if dc in streamed and stream_chunk > 0:
                pref = min(pref, stream_chunk)
            res[s] += mem.live_kv_bytes(pref * blk, mask, blk)
    return res


def schedule(segment_ids: np.ndarray, *, blk: int, n_servers: int,
             comm: CommModel, caps: Caps, tolerance: float = 0.1,
             max_moves: int = 100000,
             speeds: Optional[np.ndarray] = None,
             cost_model: Optional[CostModel] = None,
             exclude: Optional[Iterable[int]] = None,
             mem_model: Optional[MemoryModel] = None,
             budgets: Optional[np.ndarray] = None,
             stream_chunk: int = 0,
             mask: Optional[MaskSpec] = None) -> Schedule:
    docs, doc_of, bi_of = layout_from_segments(segment_ids, blk, n_servers)
    nb = segment_ids.shape[1] // blk
    G = n_servers * nb
    assign = (np.arange(G) // nb).astype(np.int64)     # home assignment

    exclude = check_exclude(exclude, n_servers)
    excluded = set(exclude)
    speeds = np.ones(n_servers) if speeds is None \
        else np.asarray(speeds, np.float64)
    if speeds.shape != (n_servers,):
        raise ValueError(f"speeds needs {n_servers} entries, got "
                         f"{speeds.shape}")
    if (speeds <= 0).any():
        raise ValueError(f"server speeds must be > 0, got {speeds}")
    cost_of = block_costs(doc_of, bi_of, blk, cost_model, mask)
    max_blocks = int(bi_of.max()) + 1 if len(bi_of) else 1
    bi_cost = _bi_cost_table(blk, max_blocks, cost_model, mask)
    bi_csum = np.concatenate([[0.0], np.cumsum(bi_cost)])

    def range_cost(lo: int, hi: int) -> float:
        """Sum of per-block CA cost over block-in-doc range [lo, hi)."""
        return float(bi_csum[hi] - bi_csum[lo])

    # loads are modeled *time*: assigned base cost / server speed.
    # Excluded servers contribute no capacity: the ideal per-server time
    # spreads the whole batch over the survivors' speeds only.
    allowed = [s for s in range(n_servers) if s not in excluded]
    loads_base = np.array([cost_of[s * nb:(s + 1) * nb].sum()
                           for s in range(n_servers)])
    loads = loads_base / speeds
    fbar = loads_base.sum() / speeds[allowed].sum()

    # items[s][doc_id] -> sorted list of disjoint (lo, hi) block ranges
    items: List[Dict[int, List[Tuple[int, int]]]] = \
        [dict() for _ in range(n_servers)]
    for d in docs:
        items[d.home][d.doc_id] = [(0, d.n_blocks)]
    # kv prefix length (blocks) already available on each server per doc
    sent_kv: List[Dict[int, int]] = [dict() for _ in range(n_servers)]
    q_used = np.zeros((n_servers, n_servers), np.int64)
    kv_used = np.zeros((n_servers, n_servers), np.int64)
    nkv_used = np.full(n_servers, nb, np.int64)        # local blocks

    comm_bytes = 0.0
    n_moves = 0

    # ---- memory constraint state (DESIGN.md §11).  ``resident`` and
    # ``kv_need`` mirror the assignment incrementally: per-server q/o +
    # residual bytes for every held block, plus each needed doc kv
    # prefix once (deduplicated — the same counting the kv-gather
    # buffer realizes).  Streamed docs' kv is clamped to one chunk.
    mem_on = budgets is not None
    mem = mem_model if mem_model is not None \
        else (MemoryModel(comm) if mem_on else None)
    if mem_on:
        budgets = np.asarray(budgets, np.float64)
        if budgets.shape != (n_servers,):
            raise ValueError(f"budgets needs {n_servers} entries, got "
                             f"{budgets.shape}")
        if not (budgets > 0).all():
            bad = int(np.argmin(budgets > 0))
            raise ValueError(f"budgets[{bad}] must be > 0, got "
                             f"{budgets[bad]} for endpoint {bad}")
    streamed: set = set(streamed_doc_ids(
        docs, blk, mem, budgets, stream_chunk=stream_chunk,
        allowed=allowed)) if mem_on else set()
    q_unit = (mem.q_bytes(blk) + mem.residual_bytes(blk)) if mem else 0.0
    kv_unit = mem.kv_bytes(blk) if mem else 0.0

    def kv_clamp(dc: int, pref: int) -> int:
        if dc in streamed and stream_chunk > 0:
            return min(pref, stream_chunk)
        return pref

    resident = np.zeros(n_servers)
    kv_need: List[Dict[int, int]] = [dict() for _ in range(n_servers)]
    if mem is not None:
        for d in docs:
            resident[d.home] += d.n_blocks * q_unit \
                + kv_clamp(d.doc_id, d.n_blocks) * kv_unit
            kv_need[d.home][d.doc_id] = d.n_blocks

    def mem_delta_dst(dst: int, dc: int, hi: int, n_q: int) -> float:
        """Resident bytes dst gains when n_q blocks of doc dc (prefix
        end hi) land on it."""
        old = kv_need[dst].get(dc, 0)
        return n_q * q_unit \
            + (kv_clamp(dc, max(old, hi)) - kv_clamp(dc, old)) * kv_unit

    def mem_fits(dst: int, dc: int, hi: int, n_q: int) -> bool:
        return not mem_on or resident[dst] \
            + mem_delta_dst(dst, dc, hi, n_q) <= budgets[dst]

    def mem_move(src: int, dst: int, dc: int, hi: int, n_q: int) -> None:
        """Memory bookkeeping for a src->dst move; call AFTER
        ``items[src]`` was updated (the remaining ranges determine the
        source's surviving kv need)."""
        if mem is None:
            return
        resident[dst] += mem_delta_dst(dst, dc, hi, n_q)
        kv_need[dst][dc] = max(kv_need[dst].get(dc, 0), hi)
        old_s = kv_need[src].pop(dc, 0)
        rng = items[src].get(dc)
        new_s = rng[-1][1] if rng else 0
        if rng:
            kv_need[src][dc] = new_s
        resident[src] -= n_q * q_unit \
            + (kv_clamp(dc, old_s) - kv_clamp(dc, new_s)) * kv_unit

    if excluded:
        from repro_torch.core.plan import PlanCapacityError  # circular-safe

        def _deal_fit(home: int, dst: int, n_bl: int):
            """None when the whole doc fits on dst, else the failing
            (capacity, needed, available) triple."""
            if q_used[home, dst] + n_bl > caps.cq:
                return "CQ", int(q_used[home, dst]) + n_bl, caps.cq
            if kv_used[home, dst] + n_bl > caps.ckv:
                return "CKV", int(kv_used[home, dst]) + n_bl, caps.ckv
            if nkv_used[dst] + n_bl > caps.nkv:
                return "NKV", int(nkv_used[dst]) + n_bl, caps.nkv
            return None

        # Evacuation: docs homed on excluded servers are dealt whole to
        # the least-loaded survivor with capacity (whole docs keep each
        # kv prefix send a single contiguous range); the greedy loop
        # below then rebalances among survivors as usual.
        for d in docs:
            if d.home not in excluded:
                continue
            n_bl = d.n_blocks
            cand = sorted(allowed, key=lambda s: (loads[s], s))
            cap_ok = [s for s in cand
                      if _deal_fit(d.home, s, n_bl) is None]
            if not cap_ok:
                cap, needed, avail = _deal_fit(d.home, cand[0], n_bl)
                raise PlanCapacityError(cap, d.home, cand[0], needed,
                                        avail)
            dst = next((s for s in cap_ok
                        if mem_fits(s, d.doc_id, n_bl, n_bl)), None)
            if dst is None:
                from repro_torch.core.plan import PlanMemoryError
                s0 = cap_ok[0]
                raise PlanMemoryError(
                    s0, resident[s0] + mem_delta_dst(s0, d.doc_id, n_bl,
                                                     n_bl),
                    float(budgets[s0]),
                    detail=f"evacuating doc {d.doc_id} whole from "
                           f"excluded server {d.home}")
            df = range_cost(0, n_bl)
            del items[d.home][d.doc_id]
            items[dst][d.doc_id] = [(0, n_bl)]
            assign[d.g0:d.g0 + n_bl] = dst
            loads[d.home] -= df / speeds[d.home]
            loads[dst] += df / speeds[dst]
            q_used[d.home, dst] += n_bl
            kv_used[d.home, dst] += n_bl
            nkv_used[dst] += n_bl
            sent_kv[dst][d.doc_id] = n_bl
            mem_move(d.home, dst, d.doc_id, n_bl, n_bl)
            comm_bytes += comm.migration_bytes(n_bl * blk, n_bl * blk)
            n_moves += 1
        loads[list(excluded)] = 0.0      # evacuated exactly

    def suffix_take(lo: int, hi: int, budget: float) -> int:
        """Largest t in [lo, hi) such that cost of [t, hi) <= budget, but
        always at least one block if a single block fits 1.5x the budget
        (avoids stalling on coarse granularity).  ``budget`` is in base
        cost units (the destination's time budget times its speed)."""
        t = hi
        acc = 0.0
        while t > lo:
            c = float(bi_cost[t - 1])         # cost of block (t-1)
            if acc + c > budget:
                break
            acc += c
            t -= 1
        if t == hi and hi - lo >= 1:
            c = float(bi_cost[hi - 1])
            if c <= 1.5 * budget:
                t = hi - 1
        return t

    while n_moves < max_moves:
        order = np.argsort(loads)
        # destination: the least-loaded *surviving* server (an excluded
        # server sits at load 0 but must never receive tasks)
        dst = next(int(s) for s in order if int(s) not in excluded)
        deficit = fbar - loads[dst]
        if deficit <= tolerance * fbar:
            break
        best = None  # (E, src, doc_id, ridx, t, hi, dF, vbytes, need_kv)
        for src in order[::-1]:
            src = int(src)
            surplus = loads[src] - fbar
            if surplus <= 0:
                break
            if src == dst:
                continue
            # time budgets converted to base cost units per endpoint
            budget = min(surplus * speeds[src], deficit * speeds[dst])
            for doc_id, ranges in items[src].items():
                d = docs[doc_id]
                # only the latest range's suffix migrates (comm-minimal)
                for ridx in range(len(ranges) - 1, -1, -1):
                    lo, hi = ranges[ridx]
                    t = suffix_take(lo, hi, budget)
                    if t >= hi:
                        continue
                    n_q = hi - t
                    if q_used[d.home, dst] + n_q > caps.cq:
                        continue
                    if d.home == dst:
                        need_kv = 0
                    else:
                        have = sent_kv[dst].get(doc_id, 0)
                        need_kv = max(0, hi - have)
                        if kv_used[d.home, dst] + need_kv > caps.ckv:
                            continue
                        if nkv_used[dst] + need_kv > caps.nkv:
                            continue
                    if not mem_fits(dst, doc_id, hi, n_q):
                        continue
                    df = range_cost(t, hi)
                    vbytes = comm.migration_bytes(n_q * blk, need_kv * blk)
                    # time gained by the deficit server per byte moved
                    e_score = df / speeds[dst] / max(vbytes, 1.0)
                    if best is None or e_score > best[0]:
                        best = (e_score, src, doc_id, ridx, t, hi, df,
                                vbytes, need_kv)
                    break    # deeper ranges cost strictly more comm
        if best is None:
            break
        _, src, doc_id, ridx, t, hi, df, vbytes, need_kv = best
        d = docs[doc_id]
        ranges = items[src][doc_id]
        lo, _hi = ranges[ridx]
        assert _hi == hi
        if t == lo:
            ranges.pop(ridx)
            if not ranges:
                del items[src][doc_id]
        else:
            ranges[ridx] = (lo, t)
        # insert into dst with adjacency merge
        dst_ranges = items[dst].setdefault(doc_id, [])
        dst_ranges.append((t, hi))
        dst_ranges.sort()
        merged = [dst_ranges[0]]
        for a, b in dst_ranges[1:]:
            if a == merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
        items[dst][doc_id] = merged

        assign[d.g0 + t: d.g0 + hi] = dst
        loads[src] -= df / speeds[src]
        loads[dst] += df / speeds[dst]
        q_used[d.home, dst] += hi - t
        if d.home != dst:
            kv_used[d.home, dst] += need_kv
            nkv_used[dst] += need_kv
            sent_kv[dst][doc_id] = max(sent_kv[dst].get(doc_id, 0), hi)
        mem_move(src, dst, doc_id, hi, hi - t)
        comm_bytes += vbytes
        n_moves += 1

    # ---- memory repair (DESIGN.md §11).  Time balancing never ADDS
    # bytes past a destination's budget (mem_fits above), but servers
    # can be born over budget by their own home layout.  Repair moves
    # doc-range suffixes off over-budget servers to the least-loaded
    # destination with room — the deepest-prefix doc first, since its
    # kv dominates the working set.  Every move is capacity-checked
    # like any other; when no move exists, no feasible split does.
    if mem_on:
        from repro_torch.core.plan import PlanMemoryError  # circular-safe

        while n_moves < max_moves:
            over = [s for s in allowed if resident[s] > budgets[s]]
            if not over:
                break
            s = max(over, key=lambda x: (resident[x] - budgets[x], -x))
            move = None   # (dst, doc_id, ridx, t, hi, need_kv)
            by_depth = sorted(items[s].items(),
                              key=lambda kv: (-kv_need[s][kv[0]], kv[0]))
            for doc_id, ranges in by_depth:
                d = docs[doc_id]
                ridx = len(ranges) - 1
                lo, hi = ranges[ridx]
                for dst in sorted(allowed, key=lambda x: (loads[x], x)):
                    if dst == s:
                        continue
                    # capacity ceiling on the suffix length
                    take = min(hi - lo, caps.cq - int(q_used[d.home,
                                                             dst]))
                    if take <= 0:
                        continue
                    if dst == d.home:
                        need_kv = 0
                    else:
                        need_kv = max(0, hi - sent_kv[dst].get(doc_id, 0))
                        if kv_used[d.home, dst] + need_kv > caps.ckv:
                            continue
                        if nkv_used[dst] + need_kv > caps.nkv:
                            continue
                    # budget ceiling: dst pays the full hi-prefix kv
                    # (causal duplication) plus q/o bytes per block
                    head = budgets[dst] - resident[dst] \
                        - mem_delta_dst(dst, doc_id, hi, 0)
                    if q_unit > 0:
                        take = min(take, int(head // q_unit))
                    elif head < 0:
                        continue
                    if take <= 0:
                        continue
                    move = (dst, doc_id, ridx, max(lo, hi - take), hi,
                            need_kv)
                    break
                if move is not None:
                    break
            if move is None:
                raise PlanMemoryError(
                    s, float(resident[s]), float(budgets[s]),
                    detail=f"{len(items[s])} docs resident after "
                           f"{n_moves} moves; no destination has room")
            dst, doc_id, ridx, t, hi, need_kv = move
            d = docs[doc_id]
            ranges = items[s][doc_id]
            lo, _hi = ranges[ridx]
            if t == lo:
                ranges.pop(ridx)
                if not ranges:
                    del items[s][doc_id]
            else:
                ranges[ridx] = (lo, t)
            dst_ranges = items[dst].setdefault(doc_id, [])
            dst_ranges.append((t, hi))
            dst_ranges.sort()
            merged = [dst_ranges[0]]
            for a, b in dst_ranges[1:]:
                if a == merged[-1][1]:
                    merged[-1] = (merged[-1][0], b)
                else:
                    merged.append((a, b))
            items[dst][doc_id] = merged
            assign[d.g0 + t: d.g0 + hi] = dst
            df = range_cost(t, hi)
            loads[s] -= df / speeds[s]
            loads[dst] += df / speeds[dst]
            q_used[d.home, dst] += hi - t
            if d.home != dst:
                kv_used[d.home, dst] += need_kv
                nkv_used[dst] += need_kv
                sent_kv[dst][doc_id] = max(sent_kv[dst].get(doc_id, 0),
                                           hi)
            mem_move(s, dst, doc_id, hi, hi - t)
            comm_bytes += comm.migration_bytes((hi - t) * blk,
                                               need_kv * blk)
            n_moves += 1

    final_resident = None
    if mem is not None:
        # authoritative recompute from the final assignment — the same
        # helper tests and planners use, so the reported working set can
        # never drift from the incremental bookkeeping above
        final_resident = assignment_resident_bytes(
            assign, doc_of, bi_of, blk, n_servers, mem,
            streamed=streamed, stream_chunk=stream_chunk)
    # narrate the schedule-time prediction (DESIGN.md §14): the
    # imbalance gauge is the planner's own claim about the step it just
    # built — trace_report compares it against measured serve times
    obs_metrics.get_registry().gauge(
        "cad_schedule_imbalance",
        "scheduled per-server load max/mean - 1 (straggler "
        "overhang)").set(imbalance(loads))
    return Schedule(assign=assign, docs=docs, doc_of_block=doc_of,
                    bi_of_block=bi_of, n_servers=n_servers, nb=nb, blk=blk,
                    loads=loads, comm_bytes=comm_bytes, n_moves=n_moves,
                    speeds=speeds, exclude=exclude,
                    resident_bytes=final_resident, budgets=budgets,
                    streamed=tuple(sorted(streamed)))


def imbalance(loads: np.ndarray) -> float:
    """max/mean - 1 (the straggler overhang)."""
    m = loads.mean()
    return float(loads.max() / max(m, 1e-9) - 1.0)
