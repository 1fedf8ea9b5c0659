"""Continuous-batching scheduler for the serving engine (DESIGN.md §8).

Host-side, numpy — the serving analogue of the CAD training scheduler
(``core/scheduler.py``): where training balances CA-task FLOPs across a
fixed attention-server pool, serving balances *requests* across a fixed
pool of cache slots, between decode steps, under capacity bounds that
mirror the compiled step's static shapes.

Three mechanisms:

  admission  — WAITING requests claim free slots while the projected kv
               footprint stays under ``token_budget`` and (optionally)
               the predicted per-step core-attention time stays under
               ``step_cost_budget``, scored with the same
               ``core.cost_model.CostModel`` the CAD planner uses.
               Policy "fcfs" admits in arrival order (head-of-line
               blocking keeps ordering deterministic); "cost" admits
               cheapest-predicted-first — the planner's balance logic
               repurposed for serving.
  prefill    — prompts stream through fixed-size chunks: each chunk packs
               pieces of the active prefilling prompts cu_seqlens-style,
               every piece aligned to the 128-token kernel block so q
               blocks stay request-pure (the invariant
               ``ragged_decode_attention`` relies on, exactly like the
               training packer's document-pure blocks).  ``fused=False``
               degrades to one-token-per-request decode-mode chunks (the
               per-token path for recurrent/MoE archs — and the
               benchmark baseline).
  eviction   — when live requests outgrow the token budget (decode
               lengthens kv every step), the most recently admitted
               request is preempted LIFO, its progress discarded, and it
               is requeued at the *front* of the waiting queue
               (vLLM-style recompute preemption).

The scheduler owns all request state; the engine owns device state and
calls ``admit -> next_prefill_chunk -> commit_prefill`` /
``decode_batch -> commit_decode`` in a loop.  ``trace`` logs
(event, rid) pairs for every admit/finish/evict — the ordering contract
the tests pin down.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import CalibrationSnapshot, CostModel
from repro_torch.data.packing import BLOCK
from repro_torch.obs import metrics as obs_metrics

WAITING, PREFILL, DECODE, DONE = "waiting", "prefill", "decode", "done"


@dataclasses.dataclass
class Request:
    """One generation request plus its scheduler-owned runtime state."""
    rid: int
    prompt: np.ndarray                 # [P] int32
    max_new_tokens: int = 32
    # runtime
    state: str = WAITING
    slot: int = -1
    n_prefilled: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    n_evictions: int = 0
    admit_seq: int = -1                # monotone admission stamp (LIFO key)

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def total_len(self) -> int:
        """Upper bound on this request's kv footprint."""
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class PrefillChunk:
    """Device-ready arrays for one ``serve_chunk_step`` call."""
    tokens: np.ndarray                 # [T] int32 (0 on padding rows)
    pos: np.ndarray                    # [T] int32 (-1 on padding rows)
    block_req: np.ndarray              # [nq] int32 (-1 = dead block)
    kv_len_next: np.ndarray            # [n_slots] int32
    last_rows: List[Tuple[int, int]]   # (slot, row of last prompt token)
                                       # for requests finishing prefill


@dataclasses.dataclass
class SchedulerConfig:
    n_slots: int
    max_seq: int
    chunk_tokens: int = 512
    token_budget: Optional[int] = None   # cap on Σ projected kv tokens
    admission: str = "fcfs"              # "fcfs" | "cost"
    cost_model: Optional[CostModel] = None
    # live pricing: pulled once per admission round, so admission prices
    # with the same calibrated snapshot the CAD planner plans from
    # (instead of a static cost_model that ignores a live calibrator)
    snapshot_provider: \
        Optional[Callable[[], CalibrationSnapshot]] = None
    step_cost_budget: float = 0.0        # seconds of predicted CA per
                                         # decode step; 0 disables
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.chunk_tokens % BLOCK != 0:
            raise ValueError(
                f"chunk_tokens {self.chunk_tokens} must be a multiple "
                f"of {BLOCK}")
        if self.token_budget is None:
            self.token_budget = self.n_slots * self.max_seq
        if self.admission not in ("fcfs", "cost"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if (self.admission == "cost" or self.step_cost_budget) \
                and self.cost_model is None \
                and self.snapshot_provider is None:
            raise ValueError("cost-based admission needs a cost_model "
                             "or a snapshot_provider")


class ContinuousScheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}          # slot -> request
        self.kv_len = np.zeros(cfg.n_slots, np.int32)
        self.free = list(range(cfg.n_slots))          # kept sorted
        self.done: List[Request] = []
        self.trace: List[Tuple[str, int]] = []
        self._admit_counter = 0
        self._round_cm = cfg.cost_model
        self.last_calib_version = -1      # snapshot version priced with

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        if req.prompt_len == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.total_len > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+new {req.total_len} exceeds "
                f"max_seq {self.cfg.max_seq}")
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def has_prefill(self) -> bool:
        return any(r.state == PREFILL for r in self.active.values())

    # ------------------------------------------------------------ budgets
    def _live_tokens(self) -> int:
        """Committed kv footprint: an admitted request's whole prompt
        counts from admission (prefill is committed work — otherwise two
        large prompts could co-admit under the budget at kv_len 0 and
        one would be evicted right after its prefill was paid for),
        plus one decode step of growth for decoding requests."""
        total = 0
        for slot, r in self.active.items():
            if r.state == PREFILL:
                total += r.prompt_len
            else:
                total += int(self.kv_len[slot]) + 1
        return total

    def _refresh_cost_model(self) -> Optional[CostModel]:
        """The cost model this admission round prices with: ONE snapshot
        per round from ``snapshot_provider`` when attached (admission
        then agrees with the calibrated planner), else the static
        ``cost_model``.  All of a round's decisions — ordering, the
        step-cost budget — use the same pull."""
        if self.cfg.snapshot_provider is not None:
            snap = self.cfg.snapshot_provider()
            self._round_cm = snap.cost_model
            self.last_calib_version = int(snap.version)
        return self._round_cm

    def _step_cost(self, extra: Optional[Request] = None) -> float:
        cm = self._round_cm
        reqs = list(self.active.values()) + ([extra] if extra else [])
        return float(sum(cm.predict(1, r.total_len) for r in reqs))

    def _admissible(self, req: Request) -> bool:
        # +1 decode-step growth, unless the request is prefill-only
        grow = min(1, req.max_new_tokens)
        if self._live_tokens() + req.prompt_len + grow \
                > self.cfg.token_budget:
            return False
        if self.cfg.step_cost_budget and self.active \
                and self._step_cost(req) > self.cfg.step_cost_budget:
            return False
        return True

    # ---------------------------------------------------------- admission
    def admit(self) -> List[Request]:
        """Move waiting requests into free slots under the budgets."""
        admitted = []
        cm = self._refresh_cost_model()
        while self.free and self.waiting:
            if self.cfg.admission == "cost":
                i = int(np.argmin([float(cm.predict(1, r.total_len))
                                   for r in self.waiting]))
            else:
                i = 0
            req = self.waiting[i]
            if not self._admissible(req):
                break        # head-of-line blocking: deterministic order
            del self.waiting[i]
            slot = self.free.pop(0)
            req.state, req.slot, req.n_prefilled = PREFILL, slot, 0
            req.out_tokens = []
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.active[slot] = req
            self.kv_len[slot] = 0
            self.trace.append(("admit", req.rid))
            admitted.append(req)
        if not admitted and not self.active and self.waiting:
            raise RuntimeError(
                f"request {self.waiting[0].rid} can never be admitted "
                f"under token_budget={self.cfg.token_budget}")
        reg = obs_metrics.get_registry()
        reg.counter("serve_admitted_total",
                    "requests admitted into cache slots").inc(
            len(admitted))
        reg.gauge("serve_queue_depth",
                  "requests waiting for a cache slot").set(
            len(self.waiting))
        reg.gauge("serve_calib_version",
                  "calibration snapshot version admission priced "
                  "with").set(self.last_calib_version)
        return admitted

    # ----------------------------------------------------------- eviction
    def evict_for_budget(self) -> List[Request]:
        """Preempt LIFO until the next decode step fits the budget.

        The oldest active request is never evicted: it runs to completion
        even if it alone exceeds the budget (the budget goes soft for
        the last request).  That guarantees forward progress — without
        it, a single over-budget request would be admitted, decoded to
        the budget, evicted with progress discarded, and re-admitted
        forever."""
        evicted = []
        order = sorted(self.active, key=lambda s: self.active[s].admit_seq)
        while self._live_tokens() > self.cfg.token_budget and len(order) > 1:
            slot = order.pop()                 # most recently admitted
            req = self.active.pop(slot)
            req.state, req.slot = WAITING, -1
            req.n_prefilled, req.out_tokens = 0, []
            req.n_evictions += 1
            self.kv_len[slot] = 0
            self.free.append(slot)
            self.free.sort()
            self.waiting.appendleft(req)
            self.trace.append(("evict", req.rid))
            evicted.append(req)
        if evicted:
            obs_metrics.get_registry().counter(
                "serve_evictions_total",
                "recompute preemptions (LIFO budget evictions)").inc(
                len(evicted))
        return evicted

    # ------------------------------------------------------------ prefill
    def next_prefill_chunk(self, fused: bool = True) \
            -> Optional[PrefillChunk]:
        """Pack the next chunk of prompt tokens.

        fused=True: up to ``chunk_tokens`` tokens, pieces 128-aligned per
        request.  fused=False: a decode-mode chunk (blk_q = 1) advancing
        every prefilling request by exactly one token."""
        if fused:
            return self._chunk_fused()
        return self._chunk_loop()

    def _chunk_fused(self) -> Optional[PrefillChunk]:
        t_total = self.cfg.chunk_tokens
        tokens = np.zeros(t_total, np.int32)
        pos = -np.ones(t_total, np.int32)
        block_req = -np.ones(t_total // BLOCK, np.int32)
        last_rows: List[Tuple[int, int]] = []
        t = 0
        for slot in sorted(self.active):
            req = self.active[slot]
            if req.state != PREFILL:
                continue
            remaining = req.prompt_len - req.n_prefilled
            if remaining <= 0 or t >= t_total:
                continue
            nblocks = min(-(-remaining // BLOCK), (t_total - t) // BLOCK)
            if nblocks == 0:
                break
            take = min(remaining, nblocks * BLOCK)
            lo = req.n_prefilled
            tokens[t:t + take] = req.prompt[lo:lo + take]
            pos[t:t + take] = np.arange(lo, lo + take)
            block_req[t // BLOCK: t // BLOCK + nblocks] = slot
            req.n_prefilled += take
            self.kv_len[slot] = req.n_prefilled
            if req.n_prefilled == req.prompt_len:
                last_rows.append((slot, t + take - 1))
                req.state = DECODE
            t += nblocks * BLOCK
        if t == 0:
            return None
        return PrefillChunk(tokens, pos, block_req, self.kv_len.copy(),
                            last_rows)

    def _chunk_loop(self) -> Optional[PrefillChunk]:
        n = self.cfg.n_slots
        tokens = np.zeros(n, np.int32)
        pos = -np.ones(n, np.int32)
        block_req = -np.ones(n, np.int32)
        last_rows: List[Tuple[int, int]] = []
        any_live = False
        for slot in sorted(self.active):
            req = self.active[slot]
            if req.state != PREFILL:
                continue
            any_live = True
            tokens[slot] = req.prompt[req.n_prefilled]
            pos[slot] = req.n_prefilled
            block_req[slot] = slot
            req.n_prefilled += 1
            self.kv_len[slot] = req.n_prefilled
            if req.n_prefilled == req.prompt_len:
                last_rows.append((slot, slot))
                req.state = DECODE
        if not any_live:
            return None
        return PrefillChunk(tokens, pos, block_req, self.kv_len.copy(),
                            last_rows)

    def commit_prefill(self, chunk: PrefillChunk,
                       first_tokens: Dict[int, int]) -> List[Request]:
        """Record the first sampled token of each request whose prefill
        completed in ``chunk`` (keyed by slot).  Prefill-only requests
        (max_new_tokens == 0) finish with no output."""
        finished = []
        for slot, _row in chunk.last_rows:
            req = self.active[slot]
            if req.max_new_tokens > 0:
                req.out_tokens.append(int(first_tokens[slot]))
            if self._is_finished(req):
                finished.append(self._finish(req))
        return finished

    # ------------------------------------------------------------- decode
    def decode_batch(self) \
            -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]]:
        """(tokens [B], pos [B], block_req [B], kv_len_next [B]) for one
        batched decode step, or None when nothing is decoding."""
        n = self.cfg.n_slots
        tokens = np.zeros(n, np.int32)
        pos = -np.ones(n, np.int32)
        block_req = -np.ones(n, np.int32)
        kv_next = self.kv_len.copy()
        any_live = False
        for slot in sorted(self.active):
            req = self.active[slot]
            if req.state != DECODE:
                continue
            any_live = True
            tokens[slot] = req.out_tokens[-1]
            pos[slot] = self.kv_len[slot]
            block_req[slot] = slot
            kv_next[slot] += 1
        if not any_live:
            return None
        return tokens, pos, block_req, kv_next

    def commit_decode(self, next_tokens: np.ndarray) -> List[Request]:
        """Append sampled tokens; finish requests hitting max_new/eos.
        Returns the finished requests (slots freed)."""
        finished = []
        for slot in sorted(self.active):
            req = self.active[slot]
            if req.state != DECODE:
                continue
            self.kv_len[slot] += 1
            req.out_tokens.append(int(next_tokens[slot]))
            if self._is_finished(req):
                finished.append(self._finish(req))
        return finished

    # ------------------------------------------------------------ helpers
    def _is_finished(self, req: Request) -> bool:
        if len(req.out_tokens) >= req.max_new_tokens:
            return True
        return self.cfg.eos_id is not None \
            and req.out_tokens[-1] == self.cfg.eos_id

    def _finish(self, req: Request) -> Request:
        slot = req.slot
        req.state, req.slot = DONE, -1
        del self.active[slot]
        self.kv_len[slot] = 0
        self.free.append(slot)
        self.free.sort()
        self.done.append(req)
        self.trace.append(("finish", req.rid))
        obs_metrics.get_registry().counter(
            "serve_finished_total", "requests run to completion").inc()
        return req
