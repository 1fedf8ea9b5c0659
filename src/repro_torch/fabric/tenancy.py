"""Tenant classes and SLO-aware admission for the multi-tenant fabric.

The port's copy of ``repro.fabric.tenancy`` (host code: the same inputs
give the same rounds).

One elastic :class:`~repro_torch.runtime.pool.ServerPool` serves two
tenants (DESIGN.md §10):

  * **train** — the throughput class.  Its primary ``StepPlan`` tasks
    own the pool: admission never delays them, and a serve task is only
    placed into a server's *idle* capacity (the gap between the
    server's predicted primary load and the step cadence).
  * **serve** — the latency class.  Its prefill/decode CA tasks backfill
    idle capacity, and under SLO pressure they *preempt
    speculation-eligible training blocks* — the straggler backup
    re-executions, which are redundant by construction — never primary
    tasks.

Admission is deterministic: one :class:`CalibrationSnapshot` and one
``pool_epoch``-stamped membership view per round (the discipline
``CADSession.plan`` follows), FCFS order with head-of-line blocking
(the serve scheduler's documented semantics), ties broken by the lowest
slot.  The head-of-line task's budget goes soft after
``max_wait_rounds`` — the same forward-progress guarantee the serve
scheduler gives its last request.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

TRAIN_NAME, SERVE_NAME = "train", "serve"
THROUGHPUT, LATENCY = "throughput", "latency"


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """Priority class of one fabric tenant.  ``kind`` picks the
    scheduling objective (throughput = own the step plan, latency =
    backfill + SLO); lower ``priority`` wins a capacity conflict.
    ``preempts_speculation`` lets the latency class reclaim the
    capacity straggler speculation would burn on redundant backups."""
    name: str
    kind: str
    priority: int
    preempts_speculation: bool = False

    def __post_init__(self):
        if self.kind not in (THROUGHPUT, LATENCY):
            raise ValueError(f"unknown tenant kind {self.kind!r}")


TRAIN = TenantClass(name=TRAIN_NAME, kind=THROUGHPUT, priority=0)
SERVE = TenantClass(name=SERVE_NAME, kind=LATENCY, priority=1,
                    preempts_speculation=True)


@dataclasses.dataclass(frozen=True)
class ServeTaskReq:
    """One serve-tenant CA task awaiting placement: request ``rid``'s
    next prefill chunk or decode step — ``q_tokens`` query tokens
    against a ``kv_tokens``-token context, the exact shape the cost
    model prices."""
    rid: int
    seq: int                      # task index within the request
    q_tokens: int
    kv_tokens: int
    arrival_step: int             # request arrival (FCFS key)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs of the serve tenant's admission.

    ``slo_rounds``: target rounds from readiness to execution; a task
    waiting longer counts as an SLO miss in the round report.
    ``max_wait_rounds``: after this many deferrals the head-of-line
    task is force-admitted onto the least-loaded candidate even if the
    idle budget is exhausted (stretching the step — forward progress
    beats cadence).  ``allowed``: restrict serve placement to these
    slots (None = the whole pool) — a static partition expressed in the
    same machinery, which is exactly what the reference's
    ``benchmarks/fabric_mix.py`` uses as its baseline."""
    slo_rounds: int = 4
    max_wait_rounds: int = 8
    allowed: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class AdmissionRound:
    """The (deterministic, replayable) outcome of one admission round."""
    pool_epoch: int
    calib_version: int
    placements: Dict[int, List[ServeTaskReq]]   # server -> tasks
    deferred: Tuple[ServeTaskReq, ...]
    forced: Tuple[int, ...]            # rids admitted past the budget
    idle_before: Dict[int, float]      # per-server idle seconds offered
    idle_after: Dict[int, float]       # ... left after placement
    slo_misses: int                    # deferred tasks older than SLO

    @property
    def n_admitted(self) -> int:
        return sum(len(t) for t in self.placements.values())


def admit_serve(tasks: Sequence[ServeTaskReq],
                busy: Dict[int, float],
                interval: float,
                snapshot,
                view,
                *,
                policy: AdmissionPolicy = AdmissionPolicy(),
                candidates: Optional[Sequence[int]] = None,
                waits: Optional[Dict[int, int]] = None) -> AdmissionRound:
    """Place serve tasks into the pool's idle capacity for one round.

    ``busy`` maps server -> predicted primary train seconds this step
    (0 for servers with no train tasks — e.g. draining slots kept alive
    for serving); ``interval`` is the step cadence, so a server's idle
    budget is ``interval - busy``.  ``snapshot`` prices every task
    (``cost_model.predict(q, kv) / speed``); ``view`` (a ``PoolView``
    or None) stamps the round with the membership epoch and, when
    ``candidates`` is not given, supplies active + draining slots —
    draining servers take no *new train* tasks but still serve.

    Placement: FCFS over ``tasks``; each task goes to the candidate
    with the most remaining idle that fits it (ties -> lowest slot).
    The first unfittable task defers the rest (head-of-line blocking,
    deterministic order) — unless it has waited ``max_wait_rounds``
    (per ``waits``, keyed by rid), in which case it is force-admitted
    onto the least-loaded candidate and admission continues."""
    cm = snapshot.cost_model
    speeds = snapshot.speeds
    if candidates is None:
        if view is not None:
            candidates = tuple(sorted(view.active + view.draining))
        else:
            candidates = tuple(sorted(busy))
    if policy.allowed is not None:
        candidates = tuple(s for s in candidates if s in policy.allowed)
    epoch = -1 if view is None else int(view.epoch)
    idle = {s: max(0.0, float(interval) - float(busy.get(s, 0.0)))
            for s in candidates}
    idle_before = dict(idle)
    placements: Dict[int, List[ServeTaskReq]] = {}
    deferred: List[ServeTaskReq] = []
    forced: List[int] = []
    waits = waits or {}
    blocked = False
    for t in tasks:
        if blocked:
            deferred.append(t)
            continue
        cost = float(cm.predict(t.q_tokens, t.kv_tokens))
        best, best_left = -1, 0.0
        for s in candidates:
            need = cost / float(speeds[s])
            left = idle[s] - need
            if left >= 0.0 and (best < 0 or left > best_left):
                best, best_left = s, left
        if best < 0:
            if candidates and waits.get(t.rid, 0) >= policy.max_wait_rounds:
                # forward progress: budget goes soft for the head of
                # line, mirroring the serve scheduler's sole-request rule
                best = max(candidates, key=lambda s: (idle[s], -s))
                forced.append(t.rid)
            else:
                deferred.append(t)
                blocked = True           # head-of-line blocking
                continue
        idle[best] -= cost / float(speeds[best])
        placements.setdefault(best, []).append(t)
    slo_misses = sum(1 for t in deferred
                     if waits.get(t.rid, 0) >= policy.slo_rounds)
    return AdmissionRound(pool_epoch=epoch,
                          calib_version=int(snapshot.version),
                          placements=placements,
                          deferred=tuple(deferred),
                          forced=tuple(forced),
                          idle_before=idle_before,
                          idle_after=idle,
                          slo_misses=slo_misses)
