"""Elastic attention-server pool: explicit membership epochs.

The port's copy of ``repro.runtime.pool`` (stdlib only).

The paper's key structural fact — core attention is *stateless* — means
the server pool does not have to be a compile-time constant: a CA task
can be recomputed anywhere from the (q, k, v) shards its requester
already holds.  :class:`ServerPool` makes membership a first-class,
mutable, *versioned* runtime object:

  * every slot of the dispatch geometry (one per rank — array shapes
    never change, so one compiled executable serves every epoch) holds
    an *endpoint* that is ``active``, ``draining`` or ``dead``;
  * every membership mutation (drain / remove / add) bumps the pool
    **epoch**; planners are re-invoked against the surviving endpoints
    (``PoolView.excluded`` feeds the schedulers' ``exclude``), and
    prefetched plans stamped with an older epoch are re-planned at pull
    (:meth:`repro_torch.cad.CADSession._plan_stale`);
  * :class:`~repro_torch.core.cost_model.GridCalibrator` speed state is
    carried over across epochs: surviving servers keep their measured
    ratios, a same-endpoint rejoin (flap) keeps its calibration, and
    only a *new* endpoint joining at a slot resets that slot to the
    base model (``GridCalibrator.reset_server``).

Killing a server withdraws its attention-*serving* capacity only.  Its
data-rank half stays alive and keeps sending q/k/v shards — the paper's
disaggregated framing, where DP/TP workers own the state and attention
servers own none (DESIGN.md §9).

All methods are thread-safe: the plan-prefetch worker reads ``view()``
while the train loop mutates membership.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

ACTIVE = "active"
DRAINING = "draining"
DEAD = "dead"
_STATUSES = (ACTIVE, DRAINING, DEAD)


class PoolExhaustedError(RuntimeError):
    """A membership change would leave no active attention server."""


class ServerLostError(Exception):
    """An attention server was lost while it served its task batch (its
    endpoint died or stopped answering).  The elastic executor recovers
    the server's tasks on the survivors and removes it from the pool.
    Only this error is demoted to a server failure: any other exception
    of a serve (a kernel that does not build, a CUDA error, a shape a
    kernel refuses) is a fault of the program and propagates."""


@dataclasses.dataclass(frozen=True)
class PoolView:
    """Immutable snapshot of pool membership at one epoch.  Planning a
    step consumes exactly one view, so both ping-pong halves (and every
    recovery sub-plan within the step) see the same membership."""
    epoch: int
    n_slots: int
    active: Tuple[int, ...]       # slots that may receive new tasks
    draining: Tuple[int, ...]     # finishing in-flight work; no new tasks
    dead: Tuple[int, ...]
    endpoints: Tuple[str, ...]    # per-slot endpoint identity

    @property
    def excluded(self) -> Tuple[int, ...]:
        """Slots the planners must not assign tasks to."""
        return tuple(sorted(self.draining + self.dead))

    @property
    def n_active(self) -> int:
        return len(self.active)


@dataclasses.dataclass
class _Member:
    endpoint: str
    status: str
    joined_epoch: int


class ServerPool:
    """Mutable pool membership over a fixed dispatch geometry.

    ``n_slots`` is the dispatch dimension D (== data ranks); it never
    changes.  What changes is which slots currently serve attention.
    ``calibrator`` (optional) receives the carryover hooks described in
    the module docstring.
    """

    def __init__(self, n_slots: int, *, calibrator=None,
                 endpoints: Optional[List[str]] = None):
        if n_slots < 1:
            raise ValueError(f"pool needs >= 1 slot, got {n_slots}")
        if endpoints is not None and len(endpoints) != n_slots:
            raise ValueError(f"endpoints needs {n_slots} entries, got "
                             f"{len(endpoints)}")
        self.n_slots = int(n_slots)
        self.calibrator = calibrator
        self._members = [
            _Member(endpoint=(endpoints[s] if endpoints
                              else f"attn-server/{s}"),
                    status=ACTIVE, joined_epoch=0)
            for s in range(n_slots)]
        self._epoch = 0
        self._lock = threading.Lock()
        self._log: List[Tuple[int, str]] = []

    # ------------------------------------------------------------- views
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def view(self) -> PoolView:
        with self._lock:
            return self._view_locked()

    def _view_locked(self) -> PoolView:
        by = {st: [] for st in _STATUSES}
        for s, m in enumerate(self._members):
            by[m.status].append(s)
        return PoolView(epoch=self._epoch, n_slots=self.n_slots,
                        active=tuple(by[ACTIVE]),
                        draining=tuple(by[DRAINING]),
                        dead=tuple(by[DEAD]),
                        endpoints=tuple(m.endpoint
                                        for m in self._members))

    def status(self, slot: int) -> str:
        with self._lock:
            return self._members[self._check(slot)].status

    def history(self) -> Tuple[Tuple[int, str], ...]:
        """The (epoch, event) membership log — replayable audit trail."""
        with self._lock:
            return tuple(self._log)

    def __iter__(self) -> Iterator[int]:
        return iter(self.view().active)

    # --------------------------------------------------------- mutations
    def _check(self, slot: int) -> int:
        slot = int(slot)
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} outside pool of "
                             f"{self.n_slots}")
        return slot

    def _bump(self, event: str) -> int:
        self._epoch += 1
        self._log.append((self._epoch, event))
        # narrate the membership change (DESIGN.md §14); the recorder
        # and registry have their own locks and never call back into
        # the pool, so recording under self._lock cannot deadlock
        obs_trace.get_recorder().instant(
            "pool." + event.split(" ", 1)[0], "pool",
            args={"event": event, "epoch": self._epoch})
        obs_metrics.get_registry().gauge(
            "cad_pool_epoch", "pool membership epoch").set(self._epoch)
        obs_metrics.get_registry().counter(
            "cad_pool_events_total", "membership mutations",
            labels=("kind",)).inc(kind=event.split(" ", 1)[0])
        return self._epoch

    def drain(self, slot: int) -> int:
        """Stop routing new tasks to ``slot``; in-flight work finishes.
        Returns the new epoch."""
        with self._lock:
            slot = self._check(slot)
            m = self._members[slot]
            if m.status != ACTIVE:
                raise ValueError(f"cannot drain slot {slot}: {m.status}")
            if sum(x.status == ACTIVE for x in self._members) <= 1:
                raise PoolExhaustedError(
                    f"draining slot {slot} would leave no active "
                    f"attention server")
            m.status = DRAINING
            return self._bump(f"drain {slot} ({m.endpoint})")

    def remove(self, slot: int) -> int:
        """Declare ``slot`` dead (crash, deadline exceeded, operator
        removal).  Its in-flight tasks are lost — the elastic executor
        recovers them onto survivors.  Returns the new epoch."""
        with self._lock:
            slot = self._check(slot)
            m = self._members[slot]
            if m.status == DEAD:
                raise ValueError(f"slot {slot} is already dead")
            others = sum(x.status == ACTIVE for x in self._members
                         if x is not m)
            if others < 1:
                raise PoolExhaustedError(
                    f"removing slot {slot} would leave no active "
                    f"attention server")
            m.status = DEAD
            return self._bump(f"remove {slot} ({m.endpoint})")

    def add(self, slot: int, *, endpoint: Optional[str] = None,
            prior_speed: Optional[float] = None) -> int:
        """(Re)activate ``slot``.  A draining server is simply restored.
        A dead slot rejoins: with ``endpoint=None`` (or the same
        endpoint string) this is a *flap* — the same machine came back,
        so its calibrated speed state stays; with a new ``endpoint`` a
        replacement server joins and the calibrator slot is reset to
        the base model (``prior_speed`` optionally declares its
        relative speed).  Returns the new epoch."""
        with self._lock:
            slot = self._check(slot)
            m = self._members[slot]
            if m.status == ACTIVE:
                raise ValueError(f"slot {slot} is already active")
            was_draining = m.status == DRAINING
            fresh = endpoint is not None and endpoint != m.endpoint
            if fresh:
                m.endpoint = endpoint
                if self.calibrator is not None:
                    self.calibrator.reset_server(slot,
                                                 prior_speed=prior_speed)
            m.status = ACTIVE
            m.joined_epoch = self._epoch + 1
            kind = "join" if fresh else \
                ("undrain" if was_draining else "rejoin")
            return self._bump(f"{kind} {slot} ({m.endpoint})")
