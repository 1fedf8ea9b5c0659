"""Deterministic fault injection for the elastic attention runtime.

The port's copy of ``repro.runtime.faults`` (numpy only).

A :class:`FaultSchedule` is pure data — a sorted tuple of
:class:`FaultEvent` — so every failure path is *replayable*: the same
schedule (parsed from a spec string or generated from a seed) produces
the same kills, slowdowns and rejoins at the same steps, in tests, in
benchmarks and in the training demo alike.  Nothing here consults a
clock or unseeded randomness.

Spec grammar (comma-separated events)::

  kill:S@T        server S dies during step T (tasks lost mid-step;
                  removed from the pool afterwards, forever)
  flap:S@T+K      server S dies during step T and rejoins — same
                  endpoint, calibration kept — before step T+K
  slow:SxF@T-U    server S runs Fx slower during steps [T, U)
                  (U omitted -> forever), e.g. slow:1x4@3-9
  drain:S@T       server S is drained before step T (graceful: no new
                  tasks, nothing lost)

Examples::

  FaultSchedule.parse("kill:2@5")
  FaultSchedule.parse("slow:0x4@3-9,flap:1@4+3")
  FaultSchedule.random(n_servers=8, steps=100, seed=0)
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, List, Tuple

import numpy as np

KINDS = ("kill", "flap", "slow", "drain")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One injected fault.  ``until`` is the slow end-step (exclusive;
    -1 = forever) or the flap rejoin step; ``factor`` is the slowdown
    multiplier applied to the server's task time."""
    step: int
    kind: str
    server: int
    factor: float = 1.0
    until: int = -1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.step < 0 or self.server < 0:
            raise ValueError(f"step/server must be >= 0: {self}")
        if self.kind == "slow" and self.factor <= 0:
            raise ValueError(f"slow factor must be > 0: {self}")
        if self.kind == "flap" and self.until <= self.step:
            raise ValueError(f"flap rejoin must be after death: {self}")

    def spec(self) -> str:
        if self.kind == "kill" or self.kind == "drain":
            return f"{self.kind}:{self.server}@{self.step}"
        if self.kind == "flap":
            return (f"flap:{self.server}@{self.step}"
                    f"+{self.until - self.step}")
        end = "" if self.until < 0 else f"-{self.until}"
        return f"slow:{self.server}x{self.factor:g}@{self.step}{end}"


_EV_RE = re.compile(
    r"^(?P<kind>kill|flap|slow|drain):(?P<server>\d+)"
    r"(?:x(?P<factor>[0-9.]+))?@(?P<step>\d+)"
    r"(?:\+(?P<dur>\d+))?(?:-(?P<until>\d+))?$")


class FaultSchedule:
    """An ordered, replayable set of :class:`FaultEvent`."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(sorted(events))
        seen = set()
        for e in self.events:
            if e.kind in ("kill", "flap", "drain"):
                key = (e.step, e.server)
                if key in seen:
                    raise ValueError(
                        f"conflicting membership events for server "
                        f"{e.server} at step {e.step}")
                seen.add(key)

    # ------------------------------------------------------ constructors
    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """Parse the comma-separated spec grammar (module docstring)."""
        events: List[FaultEvent] = []
        for raw in filter(None, (p.strip() for p in spec.split(","))):
            m = _EV_RE.match(raw)
            if m is None:
                raise ValueError(f"bad fault spec {raw!r} (grammar: "
                                 f"kill:S@T  flap:S@T+K  slow:SxF@T-U  "
                                 f"drain:S@T)")
            kind = m.group("kind")
            server = int(m.group("server"))
            step = int(m.group("step"))
            if kind == "slow":
                if m.group("factor") is None:
                    raise ValueError(f"slow event needs a factor: {raw!r}")
                if m.group("dur"):
                    raise ValueError(
                        f"slow takes SxF@T-U, not a +K duration: {raw!r}")
                until = int(m.group("until")) if m.group("until") else -1
                events.append(FaultEvent(step, "slow", server,
                                         factor=float(m.group("factor")),
                                         until=until))
            elif kind == "flap":
                if m.group("dur") is None:
                    raise ValueError(f"flap event needs +K steps: {raw!r}")
                if m.group("factor") or m.group("until"):
                    raise ValueError(f"flap takes only S@T+K: {raw!r}")
                events.append(FaultEvent(step, "flap", server,
                                         until=step + int(m.group("dur"))))
            else:
                if m.group("factor") or m.group("dur") or m.group("until"):
                    raise ValueError(f"{kind} takes only S@T: {raw!r}")
                events.append(FaultEvent(step, kind, server))
        return cls(events)

    @classmethod
    def random(cls, n_servers: int, steps: int, seed: int, *,
               p_kill: float = 0.01, p_slow: float = 0.03,
               p_flap: float = 0.01, max_kills: int = 0,
               slow_factors=(2.0, 4.0, 8.0)) -> "FaultSchedule":
        """Seeded random schedule — chaos-monkey input that replays
        bit-identically for the same arguments.  ``max_kills`` caps
        permanent kills (default: at most n_servers - 1 ever die)."""
        rng = np.random.default_rng(seed)
        max_kills = max_kills or n_servers - 1
        kills = 0
        events: List[FaultEvent] = []
        dead_until = {}                      # server -> rejoin step (flap)
        for t in range(steps):
            for s in range(n_servers):
                if dead_until.get(s, -1) > t:
                    continue
                u = rng.random()
                if u < p_kill and kills < max_kills:
                    events.append(FaultEvent(t, "kill", s))
                    kills += 1
                    dead_until[s] = steps          # forever
                elif u < p_kill + p_flap:
                    k = int(rng.integers(1, 4))
                    if t + k < steps:
                        events.append(FaultEvent(t, "flap", s,
                                                 until=t + k))
                        dead_until[s] = t + k
                elif u < p_kill + p_flap + p_slow:
                    f = float(rng.choice(slow_factors))
                    dur = int(rng.integers(1, 6))
                    events.append(FaultEvent(t, "slow", s, factor=f,
                                             until=t + dur))
        return cls(events)

    # ----------------------------------------------------------- queries
    def spec(self) -> str:
        """Round-trips through :meth:`parse` (slow events generated by
        :meth:`random` always carry an end step, so the grammar covers
        them)."""
        return ",".join(e.spec() for e in self.events)

    def failures_at(self, step: int) -> Tuple[FaultEvent, ...]:
        """Kill/flap events striking during ``step`` — these servers
        lose their in-flight tasks mid-step."""
        return tuple(e for e in self.events
                     if e.step == step and e.kind in ("kill", "flap"))

    def drains_at(self, step: int) -> Tuple[int, ...]:
        return tuple(e.server for e in self.events
                     if e.step == step and e.kind == "drain")

    def rejoins_at(self, step: int) -> Tuple[int, ...]:
        """Flapped servers whose rejoin lands before ``step``."""
        return tuple(e.server for e in self.events
                     if e.kind == "flap" and e.until == step)

    # ------------------------------------------------- pool application
    # One implementation of the membership-event semantics, shared by
    # the fused trainer path and the elastic executor so the two can
    # never diverge.  Guards make events idempotent against earlier
    # schedule entries: a rejoin only raises the dead, a drain only
    # drains the active, a kill/flap removes any not-yet-dead server
    # (killing a *draining* server still transitions it to dead, so its
    # flap rejoin can fire later).

    def apply_pre_step(self, pool, step: int) -> List[str]:
        """Apply the membership events that land *before* step ``step``
        plans: flap rejoins and graceful drains.  Returns event log
        lines (empty when nothing applied)."""
        events: List[str] = []
        for s in self.rejoins_at(step):
            if pool.status(s) == "dead":
                pool.add(s)
                events.append(f"rejoin {s}")
        for s in self.drains_at(step):
            if pool.status(s) == "active":
                pool.drain(s)
                events.append(f"drain {s}")
        return events

    def apply_failures(self, pool, step: int) -> List[str]:
        """Apply ``step``'s kill/flap deaths to the pool.  The elastic
        executor calls this *after* executing (the server failed
        mid-step and its tasks were recovered); the fused trainer calls
        it before planning (step-granular membership).  May raise
        :class:`~repro_torch.runtime.pool.PoolExhaustedError`."""
        events: List[str] = []
        for e in self.failures_at(step):
            if pool.status(e.server) != "dead":
                pool.remove(e.server)
                events.append(f"{e.kind} {e.server}")
        return events

    def slow_factor(self, step: int, server: int) -> float:
        """Product of all slowdowns active on ``server`` at ``step``."""
        f = 1.0
        for e in self.events:
            if e.kind == "slow" and e.server == server \
                    and e.step <= step and (e.until < 0 or step < e.until):
                f *= e.factor
        return f

    def __len__(self) -> int:
        return len(self.events)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultSchedule) \
            and self.events == other.events

    def __hash__(self) -> int:
        return hash(self.events)

    def __repr__(self) -> str:
        return f"FaultSchedule({self.spec()!r})"
