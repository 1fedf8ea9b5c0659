"""Flight recorder: thread-safe, ring-buffered structured tracing

A copy of ``repro.obs.trace``; the port keeps its own so it never imports
the JAX package.
(DESIGN.md §14).

``TraceRecorder`` collects **spans** (named intervals with a duration)
and **instant events** on named *tracks* — one track per attention
server (``server/0`` …), plus ``planner``, ``prefetch``, ``pool``,
``fabric``, ``serve`` and ``step``.  The buffer is a bounded ring: at
capacity the oldest events are overwritten (``n_dropped`` counts the
overwrites), so a recorder can stay attached to a week-long run
without growing.

Two timestamp sources coexist deliberately:

  * host-side spans (plan build, prefetch, probes, serve rounds) are
    measured with the recorder's injectable :class:`~repro_torch.obs.clock.
    Clock` (``span(...)`` context manager);
  * step-execution spans carry **explicit** timestamps on a synthetic
    per-run timeline (``add_span``): the elastic executor lays each
    step's per-server serve/recovery intervals out in modeled or
    measured seconds from a cumulative origin, so the exported trace
    renders as the paper's per-server gantt regardless of which timer
    produced the numbers.

Export is Chrome-trace/Perfetto JSON (``to_chrome_trace`` / ``save``):
every track becomes one named thread, spans are complete ("X") events,
instants are "i" events, and timestamps are microseconds.  Load the
file in ``ui.perfetto.dev`` or ``chrome://tracing`` as-is.

The disabled recorder is a true no-op: every method returns before
touching the buffer, ``span()`` hands back a shared null context
manager, and — the contract ``benchmarks/obs_overhead.py`` enforces —
enabling tracing never changes a single output bit, only what gets
recorded about producing them.

Process-global wiring: components default to :func:`get_recorder`,
which starts **disabled**.  ``enable_tracing()`` swaps in a live
recorder (``launch/train.py --trace`` / test fixtures);
``disable_tracing()`` restores the no-op.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.obs.clock import MONOTONIC, Clock

SPAN = "X"          # Chrome-trace complete event
INSTANT = "i"       # Chrome-trace instant event


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded span or instant.  ``ts``/``dur`` are seconds on the
    recorder's timeline; ``track`` names the gantt row; ``step`` (when
    known) groups events for per-step attribution."""
    ph: str                      # SPAN | INSTANT
    name: str
    track: str
    ts: float
    dur: float = 0.0
    step: Optional[int] = None
    args: Optional[Dict[str, Any]] = None


class _NullSpan:
    """Shared no-op context manager for disabled recorders."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_rec", "_name", "_track", "_step", "_args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, track: str,
                 step: Optional[int], args: Optional[Dict[str, Any]]):
        self._rec = rec
        self._name, self._track = name, track
        self._step, self._args = step, args

    def __enter__(self):
        self._t0 = self._rec.clock.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = self._rec.clock.monotonic()
        self._rec.add_span(self._name, self._track, self._t0,
                           t1 - self._t0, step=self._step,
                           args=self._args)
        return False


class TraceRecorder:
    """Bounded, thread-safe event ring.

    ``capacity`` bounds the retained event count; older events are
    overwritten once full.  ``enabled=False`` builds the permanent
    no-op recorder (no buffer is ever touched).
    """

    def __init__(self, capacity: int = 65536, *, enabled: bool = True,
                 clock: Optional[Clock] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.clock: Clock = clock if clock is not None else MONOTONIC
        self._lock = threading.Lock()
        self._ring: list = [None] * self.capacity
        self._head = 0               # next write index
        self._count = 0              # live events (<= capacity)
        self._dropped = 0            # overwrites

    # ------------------------------------------------------------ record
    def span(self, name: str, track: str, *, step: Optional[int] = None,
             args: Optional[Dict[str, Any]] = None):
        """Context manager measuring a host-side span with the clock."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, track, step, args)

    def add_span(self, name: str, track: str, ts: float, dur: float, *,
                 step: Optional[int] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a span with explicit timestamps (synthetic or modeled
        timelines — the executor's per-server serve intervals)."""
        if not self.enabled:
            return
        self._push(TraceEvent(SPAN, name, track, float(ts),
                              max(0.0, float(dur)), step=step, args=args))

    def instant(self, name: str, track: str, *,
                ts: Optional[float] = None, step: Optional[int] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Record a point event (kill, epoch bump, admission round)."""
        if not self.enabled:
            return
        t = self.clock.monotonic() if ts is None else float(ts)
        self._push(TraceEvent(INSTANT, name, track, t, step=step,
                              args=args))

    def _push(self, ev: TraceEvent) -> None:
        with self._lock:
            if self._count == self.capacity:
                self._dropped += 1
            else:
                self._count += 1
            self._ring[self._head] = ev
            self._head = (self._head + 1) % self.capacity

    # ------------------------------------------------------------- views
    @property
    def n_dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return self._count

    def events(self) -> Tuple[TraceEvent, ...]:
        """Snapshot in record order (oldest retained first)."""
        with self._lock:
            if self._count < self.capacity:
                return tuple(self._ring[:self._count])
            h = self._head
            return tuple(self._ring[h:] + self._ring[:h])

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._head = self._count = self._dropped = 0

    # ------------------------------------------------------------ export
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON object: one named thread per
        track, microsecond timestamps, args carried through (plus the
        step for per-step attribution)."""
        evs = self.events()
        tracks = sorted({e.track for e in evs})
        tid = {t: i + 1 for i, t in enumerate(tracks)}
        out = [{"ph": "M", "pid": 1, "tid": tid[t], "name": "thread_name",
                "args": {"name": t}} for t in tracks]
        for e in evs:
            args = {k: _jsonable(v) for k, v in (e.args or {}).items()}
            if e.step is not None:
                args["step"] = int(e.step)
            rec = {"ph": e.ph, "name": e.name, "pid": 1,
                   "tid": tid[e.track], "ts": e.ts * 1e6, "args": args}
            if e.ph == SPAN:
                rec["dur"] = e.dur * 1e6
            else:
                rec["s"] = "t"      # instant scope: thread
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.n_dropped}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=None,
                      separators=(",", ":"))

    # ----------------------------------------------------------- queries
    def iter_steps(self) -> Iterator[int]:
        seen = []
        for e in self.events():
            if e.step is not None and e.step not in seen:
                seen.append(e.step)
        return iter(seen)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return float(v)            # numpy scalars
    except (TypeError, ValueError):
        return str(v)


# ------------------------------------------------------------ global hook
_NULL_RECORDER = TraceRecorder(capacity=1, enabled=False)
_default: TraceRecorder = _NULL_RECORDER
_default_lock = threading.Lock()


def get_recorder() -> TraceRecorder:
    """The process-global recorder components default to.  Starts as
    the disabled no-op; ``enable_tracing()`` swaps in a live one."""
    return _default


def set_recorder(rec: Optional[TraceRecorder]) -> TraceRecorder:
    """Install ``rec`` as the global recorder (None restores the
    no-op).  Returns the recorder now installed."""
    global _default
    with _default_lock:
        _default = rec if rec is not None else _NULL_RECORDER
        return _default


def enable_tracing(capacity: int = 65536, *,
                   clock: Optional[Clock] = None) -> TraceRecorder:
    """Install and return a fresh live global recorder."""
    return set_recorder(TraceRecorder(capacity, clock=clock))


def disable_tracing() -> None:
    """Restore the disabled no-op global recorder."""
    set_recorder(None)
