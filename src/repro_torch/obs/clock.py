"""Injectable monotonic clocks (DESIGN.md §14).

A copy of ``repro.obs.clock``; the port keeps its own so it never imports
the JAX package.

Every timer read in the runtime — the elastic executor's ``"wall"``
serve timings, trace span boundaries, serve-round latencies — goes
through a :class:`Clock` rather than calling ``time.perf_counter()``
directly.  Production code uses :data:`MONOTONIC` (a thin
``perf_counter`` wrapper); timing-dependent tests install a
:class:`FakeClock` and *script* the passage of time instead of
sleeping, so "this server took 3x longer" is a deterministic fixture,
not a flaky race.

``FakeClock.tick`` is the auto-advance: each ``monotonic()`` read
moves the clock forward by a fixed amount, which makes paired
start/stop reads measure exactly ``tick`` seconds — enough to drive
the executor's wall timer through a whole fault-injected run with
reproducible per-server seconds.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Anything with a monotonic ``monotonic() -> float`` (seconds)."""

    def monotonic(self) -> float: ...


class MonotonicClock:
    """The real thing: ``time.perf_counter``."""

    def monotonic(self) -> float:
        return time.perf_counter()


class FakeClock:
    """A scripted clock for deterministic timing tests.

    ``tick`` auto-advances the clock by that many seconds on every
    ``monotonic()`` read; ``advance()`` moves it explicitly.  Reads are
    monotone non-decreasing by construction.
    """

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        if tick < 0:
            raise ValueError(f"tick must be >= 0, got {tick}")
        self._now = float(start)
        self.tick = float(tick)
        self.reads = 0

    def monotonic(self) -> float:
        t = self._now
        self._now += self.tick
        self.reads += 1
        return t

    def advance(self, seconds: float) -> float:
        """Move time forward; returns the new now."""
        if seconds < 0:
            raise ValueError(f"cannot advance by {seconds} (monotonic)")
        self._now += float(seconds)
        return self._now


#: Process-wide default — the real monotonic clock.
MONOTONIC = MonotonicClock()
