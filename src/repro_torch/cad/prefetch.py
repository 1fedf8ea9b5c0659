"""Async plan prefetch: overlap host-side scheduling with device compute.

The port's copy of ``repro.cad.prefetch`` (stdlib only).

The paper's scheduler "prefetches the upcoming batch": while the device
executes step *i*, the (numpy, host-side) scheduler plans batch *i+1* so
planning never sits on the critical path.  ``PlanPrefetcher`` implements
that as a background worker thread feeding a bounded queue; the numpy
scheduler and PyTorch's device calls both release the GIL for their
heavy parts, so host planning genuinely overlaps device compute.

If the worker dies, its exception is re-raised at the consumer's next
pull — a failed plan is never silently swallowed.  ``CADSession`` falls
back to fully synchronous planning when ``prefetch=0``.

Runtime calibration crosses this thread boundary (DESIGN.md §3): the
worker plans ahead with whatever calibration snapshot is current *when
it plans*, so a prefetched plan can be up to ``depth`` steps stale by
the time the consumer pulls it.  ``is_stale``/``refresh`` close the
loop deterministically: the staleness check and the synchronous re-plan
both run on the *consumer* thread at pull time, so which snapshot a
yielded plan was built from is a pure function of the pull sequence —
never of worker-thread timing — and replay stays deterministic (each
plan records its ``calib_version``).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_DONE = object()


class PlanPrefetcher:
    """Iterate ``fn(item) for item in source`` with a bounded look-ahead.

    The worker thread pulls from ``source`` and plans at most ``depth``
    items beyond what the consumer has taken.  Order is preserved (single
    worker, FIFO queue).  ``close()`` — also invoked by ``with`` exit and
    generator teardown — stops the worker and joins it.

    ``is_stale`` (optional) is evaluated against each planned item on
    the consumer thread at pull time; when it returns True the item is
    re-planned synchronously with ``refresh`` (default: ``fn``) before
    being yielded — the calibration feedback path.  ``stale_refreshes``
    counts how many pulls re-planned.
    """

    def __init__(self, source: Iterable[Any], fn: Callable[[Any], Any],
                 depth: int = 2, *,
                 is_stale: Optional[Callable[[Any], bool]] = None,
                 refresh: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._fn = fn
        self._is_stale = is_stale
        self._refresh = refresh if refresh is not None else fn
        self.stale_refreshes = 0
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="cad-plan-prefetch")
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _put(self, item: Any) -> bool:
        """Blocking put that stays responsive to ``close()``."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self) -> None:
        rec = obs_trace.get_recorder()
        try:
            for raw in self._source:
                if self._stop.is_set():
                    return
                with rec.span("prefetch.plan", "prefetch"):
                    item = self._fn(raw)
                if not self._put(item):
                    return
                self._depth_gauge()
        except BaseException as e:           # surfaced at the next pull
            self._exc = e
        finally:
            self._put(_DONE)

    def _depth_gauge(self) -> None:
        """Publish the current look-ahead occupancy (queue depth is
        approximate by nature — a gauge, not an invariant)."""
        obs_metrics.get_registry().gauge(
            "cad_prefetch_queue_depth",
            "planned batches waiting in the prefetch queue").set(
            self._queue.qsize())

    # ----------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        # timed get so a close() from another thread (which drains the
        # queue, possibly eating the sentinel) cannot strand us
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is _DONE:
                self.close()
                if self._exc is not None:
                    raise self._exc
                raise StopIteration
            if self._stop.is_set():
                # close() raced the get: the item was planned for a
                # world that no longer exists (a dead pool epoch, a
                # torn-down session) — drop it, never deliver it
                raise StopIteration
            self._depth_gauge()
            if self._is_stale is not None and self._is_stale(item):
                with obs_trace.get_recorder().span("prefetch.replan",
                                                   "prefetch"):
                    item = self._refresh(item)
                self.stale_refreshes += 1
                obs_metrics.get_registry().counter(
                    "cad_prefetch_stale_refreshes_total",
                    "prefetched plans re-planned at pull "
                    "(stale epoch or drifted speeds)").inc()
            return item

    def close(self) -> None:
        """Stop the worker and drain the queue; idempotent."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PlanPrefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass
