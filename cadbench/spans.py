"""The program's own spans of a traced window, on the profiler's timeline:
what the per-layer metrics of the training path's layers read
(``metrics/batch_wait_ms.py``, ``plan_build_ms.py``, ``optimizer_ms.py``,
``model_idle_ms.py``).

The port's recorder (``repro_torch.obs.trace``) stamps spans with
``time.perf_counter``; the profiler stamps events in microseconds from its
trace's start.  A clock anchor taken while the profiler runs brackets a
profiler range named ``ANCHOR`` between two reads of the recorder's clock;
the range's middle, found among the profiler's events, gives the offset
between the two clocks to within half the bracket.

Each span record: ``name``, ``track``, ``step`` (the batch's index in the
stream), ``start`` and ``end`` (microseconds on the profiler's timeline),
``args``, and ``kernel_us`` / ``n_kernels``: the device time and count of
the kernels whose launching runtime call started inside the span (the
kernels ``frozen.trace.kernel_records`` keeps: the regions' own device
ranges and the lead-in's spin kernels left out).

A window's records are read with ``span_records``; a traced window with
the records in ``Records.spans`` is what the readers take, and without
them they read nothing.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from cadbench.frozen.trace import REGIONS, SPIN_KERNEL

ANCHOR = "obs.clock_anchor"
SPAN = "X"


def anchor_offset_us(anchor, events) -> Tuple[float, float]:
    """(offset, error) in microseconds mapping the recorder's seconds onto
    the profiler's timeline: ``anchor`` (the program's ``ClockAnchor``)
    holds the recorder's clock read on either side of the first profiler
    range ``ANCHOR`` among ``events``."""
    a = next(e for e in events if e.name == ANCHOR).time_range
    return anchor.offset_us(a.start, a.end)


def _launches(events) -> List[Tuple[float, float]]:
    """(launch call's start, kernel's device µs) of every kept kernel,
    sorted by the launch."""
    from torch.autograd import DeviceType
    calls = {e.id: e for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("cu")}
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in REGIONS \
                or SPIN_KERNEL in e.name or e.id not in calls:
            continue
        out.append((calls[e.id].time_range.start,
                    e.time_range.end - e.time_range.start))
    out.sort()
    return out


def span_records(spans, offset_us: float, events,
                 steps: Optional[Iterable[int]] = None) -> List[dict]:
    """The recorder's spans (``TraceEvent``s) as records on the profiler's
    timeline, those of ``steps`` only when given, with the kernels each
    launched counted from the profiler's ``events``."""
    keep = None if steps is None else set(steps)
    launches = _launches(events)
    at = [t for t, _ in launches]
    run = [0.0]
    for _, us in launches:
        run.append(run[-1] + us)
    out = []
    for s in spans:
        if s.ph != SPAN or (keep is not None and s.step not in keep):
            continue
        a = s.ts * 1e6 + offset_us
        b = (s.ts + s.dur) * 1e6 + offset_us
        i, j = bisect.bisect_left(at, a), bisect.bisect_right(at, b)
        out.append({"name": s.name, "track": s.track, "step": s.step,
                    "start": a, "end": b, "args": dict(s.args or {}),
                    "kernel_us": run[j] - run[i], "n_kernels": j - i})
    return out


def named(rec, name: str) -> List[dict]:
    """The window's span records named ``name`` (none when the records
    carry no spans)."""
    return [s for s in getattr(rec, "spans", None) or ()
            if s["name"] == name]


def by_step(spans: Sequence[dict]) -> Dict[int, float]:
    """Each batch id's total span time in ms."""
    out: Dict[int, float] = {}
    for s in spans:
        out[s["step"]] = out.get(s["step"], 0.0) \
            + (s["end"] - s["start"]) / 1e3
    return out


def busy_intervals(kernels) -> List[Tuple[float, float]]:
    """The union of the kernels' intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for k in sorted(kernels, key=lambda k: k["start"]):
        if out and k["start"] <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], k["end"]))
        else:
            out.append((k["start"], k["end"]))
    return out


def idle_us(busy: Sequence[Tuple[float, float]], a: float,
            b: float) -> float:
    """Microseconds of [a, b] that no interval of ``busy`` (disjoint,
    sorted) covers."""
    i = max(0, bisect.bisect_right(busy, (a, float("inf"))) - 1)
    covered = 0.0
    for lo, hi in busy[i:]:
        if lo >= b:
            break
        covered += max(0.0, min(hi, b) - max(lo, a))
    return (b - a) - covered
