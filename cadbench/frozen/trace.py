"""Frozen copy of how a traced window is read: the kernel families and the
bucket rule of the port's ``launch/breakdown.py`` (``KERNEL_FAMILIES``,
``cpu_op_buckets``) with the region names of ``obs/regions.py`` and the
backward-bucket map of ``launch/op_analysis.py``, and ``chip_smoke.py``'s
lead-in of spin kernels that opens a profiled window.

A kernel's bucket is that of the CUDA runtime call that launched it (the
CPU event with the same correlation id), found from the ranges enclosing
that call: the innermost region range (forward, or a remat recompute
inside the backward); else the autograd node the backward ran (an
``autograd::engine::evaluate_function`` range), whose forward op carries
the same sequence number and sits in a region range or in none; else
``fwd_other``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# the regions the port marks with torch.profiler.record_function
REGIONS = ("attention", "moe_experts", "unembed", "dispatch")
BUCKETS = ("attention", "attention_bwd", "moe_experts", "unembed",
           "dispatch", "bwd_other", "fwd_other")
# the bucket of a backward op, by its node's forward region
BWD_BUCKET = {"attention": "attention_bwd", "moe_experts": "moe_experts",
              "unembed": "unembed", "dispatch": "dispatch"}

# kernel families, matched in order on the kernel's name; the attention
# kernels' pattern captures the kernel's short name
KERNEL_FAMILIES = (
    ("SSD kernels",
     r"(ssd_(?:fwd|bwd_dc|bwd_dbx|fwd_mma|bwd_part|bwd_fold|dcsum))_kernel"),
    ("flash kernels",
     r"(flash_(?:fwd|bwd_dq|bwd_dkv|fwd_mma|dq_mma|dkv_mma))_kernel"),
    ("LRU kernels", r"(lru_scan_(?:fwd|bwd))(?:_direct)?_kernel"),
    ("CA-server kernels",
     r"(ca_(?:fwd|bwd_dq|bwd_dkv|fwd_mma|dq_mma|dkv_mma))_kernel"),
    ("ragged_decode kernels", r"(ragged_(?:mma|f32))_kernel"),
    ("matmuls (cuBLAS)", r"gemm|nvjet|xmma|cutlass|cublas|splitk"),
    ("copies and fills", r"^memcpy|^memset"))
OTHER = "other"

# the spin kernels that open a window: the profiler has been seen to drop
# a window's first device events late in a process
TRACE_LEAD_IN_CYCLES = 4_000_000
LEAD_IN_KERNELS = 64
SPIN_KERNEL = "spin_kernel"

_EVALUATE = "autograd::engine::evaluate_function: "


def trace_lead_in(torch) -> None:
    """Open a traced window: LEAD_IN_KERNELS spin kernels, not counted."""
    for _ in range(LEAD_IN_KERNELS):
        torch.cuda._sleep(TRACE_LEAD_IN_CYCLES // LEAD_IN_KERNELS)


def family(name: str) -> Tuple[str, Optional[str]]:
    """(family, the attention kernel's short name or None) of a kernel."""
    for fam, pat in KERNEL_FAMILIES:
        m = re.search(pat, name, re.I)
        if m:
            return fam, (m.group(1) if m.groups() else None)
    return OTHER, None


def _region_or_node(e):
    p = e
    while p is not None:
        if p.name in REGIONS:
            return p.name
        if p.name.startswith(_EVALUATE):
            return p
        p = p.cpu_parent
    return None


def cpu_op_buckets(cpu_events) -> Dict[int, str]:
    """Per CPU event (by ``id(event)``), its bucket by the module
    docstring's rule."""
    cpu = sorted(cpu_events, key=lambda e: e.time_range.start)
    encl = {id(e): _region_or_node(e) for e in cpu}
    fwd: Dict[tuple, Optional[str]] = {}
    for e in cpu:
        where = encl[id(e)]
        if e.sequence_nr >= 0 and not (where is not None
                                       and not isinstance(where, str)):
            fwd[(e.thread, e.sequence_nr)] = where
    out = {}
    for e in cpu:
        where = encl[id(e)]
        if where is None:
            out[id(e)] = "fwd_other"
        elif isinstance(where, str):
            out[id(e)] = where
        else:
            key = (getattr(where, "fwd_thread", where.thread),
                   where.sequence_nr)
            out[id(e)] = BWD_BUCKET.get(fwd.get(key), "bwd_other")
    return out


def kernel_records(events) -> List[dict]:
    """The device kernels of a traced window, each as ``{"name", "start",
    "end", "bucket", "family", "short"}`` (times in microseconds on the
    profiler's clock), the lead-in's spin kernels and the regions' own
    device ranges left out, sorted by start."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    buckets = cpu_op_buckets(cpu)
    launch = {e.id: e for e in cpu if e.name.startswith("cu")}
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in REGIONS \
                or SPIN_KERNEL in e.name:
            continue
        call = launch.get(e.id)
        fam, short = family(e.name)
        out.append({"name": e.name, "start": e.time_range.start,
                    "end": e.time_range.end, "family": fam, "short": short,
                    "bucket": buckets[id(call)] if call is not None
                    else "unattributed"})
    out.sort(key=lambda k: k["start"])
    return out


def busy_us(kernels) -> float:
    """The union of the kernels' intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for k in sorted(kernels, key=lambda k: k["start"]):
        busy += max(0.0, k["end"] - max(k["start"], end))
        end = max(end, k["end"])
    return busy


def idle_gaps(kernels, cpu_events, top: int = 10) -> List[list]:
    """The ``top`` longest gaps between the union of kernel intervals, each
    named by the outermost CPU op of the launching thread that overlaps
    the gap's middle (``host python`` where none does): [name, seconds]."""
    gaps, end = [], None
    for k in sorted(kernels, key=lambda k: k["start"]):
        if end is not None and k["start"] > end:
            gaps.append((end, k["start"]))
        end = k["end"] if end is None else max(end, k["end"])
    gaps.sort(key=lambda g: g[0] - g[1])
    roots = sorted((e for e in cpu_events if e.cpu_parent is None),
                   key=lambda e: e.time_range.start)
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        name = next((e.name for e in roots
                     if e.time_range.start <= mid <= e.time_range.end),
                    "host python")
        out.append([name, (b - a) / 1e6])
    return out
