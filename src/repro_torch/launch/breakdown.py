"""Per-bucket breakdown of one step: the port's counterpart of
``repro.launch.breakdown`` (``src/repro/launch/breakdown.py``).

The reference groups a compiled module's trip-weighted product FLOPs by
the JAX op name of each product, in seven buckets (attention,
attention_bwd, moe_experts, unembed, dispatch, bwd_other, fwd_other),
and its collective bytes by op name.  Here the buckets are the regions
the model marks (``obs.regions``) and the op counter's rule for the
backward (``launch.op_analysis``): :func:`flops_breakdown`,
:func:`collective_breakdown_by_name` and :func:`report` read an
:class:`~repro_torch.launch.op_analysis.OpCost`.

On the card, :func:`device_breakdown` reads one window traced with
``torch.profiler``: device ms by kernel family (:data:`KERNEL_FAMILIES`),
each attention kernel's launches, busy time and span, and device ms by
bucket.  A kernel's bucket is that of the CUDA runtime call that
launched it (the CPU event of the same correlation id:
``cudaLaunchKernel``, also where a kernel library launches through
``ctypes`` outside any torch op), found from the ranges enclosing that
call: the innermost region range (forward, or a remat recompute inside
the backward); else the autograd node the backward ran (an
``autograd::engine::evaluate_function`` range), whose forward op carries
the same sequence number and sits in a region range or in none, bucketed
as the op counter buckets it; else ``fwd_other``.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional

from repro_torch.launch.op_analysis import _BWD_BUCKET, BUCKETS, OpCost
from repro_torch.obs.regions import REGIONS

__all__ = ["BUCKETS", "KERNEL_FAMILIES", "flops_breakdown",
           "collective_breakdown_by_name", "report", "device_breakdown",
           "cpu_op_buckets", "is_kernel"]


def flops_breakdown(cost: OpCost) -> Dict[str, float]:
    """Product FLOPs by bucket (per rank)."""
    return {k: v for k, v in cost.flops_by_bucket.items() if v}


def collective_breakdown_by_name(cost: OpCost) -> Dict[str, float]:
    """Collective bytes by ``"<name> | <bucket> | <function>@<file>"``:
    the reference keys them by the op name's tail, here by the bucket and
    the function of the port that asked for the collective."""
    return dict(cost.collective_by_site)


def report(cost: OpCost, top: int = 15) -> str:
    """The reference's text report: FLOPs by bucket, then the largest
    collectives by name (per rank)."""
    lines = ["-- flops by bucket (per device) --"]
    fb = flops_breakdown(cost)
    tot = sum(fb.values()) or 1.0
    for k, v in sorted(fb.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {k:16s} {v:12.4e}  {v / tot * 100:5.1f}%")
    lines.append("-- collective bytes by op_name (per device) --")
    cb = collective_breakdown_by_name(cost)
    for k, v in sorted(cb.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {v / 2 ** 20:10.1f} MiB  {k}")
    return "\n".join(lines)


# ------------------------------------------------------- traced windows
# kernel families of a traced step, matched in order on the kernel's name;
# the attention kernels' pattern captures the kernel's short name
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

_EVALUATE = "autograd::engine::evaluate_function: "


def is_kernel(e) -> bool:
    """Whether profiler event ``e`` (a ``FunctionEvent``) counts as work on
    the card: a CUDA event, but not a region's range as the profiler
    repeats it on the card's timeline (a span over the region's
    kernels)."""
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA and e.name not in REGIONS


def _region_or_node(e):
    """The innermost region range (name) or backward node range (event)
    enclosing CPU event ``e``, or None."""
    p = e
    while p is not None:
        if p.name in REGIONS:
            return p.name
        if p.name.startswith(_EVALUATE):
            return p
        p = p.cpu_parent
    return None


def cpu_op_buckets(events) -> Dict[int, str]:
    """Per CPU event of a traced window (by ``id(event)``), its bucket by
    the module docstring's rule."""
    from torch.autograd import DeviceType
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    encl = {id(e): _region_or_node(e) for e in cpu}
    # the forward op that made each node: the last forward op that
    # recorded its sequence number (an op records the number the next
    # node will take; the op that takes it records it last)
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
            out[id(e)] = _BWD_BUCKET.get(fwd.get(key), "bwd_other")
    return out


def device_breakdown(events, skip: Optional[str] = None):
    """Device time of one traced window, in ms: per kernel family, each
    attention kernel's launches, the largest of the rest by name, busy
    time (the union of the kernels' intervals), the span from the first
    kernel's start to the last kernel's end, and per bucket (that of the
    runtime call that launched the kernel, :func:`cpu_op_buckets`; a
    kernel whose launch the window does not hold is ``unattributed``).
    Kernels whose name holds ``skip`` (a window's lead-in) are left
    out."""
    from torch.autograd import DeviceType
    kernels = [(e.name, e.time_range.start, e.time_range.end, e.id)
               for e in events if is_kernel(e)
               and not (skip and skip in e.name)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    families = dict.fromkeys([f for f, _ in KERNEL_FAMILIES] + ["other"],
                             0.0)
    attention, other = {}, {}
    for name, a, b, _ in kernels:
        ms = (b - a) / 1e3
        fam, hit = next(((f, m) for f, pat in KERNEL_FAMILIES
                         if (m := re.search(pat, name, re.I))),
                        ("other", None))
        families[fam] += ms
        if fam == "other":
            other[name] = other.get(name, 0.0) + ms
        elif hit.groups():
            attention.setdefault(hit.group(1), []).append(ms)
    busy, end = 0.0, -math.inf
    for _, a, b, _ in sorted(kernels, key=lambda x: x[1]):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = max(k[2] for k in kernels) - min(k[1] for k in kernels)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    op_bucket = cpu_op_buckets(events)
    launch = {e.id: e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("cu")}
    buckets = dict.fromkeys((*BUCKETS, "unattributed"), 0.0)
    for _, a, b, cid in kernels:
        call = launch.get(cid)
        buckets[op_bucket[id(call)] if call is not None
                else "unattributed"] += (b - a) / 1e3
    return dict(kernels=len(kernels), busy_ms=busy / 1e3,
                span_ms=span / 1e3, families=families, attention=attention,
                top_other=top, buckets=buckets)
