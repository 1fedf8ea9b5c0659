"""A traced window reduced to what the per-layer metrics read."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from cadbench.frozen import trace as ftrace
from cadbench.frozen.data import segment_lengths


@dataclasses.dataclass
class Records:
    shape: Dict                 # the configuration's shape
    kernels: List[dict]         # frozen.trace.kernel_records
    window_s: float             # host clock, synchronize to synchronize
    steps: List[dict]           # per traced step: tokens, segments,
                                # fwd_passes (layer forwards it ran)
    busy_s: float = 0.0
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)


def step_records(obs, expected, steps) -> List[dict]:
    return [{"tokens": int((expected[k]["segment_ids"] > 0).sum()),
             "segments": segment_lengths(expected[k]["segment_ids"]),
             "fwd_passes": obs.fwd_passes[k]} for k in steps]


def from_trace(cell, obs, expected) -> Records:
    from torch.autograd import DeviceType
    events = obs.profile.events()
    kernels = ftrace.kernel_records(events)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    by_name: Dict[str, float] = {}
    for k in kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) \
            + (k["end"] - k["start"]) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Records(
        shape=cell["config_file"]["shape"], kernels=kernels,
        window_s=obs.window_end - obs.window_start,
        steps=step_records(obs, expected, obs.window_steps),
        busy_s=ftrace.busy_us(kernels) / 1e6,
        device_ops=[[n, s] for n, s in top],
        idle_gaps=ftrace.idle_gaps(kernels, cpu))
