"""Serving subsystem (DESIGN.md §8): fused packed chunked prefill, the
ragged cache-attention kernel path, and host-side continuous batching.

  engine     — Engine / ServeConfig: device loop over two shapes
               (prefill chunk, decode batch)
  scheduler  — ContinuousScheduler: admission / chunk packing / eviction
"""
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import (ContinuousScheduler, PrefillChunk,
                                         Request, SchedulerConfig)

__all__ = ["Engine", "ServeConfig", "ContinuousScheduler", "PrefillChunk",
           "Request", "SchedulerConfig"]
