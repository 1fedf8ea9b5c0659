"""Trainer: the host loop that owns the data pipeline, the CAD attention
service (plans prefetched asynchronously one step ahead — the paper's
"scheduler prefetches the upcoming batch"), the model on its device, the
optimizer and the metrics.  The port of ``repro.train.trainer``.

The reference's checkpoints (``ckpt_every``), calibration probes
(``calibrate_every``) and fault schedules (``fault_schedule``) are not
ported: ``checkpoint/ckpt.py`` comes with a later PR, the probes with
ROADMAP queue 1 item 7, the elastic runtime with item 8.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.cad.session import CADSession
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.model import Transformer, resolve_device
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.parallel import ParallelContext
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    peak_lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.1
    log_every: int = 10
    seed: int = 0                 # the model's weights when none is given


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, pipe_cfg: PipelineConfig, train_cfg: TrainConfig,
          ctx: Optional[ParallelContext] = None,
          model: Optional[Transformer] = None,
          session: Optional[CADSession] = None, device="cuda",
          on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None) \
        -> Dict[str, Any]:
    """Train ``cfg`` (a ModelConfig) on ``device`` (``cuda`` unless the
    caller asks for the CPU); returns the model, optimizer state and
    history.

    Pass ``session`` (a :class:`repro_torch.cad.CADSession`) to train with
    the attention service: the session provides the ParallelContext and
    attaches prefetched plans to every batch.  Without a session the loop
    trains on raw packed batches with ``ctx`` (default: the ``ref``
    oracle, since the reference's default ``xla`` path is not ported).
    ``model`` (a Transformer) is trained in place; without one, weights
    are drawn from ``train_cfg.seed``.  ``on_step(step, metrics)`` is
    called after every step with the metrics as floats, the step's
    host-clock seconds (``step_s``, ended by a device synchronize) and the
    schedule stats."""
    if model is None:
        model = Transformer(cfg, device=resolve_device(device),
                            seed=train_cfg.seed)
    dev = model.device
    if session is not None:
        ctx = session.context()
        gen = session.attach_plans(raw_batches(pipe_cfg))
    else:
        ctx = ctx or ParallelContext(attn_impl="ref", remat=True)
        gen = raw_batches(pipe_cfg)
    opt = AdamW(lr=cosine_schedule(train_cfg.peak_lr, train_cfg.warmup,
                                   train_cfg.steps),
                weight_decay=train_cfg.weight_decay)
    params = list(model.parameters())
    opt_state = opt.init(params)
    step_fn = make_train_step(model, ctx, opt)

    history = []
    t0 = time.time()
    try:
        for step in range(train_cfg.steps):
            batch = next(gen)
            stats = batch.pop("schedule_stats", None)
            _sync(dev)
            ts = time.perf_counter()
            opt_state, metrics = step_fn(opt_state, batch)
            _sync(dev)
            m = {k: float(v) for k, v in metrics.items()}
            m["step_s"] = time.perf_counter() - ts
            m["step"] = step
            m["wall_s"] = time.time() - t0
            if stats:
                m.update({f"sched_{k}": v for k, v in stats.items()})
            if on_step is not None:
                on_step(step, m)
            if step % train_cfg.log_every == 0 \
                    or step == train_cfg.steps - 1:
                history.append(m)
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} ({m['wall_s']:.1f}s)",
                      flush=True)
    finally:
        gen.close()      # stops the plan-prefetch worker, if any
    return {"model": model, "opt_state": opt_state, "history": history}
