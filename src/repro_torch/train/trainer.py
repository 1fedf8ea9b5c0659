"""Trainer: the host loop that owns the data pipeline, the CAD attention
service (plans prefetched asynchronously one step ahead — the paper's
"scheduler prefetches the upcoming batch"), the model on its device, the
optimizer, checkpointing, the metrics, the runtime calibration probes
(``calibrate_every``) and the fault schedule's membership events
(``fault_schedule``).  The port of ``repro.train.trainer``.

With a session over a CAD process group (``CADSession.for_pipeline(...,
group=g)``) every rank runs this loop on its rows of the same global
batches: the parameters start from rank 0's, the gradients are summed
across the ranks before each update, rank 0 alone logs and writes
checkpoints, every rank synchronizes its own device around a step, and
tokens/s counts the global batch.  Every rank applies the fault
schedule's membership events at the same step and probes its own server
in turn (``CADSession.observe_probe`` gathers the timings), so every
rank plans every step from the same pool epoch and calibration snapshot.
A killed server's rank goes on training its rows; it serves no task.

With a session on a ``("data", "model")`` grid (``for_pipeline(...,
grid=g)``), or with ``grid=g`` and no session (colocated attention, an
attention-free arch), the CAD group is the grid's ``"data"`` sub-group
and the model is cut to this rank's shards (``convert.shard_model``, the
FSDP data axes included) before training; the model ranks of a data rank
train its rows together.  Every rank of the grid plans every step alike:
the model index 0 ranks probe their data group's servers in turn and the
timings reach every model rank (``CADSession.observe_probe``), every
rank applies the fault schedule at the same step (a killed server is a
data index, whose model ranks train their rows and serve no task), and
rank 0 of the world writes each checkpoint, the tensors gathered whole
from every rank's shards, in the layout one process writes.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.cad.session import CADSession
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import (PipelineConfig, global_token_count,
                                       raw_batches, rank_rows)
from repro_torch.models.convert import decay_mask, gather_shard, shard_model
from repro_torch.models.model import Transformer, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.parallel import ParallelContext, make_rules, sharded_over
from repro_torch.train.step import TRACK, broadcast_params, make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    peak_lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.1
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    seed: int = 0                 # the model's weights when none is given
    calibrate_every: int = 0      # probe + feed CA timings every N steps
                                  # (0 = off; needs a session calibrator)
    fault_schedule: str = ""      # FaultSchedule spec applied to the
                                  # session's ServerPool (one is attached
                                  # if missing): membership events take
                                  # effect at step granularity here —
                                  # a killed server is excluded from the
                                  # next plan; prefetched plans from the
                                  # dead epoch re-plan at pull
    speculate_pct: float = 0.0    # straggler-speculation percentile;
                                  # consumed by the task-level elastic
                                  # executor — the fused path only
                                  # records it


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _grid_rows(batches, grid):
    """A sessionless grid's batches: this rank's data index's rows of each
    global batch, with the batch's loss-token count."""
    for batch in batches:
        out = rank_rows(batch, grid.data_index, grid.data)
        out["n_tokens_global"] = global_token_count(batch)
        yield out


def _whole_state(model, opt_state, grid):
    """The grid's parameters and AdamW state gathered whole from every
    rank's shards (collectives on every rank), on the host, under the
    names and in the order of a one-process model's: what a checkpoint
    holds."""
    groups = {"data": grid.data_group, "model": grid.model_group}
    placed = model.grid_placements
    names = [n for n, _ in model.named_parameters()]

    def whole(ts):
        return [gather_shard(t.detach(), placed[n], groups).cpu()
                for n, t in zip(names, ts)]
    params = dict(zip(names, whole(model.parameters())))
    return params, AdamWState(step=opt_state.step, mu=whole(opt_state.mu),
                              nu=whole(opt_state.nu))


def train(cfg, pipe_cfg: PipelineConfig, train_cfg: TrainConfig,
          ctx: Optional[ParallelContext] = None,
          model: Optional[Transformer] = None,
          session: Optional[CADSession] = None, device="cuda",
          on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
          grid=None, memory: Optional[torch.Tensor] = None) \
        -> Dict[str, Any]:
    """Train ``cfg`` (a ModelConfig) on ``device`` (``cuda`` unless the
    caller asks for the CPU); returns the model, optimizer state and
    history.

    Pass ``session`` (a :class:`repro_torch.cad.CADSession`) to train with
    the attention service: the session provides the ParallelContext and
    attaches prefetched plans to every batch.  Without a session the loop
    trains on raw packed batches with ``ctx`` (default: blockwise ``xla``
    attention with remat, as in the reference); an attention-free model
    (mamba2) trains with any ``ctx``, its SSD layers in the CUDA kernels
    under ``attn_impl="pallas"`` and on the einsum route otherwise.
    ``model`` (a Transformer) is trained in place; without one, weights
    are drawn from ``train_cfg.seed``.  ``on_step(step, metrics)`` is
    called after every step with the metrics as floats, the step's
    host-clock seconds (``step_s``, ended by a device synchronize) and the
    schedule stats.

    With ``train_cfg.calibrate_every`` > 0 and a session calibrator, every
    that many steps the step's plan is probed after the step (seeded q/k/v
    in the model's compute dtype on its device, each server's batch
    timed) and the timings fed back, so later batches plan from measured
    costs (DESIGN.md §3).

    With ``train_cfg.fault_schedule`` (a CAD session only) the session
    gets a :class:`~repro_torch.runtime.ServerPool` when it has none, and
    before each step the schedule's membership events are applied to it:
    a killed or drained server is excluded from the plans from that step
    on, prefetched plans of an older epoch are re-planned at pull, and
    the step's metrics carry ``pool_events``.  Every ``ckpt_every`` steps
    the model's tensors, the optimizer state and the calibrator's state
    are saved into ``ckpt_dir``; a calibrator starts from the newest
    checkpoint's calibration state.  Like the reference, the loop does
    not resume the parameters.

    ``grid`` (a :class:`~repro_torch.launch.mesh.GridInfo`, without a
    session) trains on a ``("data", "model")`` grid with ``ctx``'s
    attention route: each data index takes its rows of every batch.
    ``memory`` [global rows, M, d_model] is the memory a cross-attention
    arch reads (stub frame or patch embeddings), each rank's rows added
    to its batches.

    Traced (DESIGN.md §14): each iteration is a ``train.step`` span on the
    ``train`` track, holding ``train.batch_wait`` (``next`` on the batch
    stream, the plan wait and the plan agreement included, up to the
    synchronize before the step), the step's
    own spans (``make_train_step``) and ``train.readback`` (the
    synchronize and the metrics' reads), all with the batch's index in
    the stream as their step; the wait and the readback also enter
    profiler ranges while a profiler runs."""
    if session is not None:
        grid = session.grid
    if model is None:
        model = Transformer(cfg, device=resolve_device(device),
                            seed=train_cfg.seed)
    if grid is not None and getattr(model, "grid_placements", None) is None:
        shard_model(model, grid.sizes, {"data": grid.data_index,
                                        "model": grid.model_index})
    dev = model.device
    faults = pool = None
    group = None if session is None else session.group
    rank = 0 if group is None else dist.get_rank(group)
    if grid is not None:
        group, rank = grid.data_group, grid.rank
    if session is not None:
        if train_cfg.fault_schedule:
            from repro_torch.runtime import FaultSchedule, ServerPool
            faults = FaultSchedule.parse(train_cfg.fault_schedule)
            if session.pool is None:
                session = session.with_pool(ServerPool(
                    session.cfg.n_servers,
                    calibrator=session.calibrator))
            if train_cfg.speculate_pct > 0 and rank == 0:
                print("note: --speculate-pct drives task-level "
                      "speculation in the elastic executor "
                      "(runtime.ElasticExecutor); the fused train step "
                      "applies membership events only")
        pool = session.pool
        ctx = session.context()
        gen = session.attach_plans(raw_batches(pipe_cfg))
    else:
        ctx = ctx or ParallelContext(attn_impl="xla", remat=True)
        gen = raw_batches(pipe_cfg)
        if grid is not None:
            ctx = dataclasses.replace(
                ctx, group=grid.data_group, model_group=grid.model_group,
                rules=make_rules(grid.sizes, cfg))
            gen = _grid_rows(gen, grid)
    if memory is not None and group is not None:
        rows = memory.shape[0] // dist.get_world_size(group)
        memory = memory[dist.get_rank(group) * rows:][:rows]
    opt = AdamW(lr=cosine_schedule(train_cfg.peak_lr, train_cfg.warmup,
                                   train_cfg.steps),
                weight_decay=train_cfg.weight_decay)
    params = list(model.parameters())
    if group is not None:
        # one set of weights over the data ranks (on a grid the
        # expert-parallel experts are each data rank's own)
        placed = getattr(model, "grid_placements", {})
        broadcast_params([p for n, p in model.named_parameters()
                          if "data" not in sharded_over(placed.get(n, ()))],
                         group)
    opt_state = opt.init(params)
    tokens = pipe_cfg.global_batch * pipe_cfg.seq_len
    step_fn = make_train_step(model, ctx, opt, decay_mask(model))
    calibrating = (session is not None and session.calibrator is not None
                   and train_cfg.calibrate_every > 0)
    if session is not None and session.calibrator is not None \
            and train_cfg.ckpt_every:
        # calibration survives restarts: pick up the measured grid from
        # the newest checkpoint (no-op when none carries calibration)
        if group is not None:
            # rank 0 alone writes: every rank reads a whole checkpoint
            dist.barrier(group=None if grid is not None else group)
        last = ckpt.latest_step(train_cfg.ckpt_dir)
        if last is not None and ckpt.restore_calibration(
                train_cfg.ckpt_dir, last, session.calibrator) and rank == 0:
            print(f"restored calibration state from step {last}")

    history = []
    t0 = time.time()
    rec = obs_trace.get_recorder()
    try:
        for step in range(train_cfg.steps):
            with rec.span("train.step", TRACK, step=step):
                pool_events = []
                if faults is not None:
                    # membership events land at step granularity on
                    # the fused path: the planner is re-invoked against
                    # the survivors and stale prefetched plans re-plan at
                    # pull (kills apply before the step — the fused step
                    # cannot lose a server mid-flight; same shared
                    # semantics as the elastic executor)
                    pool_events = faults.apply_pre_step(pool, step) \
                        + faults.apply_failures(pool, step)
                    if pool_events and rank == 0:
                        print(f"step {step:5d} pool: "
                              f"{', '.join(pool_events)} "
                              f"(epoch {pool.epoch})", flush=True)
                with rec.span("train.batch_wait", TRACK, step=step,
                              profiled=True):
                    batch = next(gen)
                    if memory is not None:
                        batch["memory"] = memory
                    stats = batch.pop("schedule_stats", None)
                    plan = batch.get("plan") if calibrating else None
                    _sync(dev)
                ts = time.perf_counter()
                opt_state, metrics = step_fn(opt_state, batch, step=step)
                with rec.span("train.readback", TRACK, step=step,
                              profiled=True):
                    _sync(dev)
                    m = {k: float(v) for k, v in metrics.items()}
                m["step_s"] = time.perf_counter() - ts
                m["tokens_per_s"] = tokens / m["step_s"]
                if plan is not None \
                        and step % train_cfg.calibrate_every == 0:
                    # measure -> fit: the per-server timings feed the
                    # calibrator, so the (prefetched) plan of a later
                    # batch is built from them (under a group each rank
                    # times its own server and every rank feeds all the
                    # timings)
                    session.observe_probe(plan, seed=train_cfg.seed + step,
                                          dtype=model.cfg.cdtype,
                                          device=dev)
                m["step"] = step
                m["wall_s"] = time.time() - t0
                if stats:
                    m.update({f"sched_{k}": v for k, v in stats.items()})
                if pool_events:
                    m["pool_events"] = ";".join(pool_events)
                if on_step is not None:
                    on_step(step, m)
                if step % train_cfg.log_every == 0 \
                        or step == train_cfg.steps - 1:
                    history.append(m)
                    if rank == 0:
                        aux = "".join(f" {k} {m[k]:.4e}" for k in
                                      ("moe_lb", "moe_z") if k in m)
                        print(f"step {step:5d} loss {m['loss']:.4f} "
                              f"gnorm {m['grad_norm']:.3f}{aux} "
                              f"({m['wall_s']:.1f}s)", flush=True)
                if train_cfg.ckpt_every and step and \
                        step % train_cfg.ckpt_every == 0:
                    params, saved = model.state_dict(), opt_state
                    if grid is not None:
                        params, saved = _whole_state(model, opt_state,
                                                     grid)
                    ckpt.save(train_cfg.ckpt_dir, step, params, saved,
                              calibrator=None if session is None
                              else session.calibrator, rank=rank)
                    del params, saved
                    if group is not None:
                        # rank 0 alone writes: no rank reads the
                        # checkpoint (a restart's calibration) before it
                        # is whole
                        dist.barrier(group=None if grid is not None
                                     else group)
    finally:
        gen.close()      # stops the plan-prefetch worker, if any
    return {"model": model, "opt_state": opt_state, "history": history}
