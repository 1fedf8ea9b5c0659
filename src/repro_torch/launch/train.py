"""Training launcher for the port: one card, or the CPU when asked for.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch smollm-360m-reduced --steps 3 --seq 256 --batch 4 --ranks 2 \\
      --cad --device cpu

The port of ``repro.launch.train`` with the reference's flags: --cad
(core attention disaggregation on/off), --plan-policy (identity |
per_doc_cp | balanced | ring), --pingpong (nano-batch split), --tolerance
(scheduler imbalance budget), --prefetch (async plan look-ahead; 0 =
synchronous), --strategy fixed|variable (packing baseline),
--server-speeds (heterogeneous pool: comma-separated per-rank speed
factors), --server-hbm (per-rank HBM budgets in bytes), --stream-chunk
(kv blocks a streamed serve holds at once), --calibrate (runtime
cost-model calibration: each server's batch is probed every
--calibrate-every steps and the timings fed back, so later batches are
planned from measured costs), --mask
(attention task shape beyond dense causal: "sliding:window=256,sink=16"
or "dilated:rate=4"), --fault-schedule (elastic pool membership: a
deterministic FaultSchedule spec like "kill:1@5" or "flap:0@3+2,
slow:2x4@4-8" — killed/drained servers are excluded from subsequent
plans and flapped servers rejoin, DESIGN.md §9), --speculate-pct
(straggler-speculation percentile for the elastic executor),
--ckpt-dir/--ckpt-every (checkpoints of the model, the optimizer and the
calibration), --trace/--trace-capacity (a Chrome-trace JSON of the run,
one track per attention server, read by
``python -m repro_torch.launch.trace_report``) and --metrics (the
metrics registry's JSON at exit).  ``--device`` (default ``cuda``) picks
the card; without one, ``cuda`` raises.  Without --cad the model trains with
colocated blockwise ``xla`` attention, as in the reference; an
attention-free arch (mamba2-370m) trains the same way with --cad, after
the reference's note that CAD does not apply, its SSD layers on the
einsum route in torch ops.  recurrentgemma trains as the reference's
launcher trains it: its rglru layers run the plain recurrence in torch
ops with or without --cad (the ``lru_scan`` kernels are the ``pallas``
route, which the launcher does not pick), and with --cad its local
layers, all windowed, take the dispatch's blockwise fallback.  The MoE
archs (qwen2-moe-a2.7b, llama4-maverick-400b-a17b, and their -reduced
widths) train with their auxiliary losses in the loss, logged beside it;
under ``torchrun`` each rank routes its own tokens, and an arch with
expert parallelism (maverick) routes globally over experts split across
the ranks.  The reference's --kernel is
not carried over: CUDA tensors run the hand-written kernels.

Across processes, one rank per attention server::

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm-360m-reduced --steps 3 --seq 256 --batch 8 --ranks 4 \
      --cad --device cpu

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) each process joins
the group (gloo for ``--device cpu``, NCCL on ``cuda:LOCAL_RANK``
otherwise; ``launch/mesh.py``), reads the same global batches, trains its
rows and exchanges q/kv blocks and outputs with the other ranks; rank 0
prints (the pool lines and the step lines) and writes checkpoints,
traces and metrics.  ``--ranks`` must equal ``WORLD_SIZE`` there, and
--cad is required.  --calibrate and --calibrate-every (each rank probes
its own server in turn; the timings are gathered, so every rank plans
from the same calibration), --fault-schedule (every rank applies the
membership events at the same step; a killed server's rank trains its
rows and serves no task), --stream-chunk and --server-hbm (the plans;
the ranks serve unstreamed, as the reference's mesh path does) work
under ``torchrun`` as in one process.  Without ``torchrun``
the launcher keeps the single-process simulated pool.

``--model-axis M`` lays the ranks out as a ``--ranks x M`` grid
(``launch/mesh.py::join_grid``; ``WORLD_SIZE`` must be ``ranks x M``):
each model index's ``--ranks`` ranks are a CAD group, and the M ranks of
a data index split the heads, FFN columns, expert width, vocabulary and
residual sequence between them (tensor parallelism, the reference's
``"model"`` axis), an expert-parallel arch's experts split over the data
ranks, and every other tensor's ``dmodel`` dim over the data ranks (FSDP
storage, gathered where a layer reads it)::

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm-360m-reduced --steps 3 --seq 256 --batch 4 --ranks 2 \
      --model-axis 2 --cad --device cpu

Every layer kind splits: ssd (mamba2-370m; attention-free, so the grid
trains without --cad, colocated), rglru (recurrentgemma-9b), and the
cross-attention and encoder layers (whisper-large-v3,
llama-3.2-vision-11b).  --calibrate, --fault-schedule and --ckpt-every
work on a grid as under a group: the model index 0 ranks probe, every
rank applies the membership events at the same step, and rank 0 writes
each checkpoint whole, in one process's layout.  Without --cad a grid
trains colocated (``xla``).

An arch that reads a memory (whisper-large-v3, llama-3.2-vision-11b) is
given a stub one, seeded as the weights are: frame or patch embeddings of
``encoder.n_ctx`` rows a batch row (``stub_memory``).
"""
import argparse
import json
import os

import torch

from repro_torch.cad import CADSession, available_policies
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.launch import mesh
from repro_torch.models.model import needs_memory, resolve_device
from repro_torch.obs import enable_tracing, get_recorder, get_registry
from repro_torch.parallel import ParallelContext
from repro_torch.train.trainer import TrainConfig, train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel ranks a data rank (under "
                         "torchrun, WORLD_SIZE = ranks x model-axis)")
    ap.add_argument("--max-doc", type=int, default=0)
    ap.add_argument("--dist", default="pretrain",
                    choices=["pretrain", "prolong"])
    ap.add_argument("--strategy", default="fixed",
                    choices=["fixed", "variable"])
    ap.add_argument("--cad", action="store_true")
    ap.add_argument("--plan-policy", default="balanced",
                    choices=list(available_policies()))
    ap.add_argument("--pingpong", action="store_true")
    ap.add_argument("--tolerance", type=float, default=0.1)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="plan look-ahead depth (0 = synchronous)")
    ap.add_argument("--server-speeds", default="",
                    help="comma-separated per-rank speed factors "
                         "(heterogeneous pool), e.g. '1,0.5'")
    ap.add_argument("--server-hbm", default="",
                    help="comma-separated per-rank HBM budgets in bytes")
    ap.add_argument("--mask", default="",
                    help="attention task shape (DESIGN.md §12): 'causal' "
                         "(default), 'sliding:window=N[,sink=M]', "
                         "'dilated:rate=R'")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    ap.add_argument("--calibrate", action="store_true",
                    help="runtime cost-model calibration: probe "
                         "per-server kernel times and re-plan from them")
    ap.add_argument("--calibrate-every", type=int, default=5,
                    help="steps between calibration probes")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="kv blocks resident per streamed chunk; "
                         "0 = no streaming")
    ap.add_argument("--fault-schedule", default="",
                    help="deterministic fault injection spec, e.g. "
                         "'kill:1@5' or 'flap:0@3+2,slow:2x4@4-8' "
                         "(elastic pool membership, DESIGN.md §9)")
    ap.add_argument("--speculate-pct", type=float, default=0.0,
                    help="straggler-speculation deadline percentile "
                         "(0 = off; task-level speculation runs in the "
                         "elastic executor)")
    ap.add_argument("--ckpt-dir", default=TrainConfig().ckpt_dir,
                    help="checkpoint directory (default: %(default)s)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a checkpoint every N steps (0 = never)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "to this path (one track per attention server; "
                         "DESIGN.md §14)")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="trace ring-buffer capacity (oldest events "
                         "are overwritten past it)")
    ap.add_argument("--metrics", default="",
                    help="write the metrics-registry JSON snapshot "
                         "(counters/gauges/histograms) to this path "
                         "at exit")
    return ap.parse_args(argv)


def _per_rank(text, ranks, flag):
    if not text:
        return None
    vals = tuple(float(s) for s in text.split(","))
    if len(vals) != ranks:
        raise SystemExit(f"{flag} needs {ranks} entries, got {len(vals)}")
    return vals


def _join(args):
    """Under torchrun: join the CAD group, or the ``--ranks x
    --model-axis`` grid; returns (RankInfo, GridInfo or None, the
    training device)."""
    if not mesh.launched_by_torchrun():
        if args.model_axis > 1:
            raise SystemExit("--model-axis needs a process a rank: run "
                             "under torchrun")
        return None, resolve_device(args.device)
    if not args.cad and args.model_axis == 1:
        raise SystemExit("under torchrun the launcher trains with --cad "
                         "(the ranks are the attention servers) or on a "
                         "grid (--model-axis > 1)")
    world = int(os.environ["WORLD_SIZE"])
    if args.ranks * args.model_axis != world:
        raise SystemExit(f"--ranks {args.ranks} x --model-axis "
                         f"{args.model_axis} != WORLD_SIZE {world}")
    dev = resolve_device(args.device).type
    if args.model_axis > 1:
        info = mesh.join_grid(args.ranks, args.model_axis, dev)
    else:
        info = mesh.join_group(dev)
    return info, info.device


def stub_memory(cfg, rows: int, seed: int) -> torch.Tensor:
    """A seeded memory ``[rows, encoder.n_ctx, d_model]`` f32 on the CPU:
    0.02 x (a normal vector each row's frames share + a normal vector
    each frame), the frame or patch embeddings an arch with
    cross-attention reads in place of real audio or images."""
    gen = torch.Generator().manual_seed(seed)
    shared = torch.randn((rows, 1, cfg.d_model), generator=gen)
    frames = torch.randn((rows, cfg.encoder.n_ctx, cfg.d_model),
                         generator=gen)
    return (shared + frames) * 0.02


def main(argv=None):
    args = parse_args(argv)
    info, device = _join(args)
    try:
        return _main(args, info, device)
    finally:
        if info is not None:
            mesh.leave_group()


def _main(args, info, device):
    lead = info is None or info.rank == 0
    grid = info if isinstance(info, mesh.GridInfo) else None
    if args.trace and lead:
        enable_tracing(capacity=args.trace_capacity)
    cfg = get_config(args.arch)
    if lead:
        print(f"arch={cfg.arch_id} params={cfg.n_params()/1e6:.1f}M "
              f"family={cfg.family} device={device}"
              + ("" if info is None else f" ranks={info.world}")
              + ("" if grid is None else
                 f" grid={grid.data}x{grid.model}"))
    pipe = PipelineConfig(
        distribution=args.dist, max_doc_len=args.max_doc or args.seq,
        seq_len=args.seq, global_batch=args.batch, n_ranks=args.ranks,
        vocab_size=cfg.vocab_size, strategy=args.strategy)
    speeds = _per_rank(args.server_speeds, args.ranks, "--server-speeds")
    hbm = _per_rank(args.server_hbm, args.ranks, "--server-hbm")
    session = None
    ctx = None
    if args.cad and cfg.has_attention():
        session = CADSession.for_pipeline(
            cfg, pipe, pingpong=args.pingpong, tolerance=args.tolerance,
            plan_policy=args.plan_policy, prefetch=args.prefetch,
            server_speeds=speeds, server_hbm=hbm,
            stream_chunk=args.stream_chunk, calibrate=args.calibrate,
            mask=args.mask or None,
            group=None if info is None or grid else info.group, grid=grid)
    else:
        if args.cad:
            print(f"note: {cfg.arch_id} is attention-free; CAD is "
                  f"inapplicable (DESIGN.md §5) — training without it")
        if speeds or hbm or args.mask or args.calibrate \
                or args.stream_chunk or args.fault_schedule:
            print("note: --server-speeds/--server-hbm/--mask/--calibrate/"
                  "--stream-chunk/--fault-schedule only apply to the CAD "
                  "attention service — ignored")
        ctx = ParallelContext(attn_impl="xla", remat=True)
        if info is not None and grid is None:
            raise SystemExit(f"{cfg.arch_id} has no attention for the "
                             f"ranks to serve: no CAD group to train in "
                             f"(a grid, --model-axis > 1, trains it)")
    tc = TrainConfig(steps=args.steps, peak_lr=args.lr,
                     warmup=max(1, args.steps // 10),
                     log_every=max(1, args.steps // 20),
                     ckpt_every=args.ckpt_every,
                     calibrate_every=args.calibrate_every
                     if args.calibrate else 0,
                     fault_schedule=args.fault_schedule
                     if session is not None else "",
                     ckpt_dir=args.ckpt_dir,
                     speculate_pct=args.speculate_pct)
    memory = stub_memory(cfg, args.batch, tc.seed) \
        if needs_memory(cfg) else None
    res = train(cfg, pipe, tc, ctx=ctx, session=session, device=device,
                grid=None if session is not None else grid, memory=memory)
    h = res["history"]
    if not lead:
        return res
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")
    if args.trace:
        rec = get_recorder()
        # under a profiler, the clock anchor places the file on its trace
        rec.save(args.trace, anchor=rec.clock_anchor())
        print(f"trace: {len(rec)} events -> {args.trace} "
              f"({rec.n_dropped} dropped)")
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(get_registry().to_dict(), f, indent=2)
        print(f"metrics: -> {args.metrics}")
    return res


if __name__ == "__main__":
    main()
