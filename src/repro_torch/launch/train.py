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
factors), --server-hbm (per-rank HBM budgets in bytes), --mask
(attention task shape beyond dense causal: "sliding:window=256,sink=16"
or "dilated:rate=4").  ``--device`` (default ``cuda``) picks the card;
without one, ``cuda`` raises.  Without --cad the model trains with the
``ref`` attention oracle, since the reference's default ``xla`` path is
not ported.  The reference's --kernel is not carried over: CUDA tensors
run the hand-written kernels.  --calibrate, --stream-chunk,
--fault-schedule, --ckpt-dir/--ckpt-every and --trace are accepted and
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""
import argparse

from repro_torch.cad import CADSession, available_policies
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.models.model import resolve_device
from repro_torch.parallel import ParallelContext
from repro_torch.train.trainer import TrainConfig, train

NOT_PORTED = {
    "calibrate": "runtime calibration probes come with ROADMAP queue 1 "
                 "item 7",
    "stream_chunk": "chunked KV streaming comes with ROADMAP queue 1 item 7",
    "fault_schedule": "fault schedules need the elastic runtime, ROADMAP "
                      "queue 1 item 8",
    "ckpt_dir": "checkpoints (checkpoint/ckpt.py) come with a later PR of "
                "the port",
    "ckpt_every": "checkpoints (checkpoint/ckpt.py) come with a later PR "
                  "of the port",
    "trace": "trace export of the training run (launch/trace_report.py) "
             "comes with ROADMAP queue 1 item 8",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=2)
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
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--stream-chunk", type=int, default=0)
    ap.add_argument("--fault-schedule", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--trace", default="")
    return ap.parse_args(argv)


def _per_rank(text, ranks, flag):
    if not text:
        return None
    vals = tuple(float(s) for s in text.split(","))
    if len(vals) != ranks:
        raise SystemExit(f"{flag} needs {ranks} entries, got {len(vals)}")
    return vals


def main(argv=None):
    args = parse_args(argv)
    for name, why in NOT_PORTED.items():
        if getattr(args, name):
            raise NotImplementedError(f"--{name.replace('_', '-')}: {why}")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    print(f"arch={cfg.arch_id} params={cfg.n_params()/1e6:.1f}M "
          f"family={cfg.family} device={device}")
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
            server_speeds=speeds, server_hbm=hbm, mask=args.mask or None)
    else:
        if speeds or hbm or args.mask:
            print("note: --server-speeds/--server-hbm/--mask only apply "
                  "to the CAD attention service — ignored")
        ctx = ParallelContext(attn_impl="ref", remat=True)
    tc = TrainConfig(steps=args.steps, peak_lr=args.lr,
                     warmup=max(1, args.steps // 10),
                     log_every=max(1, args.steps // 20))
    res = train(cfg, pipe, tc, ctx=ctx, session=session, device=device)
    h = res["history"]
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")
    return res


if __name__ == "__main__":
    main()
