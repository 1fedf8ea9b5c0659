"""Elastic training demo on the PyTorch port (the counterpart of
``examples/elastic_train.py``): lose an attention server mid-run, keep
going.

Trains a tiny llama-family model with CAD active on a pool of attention
servers and, via a deterministic ``FaultSchedule``, kills one server
halfway through.  The pool's membership epoch bumps, the planner is
re-invoked against the survivors (any prefetched plan from the dead epoch
is re-planned at pull), and training finishes every configured step with
a finite loss.  Flap the server instead with ``--flap`` to watch it
rejoin a few steps later.

Run:  PYTHONPATH=src python examples/torch_elastic_train.py [--device cpu]
      PYTHONPATH=src python examples/torch_elastic_train.py --steps 12 --flap
"""
import argparse
import math

from repro_torch.cad import CADSession
from repro_torch.configs import ModelConfig
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.runtime import ServerPool
from repro_torch.train.trainer import TrainConfig, train

TINY = ModelConfig(
    arch_id="llama-tiny-elastic", family="dense",
    source="examples/elastic_train",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, layer_pattern=("global",),
    tie_embeddings=True, param_dtype="float32",
    compute_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--victim", type=int, default=1)
    ap.add_argument("--flap", action="store_true",
                    help="kill + rejoin instead of a permanent kill")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    kill_step = max(1, args.steps // 2)
    spec = (f"flap:{args.victim}@{kill_step}+2" if args.flap
            else f"kill:{args.victim}@{kill_step}")
    print(f"model: {TINY.arch_id} | pool: {args.ranks} servers | "
          f"fault schedule: {spec}")

    pipe = PipelineConfig(distribution="pretrain", max_doc_len=args.seq,
                          seq_len=args.seq, global_batch=2 * args.ranks,
                          n_ranks=args.ranks, vocab_size=TINY.vocab_size,
                          seed=0)
    session = CADSession.for_pipeline(TINY, pipe, plan_policy="balanced")
    session = session.with_pool(ServerPool(session.cfg.n_servers))

    res = train(TINY, pipe, TrainConfig(
        steps=args.steps, peak_lr=1e-3, warmup=1, log_every=1,
        fault_schedule=spec), session=session, device=args.device)

    h = res["history"]
    if len(h) != args.steps:
        raise SystemExit("training must finish every step")
    if not all(math.isfinite(m["loss"]) for m in h):
        raise SystemExit("every step's loss must be finite")
    epochs = sorted({m.get("sched_pool_epoch", 0.0) for m in h})
    print(f"finished {args.steps}/{args.steps} steps | "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} | "
          f"pool epochs seen: {[int(e) for e in epochs]}")
    print(f"membership log: {session.pool.history()}")
    return 0


if __name__ == "__main__":
    main()
