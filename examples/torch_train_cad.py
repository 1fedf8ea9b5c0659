"""End-to-end training driver on the PyTorch port (the counterpart of
``examples/train_cad.py``): train a ~100M-parameter llama-family model on
packed synthetic documents with CAD active: the scheduler balances
CA-tasks across a pool of attention servers (simulated in this process)
every step, exactly the production dataflow.

Run:  PYTHONPATH=src python examples/torch_train_cad.py --steps 300
Tiny: PYTHONPATH=src python examples/torch_train_cad.py --steps 20 --tiny \\
          [--device cpu]
"""
import argparse

from repro_torch.cad import CADSession, available_policies
from repro_torch.configs import ModelConfig
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.parallel import ParallelContext
from repro_torch.train.trainer import TrainConfig, train

# ~100M params: 12L, d=768, llama-style (GPT-2-small scale)
SMOL_100M = ModelConfig(
    arch_id="llama-100m", family="dense", source="examples/train_cad",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
    d_ff=2048, vocab_size=32000, layer_pattern=("global",),
    tie_embeddings=True, param_dtype="float32", compute_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced model for a fast smoke run")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--no-cad", action="store_true")
    ap.add_argument("--pingpong", action="store_true")
    ap.add_argument("--plan-policy", default="balanced",
                    choices=list(available_policies()))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = SMOL_100M.reduced() if args.tiny else SMOL_100M
    print(f"model: {cfg.arch_id} ({cfg.n_params()/1e6:.1f}M params)")
    pipe = PipelineConfig(distribution="pretrain",
                          max_doc_len=args.seq, seq_len=args.seq,
                          global_batch=args.batch, n_ranks=args.ranks,
                          vocab_size=cfg.vocab_size, seed=0)
    ctx = session = None
    if args.no_cad:
        ctx = ParallelContext(attn_impl="xla", remat=True)
    else:
        # one object owns pool geometry, ping-pong, tolerance and plan
        # policy; plans are prefetched one step ahead of the device
        session = CADSession.for_pipeline(cfg, pipe, pingpong=args.pingpong,
                                          plan_policy=args.plan_policy)
    res = train(cfg, pipe, TrainConfig(steps=args.steps, peak_lr=3e-4,
                                       warmup=min(50, args.steps // 5),
                                       log_every=max(1, args.steps // 20)),
                ctx=ctx, session=session, device=args.device)
    h = res["history"]
    print(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} over "
          f"{args.steps} steps")
    return 0


if __name__ == "__main__":
    main()
