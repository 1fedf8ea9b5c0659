"""Serving example on the PyTorch port (the counterpart of
``examples/serve_batch.py``): fused packed chunked prefill + continuous
batching on a reduced gemma2 (alternating local/global attention), plus
dense-batch decode on the attention-free state-space archs (mamba2 /
recurrentgemma) whose prompts stream per token (DESIGN.md §8).  On the
card the engine's attention runs in the ragged-decode kernel.

Run: PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Transformer, resolve_device
from repro_torch.serve import Engine, ServeConfig


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_continuous(dev, arch="gemma2-2b", slots=2, new_tokens=8):
    """6 ragged requests through 2 cache slots: fused chunked prefill,
    batched ragged decode, admission/eviction between steps."""
    cfg = get_config(arch).reduced()
    model = Transformer(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    lens = (9, 30, 5, 17, 3, 22)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    eng = Engine(model, ServeConfig(max_seq=64, max_new_tokens=new_tokens,
                                    chunk_tokens=128),
                 batch_size=slots, device=dev)
    t0 = time.time()
    results = eng.serve(prompts)
    _sync(dev)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in results.values())
    print(f"{arch:22s} continuous batching: {len(prompts)} ragged requests "
          f"(lens {lens}) through {slots} slots")
    print(f"{'':22s} {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s on {dev.type}); "
          f"events: {[e for e, _ in eng.last_trace]}")
    for rid in sorted(results):
        print(f"  req {rid} ({lens[rid]:2d} prompt toks):",
              results[rid].tolist())
    if n_tok != len(prompts) * new_tokens:
        raise SystemExit(f"{arch}: {n_tok} tokens served, "
                         f"{len(prompts) * new_tokens} asked for")


def run_static(dev, arch, batch=4, prompt_len=12, new_tokens=16):
    """Dense-batch generate: fused prefill where the arch supports it,
    per-token prefill (decode-mode chunks) otherwise."""
    cfg = get_config(arch).reduced()
    model = Transformer(cfg, device=dev, seed=0)
    eng = Engine(model, ServeConfig(max_seq=prompt_len + new_tokens + 1,
                                    max_new_tokens=new_tokens),
                 batch_size=batch, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, dtype=torch.int32)
    t0 = time.time()
    out = eng.generate(prompt.numpy())
    _sync(dev)
    dt = time.time() - t0
    mode = "fused prefill" if eng.fused_ok else "per-token prefill"
    print(f"{arch:22s} generated {tuple(out.shape)} in {dt:.1f}s "
          f"({batch * new_tokens / dt:.1f} tok/s on {dev.type}, {mode})")
    print("  first row:", out[0].tolist())
    if tuple(out.shape) != (batch, new_tokens) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise SystemExit(f"{arch}: generated {tuple(out.shape)}, tokens "
                         f"outside the vocabulary or missing")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run_continuous(dev)
    for arch in ("gemma2-2b", "mamba2-370m", "recurrentgemma-9b"):
        run_static(dev, arch)
    return 0


if __name__ == "__main__":
    main()
