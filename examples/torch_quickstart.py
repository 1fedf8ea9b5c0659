"""Quickstart on the PyTorch port: core attention disaggregation in ~50
lines (the counterpart of ``examples/quickstart.py``).

Builds a packed two-rank batch, plans CA-tasks through a ``CADSession``
(the attention-service entry point: plan policies are selected by name),
dispatches them through the CAD runtime (every attention server of the
pool simulated in this process: the CA kernels on the card, their plain
versions on the CPU), and checks the result equals monolithic attention.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.cad import CADConfig, CADSession
from repro_torch.core.attention import ref_attention
from repro_torch.core.cost_model import CommModel
from repro_torch.core.dispatch import cad_attention
from repro_torch.models.model import resolve_device

BLK, D, S = 128, 2, 1024
ERR_BOUND = 1e-4


def packed_batch():
    """2 ranks x 1024 tokens, documents of 1-4 blocks (the reference's)."""
    rng = np.random.default_rng(0)
    segs = np.zeros((D, S), np.int32)
    poss = np.zeros((D, S), np.int32)
    sid = 1
    for r in range(D):
        t = 0
        while t < S:
            dl = min(int(rng.integers(1, 5)) * BLK, S - t)
            segs[r, t:t + dl] = sid
            poss[r, t:t + dl] = np.arange(dl)
            sid += 1
            t += dl
    return segs, poss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    segs, poss = packed_batch()

    # --- the attention service: pool geometry + plan policy by name ----
    nb = S // BLK
    session = CADSession(
        cfg=CADConfig(n_servers=D, blk=BLK, nb=nb, cq=nb, ckv=2 * nb,
                      nkv=4 * nb),
        plan_policy="balanced", tolerance=0.05, jmax=nb,
        comm=CommModel(n_heads=4, head_dim=64, n_kv_heads=2))

    plan, stats = session.plan(segs)          # one step's typed StepPlan
    print(f"planner[{session.plan_policy}]: {stats['n_moves']} migrations, "
          f"{stats['comm_bytes']/2**20:.2f} MiB moved, "
          f"straggler x{stats['load_max_over_mean']:.3f}")

    # --- dispatch through the CAD runtime, compare to monolithic CA ----
    ctx = session.context()
    ctx = ctx.cad.bind_plan(ctx, plan.to(dev))  # bind this step's plan

    gen = torch.Generator(device="cpu").manual_seed(0)
    q = torch.randn((D, S, 4, 64), generator=gen).to(dev)
    k = torch.randn((D, S, 2, 64), generator=gen).to(dev)
    v = torch.randn((D, S, 2, 64), generator=gen).to(dev)
    seg = torch.from_numpy(segs).to(dev)
    pos = torch.from_numpy(poss).to(dev)

    with torch.no_grad():
        out_cad = cad_attention(q, k, v, seg, pos, seg, pos, ctx=ctx)
        out_ref = ref_attention(q, k, v, seg, pos, seg, pos)
    err = float((out_cad - out_ref).abs().max())
    print(f"CAD == monolithic attention: max |err| = {err:.2e}")
    if not err < ERR_BOUND:
        raise SystemExit(f"CAD differs from monolithic attention by {err}")
    print("OK")
    return 0


if __name__ == "__main__":
    main()
