"""Explore the communication-aware greedy scheduler (paper §4.2) on the
PyTorch port's planner (the counterpart of
``examples/schedule_explore.py``; host numpy, as the reference's).

Samples packed batches from the Pretrain/ProLong distributions, runs the
scheduler at several tolerance factors, and prints per-server loads,
migrations, and comm volume: an ASCII version of paper Fig. 12.  Also
compares the registered plan policies (identity / per_doc_cp / balanced
/ ring) head-to-head through the repro_torch.cad registry.  The planner
runs on the host, so ``--device`` (cuda by default) is only checked.

Run: PYTHONPATH=src python examples/torch_schedule_explore.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.cad import (CADConfig, PlanCapacityError, available_policies,
                             get_planner)
from repro_torch.configs import get_config
from repro_torch.core.cost_model import CommModel
from repro_torch.core.scheduler import Caps, imbalance, schedule
from repro_torch.data.distributions import sample_lengths
from repro_torch.data.packing import BLOCK, pack_documents
from repro_torch.models.model import resolve_device

ARCH = "llama3-8b"
N_RANKS = 8
TOKENS_PER_RANK = 65536
MAX_DOC = 65536


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = get_config(ARCH)
    comm = CommModel(cfg.n_heads, cfg.head_dim, cfg.n_kv_heads)
    rng = np.random.default_rng(0)

    for dist in ("pretrain", "prolong"):
        lens = []
        while sum(lens) < N_RANKS * TOKENS_PER_RANK * 1.2:
            lens.extend(sample_lengths(dist, rng, 64, MAX_DOC).tolist())
        chunks = pack_documents(lens, TOKENS_PER_RANK, N_RANKS, rng=rng)
        segs = np.stack([c.segment_ids for c in chunks])
        nb = TOKENS_PER_RANK // BLOCK

        print(f"\n=== {dist}: {N_RANKS} ranks x {TOKENS_PER_RANK} tokens ===")
        for tol in (0.0, 0.1, 0.3):
            sch = schedule(segs, blk=BLOCK, n_servers=N_RANKS, comm=comm,
                           caps=Caps(cq=nb, ckv=2 * nb, nkv=4 * nb),
                           tolerance=tol)
            loads = sch.loads / max(sch.loads.mean(), 1e-9)
            bars = " ".join(f"{x:4.2f}" for x in loads)
            print(f"tol={tol:4.2f}  imb={imbalance(sch.loads):5.3f}  "
                  f"moves={sch.n_moves:3d}  "
                  f"comm={sch.comm_bytes/2**20:7.1f}MiB  loads/mean: {bars}")
        # plan policies head-to-head; identity == the no-CAD home baseline
        cadcfg = CADConfig(n_servers=N_RANKS, blk=BLOCK, nb=nb, cq=nb,
                           ckv=2 * nb, nkv=4 * nb)
        for pol in available_policies():
            try:
                # build_plan=True on purpose: the capacity feasibility
                # check (PlanCapacityError below) is part of the comparison
                res = get_planner(pol)(cadcfg, segs, comm=comm,
                                       tolerance=0.1)
            except PlanCapacityError as e:
                print(f"policy {pol:10s}  infeasible at this pool geometry: "
                      f"{e.capacity} needs {e.needed} > {e.available} slots")
                continue
            print(f"policy {pol:10s}  imb={imbalance(res.loads):5.3f}  "
                  f"moves={res.stats['n_moves']:4d}  "
                  f"comm={res.stats['comm_bytes']/2**20:7.1f}MiB")
    return 0


if __name__ == "__main__":
    main()
