"""Roofline analysis of dry-run records: the port of
``repro.launch.roofline`` (``src/repro/launch/roofline.py``).

Consumes the dry run's JSONL records (``launch.dryrun``) and derives the
three roofline terms per (arch x shape x grid), on one NVIDIA H100 SXM's
data-sheet rates (``core.cost_model``):

  compute term    = op FLOPs / peak bf16 FLOP/s        (989e12)
  memory term     = op bytes / HBM bandwidth           (3.35e12 B/s)
  collective term = collective bytes / NVLink bandwidth (450e9 B/s)

All dry-run numbers are per rank (rank 0's step of the grid), so each
term divides a per-rank quantity by a per-card rate.  The memory term's
bytes are the op counter's unfused approximation
(``launch.op_analysis``), an upper bound on what an eager step moves.

MODEL_FLOPS uses 6·N·D (dense train), 6·N_active·D (MoE), 2·N·D for a
forward-only shape, and 2·N_active per generated token for decode.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.cost_model import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                         PEAK_FLOPS_BF16)
from repro_torch.launch.dryrun_lib import INPUT_SHAPES


def model_flops(arch: str, shape_name: str) -> float:
    """Useful (paper-accounting) FLOPs for the whole step, global."""
    cfg = get_config(arch)
    info = INPUT_SHAPES[shape_name]
    n_active = cfg.n_active_params()
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode"
                              else 1)
    if info["kind"] == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def roofline_row(rec: Dict) -> Optional[Dict]:
    if rec.get("skipped") or rec.get("error"):
        return None
    n = rec["n_devices"]
    t_compute = rec["hlo_flops_per_device"] / PEAK_FLOPS_BF16
    t_memory = rec["hlo_bytes_per_device"] / HBM_BW
    t_coll = rec["collective_bytes_per_device"] / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_total = rec["hlo_flops_per_device"] * n
    row = {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": "x".join(str(x) for x in rec["mesh"]),
        "cad": rec.get("cad", False),
        "compute_s": t_compute, "memory_s": t_memory,
        "collective_s": t_coll, "dominant": dom,
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_ratio": mf / hlo_total if hlo_total else 0.0,
        "peak_gib_per_dev": rec["peak_bytes"] / 2 ** 30,
        "fits_hbm": rec["peak_bytes"] < HBM_BYTES,
    }
    # one-line "what would move the dominant term down"
    hints = {
        "compute": "shard replicated CA heads / cut remat recompute",
        "memory": "larger fused blocks; fewer materialized intermediates; "
                  "rematerialize less-reused tensors only",
        "collective": "reduce FSDP all-gather volume (cache weights), "
                      "overlap A2A with serve compute (ping-pong), "
                      "shard kv instead of MHA-izing",
    }
    row["hint"] = hints[dom]
    return row


def load_rows(paths: List[str]) -> List[Dict]:
    rows = []
    for p in paths:
        with open(p) as f:
            for line in f:
                rec = json.loads(line)
                r = roofline_row(rec)
                if r:
                    r["_rec"] = rec
                    rows.append(r)
    return rows


def fmt_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | CAD | compute_s | memory_s | "
           "collective_s | dominant | MODEL/OPS | peak GiB/dev |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{'Y' if r['cad'] else '-'} | "
            f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | "
            f"{r['collective_s']:.4f} | **{r['dominant']}** | "
            f"{r['useful_ratio']:.2f} | {r['peak_gib_per_dev']:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl", nargs="+")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = load_rows(args.jsonl)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    if args.markdown:
        print(fmt_table(rows))
    else:
        for r in rows:
            print(f"{r['arch']:28s} {r['shape']:12s} {r['mesh']:9s} "
                  f"C={r['compute_s']:.4f}s M={r['memory_s']:.4f}s "
                  f"X={r['collective_s']:.4f}s dom={r['dominant']:10s} "
                  f"useful={r['useful_ratio']:.2f}")


if __name__ == "__main__":
    main()
