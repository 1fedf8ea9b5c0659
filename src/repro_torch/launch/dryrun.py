"""Dry-run command: the port of ``repro.launch.dryrun``
(``src/repro/launch/dryrun.py``).

For every (architecture x input shape), build rank 0's step of the
production grid on the ``meta`` device over a fake process group, run it
once under the op counter and print its bytes, FLOPs and collectives
(``launch.dryrun_lib``).  Results are appended as JSON lines.  Needs no
card and allocates nothing.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all               # 16 x 16
  python -m repro_torch.launch.dryrun --all --multi-pod   # 2 x 16 x 16
  python -m repro_torch.launch.dryrun --arch ... --cad    # CAD dispatch
  python -m repro_torch.launch.dryrun --arch ... --grid 2x2  # data x model
"""
import argparse
import json
import os
import sys
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch.dryrun_lib import (INPUT_SHAPES, production_sizes,
                                           run_dryrun)


def parse_grid(text: str):
    """``"DxM"`` -> ``{"data": D, "model": M}``, ``"PxDxM"`` adds
    ``"pod"``."""
    dims = [int(x) for x in text.lower().split("x")]
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if axes is None:
        raise argparse.ArgumentTypeError(f"--grid {text!r}: DxM or PxDxM")
    return dict(zip(axes, dims))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None,
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grid", type=parse_grid, default=None,
                    help="another grid than the production one: DxM or "
                         "PxDxM")
    ap.add_argument("--cad", action="store_true",
                    help="trace the CAD dispatch path (train shapes)")
    ap.add_argument("--pingpong", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun.jsonl")
    args = ap.parse_args(argv)

    archs = args.arch or list(ASSIGNED_ARCHS)
    shapes = args.shape or list(INPUT_SHAPES)
    if not args.all and args.arch is None and args.shape is None:
        ap.error("pass --all or --arch/--shape")

    torch.set_num_threads(1)        # meta tensors: nothing to compute
    sizes = args.grid or production_sizes(args.multi_pod)
    mesh = list(sizes.values())
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} mesh={mesh}" \
                      + (" CAD" if args.cad else "")
                try:
                    r = run_dryrun(arch, shape, sizes, cad=args.cad,
                                   pingpong=args.pingpong)
                except Exception as e:  # a failure here is a system bug
                    failures += 1
                    r = {"arch": arch, "shape": shape, "cad": args.cad,
                         "mesh": mesh, "error":
                         f"{type(e).__name__}: {e}"}
                    traceback.print_exc()
                f.write(json.dumps(r) + "\n")
                f.flush()
                if r.get("skipped"):
                    print(f"[skip] {tag}: {r['reason']}")
                elif "error" in r:
                    print(f"[FAIL] {tag}: {r['error'][:200]}")
                else:
                    print(f"[ ok ] {tag}: trace={r['trace_s']}s "
                          f"peak={r['peak_bytes']/2**30:.2f}GiB/dev "
                          f"flops={r['hlo_flops_per_device']:.3e} "
                          f"coll={r['collective_bytes_per_device']/2**20:.1f}"
                          f"MiB", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
