"""Readings that the limits of ``correct`` are set from, on the card, in
one process per cell (the kernels built or loaded once):

* the program's gaps against the f32 reference on each of ``--seeds``,
  by the comparison a run makes (``compare.against_reference``): the
  lower readings;
* on each of ``--control-seeds``, the control (the reference in fp8 in
  the program's place) and the fault "half of the batch left out, the
  mean taken over the rest" planted in the reference: the upper ones.

    python3 cadbench/calibrate.py --workload <cell> --seeds 101-112 \
        --control-seeds 201-203 --out chiprun_out/calib.json

Not run by the benchmark's runs.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def seeds(spec: str):
    out = []
    for part in filter(None, spec.split(",")):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    # the controls run at the edge of the card's memory: no fragmentation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA card")
    from cadbench import compare, harness
    from cadbench.reference.model import train_steps

    dev = "cuda"
    cell = harness.load_cell(args.workload)
    shape, n_cmp = cell["config_file"]["shape"], cell["compare_steps"]
    expected = harness.batches(cell, n_cmp)
    rows = cell["traffic_file"]["rows"]
    out = {"workload": args.workload,
           "card": torch.cuda.get_device_name(0),
           "program": [], "control": []}

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    def gaps(found):
        return {k: v[0] for k, v in found.items()} | {
            "where": {k: v[1] for k, v in found.items()}}

    for s in seeds(args.seeds):
        t = time.perf_counter()
        obs = harness.drive(cell, s, dev)
        t1 = time.perf_counter()
        ref, found = compare.against_reference(cell, obs, expected, s, dev)
        row = {"seed": s, **gaps(found), "losses": obs.losses,
               "ref_losses": ref["losses"], "grad_norm": obs.grad_norm,
               "grad_total": obs.grad_total,
               "ref_grad_norm": ref["grad_norm"],
               "peak_gib": obs.peak_bytes / 2 ** 30,
               "program_s": t1 - t, "reference_s": time.perf_counter() - t1,
               "batches_differ": harness.batches_match(obs, expected)}
        out["program"].append(row)
        log(json.dumps(row))
    for s in seeds(args.control_seeds):
        first = {}
        ref = train_steps(shape, s, expected, cell["train"], dev,
                          on_first_grad=lambda g: first.update(
                              {n: t.cpu() for n, t in g.items()}))
        row = {"seed": s}
        for what, kw in (("fp8", {"precision": "fp8"}),
                         ("half_batch", {"rows": rows // 2})):
            torch.cuda.empty_cache()
            diff, diffs = compare.grad_diff_norms(first)
            ctl = train_steps(shape, s, expected, cell["train"], dev,
                              on_first_grad=diff, **kw)
            row[what] = gaps(compare.gaps(dict(ctl, grad_diff_norms=diffs),
                                          ref))
        del first
        out["control"].append(row)
        log(json.dumps(row))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
