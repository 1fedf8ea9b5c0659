"""Perf-iteration command: the port of ``repro.launch.perf``
(``src/repro/launch/perf.py``).  Dry-runs one (arch x shape) combination
on the production grid (``launch.dryrun_lib``, on the ``meta`` device, no
card) and prints the roofline terms and the per-bucket FLOPs and
per-site collective breakdown: the profile a perf hypothesis is tested
against.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma2-2b \\
      --shape train_4k [--cad] [--pingpong] [--multi-pod]

``--measure`` also runs one rank's step on the card (``--device``,
``cuda`` by default): ``--rows`` rows of the shape's sequence (no grid;
a decode shape's one token a row against a full cache of that many
positions) at ``--layers`` layers, first under the op counter (its FLOPs against
the meta trace of the same step, the card's peak allocation against the
predicted peak), then once more traced with ``torch.profiler``, and
prints the device ms of each bucket beside that bucket's compute and
memory terms (``launch.breakdown.device_breakdown``).
"""
import argparse
import gc
import time
from typing import Any, Dict

import torch

from repro_torch.core.cost_model import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.launch.breakdown import BUCKETS, device_breakdown, report
from repro_torch.launch.dryrun import parse_grid
from repro_torch.launch.dryrun_lib import (INPUT_SHAPES, analyze_step,
                                           arch_config, build_step,
                                           production_sizes, run_dryrun)
from repro_torch.launch.op_analysis import OpCost
from repro_torch.launch.roofline import roofline_row
from repro_torch.models.model import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(arch: str, shape_name: str, *, layers: int = 2, rows: int = 1,
            cad: bool = False, pingpong: bool = False, device="cuda",
            seed: int = 0, lead_in=None, skip=None) -> Dict[str, Any]:
    """One rank's step (``rows`` x the shape's sequence, ``layers``
    layers, no grid) traced on meta and run on ``device``: the
    prediction, the run under the op counter, one more step traced with
    ``torch.profiler`` and the bucket table (FLOPs, bytes, their roofline
    terms in ms and, on a card, device ms).  ``lead_in()``, if given, runs
    first in the traced window; kernels named with ``skip`` are left out
    of its breakdown."""
    cfg = arch_config(arch, layers)
    shape = dict(INPUT_SHAPES[shape_name], batch=rows)
    pred_step = build_step(cfg, None, shape, cad=cad, pingpong=pingpong,
                           device="meta")
    pred, trace_s, _ = analyze_step(pred_step)
    pred_args = pred_step.argument_bytes()
    del pred_step
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
    step = build_step(cfg, None, shape, cad=cad, pingpong=pingpong,
                      device=dev, seed=seed)
    args_b = step.argument_bytes()
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    got, count_s, result = analyze_step(step)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    loss = float(result[1]["loss"]) if shape["kind"] == "train" else None
    del result
    t0 = time.perf_counter()
    step.fn(*step.args)
    _sync(dev)
    step_ms = 1e3 * (time.perf_counter() - t0)
    bd = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if lead_in is not None:
                lead_in()
            step.fn(*step.args)
            _sync(dev)
        bd = device_breakdown(prof.events(), skip=skip)
        del prof
    table = []
    for b in (*BUCKETS, "unattributed"):
        f = pred.flops_by_bucket.get(b, 0.0)
        by = pred.bytes_by_bucket.get(b, 0.0)
        ms = None if bd is None else bd["buckets"].get(b, 0.0)
        if f or by or ms:
            table.append(dict(bucket=b, flops=f, compute_ms=1e3 * f
                              / PEAK_FLOPS_BF16, bytes=by,
                              memory_ms=1e3 * by / HBM_BW, device_ms=ms))
    pred_peak = pred_args["argument_bytes"] + pred.temp_bytes \
        + pred.output_bytes
    return dict(
        arch=arch, shape=shape_name, rows=rows, layers=cfg.n_layers,
        cad=cad, pingpong=pingpong, device=str(dev), trace_s=trace_s,
        count_s=count_s, step_ms=step_ms, loss=loss,
        predicted=dict(pred_args, flops=pred.flops, hbm_bytes=pred.hbm_bytes,
                       temp_bytes=pred.temp_bytes,
                       output_bytes=pred.output_bytes, peak_bytes=pred_peak),
        measured=dict(args_b, flops=got.flops, hbm_bytes=got.hbm_bytes,
                      peak_allocated=peak),
        peak_ratio=None if peak is None else pred_peak / peak,
        buckets=table, breakdown=bd)


def format_measure(res: Dict[str, Any]) -> str:
    p, m = res["predicted"], res["measured"]
    lines = [
        f"== measured: {res['arch']} x {res['shape']} at {res['rows']} "
        f"row(s), {res['layers']} layers, cad={res['cad']} on "
        f"{res['device']}: step {res['step_ms']:.1f} ms untraced, loss "
        f"{res['loss']}",
        f"argument bytes: predicted {p['argument_bytes']} (params "
        f"{p['param_bytes']}, moments {p['moment_bytes']}, batch "
        f"{p['batch_bytes']}, cache {p['cache_bytes']}), on the device "
        f"{m['argument_bytes']}",
        f"flops: meta trace {p['flops']:.6e}, on the device "
        f"{m['flops']:.6e}",
        f"peak: predicted {p['peak_bytes'] / 2 ** 30:.3f} GiB (temp "
        f"{p['temp_bytes'] / 2 ** 30:.3f}), allocated "
        + (f"{m['peak_allocated'] / 2 ** 30:.3f} GiB, ratio "
           f"{res['peak_ratio']:.4f}" if m["peak_allocated"] is not None
           else "not measured (no card)"),
        f"  {'bucket':14s} {'flops':>12s} {'compute ms':>11s} "
        f"{'bytes':>12s} {'memory ms':>10s} {'device ms':>10s}"]
    for r in res["buckets"]:
        dms = "-" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        lines.append(f"  {r['bucket']:14s} {r['flops']:12.4e} "
                     f"{r['compute_ms']:11.3f} {r['bytes']:12.4e} "
                     f"{r['memory_ms']:10.3f} {dms:>10s}")
    bd = res["breakdown"]
    if bd is not None:
        lines.append(f"device: busy {bd['busy_ms']:.3f} ms of a "
                     f"{bd['span_ms']:.3f} ms span, {bd['kernels']} "
                     f"kernels; by family: " + ", ".join(
                         f"{k} {v:.3f}" for k, v in bd["families"].items()
                         if v))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--cad", action="store_true")
    ap.add_argument("--pingpong", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grid", type=parse_grid, default=None)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--measure", action="store_true",
                    help="also run one rank's step on the card, traced")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the arch's; 2 with --measure)")
    ap.add_argument("--rows", type=int, default=1,
                    help="rows of the measured step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sizes = args.grid or production_sizes(args.multi_pod)
    layers = args.layers or (2 if args.measure else None)
    rec = run_dryrun(args.arch, args.shape, sizes, cad=args.cad,
                     pingpong=args.pingpong, layers=layers)
    if rec.get("skipped"):
        print(rec)
        return 0
    row = roofline_row(rec)
    print(f"== {args.arch} x {args.shape} mesh={rec['mesh']} "
          f"cad={args.cad} pingpong={args.pingpong} layers={rec['layers']}")
    print(f"compute   {row['compute_s']:.4f} s")
    print(f"memory    {row['memory_s']:.4f} s")
    print(f"collective{row['collective_s']:.4f} s")
    print(f"dominant  {row['dominant']}   useful={row['useful_ratio']:.2f} "
          f"peak={row['peak_gib_per_dev']:.1f} GiB/dev")
    print(report(OpCost(flops_by_bucket=rec["flops_by_bucket"],
                        collective_by_site=rec["collective_by_site"]),
                 top=args.top))
    if args.measure:
        res = measure(args.arch, args.shape, layers=layers, rows=args.rows,
                      cad=args.cad, pingpong=args.pingpong,
                      device=args.device)
        print(format_measure(res))
    return 0


if __name__ == "__main__":
    main()
