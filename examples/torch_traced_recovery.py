"""Flight-recorder demo on the PyTorch port (the counterpart of
``examples/traced_recovery.py``): trace a fault-injected elastic run.

Runs the decomposed elastic executor (per-server dispatch: the path that
narrates ``serve``/``recover`` spans and ``kill``/``speculate`` instants
onto one trace track per attention server, DESIGN.md §14) under a
deterministic fault schedule: one server killed mid-run, another slowed
enough to trip straggler speculation.  Saves the Chrome-trace/Perfetto
JSON and the metrics snapshot, then prints the per-step straggler
attribution over the trace it just wrote.

Run:  PYTHONPATH=src python examples/torch_traced_recovery.py [--device cpu]
      # then load <tmp>/recovery.trace.json in ui.perfetto.dev
"""
import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.cad import CADConfig, CADSession
from repro_torch.core.cost_model import CommModel
from repro_torch.launch.trace_report import report_lines
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.runtime import ElasticExecutor, FaultSchedule, ServerPool

BLK = 16


def make_segs(d, nb, seed):
    rng = np.random.default_rng(seed)
    segs = np.zeros((d, nb * BLK), np.int32)
    sid = 1
    for r in range(d):
        t = 0
        while t < nb:
            dbl = int(rng.integers(1, min(4, nb - t) + 1))
            segs[r, t * BLK:(t + dbl) * BLK] = sid
            sid += 1
            t += dbl
    return segs


def main(argv=None):
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=8,
                    help="q blocks per rank")
    ap.add_argument("--trace",
                    default=os.path.join(tmp, "recovery.trace.json"))
    ap.add_argument("--metrics",
                    default=os.path.join(tmp, "recovery.metrics.json"))
    ap.add_argument("--speculate-pct", type=float, default=0.9)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    d, nb = args.ranks, args.blocks
    kill, slow_lo = max(1, args.steps // 3), max(2, args.steps // 2)
    spec = (f"kill:1@{kill},"
            f"slow:{d - 1}x3@{slow_lo}-{args.steps - 1}")
    print(f"pool: {d} servers | faults: {spec} | "
          f"speculate_pct={args.speculate_pct}")

    cfg = CADConfig(n_servers=d, blk=BLK, nb=nb, cq=2 * nb, ckv=4 * nb,
                    nkv=8 * nb)
    session = CADSession(cfg=cfg, comm=CommModel(2, 8, 2),
                         tolerance=0.05, jmax=nb, prefetch=0)
    session = session.with_pool(ServerPool(d))
    rec = TraceRecorder(capacity=65536)
    mx = MetricsRegistry()
    ex = ElasticExecutor(session, faults=FaultSchedule.parse(spec),
                         speculate_pct=args.speculate_pct,
                         recorder=rec, metrics=mx)

    for step in range(args.steps):
        segs = make_segs(d, nb, seed=step)
        pos = np.broadcast_to(np.arange(segs.shape[1]),
                              segs.shape).copy()
        q, k, v, p = ex.synth_inputs(segs, pos, seed=step,
                                     device=args.device)
        _, rep = ex.run_step(step, q, k, v, p, segs)
        note = []
        if rep.failed:
            note.append(f"failed={sorted(rep.failed)}")
        if rep.speculated:
            note.append(f"speculated={sorted(rep.speculated)}")
        print(f"step {step} epoch {rep.epoch} "
              f"step_s {rep.step_seconds:.3g} "
              f"{' '.join(note)}".rstrip())

    rec.save(args.trace)
    with open(args.metrics, "w") as f:
        json.dump(mx.to_dict(), f, indent=2)
    print(f"trace: {len(rec)} events -> {args.trace} "
          f"({rec.n_dropped} dropped)")
    print(f"metrics: -> {args.metrics}")
    print()
    for line in report_lines(rec.to_chrome_trace()):
        print(line)

    evs = rec.events()
    if not any(e.name == "kill" for e in evs):
        raise SystemExit("kill must be traced")
    if not any(e.name == "recover" for e in evs):
        raise SystemExit("recovery must be traced")
    if args.speculate_pct and not any(e.name == "speculate" for e in evs):
        raise SystemExit("speculation must be traced")
    return 0


if __name__ == "__main__":
    main()
