"""Straggler-attribution report over a saved Chrome trace.

The port's copy of ``repro.launch.trace_report`` (stdlib only).

Reads the Perfetto/Chrome-trace JSON written by ``--trace`` (or
``TraceRecorder.save``) and prints, per training step, the paper's
straggler story in one line: which attention server bounded the step,
how far above the mean it ran, how well the planner predicted it, and
how much of its time was recovery work re-dispatched from a failed or
speculated peer (DESIGN.md §14).

  PYTHONPATH=src python -m repro_torch.launch.trace_report run.trace.json

Columns:

  step      the training step
  max_s     the bounding (slowest) server's total seconds
            (serve + recovery + backfill on that server)
  mean_s    mean total seconds over servers that served this step
  server    which server was the straggler
  pred_s    the cost model's predicted serve seconds for that server
  rec%      recovery share of the straggler's time (0% = fault-free)
  events    kill / serve-error / speculate markers this step

The report consumes only the public trace schema — span names
``serve`` / ``recover`` / ``serve.backfill`` on ``server/<slot>``
tracks, ``kill`` / ``serve-error`` / ``speculate`` instants, and the
``step`` + ``predicted`` args the executor attaches — so any trace a
:class:`repro_torch.obs.TraceRecorder` saved is reportable.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

SERVE_SPANS = ("serve", "serve.backfill")
MARKER_EVENTS = ("kill", "serve-error", "speculate")


def _track_of(ev: Dict[str, Any], names: Dict[int, str]) -> str:
    return names.get(ev.get("tid", -1), f"tid/{ev.get('tid')}")


def _server_of(track: str) -> Optional[int]:
    if track.startswith("server/"):
        return int(track.split("/", 1)[1])
    return None


def load_steps(trace: Dict[str, Any]) -> Dict[int, Dict[int, dict]]:
    """{step: {server: {"serve": s, "recover": s, "predicted": s,
    "events": [name, ...]}}} from a Chrome-trace object."""
    names: Dict[int, str] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    steps: Dict[int, Dict[int, dict]] = {}
    for ev in trace.get("traceEvents", ()):
        args = ev.get("args") or {}
        step = args.get("step")
        if ev.get("ph") == "M" or step is None:
            continue
        server = _server_of(_track_of(ev, names))
        if server is None:
            continue
        rec = steps.setdefault(int(step), {}).setdefault(
            server, {"serve": 0.0, "recover": 0.0, "predicted": 0.0,
                     "events": []})
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name in SERVE_SPANS:
            rec["serve"] += float(ev.get("dur", 0.0)) / 1e6
            rec["predicted"] += float(args.get("predicted", 0.0))
        elif ev.get("ph") == "X" and name == "recover":
            rec["recover"] += float(ev.get("dur", 0.0)) / 1e6
        elif ev.get("ph") == "i" and name in MARKER_EVENTS:
            rec["events"].append(name)
    return steps


def attribute_step(servers: Dict[int, dict]) -> Dict[str, Any]:
    """The straggler attribution for one step: who bounded it and why."""
    totals = {s: d["serve"] + d["recover"] for s, d in servers.items()}
    served = {s: t for s, t in totals.items() if t > 0.0} or totals
    straggler = max(sorted(served), key=lambda s: served[s])
    mean = sum(served.values()) / len(served)
    d = servers[straggler]
    total = totals[straggler]
    return {"server": straggler,
            "max_seconds": total,
            "mean_seconds": mean,
            "predicted_seconds": d["predicted"],
            "recovery_share": (d["recover"] / total) if total > 0 else 0.0,
            "events": sorted(ev for s in servers.values()
                             for ev in s["events"])}


def report_lines(trace: Dict[str, Any]) -> List[str]:
    steps = load_steps(trace)
    lines = [f"{'step':>6} {'max_s':>12} {'mean_s':>12} {'server':>6} "
             f"{'pred_s':>12} {'rec%':>6}  events"]
    for step in sorted(steps):
        a = attribute_step(steps[step])
        evs = ",".join(a["events"]) or "-"
        lines.append(
            f"{step:>6} {a['max_seconds']:>12.6g} "
            f"{a['mean_seconds']:>12.6g} {a['server']:>6} "
            f"{a['predicted_seconds']:>12.6g} "
            f"{a['recovery_share'] * 100:>5.1f}%  {evs}")
    if not steps:
        lines.append("(no per-step server events in trace)")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="per-step straggler attribution from a --trace file")
    ap.add_argument("trace", help="Chrome-trace JSON (from --trace or "
                                  "TraceRecorder.save)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable attribution instead of "
                         "the table")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    if args.json:
        steps = load_steps(trace)
        print(json.dumps({str(k): attribute_step(v)
                          for k, v in sorted(steps.items())}, indent=2))
        return
    for line in report_lines(trace):
        print(line)


if __name__ == "__main__":
    main()
