"""Run one cell of the port's benchmark once and print one JSON line.

    python3 cadbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for.  Set-up (imports, the kernels loaded or built into ``build/``,
the seed's weights, the session and the compared warm-up steps) is timed
as ``setup_s``; then, with ``--trace 0``, whole training steps for
``--seconds`` (``tokens_per_s``, ``peak_mem_gib``), or with ``--trace 1``
the cell's ``trace_steps`` steps under ``torch.profiler`` (the per-layer
metrics of ``BENCHMARK.json`` that list the cell).  Then the program's
state is freed and the plain reference recomputes the compared steps:
``correct`` is the comparison of ``compare.py`` against the cell's
limits.  The numbers compared close standard error and the line's
``checks``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# every compiler cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(REPO / "build" / "cadbench-cache" / _sub)
sys.path[:0] = [str(REPO), str(REPO / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


def fail(msg: str, code: int = 2):
    print(f"cadbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer_metrics(bench, cell):
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def read_metric(name, records, root=HERE):
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        fail(f"no reader for per-layer metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"cadbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(records)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench_path = REPO / "BENCHMARK.json"
    if not bench_path.is_file():
        fail(f"no {bench_path}")
    bench = json.loads(bench_path.read_text())
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        fail(f"BENCHMARK.json has no workload {args.workload!r}")

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        fail(f"the cell needs {entry['chips']} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    print(f"cadbench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr, flush=True)
    line = execute(bench, entry, args.seed, args.seconds, args.trace)
    bad = loaded_forbidden()
    if bad:
        fail(f"loaded in the process that reports: {bad}", 3)
    print(json.dumps(line), flush=True)


def execute(bench, entry, seed, seconds, trace, device="cuda", root=HERE):
    """Everything of a run after the look for a card: the program's set-up,
    compared steps and window, then the reference and the comparison.
    Returns the result line; the numbers compared go to standard error.
    ``device`` and ``root`` (where the cell's files are) let a test drive
    a small cell on the CPU."""
    import torch
    from cadbench import compare, harness, records as recs

    name = entry["name"]
    cell = harness.load_cell(name, root)
    obs = harness.drive(cell, seed, device, seconds=seconds,
                        trace=bool(trace))
    setup_s = obs.window_start - T0
    n_steps = len(obs.step_end)
    expected = harness.batches(cell, n_steps)
    differs = harness.batches_match(obs, expected)

    cuda = torch.device(device).type == "cuda"
    metrics, dev = {}, {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": entry["chips"], "memory_peak_bytes": obs.peak_bytes}
    breakdown = None
    if trace:
        rec = recs.from_trace(cell, obs, expected)
        obs.profile = None
        for m in per_layer_metrics(bench, name):
            v = read_metric(m["name"], rec, root)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = rec.busy_s
        dev["window_s"] = rec.window_s
        breakdown = {"device_ops": rec.device_ops,
                     "idle_gaps": rec.idle_gaps}
    else:
        span = obs.window_end - obs.window_start
        tokens = sum(int((expected[k]["segment_ids"] > 0).sum())
                     for k in obs.window_steps)
        e2e = {"tokens_per_s": tokens / span if obs.window_steps
               else float("nan"),
               "peak_mem_gib": obs.peak_bytes / GIB,
               "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if name not in m.get("workloads", [name]):
                continue
            if m["name"] not in e2e:
                fail(f"no measurement for end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        ends = [obs.step_end[k] for k in obs.window_steps]
        steps = [round(b - a, 4)
                 for a, b in zip([obs.window_start] + ends[:-1], ends)]
        print(f"cadbench: window {span:.3f} s, steps "
              f"{obs.window_steps}, {tokens} tokens, step seconds {steps}",
              file=sys.stderr)

    n_cmp = cell["compare_steps"]
    t_ref = time.perf_counter()
    ref, found = compare.against_reference(cell, obs, expected, seed, device)
    ok, checks = compare.judge(found, cell["limits"])
    failed = sum(1 for x in obs.losses if not math.isfinite(x))
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    checks["batches_differ"] = {"value": int(differs is not None),
                                "limit": 0}
    correct = ok and differs is None and failed == 0 \
        and bool(obs.window_steps)
    line = {"correct": correct, "attempted": n_steps, "failed": failed,
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(f"cadbench: setup_s {setup_s:.3f}, reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    print(f"cadbench: first gradient's norm {obs.grad_norm!r} as the "
          f"program gives it, {obs.grad_total!r} by the hooks",
          file=sys.stderr)
    print(f"cadbench: losses {obs.losses[:n_cmp]} reference "
          f"{ref['losses']}; loss_gap {found['loss_gap'][0]!r}; worst "
          f"{[(k, v[1]) for k, v in found.items()]}"
          + ("" if differs is None else f"; {differs}"), file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return line

if __name__ == "__main__":
    main()
