"""What the benchmark runs loads no JAX and no JAX package (top-level
names compared whole), and the reference loads nothing of the program;
a cell, a configuration and a per-layer metric added as files are found
without editing a harness file."""
import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from conftest import REPO, tiny_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{REPO}:{REPO}/src"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax():
    """Every module of a run (harness, the port's trainer and session,
    the reference, the records and each metric reader)."""
    names = _loaded(
        "import cadbench.run, cadbench.harness, cadbench.records, "
        "cadbench.compare, cadbench.calibrate\n"
        "import repro_torch.train.trainer, repro_torch.cad.session\n"
        "import cadbench.reference.model\n"
        "import glob, runpy\n"
        "for f in glob.glob('cadbench/metrics/*.py'): runpy.run_path(f)")
    assert "repro_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded("import cadbench.reference.model, "
                    "cadbench.reference.weights")
    assert not names & (FORBIDDEN | {"repro_torch"})
    for f in (REPO / "cadbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) and not node.level else []
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"repro_torch",
                                                           "cadbench"}, \
                    (f.name, m)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_new_files_are_found_by_name(bench_copy):
    """A configuration, traffic mix, cell and per-layer metric dropped into
    a copy of the benchmark are found through ``BENCHMARK.json`` alone."""
    before = {p: p.read_bytes() for p in bench_copy.rglob("*.py")}
    entry = tiny_cell(bench_copy)
    (bench_copy / "metrics" / "steps_traced.py").write_text(
        "def read(rec):\n    return float(len(rec.steps))\n")
    bench_path = bench_copy.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["per_layer"].append({
        "name": "steps_traced", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "tokens_per_s", "workloads": ["tiny"]})
    bench_path.write_text(json.dumps(bench))

    run = _module(bench_copy / "run.py", "cadbench_copy_run")
    from cadbench import harness
    cell = harness.load_cell(entry["name"], bench_copy)
    assert cell["config_file"]["shape"]["d_model"] == 128
    assert cell["traffic_file"]["seq_len"] == 512
    assert harness.model_config(cell).d_model == 128
    names = [m["name"] for m in run.per_layer_metrics(bench, "tiny")]
    assert names == ["steps_traced"]

    class Rec:
        steps = [{}, {}]
    assert run.read_metric("steps_traced", Rec, bench_copy) == 2.0
    assert {p: p.read_bytes() for p in bench_copy.rglob("*.py")
            if p in before} == before
