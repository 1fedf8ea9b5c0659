"""The six PyTorch examples (``examples/torch_*.py``), each the
counterpart of a reference example, run in this process at their
smallest arguments (``torch_traced_recovery.py`` at its defaults: fewer
steps would end before its slowed server trips speculation) with
``--device cpu``: each finishes (``main``
returns 0, no ``SystemExit``).  ``torch_schedule_explore.py`` prints the
reference example's output line for line (both plan on host numpy), and
``torch_quickstart.py`` the reference quickstart's planner line (its
session and format on the same batch), its CAD-vs-monolithic error under
the reference's own bound (its q/k/v are drawn by torch, so the error
itself differs)."""
import importlib.util
import re
import runpy
from pathlib import Path

import pytest

import test_torch_helpers  # noqa: F401  (torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
# example -> its smallest arguments (on the CPU)
SMALLEST = {"torch_quickstart": [],
            "torch_train_cad": ["--steps", "2", "--tiny", "--seq", "256",
                                "--batch", "2"],
            "torch_serve_batch": [],
            "torch_elastic_train": ["--steps", "2"],
            "torch_traced_recovery": [],
            "torch_schedule_explore": []}
QUICKSTART_BOUND = 1e-4     # examples/quickstart.py's assert


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, args, capsys):
    capsys.readouterr()
    assert _example(name).main(args + ["--device", "cpu"]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_train_cad", "torch_serve_batch",
                                  "torch_elastic_train"])
def test_example_runs_on_cpu(name, capsys):
    out = _run(name, SMALLEST[name], capsys)
    assert out.strip()


def test_traced_recovery_example_traces_the_faults(tmp_path, capsys):
    out = _run("torch_traced_recovery", SMALLEST["torch_traced_recovery"]
               + ["--trace", str(tmp_path / "t.json"),
                  "--metrics", str(tmp_path / "m.json")], capsys)
    assert (tmp_path / "t.json").stat().st_size > 0
    assert (tmp_path / "m.json").stat().st_size > 0
    assert re.search(r"^step \d+ epoch 0 .*failed=\[1\]", out, re.M)
    assert re.search(r"^step \d+ epoch 1 .*speculated=", out, re.M)


def test_schedule_explore_prints_the_reference_lines(capsys):
    port = _run("torch_schedule_explore", [], capsys)
    runpy.run_path(str(ROOT / "examples" / "schedule_explore.py"),
                   run_name="__main__")
    ref = capsys.readouterr().out
    assert port.splitlines() == ref.splitlines()
    assert len(port.splitlines()) > 10


def _reference_planner_line(segs, blk, nb):
    """``examples/quickstart.py``'s planner line: its session and format
    on the same batch (its dispatch, a JAX compile, is not needed for
    this line)."""
    from repro.cad import CADConfig, CADSession
    from repro.core.cost_model import CommModel
    session = CADSession(
        cfg=CADConfig(n_servers=segs.shape[0], blk=blk, nb=nb, cq=nb,
                      ckv=2 * nb, nkv=4 * nb),
        kernel="xla", plan_policy="balanced", tolerance=0.05, jmax=nb,
        comm=CommModel(n_heads=4, head_dim=64, n_kv_heads=2))
    _, stats = session.plan(segs)
    return (f"planner[{session.plan_policy}]: {stats['n_moves']} "
            f"migrations, {stats['comm_bytes']/2**20:.2f} MiB moved, "
            f"straggler x{stats['load_max_over_mean']:.3f}")


def test_quickstart_plans_as_the_reference_and_matches_attention(capsys):
    mod = _example("torch_quickstart")
    port = _run("torch_quickstart", [], capsys).splitlines()
    segs, _ = mod.packed_batch()
    assert port[0] == _reference_planner_line(segs, mod.BLK,
                                              mod.S // mod.BLK)
    err = float(port[1].rsplit("=", 1)[1])
    assert port[1].startswith("CAD == monolithic attention") \
        and err < QUICKSTART_BOUND
    assert port[2] == "OK"
