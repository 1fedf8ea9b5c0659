"""The port stands alone: importing ``repro_torch`` (every submodule) or
``chip_smoke.py`` loads no ``jax`` and nothing of the JAX package
``repro``.  Checked in a fresh interpreter, since this test process has
both loaded."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
{imports}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean", len(sys.modules))
"""

_PORT = """
import repro_torch
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
"""

_SMOKE = f"""
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
"""


def _probe(imports):
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(imports=imports)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_importing_every_port_module_loads_no_jax():
    _probe(_PORT)


def test_importing_chip_smoke_loads_no_jax():
    _probe(_SMOKE)


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits


def test_chip_smoke_without_a_card_or_the_repo_prints_no_result(tmp_path):
    """Run alone (a directory holding only the script) and on a machine
    without a card, chip_smoke.py exits non-zero and prints nothing."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path),
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout == ""
