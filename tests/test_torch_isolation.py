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


# the decomposed dispatch, streaming, calibration and ring functions, each
# from the module that defines it
_NEW_FUNCTIONS = """
from repro_torch.core.dispatch import (
    build_server_inputs, serve_task_batch, stream_task_batch,
    assemble_step_outputs, merge_recovered, probe_plan_times,
    ring_pass_geometry, ring_attention, ring_global_sim)
from repro_torch.kernels.packed_flash.ops import (
    ca_server_fwd_range, ca_server_fwd_range_reference, ca_server_fwd_chunked,
    ca_partial_attention, merge_softmax_partials, ca_fwd_init, ca_fwd_steps,
    ca_fwd_finalize)
from repro_torch.cad.session import CADSession
from repro_torch.cad import GridCalibrator, CalibrationSnapshot
from repro_torch.train.trainer import TrainConfig
assert callable(CADSession.observe_probe) and callable(CADSession._plan_stale)
assert TrainConfig().calibrate_every == 0
"""


def test_dispatch_streaming_calibration_and_ring_load_no_jax():
    _probe(_NEW_FUNCTIONS)


# the elastic runtime, checkpoints and the trace report, each from the
# module that defines it, and the trainer and launcher that use them
_ELASTIC = """
from repro_torch.runtime import (
    ServerPool, PoolView, PoolExhaustedError, ServerLostError, FaultSchedule,
    FaultEvent, RecoveryPlan, build_recovery_plan, lost_block_mask,
    assignment_of_plan, recovery_tasks, ElasticExecutor, StepReport)
from repro_torch.runtime.executor import StepState, TIMERS
from repro_torch.checkpoint.ckpt import (
    save, restore, read_meta, restore_calibration, latest_step)
from repro_torch.launch.trace_report import (
    load_steps, attribute_step, report_lines, main)
from repro_torch.launch.train import parse_args
from repro_torch.train.trainer import TrainConfig
assert TrainConfig().fault_schedule == "" and TrainConfig().ckpt_every == 0
assert parse_args(["--arch", "x", "--trace", "t"]).trace_capacity > 0
"""


def test_runtime_checkpoint_and_trace_report_load_no_jax():
    _probe(_ELASTIC)


# the App. A bound, the configs of this slice and recurrent serving, each
# from the module that defines it
_SERVING = """
from repro_torch.core.analysis import (
    max_partition_size, context_independent_time_per_token)
from repro_torch.configs import get_config, SERVE_ARCHS, PAPER_ARCHS
from repro_torch.models.layers import ssd_decode, rglru_decode, _causal_conv
from repro_torch.models.model import Transformer, fused_prefill_ok
from repro_torch.serve.engine import Engine, check_kernel_head_dim
from repro_torch.launch.serve import parse_args
for arch in ("llama3-34b", "mistral-large-123b", "nemotron-4-340b",
             "mamba2-370m", "recurrentgemma-9b"):
    assert arch in SERVE_ARCHS, arch
    assert parse_args(["--arch", arch]).arch == arch
assert max_partition_size(get_config("llama3-34b")) > 1
assert not fused_prefill_ok(get_config("mamba2-370m"))
check_kernel_head_dim(get_config("nemotron-4-340b"))
"""


def test_analysis_configs_and_recurrent_serving_load_no_jax():
    _probe(_SERVING)


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
