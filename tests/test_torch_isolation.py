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


# the rank path (group, join, exchange, per-rank plans, the data-parallel
# step) and the fabric, each from the module that defines it; importing
# them creates no process group and touches no device
_RANKS_AND_FABRIC = """
import torch
from repro_torch.parallel import ParallelContext
from repro_torch.launch.mesh import (join_group, leave_group, RankInfo,
                                     launched_by_torchrun)
from repro_torch.core.dispatch import (
    _Exchange, _rank_fn, _pingpong_ranks, check_cad_group)
from repro_torch.cad.session import plan_digest, CADSession
from repro_torch.data.pipeline import rank_rows, global_token_count
from repro_torch.train.step import allreduce_grads, broadcast_params
from repro_torch.fabric import (
    AdmissionPolicy, AdmissionRound, FabricExecutor, FabricStepReport,
    LATENCY, SERVE, ServeRequest, ServeTaskReq, ServeWorkload, THROUGHPUT,
    TRAIN, TenantClass, admit_serve)
import torch.distributed as dist
assert not dist.is_initialized()
assert torch.cuda.is_initialized() is False
assert ParallelContext().group is None
"""


def test_rank_path_and_fabric_load_no_jax():
    _probe(_RANKS_AND_FABRIC)


# the cross-attention archs, the encoder and the legacy decode path, each
# from the module that defines it
_CROSS = """
from repro_torch.configs import get_config, SERVE_ARCHS
from repro_torch.core.attention import decode_attention
from repro_torch.models.layers import attn_init, cross_attn_apply, cross_gate
from repro_torch.models.model import Transformer, has_encoder, needs_memory
from repro_torch.models.convert import decay_mask, params_from_jax
from repro_torch.train.step import BATCH_KEYS, make_serve_step
from repro_torch.serve.engine import Engine
from repro_torch.launch.serve import build_engine
assert callable(Transformer.encode) and callable(Transformer.decode_step)
assert {"memory", "memory_mask"} <= set(BATCH_KEYS)
for arch in ("whisper-large-v3", "llama-3.2-vision-11b"):
    assert needs_memory(get_config(arch)) and arch not in SERVE_ARCHS
assert has_encoder(get_config("whisper-large-v3"))
"""


def test_cross_attention_and_legacy_decode_load_no_jax():
    _probe(_CROSS)


# pipeline parallelism with CAD across stages, from the module that
# defines it; importing it creates no process group and touches no device
_PIPELINE = """
import torch
import torch.distributed as dist
from repro_torch.pipeline_par import (
    pipeline_apply, split_stages, tick_schedules, model_stage_fn,
    sum_grads_over_stages)
from repro_torch.pipeline_par.pipeline import (
    _Shift, _SumOverGroup, _tick_sim, _lockstep_tick_fn, MB_SEG_OFFSET)
assert MB_SEG_OFFSET == 100000
assert not dist.is_initialized()
assert torch.cuda.is_initialized() is False
"""


def test_pipeline_parallelism_loads_no_jax():
    _probe(_PIPELINE)


# the sharding rules and the grid's layers, each from the module that
# defines it; importing them joins no grid and touches no device
_GRID = """
import torch
import torch.distributed as dist
from repro_torch.parallel import (
    ShardingRules, make_rules, param_placements, fsdp_dims, sharded_over,
    head_pad, ParallelContext)
from repro_torch.launch.mesh import GridInfo, join_grid
from repro_torch.models.sharded import (
    seq_gather, seq_scatter, own_seq, vocab_nll, exchange_rows, all_gather,
    fsdp_gather, read_weights)
from repro_torch.models.layers import tp_heads, tp_local_heads
from repro_torch.models.convert import (
    shard_params, gather_params, shard_model, grid_placements,
    gather_shard, shard_shape)
from repro_torch.models.model import check_grid
from repro_torch.train.loss import grid_nll_sum
from repro_torch.train.step import grad_groups
assert head_pad(15, 2) == 16 and not ParallelContext().tp
assert not dist.is_initialized()
assert torch.cuda.is_initialized() is False
"""


def test_sharding_rules_and_grid_layers_load_no_jax():
    _probe(_GRID)


# the launch tooling, each module by name, and one dry run on a fake grid
# (the fake process group, the meta step, the op counter and the roofline)
_LAUNCH = """
import torch
import torch.distributed as dist
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch import (breakdown, dryrun, dryrun_lib, op_analysis,
                                perf, roofline)
from repro_torch.obs.regions import REGIONS, region, marked
rec = dryrun_lib.run_dryrun("smollm-360m-reduced",
                            dict(kind="train", seq=256, batch=4),
                            {"data": 2, "model": 2}, cad=True)
assert rec["hlo_flops_per_device"] > 0 and rec["collective_bytes_per_device"]
assert breakdown.report(op_analysis.OpCost(flops=1.0))
assert len(ASSIGNED_ARCHS) == 10 and callable(perf.measure)
assert callable(roofline.main) and callable(dryrun.main)
assert not dist.is_initialized()
assert torch.cuda.is_initialized() is False
"""


def test_launch_tooling_loads_no_jax():
    _probe(_LAUNCH)


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
