"""The port's launch tooling (``repro_torch.launch``: ``op_analysis``,
``breakdown``, ``dryrun_lib``, ``dryrun``, ``roofline``, ``perf``) held
against the reference's (``repro.launch``) on the CPU.

* the shape table, ``applicable``, ``ASSIGNED_ARCHS`` and ``model_flops``
  equal the reference's;
* every assigned arch's per-rank parameter and AdamW moment bytes at full
  width on the production grids (16 x 16 and 2 x 16 x 16) equal the
  reference's ``param_pspecs`` shards of ``jax.eval_shape(M.init)``: the
  port's side is the dry run's own step, built on ``meta`` over a fake
  process group;
* the op counter's FLOPs of reduced archs' train steps and forwards
  against ``repro.launch.hlo_analysis`` of the reference's compiled step,
  and the attention and unembed buckets against the reference's;
* the counter on programs of known cost, with collectives over a fake
  process group;
* the profiler's bucket of every CPU op (what ``device_breakdown`` gives a
  kernel's launching op) against the op counter's buckets;
* ``roofline_row`` of one record through both packages, and the
  ``dryrun`` CLI on a small grid.
"""
import json
import math
import types

import jax
import numpy as np
import pytest
import torch

import tests.test_torch_helpers  # noqa: F401  (torch on one thread)
from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.launch import dryrun_lib as RD
from repro.launch import roofline as RR
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import dryrun_lib as D
from repro_torch.launch.breakdown import (cpu_op_buckets, device_breakdown,
                                         flops_breakdown)
from repro_torch.launch.op_analysis import analyze

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# small shapes: 1024 tokens a row is two 512-token blocks of the xla
# route, so its pair loop runs more than once on both sides (at one pair
# XLA merges the remat and backward loops and drops a product)
SMALL = {"train_small": dict(kind="train", seq=1024, batch=2),
         "prefill_small": dict(kind="prefill", seq=1024, batch=2)}
# The port's op counter against the reference's HLO analysis, measured:
# forwards are equal (gap 0 for all three archs); train steps differ by
# which forward products the remat recompute re-runs: torch.utils.checkpoint
# stops its recompute at the last tensor the backward saves (early stop),
# XLA drops the products its dead-code pass can; smollm 0, qwen2-moe
# +0.34%, recurrentgemma -1.84%.
FWD_RTOL = 1e-9
TRAIN_RTOL = 2e-2
# the xla route's backward: the port counts delta = rowsum(do * o) as a
# product (torch.einsum runs it as bmm), XLA lowers it to a reduce; +0.014%
# of the attention buckets' FLOPs measured
ATTN_RTOL = 5e-4
FLOPS_ARCHS = ("smollm-360m-reduced", "recurrentgemma-9b-reduced",
               "qwen2-moe-a2.7b-reduced")


@pytest.fixture
def small_shapes(monkeypatch):
    for name, info in SMALL.items():
        monkeypatch.setitem(RD.INPUT_SHAPES, name, info)
        monkeypatch.setitem(D.INPUT_SHAPES, name, info)


def test_tables_match_reference():
    assert ASSIGNED_ARCHS == REF_ARCHS
    assert D.INPUT_SHAPES == RD.INPUT_SHAPES
    for arch in ASSIGNED_ARCHS:
        for shape in D.INPUT_SHAPES:
            assert D.applicable(get_config(arch), shape) \
                == RD.applicable(ref_config(arch), shape)
            assert roofline.model_flops(arch, shape) \
                == RR.model_flops(arch, shape)


def _ref_rank_bytes(arch, sizes):
    """The reference's per-device parameter and moment bytes on a mesh of
    ``sizes``: ``param_pspecs`` of ``jax.eval_shape(M.init)`` on a stub
    mesh (``make_rules`` and ``param_pspecs`` read only its
    ``axis_names`` and ``devices.shape``)."""
    from repro.models import model as M
    from repro.optim.adamw import AdamW
    from repro.parallel import make_rules, param_pspecs
    cfg = ref_config(arch)
    mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values()),
                                                  dtype=np.int8))
    shapes = jax.eval_shape(lambda: M.init(jax.random.PRNGKey(0), cfg))
    specs = param_pspecs(cfg, shapes, make_rules(mesh, cfg), mesh)
    mom = jax.eval_shape(AdamW().init, shapes)

    def shard(leaf, spec):
        shape = list(leaf.shape)
        for i, ax in enumerate(spec):
            for a in (() if ax is None else
                      ax if isinstance(ax, tuple) else (ax,)):
                shape[i] //= sizes[a]
        return math.prod(shape) * leaf.dtype.itemsize

    def total(tree):
        return sum(jax.tree.leaves(jax.tree.map(shard, tree, specs)))
    return total(shapes), total(mom.mu) + total(mom.nu)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_rank_param_and_moment_bytes_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    with D.fake_grid(sizes) as groups:
        step = D.build_step(get_config(arch), sizes, "train_4k",
                            groups=groups)
        got = step.argument_bytes()
    params, moments = _ref_rank_bytes(arch, sizes)
    assert (got["param_bytes"], got["moment_bytes"]) == (params, moments)
    rows = D.INPUT_SHAPES["train_4k"]["batch"] // D.data_size(sizes)
    assert got["argument_bytes"] == params + moments + got["batch_bytes"]
    assert got["batch_bytes"] >= 4 * rows * 4096 * 4


def _ref_cost(arch, shape):
    from repro.compat import make_mesh
    from repro.launch.breakdown import flops_breakdown as ref_breakdown
    from repro.launch.hlo_analysis import analyze as ref_analyze
    mesh = make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    fn, args, _ = RD.build_step(ref_config(arch), mesh, shape)
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return ref_analyze(txt).flops, ref_breakdown(txt)


@pytest.mark.parametrize("shape", list(SMALL))
@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_flops_match_reference(arch, shape, small_shapes):
    ref_flops, ref_b = _ref_cost(arch, shape)
    rec = D.run_dryrun(arch, shape, None)
    rtol = TRAIN_RTOL if shape.startswith("train") else FWD_RTOL
    assert rec["hlo_flops_per_device"] == pytest.approx(ref_flops, rel=rtol)
    got_b = rec["flops_by_bucket"]
    attn = ("attention", "attention_bwd")
    assert sum(got_b.get(k, 0) for k in attn) == pytest.approx(
        sum(ref_b.get(k, 0) for k in attn), rel=ATTN_RTOL)
    assert got_b["unembed"] == ref_b["unembed"]
    if "moe" in arch:
        assert got_b["moe_experts"] == ref_b["moe_experts"]


def test_expert_parallel_dry_run_sends_an_even_share():
    """maverick's expert-parallel routing on meta (values unknown): every
    choice kept, each rank's experts an even share of every rank's rows.
    One layer on data 4 x model 2, 2 rows of 256 a data rank (512 tokens,
    top-1): six exchanges of 512 rows of d_model 5120 in bf16 (the
    forward's two, the remat recompute's two, the backward's two)."""
    rec = D.run_dryrun("llama4-maverick-400b-a17b",
                       dict(kind="train", seq=256, batch=8),
                       {"data": 4, "model": 2}, layers=1)
    assert rec["collective_counts"]["all-to-all"] == 6
    assert rec["collective_breakdown"]["all-to-all"] == 6 * 512 * 5120 * 2
    assert rec["flops_by_bucket"]["moe_experts"] > 0


def test_counter_on_known_programs():
    a = torch.empty(1024, 512, device="meta")
    b = torch.empty(512, 256, device="meta")
    c = analyze(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * 1024 * 512 * 256
    assert c.hbm_bytes == 4 * (1024 * 512 + 512 * 256 + 1024 * 256)
    assert c.output_bytes == 4 * 1024 * 256 and c.temp_bytes == 0

    def ten(x, y):
        for _ in range(10):
            x = x @ y
        return x
    s = torch.empty(512, 512, device="meta")
    c = analyze(ten, s, s)
    assert c.flops == 10 * 2 * 512 ** 3
    # a step's input and output alive at once, neither the returned one
    assert c.temp_bytes == 2 * 4 * 512 * 512
    assert c.output_bytes == 4 * 512 * 512

    def comms(group_size):
        import torch.distributed as dist
        x = torch.empty(64, 64, device="meta")
        dist.all_reduce(x)
        parts = [torch.empty_like(x) for _ in range(group_size)]
        dist.all_gather(parts, x)
        out = torch.empty(group_size * 16, 32, device="meta")
        dist.all_to_all_single(out, torch.empty_like(out))
        return out
    with D.fake_grid({"data": 8}):
        c = analyze(comms, 8)
    assert c.collective_breakdown == {"all-reduce": 4 * 64 * 64,
                                      "all-gather": 8 * 4 * 64 * 64,
                                      "all-to-all": 4 * 8 * 16 * 32}
    assert c.collective_counts == {"all-reduce": 1, "all-gather": 1,
                                   "all-to-all": 1}
    assert c.collective_bytes == sum(c.collective_breakdown.values())
    assert c.flops == 0


@pytest.mark.parametrize("cad", [False, True])
def test_profiler_buckets_match_counter(cad):
    """Each CPU op's bucket as ``device_breakdown`` finds it for the
    kernels an op launches (enclosing region ranges, backward nodes by
    sequence number) gives the op counter's FLOPs by bucket.  Early stop
    is off: with it, a recompute is cut inside the autograd layer of an
    op that the profiler has already recorded."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import set_checkpoint_early_stop
    products = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
    step = D.build_step(get_config("qwen2-moe-a2.7b-reduced"), None,
                        dict(kind="train", seq=512, batch=2), device="cpu",
                        cad=cad)
    with set_checkpoint_early_stop(False):
        cost, _, _ = D.analyze_step(step)
        with profile(activities=[ProfilerActivity.CPU],
                     with_flops=True) as prof:
            step.fn(*step.args)
    events = prof.events()
    bucket = cpu_op_buckets(events)
    got = {}
    for e in events:
        if e.name in products and e.flops and not (
                e.cpu_parent is not None and e.cpu_parent.name in products):
            got[bucket[id(e)]] = got.get(bucket[id(e)], 0) + e.flops
    assert got == flops_breakdown(cost)
    assert set(got) >= {"attention", "attention_bwd", "moe_experts",
                        "unembed", "fwd_other", "bwd_other"}


def test_device_breakdown_buckets_a_kernel_by_its_launch():
    """Kernels of a synthetic traced window (this build traces no card):
    each takes the bucket of the runtime call of its correlation id, by
    the ranges around that call.  A product in the unembed region and its
    backward (the node's forward op has its sequence number), a kernel
    launched straight from an attention region (as a ``ctypes`` kernel
    library launches), a kernel without a launch in the window; the
    region's own span on the device timeline and the lead-in are left
    out."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import EventList, FunctionEvent

    def ev(i, name, start, end, cuda=False, seq=-1):
        return FunctionEvent(
            id=i, name=name, thread=1, start_us=start, end_us=end,
            fwd_thread=1, sequence_nr=seq,
            device_type=DeviceType.CUDA if cuda else DeviceType.CPU)
    events = EventList([
        ev(1, "unembed", 0, 100), ev(2, "aten::mm", 10, 50, seq=7),
        ev(501, "cudaLaunchKernel", 20, 21),
        ev(3, "autograd::engine::evaluate_function: MmBackward0", 300, 400,
           seq=7),
        ev(4, "aten::mm", 310, 350), ev(502, "cudaLaunchKernel", 320, 321),
        ev(5, "attention", 600, 700), ev(503, "cudaLaunchKernel", 610, 611),
        ev(501, "gemm_fwd", 1000, 1060, cuda=True),
        ev(502, "gemm_bwd", 1100, 1200, cuda=True),
        ev(503, "ragged_mma_kernel", 1300, 1310, cuda=True),
        ev(504, "elementwise", 1400, 1402, cuda=True),
        ev(9, "attention", 1300, 1310, cuda=True),
        ev(505, "spin_kernel", 900, 990, cuda=True)])
    events._build_tree()
    bd = device_breakdown(events, skip="spin_kernel")
    got = {k: round(v, 6) for k, v in bd["buckets"].items() if v}
    assert got == {"unembed": 0.16, "attention": 0.01,
                   "unattributed": 0.002}
    assert bd["kernels"] == 4
    assert bd["busy_ms"] == pytest.approx(0.172)


def test_roofline_row_matches_reference():
    rec = {"arch": "llama3-8b", "shape": "train_4k", "mesh": [16, 16],
           "n_devices": 256, "cad": True,
           "hlo_flops_per_device": 4.8e14, "hlo_bytes_per_device": 9.1e12,
           "collective_bytes_per_device": 2.2e11, "peak_bytes": 9.0e9}
    got, ref = roofline.roofline_row(rec), RR.roofline_row(rec)
    from repro.core import cost_model as ref_rates
    from repro_torch.core import cost_model as rates
    for term, mine, theirs in (
            ("compute_s", rates.PEAK_FLOPS_BF16, ref_rates.PEAK_FLOPS_BF16),
            ("memory_s", rates.HBM_BW, ref_rates.HBM_BW),
            ("collective_s", rates.NVLINK_BW, ref_rates.ICI_BW)):
        assert got[term] * mine == pytest.approx(ref[term] * theirs,
                                                 rel=1e-12)
    assert got["useful_ratio"] == ref["useful_ratio"]
    assert got["fits_hbm"] and got["hint"]


def test_dryrun_cli_writes_reference_records(tmp_path):
    out = tmp_path / "dry.jsonl"
    base = ["--arch", "smollm-360m-reduced", "--shape", "train_4k",
            "--grid", "16x2", "--out", str(out)]
    assert dryrun.main(base) == 0
    assert dryrun.main(base + ["--cad"]) == 0
    plain, cad = (json.loads(line) for line in out.read_text().splitlines())
    ref_keys = {"arch", "shape", "cad", "pingpong", "skipped", "n_devices",
                "mesh", "argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes", "hlo_flops_per_device", "hlo_bytes_per_device",
                "collective_bytes_per_device", "collective_counts",
                "collective_breakdown"}
    for rec in (plain, cad):
        assert ref_keys | {"trace_s"} <= set(rec)
        assert rec["mesh"] == [16, 2] and rec["n_devices"] == 32
        assert rec["argument_bytes"] == rec["param_bytes"] \
            + rec["moment_bytes"] + rec["batch_bytes"]
        assert rec["peak_bytes"] == rec["argument_bytes"] \
            + rec["temp_bytes"] + rec["output_bytes"]
        assert rec["hlo_flops_per_device"] > 0
        assert rec["collective_breakdown"]["all-gather"] > 0
    assert not plain["cad"] and cad["cad"]
    assert "all-to-all" in cad["collective_breakdown"]
    assert "all-to-all" not in plain["collective_breakdown"]
    assert roofline.roofline_row(plain)["dominant"] in (
        "compute", "memory", "collective")
    with pytest.raises(NotImplementedError, match="grid decode step"):
        D.run_dryrun("smollm-360m-reduced", "decode_32k",
                     {"data": 4, "model": 2})
    skipped = D.run_dryrun("smollm-360m-reduced", "long_500k",
                           {"data": 4, "model": 2})
    assert skipped["skipped"] and "500K" in skipped["reason"]
