"""The readers of the program's spans (``spans.py``, ``metrics/
batch_wait_ms.py``, ``plan_build_ms.py``, ``optimizer_ms.py``,
``model_idle_ms.py``): known values on a traced window built by hand,
nothing read from a window without spans, the seven other readers
unmoved by spans, and the span records of a tiny cell driven on the
CPU."""
import copy
import importlib.util
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cadbench import harness
from cadbench.records import Records
from cadbench.spans import anchor_offset_us, span_records
from conftest import REPO, tiny_cell

NEW = ("batch_wait_ms", "plan_build_ms", "optimizer_ms", "model_idle_ms")
TRAINER = ("train.step", "train.batch_wait", "train.h2d", "train.forward",
           "train.backward", "optim.update", "train.readback")


def _reader(name):
    path = REPO / "cadbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"spans_test_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, step, start, end, kernel_us=0.0):
    return {"name": name, "track": "train", "step": step, "start": start,
            "end": end, "args": {}, "kernel_us": kernel_us, "n_kernels": 0}


def _kernel(start, end, family="other", bucket="fwd_other", short=None):
    return {"name": "k", "start": start, "end": end, "family": family,
            "short": short, "bucket": bucket}


def _window():
    """Steps 5 and 6 traced (µs on the profiler's timeline)."""
    kernels = [_kernel(100, 200, bucket="dispatch"),
               _kernel(150, 300, "matmuls (cuBLAS)"),
               _kernel(400, 800, "CA-server kernels", "attention",
                       "ca_fwd_mma"),
               _kernel(1300, 1900, "CA-server kernels", "attention_bwd",
                       "ca_dq_mma")]
    shape = json.loads((REPO / "cadbench" / "configs" / "smollm-360m.json")
                       .read_text())["shape"]
    steps = [{"tokens": 1000, "segments": [600, 400], "fwd_passes": 64}
             for _ in range(2)]
    rec = Records(shape=shape, kernels=kernels, window_s=0.0025,
                  steps=steps, busy_s=0.0014)
    spans = [_span("train.step", 5, 0, 1000),
             _span("train.step", 6, 1000, 2000),
             _span("train.batch_wait", 5, 0, 100),
             _span("train.batch_wait", 6, 1000, 1300),
             _span("plan.build", 5, -5000, -4000),
             _span("plan.build", 6, -3000, -1000),
             _span("plan.build", 6, 1000, 1500),        # a re-plan at pull
             _span("plan.build", 7, 500, 600),          # not trained on
             _span("optim.update", 5, 900, 950, kernel_us=300.0),
             _span("optim.update", 6, 1900, 1950, kernel_us=500.0),
             _span("train.forward", 5, 100, 500),
             _span("train.backward", 5, 500, 900),
             _span("train.forward", 6, 1300, 1600),
             _span("train.backward", 6, 1600, 1900)]
    return rec, spans


def test_readers_give_known_values():
    rec, spans = _window()
    rec.spans = spans
    got = {n: _reader(n)(rec) for n in NEW}
    # idle in the model's spans: step 5 [100, 900] less the union of
    # [100, 300] and [400, 800]; step 6 [1300, 1900] fully covered
    assert got == pytest.approx({"batch_wait_ms": 0.2,
                                 "plan_build_ms": (1.0 + 2.5) / 2,
                                 "optimizer_ms": 0.4,
                                 "model_idle_ms": 0.1})


def test_spans_move_no_other_reader():
    """Without spans the new readers read nothing; every reader of the
    benchmark reads the same with them as without."""
    plain, spans = _window()
    for n in NEW:
        assert _reader(n)(plain) is None
    traced = copy.deepcopy(plain)
    traced.spans = spans
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"] if m["name"] not in NEW]
    assert len(names) == 7
    for n in names:
        want = _reader(n)(plain)
        assert want is not None, n
        assert _reader(n)(traced) == want, n


def test_tiny_cell_driven_on_the_cpu_gives_span_records(bench_copy):
    """The recorder on from the drive's start and a CPU profiler over the
    window: every step of the window has each trainer span once, its
    ``data.next`` and its ``plan.build`` (planned ahead on the prefetch
    thread), placed by the anchor inside the profiler's own ranges of the
    mirrored spans."""
    from repro_torch.obs import trace as obs_trace
    torch.set_num_threads(4)
    cell = harness.load_cell(tiny_cell(bench_copy)["name"], bench_copy)
    prev = obs_trace.get_recorder()
    rec = obs_trace.enable_tracing()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            anchor = rec.clock_anchor()
            obs = harness.drive(cell, 2 ** 31 + 17, "cpu", seconds=4.0)
    finally:
        obs_trace.set_recorder(prev)
    events = prof.events()
    offset, err = anchor_offset_us(anchor, events)
    assert 0 < err < 1000
    assert obs.window_steps
    spans = span_records(rec.events(), offset, events, obs.window_steps)
    for k in obs.window_steps:
        mine = [s["name"] for s in spans if s["step"] == k]
        for name in TRAINER + ("data.next", "plan.build"):
            assert mine.count(name) == 1, (k, name, mine)
    assert all(s["kernel_us"] == 0 for s in spans)      # no card here
    for name in ("train.batch_wait", "optim.update", "train.readback"):
        ranges = [e.time_range for e in events if e.name == name]
        for s in (s for s in spans if s["name"] == name):
            assert any(s["start"] - err <= r.start and
                       r.end <= s["end"] + err for r in ranges), name
