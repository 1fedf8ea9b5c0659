"""The training path's spans (DESIGN.md §14) on the CPU: one span call
that feeds the recorder and, with ``profiled=True``, the profiler; the
clock anchor that puts recorder times on the profiler's timeline; the six
trainer spans of each step with the batch ids of the ``data.next`` and
``plan.build`` that fed it; mirrored spans that are root CPU events
enclosing no model region; and losses bitwise equal with tracing on."""
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.cad import CADSession
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.regions import REGIONS
from repro_torch.obs.trace import ANCHOR, TraceRecorder
from repro_torch.train.trainer import TrainConfig, train

# one intra-op thread: the bitwise comparison of losses needs the same
# reduction order in both runs
torch.set_num_threads(1)

ARCH = "smollm-360m-reduced"
PIPE = dict(distribution="prolong", max_doc_len=256, seq_len=256,
            global_batch=4, n_ranks=2, seed=0)
CHILDREN = ("train.batch_wait", "train.h2d", "train.forward",
            "train.backward", "optim.update", "train.readback")
MIRRORED = ("train.batch_wait", "train.h2d", "optim.update",
            "train.readback")


@pytest.fixture
def recorder():
    """A live global recorder, the previous one restored after."""
    prev = obs_trace.get_recorder()
    rec = obs_trace.enable_tracing()
    yield rec
    obs_trace.set_recorder(prev)


def _train(steps, prefetch=2):
    cfg = get_config(ARCH)
    pipe = PipelineConfig(**dict(PIPE, vocab_size=cfg.vocab_size))
    session = CADSession.for_pipeline(cfg, pipe, prefetch=prefetch)
    res = train(cfg, pipe, TrainConfig(steps=steps, peak_lr=1e-3, warmup=1,
                                       log_every=1),
                session=session, device="cpu")
    return [h["loss"] for h in res["history"]]


def _spans(rec, name):
    return [e for e in rec.events() if e.name == name]


def _event(events, name):
    return next(e for e in events if e.name == name)


def test_anchor_places_a_span_around_a_profiler_range():
    """A recorder span around a known profiler range lands around it on
    the profiler's timeline, within the anchor's error."""
    rec = TraceRecorder()
    assert rec.clock_anchor() is None           # no profiler runs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchor = rec.clock_anchor()
        time.sleep(0.002)
        with rec.span("outer", "t"):
            with torch.profiler.record_function("known"):
                time.sleep(0.005)
    events = prof.events()
    a = _event(events, ANCHOR)
    offset, err = anchor.offset_us(a.time_range.start, a.time_range.end)
    assert 0 < err < 1000
    span = _spans(rec, "outer")[0]
    known = _event(events, "known").time_range
    start = span.ts * 1e6 + offset
    end = (span.ts + span.dur) * 1e6 + offset
    assert start <= known.start + err and end >= known.end - err
    # the known range is 5 ms of a span only a little longer
    assert (end - start) - (known.end - known.start) < 2000 + 2 * err
    doc = rec.to_chrome_trace(offset, anchor)
    x = next(e for e in doc["traceEvents"] if e.get("name") == "outer")
    assert x["ts"] == pytest.approx(start)
    lo, hi = doc["otherData"]["clock_anchor_us"]
    assert lo <= (a.time_range.start + a.time_range.end) / 2 + err
    assert hi >= (a.time_range.start + a.time_range.end) / 2 - err


def test_disabled_span_without_profiler_records_and_enters_nothing(
        monkeypatch):
    """With no profiler and the recorder disabled a span, profiled or
    not, is the shared null span: nothing recorded, no profiler range."""
    entered = []
    monkeypatch.setattr(obs_trace, "_profiler_range",
                        lambda name: entered.append(name))
    rec = TraceRecorder(enabled=False)
    for profiled in (False, True):
        with rec.span("x", "t", step=0, profiled=profiled) as sp:
            pass
        assert sp is obs_trace._NULL_SPAN
    assert len(rec) == 0 and entered == []


@pytest.mark.parametrize("prefetch", [0, 2])
def test_trainer_spans_cover_every_step(recorder, prefetch):
    """Each step: one ``train.step`` with its six children, all with the
    step's batch id, which is that of a ``data.next`` and a
    ``plan.build`` (carrying the plan's figures); the children lie inside
    the step and cover at least 95% of it.  The replaced spans are
    gone."""
    steps = 3
    _train(steps, prefetch)
    names = {e.name for e in recorder.events()}
    assert not names & {"prefetch.plan", "schedule"}
    built = {e.step: e for e in _spans(recorder, "plan.build")}
    pulled = {e.step for e in _spans(recorder, "data.next")}
    for k in range(steps):
        (outer,) = [e for e in _spans(recorder, "train.step") if e.step == k]
        assert outer.track == "train"
        covered = 0.0
        for name in CHILDREN:
            (sp,) = [e for e in _spans(recorder, name) if e.step == k]
            assert outer.ts <= sp.ts and \
                sp.ts + sp.dur <= outer.ts + outer.dur
            covered += sp.dur
        assert covered >= 0.95 * outer.dur, (k, covered, outer.dur)
        assert k in pulled
        assert {"load_max_over_mean", "imbalance", "n_moves",
                "comm_bytes"} <= set(built[k].args)
        assert built[k].args["imbalance"] == pytest.approx(
            built[k].args["load_max_over_mean"] - 1.0)


def test_mirrored_spans_are_root_cpu_events(recorder):
    """Under a profiler the four mirrored spans are root CPU events, no
    model region lies inside one, the model's spans are not mirrored, and
    each lies inside its recorder span placed by the anchor."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchor = recorder.clock_anchor()
        _train(2, prefetch=0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    a = _event(events, ANCHOR)
    offset, err = anchor.offset_us(a.time_range.start, a.time_range.end)
    names = {e.name for e in events}
    assert not names & {"train.step", "train.forward", "train.backward"}
    assert set(REGIONS) & names      # the model's regions were entered
    for name in MIRRORED:
        got = sorted((e for e in events if e.name == name),
                     key=lambda e: e.time_range.start)
        spans = sorted(_spans(recorder, name), key=lambda e: e.ts)
        assert len(got) == len(spans) == 2, name
        for e, sp in zip(got, spans):
            assert e.cpu_parent is None, (name, e.cpu_parent.name)
            assert e.time_range.start >= sp.ts * 1e6 + offset - err
            assert e.time_range.end <= (sp.ts + sp.dur) * 1e6 + offset + err
    for e in events:
        if e.name in REGIONS:
            p = e.cpu_parent
            while p is not None:
                assert p.name not in MIRRORED, (e.name, p.name)
                p = p.cpu_parent


@pytest.mark.parametrize("view", ["recorder", "profiler"])
def test_traced_losses_are_bitwise_untraced(view):
    """Tracing observes and never perturbs: the same run's losses with
    the recorder on, or under a profiler, equal the untraced run's bit
    for bit."""
    base = _train(3)
    prev = obs_trace.get_recorder()
    try:
        if view == "recorder":
            obs_trace.enable_tracing()
            traced = _train(3)
        else:
            with profile(activities=[ProfilerActivity.CPU]):
                traced = _train(3)
    finally:
        obs_trace.set_recorder(prev)
    assert traced == base
