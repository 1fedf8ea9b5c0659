"""The port's elastic executor (``repro_torch.runtime.executor``), the
session's pool and the trainer's fault schedule (DESIGN.md §9, §14).

Against the reference's ``ElasticExecutor`` on the same numpy q/k/v and
one explicit cost grid (both sessions carry a calibrator built from the
same ``CostModel``; the two packages' analytic constants describe other
chips): outputs within the dispatch tests' f32 atol 2e-5, and equal
reports (failed, speculated, recovered blocks, epoch, server set,
events), ``step_seconds`` to 1e-12 relative, under fault-free,
``kill:2@1``, ``flap:1@0+2``, ``slow:3x4@0`` with speculation and a
masked kill.  Inside the port, bitwise: fault-free == ``_global_sim``,
kill == a fault-free run on the reduced pool, traced == untraced, two
replays of one schedule, streamed == unstreamed, a lost server's
recovery == fault-free.  The executor's wall timer reads the injectable
clock; only ``ServerLostError`` is demoted to a server failure.  The
trainer under ``kill:1@2`` excludes server 1 from every later plan and
keeps the unfaulted run's losses before the kill."""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cad import CADSession as JSession
from repro.core.cost_model import CommModel as JComm
from repro.core.cost_model import CostModel as JCost
from repro.core.cost_model import GridCalibrator as JCal
from repro.core.mask import MaskSpec as JMask
from repro.core.plan import CADConfig as JCfg
from repro.runtime import ElasticExecutor as JExecutor
from repro.runtime import FaultSchedule as JFaults
from repro.runtime import ServerPool as JPool
from repro_torch.cad import CADSession
from repro_torch.configs import get_config
from repro_torch.core import dispatch as D
from repro_torch.core.cost_model import CommModel, CostModel, GridCalibrator
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import CADConfig
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.launch import trace_report
from repro_torch.obs import FakeClock, MetricsRegistry, TraceRecorder
from repro_torch.obs import server_track
from repro_torch.runtime import (ElasticExecutor, FaultSchedule,
                                 PoolExhaustedError, ServerLostError,
                                 ServerPool)
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import to_numpy, to_torch

BLK = 16
OUT_TOL = dict(atol=2e-5, rtol=0)
SLIDING = dict(kind="sliding", window=2 * BLK, sink=0)


def make_segs(d, nb, seed=0, max_doc_blocks=4):
    rng = np.random.default_rng(seed)
    segs = np.zeros((d, nb * BLK), np.int32)
    sid = 1
    for r in range(d):
        t = 0
        while t < nb:
            dbl = int(rng.integers(1, min(max_doc_blocks, nb - t) + 1))
            segs[r, t * BLK:(t + dbl) * BLK] = sid
            sid += 1
            t += dbl
    return segs


def sliding_segs(d=3, nb=16):
    """The reference's masked-recovery layout: one deep document on the
    rank that dies, shallow ones on the others."""
    segs = np.zeros((d, nb * BLK), np.int32)

    def put(r, t0, n, sid):
        segs[r, t0 * BLK:(t0 + n) * BLK] = sid
        return t0 + n

    put(0, put(0, 0, 4, 1), 1, 2)
    t = put(1, 0, 8, 3)
    for i in range(4):
        t = put(1, t, 2, 4 + i)
    put(2, 0, 11, 8)
    return segs


def make_cfg(d, nb, **kw):
    return CADConfig(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb,
                     nkv=4 * nb, **kw)


def make_session(d=4, nb=8, **kw):
    kw.setdefault("comm", CommModel(2, 8, 2))
    kw.setdefault("tolerance", 0.05)
    kw.setdefault("jmax", nb)
    kw.setdefault("prefetch", 0)
    cfg_kw = {k: kw.pop(k) for k in ("stream_chunk",) if k in kw}
    return CADSession(cfg=make_cfg(d, nb, **cfg_kw), **kw)


def make_executor(session=None, *, faults=None, pool=None, **kw):
    session = session or make_session()
    session = session.with_pool(pool or ServerPool(session.cfg.n_servers))
    if isinstance(faults, str):
        faults = FaultSchedule.parse(faults)
    return ElasticExecutor(session, faults=faults, **kw)


def qkv(segs, seed=0, hq=2, hkv=2, dh=8):
    """Seeded numpy q/k/v [D, S, H, dh] and masked positions."""
    rng = np.random.default_rng(seed)
    d, s = segs.shape
    q = rng.standard_normal((d, s, hq, dh)).astype(np.float32)
    k = rng.standard_normal((d, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((d, s, hkv, dh)).astype(np.float32)
    pos = np.where(segs > 0, np.arange(s)[None, :], -1).astype(np.int32)
    return q, k, v, pos


def run(ex, segs, steps, seed=0):
    """``steps`` steps on one batch: (outputs as numpy, reports)."""
    q, k, v, pos = (to_torch(x) for x in qkv(segs, seed))
    outs, reps = [], []
    for step in range(steps):
        o, r = ex.run_step(step, q, k, v, pos, segs)
        outs.append(to_numpy(o))
        reps.append(r)
    return outs, reps


def bits(outs):
    return [o.tobytes() for o in outs]


# ------------------------------------------------- against the reference
CASES = {
    "fault-free": ("", {}, False),
    "kill:2@1": ("kill:2@1", {}, False),
    "flap:1@0+2": ("flap:1@0+2", {}, False),
    "slow:3x4@0+speculate": ("slow:3x4@0", {"speculate_pct": 0.9}, False),
    "masked-kill:1@0": ("kill:1@0", {}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_executor_matches_reference(case):
    """Three steps on both packages' executors under one cost grid: the
    same reports, outputs within f32 atol 2e-5."""
    spec, kw, masked = CASES[case]
    d, nb = (3, 16) if masked else (4, 8)
    segs = sliding_segs(d, nb) if masked else make_segs(d, nb, seed=7)
    cm = CostModel.analytic(2, 8)
    jcfg = JCfg(**dataclasses.asdict(make_cfg(d, nb)))
    jsess = JSession(cfg=jcfg, comm=JComm(2, 8, 2), tolerance=0.05,
                     jmax=nb, prefetch=0,
                     calibrator=JCal(JCost.from_dict(cm.to_dict()), d),
                     mask=JMask(**SLIDING) if masked else None)
    jex = JExecutor(jsess.with_pool(JPool(d)),
                    faults=JFaults.parse(spec), **kw)
    ex = make_executor(make_session(
        d, nb, calibrator=GridCalibrator(cm, d),
        mask=MaskSpec(**SLIDING) if masked else None), faults=spec, **kw)
    q, k, v, pos = qkv(segs, seed=3)
    jin = [jnp.asarray(x) for x in (q, k, v, pos)]
    tin = [to_torch(x) for x in (q, k, v, pos)]
    faulted = False
    for step in range(3):
        jout, jrep = jex.run_step(step, *jin, segs)
        out, rep = ex.run_step(step, *tin, segs)
        faulted |= bool(rep.failed or rep.speculated)
        np.testing.assert_allclose(to_numpy(out), np.asarray(jout),
                                   **OUT_TOL)
        for f in ("step", "epoch", "failed", "speculated",
                  "recovered_blocks", "events", "deadline"):
            assert getattr(rep, f) == getattr(jrep, f), (step, f)
        assert rep.server_seconds.keys() == jrep.server_seconds.keys()
        assert rep.recovery_seconds.keys() == jrep.recovery_seconds.keys()
        assert rep.step_seconds == pytest.approx(jrep.step_seconds,
                                                 rel=1e-12)
    assert faulted == bool(spec)


# ----------------------------------------------------- inside the port
def test_fault_free_equals_global_sim():
    d, nb = 3, 6
    segs = make_segs(d, nb, seed=5)
    ex = make_executor(make_session(d, nb))
    (out,), (rep,) = run(ex, segs, 1, seed=2)
    plan, _ = ex.session.plan(segs)
    q, k, v, pos = (to_torch(x) for x in qkv(segs, seed=2))
    cad = D.CADContext(cfg=ex.session.cfg, jmax=ex.session.jmax)
    ref = D._global_sim(q, k, v, pos, plan.to("cpu"), cad, 0.0, None)
    assert out.tobytes() == to_numpy(ref).tobytes()
    assert rep.failed == () and rep.recovered_blocks == 0


@pytest.mark.parametrize("stream_chunk", [0, 2])
def test_kill_bitwise_equal_to_reduced_pool(stream_chunk):
    """A server killed mid-step: steps 1 and 2 bitwise equal to a
    fault-free run on the pool without it, and to the fault-free full
    pool (one batch); streamed serves (``stream_chunk`` 2) give the
    unstreamed bits."""
    d, nb = 4, 8
    segs = make_segs(d, nb, seed=7)
    sess = lambda: make_session(d, nb, stream_chunk=stream_chunk)  # noqa
    outs, reps = run(make_executor(sess(), faults="kill:2@1"), segs, 3, 9)
    assert reps[1].failed == (2,) and reps[1].recovered_blocks > 0
    assert reps[2].epoch == reps[1].epoch + 1
    assert 2 not in reps[2].server_seconds
    reduced = ServerPool(d)
    reduced.remove(2)
    b_outs, b_reps = run(make_executor(sess(), pool=reduced), segs, 3, 9)
    assert bits(outs[1:]) == bits(b_outs[1:])
    assert reps[2].step_seconds == pytest.approx(b_reps[2].step_seconds,
                                                 rel=1e-12)
    free, _ = run(make_executor(make_session(d, nb)), segs, 1, 9)
    assert bits(outs) == bits(free * 3)


def test_traced_equals_untraced_and_narrates():
    faults = "kill:1@1"
    d, nb = 4, 8
    segs = make_segs(d, nb, seed=1)
    base, _ = run(make_executor(faults=faults), segs, 3)
    rec, mx = TraceRecorder(capacity=4096), MetricsRegistry()
    traced, reps = run(make_executor(faults=faults, recorder=rec,
                                     metrics=mx), segs, 3)
    assert len(rec) > 0 and bits(base) == bits(traced)
    evs = rec.events()
    kills = [e for e in evs if e.name == "kill"]
    assert [(e.track, e.step) for e in kills] == [(server_track(1), 1)]
    recovers = [e for e in evs if e.name == "recover" and e.step == 1]
    assert recovers and all(e.track != server_track(1) for e in recovers)
    steps = sorted((e for e in evs if e.name == "step"),
                   key=lambda e: e.step)
    for prev, nxt in zip(steps, steps[1:]):
        assert nxt.ts == pytest.approx(prev.ts + prev.dur)
    assert mx.counter("cad_failures_total").value() == 1.0
    assert mx.counter("cad_recovered_blocks_total").value() \
        == float(sum(r.recovered_blocks for r in reps))
    assert mx.gauge("cad_pool_epoch").value() == reps[-1].epoch
    # the trace feeds the straggler report
    a = trace_report.attribute_step(
        trace_report.load_steps(rec.to_chrome_trace())[1])
    totals = {s: reps[1].server_seconds.get(s, 0.0)
              + reps[1].recovery_seconds.get(s, 0.0)
              for s in reps[1].server_seconds}
    assert a["server"] == max(sorted(totals), key=lambda s: totals[s])
    assert "kill" in a["events"]


def test_replays_of_one_schedule_are_bitwise_equal():
    d, nb = 3, 6
    segs = make_segs(d, nb, seed=17)
    fs = FaultSchedule.random(d, 5, seed=4, p_kill=0.05, p_slow=0.2,
                              p_flap=0.05, max_kills=1)

    def once():
        outs, reps = run(make_executor(make_session(d, nb), faults=fs,
                                       speculate_pct=0.9), segs, 5)
        return bits(outs), [(r.step_seconds, r.failed, r.speculated,
                             r.events) for r in reps]
    a = once()
    assert a == once()
    assert any(r[1] or r[2] for r in a[1])


def test_speculation_bitwise_and_faster():
    d, nb = 4, 8
    segs = make_segs(d, nb, seed=13)
    ref, _ = run(make_executor(make_session(d, nb)), segs, 1, 3)
    outs, (rep,) = run(make_executor(
        make_session(d, nb), faults="slow:1x8@0-1", speculate_pct=0.9,
        speculate_slack=1.2), segs, 1, 3)
    assert rep.speculated == (1,) and bits(outs) == bits(ref)
    assert rep.step_seconds < max(rep.server_seconds.values())


def test_events_on_servers_in_other_states():
    """A drain after a kill is skipped; a kill striking a draining server
    fells it so its flap rejoin fires later (the reference's semantics)."""
    d, nb = 3, 6
    segs = make_segs(d, nb, seed=23)
    ex = make_executor(make_session(d, nb), faults="kill:1@0,drain:1@2")
    run(ex, segs, 4)
    assert ex.pool.status(1) == "dead"
    ex2 = make_executor(make_session(d, nb),
                        faults="drain:1@0,flap:1@1+2")
    _, reps = run(ex2, segs, 4)
    assert [len(r.server_seconds) for r in reps] == [2, 2, 2, 3]
    assert ex2.pool.status(1) == "active"
    ex3 = make_executor(make_session(d, nb), faults="flap:0@1+2")
    _, reps = run(ex3, segs, 4)
    assert [len(r.server_seconds) for r in reps] == [3, 2, 2, 3]
    assert reps[1].epoch < reps[2].epoch < reps[3].epoch


def test_executor_validates_and_exhausts():
    with pytest.raises(ValueError):
        ElasticExecutor(make_session())
    with pytest.raises(NotImplementedError, match="ping-pong"):
        ElasticExecutor(make_session(pingpong=True).with_pool(
            ServerPool(4)))
    with pytest.raises(ValueError):
        make_executor(timer="sundial")
    with pytest.raises(ValueError):
        make_executor(speculate_pct=1.5)
    pool = ServerPool(2)
    pool.remove(0)
    ex = make_executor(make_session(2, 4), pool=pool, faults="kill:1@0")
    with pytest.raises(PoolExhaustedError):
        run(ex, make_segs(2, 4), 1)


def test_lost_server_is_recovered_other_errors_propagate(monkeypatch):
    """A serve raising ``ServerLostError`` is a server failure: its tasks
    are recovered bitwise, it leaves the pool, the trace marks a
    serve-error.  A kernel's refusal (ValueError) or a CUDA error
    (RuntimeError) propagates instead of being recovered elsewhere."""
    import repro_torch.runtime.executor as E
    d, nb = 4, 8
    segs = make_segs(d, nb, seed=7)
    ref, _ = run(make_executor(make_session(d, nb)), segs, 1)
    serve = E.serve_task_batch
    for exc in (ServerLostError("endpoint gone"),
                ValueError("ca_server kernel: head_dim 7"),
                RuntimeError("CUDA error: an illegal memory access")):
        calls = []

        def failing(cad, inputs_s, plan_s, exc=exc, calls=calls):
            calls.append(1)
            if len(calls) == 2:            # the second server's serve
                raise exc
            return serve(cad, inputs_s, plan_s)
        monkeypatch.setattr(E, "serve_task_batch", failing)
        rec = TraceRecorder(capacity=256)
        ex = make_executor(make_session(d, nb), recorder=rec,
                           metrics=MetricsRegistry())
        if not isinstance(exc, ServerLostError):
            with pytest.raises(type(exc)):
                run(ex, segs, 1)
            continue
        outs, (rep,) = run(ex, segs, 1)
        assert rep.failed == (1,) and rep.recovered_blocks > 0
        assert bits(outs) == bits(ref)
        assert "serve-error 1: ServerLostError" in rep.events
        assert "remove 1 (serve error)" in rep.events
        assert ex.pool.status(1) == "dead"
        assert [e.track for e in rec.events() if e.name == "serve-error"] \
            == [server_track(1)]


def test_wall_timer_reads_the_injectable_clock():
    clock = FakeClock(tick=0.25)
    ex = make_executor(timer="wall", clock=clock)
    assert ex.clock is clock
    _, (rep,) = run(ex, make_segs(4, 8), 1)
    assert clock.reads == 2 * len(rep.server_seconds)
    assert all(sec == pytest.approx(0.25)
               for sec in rep.server_seconds.values())
    model_clock = FakeClock(tick=1.0)
    _, (rep,) = run(make_executor(timer="model", clock=model_clock),
                    make_segs(4, 8), 1)
    assert model_clock.reads == 0
    assert all(sec > 0 for sec in rep.server_seconds.values())


def test_calibration_residual_gauge_under_a_slow_server():
    """Model timer: measured = predicted x slow, so a 2x-slowed server
    shows residual 0.5 and healthy ones exactly 0."""
    mx = MetricsRegistry()
    run(make_executor(faults="slow:1x2@0-9", metrics=mx), make_segs(4, 8),
        2)
    resid = mx.gauge("cad_calib_residual", labels=("server",))
    assert resid.value(server=1) == pytest.approx(0.5)
    assert resid.value(server=0) == pytest.approx(0.0)


def test_speculation_prices_masked_tasks_by_live_kv():
    d, nb = 3, 16
    segs = sliding_segs(d, nb)
    sess = make_session(d, nb, mask=MaskSpec(**SLIDING))
    ex = make_executor(sess)
    q, k, v, pos = (to_torch(x) for x in qkv(segs))
    st = ex.begin_step(0, q, k, v, pos, segs)
    live, rect = {}, {}
    for s, _slot, qt, kvt in D.iter_plan_tasks(sess.cfg, st.plan,
                                               sess.mask):
        live.setdefault(s, []).append((qt, kvt))
    for s, _slot, qt, kvt in D.iter_plan_tasks(sess.cfg, st.plan):
        rect.setdefault(s, []).append((qt, kvt))
    assert {s: t for s, t in st.tasks_by.items() if t} == live != rect
    for s in live:
        want = sum(float(st.cm.predict(qt, kvt)) for qt, kvt in live[s])
        assert st.preds[s] == pytest.approx(want / float(st.speeds[s]),
                                            rel=1e-12)


def test_synth_inputs_geometry():
    ex = make_executor()
    segs = make_segs(4, 8)
    pos = np.broadcast_to(np.arange(segs.shape[1]), segs.shape).copy()
    q, k, v, p = ex.synth_inputs(segs, pos, seed=1, device="cpu")
    assert q.shape == (4, 8 * BLK, 2, 8) and k.shape == v.shape
    assert torch.equal(q, ex.synth_inputs(segs, pos, seed=1,
                                          device="cpu")[0])
    assert int(p.min()) == -1 or (segs > 0).all()


# ------------------------------------------------ session pool, prefetch
def test_with_pool_validates_and_stamps_plans():
    sess = make_session(4, 8)
    with pytest.raises(ValueError):
        sess.with_pool(ServerPool(3))
    pool = ServerPool(4)
    sess = sess.with_pool(pool)
    segs = make_segs(4, 8)
    _, stats = sess.plan(segs)
    assert (stats["pool_epoch"], stats["pool_active"]) == (0.0, 4.0)
    pool.drain(3)
    plan, stats = sess.plan(segs)
    assert (stats["pool_epoch"], stats["pool_active"]) == (1.0, 3.0)
    assert np.asarray(plan["task_kv_len"])[3].sum() == 0
    assert sess.admission_view()[1].epoch == 1


def test_prefetched_plans_replan_on_epoch_change():
    """A membership change mid-stream: every batch pulled after it was
    prefetched under the old epoch and is re-planned at pull
    (``_plan_stale``) against the survivors."""
    d, nb = 2, 4
    pool = ServerPool(d)
    sess = make_session(d, nb, prefetch=2).with_pool(pool)
    segs = make_segs(d, nb)
    stale = []
    is_stale = sess._plan_stale
    object.__setattr__(sess, "_plan_stale",
                       lambda b: stale.append(is_stale(b)) or stale[-1])

    def batches(n):
        for _ in range(n):
            yield {"segment_ids": segs.reshape(d * 2, -1)}
    gen = sess.attach_plans(batches(6))
    first = next(gen)
    assert first["schedule_stats"]["pool_epoch"] == 0.0
    pool.remove(1)
    got = list(gen)
    assert len(got) == 5 and any(stale)
    for b in got:
        assert b["schedule_stats"]["pool_epoch"] == 1.0
        assert np.asarray(b["plan"]["task_kv_len"])[1].sum() == 0
    assert "cad-plan-prefetch" not in [t.name for t in threading.enumerate()]


# ---------------------------------------------------------------- trainer
ARCH = "smollm-360m-reduced"


def test_train_with_fault_schedule():
    """``kill:1@2`` on the fused path over 3 steps: finite losses, the
    epoch bumps at step 2 with 1 of 2 servers left, the plan of step 2
    gives server 1 no task, and steps 0-1 keep the losses of the run
    without a schedule bitwise (the kill has not landed yet)."""
    cfg = get_config(ARCH)
    pipe = PipelineConfig(distribution="pretrain", max_doc_len=256,
                          seq_len=256, global_batch=4, n_ranks=2,
                          vocab_size=cfg.vocab_size, seed=3)
    runs = {}
    for spec in ("", "kill:1@2"):
        sess = CADSession.for_pipeline(cfg, pipe, plan_policy="balanced")
        if spec:    # the trainer keeps a pool it is given
            sess = sess.with_pool(ServerPool(2))
        plans = []

        def recording(batches, attach=sess.attach_plans, plans=plans):
            gen = attach(batches)
            try:
                for b in gen:
                    plans.append(b["plan"])
                    yield b
            finally:
                gen.close()
        object.__setattr__(sess, "attach_plans", recording)
        tc = TrainConfig(steps=3, peak_lr=1e-3, warmup=1, log_every=1,
                         fault_schedule=spec)
        res = train(cfg, pipe, tc, session=sess, device="cpu")
        runs[spec] = (res["history"], plans)
    hist, plans = runs["kill:1@2"]
    base, _ = runs[""]
    assert all(np.isfinite(m["loss"]) for m in hist)
    assert [m["sched_pool_epoch"] for m in hist] == [0.0, 0.0, 1.0]
    assert hist[2]["sched_pool_active"] == 1.0
    assert hist[2]["pool_events"] == "kill 1"
    assert np.asarray(plans[2]["task_kv_len"])[1].sum() == 0
    assert [m["loss"] for m in hist[:2]] == [m["loss"] for m in base[:2]]


def test_launcher_fault_schedule_trace_metrics_and_checkpoints(tmp_path,
                                                               capsys):
    """The launcher with ``--fault-schedule kill:1@2 --trace --metrics
    --ckpt-dir --ckpt-every 2`` on the CPU: finite losses, a trace the
    report reads, the metrics JSON, and a checkpoint ``latest_step``
    finds."""
    import json
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.train import main
    from repro_torch.obs import (get_recorder, get_registry, set_recorder,
                                 set_registry)
    prev = get_recorder(), get_registry()
    set_registry(MetricsRegistry())
    try:
        res = main(["--arch", ARCH, "--device", "cpu", "--cad", "--ranks",
                    "2", "--steps", "4", "--seq", "256", "--batch", "4",
                    "--fault-schedule", "kill:1@2", "--trace",
                    str(tmp_path / "t.json"), "--metrics",
                    str(tmp_path / "m.json"), "--ckpt-dir",
                    str(tmp_path / "ck"), "--ckpt-every", "2"])
    finally:
        set_recorder(prev[0])
        set_registry(prev[1])
    assert all(np.isfinite(m["loss"]) for m in res["history"])
    assert "step     2 pool: kill 1 (epoch 1)" in capsys.readouterr().out
    trace = json.loads((tmp_path / "t.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"plan.build", "pool.remove"} <= names
    trace_report.main([str(tmp_path / "t.json")])
    assert capsys.readouterr().out.splitlines()[0].split()[0] == "step"
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert "cad_pool_epoch" in json.dumps(metrics)
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2

