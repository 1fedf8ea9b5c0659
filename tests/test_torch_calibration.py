"""The port's runtime calibration loop (measure -> fit -> re-plan,
DESIGN.md §3): ``GridCalibrator``, ``probe_plan_times``, the session's
``observe*`` feedback, ``_plan_stale`` and the trainer's
``calibrate_every`` hook, and the launcher's ``--calibrate`` /
``--calibrate-every`` / ``--stream-chunk``.

Against the reference: the same observations give the calibrator the
same grid, speeds, version and state exactly; the probe reports the same
per-server task compositions (its times are this machine's).  Inside the
port: calibrated training gives the uncalibrated run's losses bitwise
(plans move tasks, not arithmetic)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro.core.cost_model import CostModel as JCost
from repro.core.cost_model import GridCalibrator as JCal
from repro.core.plan import CADConfig as JCfg
from repro_torch.cad import CADSession, GridCalibrator, PlanPrefetcher
from repro_torch.configs import get_config
from repro_torch.core import dispatch as D
from repro_torch.core.cost_model import CommModel, CostModel
from repro_torch.core.plan import CADConfig, PingPongPlan
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.models.model import Transformer
from repro_torch.obs import trace as obs_trace
from repro_torch.train.trainer import TrainConfig, train
# pins torch to one thread: with several, the port's CPU training is not
# bitwise repeatable (the same plans gave other step-1 losses in some runs)
import test_torch_helpers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BLK = 32
ARCH = "smollm-360m-reduced"
PIPE = dict(distribution="prolong", max_doc_len=256, seq_len=256,
            global_batch=4, n_ranks=2, seed=0,
            vocab_size=get_config(ARCH).vocab_size)


def make_cfg(d, nb, blk=BLK, speeds=None):
    return CADConfig(n_servers=d, blk=blk, nb=nb, cq=2 * nb, ckv=2 * nb,
                     nkv=4 * nb, server_speeds=speeds)


def uniform_doc_segs(d, nb, blk=BLK, doc_blocks=2):
    """Every rank packed with ``doc_blocks``-block documents."""
    segs = np.zeros((d, nb * blk), np.int32)
    sid = 1
    for r in range(d):
        for t in range(0, nb, doc_blocks):
            n = min(doc_blocks, nb - t)
            segs[r, t * blk:(t + n) * blk] = sid
            sid += 1
    return segs


def _session(d=2, nb=8, prefetch=0, ema=0.5, **kw):
    return CADSession(cfg=make_cfg(d, nb), comm=CommModel(2, 16, 2),
                      tolerance=0.05, prefetch=prefetch,
                      calibrator=GridCalibrator(CostModel.analytic(2, 16), d,
                                                ema=ema), **kw)


# ------------------------------------------------------------ calibrator
def _base_pair():
    """The same measured-style base grid in both packages (the analytic
    models differ: the port's carries the H100's peaks)."""
    base = JCost.analytic(4, 32)
    args = (base.q_grid, base.kv_grid, base.time_grid, 4, 32)
    return (JCost.from_grid(*args, peak_flops=base.peak_flops),
            CostModel.from_grid(*args, peak_flops=base.peak_flops))


@pytest.mark.parametrize("ema", [1.0, 0.5])
def test_grid_calibrator_matches_reference(ema):
    """The same observation stream (per task, per fused batch, with and
    without a server, degenerate samples, a server reset) gives the same
    grid, speeds, version and state_dict, exactly."""
    jbase, tbase = _base_pair()
    jcal = JCal(jbase, 3, ema=ema, prior_speeds=(1.0, 0.5, 1.0))
    tcal = GridCalibrator(tbase, 3, ema=ema, prior_speeds=(1.0, 0.5, 1.0))
    rng = np.random.default_rng(0)
    for i in range(40):
        s = int(rng.integers(3))
        kv = int(rng.choice([128, 300, 1024, 4096, 70000]))
        sec = float(rng.uniform(1e-5, 1e-2))
        for cal in (jcal, tcal):
            if i % 5 == 0:
                cal.observe_tasks([(128, kv), (64, 2 * kv), (0, 8)], sec,
                                  server=s)
            else:
                cal.observe(128, kv, sec, server=None if i % 7 == 0 else s)
            if i == 20:
                cal.reset_server(1, prior_speed=0.7)
    for cal in (jcal, tcal):
        cal.observe(128, 256, 0.0)                  # ignored
    assert tcal.version == jcal.version and \
        tcal.n_observations == jcal.n_observations
    np.testing.assert_array_equal(tcal.speeds(), jcal.speeds())
    js, ts = jcal.snapshot(), tcal.snapshot()
    assert ts.version == js.version and ts.speeds == js.speeds
    np.testing.assert_array_equal(ts.cost_model.time_grid,
                                  js.cost_model.time_grid)
    # assert_equal: the unobserved cells are NaN on both sides
    np.testing.assert_equal(tcal.state_dict(), jcal.state_dict())
    again = GridCalibrator(tbase, 3)
    again.load_state_dict(jcal.state_dict())
    np.testing.assert_equal(again.state_dict(), tcal.state_dict())


def test_calibrator_estimates_relative_speeds():
    """A server measuring 2x slower converges to speed 0.5, whatever the
    uniform hardware-vs-model scale."""
    base = CostModel.analytic(4, 32)
    truth = base.scaled(2.0)
    speeds = np.array([1.0, 0.5, 1.0])
    cal = GridCalibrator(base, n_servers=3, ema=0.5)
    rng = np.random.default_rng(0)
    for _ in range(40):
        s = int(rng.integers(3))
        kv = int(rng.choice([256, 1024, 4096]))
        cal.observe(128, kv, float(truth.predict(128, kv)) / speeds[s],
                    server=s)
    np.testing.assert_allclose(cal.speeds(), speeds, rtol=0.05)


# ----------------------------------------------------------------- probe
def test_probe_plan_times_matches_reference_compositions():
    """On the CPU the probe serves each server's batch (the plain
    versions) and reports the reference's per-server task compositions,
    with positive times, spans on the servers' tracks, and a session fed
    from it."""
    d, nb = 2, 2
    cfg = make_cfg(d, nb)
    session = CADSession(cfg=cfg, comm=CommModel(2, 8, 2), tolerance=0.05,
                         prefetch=0, jmax=cfg.nkv,
                         calibrator=GridCalibrator(CostModel.analytic(2, 8),
                                                   d))
    segs = uniform_doc_segs(d, nb)
    plan, _ = session.plan(segs)
    rec = obs_trace.enable_tracing()
    try:
        res = D.probe_plan_times(D.CADContext(cfg=cfg, jmax=cfg.nkv), plan,
                                 n_heads=2, head_dim=8, n_kv_heads=2,
                                 repeats=2, device="cpu")
    finally:
        obs_trace.disable_tracing()
    jcfg = JCfg(n_servers=d, blk=BLK, nb=nb, cq=2 * nb, ckv=2 * nb,
                nkv=4 * nb)
    jres = JD.probe_plan_times(JD.CADContext(cfg=jcfg, kernel="xla",
                                             jmax=jcfg.nkv), plan,
                               n_heads=2, head_dim=8, n_kv_heads=2)
    assert [(s, t) for s, t, _ in res] == [(s, t) for s, t, _ in jres]
    assert all(sec > 0 for _, _, sec in res)
    tracks = sorted(ev.track for ev in rec.events() if ev.name == "probe")
    assert tracks == [f"server/{s}" for s in range(d)]

    session.observe_probe(plan, dtype=torch.float32, device="cpu")
    assert session.calibrator.version > 0
    assert len(session.calibrator.speeds()) == d


def test_observe_plan_accepts_pingpong_plans():
    """The feedback channel takes both halves of a PingPongPlan, and the
    probe probes both."""
    session = _session(pingpong=True)
    plan, stats = session.plan(uniform_doc_segs(2, 16))
    assert isinstance(plan, PingPongPlan) and stats["calib_version"] == 0.0
    session.observe_plan(plan, np.full(2, 1e-3))
    v = session.calibrator.version
    assert v > 0
    session.observe_probe(plan, device="cpu")
    assert session.calibrator.version > v


def test_session_plan_annotates_calibration_stats():
    session = _session()
    segs = uniform_doc_segs(2, 8)
    _plan, stats = session.plan(segs)
    assert stats["calib_version"] == 0.0
    assert stats["calib_speed_0"] == stats["calib_speed_1"] == 1.0
    plain = CADSession(cfg=make_cfg(2, 8), comm=CommModel(2, 16, 2),
                       prefetch=0)
    assert "calib_version" not in plain.plan(segs)[1]
    snap, view = plain.admission_view()
    assert snap.version == -1 and view is None
    assert plain.snapshot_provider()().speeds == (1.0, 1.0)
    assert session.admission_view()[0] is session.calibrator.snapshot()


def test_plan_stale_on_speed_drift():
    """A prefetched plan is stale once the speeds it was planned from
    drift past ``recalib_threshold``; a new version with the same speeds,
    or no calibration stats, is not."""
    session = _session(ema=1.0)
    base = session.calibrator.base
    _plan, stats = session.plan(uniform_doc_segs(2, 8))
    batch = {"schedule_stats": stats}
    assert not session._plan_stale(batch)
    assert not session._plan_stale({"schedule_stats": {}})
    for s in range(2):                      # a new version, same speeds
        session.observe(BLK, 512, float(base.predict(BLK, 512)), server=s)
    assert not session._plan_stale(batch)
    session.observe(BLK, 512, 4 * float(base.predict(BLK, 512)), server=1)
    assert session._plan_stale(batch)


def test_attach_plans_refreshes_on_speed_drift():
    """Plans prefetched with stale speeds are re-planned at pull once
    feedback moves the speeds."""
    session = _session(prefetch=2, ema=1.0)
    base = session.calibrator.base
    segs = uniform_doc_segs(2, 8)
    gen = session.attach_plans({"segment_ids": segs.copy()}
                               for _ in range(4))
    assert next(gen)["schedule_stats"]["calib_version"] == 0.0
    for kv in (256, 512, 1024):
        session.observe(BLK, kv, float(base.predict(BLK, kv)), server=0)
        session.observe(BLK, kv, 4 * float(base.predict(BLK, kv)),
                        server=1)
    for _ in range(3):
        st = next(gen)["schedule_stats"]
        np.testing.assert_allclose(
            [st["calib_speed_0"], st["calib_speed_1"]], [1.0, 0.25])
    gen.close()


def test_prefetcher_stale_refresh():
    """Items planned ahead and flagged stale are re-planned at pull, in
    order."""
    calls = []

    def plan(x):
        item = x["item"] if isinstance(x, dict) else x
        calls.append(item)
        return {"item": item}

    pf = PlanPrefetcher(iter(range(4)), plan, depth=2,
                        is_stale=lambda it: it["item"] == 1)
    assert [o["item"] for o in pf] == [0, 1, 2, 3]
    assert pf.stale_refreshes == 1 and calls.count(1) == 2


# --------------------------------------------------- trainer and launcher
def test_for_pipeline_calibrates_and_streams():
    """``calibrate=True`` attaches a calibrator seeded with the declared
    speeds; ``stream_chunk`` reaches the pool config; ``with_pool``
    attaches an elastic pool of the session's size (it raised until the
    runtime was ported)."""
    cfg = get_config(ARCH)
    sess = CADSession.for_pipeline(cfg, PipelineConfig(**PIPE),
                                   calibrate=True, calib_ema=0.25,
                                   stream_chunk=2, server_speeds=(1.0, 0.5))
    assert sess.calibrator is not None and sess.calibrator.ema == 0.25
    np.testing.assert_allclose(sess.calibrator.speeds(), [1.0, 0.5])
    assert sess.cfg.stream_chunk == 2
    from repro_torch.runtime import ServerPool
    pooled = sess.with_pool(ServerPool(2, calibrator=sess.calibrator))
    assert pooled.pool.calibrator is sess.calibrator and sess.pool is None


def test_calibrated_training_losses_bitwise_equal_uncalibrated(
        monkeypatch):
    """Three steps with a probe after every step give the uncalibrated
    run's losses bitwise: the probes re-plan later steps, and a plan
    moves tasks, not arithmetic.  The probe runs, but its times (on the
    CPU, mostly noise) are replaced by each server's (q, kv) token pairs
    at a fixed rate, server 1 at half speed (the straggler the
    reference's benchmark injects), so the calibrated plans of steps 1
    and 2 must differ from the uncalibrated ones; the plans carry the
    calibration."""
    import repro_torch.cad.session as session_mod
    probe = session_mod.probe_plan_times

    def straggler_probe(*args, **kw):
        return [(s, tasks, sum(q * kv for q, kv in tasks) * 1e-9
                 * (2.0 if s == 1 else 1.0))
                for s, tasks, _ in probe(*args, **kw)]
    monkeypatch.setattr(session_mod, "probe_plan_times", straggler_probe)
    cfg = get_config(ARCH)
    pipe = PipelineConfig(**PIPE)
    runs, plans = {}, {}
    for calibrate in (False, True):
        sess = CADSession.for_pipeline(cfg, pipe, calibrate=calibrate,
                                       prefetch=2)
        taken = plans[calibrate] = []

        def recording(batches, attach=sess.attach_plans, taken=taken):
            gen = attach(batches)
            try:
                for b in gen:
                    taken.append(b["plan"])
                    yield b
            finally:
                gen.close()
        object.__setattr__(sess, "attach_plans", recording)   # frozen
        res = train(cfg, pipe, TrainConfig(steps=3, peak_lr=1e-3, warmup=1,
                                           log_every=1,
                                           calibrate_every=1),
                    model=Transformer(cfg, device="cpu", seed=0),
                    session=sess, device="cpu")
        runs[calibrate] = res["history"]
        if calibrate:
            assert sess.calibrator.version > 0
            assert sess.calibrator.n_observations > 0
            assert sess.calibrator.speeds()[1] < 0.6
    moved = [i for i, (a, b) in enumerate(zip(plans[False], plans[True]))
             if not all(np.array_equal(np.asarray(a[f]), np.asarray(b[f]))
                        for f in a)]
    assert moved == [1, 2]
    assert [h["loss"] for h in runs[True]] \
        == [h["loss"] for h in runs[False]]
    assert all("sched_calib_version" in h for h in runs[True])
    assert all("sched_calib_version" not in h for h in runs[False])


def test_launcher_calibrates_and_streams_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "2", "--seq", "256", "--batch", "4",
         "--ranks", "2", "--cad", "--calibrate", "--calibrate-every", "1",
         "--stream-chunk", "2"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and "done: loss" in proc.stdout
