"""The port's multi-tenant fabric (``repro_torch.fabric``, DESIGN.md §10)
against the reference's ``repro.fabric``, and the tests of
``tests/test_fabric.py`` ported.

Both packages price with one cost grid (the reference's analytic
``CostModel(2, 8)``, carried to the port by ``to_dict``, in a calibrator
that is never fed), so admission means the same thing on both sides.
Exactly equal: tenant classes, admission rounds, request task sequences
and fused-batch layouts (the port fed the reference's request arrays).
Within the f32 tolerance of ``tests/test_torch_runtime.py`` (atol 2e-5):
the outputs of mixed train + serve steps on the same numpy q/k/v, with
equal step reports.  Inside the port, bitwise: training outputs with
serve backfill == a dedicated pool, kill-mid-decode replays, a shared
pool's serve digests == a static partition's."""
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cad import CADSession as JSession
from repro.core.cost_model import CalibrationSnapshot as JSnap
from repro.core.cost_model import CommModel as JComm
from repro.core.cost_model import CostModel as JCost
from repro.core.cost_model import GridCalibrator as JCal
from repro.core.plan import CADConfig as JCfg
from repro.fabric import AdmissionPolicy as JPolicy
from repro.fabric import FabricExecutor as JFabric
from repro.fabric import ServeWorkload as JWorkload
from repro.fabric import SERVE as J_SERVE
from repro.fabric import TRAIN as J_TRAIN
from repro.fabric import admit_serve as j_admit_serve
from repro.fabric.tenancy import ServeTaskReq as JReq
from repro.runtime import FaultSchedule as JFaults
from repro.runtime import ServerPool as JPool
from repro_torch.cad import CADConfig, CADSession
from repro_torch.core.cost_model import (CalibrationSnapshot, CommModel,
                                         CostModel, GridCalibrator)
from repro_torch.fabric import (LATENCY, SERVE, THROUGHPUT, TRAIN,
                                AdmissionPolicy, FabricExecutor,
                                ServeWorkload, TenantClass, admit_serve)
from repro_torch.fabric.tenancy import ServeTaskReq
from repro_torch.runtime import ElasticExecutor, FaultSchedule, ServerPool
from test_torch_helpers import to_numpy, to_torch

BLK = 16
D, NB = 4, 8
OUT_TOL = dict(atol=2e-5, rtol=0)
# the reference's analytic model, the one grid both packages price with
J_CM = JCost.analytic(2, 8)
CM = CostModel.from_dict(J_CM.to_dict())


def make_segs(d=D, nb=NB, seed=0, max_doc_blocks=4):
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


def geo():
    return dict(n_servers=D, blk=BLK, nb=NB, cq=2 * NB, ckv=4 * NB,
                nkv=4 * NB)


def make_session(drained=()):
    sess = CADSession(cfg=CADConfig(**geo()), comm=CommModel(2, 8, 2),
                      tolerance=0.05, jmax=NB, prefetch=0,
                      calibrator=GridCalibrator(CM, D))
    pool = ServerPool(D)
    for s in drained:
        pool.drain(s)
    return sess.with_pool(pool)


def make_j_session(drained=()):
    sess = JSession(cfg=JCfg(**geo()), comm=JComm(2, 8, 2), tolerance=0.05,
                    jmax=NB, prefetch=0,
                    calibrator=JCal(JCost.from_dict(J_CM.to_dict()), D))
    pool = JPool(D)
    for s in drained:
        pool.drain(s)
    return sess.with_pool(pool)


def make_workload(arrivals, seed=7, slots=4, contents=None):
    return ServeWorkload(arrivals, n_heads=2, head_dim=8, blk=BLK,
                         slots=slots, seed=seed, contents=contents)


def make_j_workload(arrivals, seed=7, slots=4):
    return JWorkload(arrivals, n_heads=2, head_dim=8, blk=BLK, slots=slots,
                     seed=seed)


def contents_of(jwl):
    return [(r.qc, r.kc, r.vc) for r in jwl.requests]


def step_inputs(step, seed=0):
    """Seeded numpy q/k/v [D, S, 2, 8], masked positions, segment ids."""
    segs = make_segs(seed=step)
    rng = np.random.default_rng(seed + step)
    q, k, v = (rng.standard_normal(segs.shape + (2, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.where(segs > 0, np.arange(segs.shape[1])[None, :],
                   -1).astype(np.int32)
    return q, k, v, pos, segs


def run_fabric(arrivals, steps, *, drained=(), allowed=None, faults=None,
               interval=1e-3, speculate_pct=0.0, max_steps=None, seed=0,
               contents=None, record=None):
    wl = make_workload(arrivals, contents=contents)
    if record is not None:
        commit = wl.commit

        def recording(task, out_rows, step):
            record.append((task.rid, task.seq,
                           to_numpy(out_rows[:task.q_tokens])))
            commit(task, out_rows, step)
        wl.commit = recording
    ex = FabricExecutor(
        make_session(drained=drained), wl,
        faults=FaultSchedule.parse(faults) if faults else None,
        policy=AdmissionPolicy(allowed=allowed),
        speculate_pct=speculate_pct)
    outs, reports = [], []
    step = 0
    while step < steps or (max_steps and step < max_steps
                           and not wl.all_done()):
        q, k, v, pos, segs = step_inputs(step, seed)
        out, rep = ex.run_mixed_step(
            step, *(to_torch(x) for x in (q, k, v, pos)), segs,
            interval=interval)
        outs.append(to_numpy(out))
        reports.append(rep)
        step += 1
    return wl, outs, reports


def run_j_fabric(arrivals, steps, *, faults=None, interval=1e-3,
                 speculate_pct=0.0, max_steps=None, seed=0, record=None):
    wl = make_j_workload(arrivals)
    if record is not None:
        commit = wl.commit

        def recording(task, out_rows, step):
            record.append((task.rid, task.seq,
                           np.asarray(out_rows[:task.q_tokens])))
            commit(task, out_rows, step)
        wl.commit = recording
    ex = JFabric(make_j_session(), wl,
                 faults=JFaults.parse(faults) if faults else None,
                 policy=JPolicy(), speculate_pct=speculate_pct)
    outs, reports = [], []
    step = 0
    while step < steps or (max_steps and step < max_steps
                           and not wl.all_done()):
        q, k, v, pos, segs = step_inputs(step, seed)
        out, rep = ex.run_mixed_step(
            step, *(jnp.asarray(x) for x in (q, k, v, pos)), segs,
            interval=interval)
        outs.append(np.asarray(out))
        reports.append(rep)
        step += 1
    return wl, outs, reports


def bits(outs):
    return [o.tobytes() for o in outs]


def snap_of(cm=None, speeds=(1.0,) * D, version=0):
    return CalibrationSnapshot(version=version, cost_model=cm or CM,
                               speeds=tuple(speeds))


def task(rid, q=BLK, kv=2 * BLK, seq=0, arrival=0):
    return ServeTaskReq(rid=rid, seq=seq, q_tokens=q, kv_tokens=kv,
                        arrival_step=arrival)


COST = float(CM.predict(BLK, 2 * BLK))


# ===================================================================
# tenancy: classes + admission
# ===================================================================

def test_tenant_classes():
    assert TRAIN.kind == THROUGHPUT and SERVE.kind == LATENCY
    assert TRAIN.priority < SERVE.priority
    assert SERVE.preempts_speculation and not TRAIN.preempts_speculation
    assert (TRAIN, SERVE) == tuple(TenantClass(**vars(c))
                                   for c in (J_TRAIN, J_SERVE))
    with pytest.raises(ValueError, match="tenant kind"):
        TenantClass(name="x", kind="bursty", priority=2)


def test_admission_backfills_idle_capacity():
    """Tasks land on the candidate with the most remaining idle; busy
    servers receive nothing they cannot fit."""
    interval = 4 * COST
    busy = {0: interval, 1: interval - 2 * COST, 2: 0.0, 3: 0.0}
    rnd = admit_serve([task(r) for r in range(6)], busy, interval,
                      snap_of(), None, candidates=(0, 1, 2, 3))
    assert rnd.n_admitted == 6 and not rnd.deferred
    assert 0 not in rnd.placements
    placed = {s: len(t) for s, t in rnd.placements.items()}
    assert placed[2] + placed[3] >= 4
    assert sum(placed.values()) == 6
    assert all(v >= -1e-12 for v in rnd.idle_after.values())


def test_admission_fcfs_head_of_line_blocks():
    """The first unfittable task defers everything behind it."""
    small = task(1, q=1, kv=BLK)
    big = task(0, q=BLK, kv=2 * BLK)
    rnd = admit_serve([big, small], {0: 0.0}, 0.5 * COST, snap_of(), None,
                      candidates=(0,))
    assert rnd.n_admitted == 0
    assert [t.rid for t in rnd.deferred] == [0, 1]


def test_admission_forced_after_max_wait():
    """A head-of-line task past ``max_wait_rounds`` goes through with no
    idle budget left, and admission continues behind it."""
    pol = AdmissionPolicy(max_wait_rounds=3)
    rnd = admit_serve([task(0), task(1, q=1, kv=BLK)], {0: 0.0, 1: 0.0},
                      0.1 * COST, snap_of(), None, policy=pol,
                      candidates=(0, 1), waits={0: 3})
    assert rnd.forced == (0,)
    assert 0 in {t.rid for g in rnd.placements.values() for t in g}
    rnd2 = admit_serve([task(0), task(1, q=1, kv=BLK)], {0: 0.0, 1: 0.0},
                       0.1 * COST, snap_of(), None, policy=pol,
                       candidates=(0, 1))
    assert rnd2.n_admitted == 0 and len(rnd2.deferred) == 2


def test_admission_allowed_partition_and_slo():
    pol = AdmissionPolicy(slo_rounds=2, allowed=(2, 3))
    rnd = admit_serve([task(r) for r in range(4)],
                      {s: 0.0 for s in range(4)}, 1.01 * COST, snap_of(),
                      None, policy=pol, candidates=(0, 1, 2, 3),
                      waits={2: 2, 3: 5})
    assert set(rnd.placements) <= {2, 3}
    assert rnd.n_admitted == 2 and len(rnd.deferred) == 2
    assert rnd.slo_misses == 2
    assert rnd.pool_epoch == -1
    view = make_session().pool.view()
    rnd2 = admit_serve([], {}, 1.0, snap_of(), view)
    assert rnd2.pool_epoch == view.epoch


# the four rounds above, and a view-stamped one, against the reference's
ROUNDS = {
    "backfill": (6, {0: 4.0, 1: 2.0, 2: 0.0, 3: 0.0}, 4.0, {}, {}),
    "head-of-line": ("hol", {0: 0.0}, 0.5, {}, {}),
    "forced": ("pair", {0: 0.0, 1: 0.0}, 0.1, {"max_wait_rounds": 3},
               {0: 3}),
    "partition+slo": (4, {s: 0.0 for s in range(4)}, 1.01,
                      {"slo_rounds": 2, "allowed": (2, 3)}, {2: 2, 3: 5}),
    "view, speeds": (8, {0: 1.0, 1: 0.5, 2: 0.0, 3: 0.0}, 3.0, {}, {1: 9}),
}


def _round_tasks(spec):
    if spec == "hol":
        return [(0, BLK, 2 * BLK), (1, 1, BLK)]
    if spec == "pair":
        return [(0, BLK, 2 * BLK), (1, 1, BLK)]
    return [(r, BLK if r % 3 else 1, (r + 2) * BLK) for r in range(spec)]


def _round_fields(rnd):
    return (rnd.pool_epoch, rnd.calib_version,
            {s: [(t.rid, t.seq, t.q_tokens, t.kv_tokens) for t in ts]
             for s, ts in rnd.placements.items()},
            [(t.rid, t.seq) for t in rnd.deferred], rnd.forced,
            rnd.idle_before, rnd.idle_after, rnd.slo_misses)


@pytest.mark.parametrize("case", list(ROUNDS))
def test_admission_rounds_equal_reference(case):
    spec, busy, interval, pol, waits = ROUNDS[case]
    speeds = (1.0, 0.5, 2.0, 1.0) if case == "view, speeds" else (1.0,) * D
    tasks = _round_tasks(spec)
    busy = {s: b * COST for s, b in busy.items()}
    view = jview = None
    if case == "view, speeds":
        pool, jpool = ServerPool(D), JPool(D)
        for p in (pool, jpool):
            p.drain(3)
            p.remove(0)
        view, jview = pool.view(), jpool.view()
    rnd = admit_serve([ServeTaskReq(r, 0, q, kv, 0) for r, q, kv in tasks],
                      busy, interval * COST,
                      snap_of(speeds=speeds, version=3), view,
                      policy=AdmissionPolicy(**pol),
                      candidates=None if view else tuple(sorted(busy)),
                      waits=dict(waits))
    jrnd = j_admit_serve([JReq(r, 0, q, kv, 0) for r, q, kv in tasks], busy,
                         interval * COST,
                         JSnap(version=3, cost_model=J_CM,
                               speeds=tuple(speeds)), jview,
                         policy=JPolicy(**pol),
                         candidates=None if jview else tuple(sorted(busy)),
                         waits=dict(waits))
    assert _round_fields(rnd) == _round_fields(jrnd)


# ===================================================================
# workload: task sequence + fused batch builder
# ===================================================================

def test_workload_task_sequence_is_fixed():
    wl = make_workload([(0, 3 * BLK + 4, 2)])
    r = wl.requests[0]
    seen = []
    while not r.done:
        seq, qt, kvt = r.next_task(BLK)
        seen.append((seq, qt, kvt))
        if r.n_prefilled < r.prompt_len:
            r.n_prefilled += qt
        else:
            r.n_decoded += 1
    assert seen == [(0, BLK, BLK), (1, BLK, 2 * BLK),
                    (2, BLK, 3 * BLK), (3, 4, 3 * BLK + 4),
                    (4, 1, 3 * BLK + 5), (5, 1, 3 * BLK + 6)]


ARRIVALS = [(0, 2 * BLK, 1), (0, BLK // 2, 1), (1, 3 * BLK + 5, 4),
            (2, 1, 3)]


def test_workload_sequences_and_batches_equal_reference():
    """Fed the reference's request arrays, the port's pending tasks, task
    sequences and fused batches (every array, the plan) are the
    reference's, round after round."""
    jwl = make_j_workload(ARRIVALS)
    wl = make_workload(ARRIVALS, contents=contents_of(jwl))
    assert (wl.req_blocks, wl.kv_blocks, wl.jmax) \
        == (jwl.req_blocks, jwl.kv_blocks, jwl.jmax)
    for step in range(12):
        tasks, jtasks = wl.pending(step), jwl.pending(step)
        assert [vars(t) for t in tasks] == [vars(t) for t in jtasks]
        if not tasks:
            continue
        (inputs, plan), (jin, jplan) = wl.build_arrays(tasks), \
            jwl.build_batch(jtasks)
        for a, b in zip(inputs, jin):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        for key in ("task_kv_start", "task_kv_len"):
            np.testing.assert_array_equal(plan[key], np.asarray(jplan[key]))
        tinp, tplan = wl.build_batch(tasks, device="cpu")
        assert all(torch.equal(x, torch.as_tensor(a))
                   for x, a in zip(tinp, inputs))
        assert tplan["task_kv_len"].dtype == torch.int32
        for t, jt in zip(tasks, jtasks):
            out = np.full((BLK, 2, 8), float(t.rid), np.float32)
            wl.commit(t, out, step)
            jwl.commit(jt, out, step)
    assert wl.digest_map() == jwl.digest_map()
    assert wl.completion() == jwl.completion()


def test_workload_build_batch_layout():
    wl = make_workload([(0, 2 * BLK, 1), (0, BLK // 2, 1)])
    tasks = wl.pending(0)
    assert [t.q_tokens for t in tasks] == [BLK, BLK // 2]
    inputs, plan = wl.build_batch(tasks, device="cpu")
    q_tasks, qpos, k_buf, v_buf, kpos = (to_numpy(a) for a in inputs)
    assert q_tasks.shape == (wl.slots, BLK, 2, 8)
    assert k_buf.shape[0] == wl.kv_blocks
    assert (qpos[1, BLK // 2:] == -1).all()
    start, ln = to_numpy(plan["task_kv_start"]), to_numpy(plan["task_kv_len"])
    assert ln[0] == 1 and ln[1] == 1 and start[1] == 1
    assert (kpos[1, BLK // 2:] == -1).all()
    with pytest.raises(ValueError, match="slots"):
        wl.build_batch([task(0)] * (wl.slots + 1), device="cpu")


def test_workload_draws_are_seeded_per_request():
    """A request's content is a function of (seed, rid) alone."""
    a = make_workload([(0, 20, 1), (0, 40, 2)])
    b = make_workload([(0, 20, 1), (3, 70, 5)])
    c = make_workload([(0, 20, 1)], seed=8)
    assert a.requests[0].qc.tobytes() == b.requests[0].qc.tobytes()
    assert a.requests[0].qc.tobytes() != c.requests[0].qc.tobytes()
    assert a.requests[0].qc.dtype == np.float32


def test_workload_rejects_empty_prompt_and_blk_mismatch():
    with pytest.raises(ValueError, match="empty prompt"):
        make_workload([(0, 0, 1)])
    with pytest.raises(ValueError, match="contents"):
        make_workload([(0, 4, 1)], contents=[])
    with pytest.raises(ValueError, match="shapes"):
        make_workload([(0, 4, 1)], contents=[(np.zeros((BLK, 2, 8)),) * 2
                                             + (np.zeros((1, 2, 8)),)])
    with pytest.raises(ValueError, match="blk"):
        FabricExecutor(make_session(), ServeWorkload([(0, 8, 1)], blk=128))


# ===================================================================
# fabric executor: against the reference, then isolation, preemption,
# recovery inside the port
# ===================================================================

REPORT_FIELDS = ("pool_epoch", "calib_version", "admitted", "executed",
                 "deferred", "forced", "lost_serve", "readmitted",
                 "slo_misses", "spec_preempted", "serve_tokens")
MIXED = {
    "backfill": ([(0, 2 * BLK, 2), (1, BLK, 1), (1, 3 * BLK, 2)],
                 dict(steps=4)),
    "kill mid-decode": ([(0, 2 * BLK, 3)] * 8,
                        dict(steps=5, faults="kill:1@3")),
    "speculation preempted": ([(0, BLK, 1)],
                              dict(steps=5, speculate_pct=0.9,
                                   faults="slow:1x8@3-5")),
}


@pytest.mark.parametrize("case", list(MIXED))
def test_mixed_steps_match_reference(case):
    """The same arrivals (the port fed the reference's request arrays),
    q/k/v and schedule through both packages: train outputs within f32
    atol 2e-5, every serve task's output too, equal step reports."""
    arrivals, kw = MIXED[case]
    jrec, rec = [], []
    jwl, jouts, jreps = run_j_fabric(arrivals, record=jrec, **kw)
    wl, outs, reps = run_fabric(arrivals, contents=contents_of(jwl),
                                record=rec, **kw)
    for a, b in zip(outs, jouts):
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert len(reps) == len(jreps)
    for r, jr in zip(reps, jreps):
        for f in REPORT_FIELDS:
            assert getattr(r, f) == getattr(jr, f), f
        assert r.train.failed == jr.train.failed
        assert r.train.speculated == jr.train.speculated
        assert r.step_seconds == pytest.approx(jr.step_seconds, rel=1e-9)
    assert [(rid, seq) for rid, seq, _ in rec] \
        == [(rid, seq) for rid, seq, _ in jrec]
    for (_, _, a), (_, _, b) in zip(rec, jrec):
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert wl.completion() == jwl.completion()
    assert any(r.executed for r in reps)


def _train_only(steps, seed=0):
    ex = ElasticExecutor(make_session(), feed_calibrator=False)
    outs = []
    for step in range(steps):
        q, k, v, pos, segs = step_inputs(step, seed)
        out, _rep = ex.run_step(step, *(to_torch(x) for x in (q, k, v, pos)),
                                segs)
        outs.append(to_numpy(out))
    return outs


def test_train_bit_identical_with_serve_backfill():
    """Training outputs with serve traffic backfilling the same pool match
    a dedicated-pool run bit for bit, and the serve tenant completes."""
    arr = [(0, 2 * BLK, 2), (1, BLK, 1), (1, 3 * BLK, 2)]
    wl, outs, reps = run_fabric(arr, 8)
    assert bits(outs) == bits(_train_only(8))
    assert wl.all_done()
    assert sum(r.executed for r in reps) \
        == sum(len(r.digests) for r in wl.requests)
    assert all(r.calib_version == reps[0].calib_version for r in reps)


def test_serve_preempts_speculation_not_primaries():
    wl, outs, reps = run_fabric([(0, BLK, 1)], 6, speculate_pct=0.9,
                                faults="slow:1x8@3-5")
    assert reps[0].spec_preempted
    assert reps[0].train.speculated == ()
    drained = [r for r in reps if r.admitted == 0 and r.deferred == 0]
    assert drained and not any(r.spec_preempted for r in drained)
    assert any(r.train.speculated for r in drained)
    assert bits(outs) == bits(_train_only(6))


def test_kill_mid_decode_recovers_and_replays():
    """A server killed mid-step loses its serve placements with its train
    tasks: serve re-places onto the least-loaded survivors in the same
    round, both tenants complete, the run replays bitwise, and the
    per-request digests equal the fault-free run's."""
    arr = [(0, 2 * BLK, 3)] * 8
    kw = dict(steps=6, faults="kill:1@3", max_steps=30)
    wl1, d1, r1 = run_fabric(arr, **kw)
    wl2, d2, r2 = run_fabric(arr, **kw)
    kill = r1[3]
    assert kill.train.failed == (1,)
    assert kill.lost_serve > 0 and kill.readmitted == kill.lost_serve
    assert wl1.all_done()
    assert r1[-1].pool_epoch == 1
    assert bits(d1) == bits(d2)
    assert wl1.digest_map() == wl2.digest_map()
    assert wl1.completion() == wl2.completion()
    assert [r.step_seconds for r in r1] == [r.step_seconds for r in r2]
    wl0, _d0, _r0 = run_fabric(arr, steps=6, max_steps=30)
    assert wl0.digest_map() == wl1.digest_map()


def test_partition_vs_shared_placement_independent():
    arr = [(0, 2 * BLK, 2)] * 6
    shared, _d, _r = run_fabric(arr, 6, max_steps=30)
    part, _d2, _r2 = run_fabric(arr, 6, drained=(2, 3), allowed=(2, 3),
                                max_steps=30)
    assert shared.all_done() and part.all_done()
    assert shared.digest_map() == part.digest_map()


def test_admission_round_reports_budget_pressure():
    arr = [(0, 2 * BLK, 1)] * 12
    wl, _d, reps = run_fabric(arr, 6, interval=1e-7, allowed=(3,),
                              max_steps=6)
    assert any(r.deferred > 0 for r in reps)
    assert any(r.slo_misses > 0 for r in reps[4:])
    assert not wl.all_done()


def test_wall_timer_keeps_the_bits():
    """Under the ``wall`` timer (each serve between two synchronizes) the
    outputs and digests are the model timer's."""
    arr = [(0, 2 * BLK, 2), (1, BLK, 1)]
    wl, outs, _ = run_fabric(arr, 3)
    wl2 = make_workload(arr)
    ex = FabricExecutor(make_session(), wl2, timer="wall")
    for step in range(3):
        q, k, v, pos, segs = step_inputs(step)
        out, rep = ex.run_mixed_step(
            step, *(to_torch(x) for x in (q, k, v, pos)), segs,
            interval=1e-3)
        assert to_numpy(out).tobytes() == outs[step].tobytes()
        assert all(s >= 0 for s in rep.serve_seconds.values())
    assert wl2.digest_map() == wl.digest_map()


# ===================================================================
# session admission view + scheduler snapshot provider
# ===================================================================

def test_session_admission_view_fallback_and_provider():
    sess = CADSession(cfg=CADConfig(**geo()), comm=CommModel(2, 8, 2),
                      prefetch=0).with_pool(ServerPool(D))
    snap, view = sess.admission_view()
    assert snap.version == -1
    assert len(snap.speeds) == D
    assert view.epoch == 0
    assert sess.snapshot_provider()().version == snap.version


def test_scheduler_snapshot_provider_reprices_each_round():
    from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                             SchedulerConfig)
    calls = []

    def provider():
        calls.append(len(calls))
        return snap_of(version=len(calls))

    s = ContinuousScheduler(SchedulerConfig(
        n_slots=2, max_seq=256, admission="cost",
        snapshot_provider=provider))
    s.submit(Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                     max_new_tokens=2))
    assert [r.rid for r in s.admit()] == [0]
    assert calls == [0] and s.last_calib_version == 1
    s.admit()
    assert len(calls) == 2 and s.last_calib_version == 2
    with pytest.raises(ValueError, match="cost_model or a "
                                         "snapshot_provider"):
        SchedulerConfig(n_slots=1, max_seq=64, admission="cost")


# ===================================================================
# HTTP daemon
# ===================================================================

def test_daemon_http_roundtrip():
    """submit/stream/health/drain through the port's HTTP daemon on an
    ephemeral port, with cost admission priced by the live calibrator."""
    from repro_torch.launch import serve as L
    args = L.parse_args(["--device", "cpu", "--slots", "2", "--max-seq",
                         "64", "--max-new", "4", "--admission", "cost",
                         "--calibrate"])
    daemon = L.EngineDaemon(L.build_engine(args), calibrate=True)
    srv = L.make_server(daemon, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_port}"

    def post(path, obj):
        rq = urllib.request.Request(base + path, json.dumps(obj).encode())
        with urllib.request.urlopen(rq) as r:
            return json.loads(r.read())

    try:
        out = post("/generate", {"prompt": [3, 14, 15],
                                 "max_new_tokens": 3})
        assert len(out["tokens"]) == 3
        rq = urllib.request.Request(
            base + "/generate",
            json.dumps({"prompt": [1, 2], "stream": True}).encode())
        with urllib.request.urlopen(rq) as r:
            lines = [json.loads(ln) for ln in r]
        assert lines[-1]["done"] and len(lines[-1]["tokens"]) == 4
        assert [ln["token"] for ln in lines[:-1]] \
            == lines[-1]["tokens"][:-1]
        with urllib.request.urlopen(base + "/health") as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["done"] == 2 and h["rounds"] > 0
        assert h["queue_depth"] == 0 and h["pool_epoch"] >= 0
        assert h["calib_version"] >= -1
        with urllib.request.urlopen(base + "/metrics") as r:
            assert r.headers["Content-Type"] \
                == "text/plain; version=0.0.4"
            text = r.read().decode()
        assert "# TYPE serve_admitted_total counter" in text
        assert "# TYPE serve_rounds_total counter" in text
        assert "serve_queue_depth 0" in text
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/generate", {"prompt": []})
        assert ei.value.code == 400
        ei.value.close()
        assert post("/drain", {})["draining"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/generate", {"prompt": [1]})
        assert ei.value.code == 503
        ei.value.close()
        with urllib.request.urlopen(base + "/health") as r:
            assert json.loads(r.read())["status"] == "drained"
    finally:
        daemon.stop()
        srv.shutdown()
        srv.server_close()
