"""The port's elastic runtime host modules (``repro_torch.runtime.faults``,
``.pool`` and ``.recovery``) and ``launch/trace_report.py`` against the
JAX package's, exactly: the same specs, seeded draws, pool event
strings, epochs, views and history, the same recovery sub-plans
(plan arrays, lost mask, assignment, added time) under one explicit cost
model, HBM budgets and mask, and the same report lines of one trace.
These modules are numpy and stdlib; the port keeps its own copies, so
equality is the test."""
import dataclasses
import json

import numpy as np
import pytest

from repro.cad import get_planner as j_get_planner
from repro.core.cost_model import CommModel as JComm
from repro.core.cost_model import CostModel as JCostModel
from repro.core.cost_model import GridCalibrator as JCalib
from repro.core.cost_model import MemoryModel as JMem
from repro.core.mask import MaskSpec as JMask
from repro.core.plan import CADConfig as JCfg
from repro.launch import trace_report as j_report
from repro.obs import TraceRecorder as JRecorder
from repro.runtime import faults as JF
from repro.runtime import pool as JP
from repro.runtime import recovery as JR
from repro_torch.core.cost_model import CommModel, CostModel, GridCalibrator
from repro_torch.core.cost_model import MemoryModel
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import CADConfig, StepPlan
from repro_torch.launch import trace_report
from repro_torch.obs import TraceRecorder, server_track
from repro_torch.runtime import recovery as R
from repro_torch.runtime import (FaultSchedule, PoolExhaustedError,
                                 ServerPool)

BLK = 16


def _events(fs):
    return [dataclasses.astuple(e) for e in fs.events]


# ----------------------------------------------------------------- faults
SPECS = ["kill:2@5", "slow:0x4@3-9,flap:1@4+3,drain:3@2",
         "slow:1x2.5@0,kill:0@1,flap:2@0+1", "drain:0@0,drain:1@3",
         "slow:3x8@2-4,slow:3x2@3"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_schedule_parse_and_queries_equal_reference(spec):
    """Parsed events, ``spec()`` strings and every query over a grid of
    steps and servers: exactly the reference's."""
    fs, js = FaultSchedule.parse(spec), JF.FaultSchedule.parse(spec)
    assert _events(fs) == _events(js)
    assert fs.spec() == js.spec()
    assert FaultSchedule.parse(fs.spec()) == fs
    for t in range(12):
        assert [dataclasses.astuple(e) for e in fs.failures_at(t)] \
            == [dataclasses.astuple(e) for e in js.failures_at(t)]
        assert fs.drains_at(t) == js.drains_at(t)
        assert fs.rejoins_at(t) == js.rejoins_at(t)
        for s in range(4):
            assert fs.slow_factor(t, s) == js.slow_factor(t, s)


@pytest.mark.parametrize("bad", [
    "boom:1@2", "kill:1", "slow:1@3", "flap:1@3", "kill:1x2@3",
    "slow:0x0@1", "kill:1@2,kill:1@2", "slow:1x2@3+5", "flap:1@4+3-9",
])
def test_fault_schedule_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        JF.FaultSchedule.parse(bad)
    with pytest.raises(ValueError):
        FaultSchedule.parse(bad)


@pytest.mark.parametrize("n,steps,seed,kw", [
    (8, 100, 7, {}), (8, 100, 8, {}), (3, 5, 4, dict(
        p_kill=0.05, p_slow=0.2, p_flap=0.05, max_kills=1)),
    (4, 40, 0, dict(p_kill=0.1, p_flap=0.1, slow_factors=(1.5, 3.0)))])
def test_fault_schedule_random_draws_equal_reference(n, steps, seed, kw):
    fs = FaultSchedule.random(n, steps, seed, **kw)
    js = JF.FaultSchedule.random(n, steps, seed, **kw)
    assert len(fs) > 0 and _events(fs) == _events(js)
    assert fs.spec() == js.spec()


def test_schedule_application_to_pools_equals_reference():
    """``apply_pre_step`` / ``apply_failures`` over 8 steps of a random
    schedule: the same event lines (or the same exhausted pool), epochs,
    views and history."""
    fs = FaultSchedule.random(4, 8, 3, p_kill=0.1, p_flap=0.15,
                              max_kills=2)
    js = JF.FaultSchedule.parse(fs.spec())
    pool, jpool = ServerPool(4), JP.ServerPool(4)

    def apply(sched, p, t, exhausted):
        try:
            return sched.apply_pre_step(p, t) + sched.apply_failures(p, t)
        except exhausted as e:
            return ("exhausted", str(e))
    for t in range(8):
        assert apply(fs, pool, t, PoolExhaustedError) \
            == apply(js, jpool, t, JP.PoolExhaustedError)
        assert dataclasses.asdict(pool.view()) \
            == dataclasses.asdict(jpool.view())
    assert pool.history() == jpool.history() and pool.history()


# ------------------------------------------------------------------- pool
def test_pool_epochs_views_history_and_errors_equal_reference():
    ops = [("drain", 1, {}), ("remove", 2, {}), ("add", 2, {}),
           ("add", 1, {}), ("remove", 3, {}),
           ("add", 3, {"endpoint": "replacement-host"}), ("drain", 0, {}),
           ("remove", 0, {}), ("remove", 1, {}), ("remove", 2, {}),
           ("remove", 3, {}), ("add", 9, {}), ("add", 3, {})]
    pool, jpool = ServerPool(4), JP.ServerPool(4)
    for name, slot, kw in ops:
        res = []
        for p, exc in ((pool, PoolExhaustedError),
                       (jpool, JP.PoolExhaustedError)):
            try:
                res.append(getattr(p, name)(slot, **kw))
            except exc as e:
                res.append(("exhausted", str(e)))
            except ValueError as e:
                res.append(("value", str(e)))
        assert res[0] == res[1], (name, slot)
        assert dataclasses.asdict(pool.view()) \
            == dataclasses.asdict(jpool.view())
        assert [pool.status(s) for s in range(4)] \
            == [jpool.status(s) for s in range(4)]
    assert pool.history() == jpool.history()
    assert list(pool) == list(jpool)
    with pytest.raises(ValueError):
        ServerPool(0)
    with pytest.raises(ValueError):
        ServerPool(2, endpoints=["a"])


def test_pool_calibrator_carryover_equals_reference():
    """Survivors and a flap keep their speeds; a new endpoint resets its
    slot (``GridCalibrator.reset_server``) with a declared prior:
    speeds, versions and states as the reference's at each stage."""
    base = CostModel.analytic(2, 8)           # one grid for both
    cals = [GridCalibrator(base, 3),
            JCalib(JCostModel.from_dict(base.to_dict()), 3)]
    for cal in cals:
        for s in range(3):
            for _ in range(4):
                cal.observe(128, 1024, 1e-3 * (s + 1), server=s)
    pools = [ServerPool(3, calibrator=cals[0]),
             JP.ServerPool(3, calibrator=cals[1])]
    for step in (("remove", 2, {}), ("add", 2, {}), ("remove", 2, {}),
                 ("add", 2, {"endpoint": "new", "prior_speed": 0.5})):
        for p in pools:
            getattr(p, step[0])(step[1], **step[2])
        np.testing.assert_array_equal(cals[0].speeds(), cals[1].speeds())
        assert cals[0].version == cals[1].version
    assert pools[0].history() == pools[1].history()


# --------------------------------------------------------------- recovery
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


def _pair_cfg(d, nb, **kw):
    jcfg = JCfg(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb,
                nkv=4 * nb, **kw)
    return jcfg, CADConfig(**dataclasses.asdict(jcfg))


def _same_recovery(rec, jrec):
    assert (rec is None) == (jrec is None)
    if rec is None:
        return
    np.testing.assert_array_equal(rec.lost, jrec.lost)
    np.testing.assert_array_equal(rec.assign, jrec.assign)
    assert rec.added_time == jrec.added_time and rec.added_time
    assert rec.n_blocks == jrec.n_blocks > 0
    for key, val in jrec.plan.items():
        np.testing.assert_array_equal(rec.plan[key], np.asarray(val),
                                      err_msg=key)


SLIDING = dict(kind="sliding", window=2 * BLK, sink=0)


@pytest.mark.parametrize("case", ["one-dead", "two-dead-speeds",
                                  "sliding-mask", "identity-plan"])
def test_recovery_plan_equals_reference(case):
    """``assignment_of_plan``, ``lost_block_mask``, ``build_recovery_plan``
    (base loads, an explicit analytic cost model, speeds, a mask) and
    ``recovery_tasks``: the reference's arrays and floats exactly."""
    d, nb = 4, 8
    jcfg, cfg = _pair_cfg(d, nb)
    segs = make_segs(d, nb, seed=1)
    policy = "identity" if case == "identity-plan" else "balanced"
    jmask = JMask(**SLIDING) if case == "sliding-mask" else None
    mask = MaskSpec(**SLIDING) if case == "sliding-mask" else None
    kw = {} if jmask is None else {"mask": jmask}
    jplan = j_get_planner(policy)(jcfg, segs, comm=JComm(2, 8, 2),
                                  tolerance=0.05, **kw).plan
    plan = StepPlan.from_dict(jplan.to_dict())
    failed = (1, 3) if case == "two-dead-speeds" else (1,)
    allowed = [s for s in range(d) if s not in failed]
    speeds = np.array([1.0, 0.5, 2.0, 1.0]) \
        if case == "two-dead-speeds" else None
    jcm = JCostModel.analytic(2, 8)
    cm = CostModel.from_dict(jcm.to_dict())
    np.testing.assert_array_equal(R.assignment_of_plan(cfg, plan),
                                  JR.assignment_of_plan(jcfg, jplan))
    np.testing.assert_array_equal(R.lost_block_mask(cfg, plan, failed),
                                  JR.lost_block_mask(jcfg, jplan, failed))
    base = {s: 1e-4 * (s + 1) for s in allowed}
    rec = R.build_recovery_plan(cfg, segs, plan, failed, allowed=allowed,
                                base_loads=base, cost_model=cm,
                                speeds=speeds, mask=mask)
    jrec = JR.build_recovery_plan(jcfg, segs, jplan, failed,
                                  allowed=allowed, base_loads=base,
                                  cost_model=jcm, speeds=speeds,
                                  mask=jmask)
    _same_recovery(rec, jrec)
    assert R.recovery_tasks(cfg, rec, mask) \
        == JR.recovery_tasks(jcfg, jrec, jmask)
    with pytest.raises(ValueError):
        R.build_recovery_plan(cfg, segs, plan, failed, allowed=())
    with pytest.raises(ValueError):
        R.build_recovery_plan(cfg, segs, plan, failed, allowed=failed)


def _segs_one_long_doc(n_ranks=3, nb=4):
    """Rank 0: one doc spanning all blocks; ranks 1+: one 1-block doc."""
    segs = np.zeros((n_ranks, nb * BLK), np.int64)
    segs[0, :] = 1
    for r in range(1, n_ranks):
        segs[r, :BLK] = 10 * r + 1
    return segs


@pytest.mark.parametrize("case", ["headroom", "no-budgets",
                                  "nothing-fits"])
def test_memory_aware_recovery_equals_reference(case):
    """The reference's budget-aware recovery tests
    (``tests/test_memory_planning.py``: a survivor at its HBM ceiling is
    skipped; without budgets the least loaded takes the run; when nothing
    fits the least loaded takes it anyway, streamed) on both packages:
    equal sub-plans, and the reference's destinations."""
    segs = _segs_one_long_doc()
    chunk = 1 if case == "nothing-fits" else 0
    jcfg = JCfg.default(3, 4 * BLK, blk=BLK, stream_chunk=chunk)
    cfg = CADConfig(**dataclasses.asdict(jcfg))
    jcomm = JComm(n_heads=2, head_dim=16, n_kv_heads=2)
    comm = CommModel(n_heads=2, head_dim=16, n_kv_heads=2)
    jplan = j_get_planner("balanced")(jcfg, segs, comm=jcomm,
                                      tolerance=0.05).plan
    plan = StepPlan.from_dict(jplan.to_dict())
    kw = {"headroom": dict(base_loads={1: 0.0, 2: 1e6},
                           budgets=np.full(3, 1e9),
                           base_resident={1: 1e9, 2: 0.0}),
          "no-budgets": dict(base_loads={1: 0.0, 2: 1e6}),
          "nothing-fits": dict(base_loads={1: 0.0, 2: 5.0},
                               budgets=np.full(3, 1.0),
                               base_resident={1: 0.0, 2: 0.0},
                               stream_chunk=1)}[case]
    mem = {} if case == "no-budgets" else {"mem_model": MemoryModel(comm)}
    jmem = {} if case == "no-budgets" else {"mem_model": JMem(jcomm)}
    rec = R.build_recovery_plan(cfg, segs, plan, [0], allowed=[1, 2],
                                **kw, **mem)
    jrec = JR.build_recovery_plan(jcfg, segs, jplan, [0], allowed=[1, 2],
                                  **kw, **jmem)
    _same_recovery(rec, jrec)
    moved_to = set(int(s) for s in rec.assign[rec.lost])
    if case == "headroom":
        assert moved_to == {2}
    elif case == "no-budgets":
        assert moved_to == {1}


# ----------------------------------------------------------- trace_report
def _golden(rec):
    rec.add_span("serve", server_track(0), 0.0, 2.0, step=0,
                 args={"predicted": 1.9})
    rec.add_span("serve", server_track(2), 0.0, 1.0, step=0,
                 args={"predicted": 1.1})
    rec.add_span("recover", server_track(0), 2.0, 0.5, step=0)
    rec.instant("kill", server_track(1), ts=0.0, step=0)
    rec.instant("speculate", server_track(2), ts=0.5, step=0)
    rec.add_span("serve", server_track(1), 3.0, 4.0, step=1,
                 args={"predicted": 4.2})
    rec.add_span("serve.backfill", server_track(1), 7.0, 1.0, step=1)
    rec.add_span("serve", server_track(3), 3.0, 4.0, step=1)
    return rec.to_chrome_trace()


def test_trace_report_equals_reference(tmp_path, capsys):
    """The same trace recorded by both packages' recorders: the port's
    Chrome trace equals the reference's, and ``load_steps``,
    ``attribute_step`` (with the reference's goldens and lowest-slot tie
    break), ``report_lines`` and the ``--json`` CLI give its output."""
    trace = _golden(TraceRecorder(capacity=64))
    jtrace = _golden(JRecorder(capacity=64))
    assert trace == jtrace
    steps = trace_report.load_steps(trace)
    assert steps == j_report.load_steps(trace)
    a0 = trace_report.attribute_step(steps[0])
    assert a0 == j_report.attribute_step(steps[0])
    assert a0["server"] == 0 and a0["max_seconds"] == pytest.approx(2.5)
    assert a0["recovery_share"] == pytest.approx(0.2)
    assert a0["events"] == ["kill", "speculate"]
    a1 = trace_report.attribute_step(steps[1])
    assert a1["server"] == 1 and a1["max_seconds"] == pytest.approx(5.0)
    assert trace_report.report_lines(trace) == j_report.report_lines(trace)
    assert trace_report.report_lines({"traceEvents": []}) \
        == j_report.report_lines({"traceEvents": []})
    p = tmp_path / "g.json"
    p.write_text(json.dumps(trace))
    trace_report.main([str(p), "--json"])
    ours = capsys.readouterr().out
    j_report.main([str(p), "--json"])
    assert ours == capsys.readouterr().out
