"""The port's host planning stack (``repro_torch.data``, ``core.mask``,
``core.scheduler``, ``core.plan``, ``cad``) against the JAX package's: the
same seeded document mixes give the same packed batches and, for every
policy, with speeds, HBM budgets, masks and ping-pong, the same six plan
arrays, exactly."""
import types

import numpy as np
import pytest

from repro.cad import CADSession as JSession
from repro.cad import get_planner as j_get_planner
from repro.core.cost_model import CommModel as JComm
from repro.core.cost_model import CostModel as JCost
from repro.core.mask import MaskSpec as JMask
from repro.core.plan import CADConfig as JCfg
from repro.core.plan import PlanMemoryError as JMemErr
from repro.data.pipeline import PipelineConfig as JPipe
from repro.data.pipeline import raw_batches as j_raw_batches
from repro_torch.cad import CADSession, get_planner
from repro_torch.core.cost_model import CommModel, CostModel
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import PLAN_FIELDS, CADConfig, PlanMemoryError
from repro_torch.data.pipeline import PipelineConfig, raw_batches

POLICIES = ["identity", "per_doc_cp", "balanced", "ring"]
BLK = 16


def _segments(seed, d, nb):
    """A packed layout: block-aligned documents (some ending in a
    partial block), whole padding blocks between some of them."""
    rng = np.random.default_rng(seed)
    segs = np.zeros((d, nb * BLK), np.int32)
    sid = 1
    for r in range(d):
        t = 0
        while t < nb:
            if rng.random() < 0.15:
                t += 1
                continue
            dbl = int(rng.integers(1, min(6, nb - t) + 1))
            tokens = dbl * BLK - (int(rng.integers(0, BLK))
                                  if rng.random() < 0.3 else 0)
            segs[r, t * BLK:t * BLK + tokens] = sid
            sid += 1
            t += dbl
    return segs


# name -> (seed, servers, blocks per rank, speeds, hbm, mask, cost model)
SCENARIOS = {
    "homogeneous": (0, 4, 8, None, None, None, False),
    "speeds": (1, 4, 8, (1.0, 0.5, 1.0, 0.25), None, None, False),
    "hbm": (2, 3, 8, None, (1.05e5, 1.05e5, 1.05e5), None, False),
    "sliding": (3, 2, 10, None, None, ("sliding", 40, 8, 1), False),
    "dilated": (4, 4, 8, None, None, ("dilated", 0, 0, 2), False),
    "cost_model": (5, 2, 8, (1.0, 0.5), None, None, True),
}


def _mask_pair(m):
    if m is None:
        return None, None
    kind, window, sink, rate = m
    return (JMask(kind=kind, window=window, sink=sink, rate=rate),
            MaskSpec(kind=kind, window=window, sink=sink, rate=rate))


def _run(policy, scenario):
    seed, d, nb, speeds, hbm, m, use_cm = SCENARIOS[scenario]
    segs = _segments(seed, d, nb)
    geo = dict(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb, nkv=4 * nb,
               server_speeds=speeds, server_hbm=hbm)
    j_mask, t_mask = _mask_pair(m)
    j_kw = dict(comm=JComm(4, 32, 2), tolerance=0.1)
    t_kw = dict(comm=CommModel(4, 32, 2), tolerance=0.1)
    if m is not None:
        j_kw["mask"], t_kw["mask"] = j_mask, t_mask
    if use_cm:
        # one measured-style grid for both (the two packages' analytic
        # defaults describe different chips)
        j_cm = JCost.analytic(4, 32).scaled(2.5)
        j_kw["cost_model"] = j_cm
        t_kw["cost_model"] = CostModel.from_dict(j_cm.to_dict())
    outcome = []
    for fn, cfg, kw, err in ((j_get_planner(policy), JCfg(**geo), j_kw,
                              JMemErr),
                             (get_planner(policy), CADConfig(**geo), t_kw,
                              PlanMemoryError)):
        try:
            outcome.append(fn(cfg, segs, **kw))
        except err as e:
            outcome.append(type(e).__name__)
    return outcome


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("policy", POLICIES)
def test_plan_arrays_match_reference(policy, scenario):
    ref, got = _run(policy, scenario)
    if isinstance(ref, str) or isinstance(got, str):
        assert ref == got          # both refuse the layout the same way
        return
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(got.plan[f]),
                                      np.asarray(ref.plan[f]), err_msg=f)
    np.testing.assert_array_equal(got.assign, ref.assign)
    np.testing.assert_array_equal(got.loads, ref.loads)
    assert got.stats == ref.stats
    assert got.streamed == ref.streamed


def test_memory_budget_scenario_plans_and_refuses():
    """The HBM scenario is one where the fixed layouts are refused and
    the balanced planner re-splits, so both branches above are held."""
    outcomes = {p: _run(p, "hbm")[1] for p in POLICIES}
    assert any(isinstance(o, str) for o in outcomes.values())
    assert not isinstance(outcomes["balanced"], str)


PIPES = {
    "pretrain": dict(distribution="pretrain", max_doc_len=1024,
                     seq_len=1024, global_batch=4, n_ranks=2, seed=0),
    "prolong-variable": dict(distribution="prolong", max_doc_len=2048,
                             seq_len=2048, global_batch=4, n_ranks=4,
                             seed=3, strategy="variable"),
}


@pytest.mark.parametrize("pipe", list(PIPES))
def test_raw_batches_match_reference(pipe):
    j_gen = j_raw_batches(JPipe(**PIPES[pipe]))
    t_gen = raw_batches(PipelineConfig(**PIPES[pipe]))
    for _ in range(3):
        a, b = next(j_gen), next(t_gen)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("pingpong", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_session_plans_match_reference(policy, pingpong):
    """Sessions sized from the same pipeline plan the same batches the
    same way, ping-pong halves included."""
    model = types.SimpleNamespace(n_heads=4, head_dim=32, n_kv_heads=2)
    kw = dict(distribution="prolong", max_doc_len=512, seq_len=512,
              global_batch=8, n_ranks=2, seed=1)
    j_sess = JSession.for_pipeline(model, JPipe(**kw), pingpong=pingpong,
                                   plan_policy=policy, prefetch=0)
    t_sess = CADSession.for_pipeline(model, PipelineConfig(**kw),
                                     pingpong=pingpong, plan_policy=policy,
                                     prefetch=0)
    assert t_sess.jmax == j_sess.jmax
    j_batches = j_sess.attach_plans(j_raw_batches(JPipe(**kw)))
    t_batches = t_sess.attach_plans(raw_batches(PipelineConfig(**kw)))
    for _ in range(2):
        a, b = next(j_batches), next(t_batches)
        halves = [(a["plan"], b["plan"])] if not pingpong \
            else list(zip(a["plan"], b["plan"]))
        for pa, pb in halves:
            for f in PLAN_FIELDS:
                np.testing.assert_array_equal(np.asarray(pb[f]),
                                              np.asarray(pa[f]), err_msg=f)
        assert b["schedule_stats"] == a["schedule_stats"]


def test_prefetched_plans_equal_synchronous_ones():
    model = types.SimpleNamespace(n_heads=4, head_dim=32, n_kv_heads=2)
    kw = dict(distribution="pretrain", max_doc_len=512, seq_len=512,
              global_batch=4, n_ranks=2, seed=2)
    sess = CADSession.for_pipeline(model, PipelineConfig(**kw))
    sync = sess.attach_plans(raw_batches(PipelineConfig(**kw)), prefetch=0)
    ahead = sess.attach_plans(raw_batches(PipelineConfig(**kw)), prefetch=2)
    for _ in range(3):
        a, b = next(sync), next(ahead)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(a["plan"][f], b["plan"][f])
    ahead.close()


@pytest.mark.parametrize("arch", ["smollm-360m", "llama3-8b", "gemma2-2b"])
def test_cost_accounting_matches_reference(arch):
    """The cost model's FLOP and byte accounting (App. A/B, DESIGN.md
    §11-§12) equals the reference's for the ported configs."""
    from repro.configs import get_config as j_get_config
    from repro.core import cost_model as J
    from repro_torch.configs import get_config
    from repro_torch.core import cost_model as T
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    assert T.linear_flops_per_token(cfg) == J.linear_flops_per_token(j_cfg)
    lens = np.array([1, 128, 1000, 4096, 32768])
    np.testing.assert_array_equal(
        T.causal_doc_flops(lens, cfg.n_heads, cfg.head_dim),
        J.causal_doc_flops(lens, cfg.n_heads, cfg.head_dim))
    heads = (cfg.n_heads, cfg.head_dim, cfg.n_kv_heads)
    t_mem, j_mem = T.MemoryModel(CommModel(*heads)), J.MemoryModel(
        JComm(*heads))
    assert CommModel(*heads).migration_bytes(300, 2000) \
        == JComm(*heads).migration_bytes(300, 2000)
    for m in (None, ("sliding", 512, 16, 1), ("dilated", 0, 0, 4)):
        j_mask, t_mask = _mask_pair(m)
        for kv in (128, 1000, 8192):
            assert t_mem.task_bytes(128, kv, t_mask) \
                == j_mem.task_bytes(128, kv, j_mask)


def test_plan_to_device_makes_int32_tensors():
    import torch
    segs = _segments(0, 2, 4)
    cfg = CADConfig(n_servers=2, blk=BLK, nb=4, cq=4, ckv=8, nkv=16)
    plan = get_planner("balanced")(cfg, segs).plan.to("cpu")
    for f in PLAN_FIELDS:
        assert plan[f].dtype == torch.int32
