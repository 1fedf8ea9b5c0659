"""Property-based planner/scheduler invariants, held by the PyTorch
port's copy of the planning stack (``repro_torch.cad``,
``repro_torch.core``): the invariants of ``test_planner_properties.py``
with the port's modules in place of the JAX package's, at half the
examples per property.

For random document-length mixes, pool sizes, speed factors, cost
models, and tolerances, every registered policy must yield plans that

  * cover each live q-block exactly once (and padding never),
  * encode every task's kv context as the document's exact prefix,
  * respect the static send/buffer capacities,
  * account loads consistently (work is conserved under speed scaling),
  * plan deterministically (same inputs -> bit-identical arrays),
  * never balance *worse* than identity,
  * under elastic membership subsets (``exclude``), never place a task
    on an excluded server while still covering every live block, and
  * fail infeasible builds with ``PlanCapacityError`` — never a bare
    assert or a silent overflow.

The suite runs under hypothesis when it is installed (CI installs the
``dev`` extra, so there it must run, not skip); without hypothesis the
same generators and checks run as a seeded random sweep, so the
invariants stay enforced in minimal environments too.  Both paths share
one scenario generator through the tiny ``Sampler`` interface below.
"""

import numpy as np
import pytest

from repro_torch.cad import (CADConfig, PlanCapacityError,
                             PlanMemoryError, available_policies,
                             get_planner)
from repro_torch.core.cost_model import CommModel, CostModel, MemoryModel
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import identity_assignment, plan_from_assignment
from repro_torch.core.scheduler import (assignment_resident_bytes,
                                        block_costs, layout_from_segments)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                    # pragma: no cover
    HAVE_HYPOTHESIS = False

BLK = 16
N_EXAMPLES = 20
POLICIES = sorted(available_policies())


# ------------------------------------------------------------ generators
class RngSampler:
    """numpy-backed stand-in for hypothesis draws (the no-hypothesis
    fallback sweep)."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng

    def int_(self, lo: int, hi: int) -> int:
        return int(self._rng.integers(lo, hi + 1))

    def choice(self, seq):
        return seq[self.int_(0, len(seq) - 1)]

    def bool_(self, p: float = 0.5) -> bool:
        return bool(self._rng.random() < p)


class HypSampler:
    """The same interface backed by a hypothesis ``data`` draw, so
    shrinking works on every decision the generator makes."""

    def __init__(self, draw):
        self._draw = draw

    def int_(self, lo: int, hi: int) -> int:
        return self._draw(st.integers(lo, hi))

    def choice(self, seq):
        return self._draw(st.sampled_from(list(seq)))

    def bool_(self, p: float = 0.5) -> bool:
        # p only shapes the fallback sweep; hypothesis explores both
        return self._draw(st.booleans())


def property_case(fn):
    """Run ``fn(sampler)`` under hypothesis when available, else as a
    seeded random sweep over the same generator.  (No functools.wraps:
    pytest must see the *wrapper's* signature, not ``fn``'s.)"""
    if HAVE_HYPOTHESIS:
        def hyp_wrapper(data):
            fn(HypSampler(data.draw))
        hyp_wrapper.__name__ = fn.__name__
        hyp_wrapper.__doc__ = fn.__doc__
        return settings(max_examples=N_EXAMPLES, deadline=None)(
            given(st.data())(hyp_wrapper))

    def sweep_wrapper(seed):
        fn(RngSampler(np.random.default_rng(seed)))
    sweep_wrapper.__name__ = fn.__name__
    sweep_wrapper.__doc__ = fn.__doc__
    return pytest.mark.parametrize("seed", range(N_EXAMPLES))(
        sweep_wrapper)


def gen_scenario(s):
    """Random pool + packed-batch layout honoring the pipeline contract:
    blocks are document-pure; a doc's last block may be partially filled
    (trailing zeros); whole padding blocks may separate docs."""
    d = s.int_(1, 4)
    nb = s.int_(2, 8)
    segs = np.zeros((d, nb * BLK), np.int32)
    sid = 1
    for r in range(d):
        t = 0
        while t < nb:
            if s.bool_(0.15):                 # padding block
                t += 1
                continue
            dbl = s.int_(1, min(4, nb - t))
            tokens = dbl * BLK
            if s.bool_(0.3):                  # partial last block
                tokens -= s.int_(0, BLK - 1)
            segs[r, t * BLK:t * BLK + tokens] = sid
            sid += 1
            t += dbl
    cfg = CADConfig(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb,
                    nkv=4 * nb,
                    server_speeds=tuple(s.choice([0.25, 0.5, 1.0])
                                        for _ in range(d))
                    if s.bool_(0.5) else None)
    cost_model = CostModel.analytic(4, 32).scaled(s.choice([1.0, 2.5])) \
        if s.bool_(0.4) else None
    tolerance = s.choice([0.02, 0.1, 0.3])
    return cfg, segs, cost_model, tolerance


# ---------------------------------------------------------------- checks
def plan_served_blocks(cfg, plan):
    """(global block -> server) mapping reconstructed from the dispatch
    arrays; blocks appearing more than once are reported as duplicates."""
    d, nb = cfg.n_servers, cfg.nb
    served, dupes = {}, []
    q_home = np.asarray(plan["q_home_idx"])
    q_send = np.asarray(plan["q_send_idx"])
    for r in range(d):
        for i in range(nb):
            if q_home[r, i] >= 0:
                g = r * nb + int(q_home[r, i])
                if g in served:
                    dupes.append(g)
                else:
                    served[g] = r
    for src in range(d):
        for dst in range(d):
            for c in range(cfg.cq):
                idx = int(q_send[src, dst, c])
                if idx >= 0:
                    g = src * nb + idx
                    if g in served:
                        dupes.append(g)
                    else:
                        served[g] = dst
    return served, dupes


def resolve_kv_slot(cfg, plan, server, buf_pos):
    """kv buffer position -> the global kv block it holds."""
    nb, ckv = cfg.nb, cfg.ckv
    slot = int(np.asarray(plan["kv_gather"])[server, buf_pos])
    assert slot >= 0, "task kv range points at an empty buffer slot"
    if slot < nb:
        return server * nb + slot
    src, c = divmod(slot - nb, ckv)
    idx = int(np.asarray(plan["kv_send_idx"])[src, server, c])
    assert idx >= 0, "kv gather references an unused recv slot"
    return src * nb + idx


def task_q_block(cfg, plan, server, slot):
    """task slot -> the global q block it serves (or None if empty)."""
    nb, cq = cfg.nb, cfg.cq
    if slot < nb:
        idx = int(np.asarray(plan["q_home_idx"])[server, slot])
        return server * nb + idx if idx >= 0 else None
    src, c = divmod(slot - nb, cq)
    idx = int(np.asarray(plan["q_send_idx"])[src, server, c])
    return src * nb + idx if idx >= 0 else None


def run_policy(policy, cfg, segs, cost_model, tolerance):
    return get_planner(policy)(cfg, segs, comm=None, tolerance=tolerance,
                               cost_model=cost_model)


# ------------------------------------------------------------ properties
@property_case
def test_coverage_exactly_once(s):
    """Every live q-block is served exactly once; padding never."""
    cfg, segs, cm, tol = gen_scenario(s)
    policy = s.choice(POLICIES)
    res = run_policy(policy, cfg, segs, cm, tol)
    _docs, doc_of, _bi = layout_from_segments(segs, cfg.blk,
                                              cfg.n_servers)
    served, dupes = plan_served_blocks(cfg, res.plan)
    assert not dupes, f"{policy}: blocks served twice: {dupes}"
    for g in range(cfg.n_servers * cfg.nb):
        if doc_of[g] >= 0:
            assert g in served, f"{policy}: live block {g} never served"
            assert served[g] == int(res.assign[g]), \
                f"{policy}: plan serves {g} on {served[g]}, " \
                f"assign says {res.assign[g]}"
        else:
            assert g not in served, f"{policy}: padding block {g} served"


@property_case
def test_task_kv_is_doc_prefix(s):
    """Each task's kv buffer range resolves to its document's exact
    prefix, in order — the invariant the server kernels assume."""
    cfg, segs, cm, tol = gen_scenario(s)
    policy = s.choice(POLICIES)
    res = run_policy(policy, cfg, segs, cm, tol)
    docs, doc_of, bi_of = layout_from_segments(segs, cfg.blk,
                                               cfg.n_servers)
    kv_start = np.asarray(res.plan["task_kv_start"])
    kv_len = np.asarray(res.plan["task_kv_len"])
    for srv in range(cfg.n_servers):
        for slot in range(cfg.n_tasks):
            ln = int(kv_len[srv, slot])
            if ln == 0:
                continue
            g = task_q_block(cfg, res.plan, srv, slot)
            assert g is not None, "live task slot without a q block"
            dc = int(doc_of[g])
            assert ln == int(bi_of[g]) + 1, \
                f"task context is not the causal prefix ({ln} vs " \
                f"{bi_of[g] + 1})"
            g0 = docs[dc].g0
            start = int(kv_start[srv, slot])
            for j in range(ln):
                assert resolve_kv_slot(cfg, res.plan, srv, start + j) \
                    == g0 + j, "kv prefix out of order"


@property_case
def test_capacities_respected(s):
    """Send-slot and buffer usage never exceeds the static capacities
    the compiled dispatch shapes provide."""
    cfg, segs, cm, tol = gen_scenario(s)
    policy = s.choice(POLICIES)
    res = run_policy(policy, cfg, segs, cm, tol)
    q_send = np.asarray(res.plan["q_send_idx"])
    kv_send = np.asarray(res.plan["kv_send_idx"])
    kv_gather = np.asarray(res.plan["kv_gather"])
    assert ((q_send >= 0).sum(-1) <= cfg.cq).all()
    assert ((kv_send >= 0).sum(-1) <= cfg.ckv).all()
    assert ((kv_gather >= 0).sum(-1) <= cfg.nkv).all()
    # ... and the per-pair send lists are dense prefixes (pad = tail):
    # a dead slot is never followed by a live one
    for arr in (q_send, kv_send):
        live = arr >= 0
        assert not (~live[..., :-1] & live[..., 1:]).any()


@property_case
def test_load_accounting_conserves_work(s):
    """Reported loads equal the recomputed per-server cost over speed,
    and total work is conserved: sum(loads * speeds) == total cost."""
    cfg, segs, cm, tol = gen_scenario(s)
    policy = s.choice(POLICIES)
    res = run_policy(policy, cfg, segs, cm, tol)
    _docs, doc_of, bi_of = layout_from_segments(segs, cfg.blk,
                                                cfg.n_servers)
    cost = block_costs(doc_of, bi_of, cfg.blk, cm)
    live = doc_of >= 0
    expect = np.zeros(cfg.n_servers)
    np.add.at(expect, res.assign[live].astype(np.int64), cost[live])
    expect = expect / cfg.speeds()
    np.testing.assert_allclose(res.loads, expect, rtol=1e-9)
    np.testing.assert_allclose((res.loads * cfg.speeds()).sum(),
                               cost[live].sum(), rtol=1e-9)
    assert res.stats["load_max_over_mean"] >= 1.0 - 1e-12 \
        or cost[live].sum() == 0


@property_case
def test_planning_is_deterministic(s):
    """Same inputs -> bit-identical plans and assignments (the replay
    guarantee the prefetch path depends on)."""
    cfg, segs, cm, tol = gen_scenario(s)
    policy = s.choice(POLICIES)
    a = run_policy(policy, cfg, segs, cm, tol)
    b = run_policy(policy, cfg, segs, cm, tol)
    np.testing.assert_array_equal(a.assign, b.assign)
    for key in a.plan.keys():
        np.testing.assert_array_equal(np.asarray(a.plan[key]),
                                      np.asarray(b.plan[key]),
                                      err_msg=f"{policy}:{key}")


@property_case
def test_balanced_never_worse_than_identity(s):
    """The greedy scheduler only moves work toward deficit servers: its
    max modeled time never exceeds identity's."""
    cfg, segs, cm, tol = gen_scenario(s)
    ident = run_policy("identity", cfg, segs, cm, tol)
    bal = run_policy("balanced", cfg, segs, cm, tol)
    assert bal.loads.max() <= ident.loads.max() * (1 + 1e-9), \
        (bal.loads, ident.loads)


@property_case
def test_infeasible_raises_capacity_error(s):
    """Assignments that cannot fit the static shapes raise
    PlanCapacityError with diagnostics — never a bare assert and never
    a silently-truncated plan."""
    cfg, segs, _cm, _tol = gen_scenario(s)
    if cfg.n_servers == 1:
        return                              # nothing can overflow
    docs, doc_of, bi_of = layout_from_segments(segs, cfg.blk,
                                               cfg.n_servers)
    if not (doc_of >= 0).any():
        return
    tiny = CADConfig(n_servers=cfg.n_servers, blk=cfg.blk, nb=cfg.nb,
                     cq=s.int_(1, 2), ckv=s.int_(1, 2),
                     nkv=s.int_(1, cfg.nb + 1))
    # stress assignment: everything on server 0
    assign = np.zeros_like(identity_assignment(tiny))
    try:
        plan = plan_from_assignment(tiny, assign, doc_of, bi_of, docs)
    except PlanCapacityError as e:
        assert e.capacity in ("CQ", "CKV", "NKV")
        assert e.needed > e.available >= 0
        assert str(e.capacity) in str(e)
        return
    # a successful build must actually be feasible: re-verify coverage
    served, dupes = plan_served_blocks(tiny, plan)
    assert not dupes
    assert all(doc_of[g] >= 0 for g in served)
    assert sum(1 for g in range(len(doc_of)) if doc_of[g] >= 0) \
        == len(served)


@property_case
def test_membership_subset_invariant(s):
    """Elastic membership (DESIGN.md §9): with a random non-empty
    proper subset of servers excluded (drained/dead pool members),
    every policy still serves each live block exactly once, never on an
    excluded server, leaves excluded loads at zero, and replans
    bit-identically — the invariant the recovery/epoch machinery
    depends on.  Builds that genuinely cannot fit the survivors' caps
    must fail with PlanCapacityError, never silently truncate."""
    cfg, segs, cm, tol = gen_scenario(s)
    if cfg.n_servers == 1:
        return                               # no proper subset exists
    d = cfg.n_servers
    mask = s.int_(1, 2 ** d - 2)             # >=1 excluded, >=1 survivor
    exclude = tuple(i for i in range(d) if mask >> i & 1)
    policy = s.choice(POLICIES)
    try:
        res = run_policy_excl(policy, cfg, segs, cm, tol, exclude)
    except PlanCapacityError as e:
        assert e.capacity in ("CQ", "CKV", "NKV")
        return
    _docs, doc_of, _bi = layout_from_segments(segs, cfg.blk, d)
    served, dupes = plan_served_blocks(cfg, res.plan)
    assert not dupes, f"{policy}: blocks served twice: {dupes}"
    for g in range(d * cfg.nb):
        if doc_of[g] >= 0:
            assert g in served, f"{policy}: live block {g} dropped " \
                f"under exclude={exclude}"
            assert served[g] not in exclude, \
                f"{policy}: block {g} served on excluded " \
                f"{served[g]} (exclude={exclude})"
        else:
            assert g not in served
    for e in exclude:
        assert res.loads[e] == 0.0, (policy, exclude, res.loads)
    again = run_policy_excl(policy, cfg, segs, cm, tol, exclude)
    np.testing.assert_array_equal(res.assign, again.assign)
    for key in res.plan.keys():
        np.testing.assert_array_equal(np.asarray(res.plan[key]),
                                      np.asarray(again.plan[key]),
                                      err_msg=f"{policy}:{key}")


def run_policy_excl(policy, cfg, segs, cost_model, tolerance, exclude):
    return get_planner(policy)(cfg, segs, comm=None, tolerance=tolerance,
                               cost_model=cost_model, exclude=exclude)


@property_case
def test_memory_budget_invariant(s):
    """HBM budgets (DESIGN.md §11): every successful plan's resident
    bytes fit the budget on every server (streamed docs clamped to the
    chunk), the reported residency matches an independent recompute,
    coverage still holds, and infeasible builds raise PlanMemoryError
    with over-budget diagnostics — never a silent overflow."""
    cfg, segs, cm, tol = gen_scenario(s)
    policy = s.choice(POLICIES)
    mem = MemoryModel(CommModel(2, 8, 2))
    base = get_planner(policy)(cfg, segs, comm=None, tolerance=tol,
                               cost_model=cm, mem_model=mem)
    resident0 = np.asarray(base.resident_bytes, np.float64)
    if resident0.max() <= 0:
        return                               # all-padding batch
    factor = s.choice([1.0, 0.8, 0.6])
    budgets = np.full(cfg.n_servers, factor * resident0.max())
    chunk = s.choice([0, 1, 2])
    try:
        res = get_planner(policy)(cfg, segs, comm=None, tolerance=tol,
                                  cost_model=cm, mem_model=mem,
                                  budgets=budgets, stream_chunk=chunk)
    except PlanMemoryError as e:
        assert e.resident_bytes > e.budget_bytes >= 0
        assert "resident bytes" in str(e)
        return
    docs, doc_of, bi_of = layout_from_segments(segs, cfg.blk,
                                               cfg.n_servers)
    rec = assignment_resident_bytes(res.assign, doc_of, bi_of, cfg.blk,
                                    cfg.n_servers, mem,
                                    streamed=res.streamed,
                                    stream_chunk=chunk)
    np.testing.assert_allclose(np.asarray(res.resident_bytes), rec,
                               rtol=1e-9)
    assert (np.asarray(res.resident_bytes) <= budgets + 1e-9).all(), \
        (policy, res.resident_bytes, budgets)
    served, dupes = plan_served_blocks(cfg, res.plan)
    assert not dupes
    assert len(served) == int((doc_of >= 0).sum())


@property_case
def test_stats_moves_match_assignment(s):
    """n_moves counts exactly the blocks served away from home."""
    cfg, segs, cm, tol = gen_scenario(s)
    policy = s.choice(["per_doc_cp", "balanced"])
    res = run_policy(policy, cfg, segs, cm, tol)
    _docs, doc_of, _bi = layout_from_segments(segs, cfg.blk,
                                              cfg.n_servers)
    home = identity_assignment(cfg)
    if policy == "per_doc_cp":
        # per_doc_cp counts every re-homed block, live or not
        assert res.stats["n_moves"] == int((res.assign != home).sum())
    else:
        live = doc_of >= 0
        moved = int((res.assign[live] != home[live]).sum())
        # net displacement requires at least one greedy range-move
        if moved > 0:
            assert res.stats["n_moves"] > 0
        if res.stats["n_moves"] == 0:
            assert moved == 0
    assert res.stats["comm_bytes"] >= 0.0


# --------------------------------------------- mask-structured tasks (§12)
def gen_mask(s):
    """Random non-trivial task-shape spec scaled to BLK (DESIGN.md §12)."""
    if s.choice(["sliding", "dilated"]) == "sliding":
        return MaskSpec(kind="sliding",
                        window=s.choice([BLK // 2, BLK, 3 * BLK]),
                        sink=s.choice([0, BLK]))
    return MaskSpec(kind="dilated", rate=s.choice([2, 3, 4]))


def run_policy_mask(policy, cfg, segs, cost_model, tolerance, mask):
    return get_planner(policy)(cfg, segs, comm=None, tolerance=tolerance,
                               cost_model=cost_model, mask=mask)


@property_case
def test_masked_coverage_loads_and_capacities(s):
    """Mask-structured splits keep every plan invariant: exactly-once
    coverage, dense send prefixes within static capacities, loads equal
    to the live-block cost recompute (work conserved under speeds), and
    bit-identical replanning."""
    cfg, segs, cm, tol = gen_scenario(s)
    mask = gen_mask(s)
    policy = s.choice(POLICIES)
    res = run_policy_mask(policy, cfg, segs, cm, tol, mask)
    _docs, doc_of, bi_of = layout_from_segments(segs, cfg.blk,
                                                cfg.n_servers)
    served, dupes = plan_served_blocks(cfg, res.plan)
    assert not dupes, f"{policy}/{mask.describe()}: served twice: {dupes}"
    for g in range(cfg.n_servers * cfg.nb):
        if doc_of[g] >= 0:
            assert g in served and served[g] == int(res.assign[g]), \
                f"{policy}/{mask.describe()}: block {g} miscovered"
        else:
            assert g not in served
    for key in ("q_send_idx", "kv_send_idx"):
        arr = np.asarray(res.plan[key])
        cap = cfg.cq if key == "q_send_idx" else cfg.ckv
        assert ((arr >= 0).sum(-1) <= cap).all()
        live = arr >= 0
        assert not (~live[..., :-1] & live[..., 1:]).any()
    cost = block_costs(doc_of, bi_of, cfg.blk, cm, mask)
    live = doc_of >= 0
    expect = np.zeros(cfg.n_servers)
    np.add.at(expect, res.assign[live].astype(np.int64), cost[live])
    np.testing.assert_allclose(res.loads, expect / cfg.speeds(),
                               rtol=1e-9)
    np.testing.assert_allclose((res.loads * cfg.speeds()).sum(),
                               cost[live].sum(), rtol=1e-9)
    again = run_policy_mask(policy, cfg, segs, cm, tol, mask)
    np.testing.assert_array_equal(res.assign, again.assign)


@property_case
def test_masked_balanced_and_memory_budget(s):
    """Under live-block pricing the greedy scheduler still never leaves
    a higher max modeled time than identity, and HBM budgets keep their
    inclusive-fit guarantee (residency is the full kv prefix the gather
    buffer realizes, mask or not — DESIGN.md §11/§12)."""
    cfg, segs, cm, tol = gen_scenario(s)
    mask = gen_mask(s)
    ident = run_policy_mask("identity", cfg, segs, cm, tol, mask)
    bal = run_policy_mask("balanced", cfg, segs, cm, tol, mask)
    assert bal.loads.max() <= ident.loads.max() * (1 + 1e-9), \
        (mask.describe(), bal.loads, ident.loads)
    mem = MemoryModel(CommModel(2, 8, 2))
    policy = s.choice(POLICIES)
    base = get_planner(policy)(cfg, segs, comm=None, tolerance=tol,
                               cost_model=cm, mem_model=mem, mask=mask)
    resident0 = np.asarray(base.resident_bytes, np.float64)
    if resident0.max() <= 0:
        return                               # all-padding batch
    budgets = np.full(cfg.n_servers, s.choice([1.0, 0.7]) *
                      resident0.max())
    try:
        res = get_planner(policy)(cfg, segs, comm=None, tolerance=tol,
                                  cost_model=cm, mem_model=mem,
                                  budgets=budgets, mask=mask)
    except PlanMemoryError as e:
        assert e.resident_bytes > e.budget_bytes >= 0
        return
    docs, doc_of, bi_of = layout_from_segments(segs, cfg.blk,
                                               cfg.n_servers)
    rec = assignment_resident_bytes(res.assign, doc_of, bi_of, cfg.blk,
                                    cfg.n_servers, mem,
                                    streamed=res.streamed)
    np.testing.assert_allclose(np.asarray(res.resident_bytes), rec,
                               rtol=1e-9)
    assert (np.asarray(res.resident_bytes) <= budgets + 1e-9).all()
    served, dupes = plan_served_blocks(cfg, res.plan)
    assert not dupes
    assert len(served) == int((doc_of >= 0).sum())
