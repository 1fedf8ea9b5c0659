"""The port's single-process CAD dispatch (``repro_torch.core.dispatch``)
against ``repro.core.dispatch._global_sim`` with the blockwise ``xla``
server, on the same plans and numpy inputs: outputs and q/k/v gradients
(f32 atol 1e-5), and CAD == the port's own monolithic ``ref_attention``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro.core.plan import CADConfig as JCfg
from repro.core.plan import identity_plan as j_identity_plan
from repro.core.plan import per_document_cp_plan as j_cp_plan
from repro.core.plan import plan_from_schedule as j_from_schedule
from repro.core.scheduler import schedule as j_schedule
from repro.core.cost_model import CommModel as JComm
from repro.parallel import ParallelContext as JCtx
from repro_torch.core import dispatch as D
from repro_torch.core.attention import ref_attention
from repro_torch.core.plan import CADConfig, StepPlan
from repro_torch.parallel import ParallelContext
from test_torch_helpers import to_numpy, to_torch

BLK = 64
JMAX = 4          # kv blocks per task: no document is longer (as the
                  # session bounds it by max_doc_len)
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def random_layout(rng, rows, s, max_doc_blocks=4):
    """Rank-major packed rows of block-aligned documents, some ending in
    padding inside their last block."""
    segs = np.zeros((rows, s), np.int32)
    poss = np.zeros((rows, s), np.int32)
    sid = 1
    for r in range(rows):
        t = 0
        while t < s:
            dl = min(int(rng.integers(1, max_doc_blocks + 1)) * BLK, s - t)
            real = dl if rng.random() < 0.7 else max(
                1, dl - int(rng.integers(0, BLK)))
            segs[r, t:t + real] = sid
            poss[r, t:t + real] = np.arange(real)
            sid += 1
            t += dl
    return segs, poss


def make_cfg(d, tokens):
    nb = tokens // BLK
    return dict(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb, nkv=4 * nb)


def _plan(policy, geo, segs, hq, dh, hkv):
    cfg = JCfg(**geo)
    if policy == "identity":
        return j_identity_plan(cfg, segs)
    if policy == "per_doc_cp":
        return j_cp_plan(cfg, segs)
    sch = j_schedule(segs, blk=BLK, n_servers=geo["n_servers"],
                     comm=JComm(hq, dh, hkv), caps=cfg.caps(),
                     tolerance=0.05)
    return j_from_schedule(cfg, sch)


def _qkv(seed, rows, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, s, hq, dh)).astype(np.float32),
            rng.standard_normal((rows, s, hkv, dh)).astype(np.float32),
            rng.standard_normal((rows, s, hkv, dh)).astype(np.float32))


def _jax_vjp(f, q, k, v, g):
    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(f, q_, k_, v_)
        return out, vjp(g_)
    return run(*(jnp.asarray(x) for x in (q, k, v, g)))


def _torch_sim_and_grads(fn, q, k, v, g):
    qt, kt, vt = (to_torch(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), to_torch(g))
    return out, grads


# (policy, servers, rows per rank, tokens per row, Hq, Hkv, dh, seed)
CASES = {
    "identity": ("identity", 2, 1, 6 * BLK, 2, 2, 32, 0),
    "per_doc_cp": ("per_doc_cp", 4, 1, 4 * BLK, 2, 2, 32, 1),
    "balanced": ("balanced", 4, 1, 6 * BLK, 2, 2, 32, 2),
    "balanced-gqa4/2": ("balanced", 2, 2, 3 * BLK, 4, 2, 32, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_global_sim_matches_reference(case):
    policy, d, rpr, s, hq, hkv, dh, seed = CASES[case]
    rng = np.random.default_rng(seed)
    segs, poss = random_layout(rng, d * rpr, s)
    geo = make_cfg(d, rpr * s)
    jplan = _plan(policy, geo, segs.reshape(d, -1), hq, dh, hkv)
    q, k, v = _qkv(seed, d * rpr, s, hq, hkv, dh)
    g = np.random.default_rng(seed + 100).standard_normal(
        q.shape).astype(np.float32)
    posm = np.where(segs > 0, poss, -1).astype(np.int32)

    jcad = JD.CADContext(cfg=JCfg(**geo), kernel="xla", jmax=JMAX)
    jplan_d = jax.tree.map(jnp.asarray, jplan)
    want, want_g = _jax_vjp(
        lambda q_, k_, v_: JD._global_sim(q_, k_, v_, jnp.asarray(posm),
                                          jplan_d, jcad, 0.0, None),
        q, k, v, g)

    cfg = CADConfig(**geo)
    plan = StepPlan.from_dict(jplan.to_dict()).to("cpu")
    cad = D.CADContext(cfg=cfg, jmax=JMAX)
    got, got_g = _torch_sim_and_grads(
        lambda a, b, c: D._global_sim(a, b, c, to_torch(posm), plan, cad,
                                      0.0, None), q, k, v, g)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **OUT_TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **GRAD_TOL)

    # CAD == monolithic attention, inside the port
    seg_t, pos_t = to_torch(segs), to_torch(poss)
    ctx = ParallelContext(attn_impl="cad", cad=D.CADContext(
        cfg=cfg, plan=plan, jmax=JMAX))
    mono, mono_g = _torch_sim_and_grads(
        lambda a, b, c: ref_attention(a, b, c, seg_t, pos_t, seg_t, pos_t),
        q, k, v, g)
    cad_out, cad_g = _torch_sim_and_grads(
        lambda a, b, c: D.cad_attention(a, b, c, seg_t, pos_t, seg_t, pos_t,
                                        ctx=ctx), q, k, v, g)
    torch.testing.assert_close(cad_out, mono, atol=2e-5, rtol=1e-5)
    for a, b in zip(cad_g, mono_g):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=1e-4)


def test_pingpong_matches_reference():
    """Two nano-batches with their own plans, split within each rank's
    rows, against the reference's ping-pong ``cad_attention``."""
    d, rpr, s, hq, hkv, dh = 2, 2, 4 * BLK, 4, 2, 32
    rng = np.random.default_rng(11)
    segs, poss = random_layout(rng, d * rpr, s, max_doc_blocks=3)
    geo = make_cfg(d, (rpr // 2) * s)
    jplans = []
    for i in range(2):
        seg_i = np.stack([segs[r * rpr + i] for r in range(d)])
        jplans.append(_plan("balanced", geo, seg_i, hq, dh, hkv))
    q, k, v = _qkv(4, d * rpr, s, hq, hkv, dh)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    seg_j, pos_j = jnp.asarray(segs), jnp.asarray(poss)
    jcad = JD.CADContext(cfg=JCfg(**geo), kernel="xla", jmax=JMAX,
                         pingpong=True,
                         plan=tuple(jax.tree.map(jnp.asarray, p)
                                    for p in jplans))
    jctx = JCtx(mesh=None, attn_impl="cad", cad=jcad)
    want, want_g = _jax_vjp(
        lambda q_, k_, v_: JD.cad_attention(q_, k_, v_, seg_j, pos_j, seg_j,
                                            pos_j, ctx=jctx), q, k, v, g)

    cfg = CADConfig(**geo)
    plans = tuple(StepPlan.from_dict(p.to_dict()).to("cpu") for p in jplans)
    ctx = ParallelContext(attn_impl="cad", cad=D.CADContext(
        cfg=cfg, plan=plans, jmax=JMAX, pingpong=True))
    seg_t, pos_t = to_torch(segs), to_torch(poss)
    got, got_g = _torch_sim_and_grads(
        lambda a, b, c: D.cad_attention(a, b, c, seg_t, pos_t, seg_t, pos_t,
                                        ctx=ctx), q, k, v, g)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **OUT_TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **GRAD_TOL)


def test_server_batches_are_what_the_kernels_get(monkeypatch):
    """``server_batches`` rebuilds exactly the per-server inputs
    ``_global_sim`` hands ``ca_server_attention``."""
    policy, d, rpr, s, hq, hkv, dh, seed = CASES["balanced"]
    segs, poss = random_layout(np.random.default_rng(seed), d * rpr, s)
    geo = make_cfg(d, rpr * s)
    plan = StepPlan.from_dict(_plan(policy, geo, segs.reshape(d, -1), hq,
                                    dh, hkv).to_dict()).to("cpu")
    cad = D.CADContext(cfg=CADConfig(**geo), jmax=JMAX)
    q, k, v = (to_torch(x) for x in _qkv(seed, d * rpr, s, hq, hkv, dh))
    posm = to_torch(np.where(segs > 0, poss, -1).astype(np.int32))
    seen = []
    real = D.ca_server_attention

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(D, "ca_server_attention", spy)
    D._global_sim(q, k, v, posm, plan, cad, 0.0, None)
    batches = D.server_batches(q, k, v, posm, plan, cad)
    assert len(seen) == len(batches) == d
    names = ("q_tasks", "k_buf", "v_buf", "kv_start", "kv_len", "q_pos",
             "kv_pos")
    for (args, kw), b in zip(seen, batches):
        for name, a in zip(names, args):
            assert torch.equal(a, b[name]), name
        for name in ("jmax", "window", "sink", "rate"):
            assert kw[name] == b[name], name


def test_windowed_or_planless_layers_raise():
    """Windowed and non-causal layers, and calls without a plan, fall back
    to ``xla_flash_attention`` as the reference's ``cad_attention`` does,
    the dilated family at the pool's block.  (The name is that of the
    test from before the fallback was ported, when these calls raised;
    it is kept so the test's history stays one line.)"""
    from repro.core.mask import MaskSpec as JMask
    from repro_torch.core.mask import MaskSpec
    geo = make_cfg(2, 2 * BLK)
    rng = np.random.default_rng(5)
    segs, poss = random_layout(rng, 2, 2 * BLK)
    q = rng.standard_normal((2, 2 * BLK, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2 * BLK, 2, 32)).astype(np.float32)
            for _ in range(2))
    jctx = JCtx(attn_impl="cad", cad=JD.CADContext(cfg=JCfg(**geo)))
    ctx = ParallelContext(attn_impl="cad",
                          cad=D.CADContext(cfg=CADConfig(**geo)))
    cases = {"planless": ({}, {}), "windowed": ({"window": 40},) * 2,
             "non-causal": ({"causal": False},) * 2,
             "dilated": ({"mask": JMask("dilated", rate=2)},
                         {"mask": MaskSpec("dilated", rate=2)})}
    for case, (jkw, tkw) in cases.items():
        want = JD.cad_attention(*(jnp.asarray(x) for x in (
            q, k, v, segs, poss, segs, poss)), ctx=jctx, softcap=5.0, **jkw)
        got = D.cad_attention(*(to_torch(x) for x in (
            q, k, v, segs, poss, segs, poss)), ctx=ctx, softcap=5.0, **tkw)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   err_msg=case, **OUT_TOL)


def test_iter_plan_tasks_matches_reference():
    from repro.core.mask import MaskSpec as JMask
    from repro_torch.core.mask import MaskSpec
    policy, d, rpr, s, hq, hkv, dh, seed = CASES["balanced"]
    segs, _ = random_layout(np.random.default_rng(seed), d * rpr, s)
    geo = make_cfg(d, rpr * s)
    jplan = _plan(policy, geo, segs.reshape(d, -1), hq, dh, hkv)
    plan = StepPlan.from_dict(jplan.to_dict())
    for jm, tm in ((None, None), (JMask("dilated", rate=2),
                                  MaskSpec("dilated", rate=2))):
        want = JD.iter_plan_tasks(JCfg(**geo), jplan, mask=jm)
        assert D.iter_plan_tasks(CADConfig(**geo), plan, mask=tm) == want
        assert D.iter_plan_tasks(CADConfig(**geo), plan.to("cpu"),
                                 mask=tm) == want


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_unported_attention_routes_raise(impl):
    """The ``xla`` and ``pallas`` routes of ``core_attention`` give what
    the reference's router gives.  (The name is that of the test from
    before these routes were ported, when they raised; it is kept so the
    test's history stays one line.)"""
    from repro.core.attention import core_attention as j_core_attention
    from repro_torch.core.attention import core_attention
    rng = np.random.default_rng(6)
    segs, poss = random_layout(rng, 1, 2 * BLK)
    q, k, v = (rng.standard_normal((1, 2 * BLK, 2, 32)).astype(np.float32)
               for _ in range(3))
    want = j_core_attention(*(jnp.asarray(x) for x in (q, k, v, segs, poss,
                                                       segs, poss)),
                            ctx=JCtx(attn_impl=impl), window=48,
                            softcap=5.0)
    got = core_attention(*(to_torch(x) for x in (q, k, v, segs, poss, segs,
                                                 poss)),
                         ctx=ParallelContext(attn_impl=impl), window=48,
                         softcap=5.0)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **OUT_TOL)
