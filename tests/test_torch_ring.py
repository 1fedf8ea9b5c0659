"""The port's ring-attention baseline (DISTFLASHATTN, DESIGN.md §13):
``ring_pass_geometry``, ``merge_softmax_partials``,
``ca_partial_attention``, ``ring_attention`` and ``ring_global_sim``.

``ring_pass_geometry`` is host numpy: exactly the reference's arrays.
Inside the port: a dead partial merges as a bitwise no-op, forward and
gradient; ``ring_attention`` (per-server passes) == ``ring_global_sim``
(the stacked orchestration) bitwise, forward and gradients.  Against the
reference, on the same plans and numpy inputs: the merge and the partial
op (with the lse cotangent) against ``jax.vjp`` of the reference's ops,
the ring against the reference's ring, and the ring against the port's
one-shot ``_global_sim``, within f32 tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cad import get_planner as j_get_planner
from repro.core import dispatch as JD
from repro.core.mask import MaskSpec as JMask
from repro.core.plan import CADConfig as JCfg
from repro.kernels.packed_flash import ops as JO
from repro_torch.core import dispatch as D
from repro_torch.core.attention import LSE_DEAD
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import CADConfig, StepPlan
from repro_torch.kernels.packed_flash import ops
from test_torch_helpers import to_numpy, to_torch

BLK = 16
MASKS = {"dense": None,
         "sliding": ("sliding", dict(window=2 * BLK, sink=BLK)),
         "dilated": ("dilated", dict(rate=2))}
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)


def _masks(name):
    if MASKS[name] is None:
        return None, None
    kind, kw = MASKS[name]
    return JMask(kind=kind, **kw), MaskSpec(kind=kind, **kw)


def make_layout(d, nb, seed=0, max_doc_blocks=4):
    """Block-aligned documents, no padding (the reference's ring
    layout)."""
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
    poss = np.broadcast_to(np.arange(nb * BLK), segs.shape)
    return segs, np.where(segs > 0, poss, -1).astype(np.int32)


def ring_setup(mask_name, seed, d=4, nb=8, hq=2, hkv=2, dh=8):
    """A ``ring`` plan of a random layout, seeded q/k/v and an output
    cotangent, for both packages."""
    jmask, tmask = _masks(mask_name)
    geo = dict(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb, nkv=4 * nb)
    segs, pos = make_layout(d, nb, seed)
    res = j_get_planner("ring")(JCfg(**geo), segs, comm=None, mask=jmask)
    rng = np.random.default_rng(seed + 50)
    q = rng.standard_normal((d, nb * BLK, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((d, nb * BLK, hkv, dh)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    cad = D.CADContext(cfg=CADConfig(**geo), jmax=geo["nkv"], mask=tmask)
    jcad = JD.CADContext(cfg=JCfg(**geo), plan=jax.tree.map(jnp.asarray,
                                                            res.plan),
                         kernel="xla", jmax=geo["nkv"], mask=jmask)
    return dict(geo=geo, segs=segs, pos=pos, jplan=res.plan,
                plan=StepPlan.from_dict(res.plan.to_dict()).to("cpu"),
                cad=cad, jcad=jcad, jmask=jmask, mask=tmask, q=q, k=k, v=v,
                g=g)


def _bits(x):
    return to_numpy(x).tobytes()


def _with_grads(fn, st):
    q, k, v = (to_torch(st[n]).requires_grad_() for n in "qkv")
    out = fn(q, k, v)
    return out, torch.autograd.grad(out, (q, k, v), to_torch(st["g"]))


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_ring_pass_geometry_matches_reference(mask_name):
    """The pass pseudo-plans (starts, lengths, jmax) equal the
    reference's exactly, passes counted as servers or given."""
    st = ring_setup(mask_name, seed=1)
    cfg, jcfg = st["cad"].cfg, st["jcad"].cfg
    for n_passes in (None, 3):
        want = JD.ring_pass_geometry(jcfg, st["segs"], st["jplan"],
                                     n_passes=n_passes, mask=st["jmask"])
        got = D.ring_pass_geometry(cfg, st["segs"], st["plan"],
                                   n_passes=n_passes, mask=st["mask"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a["jmax"] == b["jmax"]
            for key in ("task_kv_start", "task_kv_len"):
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].dtype == b[key].dtype


def test_ring_geometry_covers_each_prefix_once():
    """Pass 0 (the diagonal) is live for every live task; the passes
    cover each task's prefix exactly once; masks never add kv."""
    st = ring_setup("dense", seed=2)
    cfg = st["cad"].cfg
    pps = D.ring_pass_geometry(cfg, st["segs"], st["plan"])
    kv_len = D._plan_numpy(st["plan"])["task_kv_len"]
    assert (pps[0]["task_kv_len"][kv_len > 0] > 0).all()
    np.testing.assert_array_equal(sum(pp["task_kv_len"] for pp in pps),
                                  kv_len)
    pps_m = D.ring_pass_geometry(cfg, st["segs"], st["plan"],
                                 mask=_masks("sliding")[1])
    for pp_d, pp_m in zip(pps, pps_m):
        assert (pp_m["task_kv_len"] <= pp_d["task_kv_len"]).all()


# --------------------------------------------------------------- merge
def _partials(seed, dead_rows=False):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)  # [b,blk,h,d]
    lse = rng.standard_normal((3, 2, 4)).astype(np.float32)     # [b,h,blk]
    if dead_rows:
        out[1, :, 0] = 0.0
        lse[1, 0] = LSE_DEAD
    return out, lse


def test_merge_dead_partial_is_bitwise_noop():
    """A dead partial (lse LSE_DEAD) merged with a live one gives the live
    side bitwise, either order, forward and gradient; the dead side gets
    zero gradient."""
    out_a, lse_a = (to_torch(x) for x in _partials(7))
    out_dead = torch.zeros_like(out_a)
    lse_dead = torch.full_like(lse_a, LSE_DEAD)
    for args in ((out_a, lse_a, out_dead, lse_dead),
                 (out_dead, lse_dead, out_a, lse_a)):
        o, lse = ops.merge_softmax_partials(*args)
        assert _bits(o) == _bits(out_a) and _bits(lse) == _bits(lse_a)

    leaves = [x.clone().requires_grad_() for x in (out_a, lse_a, out_dead,
                                                   lse_dead)]
    o, lse = ops.merge_softmax_partials(*leaves)
    g = torch.autograd.grad((o * o).sum() + torch.sin(lse).sum(), leaves)
    ra, rl = (x.clone().requires_grad_() for x in (out_a, lse_a))
    want = torch.autograd.grad((ra * ra).sum() + torch.sin(rl).sum(),
                               (ra, rl))
    assert _bits(g[0]) == _bits(want[0]) and _bits(g[1]) == _bits(want[1])
    assert not g[2].any() and not g[3].any()


def test_merge_two_live_halves_match_whole():
    """One softmax split into two kv halves, each finalized, merges back
    into the unsplit attention; gradients flow into both halves."""
    rng = np.random.default_rng(11)
    T, H, dh, S = 4, 2, 8, 32
    q, k, v = (to_torch(rng.standard_normal(sh).astype(np.float32))
               for sh in ((T, H, dh), (S, H, dh), (S, H, dh)))

    def half(kk, vv):
        s = torch.einsum("thd,shd->hts", q, kk) / np.sqrt(dh)
        lse = torch.logsumexp(s, -1)                        # [H, T]
        o = torch.einsum("hts,shd->thd", torch.exp(s - lse[..., None]), vv)
        return o, lse

    s = torch.einsum("thd,shd->hts", q, k) / np.sqrt(dh)
    whole = torch.einsum("hts,shd->thd", torch.softmax(s, -1), v)
    (oa, la), (ob, lb) = half(k[:S // 2], v[:S // 2]), half(k[S // 2:],
                                                            v[S // 2:])
    oa, ob = oa.requires_grad_(), ob.requires_grad_()
    o, _ = ops.merge_softmax_partials(oa[None], la[None], ob[None],
                                      lb[None])
    torch.testing.assert_close(o[0], whole, atol=1e-6, rtol=1e-6)
    ga, gb = torch.autograd.grad((o ** 2).sum(), (oa, ob))
    assert torch.isfinite(ga).all() and ga.any() and gb.any()


def test_merge_matches_reference():
    """Forward and all four gradients against ``jax.vjp`` of the
    reference's merge, with dead rows on one side."""
    oa, la = _partials(3, dead_rows=True)
    ob, lb = _partials(4)
    rng = np.random.default_rng(5)
    g_out = rng.standard_normal(oa.shape).astype(np.float32)
    g_lse = rng.standard_normal(la.shape).astype(np.float32)
    (want_o, want_l), vjp = jax.vjp(JO.merge_softmax_partials,
                                    *(jnp.asarray(x) for x in (oa, la, ob,
                                                               lb)))
    want_g = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    leaves = [to_torch(x).requires_grad_() for x in (oa, la, ob, lb)]
    o, lse = ops.merge_softmax_partials(*leaves)
    got_g = torch.autograd.grad((o, lse), leaves,
                                (to_torch(g_out), to_torch(g_lse)))
    np.testing.assert_allclose(to_numpy(o), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(to_numpy(lse), np.asarray(want_l), **TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **TOL)


# ------------------------------------------------------ partial attention
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_ca_partial_attention_matches_reference(mask_name):
    """One ring pass's partial on a server batch: (out, lse) and the
    q/k/v gradients of both cotangents (``g_lse`` included) against
    ``jax.vjp`` of the reference's ``ca_partial_attention``."""
    st = ring_setup(mask_name, seed=3)
    cad, jcad = st["cad"], st["jcad"]
    pp = D.ring_pass_geometry(cad.cfg, st["segs"], st["plan"],
                              mask=st["mask"])[1]
    s = 1
    inputs, plans_r = D.build_server_inputs(
        cad, st["plan"], *(to_torch(st[n]) for n in ("q", "k", "v", "pos")))
    qt, qp, kb, vb, kp = (x.contiguous() for x in inputs[s])
    st_, ln = (torch.as_tensor(pp[key][s]) for key in ("task_kv_start",
                                                       "task_kv_len"))
    window, sink, rate = D.mask_params(st["mask"], 0)
    jmax = max(pp["jmax"], 1)
    rng = np.random.default_rng(9)
    g_out = rng.standard_normal(qt.shape).astype(np.float32)
    g_lse = rng.standard_normal((qt.shape[0], qt.shape[2],
                                 qt.shape[1])).astype(np.float32)

    def jfn(a, b, c):
        return JO.ca_partial_attention(
            a, b, c, jnp.asarray(pp["task_kv_start"][s]),
            jnp.asarray(pp["task_kv_len"][s]), jnp.asarray(to_numpy(qp)),
            jnp.asarray(to_numpy(kp)), jmax, window, 0.0, None, sink, rate,
            "xla")
    (want_o, want_l), vjp = jax.vjp(jfn, *(jnp.asarray(to_numpy(x))
                                           for x in (qt, kb, vb)))
    want_g = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))

    leaves = [x.clone().requires_grad_() for x in (qt, kb, vb)]
    o, lse = ops.ca_partial_attention(*leaves, st_, ln, qp, kp, jmax=jmax,
                                      window=window, sink=sink, rate=rate)
    got_g = torch.autograd.grad((o, lse), leaves,
                                (to_torch(g_out), to_torch(g_lse)))
    assert (ln == 0).any()                  # dead rows in this pass
    np.testing.assert_allclose(to_numpy(o), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(to_numpy(lse), np.asarray(want_l), **TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **GRAD_TOL)


# ------------------------------------------------------------------ ring
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_ring_bitwise_vs_oracle(mask_name):
    """The decomposed per-server ring == the stacked single-pool oracle
    running the same pass schedule, bitwise, forward and gradients."""
    st = ring_setup(mask_name, seed=2)
    pos = to_torch(st["pos"])
    ring, ring_g = _with_grads(lambda a, b, c: D.ring_attention(
        st["cad"], st["plan"], st["segs"], a, b, c, pos), st)
    sim, sim_g = _with_grads(lambda a, b, c: D.ring_global_sim(
        a, b, c, pos, st["plan"], st["cad"], st["segs"]), st)
    assert _bits(ring) == _bits(sim)
    for a, b in zip(ring_g, sim_g):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_ring_matches_reference_and_full_serve(mask_name):
    """The port's ring against the reference's ``ring_global_sim`` and
    against the port's one-shot ``_global_sim`` of the same plan (the ring
    changes the reduction order only): output and gradients."""
    st = ring_setup(mask_name, seed=4)
    pos = to_torch(st["pos"])
    ring, ring_g = _with_grads(lambda a, b, c: D.ring_attention(
        st["cad"], st["plan"], st["segs"], a, b, c, pos), st)
    full, full_g = _with_grads(lambda a, b, c: D._global_sim(
        a, b, c, pos, st["plan"], st["cad"], 0.0, None), st)
    jpos = jnp.asarray(st["pos"])
    jplan = st["jcad"].plan

    @jax.jit
    def ref(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda a, b, c: JD.ring_global_sim(
            a, b, c, jpos, jplan, st["jcad"], st["segs"]), q_, k_, v_)
        return out, vjp(g_)
    want, want_g = ref(*(jnp.asarray(st[n]) for n in ("q", "k", "v", "g")))
    np.testing.assert_allclose(to_numpy(ring), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_numpy(ring), to_numpy(full), **TOL)
    for a, b, c in zip(ring_g, want_g, full_g):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **GRAD_TOL)
        np.testing.assert_allclose(to_numpy(a), to_numpy(c), **GRAD_TOL)
