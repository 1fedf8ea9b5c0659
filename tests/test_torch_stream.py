"""The port's decomposed dispatch and chunked KV streaming
(``repro_torch.core.dispatch``: ``build_server_inputs``,
``serve_task_batch``, ``stream_task_batch``, ``assemble_step_outputs``,
``merge_recovered``) and CAD under mask-structured plans.

Inside the port, bitwise: streamed == unstreamed for every chunk size and
mask family, through ``cfg.stream_chunk`` and the explicit call; the
decomposed serve + assemble == ``_global_sim``; a dropped server re-served
and merged == the fault-free output.  Against the reference (its
``serve_task_batch`` with the blockwise ``xla`` server and its
``cad_attention``), on the same plans and numpy inputs: f32 atol 1e-5
(outputs), 1e-5 / rtol 1e-4 (gradients), as ``test_torch_dispatch.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cad import get_planner as j_get_planner
from repro.core import dispatch as JD
from repro.core.cost_model import CommModel as JComm
from repro.core.mask import MaskSpec as JMask
from repro.core.plan import CADConfig as JCfg
from repro.parallel import ParallelContext as JCtx
from repro_torch.core import dispatch as D
from repro_torch.core.mask import MaskSpec
from repro_torch.core.plan import CADConfig, StepPlan
from repro_torch.kernels.packed_flash import ops
from repro_torch.parallel import ParallelContext
from test_torch_helpers import to_numpy, to_torch

BLK = 16
COMM = JComm(n_heads=2, head_dim=16, n_kv_heads=2)
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
MASKS = {"causal": None,
         "sliding24": ("sliding", dict(window=24)),
         "sliding16+sink16": ("sliding", dict(window=16, sink=16)),
         "dilated2": ("dilated", dict(rate=2))}
CHUNKS = (1, 2, 3, 5, 8)


def _masks(name):
    """(reference MaskSpec, port MaskSpec) of a MASKS entry."""
    if MASKS[name] is None:
        return None, None
    kind, kw = MASKS[name]
    return JMask(kind=kind, **kw), MaskSpec(kind=kind, **kw)


def _segs_one_long_doc(n_ranks=2, nb=4):
    """Rank 0: one document over every block; ranks 1+: one 1-block
    document (the reference's streaming layout)."""
    segs = np.zeros((n_ranks, nb * BLK), np.int32)
    segs[0, :] = 1
    for r in range(1, n_ranks):
        segs[r, :BLK] = 10 * r + 1
    return segs


def _stream_setup(mask_name, seed):
    """A balanced plan of the streaming layout and seeded f32 q/k/v, for
    the reference and the port."""
    jmask, tmask = _masks(mask_name)
    segs = _segs_one_long_doc()
    jcfg = JCfg.default(2, 4 * BLK, blk=BLK)
    kw = {} if jmask is None else {"mask": jmask}
    res = j_get_planner("balanced")(jcfg, segs, comm=COMM, tolerance=0.05,
                                    **kw)
    d, s_len = segs.shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((d, s_len, 2, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.where(segs > 0, np.arange(s_len)[None, :], -1).astype(np.int32)
    cfg = CADConfig(**dataclasses.asdict(jcfg))
    plan = StepPlan.from_dict(res.plan.to_dict())
    return dict(jcfg=jcfg, jplan=res.plan, jmask=jmask, cfg=cfg, plan=plan,
                mask=tmask, q=q, k=k, v=v, pos=pos, d=d)


def _port_inputs(st, cad):
    return D.build_server_inputs(cad, st["plan"], *(to_torch(st[n]) for n in
                                                    ("q", "k", "v", "pos")))


def _bits(x):
    return to_numpy(x).tobytes()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_stream_serve_bitwise_equal(mask_name, chunk):
    """Streaming splits the online-softmax walk into ranges with the
    carry threaded through: streamed (through ``serve_task_batch``'s
    ``stream_chunk`` and the explicit call) == unstreamed, bitwise, for
    every chunk size (ragged last chunks included) and mask family."""
    st = _stream_setup(mask_name, seed=1)
    cad = D.CADContext(cfg=st["cfg"], mask=st["mask"])
    assert cad.cfg.nkv > max(CHUNKS)          # every chunk size streams
    inputs, plans_r = _port_inputs(st, cad)
    for s in range(st["d"]):
        plain = D.serve_task_batch(cad, inputs[s], plans_r[s])
        streamed = D.serve_task_batch(cad, inputs[s], plans_r[s],
                                      stream_chunk=chunk)
        explicit = D.stream_task_batch(cad, inputs[s], plans_r[s],
                                       chunk_blocks=chunk)
        assert _bits(plain) == _bits(streamed) == _bits(explicit), \
            f"server {s} chunk {chunk} mask {mask_name}"


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_serve_task_batch_matches_reference(mask_name):
    """Each server's serve, streamed and not, against the reference's
    ``serve_task_batch`` with the blockwise server on the same plan."""
    st = _stream_setup(mask_name, seed=2)
    jcad = JD.CADContext(cfg=st["jcfg"], kernel="xla", mask=st["jmask"])
    jin, jplans = JD.build_server_inputs(
        jcad, st["jplan"], *(jnp.asarray(st[n]) for n in ("q", "k", "v",
                                                         "pos")))
    cad = D.CADContext(cfg=st["cfg"], mask=st["mask"])
    inputs, plans_r = _port_inputs(st, cad)
    for s in range(st["d"]):
        want = np.asarray(JD.serve_task_batch(jcad, jin[s], jplans[s]))
        for chunk in (None, 3):
            got = D.serve_task_batch(cad, inputs[s], plans_r[s],
                                     stream_chunk=chunk)
            np.testing.assert_allclose(to_numpy(got), want, **OUT_TOL)


def test_stream_via_config_and_explicit_call():
    """``cfg.stream_chunk`` turns streaming on for every caller of
    ``serve_task_batch``; ``stream_task_batch`` is the explicit entry;
    both assemble to the unstreamed step output bitwise.  A chunk of 0
    raises."""
    st = _stream_setup("causal", seed=3)
    cfg_s = dataclasses.replace(st["cfg"], stream_chunk=3)
    cad0 = D.CADContext(cfg=st["cfg"])
    cad1 = D.CADContext(cfg=cfg_s)
    inputs, plans_r = _port_inputs(st, cad0)
    outs = [{s: fn(s) for s in range(st["d"])} for fn in (
        lambda s: D.serve_task_batch(cad0, inputs[s], plans_r[s]),
        lambda s: D.serve_task_batch(cad1, inputs[s], plans_r[s]),
        lambda s: D.stream_task_batch(cad0, inputs[s], plans_r[s],
                                      chunk_blocks=3))]
    q = to_torch(st["q"])
    a, b, c = (D.assemble_step_outputs(cfg, st["plan"], o, q.shape, q.dtype)
               for cfg, o in zip((st["cfg"], cfg_s, st["cfg"]), outs))
    assert _bits(a) == _bits(b) == _bits(c)
    with pytest.raises(ValueError, match="chunk"):
        D.stream_task_batch(cad0, inputs[0], plans_r[0], chunk_blocks=0)


def test_streamed_forward_refuses_inputs_that_require_grad():
    """The streamed path is forward only: it raises rather than cut the
    graph."""
    st = _stream_setup("causal", seed=4)
    cad = D.CADContext(cfg=st["cfg"])
    q, k, v = (to_torch(st[n]).requires_grad_() for n in "qkv")
    inputs, plans_r = D.build_server_inputs(cad, st["plan"], q, k, v,
                                            to_torch(st["pos"]))
    with pytest.raises(ValueError, match="forward only"):
        D.stream_task_batch(cad, inputs[0], plans_r[0], chunk_blocks=2)
    with torch.no_grad():
        D.stream_task_batch(cad, inputs[0], plans_r[0], chunk_blocks=2)


def test_range_forward_pieces_equal_the_whole():
    """``ca_server_fwd_range`` on the CPU: ranges [0, 2), [2, 5), [5,
    jmax) with the carry threaded == one range == the plain forward,
    bitwise (out and lse)."""
    st = _stream_setup("sliding16+sink16", seed=5)
    cad = D.CADContext(cfg=st["cfg"], mask=st["mask"])
    inputs, plans_r = _port_inputs(st, cad)
    kw = D._server_kwargs(cad, inputs[0], plans_r[0])
    whole = ops.ca_server_fwd_reference(**kw)
    one = ops.ca_server_fwd_range(**kw, j0=0, j1=kw["jmax"])
    carry = ops.ca_server_fwd_range(**kw, j0=0, j1=2, finalize=False)
    carry = ops.ca_server_fwd_range(**kw, j0=2, j1=5, carry=carry,
                                    finalize=False)
    parts = ops.ca_server_fwd_range(**kw, j0=5, j1=kw["jmax"] + 3,
                                    carry=carry)
    for got in (one, parts):
        assert all(_bits(a) == _bits(b) for a, b in zip(got, whole))


# ------------------------------------------------ the decomposed dispatch
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


def _dispatch_setup(policy, seed, d=4, nb=6, hq=4, hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    segs, poss = random_layout(rng, d, nb * BLK)
    geo = dict(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb, nkv=4 * nb)
    jcfg = JCfg(**geo)
    res = j_get_planner(policy)(jcfg, segs, comm=JComm(hq, dh, hkv),
                                tolerance=0.05)
    q = rng.standard_normal((d, nb * BLK, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((d, nb * BLK, hkv, dh)).astype(np.float32)
            for _ in range(2))
    posm = np.where(segs > 0, poss, -1).astype(np.int32)
    return dict(jcfg=jcfg, jplan=res.plan, cfg=CADConfig(**geo),
                plan=StepPlan.from_dict(res.plan.to_dict()), q=q, k=k, v=v,
                pos=posm, d=d)


def _decomposed(cad, plan, q, k, v, pos, drop=()):
    inputs, plans_r = D.build_server_inputs(cad, plan, q, k, v, pos)
    outs = {s: D.serve_task_batch(cad, inputs[s], plans_r[s])
            for s in range(cad.cfg.n_servers) if s not in drop}
    return D.assemble_step_outputs(cad.cfg, plan, outs, q.shape, q.dtype)


@pytest.mark.parametrize("policy", ["identity", "balanced"])
def test_decomposed_dispatch_bitwise_equals_global_sim(policy):
    """build_server_inputs -> serve_task_batch -> assemble_step_outputs ==
    ``_global_sim`` bitwise (same kernels' plain versions on the same
    batches, the same scatter), and within f32 tolerance of the
    reference's decomposed dispatch."""
    st = _dispatch_setup(policy, seed=7)
    cad = D.CADContext(cfg=st["cfg"], jmax=4)
    q, k, v, pos = (to_torch(st[n]) for n in ("q", "k", "v", "pos"))
    got = _decomposed(cad, st["plan"], q, k, v, pos)
    sim = D._global_sim(q, k, v, pos, st["plan"].to("cpu"), cad, 0.0, None)
    assert _bits(got) == _bits(sim)

    jcad = JD.CADContext(cfg=st["jcfg"], kernel="xla", jmax=4)
    jq, jk, jv, jpos = (jnp.asarray(st[n]) for n in ("q", "k", "v", "pos"))
    jin, jplans = JD.build_server_inputs(jcad, st["jplan"], jq, jk, jv, jpos)
    jouts = {s: JD.serve_task_batch(jcad, jin[s], jplans[s])
             for s in range(st["d"])}
    want = JD.assemble_step_outputs(st["jcfg"], st["jplan"], jouts,
                                    jq.shape, jq.dtype)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **OUT_TOL)


def _blocks_of_server(cfg, plan, server):
    """[D, NB] boolean: the q blocks whose task runs on ``server``."""
    plan_np = D._plan_numpy(plan)
    lost = np.zeros(cfg.n_servers * cfg.nb, bool)
    for slot in range(plan_np["task_kv_len"].shape[1]):
        g = D._plan_task_q_block(cfg, plan_np, server, slot)
        if g is not None:
            lost[g] = True
    return lost.reshape(cfg.n_servers, cfg.nb)


@pytest.mark.parametrize("server", [0, 2])
def test_merge_recovered_is_bitwise(server):
    """Drop one server's serve (its blocks come out zero), re-serve that
    server alone, and merge its blocks in: bitwise the fault-free
    output."""
    st = _dispatch_setup("balanced", seed=8)
    cad = D.CADContext(cfg=st["cfg"], jmax=4)
    q, k, v, pos = (to_torch(st[n]) for n in ("q", "k", "v", "pos"))
    full = _decomposed(cad, st["plan"], q, k, v, pos)
    base = _decomposed(cad, st["plan"], q, k, v, pos, drop=(server,))
    others = tuple(s for s in range(st["d"]) if s != server)
    recovered = _decomposed(cad, st["plan"], q, k, v, pos, drop=others)
    lost = _blocks_of_server(st["cfg"], st["plan"], server)
    assert lost.any() and not torch.equal(base, full)
    merged = D.merge_recovered(st["cfg"], base, recovered, lost)
    assert _bits(merged) == _bits(full)
    merged_flat = D.merge_recovered(st["cfg"], base, recovered,
                                    lost.reshape(-1))
    assert _bits(merged_flat) == _bits(full)


# ------------------------------------------------------- masked CAD plans
def _masked_setup(policy, mask_name, seed, d=2, nb=6, hq=4, hkv=2, dh=32):
    """The reference's ``_cad_setup``: a block-aligned random layout (some
    gaps, ragged last blocks) planned with the mask."""
    rng = np.random.default_rng(seed)
    segs = np.zeros((d, nb * BLK), np.int32)
    poss = np.zeros((d, nb * BLK), np.int32)
    sid = 1
    for r in range(d):
        t = 0
        while t < nb:
            if rng.random() < 0.15:
                t += 1
                continue
            dbl = int(rng.integers(1, min(4, nb - t) + 1))
            tokens = dbl * BLK
            if rng.random() < 0.3:
                tokens -= int(rng.integers(0, BLK))
            segs[r, t * BLK:t * BLK + tokens] = sid
            poss[r, t * BLK:t * BLK + tokens] = np.arange(tokens)
            sid += 1
            t += dbl
    jmask, tmask = _masks(mask_name)
    geo = dict(n_servers=d, blk=BLK, nb=nb, cq=nb, ckv=2 * nb, nkv=4 * nb)
    res = j_get_planner(policy)(JCfg(**geo), segs, comm=JComm(hq, dh, hkv),
                                tolerance=0.1, mask=jmask)
    q = rng.standard_normal((d, nb * BLK, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((d, nb * BLK, hkv, dh)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    return dict(geo=geo, jplan=res.plan, jmask=jmask, mask=tmask, segs=segs,
                poss=poss, q=q, k=k, v=v, g=g)


@pytest.mark.parametrize("mask_name", ["sliding24", "sliding16+sink16",
                                       "dilated2"])
@pytest.mark.parametrize("policy", ["identity", "balanced"])
def test_cad_masked_matches_reference(policy, mask_name):
    """CAD through a mask-structured plan (q/kv routing, live-block splits)
    against the reference's ``cad_attention``: output and q/k/v
    gradients."""
    st = _masked_setup(policy, mask_name, seed=3)
    geo, segs, poss = st["geo"], st["segs"], st["poss"]
    jcad = JD.CADContext(cfg=JCfg(**geo), plan=jax.tree.map(
        jnp.asarray, st["jplan"]), kernel="xla", jmax=geo["nkv"],
        mask=st["jmask"])
    jctx = JCtx(mesh=None, attn_impl="cad", cad=jcad)
    seg_j, pos_j = jnp.asarray(segs), jnp.asarray(poss)

    @jax.jit
    def ref(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda a, b, c: JD.cad_attention(
            a, b, c, seg_j, pos_j, seg_j, pos_j, ctx=jctx,
            mask=st["jmask"]), q_, k_, v_)
        return out, vjp(g_)
    want, want_g = ref(*(jnp.asarray(st[n]) for n in ("q", "k", "v", "g")))

    plan = StepPlan.from_dict(st["jplan"].to_dict()).to("cpu")
    ctx = ParallelContext(attn_impl="cad", cad=D.CADContext(
        cfg=CADConfig(**geo), plan=plan, jmax=geo["nkv"], mask=st["mask"]))
    seg_t, pos_t = to_torch(segs), to_torch(poss)
    q, k, v = (to_torch(st[n]).requires_grad_() for n in "qkv")
    got = D.cad_attention(q, k, v, seg_t, pos_t, seg_t, pos_t, ctx=ctx,
                          mask=st["mask"])
    got_g = torch.autograd.grad(got, (q, k, v), to_torch(st["g"]))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **OUT_TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **GRAD_TOL)
