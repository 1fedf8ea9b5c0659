"""CAD across ranks: the port's dispatch over a ``torch.distributed``
group (``core.dispatch._rank_fn``, ping-pong on asynchronous exchanges),
the session's per-rank plans and the data-parallel training step, in a
gloo group of 4 CPU processes spawned once for the module.

The geometry is the reference's ``SHARD_MAP_SCRIPT``
(``tests/test_cad.py:244-292``: S 512, blk 64, Hq 4, Hkv 2, dh 32, f32)
at D = 4 ranks where the reference forces 8 XLA host devices: four
processes are what a gloo group on a shared CPU affords.  Ping-pong takes
``test_pingpong_equivalence``'s construction (``tests/test_cad.py:198``:
2 rows per rank of 4 blocks, documents of 1-3 blocks, seed 11) at the
same D = 4.

Held: the group's outputs and dq bitwise equal to the port's
``_global_sim``, dk/dv bitwise too (every kv block's gradient sums its
sends in the order ``_global_sim`` sums them); all within 2e-5 (outputs)
and 1e-5 x max |grad| (gradients) of the reference's ``ref_attention``,
its ``_global_sim``-path ``cad_attention`` and ``jax.vjp`` of it.  Two
training steps of smollm-360m-reduced at 4 ranks: losses within 1e-5
relative of the single-process trainer at ``n_ranks=4`` (each rank sums
its own rows' loss and gradients, then the ranks sum theirs: another
order), parameters bitwise equal across the ranks after each step.  Two
ping-pong steps of qwen2-moe-reduced at 4 ranks: the lm loss, the
global MoE aux losses and the parameters within 1e-5 relative of the
single-process trainer's; at capacity factor 1.0 each rank's
``moe_apply`` is the reference's on its own tokens, and the ranks' aux
shares sum to the reference's global losses.  Expert parallelism
under the group (capacity factor 1.0): each rank computes its quarter of
the experts, routing is global, and the outputs, aux losses and
gradients (through both exchanges) are the reference's over all tokens.
A rank fed other segment ids makes the plan-agreement check raise, and
a group of another size raises.
Calibration, fault schedules and streaming plans under a group are
``tests/test_torch_rank_runtime.py``'s.  The ping-pong call's
issue order is recorded on every rank: both nano-batches' ten sends go
out asynchronously before nano-batch 0 is waited on and served."""
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro.core.attention import ref_attention as j_ref_attention
from repro.core.plan import CADConfig as JCfg
from repro.parallel import ParallelContext as JCtx
from repro_torch.cad import CADSession
from repro_torch.configs import get_config
from repro_torch.core import dispatch as D
from repro_torch.core.cost_model import CommModel
from repro_torch.core.plan import CADConfig, StepPlan, plan_from_schedule
from repro_torch.core.scheduler import schedule
from repro_torch.data.pipeline import (PipelineConfig, global_token_count,
                                       rank_rows)
from repro_torch.launch import mesh
from repro_torch.parallel import ParallelContext
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import to_numpy, to_torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
S, BLK, HQ, HKV, DH = 512, 64, 4, 2, 32
PP_S = 4 * BLK             # ping-pong: tokens a row, 2 rows a rank
OUT_TOL = dict(atol=2e-5, rtol=0)
GRAD_REL = 1e-5            # x max |grad|
LOSS_RTOL = 1e-5
TRAIN = dict(arch="smollm-360m-reduced", steps=2, seq=256, batch=4)
# MoE under the group: 2 rows a rank for ping-pong's two nano-batches; the
# reduced capacity factor (8) drops nothing, so each rank's local routing
# is the single process's global one
MOE = dict(arch="qwen2-moe-a2.7b-reduced", steps=2, seq=256, batch=8)
MOE_KEYS = ("loss", "moe_lb", "moe_z", "total_loss")
MOE_RTOL = 1e-5

WORKER = r'''
import hashlib, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _digest(model):
    h = hashlib.sha1()
    for p in model.parameters():
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return type(e).__name__ + ": " + str(e)
    return None


def _cad(cfg, plan, ctx_group, pingpong=False):
    from repro_torch.core import dispatch as D
    from repro_torch.parallel import ParallelContext
    cad = D.CADContext(cfg=cfg, plan=plan, jmax=cfg.nkv, pingpong=pingpong)
    return ParallelContext(attn_impl="cad", cad=cad, group=ctx_group)


def _attention(rank, inp, prefix, cfg, plan, group, pingpong):
    from repro_torch.core import dispatch as D
    rows = inp[prefix + "q"].shape[0] // 4
    sl = slice(rank * rows, (rank + 1) * rows)
    q, k, v = (torch.from_numpy(inp[prefix + n][sl].copy())
               .requires_grad_() for n in "qkv")
    seg = torch.from_numpy(inp[prefix + "segs"][sl].copy())
    pos = torch.from_numpy(inp[prefix + "poss"][sl].copy())
    g = torch.from_numpy(inp[prefix + "g"][sl].copy())
    out = D.cad_attention(q, k, v, seg, pos, seg, pos,
                          ctx=_cad(cfg, plan, group, pingpong))
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    return {prefix + "out": out.detach().numpy(), prefix + "dq": dq.numpy(),
            prefix + "dk": dk.numpy(), prefix + "dv": dv.numpy()}


def _issue_order(rank, inp, cfg, plan, group):
    """Call (b) again, recording in order every all_to_all (with its
    async_op), every wait on an asynchronous one, and every serve."""
    from repro_torch.core import dispatch as D
    events = []
    a2a, serve = dist.all_to_all_single, D._serve

    class Work:
        def __init__(self, work, i):
            self.work, self.i = work, i

        def wait(self):
            events.append(["wait", self.i])
            return self.work.wait()

    def rec_a2a(*args, async_op=False, **kw):
        i = sum(e[0] == "a2a" for e in events)
        events.append(["a2a", i, async_op])
        work = a2a(*args, async_op=async_op, **kw)
        return Work(work, i) if async_op else work

    def rec_serve(*args, **kw):
        events.append(["serve"])
        return serve(*args, **kw)
    dist.all_to_all_single, D._serve = rec_a2a, rec_serve
    try:
        _attention(rank, inp, "b_", cfg, plan, group, True)
    finally:
        dist.all_to_all_single, D._serve = a2a, serve
    return events


def worker(rank, tmp):
    torch.set_num_threads(1)
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.core.plan import CADConfig, PingPongPlan, StepPlan
    from repro_torch.data.pipeline import PipelineConfig, raw_batches
    from repro_torch.launch import mesh
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import TrainConfig, train
    info = mesh.join_group("cpu", rank=rank, world=4,
                           init_method="file://" + os.path.join(tmp, "store"),
                           timeout_s=120)
    group = info.group
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    spec = json.load(open(os.path.join(tmp, "spec.json")))

    def plan_of(prefix):
        return StepPlan.from_dict({k[len(prefix):]: inp[k] for k in inp
                                   if k.startswith(prefix)}).to("cpu")

    res, meta = {}, {"rank": rank, "device": str(info.device), "tmp": tmp}
    cfg = CADConfig(**spec["geo"])
    res.update(_attention(rank, inp, "a_", cfg, plan_of("plan_"), group,
                          False))
    pp_cfg = CADConfig(**spec["pp_geo"])
    pp_plan = PingPongPlan(plan_of("pp0_"), plan_of("pp1_"))
    res.update(_attention(rank, inp, "b_", pp_cfg, pp_plan, group, True))
    meta["issue_order"] = _issue_order(rank, inp, pp_cfg, pp_plan, group)

    # (d) two training steps; every rank hashes its parameters after each
    t = spec["train"]
    mcfg = get_config(t["arch"])
    pipe = PipelineConfig(distribution="prolong", max_doc_len=t["seq"],
                          seq_len=t["seq"], global_batch=t["batch"],
                          n_ranks=4, vocab_size=mcfg.vocab_size, seed=0)
    model = Transformer(mcfg, device="cpu", seed=0)
    digests = []
    out = train(mcfg, pipe, TrainConfig(steps=t["steps"], peak_lr=1e-3,
                                        warmup=1, log_every=1, seed=0),
                model=model, device="cpu",
                session=CADSession.for_pipeline(mcfg, pipe, group=group),
                on_step=lambda s, m: digests.append(_digest(model)))
    meta["losses"] = [h["loss"] for h in out["history"]]
    meta["n_tokens"] = [h["n_tokens"] for h in out["history"]]
    meta["param_digests"] = digests

    # (e) MoE: two CAD steps of qwen2-moe-reduced under ping-pong (its
    # aux losses' all-reduce runs inside each layer, again in the
    # recompute); rank 0 keeps the trained parameters
    import dataclasses
    from repro_torch.models.layers import moe_apply
    m = spec["moe"]
    moe_cfg = get_config(m["arch"])
    moe_pipe = PipelineConfig(distribution="prolong", max_doc_len=m["seq"],
                              seq_len=m["seq"], global_batch=m["batch"],
                              n_ranks=4, vocab_size=moe_cfg.vocab_size,
                              seed=0)
    moe_model = Transformer(moe_cfg, device="cpu", seed=0)
    out = train(moe_cfg, moe_pipe, TrainConfig(steps=m["steps"],
                                               peak_lr=1e-3, warmup=1,
                                               log_every=1, seed=0),
                model=moe_model, device="cpu",
                session=CADSession.for_pipeline(moe_cfg, moe_pipe,
                                                group=group, pingpong=True))
    meta["moe_history"] = [{k: h[k] for k in spec["moe_keys"]}
                           for h in out["history"]]
    if rank == 0:
        np.savez(os.path.join(tmp, "moe_params.npz"),
                 **{n: p.detach().numpy()
                    for n, p in moe_model.named_parameters()})
    # moe_apply at capacity factor 1.0 on this rank's rows of moe_h
    drop_cfg = dataclasses.replace(moe_cfg, moe=dataclasses.replace(
        moe_cfg.moe, capacity_factor=1.0))
    pm = {k[len("moe_p_"):]: torch.from_numpy(v.copy())
          for k, v in inp.items() if k.startswith("moe_p_")}
    rows = inp["moe_h"].shape[0] // 4
    hm = torch.from_numpy(inp["moe_h"][rank * rows:(rank + 1) * rows]
                          .copy())
    mo, aux = moe_apply(pm, hm, drop_cfg, group=group)
    res["moe_out"] = mo.numpy()
    res.update({k: v.numpy() for k, v in aux.items()})
    # expert parallelism at capacity factor 1.0: this rank computes its
    # experts' slots of the global routing; its gradients (the experts'
    # rows of this rank, its tokens' router and shared-expert terms) are
    # summed over the group as the train step sums them
    ep_cfg = dataclasses.replace(drop_cfg, moe=dataclasses.replace(
        drop_cfg.moe, expert_parallel=True))
    pg = {k: v.clone().requires_grad_() for k, v in pm.items()}
    hg = hm.clone().requires_grad_()
    mo, aux = moe_apply(pg, hg, ep_cfg, group=group)
    res["ep_out"] = mo.detach().numpy()
    res.update({"ep_" + k: v.detach().numpy() for k, v in aux.items()})
    ct = torch.from_numpy(inp["moe_g"][rank * rows:(rank + 1) * rows]
                          .copy())
    names = sorted(pg)
    grads = torch.autograd.grad(mo, [hg] + [pg[k] for k in names], ct)
    res["ep_dh"] = grads[0].numpy()
    for k, g in zip(names, grads[1:]):
        dist.all_reduce(g, group=group)
        res["ep_d_" + k] = g.numpy()

    # (f) the plan-agreement control: rank 3 reads other segment ids (its
    # first row's document cut in two halves)
    sess = CADSession.for_pipeline(mcfg, pipe, group=group, prefetch=0)
    b0 = next(raw_batches(pipe))
    mine = dict(b0)
    if rank == 3:
        segs = np.array(b0["segment_ids"], copy=True)
        segs[0, segs.shape[1] // 2:] = segs.max() + 1
        mine["segment_ids"] = segs
    meta["disagree"] = _raises(
        lambda: list(sess.attach_plans(iter([mine]))), RuntimeError)
    meta["agree"] = _raises(
        lambda: list(sess.attach_plans(iter([b0]))), RuntimeError)

    # what the rank path refuses
    small = D.CADContext(cfg=CADConfig(**dict(spec["geo"], n_servers=2)),
                         plan=plan_of("plan_"), jmax=cfg.nkv)
    from repro_torch.parallel import ParallelContext
    x = torch.zeros(1, 512, 4, 32)
    s = torch.ones(1, 512, dtype=torch.int32)
    p = torch.arange(512, dtype=torch.int32)[None]
    meta["refusals"] = {
        "group size != n_servers": _raises(lambda: D.cad_attention(
            x, x[:, :, :2], x[:, :, :2], s, p, s, p,
            ctx=ParallelContext(attn_impl="cad", cad=small, group=group)),
            ValueError),
        "pipeline ranks != group": _raises(
            lambda: CADSession.for_pipeline(
                mcfg, PipelineConfig(global_batch=4, n_ranks=2,
                                     seq_len=256, max_doc_len=256),
                group=group), ValueError),
    }
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    mesh.leave_group()


if __name__ == "__main__":
    # the group meets in a file store under the test's directory: no port
    mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
'''


def _layout(rng, rows, s, max_blocks):
    segs = np.zeros((rows, s), np.int32)
    poss = np.zeros((rows, s), np.int32)
    sid = 1
    for r in range(rows):
        t = 0
        while t < s:
            dl = min(int(rng.integers(1, max_blocks + 1)) * BLK, s - t)
            segs[r, t:t + dl] = sid
            poss[r, t:t + dl] = np.arange(dl)
            sid += 1
            t += dl
    return segs, poss


def _geo(tokens):
    nb = tokens // BLK
    return dict(n_servers=WORLD, blk=BLK, nb=nb, cq=nb, ckv=2 * nb,
                nkv=4 * nb)


def _plan(geo, segs):
    cfg = CADConfig(**geo)
    sch = schedule(segs, blk=BLK, n_servers=WORLD,
                   comm=CommModel(HQ, DH, HKV), caps=cfg.caps(),
                   tolerance=0.05)
    return plan_from_schedule(cfg, sch)


def _qkv(seed, rows, s):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((rows, s, h, DH)).astype(np.float32)
                 for h in (HQ, HKV, HKV, HQ))       # q, k, v, g


def _cases():
    """Inputs of (a) the SHARD_MAP_SCRIPT geometry at D = 4 and (b) the
    ping-pong construction, with their plans."""
    segs, poss = _layout(np.random.default_rng(0), WORLD, S, 5)
    geo = _geo(S)
    a = dict(segs=segs, poss=poss, geo=geo, plan=_plan(geo, segs),
             **dict(zip("qkvg", _qkv(0, WORLD, S))))
    rpr = 2
    pp_segs, pp_poss = _layout(np.random.default_rng(11), WORLD * rpr,
                               PP_S, 3)
    pp_geo = _geo((rpr // 2) * PP_S)
    plans = tuple(_plan(pp_geo, np.stack([pp_segs[r * rpr + i]
                                          for r in range(WORLD)]))
                  for i in range(2))
    b = dict(segs=pp_segs, poss=pp_poss, geo=pp_geo, plan=plans,
             **dict(zip("qkvg", _qkv(4, WORLD * rpr, PP_S))))
    return {"plain": a, "pingpong": b}


def _moe_inputs():
    """The MoE weights (the reference's init) and 4 x 64 tokens of input
    for the per-rank ``moe_apply`` case (4 rows: one a rank)."""
    from repro.configs import get_config as jax_config
    from repro.models import layers as JL
    cfg = jax_config(MOE["arch"])
    p = JL.moe_init(jax.random.PRNGKey(5), cfg)
    h = np.random.default_rng(5).standard_normal(
        (WORLD, 64, cfg.d_model)).astype(np.float32)
    return {k: np.array(v) for k, v in p.items()}, h


def _moe_cotangent():
    """A seeded cotangent of the MoE output (the expert-parallel case)."""
    cfg = get_config(MOE["arch"])
    return np.random.default_rng(6).standard_normal(
        (WORLD, 64, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4-rank gloo group once; return the cases and every
    rank's results."""
    tmp = tmp_path_factory.mktemp("ranks")
    cases = _cases()
    a, b = cases["plain"], cases["pingpong"]
    arrays = {}
    for prefix, c in (("a_", a), ("b_", b)):
        for n in ("q", "k", "v", "g", "segs", "poss"):
            arrays[prefix + n] = c[n]
    arrays.update({"plan_" + k: np.asarray(v) for k, v in a["plan"].items()})
    for i, p in enumerate(b["plan"]):
        arrays.update({f"pp{i}_" + k: np.asarray(v) for k, v in p.items()})
    arrays.update({"moe_p_" + k: v for k, v in _moe_inputs()[0].items()})
    arrays["moe_h"] = _moe_inputs()[1]
    arrays["moe_g"] = _moe_cotangent()
    np.savez(tmp / "inputs.npz", **arrays)
    (tmp / "spec.json").write_text(json.dumps(
        {"geo": a["geo"], "pp_geo": b["geo"], "train": TRAIN, "moe": MOE,
         "moe_keys": MOE_KEYS}))
    (tmp / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(tmp / "worker.py"), str(tmp)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp))
    assert proc.returncode == 0, proc.stderr[-4000:]
    per_rank = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as z:
            arr = dict(z)
        per_rank.append((arr, json.loads((tmp / f"rank{r}.json")
                                         .read_text())))
    return cases, per_rank


def _gathered(per_rank, prefix, name):
    return np.concatenate([arr[prefix + name] for arr, _ in per_rank])


def _prefix(case):
    return "a_" if case == "plain" else "b_"


def _port_sim(case, c):
    """The port's single-process ``cad_attention`` (``_global_sim``) on the
    same inputs, and its q/k/v gradients."""
    cfg = CADConfig(**c["geo"])
    if case == "plain":
        plan = StepPlan.from_dict(c["plan"].to_dict()).to("cpu")
    else:
        plan = tuple(StepPlan.from_dict(p.to_dict()).to("cpu")
                     for p in c["plan"])
    ctx = ParallelContext(attn_impl="cad", cad=D.CADContext(
        cfg=cfg, plan=plan, jmax=cfg.nkv, pingpong=case == "pingpong"))
    q, k, v = (to_torch(c[n]).requires_grad_() for n in "qkv")
    seg, pos = to_torch(c["segs"]), to_torch(c["poss"])
    out = D.cad_attention(q, k, v, seg, pos, seg, pos, ctx=ctx)
    grads = torch.autograd.grad(out, (q, k, v), to_torch(c["g"]))
    return [to_numpy(out)] + [to_numpy(x) for x in grads]


def _reference(case, c):
    """The reference's ``cad_attention`` (its single-device path with the
    ``xla`` server) and ``ref_attention``, with ``jax.vjp`` of the
    former."""
    seg, pos = jnp.asarray(c["segs"]), jnp.asarray(c["poss"])
    if case == "plain":
        plan = jax.tree.map(jnp.asarray, c["plan"].to_dict())
    else:
        plan = tuple(jax.tree.map(jnp.asarray, p.to_dict())
                     for p in c["plan"])
    jcad = JD.CADContext(cfg=JCfg(**c["geo"]), kernel="xla",
                         jmax=c["geo"]["nkv"], plan=plan,
                         pingpong=case == "pingpong")
    jctx = JCtx(mesh=None, attn_impl="cad", cad=jcad)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda a, b, d: JD.cad_attention(
            a, b, d, seg, pos, seg, pos, ctx=jctx), q, k, v)
        return out, vjp(g), j_ref_attention(q, k, v, seg, pos, seg, pos)
    out, grads, ref = run(*(jnp.asarray(c[n]) for n in "qkvg"))
    return np.asarray(out), [np.asarray(x) for x in grads], np.asarray(ref)


CASES = ["plain", "pingpong"]


@pytest.fixture(scope="module")
def oracles(ranks):
    """Per case: the port's ``_global_sim`` (out, dq, dk, dv) and the
    reference's (out, grads, ref_attention), computed once."""
    cases, _ = ranks
    return {c: (_port_sim(c, cases[c]), _reference(c, cases[c]))
            for c in CASES}


@pytest.mark.parametrize("case", CASES)
def test_group_output_bitwise_equals_global_sim(ranks, oracles, case):
    _, per_rank = ranks
    out = oracles[case][0][0]
    got = _gathered(per_rank, _prefix(case), "out")
    assert got.tobytes() == out.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_group_output_matches_reference(ranks, oracles, case):
    _, per_rank = ranks
    want, _, ref = oracles[case][1]
    got = _gathered(per_rank, _prefix(case), "out")
    np.testing.assert_allclose(got, want, **OUT_TOL)
    np.testing.assert_allclose(got, ref, **OUT_TOL)


@pytest.mark.parametrize("case", CASES)
def test_group_grads_bitwise_equal_global_sim(ranks, oracles, case):
    """dq, dk and dv of the group bitwise equal to ``_global_sim``'s: the
    exchange's backward moves the gradient the way the transpose does,
    and each kv block sums its sends in the same order."""
    _, per_rank = ranks
    _, *grads = oracles[case][0]
    for name, want in zip(("dq", "dk", "dv"), grads):
        got = _gathered(per_rank, _prefix(case), name)
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("case", CASES)
def test_group_grads_match_reference_vjp(ranks, oracles, case):
    _, per_rank = ranks
    _, want, _ = oracles[case][1]
    for name, w in zip(("dq", "dk", "dv"), want):
        got = _gathered(per_rank, _prefix(case), name)
        assert np.max(np.abs(got - w)) <= GRAD_REL * np.max(np.abs(w)), name


def test_training_losses_match_single_process(ranks):
    """Two steps at 4 ranks against the single-process trainer at
    ``n_ranks=4`` on the same seed and batches."""
    _, per_rank = ranks
    cfg = get_config(TRAIN["arch"])
    pipe = PipelineConfig(distribution="prolong", max_doc_len=TRAIN["seq"],
                          seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
                          n_ranks=WORLD, vocab_size=cfg.vocab_size, seed=0)
    res = train(cfg, pipe, TrainConfig(steps=TRAIN["steps"], peak_lr=1e-3,
                                       warmup=1, log_every=1, seed=0),
                session=CADSession.for_pipeline(cfg, pipe), device="cpu")
    want = [h["loss"] for h in res["history"]]
    for _, meta in per_rank:
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL,
                                   atol=0)
        assert meta["n_tokens"] == [h["n_tokens"] for h in res["history"]]


def test_parameters_bitwise_equal_across_ranks(ranks):
    _, per_rank = ranks
    digests = [meta["param_digests"] for _, meta in per_rank]
    assert len(digests[0]) == TRAIN["steps"]
    assert all(d == digests[0] for d in digests)
    assert len(set(digests[0])) == TRAIN["steps"]     # the steps moved them


def test_plan_disagreement_raises_on_every_rank(ranks):
    """The control: rank 3 reads other segment ids, and every rank's
    plan-agreement check raises; on the same batch none does."""
    _, per_rank = ranks
    for _, meta in per_rank:
        assert meta["disagree"] is not None
        assert "disagree on the step's plan" in meta["disagree"]
        assert meta["agree"] is None


@pytest.mark.parametrize("what", [
    "group size != n_servers", "pipeline ranks != group"])
def test_what_the_rank_path_refuses(ranks, what):
    _, per_rank = ranks
    for _, meta in per_rank:
        msg = meta["refusals"][what]
        assert msg is not None, what


def _pingpong_forward_order():
    """The forward's issue order ``_pingpong_ranks`` promises: nano-batch
    0's five sends and then 1's, all asynchronous; wait on 0's, serve 0,
    start 0's return; wait on 1's, serve 1, start 1's return; wait on the
    returns."""
    sends = [["a2a", i, True] for i in range(10)]
    return (sends + [["wait", i] for i in range(5)] + [["serve"]]
            + [["a2a", 10, True]] + [["wait", i] for i in range(5, 10)]
            + [["serve"], ["a2a", 11, True], ["wait", 10], ["wait", 11]])


def test_pingpong_issue_order(ranks):
    """Nano-batch 1's exchange is issued (asynchronously) before nano-batch
    0 is waited on and served; the backward's 8 exchanges (3 sends and a
    return a nano-batch: positions carry no gradient) are synchronous."""
    _, per_rank = ranks
    fwd = _pingpong_forward_order()
    for _, meta in per_rank:
        order = meta["issue_order"]
        assert order[:len(fwd)] == fwd
        bwd = order[len(fwd):]
        assert [e[0] for e in bwd] == ["a2a"] * 8
        assert not any(e[2] for e in bwd)


def test_moe_training_matches_single_process(ranks):
    """Two CAD steps of qwen2-moe-reduced at 4 ranks under ping-pong
    against the single-process trainer on the same seed and batches: the
    lm loss, both aux losses (global values: each rank's share summed by
    the all-reduce) within 1e-5 relative, and each parameter tensor within
    1e-5 relative in norm; every rank reports the same numbers."""
    _, per_rank = ranks
    cfg = get_config(MOE["arch"])
    pipe = PipelineConfig(distribution="prolong", max_doc_len=MOE["seq"],
                          seq_len=MOE["seq"], global_batch=MOE["batch"],
                          n_ranks=WORLD, vocab_size=cfg.vocab_size, seed=0)
    res = train(cfg, pipe, TrainConfig(steps=MOE["steps"], peak_lr=1e-3,
                                       warmup=1, log_every=1, seed=0),
                session=CADSession.for_pipeline(cfg, pipe, pingpong=True),
                device="cpu")
    for key in MOE_KEYS:
        want = [h[key] for h in res["history"]]
        for _, meta in per_rank:
            got = [h[key] for h in meta["moe_history"]]
            np.testing.assert_allclose(got, want, rtol=MOE_RTOL, atol=0,
                                       err_msg=key)
    assert len({json.dumps(meta["moe_history"]) for _, meta in per_rank}) \
        == 1
    tmp = Path(per_rank[0][1]["tmp"])
    with np.load(tmp / "moe_params.npz") as z:
        got = dict(z)
    params = dict(res["model"].named_parameters())
    assert sorted(got) == sorted(params)
    # parameters: relative in norm, tensor by tensor.  Elementwise, AdamW
    # amplifies the last bits of a gradient where its two steps' terms
    # nearly cancel in the first moment (a few elements a tensor)
    for name, p in params.items():
        want = to_numpy(p)
        err = np.linalg.norm(got[name] - want) / np.linalg.norm(want)
        assert err <= MOE_RTOL, (name, err)


def test_moe_apply_per_rank_matches_reference(ranks):
    """At capacity factor 1.0 each rank routes its own 64 tokens with its
    own capacity: its output equals the reference's ``moe_apply`` on that
    slice (f32 atol 1e-5 x max(1, max |ref|)), and the ranks' aux shares
    sum to the reference's losses over all 256 tokens (1e-6 relative)."""
    import dataclasses
    from repro.configs import get_config as jax_config
    from repro.models import layers as JL
    _, per_rank = ranks
    cfg = jax_config(MOE["arch"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    p, h = _moe_inputs()
    p = jax.tree.map(jnp.asarray, p)
    ctx = JCtx(mesh=None)
    run = jax.jit(lambda x: JL.moe_apply(p, x, cfg, ctx))
    for r, (arr, _) in enumerate(per_rank):
        want, _ = run(jnp.asarray(h[r:r + 1]))
        want = np.asarray(want)
        np.testing.assert_allclose(
            arr["moe_out"], want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    _, aux = run(jnp.asarray(h))
    for k in ("moe_lb", "moe_z"):
        shares = sum(float(arr[k]) for arr, _ in per_rank)
        np.testing.assert_allclose(shares, float(aux[k]), rtol=1e-6,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _ep_reference():
    """The reference's ``moe_apply`` with ``expert_parallel`` at capacity
    factor 1.0 on all 4 ranks' tokens at once (global routing, its
    ``n_groups = 1``), its aux losses and ``jax.vjp`` under the gathered
    cotangent."""
    import dataclasses
    from repro.configs import get_config as jax_config
    from repro.models import layers as JL
    cfg = jax_config(MOE["arch"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0, expert_parallel=True))
    p, h = _moe_inputs()
    p = jax.tree.map(jnp.asarray, p)
    ctx = JCtx(mesh=None)
    (out, aux), vjp = jax.vjp(lambda pp, x: JL.moe_apply(pp, x, cfg, ctx),
                              p, jnp.asarray(h))
    dp, dh = vjp((jnp.asarray(_moe_cotangent()),
                  jax.tree.map(jnp.zeros_like, aux)))
    return np.asarray(out), aux, np.asarray(dh), dp


def test_expert_parallel_routes_globally_under_a_group(ranks):
    """Expert parallelism (maverick's layout) under the 4-rank group at
    capacity factor 1.0: each rank computes its quarter of the experts,
    routing is global (capacity from all 256 tokens, queue places in
    rank-major token order), so the ranks' outputs put together are the
    reference's over all tokens (f32 atol 1e-5 x max(1, max |ref|)) and the
    aux shares sum to its losses (1e-6 relative)."""
    _, per_rank = ranks
    want, aux, _, _ = _ep_reference()
    got = np.concatenate([arr["ep_out"] for arr, _ in per_rank])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want)
                                                          .max())))
    for k in ("moe_lb", "moe_z"):
        shares = sum(float(arr["ep_" + k]) for arr, _ in per_rank)
        np.testing.assert_allclose(shares, float(aux[k]), rtol=1e-6,
                                   err_msg=k)


def test_expert_parallel_gradients_match_reference_vjp(ranks):
    """The gradients through both exchanges: each rank's input gradient
    is its rows of ``jax.vjp``'s, and every weight gradient summed over
    the ranks is the reference's (1e-5 x max |grad|)."""
    _, per_rank = ranks
    _, _, dh, dp = _ep_reference()
    got = np.concatenate([arr["ep_dh"] for arr, _ in per_rank])
    np.testing.assert_allclose(got, dh, rtol=0,
                               atol=GRAD_REL * float(np.abs(dh).max()))
    for k, want in dp.items():
        want = np.asarray(want)
        for arr, _ in per_rank:
            np.testing.assert_allclose(
                arr["ep_d_" + k], want, rtol=0,
                atol=GRAD_REL * float(np.abs(want).max()), err_msg=k)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _RaisingDist:
    def __init__(self, err):
        self.err = err

    def all_to_all_single(self, out, inp, group=None):
        if self.err is not None:
            raise self.err
        out.copy_(inp)


@pytest.mark.parametrize("err,refused", [
    (None, False),
    (RuntimeError("ProcessGroupGloo::alltoall_base: unsupported device "
                  "type cuda"), True),
    (RuntimeError("[enforce fail at gloo/transport/tcp/pair.cc:446] "
                  "Connection reset by peer"), None),
    (RuntimeError("Timed out waiting 300000ms for send operation"), None),
])
def test_chip_smoke_gloo_probe_drops_only_the_refusal(err, refused):
    """Phase 24(b)'s probe: gloo's refusal of the device is returned (and
    drops the phase's four-rank check); any other error is raised, and
    fails the phase."""
    probe = _chip_smoke()._gloo_refusal
    fake = _RaisingDist(err)
    if refused is None:
        with pytest.raises(RuntimeError) as got:
            probe(torch, fake, None, "cpu")
        assert got.value is err
    else:
        assert (probe(torch, fake, None, "cpu") is not None) == refused


def test_rank_rows_and_global_token_count():
    rng = np.random.default_rng(3)
    labels = rng.integers(-1, 5, (8, 16)).astype(np.int32)
    segs = rng.integers(0, 3, (8, 16)).astype(np.int32)
    batch = {"tokens": np.arange(128).reshape(8, 16), "labels": labels,
             "segment_ids": segs, "positions": np.zeros((8, 16)),
             "plan": "global"}
    parts = [rank_rows(batch, r, 4) for r in range(4)]
    assert all(set(p) == {"tokens", "labels", "segment_ids", "positions"}
               for p in parts)
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), batch["tokens"])
    assert global_token_count(batch) == int(((labels >= 0)
                                             & (segs > 0)).sum())
    assert global_token_count({"labels": -np.ones((2, 2)),
                               "segment_ids": np.ones((2, 2))}) == 1
    with pytest.raises(ValueError, match="split"):
        rank_rows(batch, 0, 3)


def test_join_group_defaults(monkeypatch):
    assert mesh.default_backend("cuda") == "nccl"
    assert mesh.default_backend("cpu") == "gloo"
    monkeypatch.delenv("RANK", raising=False)
    assert not mesh.launched_by_torchrun()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.launched_by_torchrun()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.join_group("cuda")


def test_plan_digest_tells_plans_apart():
    from repro_torch.cad.session import plan_digest
    c = _cases()["plain"]
    p = c["plan"]
    assert plan_digest(p) == plan_digest(StepPlan.from_dict(p.to_dict()))
    other = {k: np.array(v) for k, v in p.items()}
    other["task_kv_len"] = other["task_kv_len"].copy()
    other["task_kv_len"][0, 0] += 1
    assert plan_digest(StepPlan.from_dict(other)) != plan_digest(p)


def test_torchrun_launcher_on_cpu(tmp_path, capsys, monkeypatch):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --cad
    --device cpu``: both ranks train, rank 0 prints, the losses equal the
    single-process launcher's printed ones."""
    from repro_torch.launch import train as launch
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    args = ["--arch", TRAIN["arch"], "--steps", "2", "--seq", "256",
            "--batch", "4", "--ranks", "2", "--cad", "--device", "cpu"]
    multi = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert multi.returncode == 0, multi.stderr[-3000:]
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    launch.main(args)

    def steps(text):
        return [ln for ln in text.splitlines() if ln.startswith("step")]
    got, want = steps(multi.stdout), steps(capsys.readouterr().out)
    assert len(got) == 2 and "ranks=2" in multi.stdout
    assert [ln.split("(")[0] for ln in got] \
        == [ln.split("(")[0] for ln in want]


def test_torchrun_launcher_calibrates_under_a_fault_schedule_on_cpu(
        tmp_path, capsys, monkeypatch):
    """``torchrun --nproc-per-node 2 ... --calibrate --calibrate-every 1
    --fault-schedule kill:1@1``: both ranks train, rank 0 alone prints the
    pool line and the step lines, as the single-process launcher prints
    them under the same schedule.  Each run's plans from step 1 on come
    from its own probe timings, so the losses are compared within one unit
    of their last printed digit, not as text: a plan moves tasks, not
    arithmetic, but the rows' sums take another order."""
    from repro_torch.launch import train as launch
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    args = ["--arch", TRAIN["arch"], "--steps", "3", "--seq", "256",
            "--batch", "4", "--ranks", "2", "--cad", "--device", "cpu",
            "--calibrate", "--calibrate-every", "1", "--fault-schedule",
            "kill:1@1"]
    multi = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert multi.returncode == 0, multi.stderr[-3000:]
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    launch.main(args)
    single = capsys.readouterr().out

    def lines(text, word):
        return [ln for ln in text.splitlines()
                if ln.startswith("step") and word in ln]

    def losses(text):
        return [float(ln.split("loss ")[1].split()[0])
                for ln in lines(text, " loss ")]
    assert lines(multi.stdout, "pool:") == ["step     1 pool: kill 1 "
                                            "(epoch 1)"]
    assert lines(multi.stdout, "pool:") == lines(single, "pool:")
    assert len(lines(multi.stdout, " loss ")) == 3
    np.testing.assert_allclose(losses(multi.stdout), losses(single),
                               atol=1e-4, rtol=0)
