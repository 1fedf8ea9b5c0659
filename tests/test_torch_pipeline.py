"""Pipeline parallelism with CAD across stages: the port's
``repro_torch.pipeline_par`` against the reference's
``repro.pipeline_par`` (paper §4.1, Figure 8), in a gloo group of 4 CPU
processes spawned once for the module, one process a stage.

Geometries are ``tests/test_pipeline.py``'s: PIPE_SCRIPT's 4 stages of
smollm-360m-reduced (4 layers, 6 microbatches of [1, 64], the ``xla``
route) and CAD_PP_SCRIPT's weightless CA layer (4 stages, 5 microbatches
of 512 tokens, blk 64, 2 heads of 32, seed 0, tolerance 0.05).  The
gradient case runs the slice's main path: smollm-360m-reduced under
``cad`` with one plan a tick, remat on, 4 microbatches of [1, 256]
``prolong`` documents of at most 128 tokens.  The reference runs in this process (its
functions, not its ``shard_map``).

Held: ``tick_schedules`` exactly the reference's (plans and stats) with
tick 0 moving tasks onto idle stages; ``split_stages`` the reference's
slices after conversion, and the error on a depth that does not split;
the pipelined forward within the reference's own 2e-4 of its
``M.forward`` per microbatch and bitwise equal to the port's unpipelined
forward; the CA layer through ``_rank_fn`` per tick within 2e-4 of
``ref_attention`` applied once a stage, and bitwise equal to the
one-process tick simulation, forward and backward; the pipelined loss's
parameter gradients within 1e-5 x max |grad| of ``jax.grad`` of the
reference's unpipelined loss, and bitwise equal to the tick
simulation's; the outputs replicated bitwise on every rank."""
import dataclasses
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

from repro.configs import get_config as jax_config
from repro.core import CADConfig as JCfg
from repro.core import CommModel as JComm
from repro.core import ref_attention as j_ref_attention
from repro.models import model as JM
from repro.parallel import ParallelContext as JCtx
from repro.pipeline_par import split_stages as j_split_stages
from repro.pipeline_par import tick_schedules as j_tick_schedules
from repro.train.loss import lm_loss as j_lm_loss
from repro_torch.configs import get_config
from repro_torch.core import dispatch as D
from repro_torch.core.cost_model import CommModel
from repro_torch.core.plan import CADConfig
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import ParallelContext
from repro_torch.pipeline_par import split_stages, tick_schedules
from repro_torch.pipeline_par.pipeline import (_lockstep_tick_fn,
                                               _tick_sim)
from repro_torch.train.loss import lm_loss
from test_torch_helpers import (load_jax_params, params_to_numpy, to_numpy,
                                to_torch)

ROOT = Path(__file__).resolve().parents[1]
N_STAGES = 4
# CAD_PP_SCRIPT's geometry
CA_MICRO, CA_BLK, CA_S, CA_H, CA_DH = 5, 64, 512, 2, 32
CA_TOL = 0.05
# PIPE_SCRIPT's
ARCH, N_LAYERS = "smollm-360m", 4
FWD_MICRO, FWD_S = 6, 64
REF_ATOL = 2e-4               # the reference's own bound (test_pipeline.py)
# the gradient case: the main path's route on small documents
GRAD_MICRO, GRAD_S, GRAD_BLK = 4, 256, 64
GRAD_DOC = 128                # documents of 1-2 blocks: tick 0 moves tasks
GRAD_REL = 1e-5               # x max |grad| of the tensor
# the loss is computed on this rank alone: not the last stage, so the
# gradient reaches the last stage through the replication's backward
LOSS_RANK = 0

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, tmp):
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.core.plan import CADConfig
    from repro_torch.launch import mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.pipeline_par import (model_stage_fn, pipeline_apply,
                                          split_stages,
                                          sum_grads_over_stages)
    from repro_torch.train.loss import lm_loss
    info = mesh.join_group("cpu", rank=rank, world=4,
                           init_method="file://" + os.path.join(tmp, "store"),
                           timeout_s=120)
    group = info.group
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    spec = json.load(open(os.path.join(tmp, "spec.json")))
    t = {k: torch.from_numpy(v.copy()) for k, v in inp.items()}
    res = {}
    n = spec["n_stages"]

    cfg = get_config(spec["arch"])
    import dataclasses
    cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(tmp, "params.pt")))
    stage = split_stages(model.layers, n, cfg.period)[rank]

    def logits_of(h):
        return model._unembed(L.norm_apply(model.final_norm, h, cfg.norm))

    # (c) the forward on the xla route, no plan
    ctx = ParallelContext(attn_impl="xla", remat=False, group=group)
    with torch.no_grad():
        h_mb = torch.stack([model._embed(x) for x in t["c_tokens"]])
        outs = pipeline_apply(h_mb, model_stage_fn(
            model, stage, ctx, t["c_segs"], t["c_poss"]), n_stages=n,
            group=group)
        res["c_logits"] = torch.stack([logits_of(h) for h in outs]).numpy()

    # (d) the weightless CA layer through _rank_fn, one plan a tick
    cad = D.CADContext(cfg=CADConfig(**spec["ca_geo"]),
                       jmax=spec["ca_geo"]["nb"])
    plans = {k[len("d_plan_"):]: v for k, v in t.items()
             if k.startswith("d_plan_")}
    pos = torch.where(t["d_segs"] > 0, t["d_poss"], -1)[:, None, :]

    def ca_stage(h, m, tick_plan):
        return D._rank_fn(h, h, h, pos[m], D._plan_row(tick_plan, rank,
                                                       "cpu"),
                          cad, 0.0, None, group)
    x = t["d_x"].clone().requires_grad_()
    out = pipeline_apply(x, ca_stage, n_stages=n, group=group, plans=plans)
    g = t["d_g"] if rank == spec["loss_rank"] else torch.zeros_like(out)
    torch.autograd.backward(out, g)
    res["d_out"], res["d_dx"] = out.detach().numpy(), x.grad.numpy()

    # (e) the main path: cad, one plan a tick, remat; the loss on one
    # rank alone
    cad = D.CADContext(cfg=CADConfig(**spec["e_geo"]),
                       jmax=spec["e_geo"]["nb"])
    ctx = ParallelContext(attn_impl="cad", cad=cad, remat=True, group=group)
    plans = {k[len("e_plan_"):]: v for k, v in t.items()
             if k.startswith("e_plan_")}
    h_mb = torch.stack([model._embed(x) for x in t["e_tokens"]])
    outs = pipeline_apply(h_mb, model_stage_fn(
        model, stage, ctx, t["e_segs"], t["e_poss"]), n_stages=n,
        group=group, plans=plans)
    g = torch.zeros_like(outs)
    if rank == spec["loss_rank"]:
        h = outs.detach().requires_grad_()
        loss = sum(lm_loss(logits_of(h[m]), t["e_labels"][m],
                           t["e_segs"][m])[0] for m in range(h.shape[0]))
        loss.backward()
        g = h.grad
        res["e_loss"] = loss.detach().numpy()
    torch.autograd.backward(outs, g)
    shared = [p for name, p in model.named_parameters()
              if not name.startswith("layers.")]
    sum_grads_over_stages(shared, group)
    first = rank * len(stage)
    own = {f"layers.{first + i}.": blk for i, blk in enumerate(stage)}
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            if any(name.startswith(k) for k in own):
                res["e_grad_" + name] = p.grad.numpy()
            elif p.grad is not None:
                raise SystemExit(f"rank {rank}: {name} of another stage "
                                 f"has a gradient")
        else:
            res["e_grad_" + name] = p.grad.numpy()
    res["e_outs"] = outs.detach().numpy()
    try:
        pipeline_apply(h_mb, lambda h, m, p: h, n_stages=2, group=group)
        res["refused"] = np.array(0)
    except ValueError:
        res["refused"] = np.array(1)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    dist.barrier()
    mesh.leave_group()


if __name__ == "__main__":
    # the group meets in a file store under the test's directory: no port
    mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
'''


def _layout(rng, rows, s, blk, max_blocks):
    """CAD_PP_SCRIPT's packing: documents of 1..max_blocks blocks, ids
    unique over the rows."""
    segs = np.zeros((rows, s), np.int32)
    poss = np.zeros((rows, s), np.int32)
    sid = 1
    for r in range(rows):
        t = 0
        while t < s:
            dl = min(int(rng.integers(1, max_blocks + 1)) * blk, s - t)
            segs[r, t:t + dl] = sid
            poss[r, t:t + dl] = np.arange(dl)
            sid += 1
            t += dl
    return segs, poss


def _geo(tokens, blk):
    nb = tokens // blk
    return dict(n_servers=N_STAGES, blk=blk, nb=nb, cq=nb, ckv=2 * nb,
                nkv=4 * nb)


def _ca_case():
    """CAD_PP_SCRIPT's inputs, with a seeded cotangent."""
    segs, poss = _layout(np.random.default_rng(0), CA_MICRO, CA_S, CA_BLK, 4)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((CA_MICRO, 1, CA_S, CA_H, CA_DH)) \
        .astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return dict(segs=segs, poss=poss, x=x, g=g, geo=_geo(CA_S, CA_BLK))


def _configs():
    cfg_j = dataclasses.replace(jax_config(ARCH).reduced(), n_layers=N_LAYERS)
    cfg_t = dataclasses.replace(get_config(ARCH).reduced(),
                                n_layers=N_LAYERS)
    return cfg_j, cfg_t


def _fwd_case(cfg):
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (FWD_MICRO, 1, FWD_S)) \
        .astype(np.int32)
    segs = np.ones_like(toks)
    poss = np.broadcast_to(np.arange(FWD_S, dtype=np.int32),
                           toks.shape).copy()
    return dict(tokens=toks, segs=segs, poss=poss)


def _grad_case(cfg):
    pipe = PipelineConfig(distribution="prolong", max_doc_len=GRAD_DOC,
                          seq_len=GRAD_S, global_batch=GRAD_MICRO,
                          vocab_size=cfg.vocab_size, seed=0)
    b = next(raw_batches(pipe))
    return {"tokens": b["tokens"][:, None], "labels": b["labels"][:, None],
            "segs": b["segment_ids"][:, None],
            "poss": b["positions"][:, None], "geo": _geo(GRAD_S, GRAD_BLK)}


def _plans(segs_mb, geo, heads):
    hq, dh, hkv = heads
    return tick_schedules(segs_mb, N_STAGES, CADConfig(**geo),
                          CommModel(hq, dh, hkv), tolerance=CA_TOL)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The reference's params, the cases, and every rank's results from
    one spawn of the 4-rank gloo group."""
    tmp = tmp_path_factory.mktemp("pipeline")
    cfg_j, cfg_t = _configs()
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    torch.save(params_from_jax(params_to_numpy(params), cfg_t),
               tmp / "params.pt")
    ca, fwd, grad = _ca_case(), _fwd_case(cfg_t), _grad_case(cfg_t)
    ca["plans"], ca["stats"] = _plans(ca["segs"], ca["geo"],
                                      (CA_H, CA_DH, CA_H))
    grad["plans"], grad["stats"] = _plans(
        grad["segs"][:, 0], grad["geo"],
        (cfg_t.n_heads, cfg_t.head_dim, cfg_t.n_kv_heads))
    arrays = {"c_" + k: v for k, v in fwd.items()}
    arrays.update({"d_" + k: ca[k] for k in ("segs", "poss", "x", "g")})
    arrays.update({"d_plan_" + k: v for k, v in ca["plans"].items()})
    arrays.update({"e_" + k: grad[k] for k in ("tokens", "labels", "segs",
                                                "poss")})
    arrays.update({"e_plan_" + k: v for k, v in grad["plans"].items()})
    np.savez(tmp / "inputs.npz", **arrays)
    (tmp / "spec.json").write_text(json.dumps(
        {"n_stages": N_STAGES, "arch": ARCH + "-reduced",
         "loss_rank": LOSS_RANK,
         "n_layers": N_LAYERS, "ca_geo": ca["geo"], "e_geo": grad["geo"]}))
    (tmp / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(tmp / "worker.py"), str(tmp)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp))
    assert proc.returncode == 0, proc.stderr[-4000:]
    per_rank = []
    for r in range(N_STAGES):
        with np.load(tmp / f"rank{r}.npz") as z:
            per_rank.append(dict(z))
    return dict(params=params, cfg_j=cfg_j, cfg_t=cfg_t, ca=ca, fwd=fwd,
                grad=grad, ranks=per_rank)


# ----------------------------------------------------------------- (a), (b)
def test_tick_schedules_equal_the_reference():
    """Plans and stats exactly the reference's at CAD_PP_SCRIPT's
    geometry; at warm-up tick 0 only stage 0 is active and the scheduler
    moves its tasks onto the idle stages."""
    ca = _ca_case()
    plans, stats = _plans(ca["segs"], ca["geo"], (CA_H, CA_DH, CA_H))
    want, want_stats = j_tick_schedules(
        ca["segs"], N_STAGES, JCfg(**ca["geo"]), JComm(CA_H, CA_DH, CA_H),
        tolerance=CA_TOL)
    assert sorted(plans) == sorted(want)
    for k in want:
        assert plans[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(plans[k], want[k], err_msg=k)
    assert len(stats) == len(want_stats) == CA_MICRO + N_STAGES - 1
    for got, ref in zip(stats, want_stats):
        assert sorted(got) == sorted(ref)
        assert got["tick"] == ref["tick"] and got["moves"] == ref["moves"]
        assert got["comm_bytes"] == ref["comm_bytes"]
        np.testing.assert_array_equal(got["loads"], ref["loads"])
    assert stats[0]["moves"] > 0, "idle stages were not used as servers"


def test_warmup_and_drain_stages_serve_other_stages_tasks():
    """In every warm-up and drain tick each stage has load after
    scheduling: the idle ones serve the busy ones' CA-tasks."""
    ca = _ca_case()
    _, stats = _plans(ca["segs"], ca["geo"], (CA_H, CA_DH, CA_H))
    for st in stats[:N_STAGES - 1] + stats[CA_MICRO:]:
        assert (st["loads"] > 0).all(), st


def test_split_stages_equals_the_reference_after_conversion():
    """Stage s's converted layers hold the reference's
    ``split_stages(params['blocks'], n)[s]``, for a two-slot pattern
    (gemma2-2b's local, global) at 8 layers: one group a stage."""
    cfg_j = dataclasses.replace(jax_config("gemma2-2b").reduced(),
                                n_layers=8)
    cfg_t = dataclasses.replace(get_config("gemma2-2b").reduced(),
                                n_layers=8)
    params = JM.init(jax.random.PRNGKey(3), cfg_j)
    model = load_jax_params(cfg_t, params)
    ref = j_split_stages(params["blocks"], N_STAGES)
    stages = split_stages(model.layers, N_STAGES, cfg_t.period)
    assert len(stages) == N_STAGES
    per = cfg_t.n_groups // N_STAGES
    for s, stage in enumerate(stages):
        assert len(stage) == per * cfg_t.period
        for si, slot in enumerate(ref):
            for path, leaf in jax.tree_util.tree_flatten_with_path(slot)[0]:
                name = ".".join(str(p.key) for p in path)
                for g in range(per):
                    got = stage[g * cfg_t.period + si].state_dict()[name]
                    np.testing.assert_array_equal(
                        to_numpy(got), np.asarray(leaf[s, g]),
                        err_msg=f"stage {s} slot {si} group {g} {name}")
        assert stage[0] is model.layers[s * per * cfg_t.period]


def test_split_stages_raises_where_the_depth_does_not_split():
    cfg_j = jax_config("gemma2-2b").reduced()           # 2 layers, period 2
    cfg_t = get_config("gemma2-2b").reduced()
    params = JM.init(jax.random.PRNGKey(3), cfg_j)
    with pytest.raises(AssertionError):
        j_split_stages(params["blocks"], N_STAGES)
    model = load_jax_params(cfg_t, params)
    with pytest.raises(ValueError, match="do not split"):
        split_stages(model.layers, N_STAGES, cfg_t.period)
    # 4 layers over 4 stages split, but not as whole 2-layer periods
    with pytest.raises(ValueError, match="do not split"):
        split_stages(list(range(4)), N_STAGES, 2)
    layers = torch.nn.ModuleList(torch.nn.Linear(1, 1) for _ in range(8))
    assert [[list(layers).index(x) for x in st]
            for st in split_stages(layers, N_STAGES, 2)] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]


# --------------------------------------------------------------------- (c)
def test_pipelined_forward_matches_reference(pipeline):
    """Each microbatch's logits within the reference's 2e-4 of its
    ``M.forward`` (PIPE_SCRIPT's bound and geometry), on every rank."""
    fwd, cfg_j = pipeline["fwd"], pipeline["cfg_j"]
    ctx = JCtx(attn_impl="xla", remat=False)
    run = jax.jit(lambda p, b: JM.forward(p, cfg_j, b, ctx)[0])
    want = np.stack([np.asarray(run(pipeline["params"], dict(
        tokens=jnp.asarray(fwd["tokens"][m]),
        segment_ids=jnp.asarray(fwd["segs"][m]),
        positions=jnp.asarray(fwd["poss"][m]))))
        for m in range(FWD_MICRO)])
    for arr in pipeline["ranks"]:
        assert float(np.abs(arr["c_logits"] - want).max()) < REF_ATOL


def test_pipelined_forward_bitwise_equals_unpipelined(pipeline):
    """The port's ``Transformer.forward`` on each microbatch alone (the
    same shapes a stage's matmuls get) gives the pipeline's logits bit for
    bit, on every rank."""
    fwd = pipeline["fwd"]
    model = load_jax_params(pipeline["cfg_t"], pipeline["params"])
    ctx = ParallelContext(attn_impl="xla", remat=False)
    with torch.no_grad():
        want = torch.stack([model({
            "tokens": to_torch(fwd["tokens"][m]),
            "segment_ids": to_torch(fwd["segs"][m]),
            "positions": to_torch(fwd["poss"][m])}, ctx)[0]
            for m in range(FWD_MICRO)]).numpy()
    for arr in pipeline["ranks"]:
        assert arr["c_logits"].tobytes() == want.tobytes()


# --------------------------------------------------------------------- (d)
def _ca_sim(ca):
    """The weightless CA pipeline in one process: ``_tick_sim`` with
    every tick's exchange through ``_global_sim``; its output and the
    gradient of its input under the seeded cotangent."""
    cad = D.CADContext(cfg=CADConfig(**ca["geo"]), jmax=ca["geo"]["nb"])
    pos = torch.where(to_torch(ca["segs"]) > 0, to_torch(ca["poss"]), -1)

    def tick_fn(hs, ms, tick_plan):
        q = torch.cat(hs)
        p = torch.cat([pos[m][None] for m in ms])
        out = D._global_sim(q, q, q, p, D._plan_tensors(tick_plan, "cpu"),
                            cad, 0.0, None)
        return list(out.split(1))
    x = to_torch(ca["x"]).requires_grad_()
    out = _tick_sim(x, tick_fn, n_stages=N_STAGES, plans=ca["plans"])
    out.backward(to_torch(ca["g"]))
    return to_numpy(out), to_numpy(x.grad)


def test_ca_per_tick_matches_reference_attention(pipeline):
    """CAD_PP_SCRIPT's check: each microbatch's output is the weightless
    CA layer applied once a stage (``ref_attention`` four times), within
    2e-4, on every rank."""
    ca = pipeline["ca"]
    seg, pos = jnp.asarray(ca["segs"]), jnp.asarray(ca["poss"])
    run = jax.jit(lambda x, s, p: j_ref_attention(x, x, x, s, p, s, p))
    for m in range(CA_MICRO):
        exp = jnp.asarray(ca["x"][m])
        for _ in range(N_STAGES):
            exp = run(exp, seg[m][None], pos[m][None])
        for arr in pipeline["ranks"]:
            err = float(np.abs(arr["d_out"][m] - np.asarray(exp)).max())
            assert err < REF_ATOL, (m, err)


def test_ca_per_tick_bitwise_equals_tick_simulation(pipeline):
    """The group's outputs and input gradients (the mirrored backward:
    the reverse shift and each tick's exchanges transposed) bitwise equal
    to the one-process tick simulation's on the same plans."""
    out, dx = _ca_sim(pipeline["ca"])
    for arr in pipeline["ranks"]:
        assert arr["d_out"].tobytes() == out.tobytes()
    # only stage 0 reads the inputs; the gradient reaches it alone
    assert pipeline["ranks"][0]["d_dx"].tobytes() == dx.tobytes()
    for arr in pipeline["ranks"][1:]:
        assert not arr["d_dx"].any()


# --------------------------------------------------------------------- (e)
def _grad_names(per_rank):
    return sorted(k for k in per_rank[0] if k.startswith("e_grad_")
                  and not k.startswith("e_grad_layers."))


def _gathered_grads(per_rank):
    """Each parameter's gradient from the rank that owns it (rank 0 for
    the shared ones, summed over the stages on every rank)."""
    out = {}
    for arr in per_rank:
        out.update({k[len("e_grad_"):]: v for k, v in arr.items()
                    if k.startswith("e_grad_layers.")})
    out.update({k[len("e_grad_"):]: per_rank[0][k]
                for k in _grad_names(per_rank)})
    return out


def test_pipelined_gradients_match_reference(pipeline):
    """Every parameter's gradient of the pipelined loss (summed over the
    microbatches, computed once, on rank LOSS_RANK) within 1e-5 x max |grad|
    of ``jax.grad`` of the reference's unpipelined loss; the loss too."""
    grad, cfg_j, cfg_t = pipeline["grad"], pipeline["cfg_j"], pipeline[
        "cfg_t"]
    ctx = JCtx(attn_impl="xla", remat=False)

    def loss_fn(p):
        return sum(j_lm_loss(JM.forward(p, cfg_j, dict(
            tokens=jnp.asarray(grad["tokens"][m]),
            segment_ids=jnp.asarray(grad["segs"][m]),
            positions=jnp.asarray(grad["poss"][m])), ctx)[0],
            jnp.asarray(grad["labels"][m]),
            jnp.asarray(grad["segs"][m]))[0] for m in range(GRAD_MICRO))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(pipeline["params"])
    want = {k: to_numpy(v) for k, v in params_from_jax(
        params_to_numpy(grads), cfg_t).items()}
    got = _gathered_grads(pipeline["ranks"])
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (name, err)
    np.testing.assert_allclose(pipeline["ranks"][LOSS_RANK]["e_loss"],
                               float(loss), rtol=1e-6)


def test_pipelined_gradients_bitwise_equal_tick_simulation(pipeline):
    """The group's outputs and every gradient bitwise equal to the
    one-process tick simulation's (``_tick_sim`` with the lockstep layers,
    each tick's exchange through ``_global_sim``) on the same plans and
    weights; the shared parameters' sums equal on every rank.  The loss
    rank is stage 0, which also embeds: its tied embedding takes the
    unembedding's gradient first, then the embedding's, as the
    simulation's two passes add them (one autograd pass through both
    would interleave the eight microbatch terms: 1.5e-8 apart)."""
    from repro_torch.models import layers as L
    grad, cfg_t, per_rank = pipeline["grad"], pipeline["cfg_t"], \
        pipeline["ranks"]
    model = load_jax_params(cfg_t, pipeline["params"])
    cad = D.CADContext(cfg=CADConfig(**grad["geo"]), jmax=grad["geo"]["nb"])
    ctx = ParallelContext(attn_impl="cad", cad=cad, remat=False)
    segs, poss = to_torch(grad["segs"]), to_torch(grad["poss"])
    stages = split_stages(model.layers, N_STAGES, cfg_t.period)
    h_mb = torch.stack([model._embed(to_torch(x)) for x in grad["tokens"]])
    outs = _tick_sim(h_mb, _lockstep_tick_fn(model, stages, ctx, segs, poss),
                     n_stages=N_STAGES, plans=grad["plans"])
    h = outs.detach().requires_grad_()
    loss = sum(lm_loss(model._unembed(L.norm_apply(
        model.final_norm, h[m], cfg_t.norm)), to_torch(grad["labels"][m]),
        segs[m])[0] for m in range(GRAD_MICRO))
    loss.backward()
    outs.backward(h.grad)
    for arr in per_rank:
        assert arr["e_outs"].tobytes() == to_numpy(outs).tobytes()
    assert per_rank[LOSS_RANK]["e_loss"].tobytes() == \
        to_numpy(loss).tobytes()
    got = _gathered_grads(per_rank)
    for name, p in model.named_parameters():
        assert got[name].tobytes() == to_numpy(p.grad).tobytes(), name
    for name in _grad_names(per_rank):
        for arr in per_rank[1:]:
            assert arr[name].tobytes() == per_rank[0][name].tobytes(), name


def test_tick_plans_of_the_gradient_case_move_tasks(pipeline):
    """The gradient case's plans are CAD plans at work: tick 0 offloads
    stage 0's tasks onto the idle stages."""
    assert pipeline["grad"]["stats"][0]["moves"] > 0


def test_pipeline_refuses_a_group_of_another_size(pipeline):
    """A stage group of 4 ranks refuses a pipeline of 2 stages."""
    for arr in pipeline["ranks"]:
        assert arr["refused"] == 1
