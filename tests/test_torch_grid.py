"""The port on a ``("data", "model")`` grid of 2 x 2 gloo processes
(spawned once for the module) against the reference on its own (2, 2)
mesh of 4 fake XLA host devices (one subprocess), both from the
reference's weights.

Forward (``attn_impl="xla"``, 4 rows of 128 tokens, f32), logits within
LOGIT_TOL and aux losses within AUX_RTOL of the reference's sharded run:

* ``smollm3``: smollm-360m-reduced with 3 q heads over 1 kv head, which
  do not divide the model axis: padded to 4 heads, kv repeated to MHA
  (the reference's ``_pad_heads_for_tp``);
* ``gqa``: 4 q heads over 2 kv heads: both split, GQA local to a rank;
* ``moe_cf1``: qwen2-moe-reduced at capacity factor 1.0 without expert
  parallelism: each data rank routes its own tokens with its own
  capacity, as the reference's sharded run does (which differs from its
  unsharded run by more than 1: tokens are dropped elsewhere);
* ``moe_ep``: the same with ``expert_parallel``: experts split over the
  data ranks, routing global, equal to the unsharded run.

Training (``trainer.train`` with a grid session, ``cad``, 2 steps of 4 x
256 ``prolong`` tokens): ``smollm3`` plain and ping-pong, and ``moe_ep``.
The losses within LOSS_RTOL of the port's one-process trainer on the same
weights and batches; step 0's gradients, gathered from the ranks' shards,
within GRAD_REL x max |grad| of ``jax.grad`` of the reference's loss on
its mesh (its ``xla`` route: the dispatch is layout, not arithmetic), and
the step-0 loss within LOSS_RTOL of its; the tensors every data rank
holds bitwise equal across them after each step; every rank's plan
digest equal at each step.  Calibration, fault schedules and checkpoints
raise on the grid.  A ``torchrun --nproc-per-node 4 ... --ranks 2
--model-axis 2`` launcher run prints the one-process launcher's losses.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.cad import CADSession
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.convert import (gather_params, grid_placements,
                                        params_from_jax)
from repro_torch.models.model import Transformer
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"data": 2, "model": 2}
FWD_ROWS, FWD_S = 4, 128
FORWARD = ("smollm3", "gqa", "moe_cf1", "moe_ep")
TRAIN = {"plain": ("smollm3", False), "pingpong": ("smollm3", True),
         "ep": ("moe_ep", False)}
STEPS, SEQ, BATCH = 2, 256, 4
LOGIT_TOL = dict(atol=2e-5, rtol=0)
AUX_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5            # x max |grad| of the tensor


def variant(get, name):
    """The config ``name`` from either package's ``get_config``."""
    if name in ("smollm3", "gqa"):
        heads = (3, 1) if name == "smollm3" else (4, 2)
        return dataclasses.replace(get("smollm-360m-reduced"),
                                   n_heads=heads[0], n_kv_heads=heads[1],
                                   head_dim=64)
    c = get("qwen2-moe-a2.7b-reduced")
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=1.0, expert_parallel=name == "moe_ep"))


def forward_batch(cfg):
    """4 rows of 128 tokens, 2-3 documents a row."""
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (FWD_ROWS, FWD_S)).astype(np.int32)
    seg = np.ones((FWD_ROWS, FWD_S), np.int32)
    seg[:, 50:] = 2
    seg[1, 100:] = 3
    pos = np.zeros_like(seg)
    for r in range(FWD_ROWS):
        for s in np.unique(seg[r]):
            pos[r, seg[r] == s] = np.arange((seg[r] == s).sum())
    return dict(tokens=tok, segment_ids=seg, positions=pos)


def pipe_config(cfg):
    return PipelineConfig(distribution="prolong", max_doc_len=SEQ,
                          seq_len=SEQ, global_batch=BATCH, n_ranks=2,
                          vocab_size=cfg.vocab_size, seed=0)


def train_config():
    return TrainConfig(steps=STEPS, peak_lr=1e-3, warmup=1, log_every=1,
                       seed=0)


REF_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import get_config
from repro.models import model as M
from repro.parallel import ParallelContext, make_rules, param_pspecs
from repro.train.loss import lm_loss
from test_torch_grid import FORWARD, TRAIN, forward_batch, variant

tmp = sys.argv[1]
mesh = make_mesh((2, 2), ("data", "model"))
rows = NamedSharding(mesh, P(("data",)))
train_batch = dict(np.load(os.path.join(tmp, "train_batch.npz")))
out = {}


def placed(cfg):
    params = M.init(jax.random.PRNGKey(0), cfg)
    rules = make_rules(mesh, cfg)
    specs = param_pspecs(cfg, params, rules, mesh)
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)
    return params, ParallelContext(mesh=mesh, rules=rules, attn_impl="xla")


for name in FORWARD:
    cfg = variant(get_config, name)
    params, ctx = placed(cfg)
    batch = {k: jax.device_put(jnp.asarray(v), rows)
             for k, v in forward_batch(cfg).items()}
    logits, aux = jax.jit(lambda p, b: M.forward(p, cfg, b, ctx))(params,
                                                                 batch)
    one = ParallelContext(attn_impl="xla")
    unsharded, _ = jax.jit(lambda p, b: M.forward(p, cfg, b, one))(params,
                                                                  batch)
    out[name + "/logits"] = np.asarray(logits)
    out[name + "/unsharded"] = np.asarray(unsharded)
    for k, v in aux.items():
        out[name + "/" + k] = np.asarray(v)

for name in sorted({a for a, _ in TRAIN.values()}):
    cfg = variant(get_config, name)
    params, ctx = placed(cfg)
    batch = {k: jax.device_put(jnp.asarray(train_batch[k]), rows)
             for k in ("tokens", "labels", "segment_ids", "positions")}

    def loss_fn(p, b):
        logits, aux = M.forward(p, cfg, b, ctx)
        total = lm_loss(logits, b["labels"], b["segment_ids"])[0]
        for v in aux.values():
            total = total + v
        return total
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    out[name + "/loss"] = np.asarray(loss)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[name + "/grad" + jax.tree_util.keystr(path)] = np.asarray(g)
np.savez(os.path.join(tmp, "ref.npz"), **out)
'''

WORKER = r'''
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[2])
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _load(name, cfg, g):
    from repro_torch.models.convert import shard_model
    from repro_torch.models.model import Transformer
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(sys.argv[1],
                                                  name + ".pt")))
    shard_model(model, g.sizes, {"data": g.data_index,
                                 "model": g.model_index})
    return model


def _data_replicated(model):
    from repro_torch.parallel import sharded_over
    h = hashlib.sha1()
    for n, p in model.named_parameters():
        if "data" not in sharded_over(model.grid_placements[n]):
            h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def worker(rank, tmp):
    torch.set_num_threads(1)
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    from repro_torch.models import sharded as S
    from repro_torch.optim import adamw
    from repro_torch.parallel import ParallelContext
    from repro_torch.train import trainer
    from test_torch_grid import (FORWARD, TRAIN, forward_batch,
                                 pipe_config, train_config, variant)
    g = mesh.join_grid(2, 2, "cpu", rank=rank, world=4,
                       init_method="file://" + os.path.join(tmp, "store"),
                       timeout_s=120)
    res, meta = {}, {}
    mine = slice(2 * g.data_index, 2 * g.data_index + 2)
    for name in FORWARD:
        cfg = variant(get_config, name)
        model = _load(name, cfg, g)
        sess = CADSession.for_pipeline(cfg, pipe_config(cfg), grid=g)
        ctx = ParallelContext(attn_impl="xla", group=g.data_group,
                              model_group=g.model_group,
                              rules=sess.rules)
        batch = {k: torch.from_numpy(v[mine].copy())
                 for k, v in forward_batch(cfg).items()}
        with torch.no_grad():
            logits, aux = model(batch, ctx)
        vocab_split = sess.rules.vocab is not None
        logits = S.all_gather(logits, g.model_group,
                              dim=2 if vocab_split else 1)
        res[name + "/logits"] = S.all_gather(logits, g.data_group).numpy()
        for k, v in aux.items():
            dist.all_reduce(v)
            res[name + "/" + k] = v.numpy()

    for case, (name, pingpong) in TRAIN.items():
        cfg = variant(get_config, name)
        pipe = pipe_config(cfg)
        model = _load(name, cfg, g)
        sess = CADSession.for_pipeline(cfg, pipe, grid=g, pingpong=pingpong)
        digests, grads = [], {}
        attach = sess.attach_plans

        def recording(batches):
            for b in attach(batches):
                digests.append(b["plan_digest"])
                yield b
        object.__setattr__(sess, "attach_plans", recording)

        class Recording(adamw.AdamW):
            def update(self, gs, state, params, decay, **kw):
                if not grads:
                    grads.update({n: t.detach().clone() for (n, _), t in
                                  zip(model.named_parameters(), gs)})
                return super().update(gs, state, params, decay, **kw)
        trainer.AdamW = Recording
        params = []
        out = trainer.train(cfg, pipe, train_config(), model=model,
                            session=sess, device="cpu",
                            on_step=lambda s, m: params.append(
                                _data_replicated(model)))
        trainer.AdamW = adamw.AdamW
        meta[case] = dict(losses=[h["loss"] for h in out["history"]],
                          total=[h["total_loss"] for h in out["history"]],
                          plan_digests=digests, params=params)
        res.update({case + "/grad/" + n: t.numpy()
                    for n, t in grads.items()})

    cfg = variant(get_config, "smollm3")
    pipe = pipe_config(cfg)
    sess = CADSession.for_pipeline(cfg, pipe, grid=g)
    meta["refusals"] = {
        flag: _raises(lambda: trainer.train(
            cfg, pipe, trainer.TrainConfig(steps=1, **{flag: value}),
            session=sess, device="cpu"))
        for flag, value in (("calibrate_every", 1),
                            ("fault_schedule", "kill:1@1"),
                            ("ckpt_every", 1))}
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    mesh.leave_group()


if __name__ == "__main__":
    # the grid meets in a file store under the test's directory: no port
    mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
'''


def _port_state(name):
    cfg_j = variant(jax_config, name)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    return params_from_jax(params_to_numpy(params),
                           variant(get_config, name))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Run the 4-rank grid and the reference's mesh (at once); return
    (the reference's arrays, every rank's arrays and records, the port's
    full weights by variant)."""
    tmp = tmp_path_factory.mktemp("grid")
    states = {n: _port_state(n) for n in FORWARD}
    for name, state in states.items():
        torch.save(state, tmp / f"{name}.pt")
    batch = next(raw_batches(pipe_config(variant(get_config, "smollm3"))))
    np.savez(tmp / "train_batch.npz", **{
        k: np.asarray(batch[k])
        for k in ("tokens", "labels", "segment_ids", "positions")})
    (tmp / "ref.py").write_text(REF_SCRIPT)
    (tmp / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    tests = str(ROOT / "tests")
    procs = [subprocess.Popen([sys.executable, str(tmp / script), str(tmp),
                               tests], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(tmp))
             for script in ("ref.py", "worker.py")]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    with np.load(tmp / "ref.npz") as z:
        ref = dict(z)
    ranks = []
    for r in range(4):
        with np.load(tmp / f"rank{r}.npz") as z:
            arrays = dict(z)
        ranks.append((arrays, json.loads((tmp / f"rank{r}.json")
                                         .read_text())))
    return ref, ranks, states


@pytest.mark.parametrize("name", FORWARD)
def test_grid_forward_matches_reference_mesh(grid, name):
    ref, ranks, _ = grid
    want = ref[name + "/logits"]
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays[name + "/logits"], want,
                                   **LOGIT_TOL)
        for k in ("moe_lb", "moe_z"):
            if name + "/" + k in ref:
                np.testing.assert_allclose(arrays[name + "/" + k],
                                           ref[name + "/" + k],
                                           rtol=AUX_RTOL, err_msg=k)


@pytest.mark.parametrize("name,local", [("moe_cf1", True),
                                        ("moe_ep", False)])
def test_grid_moe_routing_local_or_global(grid, name, local):
    """At capacity factor 1.0 group-local routing drops other tokens than
    the unsharded run (the reference's sharded run differs from its
    unsharded run, and the port's follows the sharded one); expert
    parallelism routes globally, as the unsharded run."""
    ref, ranks, _ = grid
    gap = np.abs(ref[name + "/logits"] - ref[name + "/unsharded"]).max()
    assert (gap > 1.0) == local, gap
    got = ranks[0][0][name + "/logits"]
    np.testing.assert_allclose(got, ref[name + "/logits"], **LOGIT_TOL)


def _one_process(case, states):
    name, pingpong = TRAIN[case]
    cfg = variant(get_config, name)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(states[name])
    pipe = pipe_config(cfg)
    return train(cfg, pipe, train_config(), model=model,
                 session=CADSession.for_pipeline(cfg, pipe,
                                                 pingpong=pingpong),
                 device="cpu")


@pytest.mark.parametrize("case", TRAIN)
def test_grid_training_matches_one_process(grid, case):
    _, ranks, states = grid
    want = [h["loss"] for h in _one_process(case, states)["history"]]
    for _, meta in ranks:
        np.testing.assert_allclose(meta[case]["losses"], want,
                                   rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("case", TRAIN)
def test_grid_gradients_match_reference_mesh(grid, case):
    """Step 0's gradients, each rank's shards put back together, against
    ``jax.grad`` of the reference's loss (with its aux losses) on its
    (2, 2) mesh; the step-0 total loss too."""
    ref, ranks, states = grid
    name, _ = TRAIN[case]
    cfg = variant(get_config, name)
    placements = grid_placements(cfg, states[name], SIZES)
    parts = {(r // 2, r % 2): {
        n[len(case) + 6:]: torch.from_numpy(a)
        for n, a in arrays.items() if n.startswith(case + "/grad/")}
        for r, (arrays, _) in enumerate(ranks)}
    got = gather_params(parts, placements, SIZES)
    cfg_j = variant(jax_config, name)
    shapes = JM.init(jax.random.PRNGKey(0), cfg_j)
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [ref[f"{name}/grad{jax.tree_util.keystr(p)}"] for p, _ in paths])
    want = params_from_jax(tree, cfg)
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=n)
    for _, meta in ranks:
        np.testing.assert_allclose(meta[case]["total"][0],
                                   float(ref[name + "/loss"]),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", TRAIN)
def test_grid_parameters_bitwise_across_data_ranks(grid, case):
    """After each step the tensors every data rank holds (all but the
    expert-parallel experts) are bitwise equal across the data ranks of
    each model index, and differ between the model ranks (their
    shards)."""
    _, ranks, _ = grid
    params = [meta[case]["params"] for _, meta in ranks]
    assert len(params[0]) == STEPS
    assert params[0] == params[2] and params[1] == params[3]
    assert params[0] != params[1]


@pytest.mark.parametrize("case", TRAIN)
def test_grid_plan_digests_equal_on_every_rank(grid, case):
    _, ranks, _ = grid
    digests = [meta[case]["plan_digests"] for _, meta in ranks]
    assert len(digests[0]) == STEPS
    assert all(d == digests[0] for d in digests)


@pytest.mark.parametrize("flag", ["calibrate_every", "fault_schedule",
                                  "ckpt_every"])
def test_grid_refuses_what_needs_one_planner(grid, flag):
    _, ranks, _ = grid
    for _, meta in ranks:
        msg = meta["refusals"][flag]
        assert msg is not None and "ROADMAP queue 1 item 12" in msg, msg


def test_torchrun_launcher_on_a_grid(tmp_path, capsys, monkeypatch):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --ranks 2
    --model-axis 2 --cad --device cpu``: rank 0 prints the step lines of
    the one-process launcher at ``--ranks 2``, to the printed digits."""
    from repro_torch.launch import train as launch
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    args = ["--arch", "smollm-360m-reduced", "--steps", "2", "--seq", "256",
            "--batch", "4", "--ranks", "2", "--cad", "--device", "cpu"]
    multi = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *args,
         "--model-axis", "2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert multi.returncode == 0, multi.stderr[-3000:]
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    launch.main(args)

    def steps(text):
        return [ln.split("(")[0] for ln in text.splitlines()
                if ln.startswith("step")]
    got, want = steps(multi.stdout), steps(capsys.readouterr().out)
    assert len(got) == 2 and "grid=2x2" in multi.stdout
    assert got == want
