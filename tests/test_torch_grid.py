"""The port on a ``("data", "model")`` grid of 2 x 2 gloo processes
(spawned once for the module) against the reference on its own (2, 2)
mesh of 4 fake XLA host devices (one subprocess), both from the
reference's weights (every cross layer's ``xgate``, 0 at init, opened to
XGATE first).  Every tensor is stored as ``param_placements`` says, the
FSDP ``dmodel -> data`` rule included: a rank holds its shard and the
layers gather it over the data ranks where they read it.

Forward (``attn_impl="xla"``, f32), logits within LOGIT_TOL and aux
losses within AUX_RTOL of the reference's sharded run:

* ``smollm3``: smollm-360m-reduced with 3 q heads over 1 kv head, which
  do not divide the model axis: padded to 4 heads, kv repeated to MHA
  (the reference's ``_pad_heads_for_tp``);
* ``gqa``: 4 q heads over 2 kv heads: both split, GQA local to a rank;
* ``moe_cf1``: qwen2-moe-reduced at capacity factor 1.0 without expert
  parallelism: each data rank routes its own tokens with its own
  capacity, as the reference's sharded run does (which differs from its
  unsharded run by more than 1: tokens are dropped elsewhere);
* ``moe_ep``: the same with ``expert_parallel``: experts split over the
  data ranks, routing global, equal to the unsharded run;
* ``mamba2``, ``rgemma``, ``whisper``, ``vision``: mamba2-370m,
  recurrentgemma-9b, whisper-large-v3 and llama-3.2-vision-11b reduced (2
  layers, 4 rows of 256 tokens, a memory of 24 rows where the arch reads
  one): the SSD mixer whole on every model rank, the RG-LRU width split
  over it, cross-attention of each rank's query shard to the whole
  memory, the encoder's residual split along the memory.

Training (``trainer.train``, 2 steps of 4 x 256 ``prolong`` tokens):
``smollm3`` under ``cad`` plain and ping-pong, ``moe_ep``, ``rgemma``,
``whisper`` and ``vision`` under ``cad`` with a grid session, and
``mamba2`` (attention-free) on a sessionless grid (``grid=``, ``xla``).
The losses within LOSS_RTOL of the port's one-process trainer on the
same weights and batches; step 0's gradients, gathered from the ranks'
shards, within GRAD_REL x max |grad| of ``jax.grad`` of the reference's
loss on its mesh (its ``xla`` route: the dispatch is layout, not
arithmetic), and the step-0 loss within LOSS_RTOL of its; the parameters
gathered over ``"data"`` bitwise equal across the data ranks after each
step; every rank's plan digest equal at each step; each rank's tensors of
its placements' shard shapes, its parameter and AdamW moment bytes their
sums.

The runtime on the grid (``runtime``: smollm-360m-reduced, 4 steps,
``calibrate_every=1``, ``kill:1@2``, a checkpoint every 2 steps): plan
digests and calibrator states equal on all 4 ranks at every step, the
one-process trainer replaying the gathered observations under the same
schedule builds the same plans, the checkpoint loads into a one-process
``Transformer`` bitwise equal to the gathered parameters, and a restart
restores rank 0's calibration on every rank.  A ``torchrun
--nproc-per-node 4 ... --ranks 2 --model-axis 2`` launcher run prints
the one-process launcher's losses.
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
from repro_torch.cad.session import plan_digest
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.convert import (gather_params, grid_placements,
                                        params_from_jax, shard_shape)
from repro_torch.models.model import Transformer
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharded_over
from repro_torch.runtime import ServerPool
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"data": 2, "model": 2}
FWD_ROWS = 4
# tokens a row of the forward batch
FWD_S = {"smollm3": 128, "gqa": 128, "moe_cf1": 128, "moe_ep": 128,
         "mamba2": 256, "rgemma": 256, "whisper": 256, "vision": 256}
FORWARD = tuple(FWD_S)
# case -> (variant, ping-pong, a CAD session: else a sessionless grid)
TRAIN = {"plain": ("smollm3", False, True),
         "pingpong": ("smollm3", True, True),
         "ep": ("moe_ep", False, True),
         "mamba2": ("mamba2", False, False),
         "rgemma": ("rgemma", False, True),
         "whisper": ("whisper", False, True),
         "vision": ("vision", False, True)}
CAD_TRAIN = tuple(c for c, (_, _, cad) in TRAIN.items() if cad)
STEPS, SEQ, BATCH = 2, 256, 4
REDUCED = {"mamba2": "mamba2-370m-reduced",
           "rgemma": "recurrentgemma-9b-reduced",
           "whisper": "whisper-large-v3-reduced",
           "vision": "llama-3.2-vision-11b-reduced"}
XGATE = 0.5
MEM_ROWS = 24                 # the reduced configs' encoder.n_ctx
# f32.  The grid computes the reference's mesh's function in another
# order of sums (the model ranks' partial products, the data ranks'
# gradients).  mamba2's logits take the one-process tolerance of
# tests/test_torch_mamba2.py: the SSD's decays are exponentials of f32
# cumulative sums, which the two packages round apart (the port's grid
# gave its own one-process logits bitwise; the reference's own mesh sits
# 2.5e-5 from its unsharded run at max |logit| 5.1)
LOGIT_TOL = {name: dict(atol=5e-4 if name == "mamba2" else 2e-5, rtol=0)
             for name in FORWARD}
AUX_RTOL = 1e-5
LOSS_RTOL = 1e-5
# x max |grad| of the tensor; mamba2's at its one-process tests' rtol
# (tests/test_torch_mamba2.py), for the logits' reason above
GRAD_REL = {name: 1e-4 if name == "mamba2" else 1e-5 for name in FORWARD}
# the runtime case: 4 steps, a probe each, server 1 killed before step 2,
# a checkpoint after step 2
RUNTIME = dict(arch="smollm-360m-reduced", steps=4, faults="kill:1@2",
               ckpt_every=2)


def variant(get, name):
    """The config ``name`` from either package's ``get_config``."""
    if name in ("smollm3", "gqa"):
        heads = (3, 1) if name == "smollm3" else (4, 2)
        return dataclasses.replace(get("smollm-360m-reduced"),
                                   n_heads=heads[0], n_kv_heads=heads[1],
                                   head_dim=64)
    if name in REDUCED:
        return get(REDUCED[name])
    c = get("qwen2-moe-a2.7b-reduced")
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=1.0, expert_parallel=name == "moe_ep"))


def reads_memory(name):
    return name in ("whisper", "vision")


def memory_rows(rows, seed):
    """A seeded memory [rows, MEM_ROWS, 256] f32 (the reduced d_model)."""
    rng = np.random.default_rng(seed)
    return (0.02 * (rng.standard_normal((rows, 1, 256))
                    + rng.standard_normal((rows, MEM_ROWS, 256)))) \
        .astype(np.float32)


def gate_open(params):
    """The reference's param pytree with every cross layer's ``xgate`` at
    XGATE (the tree's arrays, numpy or JAX, kept as they are)."""
    blocks = tuple(
        dict(slot, attn=dict(slot["attn"],
                             xgate=slot["attn"]["xgate"] * 0 + XGATE))
        if "xgate" in slot["attn"] else slot for slot in params["blocks"])
    return dict(params, blocks=blocks)


def forward_batch(name):
    """4 rows of FWD_S[name] tokens, 2-3 documents a row; the memory
    where the arch reads one."""
    cfg_s = FWD_S[name]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, variant(get_config, name).vocab_size,
                       (FWD_ROWS, cfg_s)).astype(np.int32)
    seg = np.ones((FWD_ROWS, cfg_s), np.int32)
    seg[:, 50:] = 2
    seg[1, 100:] = 3
    pos = np.zeros_like(seg)
    for r in range(FWD_ROWS):
        for s in np.unique(seg[r]):
            pos[r, seg[r] == s] = np.arange((seg[r] == s).sum())
    out = dict(tokens=tok, segment_ids=seg, positions=pos)
    if reads_memory(name):
        out["memory"] = memory_rows(FWD_ROWS, 1)
    return out


def pipe_config(cfg):
    return PipelineConfig(distribution="prolong", max_doc_len=SEQ,
                          seq_len=SEQ, global_batch=BATCH, n_ranks=2,
                          vocab_size=cfg.vocab_size, seed=0)


def train_config(**kw):
    return TrainConfig(**dict(dict(steps=STEPS, peak_lr=1e-3, warmup=1,
                                   log_every=1, seed=0), **kw))


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
from test_torch_grid import (FORWARD, TRAIN, forward_batch, gate_open,
                             reads_memory, variant)

tmp = sys.argv[1]
mesh = make_mesh((2, 2), ("data", "model"))
rows = NamedSharding(mesh, P(("data",)))
train_batch = dict(np.load(os.path.join(tmp, "train_batch.npz")))
out = {}


def placed(cfg):
    params = M.init(jax.random.PRNGKey(0), cfg)
    if "cross" in cfg.layer_pattern:
        params = gate_open(params)
    rules = make_rules(mesh, cfg)
    specs = param_pspecs(cfg, params, rules, mesh)
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)
    return params, ParallelContext(mesh=mesh, rules=rules, attn_impl="xla")


for name in FORWARD:
    cfg = variant(get_config, name)
    params, ctx = placed(cfg)
    batch = {k: jax.device_put(jnp.asarray(v), rows)
             for k, v in forward_batch(name).items()}
    logits, aux = jax.jit(lambda p, b: M.forward(p, cfg, b, ctx))(params,
                                                                 batch)
    one = ParallelContext(attn_impl="xla")
    unsharded, _ = jax.jit(lambda p, b: M.forward(p, cfg, b, one))(params,
                                                                  batch)
    out[name + "/logits"] = np.asarray(logits)
    out[name + "/unsharded"] = np.asarray(unsharded)
    for k, v in aux.items():
        out[name + "/" + k] = np.asarray(v)

for name in sorted({a for a, _, _ in TRAIN.values()}):
    cfg = variant(get_config, name)
    params, ctx = placed(cfg)
    keys = ("tokens", "labels", "segment_ids", "positions") \
        + (("memory",) if reads_memory(name) else ())
    batch = {k: jax.device_put(jnp.asarray(train_batch[k]), rows)
             for k in keys}

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


def _load(name, cfg, g):
    from repro_torch.models.convert import shard_model
    from repro_torch.models.model import Transformer
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(sys.argv[1],
                                                  name + ".pt")))
    shard_model(model, g.sizes, {"data": g.data_index,
                                 "model": g.model_index})
    return model


def _gathered_over_data(model, g):
    """One digest of every tensor gathered over the data ranks (a
    collective): equal across the data ranks of a model index."""
    from repro_torch.models.convert import gather_shard
    h = hashlib.sha1()
    for n, p in model.named_parameters():
        t = gather_shard(p.detach(), model.grid_placements[n],
                         {"data": g.data_group})
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _storage(model, opt_state):
    return dict(
        shapes={n: list(p.shape) for n, p in model.named_parameters()},
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        moment_bytes=sum(t.numel() * t.element_size()
                         for t in list(opt_state.mu) + list(opt_state.nu)))


def _train_case(case, g, tmp, res, meta):
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    from test_torch_grid import (TRAIN, memory_rows, pipe_config,
                                 reads_memory, train_config, variant)
    name, pingpong, cad = TRAIN[case]
    cfg = variant(get_config, name)
    pipe = pipe_config(cfg)
    model = _load(name, cfg, g)
    digests, grads = [], {}
    sess = None
    if cad:
        sess = CADSession.for_pipeline(cfg, pipe, grid=g, pingpong=pingpong)
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
    memory = torch.from_numpy(memory_rows(4, 2)) if reads_memory(name) \
        else None
    out = trainer.train(cfg, pipe, train_config(), model=model,
                        session=sess, grid=None if cad else g,
                        device="cpu", memory=memory,
                        on_step=lambda s, m: params.append(
                            _gathered_over_data(model, g)))
    trainer.AdamW = adamw.AdamW
    meta[case] = dict(losses=[h["loss"] for h in out["history"]],
                      total=[h["total_loss"] for h in out["history"]],
                      plan_digests=digests, params=params,
                      **_storage(model, out["opt_state"]))
    res.update({case + "/grad/" + n: t.numpy() for n, t in grads.items()})


def _runtime(g, tmp, res):
    """The runtime case: calibration, a kill and checkpoints on the
    grid; every pulled plan's digest, the observations fed to the
    calibrator by probe, its state after each, the pool's epoch by step,
    the parameters gathered whole after the checkpointed step, and a
    restarted session's calibration."""
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.models.convert import gather_shard
    from repro_torch.models.model import Transformer
    from repro_torch.runtime import ServerPool
    from repro_torch.train.trainer import train
    from test_torch_grid import RUNTIME, pipe_config, train_config
    cfg = get_config(RUNTIME["arch"])
    pipe = pipe_config(cfg)
    ckpt_dir = os.path.join(tmp, "ckpt")
    sess = CADSession.for_pipeline(cfg, pipe, grid=g, calibrate=True,
                                   prefetch=2)
    # the pool first: the trainer would attach one to a copy of the
    # session, without the wrappers below
    sess = sess.with_pool(ServerPool(2, calibrator=sess.calibrator))
    cal = sess.calibrator
    rec = dict(digests=[], probes=[], states=[], epochs=[])
    fed = []
    real_observe_tasks = cal.observe_tasks

    def observe_tasks(tasks, seconds, server=None):
        fed.append([[list(t) for t in tasks], seconds, server])
        return real_observe_tasks(tasks, seconds, server=server)
    cal.observe_tasks = observe_tasks
    real_probe = sess.observe_probe

    def observe_probe(plan, **kw):
        n0 = len(fed)
        real_probe(plan, **kw)
        rec["probes"].append(fed[n0:])
        rec["states"].append(json.dumps(cal.state_dict(), sort_keys=True))
    attach = sess.attach_plans

    def recording(batches):
        for b in attach(batches):
            rec["digests"].append(b["plan_digest"])
            yield b
    object.__setattr__(sess, "observe_probe", observe_probe)
    object.__setattr__(sess, "attach_plans", recording)
    model = Transformer(cfg, device="cpu", seed=0)

    def on_step(step, m):
        rec["epochs"].append(m["sched_pool_epoch"])
        if step == RUNTIME["ckpt_every"]:
            groups = {"data": g.data_group, "model": g.model_group}
            for n, p in model.named_parameters():
                res["runtime/param/" + n] = gather_shard(
                    p.detach(), model.grid_placements[n], groups) \
                    .numpy().copy()
    tc = dict(calibrate_every=1, fault_schedule=RUNTIME["faults"],
              ckpt_every=RUNTIME["ckpt_every"], ckpt_dir=ckpt_dir)
    train(cfg, pipe, train_config(steps=RUNTIME["steps"], **tc),
          model=model, session=sess, device="cpu", on_step=on_step)
    again = CADSession.for_pipeline(cfg, pipe, grid=g, calibrate=True)
    train(cfg, pipe, train_config(steps=0, **tc), session=again,
          device="cpu")
    rec["restored"] = json.dumps(again.calibrator.state_dict(),
                                 sort_keys=True)
    return rec


def worker(rank, tmp):
    torch.set_num_threads(1)
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    from repro_torch.models import sharded as S
    from repro_torch.parallel import ParallelContext
    from test_torch_grid import (FORWARD, TRAIN, forward_batch, pipe_config,
                                 variant)
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
                 for k, v in forward_batch(name).items()}
        with torch.no_grad():
            logits, aux = model(batch, ctx)
        vocab_split = sess.rules.vocab is not None
        logits = S.all_gather(logits, g.model_group,
                              dim=2 if vocab_split else 1)
        res[name + "/logits"] = S.all_gather(logits, g.data_group).numpy()
        for k, v in aux.items():
            dist.all_reduce(v)
            res[name + "/" + k] = v.numpy()
    for case in TRAIN:
        _train_case(case, g, tmp, res, meta)
    meta["runtime"] = _runtime(g, tmp, res)
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
    if "cross" in cfg_j.layer_pattern:
        params = gate_open(params)
    return params_from_jax(params_to_numpy(params),
                           variant(get_config, name))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Run the 4-rank grid and the reference's mesh (at once); return
    (the reference's arrays, every rank's arrays and records, the port's
    full weights by variant, the worker's directory)."""
    tmp = tmp_path_factory.mktemp("grid")
    states = {n: _port_state(n) for n in FORWARD}
    for name, state in states.items():
        torch.save(state, tmp / f"{name}.pt")
    batch = next(raw_batches(pipe_config(variant(get_config, "smollm3"))))
    np.savez(tmp / "train_batch.npz", memory=memory_rows(BATCH, 2), **{
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
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-4000:]
    with np.load(tmp / "ref.npz") as z:
        ref = dict(z)
    ranks = []
    for r in range(4):
        with np.load(tmp / f"rank{r}.npz") as z:
            arrays = dict(z)
        ranks.append((arrays, json.loads((tmp / f"rank{r}.json")
                                         .read_text())))
    return ref, ranks, states, tmp


@pytest.mark.parametrize("name", FORWARD)
def test_grid_forward_matches_reference_mesh(grid, name):
    ref, ranks, _, _ = grid
    want = ref[name + "/logits"]
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays[name + "/logits"], want,
                                   **LOGIT_TOL[name])
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
    ref, ranks, _, _ = grid
    gap = np.abs(ref[name + "/logits"] - ref[name + "/unsharded"]).max()
    assert (gap > 1.0) == local, gap
    got = ranks[0][0][name + "/logits"]
    np.testing.assert_allclose(got, ref[name + "/logits"], **LOGIT_TOL[name])


def _one_process(case, states):
    name, pingpong, cad = TRAIN[case]
    cfg = variant(get_config, name)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(states[name])
    pipe = pipe_config(cfg)
    memory = torch.from_numpy(memory_rows(BATCH, 2)) \
        if reads_memory(name) else None
    sess = CADSession.for_pipeline(cfg, pipe, pingpong=pingpong) \
        if cad else None
    return train(cfg, pipe, train_config(), model=model, session=sess,
                 device="cpu", memory=memory)


@pytest.mark.parametrize("case", TRAIN)
def test_grid_training_matches_one_process(grid, case):
    _, ranks, states, _ = grid
    want = [h["loss"] for h in _one_process(case, states)["history"]]
    for _, meta in ranks:
        np.testing.assert_allclose(meta[case]["losses"], want,
                                   rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("case", TRAIN)
def test_grid_gradients_match_reference_mesh(grid, case):
    """Step 0's gradients, each rank's shards put back together, against
    ``jax.grad`` of the reference's loss (with its aux losses) on its
    (2, 2) mesh; the step-0 total loss too."""
    ref, ranks, states, _ = grid
    name, _, _ = TRAIN[case]
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
                                   atol=GRAD_REL[name] * np.abs(w).max(),
                                   err_msg=n)
    for _, meta in ranks:
        np.testing.assert_allclose(meta[case]["total"][0],
                                   float(ref[name + "/loss"]),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", TRAIN)
def test_grid_parameters_bitwise_across_data_ranks(grid, case):
    """After each step the parameters, each gathered over the data ranks,
    are bitwise equal across the data ranks of each model index, and
    differ between the model ranks (their shards)."""
    _, ranks, _, _ = grid
    params = [meta[case]["params"] for _, meta in ranks]
    assert len(params[0]) == STEPS
    assert params[0] == params[2] and params[1] == params[3]
    assert params[0] != params[1]


@pytest.mark.parametrize("case", CAD_TRAIN)
def test_grid_plan_digests_equal_on_every_rank(grid, case):
    _, ranks, _, _ = grid
    digests = [meta[case]["plan_digests"] for _, meta in ranks]
    assert len(digests[0]) == STEPS
    assert all(d == digests[0] for d in digests)


@pytest.mark.parametrize("case", TRAIN)
def test_grid_stores_what_the_placements_say(grid, case):
    """Every rank holds each tensor at its placement's shard shape (the
    FSDP data axes included: some tensor of every arch is split over
    "data"), and its parameter and AdamW moment bytes are the sums of
    those shards' sizes."""
    _, ranks, states, _ = grid
    name, _, _ = TRAIN[case]
    cfg = variant(get_config, name)
    placements = grid_placements(cfg, states[name], SIZES)
    want = {n: list(shard_shape(t.shape, placements[n], SIZES))
            for n, t in states[name].items()}
    assert any("data" in sharded_over(a) and not n.split(".")[-1]
               .startswith("experts_") for n, a in placements.items())
    n_elems = {n: int(np.prod(s)) for n, s in want.items()}
    for _, meta in ranks:
        assert meta[case]["shapes"] == want
        assert meta[case]["param_bytes"] == sum(
            k * states[name][n].element_size() for n, k in n_elems.items())
        assert meta[case]["moment_bytes"] == 2 * 4 * sum(n_elems.values())


def test_grid_runtime_plans_and_calibration_equal_on_every_rank(grid):
    """Under calibration and a kill, every rank pulls the same plans, and
    its calibrator holds the same state after every probe; every rank
    reads the kill at step 2 (pool epoch 1 from there)."""
    _, ranks, _, _ = grid
    recs = [meta["runtime"] for _, meta in ranks]
    steps = RUNTIME["steps"]
    for key in ("digests", "states", "probes", "epochs"):
        assert all(r[key] == recs[0][key] for r in recs), key
    assert len(recs[0]["digests"]) == len(recs[0]["states"]) == steps
    assert recs[0]["epochs"] == [0, 0, 1, 1]
    assert len(set(recs[0]["states"])) == steps


def test_grid_runtime_one_process_builds_the_same_plans(grid):
    """The one-process trainer under the same fault schedule, its probes
    replaced by the grid's gathered observations in order, pulls the
    grid's plans at every step."""
    _, ranks, _, _ = grid
    rec = ranks[0][1]["runtime"]
    cfg = get_config(RUNTIME["arch"])
    pipe = pipe_config(cfg)
    sess = CADSession.for_pipeline(cfg, pipe, calibrate=True, prefetch=0)
    sess = sess.with_pool(ServerPool(2, calibrator=sess.calibrator))
    probes = iter(rec["probes"])

    def replay(plan, **kw):
        for tasks, seconds, server in next(probes):
            sess.calibrator.observe_tasks([tuple(t) for t in tasks],
                                          seconds, server=server)
    digests = []
    attach = sess.attach_plans

    def recording(batches):
        for b in attach(batches):
            digests.append(plan_digest(b["plan"]))
            yield b
    object.__setattr__(sess, "observe_probe", replay)        # frozen
    object.__setattr__(sess, "attach_plans", recording)
    train(cfg, pipe, train_config(steps=RUNTIME["steps"], calibrate_every=1,
                                  fault_schedule=RUNTIME["faults"]),
          model=Transformer(cfg, device="cpu", seed=0), session=sess,
          device="cpu")
    assert digests == rec["digests"]
    assert json.dumps(sess.calibrator.state_dict(), sort_keys=True) \
        == rec["states"][-1]


def test_grid_checkpoint_loads_into_one_process_bitwise(grid):
    """Rank 0's checkpoint of the grid (step 2) restores into a
    one-process ``Transformer`` and its AdamW state, with the one-process
    keys and layout, and its parameters equal the grid's shards gathered
    whole, bitwise."""
    _, ranks, _, tmp = grid
    arrays = ranks[0][0]
    cfg = get_config(RUNTIME["arch"])
    model = Transformer(cfg, device="cpu", seed=1)
    opt = AdamW()
    step = RUNTIME["ckpt_every"]
    got = ckpt.restore(str(tmp / "ckpt"), step,
                       {"params": model.state_dict(),
                        "opt_state": opt.init(list(model.parameters()))})
    model.load_state_dict(got["params"])
    assert got["opt_state"].step == step + 1
    for n, p in model.state_dict().items():
        assert torch.equal(p, torch.from_numpy(arrays["runtime/param/" + n])
                           ), n
    for _, meta in ranks:
        assert meta["runtime"]["restored"] == \
            meta["runtime"]["states"][step]


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


@pytest.mark.parametrize("arch,cad", [("mamba2-370m-reduced", False),
                                      ("recurrentgemma-9b-reduced", True),
                                      ("whisper-large-v3-reduced", True)])
def test_torchrun_launcher_trains_every_layer_kind_on_a_grid(
        arch, cad, tmp_path, capsys, monkeypatch):
    """``torchrun --nproc-per-node 4 ... --ranks 2 --model-axis 2`` for
    the ssd (no --cad: a sessionless grid, ``xla``), rglru and
    cross/encoder archs (a stub memory): rank 0 prints the one-process
    launcher's step lines at ``--ranks 2``, to the printed digits."""
    from repro_torch.launch import train as launch
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    args = ["--arch", arch, "--steps", "2", "--seq", "256", "--batch", "4",
            "--ranks", "2", "--device", "cpu"] + (["--cad"] if cad else [])
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
