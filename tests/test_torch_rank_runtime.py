"""The per-rank runtime: calibration probes, fault schedules and
KV-streaming plans under a CAD process group, in a gloo group of 4 CPU
processes spawned once for the module.

Every rank must build the same plan at every step, so every rank must
plan from the same calibration snapshot and pool epoch.  Each rank
probes its own server's batch in its turn (``probe_plan_times(...,
group=g)``), the triples are gathered and fed to every rank's calibrator
in server order (``CADSession.observe_probe``), every rank applies the
fault schedule's membership events at the same step, and a prefetched
plan of another calibration version is re-planned at pull.

Two training runs of smollm-360m-reduced at 4 ranks, 4 steps of 4 x 256
``prolong`` tokens, ``calibrate_every=1``, prefetch 2:

* ``main``: ``kill:1@2,slow:3x2@1-3``, a checkpoint every 2 steps.  The
  probe runs (its turns and serves are real), but the worker replaces its
  seconds by the base cost model's prediction of each server's tasks
  times the schedule's slow factor, so the speeds move only where the
  schedule slows server 3: step 0's probe leaves every speed where it
  was, and the plan prefetched before it is re-planned at pull all the
  same.  The fused trainer takes no notice of a slow event; the probe
  timings are where it shows.
* ``ref``: ``kill:1@2`` alone on the reference's initial weights, with
  the probe's measured seconds (each rank's own, gathered).

Held: digests, calibration versions, pool epochs and calibrator states
equal on every rank at every step, the parameters bitwise equal across
the ranks; each rank timed its own server alone, in rank order; every
plan exactly the reference ``CADSession``'s fed the same observations and
pool events (host numpy modules on both sides); the losses within 1e-5
relative of the port's one-process trainer replaying the observations,
and (``ref``) within 1e-4 of the reference's trainer under the same kill;
rank 0's checkpointed calibration restored identically on every rank.
A third case plans custom layouts with HBM budgets that stream a
document (``stream_chunk=2``) and serves them on the rank path; the
executors refuse a session over the group."""
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

from repro.cad import CADSession as JSession
from repro.cad import get_planner as j_get_planner
from repro.configs import get_config as jax_config
from repro.core.cost_model import CostModel as JCost
from repro.core.cost_model import GridCalibrator as JGrid
from repro.data.pipeline import PipelineConfig as JPipe
from repro.models import model as JM
from repro.runtime import FaultSchedule as JFaults
from repro.runtime import ServerPool as JPool
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import train as j_train
from repro_torch.cad import CADSession
from repro_torch.cad.planner import get_planner
from repro_torch.cad.session import plan_digest
from repro_torch.configs import get_config
from repro_torch.core import dispatch as D
from repro_torch.core.cost_model import PEAK_FLOPS_BF16, MemoryModel
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Transformer
from repro_torch.runtime import ServerPool
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import params_to_numpy, to_numpy

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCH = "smollm-360m-reduced"
TRAIN = dict(arch=ARCH, steps=4, seq=256, batch=4, seed=0, ckpt_every=2)
MAIN_FAULTS = "kill:1@2,slow:3x2@1-3"
REF_FAULTS = "kill:1@2"
KILLED, KILL_STEP = 1, 2
LOSS_RTOL = 1e-5            # the group sums its rows in another order
REF_ATOL = 1e-4             # tests/test_torch_train.py's bound
STREAM = dict(seq=1024, chunk=2, budget_frac=0.8)
OUT_ATOL = 1e-5

WORKER = r'''
import hashlib, json, os, sys, time
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


def _pipe(cfg, seq, batch):
    from repro_torch.data.pipeline import PipelineConfig
    return PipelineConfig(distribution="prolong", max_doc_len=seq,
                          seq_len=seq, global_batch=batch, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)


def _train_run(rank, group, tmp, spec, name, arrays):
    """One training run of the group; returns its record, and adds its
    plans to ``arrays``."""
    import repro_torch.cad.session as session_mod
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.models.model import Transformer
    from repro_torch.runtime import FaultSchedule, ServerPool
    from repro_torch.train.trainer import TrainConfig, train
    t, run = spec["train"], spec["runs"][name]
    cfg = get_config(t["arch"])
    pipe = _pipe(cfg, t["seq"], t["batch"])
    sess = CADSession.for_pipeline(cfg, pipe, group=group, calibrate=True,
                                   prefetch=2)
    sess = sess.with_pool(ServerPool(4, calibrator=sess.calibrator))
    cal, pool = sess.calibrator, sess.pool
    faults = FaultSchedule.parse(run["faults"])
    rec = {k: [] for k in ("pulls", "stale", "probes", "snaps", "turns",
                           "own", "steps")}
    fed = []

    real_observe_tasks = cal.observe_tasks

    def observe_tasks(tasks, seconds, server=None):
        fed.append([[list(x) for x in tasks], seconds, server])
        return real_observe_tasks(tasks, seconds, server=server)
    cal.observe_tasks = observe_tasks

    real_probe, real_serve = session_mod.probe_plan_times, D._serve_one
    serves = []

    def serve_one(*a, **k):
        t0 = time.time()
        out = real_serve(*a, **k)
        serves.append([t0, time.time()])
        return out

    def probe(cad, plan, **kw):
        del serves[:]
        out = real_probe(cad, plan, **kw)
        rec["turns"].append(list(serves))
        rec["own"].append([[s, [list(x) for x in tasks]]
                           for s, tasks, _ in out])
        if run["seconds"] == "model":
            step = kw["seed"] - t["seed"]
            out = [(s, tasks, float(sum(cal.base.predict(q, kv)
                                        for q, kv in tasks))
                    * faults.slow_factor(step, s)) for s, tasks, _ in out]
        return out

    real_observe_probe = sess.observe_probe

    def observe_probe(plan, **kw):
        n0 = len(fed)
        real_observe_probe(plan, **kw)
        rec["probes"].append(fed[n0:])
        rec["snaps"].append(json.dumps(cal.state_dict(), sort_keys=True))

    real_stale = sess._plan_stale

    def plan_stale(batch):
        st = batch.get("schedule_stats") or {}
        stale = real_stale(batch)
        snap = cal.snapshot()
        rec["stale"].append(dict(
            version=st.get("calib_version"), now=snap.version,
            epoch=st.get("pool_epoch"), now_epoch=pool.epoch,
            drift=max(abs(st.get(f"calib_speed_{s}", 1.0) - snap.speeds[s])
                      for s in range(4)),
            stale=stale))
        return stale

    real_attach = sess.attach_plans

    def attach_plans(batches):
        gen = real_attach(batches)
        try:
            for b in gen:
                st = b["schedule_stats"]
                k = len(rec["pulls"])
                for f, a in b["plan"].items():
                    arrays[f"{name}_plan{k}_{f}"] = np.asarray(a)
                rec["pulls"].append(dict(
                    digest=b["plan_digest"],
                    calib_version=st["calib_version"],
                    version_now=cal.version,
                    pool_epoch=st["pool_epoch"],
                    pool_active=st["pool_active"]))
                yield b
        finally:
            gen.close()
    for attr, fn in (("observe_probe", observe_probe),
                     ("_plan_stale", plan_stale),
                     ("attach_plans", attach_plans)):
        object.__setattr__(sess, attr, fn)      # a frozen dataclass
    model = Transformer(cfg, device="cpu", seed=t["seed"])
    if run["weights"]:
        with np.load(os.path.join(tmp, "weights.npz")) as z:
            model.load_state_dict({k: torch.from_numpy(z[k].copy())
                                   for k in z.files})

    def on_step(step, m):
        rec["steps"].append(dict(
            loss=m["loss"], params=_digest(model),
            calib_version=m["sched_calib_version"],
            pool_epoch=m["sched_pool_epoch"],
            pool_active=m["sched_pool_active"],
            pool_events=m.get("pool_events", "")))
    session_mod.probe_plan_times, D._serve_one = probe, serve_one
    try:
        train(cfg, pipe, TrainConfig(
                  steps=t["steps"], peak_lr=1e-3, warmup=1, log_every=1,
                  seed=t["seed"], calibrate_every=1,
                  fault_schedule=run["faults"],
                  ckpt_every=t["ckpt_every"] if run["ckpt"] else 0,
                  ckpt_dir=os.path.join(tmp, "ckpt")),
              model=model, device="cpu", session=sess, on_step=on_step)
    finally:
        session_mod.probe_plan_times, D._serve_one = real_probe, real_serve
    return rec


def _restored(rank, group, tmp, spec):
    """(h): a fresh calibrated session's trainer restores rank 0's
    checkpointed calibration at start."""
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import TrainConfig, train
    t = spec["train"]
    cfg = get_config(t["arch"])
    pipe = _pipe(cfg, t["seq"], t["batch"])
    sess = CADSession.for_pipeline(cfg, pipe, group=group, calibrate=True)
    train(cfg, pipe, TrainConfig(steps=1, peak_lr=1e-3, warmup=1,
                                 seed=t["seed"], ckpt_every=t["ckpt_every"],
                                 ckpt_dir=os.path.join(tmp, "ckpt")),
          model=Transformer(cfg, device="cpu", seed=t["seed"]),
          device="cpu", session=sess)
    return json.dumps(sess.calibrator.state_dict(), sort_keys=True)


def _streamed(rank, group, tmp, spec, inp, arrays):
    """(g): HBM budgets that stream a document, planned under the group
    (prefetch 2), then served on the rank path."""
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.parallel import ParallelContext
    st = spec["stream"]
    cfg = get_config(spec["train"]["arch"])
    pipe = _pipe(cfg, st["seq"], 4)
    sess = CADSession.for_pipeline(cfg, pipe, group=group, prefetch=2,
                                   server_hbm=tuple(st["hbm"]),
                                   stream_chunk=st["chunk"])
    batches = [{k: inp[f"stream{i}_{k}"] for k in
                ("tokens", "labels", "segment_ids", "positions")}
               for i in range(st["n"])]
    digests = []
    for i, b in enumerate(sess.attach_plans(iter(batches))):
        digests.append(b["plan_digest"])
        for f, a in b["plan"].items():
            arrays[f"stream{i}_plan_{f}"] = np.asarray(a)
        rows = slice(rank, rank + 1)
        q, k, v = (torch.from_numpy(inp[f"stream{i}_{n}"][rows].copy())
                   for n in "qkv")
        seg = torch.from_numpy(b["segment_ids"].copy())
        pos = torch.from_numpy(b["positions"].copy())
        ctx = ParallelContext(attn_impl="cad", group=group,
                              cad=D.CADContext(cfg=sess.cfg, plan=b["plan"],
                                               jmax=sess.jmax))
        with torch.no_grad():
            arrays[f"stream{i}_out"] = D.cad_attention(
                q, k, v, seg, pos, seg, pos, ctx=ctx).numpy()
    return digests


def _observe_gathers(rank, group, spec):
    """``observe_server`` and ``observe_plan`` gather every rank's timing;
    ``observe`` refuses a group."""
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    t = spec["train"]
    cfg = get_config(t["arch"])
    pipe = _pipe(cfg, t["seq"], t["batch"])
    sess = CADSession.for_pipeline(cfg, pipe, group=group, calibrate=True)
    sess.observe_server(rank, [(128, 128 * (rank + 1))], 1e-3 * (rank + 1))
    plan, _ = sess.plan(np.ones((4, t["seq"]), np.int32)
                        * np.arange(1, 5, dtype=np.int32)[:, None])
    sess.observe_plan(plan, {rank: 2e-3 * (rank + 1)})
    return dict(state=json.dumps(sess.calibrator.state_dict(),
                                 sort_keys=True),
                n_obs=sess.calibrator.n_observations,
                refused=_raises(lambda: sess.observe(128, 128, 1e-3, 0),
                                RuntimeError))


def _executors(rank, group, spec):
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.fabric import FabricExecutor, ServeWorkload
    from repro_torch.runtime import ElasticExecutor, ServerPool
    t = spec["train"]
    cfg = get_config(t["arch"])
    sess = CADSession.for_pipeline(cfg, _pipe(cfg, t["seq"], t["batch"]),
                                   group=group)
    sess = sess.with_pool(ServerPool(4))
    work = ServeWorkload([(0, 256, 4)], n_heads=cfg.n_heads,
                         head_dim=cfg.head_dim, n_kv_heads=cfg.n_kv_heads)
    return {"elastic": _raises(lambda: ElasticExecutor(sess), ValueError),
            "fabric": _raises(lambda: FabricExecutor(sess, work),
                              ValueError)}


def worker(rank, tmp):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh
    info = mesh.join_group("cpu", rank=rank, world=4,
                           init_method="file://" + os.path.join(tmp, "store"),
                           timeout_s=120)
    group = info.group
    spec = json.load(open(os.path.join(tmp, "spec.json")))
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    arrays, meta = {}, {"tmp": tmp}
    for name in spec["runs"]:
        meta[name] = _train_run(rank, group, tmp, spec, name, arrays)
    meta["restored"] = _restored(rank, group, tmp, spec)
    meta["stream_digests"] = _streamed(rank, group, tmp, spec, inp, arrays)
    meta["observe"] = _observe_gathers(rank, group, spec)
    meta["executors"] = _executors(rank, group, spec)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    mesh.leave_group()


if __name__ == "__main__":
    # the group meets in a file store under the test's directory: no port
    mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
'''


def _cfg():
    return get_config(ARCH)


def _pipe(seq=TRAIN["seq"], batch=TRAIN["batch"]):
    return dict(distribution="prolong", max_doc_len=seq, seq_len=seq,
                global_batch=batch, n_ranks=WORLD,
                vocab_size=_cfg().vocab_size, seed=0)


def _stream_layouts():
    """Two global batches of [4, 1024]: one row holds a document of all 8
    blocks, each other row one short document and padding (segment 0);
    the long document moves a row down in the second batch."""
    seq, blk = STREAM["seq"], 128
    out = []
    for i in range(2):
        segs = np.zeros((WORLD, seq), np.int32)
        pos = np.zeros((WORLD, seq), np.int32)
        for r in range(WORLD):
            n = seq if r == i else blk * (1 + (r + i) % 3)
            segs[r, :n] = 10 * r + 1
            pos[r, :n] = np.arange(n)
        rng = np.random.default_rng(7 + i)
        toks = rng.integers(0, _cfg().vocab_size, (WORLD, seq)).astype(
            np.int32)
        labels = np.where((segs > 0) & (np.roll(segs, -1, 1) == segs),
                          np.roll(toks, -1, 1), -1).astype(np.int32)
        out.append(dict(tokens=toks, labels=labels, segment_ids=segs,
                        positions=pos))
    return out


def _stream_hbm():
    """Every endpoint's budget below the long document's final task (so
    it must stream) and above what the rest needs once it streams."""
    cfg = _cfg()
    sess = CADSession.for_pipeline(cfg, PipelineConfig(**_pipe(
        STREAM["seq"], WORLD)), prefetch=0)
    final = MemoryModel(sess.comm).task_bytes(
        sess.cfg.blk, sess.cfg.nb * sess.cfg.blk)
    return (STREAM["budget_frac"] * final,) * WORLD


def _stream_qkv(i):
    cfg = _cfg()
    rng = np.random.default_rng(20 + i)
    shape = (WORLD, STREAM["seq"])
    return tuple(rng.standard_normal(shape + (h, cfg.head_dim))
                 .astype(np.float32)
                 for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))


def _reference_params():
    return JM.init(jax.random.PRNGKey(TRAIN["seed"]), jax_config(ARCH))


def _reference_losses():
    """The reference trainer under ``kill:1@2`` on its initial weights."""
    cfg_j = jax_config(ARCH)
    sess = JSession.for_pipeline(cfg_j, JPipe(**_pipe()), prefetch=0)
    res = j_train(cfg_j, JPipe(**_pipe()), JTrainConfig(
        steps=TRAIN["steps"], peak_lr=1e-3, warmup=1, log_every=1,
        fault_schedule=REF_FAULTS), params=_reference_params(),
        session=sess)
    return [h["loss"] for h in res["history"]]


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """Spawn the 4-rank gloo group once (the reference's trainer runs in
    this process meanwhile); return every rank's record and arrays, and
    the reference's losses."""
    tmp = tmp_path_factory.mktemp("rank_runtime")
    params = params_from_jax(params_to_numpy(_reference_params()), _cfg())
    np.savez(tmp / "weights.npz", **{k: to_numpy(v)
                                     for k, v in params.items()})
    arrays = {}
    for i, b in enumerate(_stream_layouts()):
        arrays.update({f"stream{i}_{k}": v for k, v in b.items()})
        arrays.update(zip((f"stream{i}_{n}" for n in "qkv"),
                          _stream_qkv(i)))
    np.savez(tmp / "inputs.npz", **arrays)
    (tmp / "spec.json").write_text(json.dumps({
        "train": TRAIN,
        "runs": {"main": dict(faults=MAIN_FAULTS, seconds="model",
                              weights=False, ckpt=True),
                 "ref": dict(faults=REF_FAULTS, seconds="measured",
                             weights=True, ckpt=False)},
        "stream": dict(seq=STREAM["seq"], chunk=STREAM["chunk"],
                       hbm=list(_stream_hbm()), n=2)}))
    (tmp / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(tmp / "worker.py"),
                             str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(tmp))
    try:
        ref_losses = _reference_losses()
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    per_rank = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as z:
            arr = dict(z)
        per_rank.append((arr, json.loads((tmp / f"rank{r}.json")
                                         .read_text())))
    return per_rank, ref_losses


def _plans(arr, name, n):
    return [{f: arr[f"{name}_plan{k}_{f}"] for f in
             ("q_home_idx", "q_send_idx", "kv_send_idx", "kv_gather",
              "task_kv_start", "task_kv_len")} for k in range(n)]


def _batches(seq=TRAIN["seq"]):
    it = raw_batches(PipelineConfig(**_pipe(seq)))
    return [next(it) for _ in range(TRAIN["steps"])]


RUNS = ["main", "ref"]


@pytest.mark.parametrize("name", RUNS)
def test_every_rank_plans_from_the_same_state(group_run, name):
    """(a) At every step: one plan digest, calibration version and pool
    epoch on every rank; after every probe one calibrator state (grid,
    speeds, version); after every step the parameters bitwise equal.
    From the kill on, server 1 is out of every plan: epoch 1, 3 active,
    no live task on server 1."""
    per_rank, _ = group_run
    recs = [meta[name] for _, meta in per_rank]
    for key in ("pulls", "steps", "snaps"):
        assert all(r[key] == recs[0][key] for r in recs), key
    assert len(recs[0]["steps"]) == TRAIN["steps"]
    assert len(recs[0]["snaps"]) == TRAIN["steps"]
    for k, (pull, step) in enumerate(zip(recs[0]["pulls"],
                                         recs[0]["steps"])):
        after = k >= KILL_STEP
        assert pull["calib_version"] == step["calib_version"]
        assert (pull["pool_epoch"], pull["pool_active"]) \
            == ((1.0, 3.0) if after else (0.0, 4.0))
        assert step["pool_events"] == (f"kill {KILLED}"
                                       if k == KILL_STEP else "")
    digests = [s["params"] for s in recs[0]["steps"]]
    assert len(set(digests)) == TRAIN["steps"]     # the steps moved them
    cfg = CADSession.for_pipeline(_cfg(), PipelineConfig(**_pipe())).cfg
    for k, plan in enumerate(_plans(per_rank[0][0], name, TRAIN["steps"])):
        servers = {s for s, *_ in D.iter_plan_tasks(cfg, plan)}
        assert (KILLED in servers) == (k < KILL_STEP), k


@pytest.mark.parametrize("name", RUNS)
def test_each_rank_probes_its_own_server_in_rank_order(group_run, name):
    """(b) Rank r's probe timed server r alone, with server r's task
    composition: one warm-up serve and one timed serve, the timed serve
    after rank r - 1's had ended."""
    per_rank, _ = group_run
    cfg = CADSession.for_pipeline(_cfg(), PipelineConfig(**_pipe())).cfg
    plans = _plans(per_rank[0][0], name, TRAIN["steps"])
    for k, plan in enumerate(plans):
        tasks = {s: [] for s in range(WORLD)}
        for s, _slot, qt, kvt in D.iter_plan_tasks(cfg, plan):
            tasks[s].append([qt, kvt])
        timed = []
        for r, (_, meta) in enumerate(per_rank):
            assert meta[name]["own"][k] == [[r, tasks[r]]]
            turns = meta[name]["turns"][k]
            assert len(turns) == 2            # warm-up, the timed serve
            timed.append(turns[1])
        for a, b in zip(timed, timed[1:]):
            assert a[1] <= b[0], (k, timed)


@pytest.mark.parametrize("name", RUNS)
def test_plans_equal_the_reference_session(group_run, name):
    """(c) The reference's ``CADSession`` (calibrated, with a
    ``ServerPool`` and the same ``FaultSchedule``) plans every step's
    segment ids at prefetch 0, fed the gathered observations and the pool
    events at the same steps: its plans equal the group's exactly, and so
    do its calibration versions and speeds."""
    per_rank, _ = group_run
    arr, meta = per_rank[0]
    rec = meta[name]
    faults = REF_FAULTS if name == "ref" else MAIN_FAULTS
    sess = JSession.for_pipeline(jax_config(ARCH), JPipe(**_pipe()),
                                 calibrate=True, prefetch=0)
    # the port's analytic model carries the H100's peak rate, the
    # reference's another chip's: both calibrators start from the port's
    cm = sess.calibrator.base
    sess = dataclasses.replace(sess, calibrator=JGrid(
        JCost.analytic(cm.n_heads, cm.head_dim, peak_flops=PEAK_FLOPS_BF16),
        WORLD, ema=sess.calibrator.ema, prior_speeds=sess.cfg.speeds()))
    pool = JPool(WORLD, calibrator=sess.calibrator)
    sess = sess.with_pool(pool)
    sched = JFaults.parse(faults)
    plans = _plans(arr, name, TRAIN["steps"])
    for k, b in enumerate(_batches()):
        sched.apply_pre_step(pool, k)
        sched.apply_failures(pool, k)
        want, stats = sess.plan(np.asarray(b["segment_ids"])
                                .reshape(WORLD, -1))
        for f, got in plans[k].items():
            np.testing.assert_array_equal(got, np.asarray(want[f]),
                                          err_msg=f"step {k} {f}")
        assert stats["calib_version"] == rec["pulls"][k]["calib_version"]
        for tasks, seconds, server in rec["probes"][k]:
            sess.calibrator.observe_tasks([tuple(t) for t in tasks],
                                          seconds, server=server)
        got, want = json.loads(rec["snaps"][k]), \
            sess.calibrator.state_dict()
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(np.asarray(got[key], float),
                                          np.asarray(want[key], float),
                                          err_msg=f"step {k} {key}")


def _one_process(rec, faults, model):
    """The port's one-process trainer on the group's batches, its
    ``observe_probe`` replaying the group's gathered observations in
    order, at prefetch 0; returns (losses, plan digests)."""
    cfg, pipe = _cfg(), PipelineConfig(**_pipe())
    sess = CADSession.for_pipeline(cfg, pipe, calibrate=True, prefetch=0)
    sess = sess.with_pool(ServerPool(WORLD, calibrator=sess.calibrator))
    probes = iter(rec["probes"])
    digests = []

    def replay(plan, **kw):
        for tasks, seconds, server in next(probes):
            sess.calibrator.observe_tasks([tuple(t) for t in tasks],
                                          seconds, server=server)

    def recording(batches, attach=sess.attach_plans):
        gen = attach(batches)
        try:
            for b in gen:
                digests.append(plan_digest(b["plan"]))
                yield b
        finally:
            gen.close()
    object.__setattr__(sess, "observe_probe", replay)        # frozen
    object.__setattr__(sess, "attach_plans", recording)
    res = train(cfg, pipe, TrainConfig(
        steps=TRAIN["steps"], peak_lr=1e-3, warmup=1, log_every=1,
        seed=TRAIN["seed"], calibrate_every=1, fault_schedule=faults),
        model=model, session=sess, device="cpu")
    return [h["loss"] for h in res["history"]], digests


def test_losses_match_the_one_process_trainer(group_run):
    """(d) The one-process trainer replaying the group's observations
    builds the group's plan at every step, and its losses agree within
    1e-5 relative (each rank sums its own rows' loss and gradients, then
    the ranks sum theirs: another order)."""
    per_rank, _ = group_run
    rec = per_rank[0][1]["main"]
    losses, digests = _one_process(
        rec, MAIN_FAULTS, Transformer(_cfg(), device="cpu",
                                      seed=TRAIN["seed"]))
    assert digests == [p["digest"] for p in rec["pulls"]]
    np.testing.assert_allclose([s["loss"] for s in rec["steps"]], losses,
                               rtol=LOSS_RTOL, atol=0)


def test_losses_match_the_reference_trainer_under_a_kill(group_run):
    """(e) Under ``kill:1@2`` alone, on the reference's initial weights
    (converted), the group's losses are within 1e-4 of the reference's
    trainer; the group calibrates from its measured probe times, which
    move tasks, not arithmetic."""
    per_rank, ref_losses = group_run
    for _, meta in per_rank:
        np.testing.assert_allclose([s["loss"] for s in meta["ref"]["steps"]],
                                   ref_losses, atol=REF_ATOL, rtol=0)


def test_prefetched_plan_of_an_older_version_is_replanned_at_pull(
        group_run):
    """(f) Step 0's probe leaves every speed where it was (the model
    seconds of unslowed servers), so step 1's plan, prefetched before the
    probe, drifted less than ``recalib_threshold``: the one-process rule
    would keep it; under the group it is re-planned at pull, and every
    pulled plan carries the calibration version current at its pull."""
    per_rank, _ = group_run
    threshold = CADSession.recalib_threshold
    for _, meta in per_rank:
        rec = meta["main"]
        for pull in rec["pulls"]:
            assert pull["calib_version"] == pull["version_now"]
        kept_by_drift = [c for c in rec["stale"]
                         if c["version"] != c["now"]
                         and c["epoch"] == c["now_epoch"]
                         and c["drift"] <= threshold]
        assert kept_by_drift and all(c["stale"] for c in kept_by_drift)
        assert all(c["stale"] == (c["version"] != c["now"]
                                  or c["epoch"] != c["now_epoch"])
                   for c in rec["stale"])


def test_streaming_plans_agree_and_outputs_match_one_process(group_run):
    """(g) HBM budgets under the long document's final task with
    ``stream_chunk=2``: the long document streams (the port's planner
    and the reference's name it), the group's digests agree and its
    plans equal the one-process session's and the reference session's.
    The rank path serves unstreamed: its outputs are within 1e-5 of the
    one-process run that streams each server's batch, and bitwise
    ``_global_sim``'s."""
    per_rank, _ = group_run
    cfg = _cfg()
    pipe = _pipe(STREAM["seq"], WORLD)
    hbm = _stream_hbm()
    kw = dict(prefetch=0, server_hbm=hbm, stream_chunk=STREAM["chunk"])
    sess = CADSession.for_pipeline(cfg, PipelineConfig(**pipe), **kw)
    jsess = JSession.for_pipeline(jax_config(ARCH), JPipe(**pipe), **kw)
    digests = [meta["stream_digests"] for _, meta in per_rank]
    assert all(d == digests[0] for d in digests)
    for i, b in enumerate(_stream_layouts()):
        segs = b["segment_ids"]
        res = get_planner("balanced")(sess.cfg, segs, comm=sess.comm,
                                      tolerance=sess.tolerance)
        jres = j_get_planner("balanced")(jsess.cfg, segs, comm=jsess.comm,
                                         tolerance=jsess.tolerance)
        assert res.streamed and res.streamed == jres.streamed, i
        want = sess.plan(segs)[0]
        assert plan_digest(want) == digests[0][i]
        for f in want:
            np.testing.assert_array_equal(per_rank[0][0][
                f"stream{i}_plan_{f}"], np.asarray(want[f]))
            np.testing.assert_array_equal(np.asarray(want[f]),
                                          np.asarray(jsess.plan(segs)[0][f]))
        cad = D.CADContext(cfg=sess.cfg, jmax=sess.jmax)
        q, k, v = (torch.from_numpy(x) for x in _stream_qkv(i))
        pos = torch.from_numpy(np.where(segs > 0, b["positions"], -1))
        inputs, plans_r = D.build_server_inputs(cad, want, q, k, v, pos)
        streamed = {s: D.serve_task_batch(cad, inputs[s], plans_r[s],
                                          stream_chunk=STREAM["chunk"])
                    for s in range(WORLD)}
        one = to_numpy(D.assemble_step_outputs(sess.cfg, want, streamed,
                                               q.shape, q.dtype))
        fused = to_numpy(D._global_sim(q, k, v, pos, D._plan_tensors(
            want, "cpu"), cad, 0.0, None))
        got = np.concatenate([arr[f"stream{i}_out"] for arr, _ in per_rank])
        np.testing.assert_allclose(got, one, atol=OUT_ATOL, rtol=0)
        assert got.tobytes() == fused.tobytes()


def test_checkpointed_calibration_restores_on_every_rank(group_run):
    """(h) Rank 0 wrote the calibration of step 2 (after its probe); a
    fresh calibrated session's trainer restores it on every rank."""
    per_rank, _ = group_run
    from repro_torch.checkpoint import ckpt
    tmp = Path(per_rank[0][1]["tmp"])
    saved = ckpt.read_meta(str(tmp / "ckpt"), TRAIN["ckpt_every"])
    want = json.dumps(saved["extra"]["calibration"], sort_keys=True)
    assert want == per_rank[0][1]["main"]["snaps"][TRAIN["ckpt_every"]]
    for _, meta in per_rank:
        assert meta["restored"] == want


def test_observe_server_and_plan_gather_across_ranks(group_run):
    """``observe_server`` and ``observe_plan`` are collectives: each rank
    passes its own timing, every rank feeds all of them, and the
    calibrators agree; ``observe`` (one rank's task) refuses the
    group."""
    per_rank, _ = group_run
    obs = [meta["observe"] for _, meta in per_rank]
    assert all(o["state"] == obs[0]["state"] for o in obs)
    assert obs[0]["n_obs"] >= 2 * WORLD
    assert all(o["refused"] and "observe_server" in o["refused"]
               for o in obs)


@pytest.mark.parametrize("executor", ["elastic", "fabric"])
def test_executors_refuse_a_group_session(group_run, executor):
    """(i) The elastic and fabric executors serve every server in one
    process, as the reference's do: a session over a group raises."""
    per_rank, _ = group_run
    for _, meta in per_rank:
        msg = meta["executors"][executor]
        assert msg is not None and "one process" in msg


def test_server_inputs_equal_build_server_inputs():
    """The probe's rank half builds server r's batch alone, bitwise the
    one-process probe's ``inputs[r]`` and ``plans_r[r]``."""
    b = _stream_layouts()[0]
    sess = CADSession.for_pipeline(_cfg(), PipelineConfig(**_pipe(
        STREAM["seq"], WORLD)), prefetch=0)
    plan = sess.plan(b["segment_ids"])[0]
    cad = D.CADContext(cfg=sess.cfg, jmax=sess.jmax)
    q, k, v = (torch.from_numpy(x) for x in _stream_qkv(0))
    pos = torch.from_numpy(np.where(b["segment_ids"] > 0, b["positions"],
                                    -1))
    inputs, plans_r = D.build_server_inputs(cad, plan, q, k, v, pos)
    for s in range(WORLD):
        got, row = D.server_inputs(cad, plan, q, k, v, pos, s)
        for a, w in zip(got, inputs[s]):
            assert a.shape == w.shape
            assert a.numpy().tobytes() == w.numpy().tobytes()
        assert sorted(row) == sorted(plans_r[s])
        assert all(torch.equal(row[f], plans_r[s][f]) for f in row)
