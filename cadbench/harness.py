"""The program side of a run: a cell's files read by name, the port's
training loop driven through warm-up, the compared steps and the timed
or traced window, and what it observed.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<mix>.json``).
The window drives ``repro_torch.train.trainer.train`` with a
``CADSession.for_pipeline`` session and the weights the benchmark draws
from the seed (``reference.weights``), passed in with ``model=``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from cadbench.frozen import data as fdata
from cadbench.frozen import trace as ftrace
from cadbench.reference.weights import make_weights, param_specs

ROOT = Path(__file__).resolve().parent

# what the configuration states beyond the shape: the port's layer kind,
# norm and activation that the reference computes
_FIXED = {"layer_pattern": ("global",), "norm": "rmsnorm",
          "activation": "silu", "use_rope": True, "post_norms": False,
          "scale_embed": False, "attn_logit_softcap": 0.0,
          "final_logit_softcap": 0.0, "qk_norm": False, "moe": None}
_SHAPE_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab_size", "tie_embeddings", "gated_mlp",
               "rope_theta")


def load_json(kind: str, name: str, root: Path = ROOT) -> Dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell's workload file with its configuration and traffic."""
    cell = load_json("workloads", name, root)
    cell["config_file"] = load_json("configs", cell["config"], root)
    cell["traffic_file"] = load_json("traffic", cell["traffic"], root)
    return cell


def traffic_config(cell: Dict) -> fdata.TrafficConfig:
    t, shape = cell["traffic_file"], cell["config_file"]["shape"]
    return fdata.TrafficConfig(
        distribution=t["distribution"], max_doc_len=t["max_doc_len"],
        seq_len=t["seq_len"], global_batch=t["rows"],
        vocab_size=shape["vocab_size"], seed=t["data_seed"],
        strategy=t.get("strategy", "fixed"))


def batches(cell: Dict, n: int) -> List[Dict]:
    """The first ``n`` batches of the cell's traffic, from the frozen
    generator."""
    gen = fdata.raw_batches(traffic_config(cell))
    return [next(gen) for _ in range(n)]


def model_config(cell: Dict):
    """The port's ModelConfig of the cell: the base arch with the
    configuration file's overrides, checked against its stated shape."""
    from repro_torch.configs import get_config
    conf = cell["config_file"]
    cfg = dataclasses.replace(get_config(conf["arch"]), **conf["overrides"])
    shape = conf["shape"]
    got = {k: getattr(cfg, k) for k in _SHAPE_KEYS}
    want = {k: shape[k] for k in _SHAPE_KEYS}
    fixed = {k: getattr(cfg, k) for k in _FIXED}
    dtype = (cfg.param_dtype, cfg.compute_dtype)
    if got != want or fixed != _FIXED or dtype != (shape["dtype"],) * 2:
        raise SystemExit(f"{conf['name']}: the port builds {got} {fixed} "
                         f"{dtype}, the configuration states {want} "
                         f"{_FIXED} {shape['dtype']}")
    return cfg


def build_model(cell: Dict, seed: int, device):
    """The port's Transformer with the seed's weights: built on the meta
    device, allocated on ``device`` and filled from ``make_weights``."""
    from repro_torch.models.model import Transformer
    cfg = model_config(cell)
    shape = cell["config_file"]["shape"]
    model = Transformer(cfg, device="meta")
    model.to_empty(device=device)
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = {n: s for n, s, _ in param_specs(shape)}
    if names != specs:
        raise SystemExit(f"the port's parameters {names} are not the "
                         f"configuration's {specs}")
    weights = make_weights(shape, seed, device, cfg.pdtype)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    del weights
    return cfg, model


class StopWindow(Exception):
    """Raised from ``on_step`` to end the loop; the loop's ``finally``
    closes the plan prefetcher."""


@dataclasses.dataclass
class Observed:
    """What one drive of the program saw: the compared steps' losses, the
    first gradient (on the host, f32) and its norms, the norms of the
    parameters' change, the step ends, each step's layer forwards and
    layer-0 batch, the window and its peak memory."""
    losses: List[float] = dataclasses.field(default_factory=list)
    grad_norm: float = float("nan")        # the program's, before the clip
    grad_total: float = float("nan")       # the same from the hooks
    grad_norms: Dict[str, float] = dataclasses.field(default_factory=dict)
    grad: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    change_norms: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_end: List[float] = dataclasses.field(default_factory=list)
    fwd_passes: List[int] = dataclasses.field(default_factory=list)
    seen: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    window_start: float = float("nan")
    window_steps: List[int] = dataclasses.field(default_factory=list)
    window_end: float = float("nan")
    peak_bytes: int = 0
    profile: object = None


def drive(cell: Dict, seed: int, device, *, seconds: float = 0.0,
          trace: bool = False) -> Observed:
    """Train the cell from the seed's weights: ``compare_steps`` steps
    (their loss, first gradient and the parameters' change are observed),
    then the window: with ``trace`` the profiled ``trace_steps`` steps,
    else whole steps until the next would end past ``seconds`` (none when
    ``seconds`` is 0)."""
    from repro_torch.cad.session import CADSession
    from repro_torch.data.pipeline import PipelineConfig
    import repro_torch.train.trainer as trainer

    cad, tr = cell["cad"], cell["train"]
    t = cell["traffic_file"]
    n_cmp = cell["compare_steps"]
    device = torch.device(device)
    cfg, model = build_model(cell, seed, device)
    pipe = PipelineConfig(
        distribution=t["distribution"], max_doc_len=t["max_doc_len"],
        seq_len=t["seq_len"], global_batch=t["rows"],
        n_ranks=cad["servers"], vocab_size=cfg.vocab_size,
        seed=t["data_seed"], strategy=t.get("strategy", "fixed"))
    session = CADSession.for_pipeline(
        cfg, pipe, tolerance=cad["tolerance"],
        plan_policy=cad["plan_policy"], prefetch=cad["prefetch"])
    tc = trainer.TrainConfig(steps=tr["steps"], peak_lr=tr["peak_lr"],
                             warmup=tr["warmup"],
                             weight_decay=tr["weight_decay"],
                             log_every=10 ** 9, ckpt_every=0)
    obs = Observed()
    first = {}
    shape = cell["config_file"]["shape"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def hook(layer, inputs):
        k = len(obs.step_end)
        while len(obs.fwd_passes) <= k:
            obs.fwd_passes.append(0)
        obs.fwd_passes[k] += 1
        if layer == 0 and k not in obs.seen:
            obs.seen[k] = (inputs["segment_ids"], inputs["positions"])

    def keep(name):
        """A tensor hook summing ``name``'s first-step gradient on the
        host in f32, whatever calls make it up."""
        def fn(g):
            g = g.detach().to("cpu", torch.float32, copy=True)
            if name in first:
                first[name] += g
            else:
                first[name] = g
        return fn

    def on_step(k, m):
        now = time.perf_counter()
        obs.step_end.append(now)
        obs.losses.append(float(m["loss"]))
        if k == 0:
            for h in hooks:
                h.remove()
            hooks.clear()
            obs.grad_norm = float(m["grad_norm"])
            obs.grad = dict(first)
            first.clear()
            # norms in f64: an f32 sum over 1e8 elements drifts
            obs.grad_norms = {
                n: float(torch.linalg.vector_norm(t, dtype=torch.float64))
                for n, t in obs.grad.items()}
            obs.grad_total = float(np.sqrt(sum(
                v * v for v in obs.grad_norms.values())))
        if k == n_cmp - 1:
            w0 = make_weights(shape, seed, device, cfg.pdtype)
            with torch.no_grad():
                obs.change_norms = {
                    n: float((p.float() - w0[n].float()).norm())
                    for n, p in model.named_parameters()}
            del w0
            if not seconds and not trace:
                raise StopWindow
            sync()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            if trace:
                from torch.profiler import ProfilerActivity, profile
                obs.profile = profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
                obs.profile.__enter__()
                ftrace.trace_lead_in(torch)
                sync()
            obs.window_start = time.perf_counter()
            return
        if k < n_cmp:
            return
        if trace:
            if k - n_cmp + 1 >= cell["trace_steps"]:
                sync()
                obs.window_end = time.perf_counter()
                obs.window_steps = list(range(n_cmp, k + 1))
                obs.profile.__exit__(None, None, None)
                raise StopWindow
            return
        if now - obs.window_start <= seconds:
            obs.window_steps.append(k)
            obs.window_end = now
            mean = (now - obs.window_start) / len(obs.window_steps)
            if now + mean - obs.window_start <= seconds:
                return
        raise StopWindow

    hooks = [p.register_hook(keep(n)) for n, p in model.named_parameters()]
    model.attn_hook = hook
    try:
        trainer.train(cfg, pipe, tc, model=model, session=session,
                      device=device, on_step=on_step)
    except StopWindow:
        pass
    finally:
        for h in hooks:
            h.remove()
        model.attn_hook = None
    sync()
    if device.type == "cuda":
        obs.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    obs.seen = {k: (s.cpu().numpy(), p.cpu().numpy())
                for k, (s, p) in obs.seen.items()}
    first.clear()
    del model, session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return obs


def batches_match(obs: Observed, expected: List[Dict]) -> Optional[str]:
    """None when every step's layer-0 segment ids and positions are the
    frozen generator's batch of that step, else what differs."""
    for k in range(len(obs.step_end)):
        if k not in obs.seen:
            return f"step {k}: layer 0 saw no batch"
        seg, pos = obs.seen[k]
        if not (np.array_equal(seg, expected[k]["segment_ids"])
                and np.array_equal(pos, expected[k]["positions"])):
            return f"step {k}: the port trained on another batch"
    return None
