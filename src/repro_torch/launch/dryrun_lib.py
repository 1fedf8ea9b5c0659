"""Dry-run library: build one rank's step of an (architecture x input
shape) on a process grid, run it on the ``meta`` device (shapes, no
memory) under the op counter, and report its bytes, FLOPs and
collectives.  The port of ``repro.launch.dryrun_lib``
(``src/repro/launch/dryrun_lib.py``).

The reference builds ``ShapeDtypeStruct`` s on the production mesh and
lowers and compiles the step without allocating.  A torch program has
no ahead-of-time form, so here the step itself runs, once, for rank 0 of
the grid: the model, its AdamW moments and the batch are meta tensors,
each the shard ``param_placements`` gives rank 0 (FSDP included), and
the grid's collectives go to a fake process group of ``prod(sizes)``
ranks (``torch.testing._internal.distributed.fake_pg``), which accepts
every collective and moves nothing.  ``launch.op_analysis`` counts what
runs.  The same :func:`build_step` builds the step on the card
(``device="cuda"``, one rank, no grid), where it allocates and computes:
``chip_smoke.py`` phase 32 and ``perf --measure`` hold the meta trace
against that run.

A CAD step takes the port's ``empty_plan`` (host arrays; the dispatch
reads a plan on the host, the activations are meta) and its servers run
the plain versions of the CA kernels (``ca_server_attention`` on meta
tensors), as the reference lowers its servers' ``xla`` route.
Attention takes the ``xla`` route with remat, as the reference's.

Decode shapes (``decode_32k``, ``long_500k``) raise ``NotImplementedError``:
the reference lowers them as a sharded serve step (its cache sequence
over ``model``), and the port's serving has no grid yet (ROADMAP queue 1
item 16, the grid decode step).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core.dispatch import CADContext
from repro_torch.core.plan import CADConfig, PingPongPlan, StepPlan, empty_plan
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models.convert import decay_mask, shard_model
from repro_torch.models.model import Transformer, resolve_device
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import ParallelContext, make_rules
from repro_torch.train.step import make_train_step

INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}

GRID_AXES = ("pod", "data", "model")
DECODE_TODO = ("a decode step on a process grid is not ported: the "
               "reference lowers decode_32k / long_500k as a sharded serve "
               "step (the cache sequence over 'model', partial attention "
               "merged across the model ranks); see ROADMAP queue 1 item "
               "16, the grid decode step")


def applicable(cfg, shape_name: str) -> Tuple[bool, str]:
    info = INPUT_SHAPES[shape_name]
    if info.get("long") and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500K decode requires a "
                       "sub-quadratic/windowed variant (DESIGN.md §6)")
    return True, ""


def production_sizes(multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh (``src/repro/launch/mesh.py``):
    16 x 16 ``("data", "model")``, or 2 x 16 x 16 with ``"pod"``."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def data_size(sizes: Optional[Mapping[str, int]]) -> int:
    """Ranks along the data axes (``"pod"`` and ``"data"``)."""
    return math.prod((sizes or {}).get(a, 1) for a in ("pod", "data"))


def grid_ranks(sizes: Mapping[str, int]):
    """(the data group's ranks, the model group's ranks) of rank 0 on a
    grid of ``sizes`` laid out row-major over ``("pod", "data",
    "model")``, as ``launch.mesh.join_grid`` lays out two axes: the data
    group holds the ranks of model index 0 over the pod and data axes (its
    CAD group), the model group data index 0's model ranks."""
    unknown = set(sizes) - set(GRID_AXES)
    if unknown:
        raise ValueError(f"unknown grid axes {sorted(unknown)}")
    m = sizes.get("model", 1)
    return [j * m for j in range(data_size(sizes))], list(range(m))


@contextlib.contextmanager
def fake_grid(sizes: Mapping[str, int]):
    """Rank 0 of a fake process group of ``prod(sizes)`` ranks, made the
    default group for the body and destroyed after it; yields (data
    group, model group).  Refuses to run where a default group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_grid: a default process group exists")
    world = math.prod(sizes.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        data_r, model_r = grid_ranks(sizes)
        yield dist.new_group(data_r), dist.new_group(model_r)
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Step:
    """One rank's step: ``fn(*args)`` runs it; the model, its AdamW state
    (None for a forward-only shape) and the batch are what it reads."""
    fn: Any
    args: Tuple
    model: Transformer
    opt_state: Any
    batch: Dict[str, Any]

    def argument_bytes(self) -> Dict[str, int]:
        """Bytes of the parameters, the AdamW moments and the batch
        tensors (this rank's shards), and their sum.  The plan is host
        arrays, made into tensors inside the step."""
        params = sum(p.nbytes for p in self.model.parameters())
        moments = 0 if self.opt_state is None else sum(
            t.nbytes for t in (*self.opt_state.mu, *self.opt_state.nu))
        batch = sum(v.nbytes for v in self.batch.values()
                    if torch.is_tensor(v))
        return dict(param_bytes=params, moment_bytes=moments,
                    batch_bytes=batch,
                    argument_bytes=params + moments + batch)


def make_batch(cfg, rows: int, seq: int, device, *, labels: bool = True,
               with_memory: bool = False, seed: int = 0) -> Dict[str, Any]:
    """A rank's batch of ``rows`` x ``seq`` tokens on ``device`` (and,
    ``with_memory``, a memory of the reference's length: the encoder's
    frames or 1601 patches): on meta shapes only; elsewhere one document a
    row, tokens and memory drawn from ``seed``, labels the next token (-1
    at the row's end)."""
    dev = torch.device(device)
    m = cfg.encoder.n_ctx if cfg.encoder else 1601
    if dev.type == "meta":
        out = {k: torch.empty((rows, seq), dtype=torch.int32, device=dev)
               for k in ("tokens", "labels", "segment_ids", "positions")}
        if with_memory:
            out["memory"] = torch.empty((rows, m, cfg.d_model), device=dev,
                                        dtype=cfg.cdtype)
    else:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        tok = torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen,
                            dtype=torch.int32)
        lab = torch.cat([tok[:, 1:], torch.full((rows, 1), -1,
                                                dtype=torch.int32)], 1)
        pos = torch.arange(seq, dtype=torch.int32).expand(rows, seq)
        out = {"tokens": tok, "labels": lab,
               "segment_ids": torch.ones((rows, seq), dtype=torch.int32),
               "positions": pos.contiguous()}
        if with_memory:
            out["memory"] = torch.randn((rows, m, cfg.d_model),
                                        generator=gen).to(cfg.cdtype)
        out = {k: v.to(dev) for k, v in out.items()}
    if not labels:
        out.pop("labels")
    return out


def _cad_setup(data_n: int, rows: int, seq: int, pingpong: bool):
    """``CADConfig.default`` and an empty plan for ``data_n`` servers, as
    the reference's ``cad_setup`` (``dryrun_lib.py:123-146``)."""
    tokens_per_rank = rows * seq
    if pingpong:
        tokens_per_rank //= 2   # per nano-batch
    blk = 128
    # capacity rule: per-pair caps >= max-doc blocks; docs never span a
    # row -> max doc = one row of `seq` tokens
    cadcfg = CADConfig.default(data_n, tokens_per_rank, blk=blk,
                               max_doc_tokens=seq)
    jmax = max(1, seq // blk)
    plan = StepPlan(**empty_plan(cadcfg))
    return cadcfg, (PingPongPlan(plan, plan) if pingpong else plan), jmax


def build_step(cfg, sizes: Optional[Mapping[str, int]], shape, *,
               cad: bool = False, pingpong: bool = False,
               device="meta", groups=None, seed: int = 0) -> Step:
    """One rank's step of ``cfg`` at ``shape`` (a name of
    :data:`INPUT_SHAPES` or a dict like its values) on a grid of
    ``sizes`` (axes of ``("pod", "data", "model")``; None: one rank, no
    process group) on ``device``.  ``groups`` is (data group, model group)
    of the grid (``fake_grid``); the batch is the data rank's rows
    (``batch / (pod x data)``), every model rank holding them whole, as
    the port's grid trains.  A train shape's step is ``make_train_step``
    (forward, backward with remat, gradient sums, AdamW) on (AdamW state,
    batch); a prefill shape's is the forward without gradients, the last
    position's logits."""
    info = dict(INPUT_SHAPES[shape] if isinstance(shape, str) else shape)
    if info["kind"] == "decode":
        raise NotImplementedError(DECODE_TODO)
    dev = resolve_device(device)
    data_n = data_size(sizes)
    if info["batch"] % data_n:
        raise ValueError(f"a batch of {info['batch']} rows does not split "
                         f"over {data_n} data ranks")
    rows, seq = info["batch"] // data_n, info["seq"]
    if sizes and groups is None:
        raise ValueError("a grid's step needs its (data, model) groups")
    data_g, model_g = groups if sizes else (None, None)
    rules = make_rules(sizes, cfg)
    ctx = ParallelContext(attn_impl="xla", remat=True, group=data_g,
                          model_group=model_g, rules=rules)
    model = Transformer(cfg, device=dev, seed=seed)
    if sizes:
        shard_model(model, sizes, {a: 0 for a in sizes})
    train = info["kind"] == "train"
    batch = make_batch(cfg, rows, seq, dev, labels=train,
                       with_memory=cfg.family in ("vlm", "audio"), seed=seed)
    if not train:
        def prefill_step(b):
            with torch.no_grad():
                logits, _ = model(b, ctx)
            return logits[:, -1:, :]
        return Step(prefill_step, (batch,), model, None, batch)
    step_batch = dict(batch, n_tokens_global=info["batch"] * seq)
    if cad:
        cadcfg, step_batch["plan"], jmax = _cad_setup(data_n, rows, seq,
                                                      pingpong)
        ctx = dataclasses.replace(ctx, attn_impl="cad", cad=CADContext(
            cfg=cadcfg, jmax=jmax, pingpong=pingpong))
    opt = AdamW()
    opt_state = opt.init(list(model.parameters()))
    fn = make_train_step(model, ctx, opt, decay_mask(model))
    return Step(fn, (opt_state, step_batch), model, opt_state, batch)


def arch_config(arch: str, layers: Optional[int] = None):
    """``arch``'s config, its depth cut to ``layers`` when given."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def analyze_step(step: Step):
    """Run ``step`` once under the op counter: (its ``OpCost``, seconds,
    what it returned)."""
    counter = OpCounter()
    t0 = time.perf_counter()
    with counter:
        result = step.fn(*step.args)
    return counter.cost(result), time.perf_counter() - t0, result


def run_dryrun(arch: str, shape_name, sizes: Optional[Mapping[str, int]],
               *, cad: bool = False, pingpong: bool = False,
               layers: Optional[int] = None) -> Dict[str, Any]:
    """Build and trace one combination on meta; return its record: the
    reference's keys (``compile_s`` as ``trace_s``, no ``lower_s``, no
    ``xla_*``), all bytes per rank, plus the argument bytes' parts, the
    FLOPs and bytes by bucket, the collective bytes by site and the
    depth.  ``sizes`` None traces one rank without a process group."""
    cfg = arch_config(arch, layers)
    name = shape_name if isinstance(shape_name, str) else "custom"
    if isinstance(shape_name, str):
        ok, why = applicable(cfg, shape_name)
        if not ok:
            return {"arch": arch, "shape": name, "skipped": True,
                    "reason": why}
    t0 = time.perf_counter()
    grid = fake_grid(sizes) if sizes else contextlib.nullcontext()
    with grid as groups:
        step = build_step(cfg, sizes, shape_name, cad=cad,
                          pingpong=pingpong, device="meta", groups=groups)
        build_s = time.perf_counter() - t0
        cost, trace_s, _ = analyze_step(step)
        arg = step.argument_bytes()
    mesh = list(sizes.values()) if sizes else [1]
    return {
        "arch": arch, "shape": name, "cad": cad, "pingpong": pingpong,
        "skipped": False, "n_devices": int(math.prod(mesh)), "mesh": mesh,
        "axes": list(sizes) if sizes else [], "layers": cfg.n_layers,
        "build_s": round(build_s, 2), "trace_s": round(trace_s, 2),
        "n_ops": cost.n_ops,
        **{k: float(v) for k, v in arg.items()},
        "output_bytes": cost.output_bytes,
        "temp_bytes": cost.temp_bytes,
        "peak_bytes": arg["argument_bytes"] + cost.temp_bytes
        + cost.output_bytes,
        "hlo_flops_per_device": cost.flops,
        "hlo_bytes_per_device": cost.hbm_bytes,
        "collective_bytes_per_device": cost.collective_bytes,
        "collective_counts": cost.collective_counts,
        "collective_breakdown": cost.collective_breakdown,
        "flops_by_bucket": cost.flops_by_bucket,
        "bytes_by_bucket": cost.bytes_by_bucket,
        "collective_by_site": cost.collective_by_site,
    }
