"""The port's decode step on a process grid (``parallel.decode_rules``,
``cache_placements``, ``Transformer.init_cache(..., ctx=)`` and
``decode_step(..., ctx)``) against its one-process ``decode_step`` and
against the reference's ``decode_step`` jitted on a (2, 2) mesh of fake
XLA devices.

Rules and placements, no process group: for every registered arch
(reduced) on (2, 2), (1, 4) and (4, 1), in both layouts, ``decode_rules``
equals the reference's replacements in ``repro.launch.dryrun_lib.
build_step`` (copied below as ``ref_decode_rules``) but where the
reference's ``long`` branch keeps ``kv_heads`` on ``"model"``: the port's
yields it to the sequence; ``param_placements`` under those rules equals
the reference's ``param_pspecs`` under the same rules, and
``cache_placements`` the reference's ``_cache_pspecs``.

The grid (one spawn of 4 gloo processes for the module, beside one
subprocess running the reference): reduced configs, a cache of S = 128
positions (a local ring of 64) filled from a seed up to position P0 =
100 (numpy k/v, states and ``kv_pos`` written into the whole cache, each
rank taking its shard), then STEPS decode steps of B = 4 rows (``long``:
1 row).  Cases: smollm-360m with 3 q heads over 1 kv head (padded to 4
over the model ranks), gemma2-2b (a ring and a global cache, softcaps)
in both layouts, and again in both filled only to position 20 (EARLY:
some ranks' slices hold no visible slot, so their partials are dead and
merge beside live ones), qwen2-moe expert-parallel (``no_drop``), whisper
(cross layers, the encoder run on the grid), mamba2 and recurrentgemma
in the ``long`` layout, on 2 x 2 and, for ``long``, 1 x 4.  Held: every
rank's f32 logits of its rows within ONE_PROCESS_REL x their std of the
one-process ``decode_step`` on the same weights and cache, next tokens
equal; ``init_cache(..., ctx)`` the shapes of the shard (and a cross
layer's ``xk``/``xv`` as the whole cache's); the early fills leaving
some ranks' slices empty and others not; for gemma2 (filled to P0 and
to 20), qwen2-moe and whisper (``decode_32k`` layout) and recurrentgemma
(``long``) on (2, 2), the logits within REF_REL x std of the reference's
mesh and every cache leaf's bytes on a rank equal to the reference's
shard of that leaf; and
the reference's ``long_500k`` ``build_step`` of gemma2-2b-reduced on
(2, 2) still raising ``DuplicateSpecError`` (ROADMAP queue 3).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.launch import dryrun_lib as RD
from repro.models import model as JM
from repro.parallel import ShardingRules as JRules
from repro.parallel import make_rules as j_make_rules
from repro.parallel import param_pspecs
from repro_torch.configs import get_config
from repro_torch.models.convert import _entries, param_shapes, params_from_jax
from repro_torch.models.model import Transformer, decode_cache_shapes
from repro_torch.parallel import (cache_placements, decode_rules, make_rules,
                                  param_placements)
from test_torch_helpers import params_to_numpy
from test_torch_sharding import FakeMesh

ROOT = Path(__file__).resolve().parents[1]
B, S, P0, STEPS = 4, 128, 100, 4
# case -> (variant, layout, grid (data, model))
CASES = {"smollm3": ("smollm3", "decode", (2, 2)),
         "gemma2": ("gemma2", "decode", (2, 2)),
         "gemma2_long": ("gemma2", "long", (2, 2)),
         "gemma2_long_1x4": ("gemma2", "long", (1, 4)),
         "moe_ep": ("moe_ep", "decode", (2, 2)),
         "whisper": ("whisper", "decode", (2, 2)),
         "mamba2_long": ("mamba2", "long", (2, 2)),
         "rgemma_long": ("rgemma", "long", (2, 2)),
         "rgemma_long_1x4": ("rgemma", "long", (1, 4)),
         "gemma2_early": ("gemma2", "decode", (2, 2)),
         "gemma2_long_early": ("gemma2", "long", (2, 2))}
# case -> its fill where it is not P0: early in the cache, so that some
# ranks' slices hold no visible slot beside ranks whose slices do (the
# global cache's second half on the model ranks, the last three quarters
# on the ``long`` layout's four; half the ring, and half of it again)
EARLY = {"gemma2_early": 20, "gemma2_long_early": 20}
REF_CASES = ("gemma2", "moe_ep", "whisper", "rgemma_long", "gemma2_early")
GRIDS = ((2, 2), (1, 4))
REDUCED = {"gemma2": "gemma2-2b-reduced", "moe_ep": "qwen2-moe-a2.7b-reduced",
           "whisper": "whisper-large-v3-reduced",
           "mamba2": "mamba2-370m-reduced",
           "rgemma": "recurrentgemma-9b-reduced"}
XGATE = 0.5
# f32, max |diff| over the std of the one-process logits.  The grid sums
# the model ranks' partial products (heads, FFN columns, vocab shards)
# and merges the ranks' softmax partials by their lse, in another order
# than one process.  Measured on the CPU: at most 4.2e-6 (smollm3 on 2 x
# 2); the one-process step itself, run on one row per rank of a 4 x 1
# grid (nothing split but the rows), sits 5.2e-6 from its run on all 4
# rows (BLAS blocks a row and four rows apart), so f32 cannot give 1e-6
ONE_PROCESS_REL = 2e-5
# against the reference's mesh: two frameworks' reduction orders besides
REF_REL = 5e-5


def variant(get, name):
    """The config ``name`` from either package's ``get_config``."""
    if name == "smollm3":
        return dataclasses.replace(get("smollm-360m-reduced"), n_heads=3,
                                   n_kv_heads=1, head_dim=64)
    c = get(REDUCED[name])
    if name == "moe_ep":
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, expert_parallel=True))
    return c


def ref_decode_rules(rules, axis_names, long):
    """The reference's replacements of ``make_rules``' output for a decode
    shape (``src/repro/launch/dryrun_lib.py:154-171``)."""
    if long:
        axes = tuple(a for a in ("pod", "data") if a in axis_names)
        seq_axes = axes + (("model",) if "model" in axis_names else ())
        return dataclasses.replace(rules, batch=None, seq=seq_axes,
                                   residual_seq=None)
    has_model = "model" in axis_names
    return dataclasses.replace(
        rules, seq="model" if has_model else None,
        kv_heads=None if has_model else rules.kv_heads, residual_seq=None)


def p0_of(case):
    """The position ``case``'s cache is filled up to."""
    return EARLY.get(case, P0)


def rows_of(case, rank):
    """The rows of the B-row batch that grid rank ``rank`` decodes."""
    _, layout, (d, m) = CASES[case]
    if layout == "long":
        return slice(0, 1)
    di = rank // m
    return slice(di * B // d, (di + 1) * B // d)


def inputs(cfg, seed=5):
    """Tokens [B, STEPS] and, for an arch that reads one, a memory [B, M,
    D] (M the encoder's n_ctx, else 16)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    mem = None
    if cfg.encoder or cfg.family == "vlm":
        m = cfg.encoder.n_ctx if cfg.encoder else 16
        mem = (0.02 * (rng.standard_normal((B, 1, cfg.d_model))
                       + rng.standard_normal((B, m, cfg.d_model)))) \
            .astype(np.float32)
    return toks, mem


# ------------------------------------------------ partials and the merge
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 30.0)])
def test_partials_with_empty_slices_merge_to_decode_attention(window,
                                                              softcap):
    """``decode_attention_partial`` over four slices of a cache, merged by
    ``merge_decode_partials``, equals ``decode_attention`` over the whole
    cache, in f32 within 1e-6 (the merge's reordered sums).  Row 0 sees
    positions 0-19 only (slices 2 and 3 empty, slice 1 partly live); row
    1 sees 0-40 (under the window of 24, slice 0 holds nothing visible);
    row 2 sees nothing.  An empty slice's partial is out 0 and lse
    ``LSE_DEAD``; the merged lse is the whole cache's; a row empty in
    every slice merges to out 0 and lse ``LSE_DEAD``."""
    from repro_torch.core.attention import (LSE_DEAD, decode_attention,
                                            decode_attention_partial,
                                            merge_decode_partials)
    rng = np.random.default_rng(0)
    b, hq, hkv, dh, s, n = 3, 4, 2, 16, 48, 4
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, dh))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, dh))
                             .astype(np.float32)) for _ in range(2))
    held = [20, 41, 0]
    pos_kv = torch.tensor([[i if i < h else -1 for i in range(s)]
                           for h in held], dtype=torch.int32)
    pos_q = torch.tensor([[19], [40], [0]], dtype=torch.int32)
    opts = dict(window=window, softcap=softcap)
    want = decode_attention(q, k, v, pos_kv >= 0, pos_q, pos_kv, **opts)
    _, lse_whole = decode_attention_partial(q, k, v, pos_kv >= 0, pos_q,
                                            pos_kv, **opts)
    per = s // n
    parts = [decode_attention_partial(
        q, k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per],
        pos_kv[:, i * per:(i + 1) * per] >= 0, pos_q,
        pos_kv[:, i * per:(i + 1) * per], **opts) for i in range(n)]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([lse for _, lse in parts])
    empty = [(0, 2), (0, 3), (2, 0), (2, 1), (2, 2), (2, 3)]
    if window:
        empty.append((1, 0))
    for row, i in empty:
        assert bool((outs[i, row] == 0).all()), (row, i)
        assert bool((lses[i, row] == LSE_DEAD).all()), (row, i)
    assert bool((lses[:, 0] < LSE_DEAD / 2).any(0).all())
    got, lse = merge_decode_partials(outs, lses)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((lse[:2] - lse_whole[:2]).abs().max()) <= 1e-6
    assert bool((got[2] == 0).all()) and bool((lse[2] == LSE_DEAD).all())
    assert bool((lse_whole[2] == LSE_DEAD).all())


# ------------------------------------------------- rules and placements
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}


def _ref_specs(tree, specs):
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))):
        spec = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
        out[jax.tree_util.keystr(path)] = spec
    return out


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, long):
    """The reference's reduced param tree and decode cache (B rows, or 1
    for ``long``, S positions; a memory of the encoder's n_ctx or 16
    rows), as shapes."""
    from repro.parallel import ParallelContext as JCtx
    cfg = jax_config(arch).reduced()
    shapes = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), cfg))
    b = 1 if long else B
    mem = None
    if cfg.encoder or cfg.family == "vlm":
        m = cfg.encoder.n_ctx if cfg.encoder else 16
        mem = jax.ShapeDtypeStruct((b, m, cfg.d_model), cfg.cdtype)
    cshapes = jax.eval_shape(lambda p, mm: JM.init_cache(
        p, cfg, b, S, memory=mm, ctx=JCtx(attn_impl="xla", remat=False)),
        shapes, mem)
    return shapes, cshapes


@pytest.mark.parametrize("layout", ["decode", "long"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_decode_rules_and_placements_match_reference(arch, mesh, layout):
    long = layout == "long"
    fake = FakeMesh(("data", "model"), MESHES[mesh])
    sizes = dict(zip(("data", "model"), MESHES[mesh]))
    cfg_j = jax_config(arch).reduced()
    cfg = get_config(arch + "-reduced")
    rules = decode_rules(make_rules(sizes, cfg), sizes, long)
    want = dataclasses.asdict(ref_decode_rules(j_make_rules(fake, cfg_j),
                                               fake.axis_names, long))
    got = dataclasses.asdict(rules)
    if long:
        # the port's one departure: kv_heads yields to the sequence
        assert got.pop("kv_heads") is None
        want.pop("kv_heads")
    assert got == want
    # parameters: the reference's param_pspecs under the same rules
    rules_j = JRules(**dataclasses.asdict(rules))
    shapes, cshapes = _ref_shapes(arch, long)
    spec_of = {id(leaf): spec for leaf, spec in zip(
        jax.tree_util.tree_leaves(shapes),
        jax.tree_util.tree_leaves(param_pspecs(cfg_j, shapes, rules_j, fake),
                                  is_leaf=lambda x: isinstance(x, P)))}
    placed = param_placements(cfg, {k: torch.empty(s, device="meta") for k, s
                                    in param_shapes(shapes, cfg).items()},
                              rules, sizes)
    for key, leaf, g in _entries(shapes, cfg):
        spec = tuple(spec_of[id(leaf)])
        spec = spec + (None,) * (leaf.ndim - len(spec))
        assert tuple(P(*placed[key])) == (spec if g is None else spec[1:]), \
            key
    # the cache: the reference's _cache_pspecs under the same rules
    want = _ref_specs(cshapes, RD._cache_pspecs(cfg_j, cshapes, rules_j))
    xk = [slot["xk"] for slot in cshapes["slots"] if "xk" in slot]
    port = decode_cache_shapes(cfg, 1 if long else B, S,
                               xk[0].shape[2] if xk else 0)
    got = cache_placements(cfg, {"slots": [{n: shp for n, (shp, _) in
                                            slot.items()}
                                           for slot in port["slots"]]},
                           rules, sizes)
    for li, slot in enumerate(got["slots"]):
        g, si = divmod(li, cfg.period)
        for name, axes in slot.items():
            ref = want[f"['slots'][{si}]['{name}']"]
            assert ref[0] is None
            assert tuple(P(*axes)) == ref[1:], (li, name)


# --------------------------------------------------------------- the grid
REF_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import get_config
from repro.launch import dryrun_lib as RD
from repro.models import model as M
from repro.parallel import ParallelContext, make_rules, param_pspecs
from repro.train.step import make_serve_step
from test_torch_grid_decode import (CASES, REF_CASES, gate_open, p0_of,
                                    ref_decode_rules, variant)

tmp = sys.argv[1]
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for case in REF_CASES:
    name, layout, _ = CASES[case]
    cfg = variant(get_config, name)
    rules = ref_decode_rules(make_rules(mesh, cfg), mesh.axis_names,
                             layout == "long")
    ctx = ParallelContext(mesh=mesh, rules=rules, attn_impl="xla",
                          remat=False)
    params = gate_open(M.init(jax.random.PRNGKey(0), cfg))
    specs = param_pspecs(cfg, params, rules, mesh)
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)
    z = np.load(os.path.join(tmp, case + "_ref.npz"))
    cache = {"slots": tuple(
        {k.split("/")[1]: jnp.asarray(z[k]) for k in z.files
         if k.startswith(f"{si}/")} for si in range(cfg.period))}
    cspecs = RD._cache_pspecs(cfg, cache, rules)
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache, cspecs)
    for si, slot in enumerate(cache["slots"]):
        for k, x in slot.items():
            out[f"{case}/bytes/{si}/{k}"] = np.asarray(
                x.addressable_shards[0].data.nbytes)
    rows = NamedSharding(mesh, P(rules.batch, None))
    prow = NamedSharding(mesh, P(rules.batch))
    toks = z["tokens"]
    step = jax.jit(make_serve_step(cfg, ctx))
    got = []
    for t in range(toks.shape[1]):
        tok = jax.device_put(jnp.asarray(toks[:, t:t + 1]), rows)
        pos = jax.device_put(
            jnp.full((toks.shape[0],), p0_of(case) + t, jnp.int32), prow)
        _, lg, cache = step(params, cache, tok, pos)
        got.append(np.asarray(lg[:, 0]))
    out[case + "/logits"] = np.stack(got, 1)
try:
    RD.build_step(get_config("gemma2-2b").reduced(), mesh, "long_500k")
    out["long_500k_error"] = np.asarray("none")
except Exception as e:
    out["long_500k_error"] = np.asarray(type(e).__name__)
np.savez(os.path.join(tmp, "ref.npz"), **out)
'''

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _groups(rank, d, m):
    """(data group, model group, data index, model index) of ``rank`` on a
    d x m grid of the 4 ranks (every rank makes every group, in order)."""
    out = {}
    for di in range(d):
        g = dist.new_group([di * m + j for j in range(m)])
        if rank // m == di:
            out["model"] = g
    for mj in range(m):
        g = dist.new_group([di * m + mj for di in range(d)])
        if rank % m == mj:
            out["data"] = g
    return out["data"], out["model"], rank // m, rank % m


def worker(rank, tmp):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh
    from repro_torch.models.convert import shard_model
    from repro_torch.models.model import Transformer, cache_shard
    from repro_torch.parallel import ParallelContext, decode_rules, make_rules
    from repro_torch.train.step import make_serve_step
    cases, grids, max_seq = torch.load(os.path.join(tmp, "cases.pt"),
                                       weights_only=False)
    mesh.join_group("cpu", rank=rank, world=4,
                    init_method="file://" + os.path.join(tmp, "store"),
                    timeout_s=120)
    groups = {grid: _groups(rank, *grid) for grid in grids}
    res = {}
    for case, (cfg, layout, grid, rows, p0) in cases.items():
        data_g, model_g, di, mi = groups[grid]
        sizes = {"data": grid[0], "model": grid[1]}
        rules = decode_rules(make_rules(sizes, cfg), sizes, layout == "long")
        state, whole, toks, mem = torch.load(os.path.join(tmp, case + ".pt"))
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(state)
        shard_model(model, sizes, {"data": di, "model": mi}, rules=rules)
        ctx = ParallelContext(attn_impl="xla", remat=False, group=data_g,
                              model_group=model_g, rules=rules)
        cache = cache_shard(cfg, whole, ctx)
        rows = rows[rank]
        fresh = model.init_cache(toks.shape[0], max_seq, layout="decode",
                                 ctx=ctx,
                                 memory=None if mem is None else mem[rows])
        shapes_ok = all(
            fresh["slots"][li][k].shape == cache["slots"][li][k].shape
            for li in range(cfg.n_layers) for k in cache["slots"][li])
        res[case + "/shapes_ok"] = np.asarray(shapes_ok)
        gap = [float((fresh["slots"][li][k] - cache["slots"][li][k])
                     .abs().max())
               for li in range(cfg.n_layers) for k in ("xk", "xv")
               if k in cache["slots"][li]]
        res[case + "/xkv_gap"] = np.asarray(max(gap) if gap else 0.0)
        for li, slot in enumerate(cache["slots"]):
            for k, x in slot.items():
                res[f"{case}/bytes/{li}/{k}"] = np.asarray(x.nbytes)
        res[case + "/live"] = np.asarray(
            [int((slot["kv_pos"] >= 0).sum()) if "kv_pos" in slot else -1
             for slot in cache["slots"]])
        step = make_serve_step(model, ctx)
        got = []
        for t in range(toks.shape[1]):
            n = rows.stop - rows.start
            _, lg = step(cache, toks[rows, t:t + 1],
                         torch.full((n,), p0 + t, dtype=torch.int32))
            got.append(lg[:, 0])
        res[case + "/logits"] = torch.stack(got, 1).numpy()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    dist.barrier()
    mesh.leave_group()


if __name__ == "__main__":
    # the grid meets in a file store under the test's directory: no port
    mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
'''


def gate_open(params):
    """The reference's param pytree with every cross layer's ``xgate`` at
    XGATE (0 at init would hide the cross layers)."""
    blocks = tuple(
        dict(slot, attn=dict(slot["attn"],
                             xgate=slot["attn"]["xgate"] * 0 + XGATE))
        if "xgate" in slot.get("attn", {}) else slot
        for slot in params["blocks"])
    return dict(params, blocks=blocks)


def _fill(model, cfg, b, memory, p0, seed=3):
    """The whole one-process cache of ``b`` rows filled up to position p0:
    seeded k/v and recurrent states (x 0.5), ``kv_pos`` the positions each
    slot holds (a ring the window before p0), ``xk``/``xv`` from the
    memory."""
    cache = model.init_cache(b, S, layout="decode", memory=memory)
    rng = np.random.default_rng(seed)
    for blk, slot in zip(model.layers, cache["slots"]):
        for name, t in slot.items():
            if name in ("xk", "xv"):
                continue
            if name == "kv_pos":
                n = t.shape[1]
                held = np.where(np.arange(n) < p0, np.arange(n), -1)
                if blk.kind == "local":
                    held = np.full(n, -1)
                    for p in range(max(0, p0 - n), p0):
                        held[p % n] = p
                t.copy_(torch.from_numpy(np.tile(held, (b, 1))
                                         .astype(np.int32)))
            else:
                t.copy_(torch.from_numpy(
                    (0.5 * rng.standard_normal(t.shape)).astype(np.float32)))
    return cache


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The one-process runs, then the 4-rank grid and the reference's mesh
    at once; returns (one-process logits by case, every rank's arrays,
    the reference's arrays)."""
    tmp = tmp_path_factory.mktemp("grid_decode")
    want, states = {}, {}
    for case, (name, layout, grid) in CASES.items():
        cfg = variant(get_config, name)
        if name not in states:
            params = gate_open(JM.init(jax.random.PRNGKey(0),
                                       variant(jax_config, name)))
            states[name] = params_from_jax(params_to_numpy(params), cfg)
        state = states[name]
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(state)
        toks, mem = inputs(cfg)
        b = 1 if layout == "long" else B
        memory = None if mem is None else torch.from_numpy(mem[:b])
        cache = _fill(model, cfg, b, memory, p0_of(case))
        whole = {"slots": [{k: v.clone() for k, v in slot.items()}
                           for slot in cache["slots"]]}
        toks_t = torch.from_numpy(toks[:b])
        torch.save((state, whole, toks_t, memory), tmp / f"{case}.pt")
        if case in REF_CASES:
            ref = {"tokens": toks[:b]}
            for si in range(cfg.period):
                for k in whole["slots"][si]:
                    ref[f"{si}/{k}"] = np.stack(
                        [whole["slots"][li][k].numpy()
                         for li in range(si, cfg.n_layers, cfg.period)])
            np.savez(tmp / f"{case}_ref.npz", **ref)
        got = []
        with torch.no_grad():
            for t in range(STEPS):
                got.append(model.decode_step(
                    cache, toks_t[:, t:t + 1],
                    torch.full((b,), p0_of(case) + t,
                               dtype=torch.int32))[:, 0])
        want[case] = torch.stack(got, 1).numpy()
    torch.save(({case: (variant(get_config, name), layout, grid,
                        [rows_of(case, r) for r in range(4)], p0_of(case))
                 for case, (name, layout, grid) in CASES.items()},
                GRIDS, S), tmp / "cases.pt")
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
    ranks = []
    for r in range(4):
        with np.load(tmp / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    with np.load(tmp / "ref.npz") as z:
        ref = dict(z)
    return want, ranks, ref


def _rel(got, want):
    return float(np.abs(got - want).max() / want.std())


@pytest.mark.parametrize("case", CASES)
def test_grid_decode_matches_one_process(grid, case):
    want, ranks, _ = grid
    for r, arrays in enumerate(ranks):
        w = want[case][rows_of(case, r)]
        got = arrays[case + "/logits"]
        assert got.shape == w.shape
        assert _rel(got, w) <= ONE_PROCESS_REL, (r, _rel(got, w))
        np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("case", CASES)
def test_grid_cache_init_gives_the_shard(grid, case):
    """``init_cache(..., ctx)`` makes every leaf in the shape of the whole
    cache's shard, and a cross layer's ``xk``/``xv`` (the memory through
    the encoder on the grid) equal to the whole cache's rows."""
    _, ranks, _ = grid
    for arrays in ranks:
        assert bool(arrays[case + "/shapes_ok"])
        assert float(arrays[case + "/xkv_gap"]) < 1e-5


@pytest.mark.parametrize("case", EARLY)
def test_early_fill_leaves_some_slices_empty(grid, case):
    """Filled to EARLY[case], every attention layer's cache (the ring as
    the global one) has a rank whose slice holds no visible slot beside a
    rank whose slice does, so dead partials merge beside live ones."""
    _, ranks, _ = grid
    live = np.stack([arrays[case + "/live"] for arrays in ranks])
    attn = live[0] >= 0
    assert attn.any()
    assert (live[:, attn].min(0) == 0).all(), live
    assert (live[:, attn].max(0) > 0).all(), live


@pytest.mark.parametrize("case", REF_CASES)
def test_grid_decode_matches_reference_mesh(grid, case):
    _, ranks, ref = grid
    for r, arrays in enumerate(ranks):
        w = ref[case + "/logits"][rows_of(case, r)]
        got = arrays[case + "/logits"]
        assert _rel(got, w) <= REF_REL, (r, _rel(got, w))
        np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("case", REF_CASES)
def test_grid_cache_bytes_match_reference_shards(grid, case):
    """Each leaf's bytes on a rank are the reference's shard of that leaf
    (its layers stacked on the group dim: the port's layers of the slot
    summed)."""
    _, ranks, ref = grid
    cfg = variant(get_config, CASES[case][0])
    for arrays in ranks:
        for si in range(cfg.period):
            for key in [k for k in ref if k.startswith(f"{case}/bytes/{si}/")]:
                name = key.rsplit("/", 1)[1]
                mine = sum(int(arrays[f"{case}/bytes/{li}/{name}"])
                           for li in range(si, cfg.n_layers, cfg.period))
                assert mine == int(ref[key]), key


def test_reference_long_500k_names_model_twice(grid):
    """The reference's fault that ``decode_rules`` departs from: its
    ``long_500k`` rules keep ``kv_heads`` on ``"model"`` beside the
    sequence, so gemma2-2b-reduced (4 kv heads) on (2, 2) raises."""
    _, _, ref = grid
    assert str(ref["long_500k_error"]) == "DuplicateSpecError"
