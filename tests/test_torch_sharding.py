"""The port's sharding rules, exactly the reference's, with no process
group: ``make_rules`` for every registered arch on five meshes (a
FakeMesh, as ``tests/test_system_e2e.py:58`` makes one), ``param_placements``
against ``param_pspecs`` on every arch's reduced tree through the port's
parameter names, ``head_pad``, the per-rank heads of the reference's
``_pad_heads_for_tp`` on seeded numpy q/k/v, the stored layout (the
placements themselves, FSDP data axes included) and the FSDP dims a layer
gathers, a ``shard_params`` -> ``gather_params`` round trip (bitwise),
and what the model axis refuses."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import layers as JL
from repro.models import model as JM
from repro.parallel import ParallelContext as JCtx
from repro.parallel import head_pad as j_head_pad
from repro.parallel import make_rules as j_make_rules
from repro.parallel import param_pspecs
from repro_torch.configs import get_config
from repro_torch.models.convert import (_entries, gather_params,
                                        grid_placements, param_shapes,
                                        shard_model, shard_params,
                                        shard_shape)
from repro_torch.models.layers import tp_local_heads
from repro_torch.models.model import Transformer, check_grid
from repro_torch.parallel import (fsdp_dims, head_pad, make_rules,
                                  param_placements, sharded_over)
from test_torch_helpers import to_torch

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x2": (("data", "model"), (2, 2)),
          "4x1": (("data", "model"), (4, 1)),
          "1x4": (("data", "model"), (1, 4)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}
ARCHS = list_archs()


class FakeMesh:
    def __init__(self, names, shape):
        self.axis_names = names

        class _D:
            pass
        self.devices = _D()
        self.devices.shape = shape


def _sizes(mesh):
    return dict(zip(*MESHES[mesh]))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_equals_reference(arch, mesh):
    want = j_make_rules(FakeMesh(*MESHES[mesh]), jax_config(arch))
    got = make_rules(_sizes(mesh), get_config(arch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_make_rules_without_a_grid():
    cfg = get_config("llama3-8b")
    assert dataclasses.asdict(make_rules(None, cfg)) == \
        dataclasses.asdict(j_make_rules(None, jax_config("llama3-8b")))


@functools.lru_cache(maxsize=None)
def _reduced_shapes(arch):
    cfg = jax_config(arch).reduced()
    return cfg, jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_equal_reference_pspecs(arch, mesh):
    """Each port tensor's axes are the reference's spec of its leaf with
    the stacked layer dim left out (the reference never shards that
    dim)."""
    cfg_j, shapes = _reduced_shapes(arch)
    cfg = get_config(arch + "-reduced")
    rules_j = j_make_rules(FakeMesh(*MESHES[mesh]), cfg_j)
    specs = param_pspecs(cfg_j, shapes, rules_j, FakeMesh(*MESHES[mesh]))
    spec_of = {id(leaf): spec for leaf, spec in zip(
        jax.tree_util.tree_leaves(shapes),
        jax.tree_util.tree_leaves(specs,
                                  is_leaf=lambda x: isinstance(x, P)))}
    want = {}
    for key, leaf, g in _entries(shapes, cfg):
        spec = tuple(spec_of[id(leaf)])
        spec = spec + (None,) * (leaf.ndim - len(spec))
        if g is not None:
            assert spec[0] is None
            spec = spec[1:]
        want[key] = spec
    got = param_placements(cfg, {k: torch.empty(s, device="meta")
                                 for k, s in param_shapes(shapes, cfg)
                                 .items()},
                           make_rules(_sizes(mesh), cfg), _sizes(mesh))
    assert sorted(got) == sorted(want)
    for key, axes in got.items():
        assert tuple(P(*axes)) == want[key], key


@pytest.mark.parametrize("n_heads,model,want", [
    (40, 16, 48), (15, 16, 16), (20, 16, 32), (15, 2, 16), (32, 2, 32),
    (3, 2, 4), (40, 1, 40), (5, 4, 8)])
def test_head_pad_equals_reference(n_heads, model, want):
    assert head_pad(n_heads, model) == want
    mesh = FakeMesh(("data", "model"), (2, model))
    assert j_head_pad(n_heads, mesh) == want
    assert j_head_pad(n_heads, None) == n_heads
    assert head_pad(n_heads, 1) == n_heads


@pytest.mark.parametrize("hq,hkv,model", [(3, 1, 2), (15, 5, 2), (5, 5, 4),
                                          (4, 2, 2), (8, 2, 4), (6, 3, 4)])
def test_local_heads_are_the_reference_padded_heads(hq, hkv, model):
    """Each model rank's q/k/v (``tp_local_heads`` on its real q heads and
    its kv heads, or all kv heads where they do not split) are its slice
    of the reference's ``_pad_heads_for_tp`` output where that pads, and
    of q and MHA-ized kv where the heads split, bitwise."""
    rng = np.random.default_rng(hq * 100 + hkv * 10 + model)
    b, s, dh = 2, 8, 4
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for h in (hq, hkv, hkv))
    cfg = dataclasses.replace(get_config("smollm-360m-reduced"),
                              n_heads=hq, n_kv_heads=hkv, head_dim=dh)
    cfg_j = dataclasses.replace(jax_config("smollm-360m-reduced"),
                                n_heads=hq, n_kv_heads=hkv, head_dim=dh)
    mesh = FakeMesh(("data", "model"), (1, model))
    ctx = JCtx(mesh=mesh, rules=j_make_rules(mesh, cfg_j))
    jq, jk, jv, orig, padded = JL._pad_heads_for_tp(q, k, v, ctx)
    assert orig == hq and padded == (hq % model != 0)
    if not padded:          # q split; kv MHA-ized unless it splits too
        rep = hq // hkv
        jk, jv = np.repeat(jk, rep, axis=2), np.repeat(jv, rep, axis=2)
    per = np.asarray(jq).shape[2] // model
    rules = make_rules({"data": 1, "model": model}, cfg)
    kv_split = rules.kv_heads is not None
    for m in range(model):
        lo = m * per
        real = slice(lo, min(lo + per, hq))
        kv = slice(m * hkv // model, (m + 1) * hkv // model) if kv_split \
            else slice(None)
        got = tp_local_heads(to_torch(q[:, :, real]), to_torch(k[:, :, kv]),
                             to_torch(v[:, :, kv]), cfg, rules, model, m)
        if kv_split:        # local GQA: q heads are the reference's
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(jq)[:, :, lo:lo + per])
            np.testing.assert_array_equal(got[1].numpy(), k[:, :, kv])
            continue
        for g, w in zip(got, (jq, jk, jv)):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w)[:, :, lo:lo + per])


@pytest.mark.parametrize("arch,expert_parallel", [
    ("llama3-8b-reduced", False), ("smollm-360m-reduced", False),
    ("gemma2-2b-reduced", False), ("qwen2-moe-a2.7b-reduced", False),
    ("qwen2-moe-a2.7b-reduced", True),
    ("llama4-maverick-400b-a17b-reduced", True),
    ("mamba2-370m-reduced", False), ("recurrentgemma-9b-reduced", False),
    ("whisper-large-v3-reduced", False),
    ("llama-3.2-vision-11b-reduced", False)])
@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (4, 1)])
def test_shard_gather_round_trip_bitwise(arch, expert_parallel, grid):
    cfg = get_config(arch)
    if expert_parallel:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_parallel=True))
    sizes = dict(zip(("data", "model"), grid))
    gen = torch.Generator().manual_seed(0)
    full = {k: torch.randn(v.shape, generator=gen) for k, v in
            Transformer(cfg, device="meta").state_dict().items()}
    placed = grid_placements(cfg, full, sizes)
    parts = {(d, m): shard_params(full, placed, {"data": d, "model": m},
                                  sizes)
             for d in range(grid[0]) for m in range(grid[1])}
    back = gather_params(parts, placed, sizes)
    assert sorted(back) == sorted(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    # what is split: the model axis, and the data axis on the FSDP dims
    # of every tensor the dmodel rule reaches and on the experts' dim
    # under expert parallelism
    split = {a for axes in placed.values() for a in sharded_over(axes)}
    assert {a for a, n in sizes.items() if n > 1} <= split
    experts = [k for k in placed if ".moe.experts_" in k]
    assert all((placed[k][0] is not None) == expert_parallel
               for k in experts)
    if grid[0] > 1:
        assert any(fsdp_dims(k, a) for k, a in placed.items()
                   if k not in experts)


@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_stored_axes_equal_param_placements(arch, grid):
    """On a grid a tensor is stored as ``param_placements`` says, the
    FSDP data axes included: ``grid_placements`` is it, and
    ``shard_model`` (on the meta device: shapes only) leaves each tensor
    at its shard's shape and records those placements."""
    cfg = get_config(arch + "-reduced")
    sizes = dict(zip(("data", "model"), grid))
    model = Transformer(cfg, device="meta")
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = param_placements(cfg, dict(model.state_dict()),
                            make_rules(sizes, cfg), sizes)
    assert grid_placements(cfg, dict(model.state_dict()), sizes) == want
    placed = shard_model(model, sizes, {"data": grid[0] - 1,
                                        "model": grid[1] - 1})
    assert placed == want == model.grid_placements
    for k, p in model.named_parameters():
        assert tuple(p.shape) == shard_shape(full[k], want[k], sizes), k


@pytest.mark.parametrize("key,axes,want", [
    ("embed", ("model", ("data",)), (1,)),
    ("layers.0.attn.wq", (("data",), "model"), (0,)),
    ("layers.0.attn.wo", ("model", ("data",)), (1,)),
    ("layers.0.mixer.in_proj", (("data",), None), (0,)),
    ("layers.0.moe.experts_up", (None, ("data",), "model"), (1,)),
    ("layers.0.moe.experts_up", (("data",), None, "model"), ()),
    ("layers.0.norm1.scale", (None,), ())])
def test_fsdp_dims_are_the_data_dims_but_the_expert_dim(key, axes, want):
    """The dims a layer gathers over the data ranks: every dim a
    placement splits over ``"data"``, but an expert tensor's dim 0 (its
    experts, split by expert parallelism, stay apart)."""
    assert fsdp_dims(key, axes) == want


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "llama-3.2-vision-11b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("model_size", [2, 4])
def test_model_axis_splits_every_layer_kind(arch, model_size):
    """ssd, rglru, cross and enc layers split over a model axis: only a
    sequence, or an encoder's memory, that the axis does not divide is
    refused."""
    cfg = get_config(arch + "-reduced")
    check_grid(cfg, model_size, 256, 24)
    check_grid(cfg, 1, 256, 25)
    with pytest.raises(ValueError, match="does not split"):
        check_grid(cfg, model_size, 257, 24)
    if cfg.encoder and cfg.encoder.n_layers:
        with pytest.raises(ValueError, match="memory of 25 rows"):
            check_grid(cfg, model_size, 256, 25)


def test_model_axis_needs_a_sequence_it_divides():
    cfg = get_config("llama3-8b-reduced")
    check_grid(cfg, 2, 256)
    with pytest.raises(ValueError, match="does not split"):
        check_grid(cfg, 2, 255)
