"""Carry the JAX package's parameters across to the port.

``params_from_jax`` takes the reference's param pytree as numpy arrays
(``embed``, ``unembed``, ``final_norm`` and ``blocks``: a tuple of slot
dicts whose leaves carry a leading ``[n_groups]`` axis; with an encoder
also ``enc_blocks``, one slot dict stacked on ``[n_enc_layers]``, and
``enc_final_norm``) and returns a ``state_dict`` for
``model.Transformer``.  Layer ``l`` is slot ``l % period`` of group
``l // period``; encoder layer ``i`` is ``enc_blocks[.][i]``.  A cross
layer's 0-d ``xgate`` is its group's entry of a ``[n_groups]`` leaf.
Weights keep the reference's
``[in, out]`` layout, which the port applies as ``h @ W``: nothing is
transposed, here or in the hot path.

``decay_mask`` says which of a ``Transformer``'s parameters the
reference's AdamW decays, a rule it states on the stacked layout.

``shard_params`` cuts a state_dict into one grid rank's shards as
``parallel.param_placements`` places them (the FSDP data axes included),
``gather_params`` puts the ranks' shards back together, and
``shard_model`` cuts a ``Transformer``'s own parameters in place: how a
grid rank gets its weights, and how tests hold a grid against one
process.  ``gather_shard`` is the collective form of ``gather_params``
for one tensor, on the grid's ranks (a checkpoint, a digest).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import check_arch, has_encoder
from repro_torch.parallel import make_rules, param_placements


def _tensor(x, dtype) -> torch.Tensor:
    # copy: arrays handed over from JAX are read-only views
    return torch.tensor(np.array(x, copy=True)).to(dtype)


def _flatten(prefix: str, tree: Mapping, out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(f"{prefix}{k}.", v, out)
        else:
            out[prefix + k] = v


def _entries(np_params: Mapping, cfg) \
        -> Iterator[Tuple[str, object, Optional[int]]]:
    """(state_dict key, reference leaf, group) triples: the port's tensor
    is ``leaf`` itself, or ``leaf[group]`` of a group-stacked slot leaf."""
    check_arch(cfg)
    yield "embed", np_params["embed"]["embed"], None
    if not cfg.tie_embeddings:
        yield "unembed", np_params["unembed"]["unembed"], None
    for k, v in np_params["final_norm"].items():
        yield f"final_norm.{k}", v, None
    blocks = np_params["blocks"]
    if len(blocks) != cfg.period:
        raise ValueError(f"{len(blocks)} pattern slots, config has "
                         f"{cfg.period}")
    for si, slot in enumerate(blocks):
        flat: Dict[str, np.ndarray] = {}
        _flatten("", slot, flat)
        for name, stacked in flat.items():
            if stacked.shape[0] != cfg.n_groups:
                raise ValueError(f"slot {si} {name}: leading axis "
                                 f"{stacked.shape[0]} != n_groups "
                                 f"{cfg.n_groups}")
            for g in range(cfg.n_groups):
                yield f"layers.{g * cfg.period + si}.{name}", stacked, g
    if has_encoder(cfg):
        flat = {}
        _flatten("", np_params["enc_blocks"], flat)
        for name, stacked in flat.items():
            if stacked.shape[0] != cfg.encoder.n_layers:
                raise ValueError(f"enc_blocks {name}: leading axis "
                                 f"{stacked.shape[0]} != n_layers "
                                 f"{cfg.encoder.n_layers}")
            for i in range(cfg.encoder.n_layers):
                yield f"enc_layers.{i}.{name}", stacked, i
        for k, v in np_params["enc_final_norm"].items():
            yield f"enc_final_norm.{k}", v, None


def params_from_jax(np_params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The reference param pytree (numpy leaves) -> a Transformer
    state_dict, in ``cfg``'s param dtype."""
    return {k: _tensor(v if g is None else v[g], cfg.pdtype)
            for k, v, g in _entries(np_params, cfg)}


def param_shapes(params: Mapping, cfg) -> Dict[str, Tuple[int, ...]]:
    """The state_dict shapes ``params_from_jax`` would produce, from any
    pytree of shaped leaves (e.g. ``jax.eval_shape`` of the reference's
    init), without materialising a weight."""
    return {k: tuple(v.shape[1:] if g is not None else v.shape)
            for k, v, g in _entries(params, cfg)}


def decay_mask(model) -> List[bool]:
    """Per tensor of ``model.parameters()``: does the reference's AdamW
    decay it?  The reference decays a leaf of its param tree when
    ``ndim >= 2`` (``src/repro/optim/adamw.py:57``).  A leaf of
    ``blocks`` carries the leading ``[n_groups]`` axis, and one of
    ``enc_blocks`` the leading ``[n_enc_layers]`` axis, so a repeated
    layer's tensor decays when it has ``dim() >= 1``: its matrices and
    also its vectors (norm scales, biases, ``lru_a``, ``conv_b``,
    ``A_log``, ``D_skip``, ``dt_bias``), but not a cross layer's 0-d
    ``xgate`` (a ``[n_groups]`` leaf there).  A top-level tensor
    (``embed``, ``unembed``, ``final_norm``, ``enc_final_norm``) decays
    when ``dim() >= 2``."""
    return [p.dim() >= (1 if name.startswith(("layers.", "enc_layers."))
                        else 2)
            for name, p in model.named_parameters()]


def _split_dims(axes) -> List[Tuple[int, str]]:
    """(dim, grid axis) for each axis a stored placement splits a dim
    over, in dim order."""
    out = []
    for i, a in enumerate(axes):
        for n in (() if a is None else a if isinstance(a, tuple) else (a,)):
            out.append((i, n))
    return out


def _cut(t: torch.Tensor, axes, coords: Mapping[str, int],
         sizes: Mapping[str, int]) -> torch.Tensor:
    for i, n in _split_dims(axes):
        size = t.shape[i] // sizes[n]
        t = t.narrow(i, coords[n] * size, size)
    return t


def grid_placements(cfg, params: Mapping, sizes: Mapping[str, int]) \
        -> Dict[str, Tuple]:
    """Per tensor, the axes it is stored split over on a grid of axis
    ``sizes``: ``param_placements`` under ``make_rules``."""
    return param_placements(cfg, params, make_rules(sizes, cfg), sizes)


def shard_shape(shape, axes, sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` placed by
    ``axes`` on a grid of axis ``sizes``."""
    out = list(shape)
    for i, n in _split_dims(axes):
        out[i] //= sizes[n]
    return tuple(out)


def shard_params(full: Mapping[str, torch.Tensor], placements: Mapping,
                 coords: Mapping[str, int], sizes: Mapping[str, int]) \
        -> Dict[str, torch.Tensor]:
    """The shards of ``full`` (a state_dict) that the rank at ``coords``
    (``{"data": d, "model": m}``) of a grid of axis ``sizes`` stores, by
    ``placements`` (``grid_placements``); views where a slice allows."""
    return {k: _cut(v, placements[k], coords, sizes)
            for k, v in full.items()}


def gather_params(parts: Mapping[Tuple[int, int], Mapping[str, torch.Tensor]],
                  placements: Mapping, sizes: Mapping[str, int]) \
        -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: ``parts[(d, m)]`` is the rank at
    data index d and model index m's shards; returns whole tensors."""
    def build(key, fixed, rest):
        if not rest:
            return parts[(fixed.get("data", 0),
                          fixed.get("model", 0))][key]
        (i, n), more = rest[0], rest[1:]
        return torch.cat([build(key, {**fixed, n: j}, more)
                          for j in range(sizes[n])], dim=i)
    return {k: build(k, {}, _split_dims(placements[k]))
            for k in parts[(0, 0)]}


@torch.no_grad()
def shard_model(model, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Dict[str, Tuple]:
    """Cut ``model``'s parameters in place to the shards the rank at
    ``coords`` stores (each a tensor of its own: the whole one is freed);
    records and returns the placements (``model.grid_placements``)."""
    placed = grid_placements(model.cfg, dict(model.named_parameters()),
                             sizes)
    for name, p in model.named_parameters():
        p.data = _cut(p.data, placed[name], coords, sizes).clone()
    model.grid_placements = placed
    return placed


def gather_shard(t: torch.Tensor, axes, groups: Mapping[str, object]) \
        -> torch.Tensor:
    """The whole tensor from every rank's shard ``t`` (placed by
    ``axes``), all-gathered over ``groups[axis]`` for each split axis in
    the reverse of ``_cut``'s order; a collective (no gradient).  With
    ``groups`` naming only ``"data"``, the model shard."""
    from repro_torch.models.sharded import all_gather
    for i, n in reversed(_split_dims(axes)):
        if n in groups:
            t = all_gather(t, groups[n], dim=i)
    return t
