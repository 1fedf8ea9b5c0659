"""Carry the JAX package's parameters across to the port.

``params_from_jax`` takes the reference's param pytree as numpy arrays
(``embed``, ``unembed``, ``final_norm`` and ``blocks``: a tuple of slot
dicts whose leaves carry a leading ``[n_groups]`` axis) and returns a
``state_dict`` for ``model.Transformer``.  Layer ``l`` is slot
``l % period`` of group ``l // period``.  Weights keep the reference's
``[in, out]`` layout, which the port applies as ``h @ W``: nothing is
transposed, here or in the hot path.

``decay_mask`` says which of a ``Transformer``'s parameters the
reference's AdamW decays, a rule it states on the stacked layout.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import check_arch


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
    ``blocks`` carries the leading ``[n_groups]`` axis, so a repeated
    layer's tensor decays when it has ``dim() >= 1``: its matrices and
    also its vectors (norm scales, biases, ``lru_a``, ``conv_b``,
    ``A_log``, ``D_skip``, ``dt_bias``).  A top-level tensor (``embed``,
    ``unembed``, ``final_norm``) decays when ``dim() >= 2``."""
    return [p.dim() >= (1 if name.startswith("layers.") else 2)
            for name, p in model.named_parameters()]
