"""Checkpoints of a model's tensors and its optimizer state (no external
deps).

The port of ``repro.checkpoint.ckpt``, with the reference's layout: one
``ckpt_{step:08d}.npz`` per checkpoint step holding the flattened leaves
(``a0``, ``a1``, ...) in the order of their tree paths, plus a metadata
``.json`` beside it with ``step``, ``paths`` and ``extra``.  A tree is
nested dicts, lists, tuples and NamedTuples (the port's ``AdamWState``)
of tensors, numpy arrays and Python numbers; the model's part is its
named tensors (``model.state_dict()``).

numpy has no bfloat16, so a tensor numpy cannot hold is stored as its
bits (``tensor.view(torch.int16)`` for bf16) and the metadata records
each leaf's dtype (``dtypes``): a restore gives the saved bits back,
never a round trip through float32.  ``restore`` returns tensors in the
dtypes and on the devices of ``like``.

Runtime-calibration state (the :class:`GridCalibrator` latency grid +
per-server speed ratios, DESIGN.md §3) rides along in the metadata
json: pass ``calibrator=`` to :func:`save` and call
:func:`restore_calibration` after a restart so the measured cost model
survives — a restore from an older checkpoint without calibration
state is a silent no-op (the calibrator simply keeps its base model).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

# dtypes numpy cannot hold, stored as integers of the same width
_BITS = {torch.bfloat16: torch.int16}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in tree order; paths in the reference's
    ``keystr`` form (``['params']['embed.weight']``, ``.mu[0]``)."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _flatten(v, f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pl for k, v in zip(tree._fields, tree)
                for pl in _flatten(v, f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array to store, and its dtype's name."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype in _BITS:
            t = t.view(_BITS[t.dtype])
        return t.numpy(), str(leaf.dtype)
    arr = np.asarray(leaf)
    return arr, ("int" if isinstance(leaf, int) else str(arr.dtype))


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """The stored array as ``like``'s kind of leaf: a tensor in its dtype
    on its device, a Python number, or a numpy array."""
    if torch.is_tensor(like):
        t = torch.from_numpy(np.array(arr, copy=True))
        bits_of = next((d for d in _BITS if str(d) == dtype), None)
        if bits_of is not None:
            t = t.view(bits_of)
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (int, float)):
        return type(like)(arr.item())
    return np.array(arr, copy=True)


def save(path: str, step: int, params: Any, opt_state: Any = None,
         extra: Optional[dict] = None, calibrator: Any = None,
         rank: int = 0) -> Optional[str]:
    """Write step ``step``: ``params`` (the model's named tensors) and
    ``opt_state`` (an ``AdamWState``, or any tree) into the ``.npz``,
    ``extra`` and the calibrator's state into the metadata json.
    Returns the ``.npz`` path.  The ranks of a CAD group hold the same
    state: only ``rank`` 0 writes, the others return None."""
    if rank != 0:
        return None
    os.makedirs(path, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    flat = _flatten(tree)
    stored = [_to_numpy(leaf) for _, leaf in flat]
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(fname, **{f"a{i}": arr for i, (arr, _) in enumerate(stored)})
    extra = dict(extra or {})
    if calibrator is not None:
        extra["calibration"] = calibrator.state_dict()
    meta = {"step": step, "paths": [p for p, _ in flat],
            "dtypes": [dt for _, dt in stored], "extra": extra}
    with open(fname + ".json", "w") as f:
        json.dump(meta, f)
    return fname


def read_meta(path: str, step: int) -> dict:
    """The metadata json saved alongside a checkpoint step."""
    fname = os.path.join(path, f"ckpt_{step:08d}.npz.json")
    with open(fname) as f:
        return json.load(f)


def restore_calibration(path: str, step: int, calibrator: Any) -> bool:
    """Load a checkpoint's calibration state into ``calibrator``
    (:meth:`GridCalibrator.load_state_dict`).  Returns True when state
    was restored; False — leaving the calibrator untouched — for
    checkpoints written before calibration rode along (older seeds),
    saved without a calibrator, or whose state describes a different
    pool geometry (e.g. a shared ckpt dir reused across runs with a
    different server count)."""
    try:
        meta = read_meta(path, step)
    except FileNotFoundError:
        return False
    state = (meta.get("extra") or {}).get("calibration")
    if not state:
        return False
    try:
        calibrator.load_state_dict(state)
    except ValueError as e:
        print(f"note: ignoring checkpoint calibration state: {e}")
        return False
    return True


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore(path: str, step: int, like: Any) -> Any:
    """Step ``step`` in the structure of ``like`` (e.g. ``{"params":
    model.state_dict(), "opt_state": opt.init(...)}``): every tensor in
    ``like``'s dtype and on its device."""
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    dtypes = read_meta(path, step)["dtypes"]
    flat = _flatten(like)
    with np.load(fname) as data:
        if len(flat) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"the target has {len(flat)}")
        leaves = []
        for i, (p, old) in enumerate(flat):
            arr = data[f"a{i}"]
            shape = tuple(old.shape) if hasattr(old, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"{p}: checkpoint shape {arr.shape}, "
                                 f"target {shape}")
            leaves.append(_from_numpy(arr, dtypes[i], old))
    return _unflatten(like, iter(leaves))
