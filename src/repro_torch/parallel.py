"""Parallelism context and sharding rules for the port's training step.

The port of ``repro.parallel``: the attention implementation, the CAD
context, rematerialization, the CAD group and the ``("data", "model")``
grid.  The reference names its devices by a mesh and maps logical dims
to mesh axes with :class:`ShardingRules` (``make_rules``); here the same
rules are computed from the grid's axis sizes, and the ranks are
``torch.distributed`` processes (:func:`repro_torch.launch.mesh.join_grid`):

* ``group`` is the CAD group, the ``"data"`` sub-group of this rank's
  model index (the reference's ``cad_axis``): one rank per attention
  server.  ``group=None`` is the single-process pool
  (``core.dispatch._global_sim``).
* ``model_group`` is the ``"model"`` sub-group of this rank's data index,
  over which the tensor-parallel layers split their heads, FFN columns,
  expert width and vocabulary, and the residual stream its sequence
  (``residual_seq``, Megatron-SP); ``models.sharded`` holds those layers'
  collectives.

Parameters are stored as :func:`param_placements` says, the FSDP
``dmodel -> data`` rule included (the reference's ``param_pspecs``,
``src/repro/parallel.py:139``): a rank holds its shard of every split
dim, and the layers all-gather a tensor's FSDP dims over ``"data"`` where
they read it (:func:`fsdp_dims`, ``models.sharded.fsdp_gather``), as
GSPMD gathers the reference's at use.  An expert-parallel arch's experts
are split over ``"data"`` on their expert dim instead, and are never
gathered: each data rank computes its own experts.

A decode step on the grid takes the reference's decode shapes' rules
(:func:`decode_rules`: the cache's sequence over ``"model"``, or over
every axis for ``long_500k``, the residual whole on every model rank)
and places its cache by :func:`cache_placements`.

The ping-pong flag lives in one place, ``CADContext.pingpong`` (the
reference also keeps ``ParallelContext.pingpong``, which nothing reads).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical dim -> grid axis (a name, a tuple of names, or None), the
    reference's fields and meanings (``src/repro/parallel.py:28``)."""
    batch: Any = None
    seq: Any = None
    residual_seq: Any = None
    heads: Any = None
    kv_heads: Any = None
    ffn: Any = None
    dmodel: Any = None
    vocab: Any = None
    experts: Any = None
    padded_heads: Any = None
    cad_axis: Any = None


def make_rules(sizes: Optional[Mapping[str, int]], cfg) -> ShardingRules:
    """The reference's divisibility-aware rules for a ``("data",
    "model")`` or ``("pod", "data", "model")`` grid of axis ``sizes``
    (``src/repro/parallel.py:53``); ``None`` gives no rule."""
    if not sizes:
        return ShardingRules()
    model_n = sizes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    data_n = 1
    for a in data_axes:
        data_n *= sizes[a]

    def div(n, axis, size):
        return axis if (n and n % size == 0) else None

    heads = div(getattr(cfg, "n_heads", 0), "model", model_n)
    kv_heads = div(getattr(cfg, "n_kv_heads", 0), "model", model_n)
    ffn = div(getattr(cfg, "d_ff", 0), "model", model_n)
    dmodel = div(getattr(cfg, "d_model", 0), data_axes, data_n)
    vocab = div(getattr(cfg, "vocab_size", 0), "model", model_n)
    experts = None
    if getattr(cfg, "moe", None) and cfg.moe.n_experts:
        if cfg.moe.expert_parallel and cfg.moe.n_experts % data_n == 0:
            experts = data_axes
        ffn = div(cfg.moe.d_ff_expert, "model", model_n)
    return ShardingRules(
        batch=data_axes, seq=None,
        residual_seq="model" if model_n > 1 else None,
        heads=heads, kv_heads=kv_heads, ffn=ffn,
        dmodel=dmodel, vocab=vocab, experts=experts,
        padded_heads="model" if model_n > 1 else None,
        cad_axis=data_axes)


def decode_rules(rules: ShardingRules, sizes: Optional[Mapping[str, int]],
                 long: bool) -> ShardingRules:
    """``make_rules``' output with the reference's replacements for a
    decode shape (``src/repro/launch/dryrun_lib.py:154-171``): for
    ``decode_32k`` the cache's sequence over ``"model"``, the kv heads
    yielding to it (a grid axis may appear once in a placement); for
    ``long_500k`` (``long``) no batch rule and the sequence over every
    axis, ``("pod", "data", "model")`` as present.  Neither splits the
    residual's sequence (a step holds one token a row).  One departure:
    in the ``long`` branch the kv heads yield to the sequence as they do
    in the ``decode`` branch; the reference keeps ``make_rules``'
    ``kv_heads`` there and names ``"model"`` twice in a cache placement
    wherever the kv heads divide the model axis (it raises then)."""
    if not sizes:
        return rules
    has_model = "model" in sizes
    kv_heads = None if has_model else rules.kv_heads
    if long:
        seq = tuple(a for a in ("pod", "data") if a in sizes) \
            + (("model",) if has_model else ())
        return dataclasses.replace(rules, batch=None, seq=seq,
                                   residual_seq=None, kv_heads=kv_heads)
    return dataclasses.replace(rules, seq="model" if has_model else None,
                               kv_heads=kv_heads, residual_seq=None)


def axis_size(axes: Any, sizes: Mapping[str, int]) -> int:
    """Ranks along ``axes`` (None, a grid axis name or a tuple of them)."""
    n = 1
    for a in (() if axes is None else axes if isinstance(axes, tuple)
              else (axes,)):
        n *= sizes.get(a, 1)
    return n


def _fit(shape: Tuple[int, ...], dims: Tuple[Any, ...],
         sizes: Mapping[str, int]) -> Tuple[Any, ...]:
    """``dims`` padded on the left with None to ``shape``'s rank, each
    axis kept only where it divides its dim (the reference's safety
    net)."""
    dims = (None,) * (len(shape) - len(dims)) + tuple(dims)
    return tuple(ax if ax is None or shape[i] % axis_size(ax, sizes) == 0
                 else None for i, ax in enumerate(dims))


# a decode cache leaf's logical dims by name (``_cache_pspecs``); the
# reference's leading stacked-group dim is not in the port's cache
_CACHE_DIMS = {"k": ("batch", "seq", "kv_heads", None),
               "v": ("batch", "seq", "kv_heads", None),
               "kv_pos": ("batch", "seq"),
               "xk": ("batch", None, "kv_heads", None),
               "xv": ("batch", None, "kv_heads", None),
               "state": ("batch", None, None, None),
               "conv": ("batch", None, None),
               "h": ("batch", None)}


def cache_placements(cfg, cache: Mapping[str, Any], rules: ShardingRules,
                     sizes: Optional[Mapping[str, int]]) -> Dict[str, Any]:
    """Per leaf of a ``layout="decode"`` cache (``{"slots": [{name:
    shaped}]}``, whole shapes: a tensor or a shape tuple), the grid axes
    of each dim: the reference's ``_cache_pspecs``
    (``src/repro/launch/dryrun_lib.py:86-105``) under ``rules``, with
    ``param_placements``' divisibility fallback.  Attention ``k``/``v``
    over (batch, seq, kv_heads), ``kv_pos`` over (batch, seq), a cross
    layer's ``xk``/``xv`` over (batch, kv_heads) with the memory whole,
    the recurrent states over the batch alone; a ``local`` layer's ring is
    split along its slots as a global cache is.  Returns the same
    structure of axes tuples."""
    del cfg     # the reference's placements read names and shapes only
    sizes = sizes or {}
    out = []
    for slot in cache["slots"]:
        placed = {}
        for name, t in slot.items():
            shape = tuple(t if isinstance(t, tuple) else t.shape)
            dims = tuple(None if d is None else getattr(rules, d)
                         for d in _CACHE_DIMS.get(name, ()))
            placed[name] = _fit(shape, dims, sizes)
        out.append(placed)
    return {"slots": out}


# the reference's replicated leaf names (``param_pspecs``)
_REPLICATED = {"scale", "bias", "lru_a", "conv_b", "conv_w", "A_log",
               "D_skip", "dt_bias", "xgate", "enc_pos"}


def _leaf_axes(name: str, shape: Tuple[int, ...], rules: ShardingRules,
               sizes: Mapping[str, int]) -> Tuple[Any, ...]:
    """One leaf's axes by the reference's naming rules, ``shape`` its
    shape on the reference's tree (with the stacked layer dim)."""
    ndim = len(shape)

    def wrap(*dims):
        return _fit(shape, dims, sizes)

    if name in _REPLICATED or ndim <= 1:
        return (None,) * ndim
    r = rules
    table = {
        "embed": (r.vocab, r.dmodel), "unembed": (r.vocab, r.dmodel),
        "wq": (r.dmodel, r.heads), "wk": (r.dmodel, r.kv_heads),
        "wv": (r.dmodel, r.kv_heads), "wo": (r.heads, r.dmodel),
        "w_gate": (r.dmodel, r.ffn), "w_up": (r.dmodel, r.ffn),
        "w_in": (r.dmodel, r.ffn), "w_down": (r.ffn, r.dmodel),
        "w_out": (r.ffn, r.dmodel), "router": (r.dmodel, None),
        "in_proj": (r.dmodel, None), "xbc_proj": (r.dmodel, None),
        "out_proj": (None, r.dmodel), "w_x": (r.dmodel, r.ffn),
        "w_gate_br": (r.dmodel, r.ffn), "w_input_gate": (r.dmodel, r.ffn),
        "w_rec_gate": (r.dmodel, r.ffn)}
    # expert-parallel: E over data, and dmodel FSDP only when E is not
    dm = None if r.experts else r.dmodel
    table.update(experts_gate=(r.experts, dm, r.ffn),
                 experts_up=(r.experts, dm, r.ffn),
                 experts_down=(r.experts, r.ffn, dm))
    if name in table:
        return wrap(*table[name])
    return wrap(*((None,) * (ndim - 2)), r.dmodel, None)


def param_placements(cfg, params: Mapping[str, Any], rules: ShardingRules,
                     sizes: Optional[Mapping[str, int]]) \
        -> Dict[str, Tuple[Any, ...]]:
    """Per tensor of a ``Transformer``'s ``named_parameters`` (any mapping
    of port names to shaped values), the reference's axes for each of its
    dims (``param_pspecs``, ``src/repro/parallel.py:139``), after its
    divisibility fallback.  A layer's tensor is judged on the reference's
    stacked shape (a leading ``[n_groups]`` or ``[n_enc_layers]`` dim, on
    which no rule puts an axis) and given without that dim."""
    sizes = sizes or {}
    out = {}
    for key, t in params.items():
        stack = ((cfg.n_groups,) if key.startswith("layers.") else
                 (cfg.encoder.n_layers,) if key.startswith("enc_layers.")
                 else ())
        out[key] = _leaf_axes(key.rsplit(".", 1)[-1],
                              stack + tuple(t.shape), rules,
                              sizes)[len(stack):]
    return out


def fsdp_dims(key: str, axes: Tuple[Any, ...]) -> Tuple[int, ...]:
    """The dims of tensor ``key`` that its placement ``axes`` splits over
    ``"data"`` by the FSDP ``dmodel`` rule: each is all-gathered where the
    tensor is read.  An expert tensor's dim 0 is the expert-parallel
    split (the ``experts`` rule), not FSDP: its experts stay apart."""
    expert = key.rsplit(".", 1)[-1].startswith("experts_")
    return tuple(i for i, a in enumerate(axes)
                 if a is not None and "data" in (a if isinstance(a, tuple)
                                                 else (a,))
                 and not (expert and i == 0))


def sharded_over(axes: Tuple[Any, ...]) -> Tuple[str, ...]:
    """The grid axes (``"data"``, ``"model"``) a stored placement splits."""
    names = {n for a in axes if a is not None
             for n in (a if isinstance(a, tuple) else (a,))}
    return tuple(n for n in ("data", "model") if n in names)


def head_pad(n_heads: int, model_size: int) -> int:
    """Heads padded up to a multiple of the model-axis size
    (``src/repro/parallel.py:225``): used inside the CA module so it stays
    tensor-parallel when ``n_heads`` does not divide the axis (llama4
    40 -> 48, smollm 15 -> 16, whisper 20 -> 32 at model 16)."""
    m = model_size
    return ((n_heads + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """What the model's forward reads besides weights and batch.

    attn_impl:   "ref" | "xla" | "pallas" | "cad" (see
                 ``core.attention.core_attention``)
    cad:         the :class:`~repro_torch.core.dispatch.CADContext` (pool
                 geometry + this step's plan) when attn_impl == "cad"
    remat:       re-run each layer's forward in the backward
                 (``torch.utils.checkpoint``) instead of keeping its
                 activations
    group:       the CAD process group (one rank per attention server; on
                 a grid, this rank's ``"data"`` sub-group), or None: every
                 server simulated in this process
    model_group: the ``"model"`` sub-group of a grid, or None
    rules:       the grid's :class:`ShardingRules` (``make_rules``), which
                 say how the layers' tensors are stored
                 (``param_placements``)
    """
    attn_impl: str = "ref"
    cad: Any = None
    remat: bool = True
    group: Any = None
    model_group: Any = None
    rules: ShardingRules = ShardingRules()

    @property
    def model_size(self) -> int:
        """The model axis's size: ``model_group``'s (1 without a grid)."""
        if self.model_group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.model_group)

    @property
    def tp(self) -> bool:
        """Whether the layers split over a model axis of more than one
        rank."""
        return self.model_group is not None and self.model_size > 1
