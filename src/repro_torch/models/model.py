"""Model assembly: decoders trained on packed documents (``forward``),
served from the ragged serving cache (DESIGN.md §8) or, for the
cross-attention archs, from the legacy dense decode cache
(``init_cache(layout="decode")``, ``decode_step``).

The port of ``repro.models.model``.  The reference stacks each pattern
slot's weights on a leading ``[n_groups]`` axis and scans over it; here
each layer is its own module in ``Transformer.layers`` and the scan is a
Python loop.  Layer ``l`` is pattern slot ``l % period`` of group
``l // period``.  An encoder (whisper's) is ``Transformer.enc_layers``,
non-causal ``enc`` layers, and ``enc_final_norm``.

What trains: patterns of ``global``, ``local``, ``cross``, ``ssd`` and
``rglru`` layers (dense MLPs or routed experts with shared ones, optional
post-norms, softcaps, tied embeddings; the Mamba-2 SSD block; the
RecurrentGemma RG-LRU block; a ``cross`` layer is a causal self-attention
layer that also cross-attends to ``batch["memory"]``, the encoder's output
when the config has one), under every ``attn_impl`` (with ``cad``,
``local`` layers, cross-attention and the encoder take the dispatch's
non-plan route, ``xla_flash_attention``; ``ssd`` layers run their
intra-chunk step and ``rglru`` layers their recurrence in the CUDA kernels
under ``pallas`` and in torch ops otherwise).  An MoE layer routes with
capacity drops in training and without (``no_drop``) in serving, and
``forward`` returns its auxiliary losses summed over the layers.  What
serves: every pattern without cross-attention or an encoder from the
ragged serving cache (``ssd`` and ``rglru`` layers keep their conv window
and recurrent state in it and run decode-mode steps only, one token a
request; MoE archs prefill a token a request per step too, as the
reference's engine gates them); every pattern from the legacy dense
decode cache, a token a step, its attention in plain torch ops
(``decode_attention``), as the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.attention import decode_attention
from repro_torch.data.packing import BLOCK as SERVE_BLOCK
from repro_torch.kernels.packed_flash import ops as pf_ops
from repro_torch.models import layers as L
from repro_torch.models import sharded as S
from repro_torch.obs.regions import marked
from repro_torch.parallel import ParallelContext, make_rules

_ATTN_KINDS = ("global", "local")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    the port never carries on on the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return device


_RECURRENT = ("ssd", "rglru")
_KINDS = _ATTN_KINDS + ("cross",) + _RECURRENT


def has_encoder(cfg) -> bool:
    return bool(cfg.encoder and cfg.encoder.n_layers)


def needs_memory(cfg) -> bool:
    """Whether the arch reads a memory (cross-attention layers or an
    encoder): it serves only from the legacy decode cache."""
    return has_encoder(cfg) or "cross" in cfg.layer_pattern


def check_arch(cfg) -> None:
    """Raise for what the port cannot build: a layer kind it does not
    know, or qk_norm (which no assigned arch uses)."""
    for kind in cfg.layer_pattern:
        if kind not in _KINDS:
            raise ValueError(f"{cfg.arch_id}: unknown layer kind {kind!r}")
    if cfg.qk_norm:
        raise NotImplementedError(f"{cfg.arch_id}: qk_norm is not ported")


def check_grid(cfg, model_size: int, seq: int, memory: int = 0) -> None:
    """Raise ``ValueError`` for what a model axis of ``model_size`` ranks
    cannot split: a sequence the axis does not divide (the residual's
    shards), an encoder's memory of ``memory`` rows that it does not
    divide (the encoder's residual shards), and an RG-LRU width that the
    ``ffn`` rule would split but the axis does not divide."""
    if model_size <= 1:
        return
    if seq % model_size:
        raise ValueError(f"a sequence of {seq} tokens does not split over "
                         f"{model_size} model ranks")
    if has_encoder(cfg) and memory % model_size:
        raise ValueError(f"{cfg.arch_id}: a memory of {memory} rows does "
                         f"not split over {model_size} encoder model ranks")
    if "rglru" in cfg.layer_pattern \
            and make_rules({"model": model_size}, cfg).ffn is not None:
        width = cfg.rglru.lru_width or cfg.d_model
        if width % model_size:
            raise ValueError(f"{cfg.arch_id}: an RG-LRU width of {width} "
                             f"does not split over {model_size} model "
                             f"ranks")


def fused_prefill_ok(cfg) -> bool:
    """Whether prompts may be prefilled in fused chunks (blk_q 128): only
    attention-only patterns without MoE.  Recurrent mixers are sequential
    and MoE routing batch-global, so those archs prefill a token a request
    per step (decode-mode chunks)."""
    return all(kind in _ATTN_KINDS for kind in cfg.layer_pattern) \
        and not (cfg.moe and cfg.moe.n_experts)


class Block(nn.Module):
    """One attention layer: norm1 -> attn -> [pnorm1] -> residual ->
    [a ``cross`` layer: xnorm -> cross-attention -> residual] -> norm2 ->
    ffn (or moe, with ``cfg.moe.n_experts``; never in an ``enc`` layer)
    -> [pnorm2] -> residual."""

    def __init__(self, cfg, kind: str, gen: torch.Generator, device):
        super().__init__()
        self.kind = kind
        dt = cfg.pdtype
        self.norm1 = L.norm_init(cfg.d_model, dt, cfg.norm, device)
        self.attn = L.attn_init(gen, cfg, device, cross=kind == "cross")
        self.norm2 = L.norm_init(cfg.d_model, dt, cfg.norm, device)
        if kind == "cross":
            self.xnorm = L.norm_init(cfg.d_model, dt, cfg.norm, device)
        if cfg.moe and cfg.moe.n_experts and kind != "enc":
            self.moe = L.moe_init(gen, cfg, device)
        else:
            self.ffn = L.ffn_init(gen, cfg, device)
        if cfg.post_norms:
            self.pnorm1 = L.norm_init(cfg.d_model, dt, cfg.norm, device)
            self.pnorm2 = L.norm_init(cfg.d_model, dt, cfg.norm, device)


class SSDBlock(nn.Module):
    """One Mamba-2 layer: norm1 -> SSD mixer -> residual."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        self.kind = "ssd"
        self.norm1 = L.norm_init(cfg.d_model, cfg.pdtype, cfg.norm, device)
        self.mixer = L.ssd_init(gen, cfg, device)


class RGLRUBlock(nn.Module):
    """One RecurrentGemma recurrent layer: norm1 -> RG-LRU mixer ->
    residual -> norm2 -> FFN -> residual."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        self.kind = "rglru"
        dt = cfg.pdtype
        self.norm1 = L.norm_init(cfg.d_model, dt, cfg.norm, device)
        self.mixer = L.rglru_init(gen, cfg, device)
        self.norm2 = L.norm_init(cfg.d_model, dt, cfg.norm, device)
        self.ffn = L.ffn_init(gen, cfg, device)


_BLOCKS = {"ssd": SSDBlock, "rglru": RGLRUBlock}


class Transformer(nn.Module):
    """Decoder (with whisper's encoder where the config has one) for
    training and serving.
    Weights are drawn from ``seed`` (normal * fan_in**-0.5, per tensor, in
    the param dtype, on ``device``);
    ``load_state_dict(convert.params_from_jax(...))`` replaces them."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        check_arch(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        # on the meta device the weights are shapes only (no memory), e.g.
        # to check a full-width layout; its draws come from a CPU generator
        gen = torch.Generator(
            device="cpu" if device.type == "meta" else device)
        gen.manual_seed(seed)
        dt = cfg.pdtype
        self.embed = nn.Parameter(L.dense_init(
            gen, cfg.d_model, (cfg.vocab_size, cfg.d_model), dt, device))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(L.dense_init(
                gen, cfg.d_model, (cfg.vocab_size, cfg.d_model), dt, device))
        self.final_norm = L.norm_init(cfg.d_model, dt, cfg.norm, device)
        kinds = [cfg.layer_pattern[i % cfg.period]
                 for i in range(cfg.n_layers)]
        self.layers = nn.ModuleList(
            _BLOCKS[kind](cfg, gen, device) if kind in _BLOCKS
            else Block(cfg, kind, gen, device) for kind in kinds)
        if has_encoder(cfg):
            self.enc_layers = nn.ModuleList(
                Block(cfg, "enc", gen, device)
                for _ in range(cfg.encoder.n_layers))
            self.enc_final_norm = L.norm_init(cfg.d_model, dt, cfg.norm,
                                              device)
        # module and parameter names by id, for ``_read`` on a grid
        self._names: Optional[Dict[int, str]] = None
        # inspection hook: called as attn_hook(layer, inputs) with each
        # sequence mixer's inputs just before its kernel call (serving: the
        # kernel's arguments; training attention: q, k, v, segment_ids,
        # positions and the ParallelContext; training ssd: the intra-chunk
        # step's C, B, x, dt, csum, nr; training rglru on the kernel
        # route: the scan's a and bterm)
        self.attn_hook: Optional[Callable[[int, Dict], None]] = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------ embed/unembed
    def _read(self, module, ctx):
        """``module`` (a block, a ``ParameterDict`` or a ``Parameter`` of
        this model) as the training path reads it: on a grid its FSDP
        shards gathered over the data ranks (``sharded.read_weights`` by
        ``grid_placements``, under the module's name), else itself."""
        placed = getattr(self, "grid_placements", None)
        if placed is None:
            return module
        if id(module) not in (self._names or {}):
            # (re)built: ``to_empty`` and the like swap parameter objects
            self._names = {id(m): n for n, m in self.named_modules()}
            self._names.update({id(p): n for n, p in
                                self.named_parameters()})
        return S.read_weights(module, self._names[id(module)], placed,
                              ctx.group)

    def _embed(self, tokens: torch.Tensor, ctx=None,
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The token embedding from ``table`` (default: ``self.embed``).
        On a grid (``ctx.tp``) it returns the residual's sequence shard:
        with the vocabulary split over the model ranks (the ``vocab``
        rule) each rank looks up the tokens of its rows of the table
        (others read zero) and the sums are reduce-scattered; with a
        replicated table each rank looks up its own tokens."""
        cfg = self.cfg
        table = self.embed if table is None else table
        tp = getattr(ctx, "tp", False)
        if tp and ctx.rules.vocab is not None:
            start = S.model_rank(ctx) * table.shape[0]
            t = tokens.long() - start
            inside = (t >= 0) & (t < table.shape[0])
            h = F.embedding(torch.where(inside, t, 0), table) \
                * inside[..., None].to(table.dtype)
            h = S.seq_scatter(h, ctx.model_group).to(cfg.cdtype)
        else:
            if tp:
                tokens = S.own_seq(tokens, ctx)
            # F.embedding, not self.embed[tokens]: the backward of
            # advanced indexing on the CPU sums repeated rows with atomic
            # adds when torch has several threads, in no fixed order
            h = F.embedding(tokens.long(), table).to(cfg.cdtype)
        if cfg.scale_embed:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype,
                                 device=h.device)
        return h

    @marked("unembed")
    def _unembed(self, h: torch.Tensor, ctx=None,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits f32 against ``table`` (default: the tied embedding or
        ``self.unembed``).  On a grid whose ``vocab`` rule splits the
        table, the whole sequence (gathered) against this rank's rows:
        ``[B, S, V/M]``; with a replicated table, this rank's sequence
        shard against all of it: ``[B, S/M, V]``
        (``train.loss.grid_nll_sum`` reads both)."""
        cfg = self.cfg
        if table is None:
            table = self.embed if cfg.tie_embeddings else self.unembed
        if getattr(ctx, "tp", False) and ctx.rules.vocab is not None:
            h = S.seq_gather(h, ctx.model_group)
        logits = (h @ table.T).float()
        if cfg.final_logit_softcap:
            logits = torch.tanh(logits / cfg.final_logit_softcap) \
                * cfg.final_logit_softcap
        return logits

    # ----------------------------------------------------------- training
    def _block_train(self, li: Optional[int], blk: nn.Module, h, batch,
                     ctx):
        """``block_apply`` (reference ``models/model.py:88-130``): for an
        attention layer norm1 -> self-attention (non-causal in an ``enc``
        layer) -> [pnorm1] -> residual -> [``cross``: xnorm ->
        cross-attention -> residual] -> norm2 -> FFN or MoE -> [pnorm2] ->
        residual; for an ssd layer norm1 -> SSD mixer -> residual; for an
        rglru layer norm1 -> RG-LRU mixer -> residual -> norm2 -> FFN ->
        residual.  The layer's weights are read through ``_read``, inside
        the remat region.  ``li`` is the decoder layer's index for
        ``attn_hook`` (None for an encoder layer, which is not hooked).
        Returns (h, the MoE layer's aux losses or None)."""
        cfg = self.cfg
        blk = self._read(blk, ctx)
        hook = None
        if self.attn_hook is not None and li is not None:
            hook = lambda inputs, li=li: self.attn_hook(li, inputs)  # noqa
        if blk.kind == "ssd":
            return h + L.ssd_apply(blk.mixer,
                                   L.norm_apply(blk.norm1, h, cfg.norm),
                                   batch, cfg, ctx, hook=hook), None
        if blk.kind == "rglru":
            h = h + L.rglru_apply(blk.mixer,
                                  L.norm_apply(blk.norm1, h, cfg.norm),
                                  batch, cfg, ctx, hook=hook)
            return h + L.ffn_apply(blk.ffn,
                                   L.norm_apply(blk.norm2, h, cfg.norm),
                                   cfg, ctx), None
        window = cfg.window if blk.kind == "local" else 0
        a = L.self_attn_apply(blk.attn, L.norm_apply(blk.norm1, h, cfg.norm),
                              batch, cfg, ctx, causal=blk.kind != "enc",
                              window=window, hook=hook)
        cross_fn = None
        if blk.kind == "cross":
            cross_fn = lambda hh: L.cross_attn_apply(  # noqa: E731
                blk.attn, L.norm_apply(blk.xnorm, hh, cfg.norm), batch, cfg,
                ctx)
        return self._attn_residual_tail(blk, h, a,
                                        group=getattr(ctx, "group", None),
                                        cross_fn=cross_fn, ctx=ctx)

    def _run_layers(self, layers, h, batch, ctx, hooked: bool):
        """Each layer in turn, under ``torch.utils.checkpoint`` when
        ``ctx.remat`` and gradients are on; returns (h, the MoE layers'
        aux losses in order)."""
        losses_all = []
        for li, blk in enumerate(layers):
            li = li if hooked else None
            if ctx.remat and torch.is_grad_enabled():
                h, losses = torch.utils.checkpoint.checkpoint(
                    self._block_train, li, blk, h, batch, ctx,
                    use_reentrant=False)
            else:
                h, losses = self._block_train(li, blk, h, batch, ctx)
            if losses:
                losses_all.append(losses)
        return h, losses_all

    def encode(self, memory_raw: torch.Tensor, ctx) -> torch.Tensor:
        """The whisper-style encoder over stub frame embeddings [B,M,D]
        (reference ``models/model.py:145-160``): sinusoidal positions
        0..M-1, one document a row, the non-causal ``enc`` layers (each
        under ``torch.utils.checkpoint`` with ``ctx.remat``), then
        ``enc_final_norm``.  On a grid (``ctx.tp``) the encoder's residual
        is split along the memory over the model ranks, as the decoder's
        along its sequence, and its output all-gathered over them, so
        every model rank's cross layers read the whole memory.  Returns
        [B,M,D] in the compute dtype."""
        cfg = self.cfg
        b, m, _ = memory_raw.shape
        dev = memory_raw.device
        pos = torch.arange(m, dtype=torch.int32, device=dev).expand(b, m)
        h = memory_raw.to(cfg.cdtype) + L.sinusoidal_pos(pos, cfg.d_model,
                                                         cfg.cdtype)
        tp = getattr(ctx, "tp", False)
        if tp:
            h = S.own_seq(h, ctx)
        ebatch = {"segment_ids": torch.ones((b, m), dtype=torch.int32,
                                            device=dev),
                  "positions": pos}
        h, _ = self._run_layers(self.enc_layers, h, ebatch, ctx,
                                hooked=False)
        h = L.norm_apply(self._read(self.enc_final_norm, ctx), h, cfg.norm)
        return S.seq_gather(h, ctx.model_group) if tp else h

    def _memory(self, memory: Optional[torch.Tensor], ctx):
        """What the cross layers attend to: the encoder's output where the
        config has an encoder, else the memory in the compute dtype."""
        if memory is None:
            if "cross" in self.cfg.layer_pattern:
                raise ValueError(f"{self.cfg.arch_id}: cross-attention "
                                 f"layers need a memory [B, M, d_model]")
            return None
        if has_encoder(self.cfg):
            return self.encode(memory, ctx)
        return memory.to(self.cfg.cdtype)

    def forward(self, batch: Dict[str, torch.Tensor], ctx) \
            -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Packed-LM forward.  ``batch`` holds ``tokens``,
        ``segment_ids`` and ``positions`` [B, S] on the model's device
        (and, with ``ctx.attn_impl == "cad"``, the step's plan is bound in
        ``ctx.cad``).  With ``ctx.remat`` each layer's forward is re-run
        in the backward (``torch.utils.checkpoint``, non-reentrant)
        instead of keeping its activations (an MoE layer's all-reduce of
        its top-1 counts under a group runs again there, in the same order
        on every rank).  A cross-attention arch also reads
        ``batch["memory"]`` [B, M, D] (encoded first where the config has
        an encoder) and, optionally, ``memory_mask`` [B, M] (0 = a memory
        row no query sees).  Returns (logits [B,S,V] f32, aux-losses: with
        MoE layers ``moe_lb`` and ``moe_z``, f32 scalars summed over the
        layers in order, else empty).  On a grid the weights
        are this rank's shards (``convert.shard_model``), read through
        ``_read`` (their FSDP dims gathered over the data ranks), and the
        batch is the data rank's rows on every model rank; with a model
        axis (``ctx.tp``) the residual stream is split along the sequence
        over the model ranks between the blocks (an encoder's along its
        memory), the logits are ``_unembed``'s shard and the aux losses
        this rank's shares."""
        cfg = self.cfg
        tp = getattr(ctx, "tp", False)
        if tp:
            mem = batch.get("memory")
            check_grid(cfg, ctx.model_size, batch["tokens"].shape[1],
                       0 if mem is None else mem.shape[1])
        memory = self._memory(batch.get("memory"), ctx)
        if memory is not None:
            batch = dict(batch, memory=memory)
        # a tied table is gathered once: its two uses' gradients add up
        # before the data ranks' sum, as they do in one process
        embed = self._read(self.embed, ctx)
        h = self._embed(batch["tokens"], ctx, embed)
        if not cfg.use_rope and cfg.has_attention():
            pos = batch["positions"]
            h = h + L.sinusoidal_pos(S.own_seq(pos, ctx) if tp else pos,
                                     cfg.d_model, cfg.cdtype)
        aux: Dict[str, torch.Tensor] = {}
        if cfg.moe and cfg.moe.n_experts:
            aux = {k: torch.zeros((), dtype=torch.float32, device=h.device)
                   for k in ("moe_lb", "moe_z")}
        h, losses_all = self._run_layers(self.layers, h, batch, ctx,
                                         hooked=True)
        for losses in losses_all:
            aux = {k: aux[k] + v for k, v in losses.items()}
        h = L.norm_apply(self._read(self.final_norm, ctx), h, cfg.norm)
        unembed = embed if cfg.tie_embeddings \
            else self._read(self.unembed, ctx)
        return self._unembed(h, ctx, unembed), aux

    # -------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_seq: int,
                   layout: str = "serve",
                   memory: Optional[torch.Tensor] = None) -> Dict:
        """A decoding cache, one slot dict a layer.

        ``layout="serve"``: the ragged serving cache (DESIGN.md §8): an
        attention layer's ``k``/``v`` of ``[B, S_pad, Hkv, dh]`` where
        slot index == absolute position (local layers too: the window is
        the kernel's mask), ``S_pad`` = ``max_seq`` rounded up to the
        128-token block; an ssd layer's ``conv`` [B, W-1, d_in + 2·G·N]
        (compute dtype) and ``state`` [B, H, N, P] f32; an rglru layer's
        ``conv`` [B, W-1, lru_width] and ``h`` [B, lru_width] f32; plus the
        per-request visibility bound ``kv_len [B]``.  Archs that read a
        memory have no serve layout (``needs_memory``).

        ``layout="decode"``: the legacy dense decode cache (reference
        ``models/model.py:194-257``): a ``global`` or ``cross`` layer's
        ``k``/``v`` [B, max_seq, Hkv, dh] and ``kv_pos`` [B, max_seq]
        (the position a slot holds, -1 = empty); a ``local`` layer's ring
        of ``min(window, max_seq)`` slots, written at ``pos % size``; the
        recurrent layers' states as above; and each ``cross`` layer's
        ``xk``/``xv`` [B, M, Hkv, dh], projected once from ``memory``
        [B, M, D] (through the encoder first where the config has one,
        its attention on the blockwise ``xla`` route; the memory is taken
        in the compute dtype, as ``forward`` takes it)."""
        cfg = self.cfg
        check_arch(cfg)
        if layout not in ("serve", "decode"):
            raise ValueError(f"unknown cache layout {layout!r}")
        if layout == "serve" and needs_memory(cfg):
            raise ValueError(f"{cfg.arch_id}: the serve cache layout does "
                             f"not support cross-attention/encoder "
                             f"architectures; use layout='decode'")
        dev, cdt, f32 = self.device, cfg.cdtype, torch.float32
        b = batch_size
        if layout == "serve":
            s_len = -(-max_seq // SERVE_BLOCK) * SERVE_BLOCK
        else:
            s_len = max_seq
            if "cross" in cfg.layer_pattern:
                if memory is None:
                    raise ValueError(
                        f"{cfg.arch_id}: the decode cache of a "
                        f"cross-attention arch needs the memory its cross "
                        f"layers attend to (Engine(memory=...))")
                if memory.shape[0] != b:
                    raise ValueError(f"memory has {memory.shape[0]} rows, "
                                     f"the cache {b}")
                with torch.no_grad():
                    memory = self._memory(memory.to(dev), ParallelContext(
                        attn_impl="xla", remat=False))

        def slot(blk):
            kind = blk.kind
            if kind == "ssd":
                s = cfg.ssm
                d_in = s.expand * cfg.d_model
                conv_ch = d_in + 2 * s.n_groups * s.d_state
                return {"conv": torch.zeros((b, s.conv_width - 1, conv_ch),
                                            dtype=cdt, device=dev),
                        "state": torch.zeros((b, d_in // s.head_dim,
                                              s.d_state, s.head_dim),
                                             dtype=f32, device=dev)}
            if kind == "rglru":
                w = cfg.rglru.lru_width or cfg.d_model
                return {"conv": torch.zeros((b, cfg.rglru.conv_width - 1, w),
                                            dtype=cdt, device=dev),
                        "h": torch.zeros((b, w), dtype=f32, device=dev)}
            n = s_len
            if layout == "decode" and kind == "local":
                n = min(cfg.window, max_seq)
            shape = (b, n, cfg.n_kv_heads, cfg.head_dim)
            c = {"k": torch.zeros(shape, dtype=cdt, device=dev),
                 "v": torch.zeros(shape, dtype=cdt, device=dev)}
            if layout == "decode":
                c["kv_pos"] = torch.full((b, n), -1, dtype=torch.int32,
                                         device=dev)
            if kind == "cross":
                m = memory.shape[1]
                kv = (b, m, cfg.n_kv_heads, cfg.head_dim)
                with torch.no_grad():
                    c["xk"] = (memory @ blk.attn["xwk"]).reshape(kv)
                    c["xv"] = (memory @ blk.attn["xwv"]).reshape(kv)
            return c

        slots: List[Dict[str, torch.Tensor]] = [
            slot(blk) for blk in self.layers]
        if layout == "decode":
            return {"slots": slots}
        return {"slots": slots,
                "kv_len": torch.zeros(b, dtype=torch.int32, device=dev)}

    @staticmethod
    def reset_serve_slots(cache: Dict, reset_mask: torch.Tensor) -> Dict:
        """Recycle request slots for continuous-batching admission.
        Attention kv needs no clearing: visibility is bounded by
        ``kv_len``, which drops to 0.  Recurrent states and conv windows
        persist across tokens, so the masked rows are zeroed.  In place;
        returns ``cache``."""
        mask = reset_mask.to(cache["kv_len"].device)
        for slot in cache["slots"]:
            if "conv" in slot:
                for x in slot.values():
                    x.masked_fill_(mask.reshape((-1,) + (1,) * (x.ndim - 1)),
                                   0)
        cache["kv_len"] = torch.where(mask, 0, cache["kv_len"])
        return cache

    # ------------------------------------------------------------ serving
    def _serve_attn(self, li: int, p, h, cache_slot, pos, writes,
                    block_req, kv_len_next, kind):
        """Write this step's k/v into the layer's serve-layout cache, then
        one fused ragged cache-attention call over the whole batch.
        h [1, T, D]; ``writes`` = (live rows, their request, their slot)."""
        cfg = self.cfg
        t = h.shape[1]
        posc = pos.clamp(min=0)
        q, k, v = L.qkv_proj(p, h, cfg, posc[None] if cfg.use_rope else None)
        # The reference scatters out of bounds with mode="drop" to skip
        # padding rows, which copies the cache; here only live rows are
        # written, in place.
        live, rows, slots = writes
        cache_slot["k"].index_put_((rows, slots), k[0, live])
        cache_slot["v"].index_put_((rows, slots), v[0, live])
        args = dict(q=q[0], k_cache=cache_slot["k"], v_cache=cache_slot["v"],
                    block_req=block_req, q_pos=pos, kv_len=kv_len_next,
                    window=cfg.window if kind == "local" else 0,
                    softcap=cfg.attn_logit_softcap)
        if self.attn_hook is not None:
            self.attn_hook(li, args)
        out = pf_ops.ragged_decode_attention(**args)
        return out.reshape(1, t, cfg.n_heads * cfg.head_dim) @ p["wo"]

    def _attn_residual_tail(self, blk: Block, h, a, group=None,
                            no_drop=False, cross_fn=None, ctx=None):
        """Post-attention wiring shared by training, serving and decode:
        post-norm, residual, the cross-attention insert ``h + cross_fn(h)``
        of a ``cross`` layer, norm2 -> FFN or MoE (``no_drop`` in serving;
        ``group``, the CAD process group, and ``ctx``, with a grid's model
        axis, in training), post-norm, residual.  Returns (h, the MoE
        layer's aux losses or None)."""
        cfg = self.cfg
        if cfg.post_norms:
            a = L.norm_apply(blk.pnorm1, a, cfg.norm)
        h = h + a
        if cross_fn is not None:
            h = h + cross_fn(h)
        f_in = L.norm_apply(blk.norm2, h, cfg.norm)
        losses = None
        if hasattr(blk, "moe"):
            f, losses = L.moe_apply(blk.moe, f_in, cfg, no_drop=no_drop,
                                    group=group, ctx=ctx)
        else:
            f = L.ffn_apply(blk.ffn, f_in, cfg, ctx)
        if cfg.post_norms:
            f = L.norm_apply(blk.pnorm2, f, cfg.norm)
        return h + f, losses

    def _block_serve(self, li: int, blk: nn.Module, h, cache_slot, pos,
                     writes, block_req, kv_len_next):
        if blk.kind in _RECURRENT:
            return self._recurrent_serve(blk, h, cache_slot, pos)
        a_in = L.norm_apply(blk.norm1, h, self.cfg.norm)
        a = self._serve_attn(li, blk.attn, a_in, cache_slot, pos, writes,
                             block_req, kv_len_next, blk.kind)
        return self._attn_residual_tail(blk, h, a, no_drop=True)[0]

    def _recurrent_step(self, blk: nn.Module, hb, cache_slot, reset):
        """One token of a recurrent layer (reference ``block_decode``,
        ``models/model.py:516-536``): hb [B, 1, D]; ``reset`` [B] bool
        starts an rglru row's recurrence afresh.  Returns (hb, the new
        conv window and state by name); the cache is not written."""
        cfg = self.cfg
        xin = L.norm_apply(blk.norm1, hb, cfg.norm)
        if blk.kind == "ssd":
            y, conv, state = L.ssd_decode(blk.mixer, xin, cache_slot["conv"],
                                          cache_slot["state"], cfg)
            return hb + y, {"conv": conv, "state": state}
        mixer = blk.mixer
        gate_br = F.gelu(xin @ mixer["w_gate_br"], approximate="tanh")
        x, conv = L._causal_conv(xin @ mixer["w_x"], mixer["conv_w"],
                                 mixer["conv_b"], cache_slot["conv"])
        hstate = L.rglru_decode(mixer, x, cache_slot["h"], reset=reset)
        hb = hb + (hstate[:, None].to(hb.dtype) * gate_br) @ mixer["w_out"]
        hb = hb + L.ffn_apply(blk.ffn, L.norm_apply(blk.norm2, hb, cfg.norm),
                              cfg)
        return hb, {"conv": conv, "h": hstate}

    def _recurrent_serve(self, blk: nn.Module, h, cache_slot, pos):
        """A recurrent layer in a decode-mode step (reference
        ``models/model.py:343-372``): row i of the packed [1, T, D] stream
        is request slot i's one token.  Rows with pos == -1 are idle slots
        (e.g. a request waiting while another prefills): their conv window
        and state are kept bit for bit, written back by a masked select;
        the rglru reset at pos == 0 is theirs only when live."""
        hb, new = self._recurrent_step(blk, h[0][:, None], cache_slot,
                                       pos.clamp(min=0) == 0)
        live = pos >= 0
        for name, x in new.items():
            old = cache_slot[name]
            old.copy_(torch.where(
                live.reshape((-1,) + (1,) * (x.ndim - 1)), x, old))
        return hb[:, 0][None]

    def serve_chunk_step(self, cache: Dict, tokens: torch.Tensor,
                         pos: torch.Tensor, block_req: torch.Tensor,
                         kv_len_next: torch.Tensor) -> torch.Tensor:
        """One serving step over a packed ragged request batch: a fused
        prefill chunk (blk_q = 128 request-pure q blocks) or a batched
        decode step (blk_q = 1).

        tokens [T] int32 (0 on padding rows); pos [T] int32 (-1 = padding
        row); block_req [nq] int32 (-1 = dead block), blk_q = T // nq;
        kv_len_next [B] int32, each request's visibility bound after this
        step's cache writes.

        Recurrent (ssd / rglru) layers take decode-mode steps only (blk_q
        1, row i = request slot i, T = the cache's batch), and MoE archs
        decode-mode steps of any T (routing is row-independent without
        drops); a prefill chunk on either raises.

        Returns logits [T, V] f32.  The cache is updated in place (k/v
        written, recurrent states advanced for live rows, ``kv_len`` set
        to ``kv_len_next``)."""
        cfg = self.cfg
        t = tokens.shape[0]
        nq = block_req.shape[0]
        if t % nq:
            raise ValueError(f"{t} tokens do not split into {nq} q blocks")
        if not fused_prefill_ok(cfg):
            if t != nq:
                raise ValueError(
                    f"{cfg.arch_id}: fused chunked prefill needs an "
                    f"attention-only pattern without MoE, got "
                    f"{cfg.layer_pattern} moe="
                    f"{bool(cfg.moe and cfg.moe.n_experts)}; recurrent and "
                    f"MoE layers take decode-mode steps (blk_q 1)")
            if any(kind in _RECURRENT for kind in cfg.layer_pattern) \
                    and t != cache["kv_len"].shape[0]:
                raise ValueError(
                    f"{cfg.arch_id}: a decode-mode step of a recurrent "
                    f"pattern has one row a cache slot ({t} rows, "
                    f"{cache['kv_len'].shape[0]} slots)")
        writes = None
        if cfg.has_attention():
            # the rows every layer writes into its cache, found once per
            # step (nonzero waits for the device)
            live = torch.nonzero(pos >= 0).squeeze(1)
            token_req = block_req.repeat_interleave(t // nq)
            writes = (live, token_req[live].long(), pos[live].long())
        h = self._embed(tokens[None])
        if not cfg.use_rope and cfg.has_attention():
            h = h + L.sinusoidal_pos(pos.clamp(min=0)[None], cfg.d_model,
                                     cfg.cdtype)
        for li, (blk, slot) in enumerate(zip(self.layers, cache["slots"])):
            h = self._block_serve(li, blk, h, slot, pos, writes,
                                  block_req, kv_len_next)
        h = L.norm_apply(self.final_norm, h, cfg.norm)
        cache["kv_len"] = kv_len_next
        return self._unembed(h)[0]

    # ------------------------------------------------------ legacy decode
    @staticmethod
    def _write_cache(cache_slot, k_new, v_new, pos, ring: bool) -> None:
        """Write one token's k/v [B, 1, Hkv, dh] at each row's ``pos``
        (``pos % size`` in a ring), and the position into ``kv_pos``; in
        place (reference ``_write_cache``, ``models/model.py:433``).  The
        reference's ``dynamic_update_slice`` clamps a position past the
        end onto the last slot; ``decode_step`` raises before that."""
        size = cache_slot["k"].shape[1]
        slot = (pos % size if ring else pos).long()
        rows = torch.arange(pos.shape[0], device=pos.device)
        cache_slot["k"][rows, slot] = k_new[:, 0]
        cache_slot["v"][rows, slot] = v_new[:, 0]
        cache_slot["kv_pos"][rows, slot] = pos.to(torch.int32)

    def _attn_decode(self, p, h, cache_slot, pos, kind):
        """Self-attention of one token a row against the dense cache
        (reference ``attn_decode``, ``models/model.py:450``).  h [B,1,D];
        returns [B,1,D]."""
        cfg = self.cfg
        b = h.shape[0]
        posb = pos[:, None]
        q, k, v = L.qkv_proj(p, h, cfg, posb if cfg.use_rope else None)
        self._write_cache(cache_slot, k, v, pos, ring=kind == "local")
        kp = cache_slot["kv_pos"]
        out = decode_attention(q, cache_slot["k"], cache_slot["v"], kp >= 0,
                               posb, kp,
                               window=cfg.window if kind == "local" else 0,
                               softcap=cfg.attn_logit_softcap)
        return out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]

    def _cross_decode(self, p, h, cache_slot):
        """Cross-attention of one token a row to the cached ``xk``/``xv``
        (reference ``cross_decode``, ``models/model.py:471``): every memory
        row is visible (the decode cache keeps no ``memory_mask``), and
        the config's attention softcap applies, as in the reference."""
        cfg = self.cfg
        b = h.shape[0]
        q = (h @ p["xwq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        m = cache_slot["xk"].shape[1]
        mask = torch.ones((b, m), dtype=torch.bool, device=h.device)
        zero = torch.zeros((b, m), dtype=torch.int32, device=h.device)
        out = decode_attention(q, cache_slot["xk"], cache_slot["xv"], mask,
                               zero[:, :1], zero, window=0,
                               softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["xwo"]
        return L.cross_gate(p, out)

    def _block_decode(self, blk: nn.Module, h, cache_slot, pos):
        """One token a row through one layer (reference ``block_decode``,
        ``models/model.py:507``): the attention kinds through
        ``_attn_residual_tail`` (MoE without drops), a ``cross`` layer's
        cross-attention inserted there, the recurrent kinds through
        ``_recurrent_step`` with the rglru reset at pos == 0."""
        if blk.kind in _RECURRENT:
            h, new = self._recurrent_step(blk, h, cache_slot, pos == 0)
            cache_slot.update(new)
            return h
        cfg = self.cfg
        a = self._attn_decode(blk.attn, L.norm_apply(blk.norm1, h, cfg.norm),
                              cache_slot, pos, blk.kind)
        cross_fn = None
        if blk.kind == "cross":
            cross_fn = lambda hh: self._cross_decode(  # noqa: E731
                blk.attn, L.norm_apply(blk.xnorm, hh, cfg.norm), cache_slot)
        return self._attn_residual_tail(blk, h, a, no_drop=True,
                                         cross_fn=cross_fn)[0]

    def decode_step(self, cache: Dict, tokens: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
        """One decode step against a ``layout="decode"`` cache (reference
        ``decode_step``, ``models/model.py:539``).  tokens [B, 1] int32,
        pos [B] int32 (the tokens each row has cached).  Returns logits
        [B, 1, V] f32; the cache is updated in place.  A position past the
        end of a ``global``/``cross`` layer's cache raises (the reference
        clamps it onto the last slot)."""
        cfg = self.cfg
        full = [c["k"].shape[1] for blk, c in zip(self.layers,
                                                 cache["slots"])
                if blk.kind in ("global", "cross")]
        if full and int(pos.max()) >= min(full):
            raise ValueError(f"decode position {int(pos.max())} is past the "
                             f"end of the {min(full)}-slot decode cache")
        h = self._embed(tokens)
        if not cfg.use_rope and cfg.has_attention():
            h = h + L.sinusoidal_pos(pos[:, None], cfg.d_model, cfg.cdtype)
        for blk, slot in zip(self.layers, cache["slots"]):
            h = self._block_decode(blk, h, slot, pos)
        h = L.norm_apply(self.final_norm, h, cfg.norm)
        return self._unembed(h)
