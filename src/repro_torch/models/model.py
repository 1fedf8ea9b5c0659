"""Model assembly: decoders trained on packed documents (``forward``)
and dense decoders served from the ragged serving cache (DESIGN.md §8).

The port of ``repro.models.model``.  The reference stacks each pattern
slot's weights on a leading ``[n_groups]`` axis and scans over it; here
each layer is its own module in ``Transformer.layers`` and the scan is a
Python loop.  Layer ``l`` is pattern slot ``l % period`` of group
``l // period``.

What trains: patterns of ``global``, ``local``, ``ssd`` and ``rglru``
layers (dense MLPs, optional post-norms, softcaps, tied embeddings; the
Mamba-2 SSD block; the RecurrentGemma RG-LRU block), under every
``attn_impl`` (with ``cad``, ``local`` layers take the dispatch's
windowed fallback, ``xla_flash_attention``; ``ssd`` layers run their
intra-chunk step and ``rglru`` layers their recurrence in the CUDA
kernels under ``pallas`` and in torch ops otherwise).  What serves: the
same patterns, from the ragged serving cache; ``ssd`` and ``rglru``
layers keep their conv window and recurrent state in it and run
decode-mode steps only (one token a request, ``ssd_decode`` /
``rglru_decode``).  MoE layers, cross-attention, the encoder and the
legacy ``layout="decode"`` cache raise ``NotImplementedError`` naming
what brings them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.data.packing import BLOCK as SERVE_BLOCK
from repro_torch.kernels.packed_flash import ops as pf_ops
from repro_torch.models import layers as L

_ATTN_KINDS = ("global", "local")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    the port never carries on on the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return device


_LATER = {"cross": "the cross-attention slice (whisper, llama3.2-vision)"}
_RECURRENT = ("ssd", "rglru")


def check_arch(cfg) -> None:
    """Raise for what the port cannot build, train and serve yet (every
    arch that trains serves: recurrent layers in decode-mode steps)."""
    for kind in cfg.layer_pattern:
        if kind not in _ATTN_KINDS + _RECURRENT:
            raise NotImplementedError(
                f"{cfg.arch_id}: {kind!r} layers come with "
                f"{_LATER.get(kind, 'a later slice')}")
    if cfg.moe and cfg.moe.n_experts:
        raise NotImplementedError(f"{cfg.arch_id}: MoE layers come with the "
                                  f"MoE slice (qwen2-moe, llama4-maverick)")
    if cfg.encoder and cfg.encoder.n_layers:
        raise NotImplementedError(f"{cfg.arch_id}: the encoder comes with the "
                                  f"cross-attention slice")
    if cfg.qk_norm:
        raise NotImplementedError(f"{cfg.arch_id}: qk_norm is not ported")


def fused_prefill_ok(cfg) -> bool:
    """Whether prompts may be prefilled in fused chunks (blk_q 128): only
    attention-only patterns.  Recurrent mixers are sequential, so their
    archs prefill a token a request per step (decode-mode chunks)."""
    return all(kind in _ATTN_KINDS for kind in cfg.layer_pattern) \
        and not (cfg.moe and cfg.moe.n_experts)


class Block(nn.Module):
    """One attention layer: norm1 -> attn -> [pnorm1] -> residual ->
    norm2 -> ffn -> [pnorm2] -> residual."""

    def __init__(self, cfg, kind: str, gen: torch.Generator, device):
        super().__init__()
        self.kind = kind
        dt = cfg.pdtype
        self.norm1 = L.norm_init(cfg.d_model, dt, cfg.norm, device)
        self.attn = L.attn_init(gen, cfg, device)
        self.norm2 = L.norm_init(cfg.d_model, dt, cfg.norm, device)
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
    """Decoder for training and, with attention-only patterns, serving.
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
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.embed[tokens.long()].to(cfg.cdtype)
        if cfg.scale_embed:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype,
                                 device=h.device)
        return h

    def _unembed(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        table = self.embed if cfg.tie_embeddings else self.unembed
        logits = (h @ table.T).float()
        if cfg.final_logit_softcap:
            logits = torch.tanh(logits / cfg.final_logit_softcap) \
                * cfg.final_logit_softcap
        return logits

    # ----------------------------------------------------------- training
    def _block_train(self, li: int, blk: nn.Module, h, batch, ctx):
        """``block_apply`` (reference ``models/model.py:88-130``): for an
        attention layer norm1 -> self-attention -> [pnorm1] -> residual ->
        norm2 -> FFN -> [pnorm2] -> residual; for an ssd layer norm1 ->
        SSD mixer -> residual; for an rglru layer norm1 -> RG-LRU mixer ->
        residual -> norm2 -> FFN -> residual."""
        cfg = self.cfg
        hook = None
        if self.attn_hook is not None:
            hook = lambda inputs, li=li: self.attn_hook(li, inputs)  # noqa
        if blk.kind == "ssd":
            return h + L.ssd_apply(blk.mixer,
                                   L.norm_apply(blk.norm1, h, cfg.norm),
                                   batch, cfg, ctx, hook=hook)
        if blk.kind == "rglru":
            h = h + L.rglru_apply(blk.mixer,
                                  L.norm_apply(blk.norm1, h, cfg.norm),
                                  batch, cfg, ctx, hook=hook)
            return h + L.ffn_apply(blk.ffn,
                                   L.norm_apply(blk.norm2, h, cfg.norm), cfg)
        window = cfg.window if blk.kind == "local" else 0
        a = L.self_attn_apply(blk.attn, L.norm_apply(blk.norm1, h, cfg.norm),
                              batch, cfg, ctx, causal=True, window=window,
                              hook=hook)
        return self._attn_residual_tail(blk, h, a)

    def forward(self, batch: Dict[str, torch.Tensor], ctx) \
            -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Packed-LM forward.  ``batch`` holds ``tokens``,
        ``segment_ids`` and ``positions`` [B, S] on the model's device
        (and, with ``ctx.attn_impl == "cad"``, the step's plan is bound in
        ``ctx.cad``).  With ``ctx.remat`` each layer's forward is re-run
        in the backward (``torch.utils.checkpoint``, non-reentrant)
        instead of keeping its activations.  Returns (logits [B,S,V] f32,
        aux-losses: empty without MoE layers)."""
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        if not cfg.use_rope and cfg.has_attention():
            h = h + L.sinusoidal_pos(batch["positions"], cfg.d_model,
                                     cfg.cdtype)
        for li, blk in enumerate(self.layers):
            if ctx.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(
                    self._block_train, li, blk, h, batch, ctx,
                    use_reentrant=False)
            else:
                h = self._block_train(li, blk, h, batch, ctx)
        h = L.norm_apply(self.final_norm, h, cfg.norm)
        return self._unembed(h), {}

    # -------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_seq: int,
                   layout: str = "serve") -> Dict:
        """The ragged serving cache (DESIGN.md §8), one slot dict a layer:
        an attention layer's ``k``/``v`` of ``[B, S_pad, Hkv, dh]`` where
        slot index == absolute position (local layers too: the window is
        the kernel's mask), ``S_pad`` = ``max_seq`` rounded up to the
        128-token block; an ssd layer's ``conv`` [B, W-1, d_in + 2·G·N]
        (compute dtype) and ``state`` [B, H, N, P] f32; an rglru layer's
        ``conv`` [B, W-1, lru_width] and ``h`` [B, lru_width] f32; plus the
        per-request visibility bound ``kv_len [B]``."""
        if layout == "decode":
            raise NotImplementedError(
                f"{self.cfg.arch_id}: the legacy dense decode cache "
                f"(layout='decode') is not ported (ROADMAP queue 1 item 10, "
                f"with item 12); the serving engine uses layout='serve'")
        if layout != "serve":
            raise ValueError(f"unknown cache layout {layout!r}")
        cfg = self.cfg
        check_arch(cfg)
        dev, cdt, f32 = self.device, cfg.cdtype, torch.float32
        s_pad = -(-max_seq // SERVE_BLOCK) * SERVE_BLOCK
        b = batch_size

        def slot(kind):
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
            shape = (b, s_pad, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=cdt, device=dev),
                    "v": torch.zeros(shape, dtype=cdt, device=dev)}

        slots: List[Dict[str, torch.Tensor]] = [
            slot(blk.kind) for blk in self.layers]
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

    def _attn_residual_tail(self, blk: Block, h, a):
        """Post-attention wiring: post-norm, residual, norm2 -> FFN,
        post-norm, residual."""
        cfg = self.cfg
        if cfg.post_norms:
            a = L.norm_apply(blk.pnorm1, a, cfg.norm)
        h = h + a
        f = L.ffn_apply(blk.ffn, L.norm_apply(blk.norm2, h, cfg.norm), cfg)
        if cfg.post_norms:
            f = L.norm_apply(blk.pnorm2, f, cfg.norm)
        return h + f

    def _block_serve(self, li: int, blk: nn.Module, h, cache_slot, pos,
                     writes, block_req, kv_len_next):
        if blk.kind in _RECURRENT:
            return self._recurrent_serve(blk, h, cache_slot, pos)
        a_in = L.norm_apply(blk.norm1, h, self.cfg.norm)
        a = self._serve_attn(li, blk.attn, a_in, cache_slot, pos, writes,
                             block_req, kv_len_next, blk.kind)
        return self._attn_residual_tail(blk, h, a)

    def _recurrent_serve(self, blk: nn.Module, h, cache_slot, pos):
        """A recurrent layer in a decode-mode step (reference
        ``models/model.py:343-372``): row i of the packed [1, T, D] stream
        is request slot i's one token.  Rows with pos == -1 are idle slots
        (e.g. a request waiting while another prefills): their conv window
        and state are kept bit for bit, written back by a masked select;
        the rglru reset at pos == 0 is theirs only when live."""
        cfg = self.cfg
        hb = h[0][:, None]                                   # [B,1,D]
        xin = L.norm_apply(blk.norm1, hb, cfg.norm)
        if blk.kind == "ssd":
            y, conv, state = L.ssd_decode(blk.mixer, xin, cache_slot["conv"],
                                          cache_slot["state"], cfg)
            hb = hb + y
            new = {"conv": conv, "state": state}
        else:
            mixer = blk.mixer
            gate_br = F.gelu(xin @ mixer["w_gate_br"], approximate="tanh")
            x, conv = L._causal_conv(xin @ mixer["w_x"], mixer["conv_w"],
                                     mixer["conv_b"], cache_slot["conv"])
            hstate = L.rglru_decode(mixer, x, cache_slot["h"],
                                    reset=pos.clamp(min=0) == 0)
            hb = hb + (hstate[:, None].to(hb.dtype) * gate_br) \
                @ mixer["w_out"]
            hb = hb + L.ffn_apply(blk.ffn,
                                  L.norm_apply(blk.norm2, hb, cfg.norm), cfg)
            new = {"conv": conv, "h": hstate}
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
        1, row i = request slot i, T = the cache's batch); a prefill
        chunk on a recurrent pattern raises.

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
                    f"attention-only pattern, got {cfg.layer_pattern}; "
                    f"recurrent layers take decode-mode steps (blk_q 1)")
            if t != cache["kv_len"].shape[0]:
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
