"""Model assembly: a dense decoder trained on packed documents
(``forward``) and served from the ragged serving cache (DESIGN.md §8).

The port of ``repro.models.model`` for dense attention stacks.  The
reference stacks each pattern slot's weights on a leading ``[n_groups]``
axis and scans over it; here each layer is its own module in
``Transformer.layers`` and the scan is a Python loop.  Layer ``l`` is
pattern slot ``l % period`` of group ``l // period``.

What runs: attention-only patterns of ``global`` and ``local`` layers
(dense MLPs, optional post-norms, softcaps, tied embeddings).  Training
with ``attn_impl="cad"`` takes causal ``global`` layers; a ``local``
layer there needs the windowed fallback (ROADMAP queue 1 item 3).
Recurrent (``ssd``/``rglru``) and MoE layers, cross-attention, the
encoder and the legacy ``layout="decode"`` cache raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
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


def check_serving_arch(cfg) -> None:
    """Raise for what the serving slice does not port yet."""
    later = {"ssd": "the mamba2 slice (ssd_chunk kernel)",
             "rglru": "the recurrentgemma slice (lru_scan kernel)",
             "cross": "the cross-attention slice (whisper, llama3.2-vision)"}
    for kind in cfg.layer_pattern:
        if kind not in _ATTN_KINDS:
            raise NotImplementedError(
                f"{cfg.arch_id}: {kind!r} layers come with "
                f"{later.get(kind, 'a later slice')}")
    if cfg.moe and cfg.moe.n_experts:
        raise NotImplementedError(f"{cfg.arch_id}: MoE layers come with the "
                                  f"MoE slice (qwen2-moe, llama4-maverick)")
    if cfg.encoder and cfg.encoder.n_layers:
        raise NotImplementedError(f"{cfg.arch_id}: the encoder comes with the "
                                  f"cross-attention slice")
    if cfg.qk_norm:
        raise NotImplementedError(f"{cfg.arch_id}: qk_norm is not ported")


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


class Transformer(nn.Module):
    """Dense decoder for serving.  Weights are drawn from ``seed``
    (normal * fan_in**-0.5, per tensor, in the param dtype, on ``device``);
    ``load_state_dict(convert.params_from_jax(...))`` replaces them."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        check_serving_arch(cfg)
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
        self.layers = nn.ModuleList(
            Block(cfg, cfg.layer_pattern[i % cfg.period], gen, device)
            for i in range(cfg.n_layers))
        # inspection hook: called as attn_hook(layer, inputs) with the
        # attention inputs just before each attention call (serving: the
        # kernel's arguments; training: q, k, v, segment_ids, positions
        # and the ParallelContext)
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
    def _block_train(self, li: int, blk: Block, h, batch, ctx):
        """``block_apply`` of an attention layer (reference
        ``models/model.py:88-124``): norm1 -> self-attention -> [pnorm1]
        -> residual -> norm2 -> FFN -> [pnorm2] -> residual."""
        cfg = self.cfg
        window = cfg.window if blk.kind == "local" else 0
        hook = None
        if self.attn_hook is not None:
            hook = lambda inputs, li=li: self.attn_hook(li, inputs)  # noqa
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
        aux-losses: empty for dense stacks)."""
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        if not cfg.use_rope:
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
        """The ragged serving cache (DESIGN.md §8): per layer ``k``/``v``
        of ``[B, S_pad, Hkv, dh]`` where slot index == absolute position
        (local layers too: the window is the kernel's mask), ``S_pad`` =
        ``max_seq`` rounded up to the 128-token block, plus the
        per-request visibility bound ``kv_len [B]``."""
        if layout == "decode":
            raise NotImplementedError(
                "the legacy dense decode cache (layout='decode') is not "
                "ported; the serving engine uses layout='serve'")
        if layout != "serve":
            raise ValueError(f"unknown cache layout {layout!r}")
        cfg = self.cfg
        s_pad = -(-max_seq // SERVE_BLOCK) * SERVE_BLOCK
        shape = (batch_size, s_pad, cfg.n_kv_heads, cfg.head_dim)
        slots: List[Dict[str, torch.Tensor]] = [
            {"k": torch.zeros(shape, dtype=cfg.cdtype, device=self.device),
             "v": torch.zeros(shape, dtype=cfg.cdtype, device=self.device)}
            for _ in self.layers]
        return {"slots": slots,
                "kv_len": torch.zeros(batch_size, dtype=torch.int32,
                                      device=self.device)}

    @staticmethod
    def reset_serve_slots(cache: Dict, reset_mask: torch.Tensor) -> Dict:
        """Recycle request slots for continuous-batching admission.
        Attention kv needs no clearing: visibility is bounded by
        ``kv_len``, which drops to 0.  In place; returns ``cache``."""
        cache["kv_len"] = torch.where(reset_mask.to(cache["kv_len"].device),
                                      0, cache["kv_len"])
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

    def _block_serve(self, li: int, blk: Block, h, cache_slot, pos,
                     writes, block_req, kv_len_next):
        a_in = L.norm_apply(blk.norm1, h, self.cfg.norm)
        a = self._serve_attn(li, blk.attn, a_in, cache_slot, pos, writes,
                             block_req, kv_len_next, blk.kind)
        return self._attn_residual_tail(blk, h, a)

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

        Returns logits [T, V] f32.  The cache is updated in place (k/v
        written, ``kv_len`` set to ``kv_len_next``)."""
        cfg = self.cfg
        t = tokens.shape[0]
        nq = block_req.shape[0]
        if t % nq:
            raise ValueError(f"{t} tokens do not split into {nq} q blocks")
        # the rows every layer writes into its cache, found once per step
        # (nonzero waits for the device)
        live = torch.nonzero(pos >= 0).squeeze(1)
        token_req = block_req.repeat_interleave(t // nq)
        writes = (live, token_req[live].long(), pos[live].long())
        h = self._embed(tokens[None])
        if not cfg.use_rope:
            h = h + L.sinusoidal_pos(pos.clamp(min=0)[None], cfg.d_model,
                                     cfg.cdtype)
        for li, (blk, slot) in enumerate(zip(self.layers, cache["slots"])):
            h = self._block_serve(li, blk, h, slot, pos, writes,
                                  block_req, kv_len_next)
        h = L.norm_apply(self.final_norm, h, cfg.norm)
        cache["kv_len"] = kv_len_next
        return self._unembed(h)[0]
