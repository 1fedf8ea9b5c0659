"""Core attention (CA) — the paper's disaggregation boundary.

The port of ``repro.core.attention``, cut to the training slice:
``core_attention`` routes by ``ctx.attn_impl`` to

  ref     — the materialized-mask oracle (small shapes, tests)
  cad     — core attention disaggregation: CA-tasks dispatched across the
            attention-server pool per a scheduler plan (core/dispatch)

The reference's ``xla`` (blockwise flash attention in plain ops) and
``pallas`` (the packed-flash TPU kernel) routes come with later slices
and raise ``NotImplementedError`` naming their ROADMAP item.

Shapes: q [B,Sq,Hq,dh], k/v [B,Skv,Hkv,dh] with Hq % Hkv == 0 (GQA).
segment ids: int32 [B,S]; 0 marks padding (attends nothing / is masked
out of loss anyway), equal nonzero ids attend within the same document.
positions: in-document positions (used for causal and window tests
together with segments).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30  # large-but-finite: keeps padded rows NaN-free

NOT_PORTED = {
    "xla": "the blockwise xla_flash_attention path comes with ROADMAP "
           "queue 1 item 3 (its windowed / non-causal fallback)",
    "pallas": "the packed-flash kernels flash_fwd/flash_bwd come with "
              "ROADMAP queue 1 item 6",
}


def _softcap(x, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(x / cap) * cap
    return x


def mask_fn(seg_q, pos_q, seg_kv, pos_kv, *, causal: bool, window: int,
            sink: int = 0, rate: int = 1, blk: int = 128):
    """Boolean mask [.., Sq, Skv]: True = may attend.

    ``sink``/``rate``/``blk`` are the unpacked static params of a
    non-causal :class:`~repro_torch.core.mask.MaskSpec` (DESIGN.md §12).
    Positions are in-document (packing restarts them per doc)."""
    same = seg_q[..., :, None] == seg_kv[..., None, :]
    valid = (seg_q[..., :, None] > 0) & (seg_kv[..., None, :] > 0)
    m = same & valid
    if causal:
        m = m & (pos_q[..., :, None] >= pos_kv[..., None, :])
    if window and window > 0:
        w = (pos_q[..., :, None] - pos_kv[..., None, :]) < window
        if sink and sink > 0:
            w = w | (pos_kv[..., None, :] < sink)
        m = m & w
    if rate and rate > 1:
        m = m & (((pos_q[..., :, None] // blk)
                  - (pos_kv[..., None, :] // blk)) % rate == 0)
    return m


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def ref_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *, causal=True,
                  window=0, sink=0, rate=1, blk=128, softcap=0.0,
                  scale: Optional[float] = None):
    """O(Sq·Skv) materialized oracle."""
    hq, hkv = q.shape[2], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = _softcap(logits, softcap)
    m = mask_fn(seg_q, pos_q, seg_kv, pos_kv, causal=causal, window=window,
                sink=sink, rate=rate, blk=blk)
    logits = torch.where(m[:, None, :, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    # fully-masked rows (padding) -> zero output instead of uniform garbage
    any_valid = m.any(dim=-1)[:, None, :, None]
    p = torch.where(any_valid, p, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def core_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *, causal=True,
                   window=0, softcap=0.0, ctx=None, scale=None, mask=None):
    """Dispatch by ``ctx.attn_impl`` (default ref).

    ``mask`` is an optional :class:`~repro_torch.core.mask.MaskSpec`
    (DESIGN.md §12) applied on top of segment+causal masking; a
    non-trivial spec overrides the layer-local ``window``."""
    from repro_torch.core.mask import mask_params
    impl = getattr(ctx, "attn_impl", "ref") if ctx is not None else "ref"
    window, sink, rate = mask_params(mask, window)
    if impl == "ref":
        return ref_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv,
                             causal=causal, window=window, softcap=softcap,
                             scale=scale, sink=sink, rate=rate)
    if impl == "cad":
        from repro_torch.core import dispatch as cad_dispatch
        return cad_dispatch.cad_attention(
            q, k, v, seg_q, pos_q, seg_kv, pos_kv, ctx=ctx, causal=causal,
            window=window if mask is None else 0, softcap=softcap,
            scale=scale, mask=mask)
    if impl in NOT_PORTED:
        raise NotImplementedError(f"attn_impl={impl!r}: {NOT_PORTED[impl]}")
    raise ValueError(f"unknown attn impl {impl!r}")
