"""Core attention (CA) — the paper's disaggregation boundary.

The port of ``repro.core.attention``: ``core_attention`` routes by
``ctx.attn_impl`` to

  ref     — the materialized-mask oracle (small shapes, tests)
  xla     — blockwise online-softmax flash attention in plain torch ops
            with a recompute backward (memory O(S·blk))
  pallas  — the packed-flash kernels (``kernels/packed_flash``: the CUDA
            kernels on CUDA tensors, their plain versions on the CPU)
  cad     — core attention disaggregation: CA-tasks dispatched across the
            attention-server pool per a scheduler plan (core/dispatch)

Shapes: q [B,Sq,Hq,dh], k/v [B,Skv,Hkv,dh] with Hq % Hkv == 0 (GQA).
segment ids: int32 [B,S]; 0 marks padding (attends nothing / is masked
out of loss anyway), equal nonzero ids attend within the same document.
positions: in-document positions (used for causal and window tests
together with segments).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs.regions import marked

NEG_INF = -2.0 ** 30  # large-but-finite: keeps padded rows NaN-free
LSE_DEAD = 2.0 ** 30  # lse of a fully masked row: exp(x - LSE_DEAD) == 0


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


@marked("attention")
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


# --------------------------------------------------------------------- xla
@marked("attention")
def xla_flash_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *,
                        causal=True, window=0, sink=0, rate=1, blk=128,
                        softcap=0.0, scale: Optional[float] = None,
                        q_block: int = 512, kv_block: int = 512,
                        skip_masked_blocks: bool = True):
    """Blockwise online-softmax attention in plain torch ops with a
    flash-style recompute backward (memory O(S·blk) in both passes).

    The baseline enumerates the full (q_block x kv_block) rectangle; with
    ``skip_masked_blocks`` (the causal-triangle variant) only block pairs
    that can hold unmasked entries are visited, from a static
    lower-triangle pair list, when ``causal`` and Sq == Skv.  Sequences
    are padded to the block (padding is segment 0).  The reference's
    ``shard_hint`` pins its scan accumulators on a device mesh; on the
    port's grid this route (and the colocated ``pallas`` route) simply
    runs on the rank's local heads, which nothing here needs to know."""
    opts = dict(causal=causal, window=window, sink=sink, rate=rate, blk=blk,
                softcap=softcap, scale=scale, q_block=q_block,
                kv_block=kv_block, skip_masked_blocks=skip_masked_blocks)
    return _XlaFlash.apply(q, k, v, seg_q, pos_q, seg_kv, pos_kv, opts)


def _pad_rows(x, n):
    """Pad dim 1 of ``x`` with ``n`` zero rows."""
    if not n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))],
                     dim=1)


def _prep_blocks(q, k, v, seg_q, pos_q, seg_kv, pos_kv, q_block, kv_block,
                 causal, skip_masked_blocks):
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    nq = -(-sq // q_block)
    nk = -(-skv // kv_block)
    pad_q = nq * q_block - sq
    pad_k = nk * kv_block - skv
    qb = _pad_rows(q, pad_q).reshape(b, nq, q_block, hq, dh)
    kb = _pad_rows(k, pad_k).reshape(b, nk, kv_block, k.shape[2], dh)
    vb = _pad_rows(v, pad_k).reshape(b, nk, kv_block, k.shape[2], dh)
    sqb = _pad_rows(seg_q, pad_q).reshape(b, nq, q_block)
    pqb = _pad_rows(pos_q, pad_q).reshape(b, nq, q_block)
    skb = _pad_rows(seg_kv, pad_k).reshape(b, nk, kv_block)
    pkb = _pad_rows(pos_kv, pad_k).reshape(b, nk, kv_block)
    # static (i, j) pair list.  Packed chunks lay documents out in order,
    # so causal triangle pruning is sound on chunk-position blocks.
    if skip_masked_blocks and causal and sq == skv:
        pairs = [(i, j) for i in range(nq) for j in range(nk)
                 if j * kv_block < (i + 1) * q_block]
    else:
        pairs = [(i, j) for i in range(nq) for j in range(nk)]
    return (qb, kb, vb, sqb, pqb, skb, pkb, pairs,
            (b, sq, hq, dh, nq, nk, q_block, kv_block))


def _pair_logits(qi, kj, sqi, pqi, skj, pkj, scale, softcap, causal,
                 window, sink, rate, blk):
    """Logits [b, h, q, k] and mask [b, q, k] of one (q-block, kv-block)
    pair, in f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qi.float(), kj.float()) * scale
    logits = _softcap(logits, softcap)
    msk = mask_fn(sqi, pqi, skj, pkj, causal=causal, window=window,
                  sink=sink, rate=rate, blk=blk)
    return torch.where(msk[:, None], logits, NEG_INF), msk


def _xla_flash_fwd(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *, causal, window,
                   sink, rate, blk, softcap, scale, q_block, kv_block,
                   skip_masked_blocks):
    """Returns (out like q, lse [b, nq, hq, q_block] f32)."""
    n_rep = q.shape[2] // k.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    (qb, kb, vb, sqb, pqb, skb, pkb, pairs,
     (b, sq, hq, dh, nq, _, qbk, _)) = _prep_blocks(
        q, k, v, seg_q, pos_q, seg_kv, pos_kv, q_block, kv_block, causal,
        skip_masked_blocks)
    dev = q.device
    m_acc = torch.full((b, nq, hq, qbk), NEG_INF, device=dev)
    l_acc = torch.zeros((b, nq, hq, qbk), device=dev)
    o_acc = torch.zeros((b, nq, hq, qbk, dh), device=dev)
    for i, j in pairs:
        logits, msk = _pair_logits(
            qb[:, i], _repeat_kv(kb[:, j], n_rep), sqb[:, i], pqb[:, i],
            skb[:, j], pkb[:, j], scale, softcap, causal, window, sink, rate,
            blk)
        mi = m_acc[:, i]
        m_new = torch.maximum(mi, logits.amax(-1))
        p = torch.where(msk[:, None], torch.exp(logits - m_new[..., None]),
                        0.0)
        corr = torch.exp(mi - m_new)
        l_acc[:, i] = l_acc[:, i] * corr + p.sum(-1)
        o_acc[:, i] = o_acc[:, i] * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, _repeat_kv(vb[:, j], n_rep).float())
        m_acc[:, i] = m_new
    out = o_acc / l_acc.clamp(min=1e-30)[..., None]
    live = m_acc > NEG_INF / 2
    out = torch.where(live[..., None], out, 0.0)
    # logsumexp per row; dead rows get +big so recomputed p underflows to 0
    lse = torch.where(live, m_acc + torch.log(l_acc.clamp(min=1e-30)),
                      LSE_DEAD)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, nq * qbk, hq, dh)
    return out[:, :sq].to(q.dtype), lse


def _xla_flash_bwd(q, k, v, seg_q, pos_q, seg_kv, pos_kv, out, lse, g, *,
                   causal, window, sink, rate, blk, softcap, scale, q_block,
                   kv_block, skip_masked_blocks):
    """Flash-style recompute backward: per (i, j) pair recompute p from
    the saved logsumexp, accumulate dq/dk/dv (GQA repeats folded back onto
    kv heads per pair)."""
    hkv = k.shape[2]
    n_rep = q.shape[2] // hkv
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    (qb, kb, vb, sqb, pqb, skb, pkb, pairs,
     (b, sq, hq, dh, nq, nk, qbk, kbk)) = _prep_blocks(
        q, k, v, seg_q, pos_q, seg_kv, pos_kv, q_block, kv_block, causal,
        skip_masked_blocks)
    pad_q = nq * qbk - sq
    gb = _pad_rows(g.float(), pad_q).reshape(b, nq, qbk, hq, dh)
    ob = _pad_rows(out.float(), pad_q).reshape(b, nq, qbk, hq, dh)
    delta = torch.einsum("biqhd,biqhd->bihq", gb, ob)      # [b, nq, hq, qbk]
    dev = q.device
    dq = torch.zeros((b, nq, qbk, hq, dh), device=dev)
    dk = torch.zeros((b, nk, kbk, hkv, dh), device=dev)
    dv = torch.zeros_like(dk)
    for i, j in pairs:
        qi = qb[:, i]
        kj = _repeat_kv(kb[:, j], n_rep)
        vj = _repeat_kv(vb[:, j], n_rep)
        logits, msk = _pair_logits(
            qi, kj, sqb[:, i], pqb[:, i], skb[:, j], pkb[:, j], scale,
            softcap, causal, window, sink, rate, blk)
        p = torch.where(msk[:, None], torch.exp(logits - lse[:, i, ..., None]),
                        0.0)
        gi = gb[:, i]                                       # [b,qbk,hq,dh]
        dvj = torch.einsum("bhqk,bqhd->bkhd", p, gi)
        dp = torch.einsum("bqhd,bkhd->bhqk", gi, vj.float())
        ds = p * (dp - delta[:, i, ..., None])
        if softcap and softcap > 0:
            # s = cap*tanh(s_raw/cap); ds_raw = ds * (1 - (s/cap)^2)
            sc = torch.where(msk[:, None], logits / softcap, 0.0)
            ds = ds * (1.0 - sc * sc)
        ds = ds * scale
        dq[:, i] += torch.einsum("bhqk,bkhd->bqhd", ds, kj.float())
        dkj = torch.einsum("bhqk,bqhd->bkhd", ds, qi.float())
        dk[:, j] += dkj.reshape(b, kbk, hkv, n_rep, dh).sum(3)
        dv[:, j] += dvj.reshape(b, kbk, hkv, n_rep, dh).sum(3)
    skv = k.shape[1]
    return (dq.reshape(b, nq * qbk, hq, dh)[:, :sq].to(q.dtype),
            dk.reshape(b, nk * kbk, hkv, dh)[:, :skv].to(k.dtype),
            dv.reshape(b, nk * kbk, hkv, dh)[:, :skv].to(v.dtype))


class _XlaFlash(torch.autograd.Function):
    """Forward saves (q, k, v, segments, positions, out, lse); backward is
    the blockwise recompute."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, pos_q, seg_kv, pos_kv, opts):
        out, lse = _xla_flash_fwd(q, k, v, seg_q, pos_q, seg_kv, pos_kv,
                                  **opts)
        ctx.save_for_backward(q, k, v, seg_q, pos_q, seg_kv, pos_kv, out,
                              lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = _xla_flash_bwd(*ctx.saved_tensors, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------- decoding
def _decode_probs(q, k_cache, v_cache, cache_len_mask, pos_q, pos_kv, *,
                  window, softcap, scale):
    """The decode attention's masked f32 logits [B,Hq,Sq,S], its mask and
    its probabilities (rows with no visible slot all 0)."""
    dh = q.shape[-1]
    n_rep = q.shape[2] // k_cache.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    k = _repeat_kv(k_cache, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = _softcap(logits, softcap)
    m = cache_len_mask[:, None, None, :] & (
        pos_q[:, None, :, None] >= pos_kv[:, None, None, :])
    if window and window > 0:
        m = m & ((pos_q[:, None, :, None] - pos_kv[:, None, None, :])
                 < window)
    logits = torch.where(m, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(m.any(-1)[..., None], p, 0.0)
    return logits, m, p


@marked("attention")
def decode_attention(q, k_cache, v_cache, cache_len_mask, pos_q, pos_kv, *,
                     window=0, softcap=0.0, scale: Optional[float] = None):
    """One-token (or few-token) query against a dense cache, the legacy
    decode path's attention (reference ``core/attention.py:374-400``): an
    f32 einsum, a masked softmax and an einsum, outside any kernel, as the
    reference computes it.

    q [B,Sq,Hq,dh]; caches [B,S,Hkv,dh]; cache_len_mask [B,S] bool (True =
    the slot holds a real token); pos_q [B,Sq]; pos_kv [B,S] absolute
    positions (a ring buffer's slot order is not its position order)."""
    _, _, p = _decode_probs(q, k_cache, v_cache, cache_len_mask, pos_q,
                            pos_kv, window=window, softcap=softcap,
                            scale=scale)
    v = _repeat_kv(v_cache, q.shape[2] // v_cache.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


@marked("attention")
def decode_attention_partial(q, k_cache, v_cache, cache_len_mask, pos_q,
                             pos_kv, *, window=0, softcap=0.0,
                             scale: Optional[float] = None):
    """``decode_attention`` over one slice of a cache, as a partial for
    :func:`merge_decode_partials`: (out [B,Sq,Hq,dh] f32, normalized over
    the slice; lse [B,Hq,Sq] f32, the log-sum-exp of the slice's visible
    logits).  A row with no visible slot gives out 0 and lse ``LSE_DEAD``,
    which the merge treats as absent."""
    logits, m, p = _decode_probs(q, k_cache, v_cache, cache_len_mask, pos_q,
                                 pos_kv, window=window, softcap=softcap,
                                 scale=scale)
    v = _repeat_kv(v_cache, q.shape[2] // v_cache.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    lse = torch.where(m.any(-1), torch.logsumexp(logits, dim=-1), LSE_DEAD)
    return out, lse


def merge_decode_partials(out, lse):
    """Merge attention partials stacked on dim 0, out [n,B,Sq,H,dh] f32 and
    lse [n,B,H,Sq] f32, by ``merge_softmax_partials``' arithmetic over n
    (the max of the live lse, their log-sum-exp, then each partial
    weighted by exp(lse_i - lse), a dead one by 0), summed in the order of
    dim 0.  Returns (out [B,Sq,H,dh] f32, lse [B,H,Sq]); rows dead in
    every partial give out 0 and lse ``LSE_DEAD``."""
    dead = lse >= LSE_DEAD / 2
    la = torch.where(dead, -LSE_DEAD, lse)
    m = la.max(0).values
    lse_m = m + torch.log(torch.exp(la - m).sum(0))
    w = torch.where(dead, 0.0, torch.exp(lse - lse_m))
    merged = (w.transpose(-1, -2)[..., None] * out).sum(0)
    return merged, torch.where(dead.all(0), LSE_DEAD, lse_m)


# ------------------------------------------------------------------ router
def core_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *, causal=True,
                   window=0, softcap=0.0, ctx=None, scale=None, mask=None):
    """Dispatch by ``ctx.attn_impl`` (default ref).

    ``mask`` is an optional :class:`~repro_torch.core.mask.MaskSpec`
    (DESIGN.md §12) applied on top of segment+causal masking; a
    non-trivial spec overrides the layer-local ``window``."""
    from repro_torch.core.mask import mask_params
    impl = getattr(ctx, "attn_impl", "ref") if ctx is not None else "ref"
    window, sink, rate = mask_params(mask, window)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              sink=sink, rate=rate)
    if impl == "ref":
        return ref_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv, **kw)
    if impl == "xla":
        return xla_flash_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv,
                                   **kw)
    if impl == "pallas":
        from repro_torch.kernels.packed_flash import ops as pf_ops
        return pf_ops.packed_flash_attention(q, k, v, seg_q, pos_q, seg_kv,
                                             pos_kv, **kw)
    if impl == "cad":
        from repro_torch.core import dispatch as cad_dispatch
        return cad_dispatch.cad_attention(
            q, k, v, seg_q, pos_q, seg_kv, pos_kv, ctx=ctx, causal=causal,
            window=window if mask is None else 0, softcap=softcap,
            scale=scale, mask=mask)
    raise ValueError(f"unknown attn impl {impl!r}")
