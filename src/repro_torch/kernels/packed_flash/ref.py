"""Materialised plain-PyTorch oracles for the packed-flash kernels.

The port of ``repro.kernels.packed_flash.ref``, cut to the serving slice:
``ref_ragged_decode``.  It builds the whole ``[nq, Hq, blk_q, S]`` logit
tensor, so it is for tests at small sizes, not for the hot path.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def ref_ragged_decode(q_blocks, k_cache, v_cache, block_req, kv_len, q_pos,
                      *, window=0, softcap=0.0, scale=None):
    """Materialized oracle for the ragged cache-attention kernel.

    q_blocks [nq, blk_q, Hq, dh]; k_cache/v_cache [R, S, Hkv, dh];
    block_req [nq] (-1 = dead block); kv_len [R]; q_pos [nq, blk_q]
    (-1 = padded row).  Cache slot index == absolute position (the serving
    layout is non-ring); causal always.  Returns [nq, blk_q, Hq, dh].
    """
    nq, blk_q, hq, dh = q_blocks.shape
    R, S, hkv, _ = k_cache.shape
    rep = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    block_req = block_req.long()
    q_pos = q_pos.long()

    safe_req = block_req.clamp(min=0)
    kb = k_cache.repeat_interleave(rep, dim=2)[safe_req].float()
    vb = v_cache.repeat_interleave(rep, dim=2)[safe_req].float()
    logits = torch.einsum("nqhd,nshd->nhqs", q_blocks.float(), kb) * scale
    if softcap and softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    s_pos = torch.arange(S, device=q_blocks.device)
    m = (block_req >= 0)[:, None, None]
    m = m & (q_pos >= 0)[:, :, None]
    m = m & (s_pos[None, None, :] < kv_len.long()[safe_req][:, None, None])
    m = m & (q_pos[:, :, None] >= s_pos[None, None, :])
    if window and window > 0:
        m = m & ((q_pos[:, :, None] - s_pos[None, None, :]) < window)
    logits = torch.where(m[:, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(m[:, None].any(-1)[..., None], p, 0.0)
    out = torch.einsum("nhqs,nshd->nqhd", p, vb)
    return out.to(q_blocks.dtype)
