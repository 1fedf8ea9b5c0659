"""Ragged cache attention for serving: the CUDA kernel's wrapper and its
plain PyTorch version (DESIGN.md §8).

``ragged_decode_attention`` keeps the signature and layout of
``repro.kernels.packed_flash.ops.ragged_decode_attention``.  On CUDA
tensors it launches the hand-written kernel ``csrc/ragged_decode.cu``
(built with ``nvcc`` at first use) or raises; on CPU tensors it runs
``ragged_decode_reference``, the blockwise online-softmax version in
PyTorch.  There is no other route: no fallback from the card to the plain
version, no environment switch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
KV_TILE = 64                  # the CUDA kernel's kv tile; S must divide by it
_SOURCE = Path(__file__).resolve().parent / "csrc" / "ragged_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
_BLK_Q = (1, 128)

#: kernel launches made by ``ragged_decode_attention`` (a plain count a run
#: resets and reads to show that the main path went through the kernel)
launches = {"ragged_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def ragged_decode_reference(q, k_cache, v_cache, block_req, q_pos, kv_len,
                            *, window=0, softcap=0.0, scale=None, blk_k=128):
    """Plain PyTorch version of the kernel, with the wrapper's signature.

    Per q block it gathers the request's cache and runs the online-softmax
    recurrence of ``_xla_ragged_decode`` over ``blk_k``-slot kv blocks in
    f32, with GQA kept as a [Hkv, rep] split of the q heads instead of a
    repeat of the cache.  Shapes as ``ragged_decode_attention``."""
    t, hq, dh = q.shape
    nq = block_req.shape[0]
    if t % nq:
        raise ValueError(f"{t} query rows do not split into {nq} blocks")
    blk_q = t // nq
    R, S, hkv, _ = k_cache.shape
    rep = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    blk_k = min(blk_k, S)
    if S % blk_k:
        raise ValueError(f"cache length {S} is not a multiple of {blk_k}")

    block_req = block_req.long()
    pos = q_pos.long().reshape(nq, blk_q)
    live_blk = (block_req >= 0)[:, None, None]
    req = block_req.clamp(min=0)
    kl = kv_len.long()[req][:, None, None]                      # [nq,1,1]
    qb = q.reshape(nq, blk_q, hkv, rep, dh).float()
    m_acc = torch.full((nq, hkv, rep, blk_q), NEG_INF, device=q.device)
    l_acc = torch.zeros((nq, hkv, rep, blk_q), device=q.device)
    o_acc = torch.zeros((nq, hkv, rep, blk_q, dh), device=q.device)
    for j in range(S // blk_k):
        sl = slice(j * blk_k, (j + 1) * blk_k)
        k = k_cache[req, sl].float()                            # [nq,bk,g,d]
        v = v_cache[req, sl].float()
        s_pos = torch.arange(j * blk_k, (j + 1) * blk_k, device=q.device)
        m = live_blk & (pos[:, :, None] >= 0) & (s_pos[None, None] < kl) \
            & (pos[:, :, None] >= s_pos[None, None])
        if window and window > 0:
            m = m & ((pos[:, :, None] - s_pos[None, None]) < window)
        m = m[:, None, None]                                    # [nq,1,1,q,k]
        logits = torch.einsum("nqgrd,nkgd->ngrqk", qb, k) * scale
        if softcap and softcap > 0:
            logits = torch.tanh(logits / softcap) * softcap
        logits = torch.where(m, logits, NEG_INF)
        m_new = torch.maximum(m_acc, logits.amax(-1))
        p = torch.where(m, torch.exp(logits - m_new[..., None]), 0.0)
        corr = torch.exp(m_acc - m_new)
        l_acc = l_acc * corr + p.sum(-1)
        o_acc = o_acc * corr[..., None] \
            + torch.einsum("ngrqk,nkgd->ngrqd", p, v)
        m_acc = m_new
    live = m_acc > NEG_INF / 2
    out = o_acc / l_acc.clamp(min=1e-30)[..., None]
    out = torch.where(live[..., None], out, 0.0)
    # [nq, g, r, q, d] -> [nq, q, g, r, d] -> [T, Hq, dh]
    return out.permute(0, 3, 1, 2, 4).reshape(t, hq, dh).to(q.dtype)


def _check_cuda_inputs(q, k_cache, v_cache, block_req, q_pos, kv_len,
                       blk_q):
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_req": block_req, "q_pos": q_pos, "kv_len": kv_len}
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"ragged_decode kernel: {name} is on {x.device}, "
                             f"the kernel runs on CUDA tensors only")
        if x.device != q.device:
            raise ValueError(f"ragged_decode kernel: {name} is on {x.device}"
                             f", q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"ragged_decode kernel: {name} not contiguous")
    for name in ("block_req", "q_pos", "kv_len"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"ragged_decode kernel: {name} must be int32, "
                             f"got {tensors[name].dtype}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"ragged_decode kernel: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    t, hq, dh = q.shape
    R, S, hkv, dh_k = k_cache.shape
    if v_cache.shape != k_cache.shape or dh_k != dh:
        raise ValueError(f"ragged_decode kernel: cache shapes {k_cache.shape}"
                         f", {v_cache.shape} do not fit q {q.shape}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"ragged_decode kernel: head_dim {dh} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if blk_q not in _BLK_Q:
        raise ValueError(f"ragged_decode kernel: blk_q {blk_q} not in "
                         f"{_BLK_Q}")
    if hq % hkv:
        raise ValueError(f"ragged_decode kernel: {hq} q heads over {hkv} kv "
                         f"heads")
    if S % KV_TILE:
        raise ValueError(f"ragged_decode kernel: cache length {S} is not a "
                         f"multiple of {KV_TILE}")
    if kv_len.shape != (R,) or q_pos.shape != (t,):
        raise ValueError(f"ragged_decode kernel: kv_len {tuple(kv_len.shape)}"
                         f" / q_pos {tuple(q_pos.shape)} do not fit R={R}, "
                         f"T={t}")


def ragged_decode_fwd(q_blocks, k_cache, v_cache, block_req, kv_len, q_pos,
                      *, window=0, softcap=0.0, scale=None):
    """Launch the CUDA kernel on the current stream.  Layout of the TPU
    kernel: q_blocks [nq, blk_q, Hq, dh], q_pos [nq, blk_q]; returns
    [nq, blk_q, Hq, dh] in q's dtype.  CUDA tensors only."""
    nq, blk_q, hq, dh = q_blocks.shape
    q = q_blocks.reshape(nq * blk_q, hq, dh)
    pos = q_pos.reshape(nq * blk_q)
    _check_cuda_inputs(q, k_cache, v_cache, block_req, pos, kv_len, blk_q)
    R, S, hkv, _ = k_cache.shape
    scale = scale if scale is not None else dh ** -0.5
    lib = load_library()
    out = torch.empty_like(q_blocks)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ragged_decode_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_req.data_ptr(), kv_len.data_ptr(), pos.data_ptr(),
            out.data_ptr(), nq, blk_q, hq, hkv, S, dh, _DTYPES[q.dtype],
            int(window or 0), float(softcap or 0.0), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"ragged_decode kernel launch failed: CUDA error "
                           f"{err}")
    launches["ragged_decode"] += 1
    return out


def ragged_decode_attention(q, k_cache, v_cache, block_req, q_pos, kv_len,
                            *, window=0, softcap=0.0, scale=None):
    """Fused cache attention over a ragged request batch (DESIGN.md §8).

    Every q block is request-pure and attends that request's cache prefix
    ``[0, kv_len)`` (slot index == position), in one call for the whole
    batch: blk_q = 1 for decode steps, 128 for chunked prefill.

    q        [T, Hq, dh]  packed query tokens; T % len(block_req) == 0
    k_cache  [R, S, Hkv, dh]  (v_cache alike)
    block_req [nq] int32  request per q block (-1 = dead block)
    q_pos    [T] int32    absolute positions (-1 = padded row)
    kv_len   [R] int32    visibility bound per request

    CUDA tensors launch the kernel (f32 or bf16, head_dim 64 or 128, blk_q
    1 or 128, any Hq / Hkv); anything it does not cover raises.  CPU
    tensors run ``ragged_decode_reference``.
    """
    t, hq, dh = q.shape
    nq = block_req.shape[0]
    if t % nq:
        raise ValueError(f"{t} query rows do not split into {nq} blocks")
    if q.device.type == "cpu":
        return ragged_decode_reference(q, k_cache, v_cache, block_req, q_pos,
                                       kv_len, window=window, softcap=softcap,
                                       scale=scale)
    if not q.is_cuda:
        raise ValueError(f"ragged_decode_attention: no kernel for device "
                         f"{q.device}")
    blk_q = t // nq
    out = ragged_decode_fwd(q.reshape(nq, blk_q, hq, dh), k_cache, v_cache,
                            block_req, kv_len, q_pos.reshape(nq, blk_q),
                            window=window, softcap=softcap, scale=scale)
    return out.reshape(t, hq, dh)


def load_library() -> ctypes.CDLL:
    lib = build.load("ragged_decode", _SOURCE)
    fn = lib.ragged_decode_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
