"""Packed-flash attention kernels: each CUDA kernel's wrapper beside its
plain PyTorch version.

* ``ragged_decode_attention``: serving cache attention (DESIGN.md §8),
  kernel ``csrc/ragged_decode.cu``, plain version
  ``ragged_decode_reference``.
* ``ca_server_attention``: the attention server's fused CA-task batch
  with its backward (paper §4.1), a ``torch.autograd.Function`` over the
  kernels ``ca_server_fwd``, ``ca_server_bwd_dq`` and
  ``ca_server_bwd_dkv`` of ``csrc/ca_server.cu``; plain versions
  ``ca_server_fwd_reference`` / ``ca_server_bwd_reference``.  Beside it
  ``ca_server_fwd_range`` (the forward over a kv-block range with a
  carry, chunked KV streaming's unit; plain version
  ``ca_server_fwd_range_reference`` on ``ca_fwd_init`` /
  ``ca_fwd_steps`` / ``ca_fwd_finalize``; ``ca_server_fwd_chunked``
  runs it over a whole kv range) and the ring's
  ``ca_partial_attention`` (a differentiable (out, lse) whose backward
  takes the lse cotangent into the kernels) and
  ``merge_softmax_partials`` (torch ops).
* ``packed_flash_attention``: packed-document self-attention with its
  backward (the colocated ``attn_impl="pallas"`` route), a
  ``torch.autograd.Function`` over the kernels ``flash_fwd``,
  ``flash_bwd_dq`` and ``flash_bwd_dkv`` of ``csrc/flash.cu``; plain
  versions ``flash_fwd_reference`` / ``flash_bwd_reference``.  Their bf16
  kernels walk the tile ranges of ``flash_tile_ranges`` (the document
  prune, a kernel of the same file; plain version
  ``flash_tile_ranges_reference``).

Each keeps the layout of its ``repro.kernels.packed_flash`` counterpart.
On CUDA tensors a wrapper launches its kernel (built with ``nvcc`` at
first use) or raises; on CPU tensors it runs the plain version.  There is
no other route: no fallback from the card to the plain version, no
environment switch (the reference's ``bwd_impl`` / ``REPRO_KERNEL_BWD``
debug fallback is not carried over).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.attention import LSE_DEAD, NEG_INF, mask_fn
from repro_torch.kernels import build

KV_TILE = 64                  # the CUDA kernel's kv tile; S must divide by it
_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "ragged_decode.cu"
_CA_SOURCE = _CSRC / "ca_server.cu"
_FLASH_SOURCE = _CSRC / "flash.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RAGGED_HEAD_DIMS = (64, 128, 192, 256)  # the ragged_decode kernel
FLASH_HEAD_DIMS = (64, 128, 192, 256)  # the flash kernels
CA_HEAD_DIMS = FLASH_HEAD_DIMS    # the CA-server kernels
_BLK_Q = (1, 128)
# split-kv of the bf16 ragged_decode kernel (csrc/ragged_decode.cu): at
# most MAX_SPLITS parts, each of at least MIN_SPLIT_TILES tiles of the
# cache length, and only while the grid has fewer CTAs than the card SMs
MAX_SPLITS = 32
MIN_SPLIT_TILES = 4
CA_BLOCKS = (64, 128)         # the CA-server kernels' task block sizes
FLASH_BLOCK = 128             # the TPU kernel's DEFAULT_BLOCK
FLASH_TILE = 64               # the flash kernels' tile; S must divide by it
# head split of the bf16 flash dk/dv kernel (csrc/flash.cu): the group's q
# heads are cut in parts while the grid has fewer than FLASH_DKV_CTAS_PER_SM
# CTAs an SM
FLASH_DKV_CTAS_PER_SM = 4

#: kernel launches made by the wrappers (plain counts a run resets and
#: reads to show that the main path went through the kernels)
launches = {"ragged_decode": 0, "ca_server_fwd": 0, "ca_server_bwd_dq": 0,
            "ca_server_bwd_dkv": 0, "ca_server_fwd_range": 0,
            "ca_server_bwd_glse": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_tile_ranges": 0}


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


def _check_tensors(kernel, tensors, int_names):
    """Raise unless every tensor is a contiguous CUDA tensor on the first
    one's device, those in ``int_names`` are int32, and the first three
    (q, k, v) share one dtype the kernels take."""
    names = list(tensors)
    q, k, v = (tensors[n] for n in names[:3])
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{kernel} kernel: {name} is on {x.device}, the "
                             f"kernel runs on CUDA tensors only")
        if x.device != q.device:
            raise ValueError(f"{kernel} kernel: {name} is on {x.device}, "
                             f"{names[0]} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} not contiguous")
    for name in int_names:
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{kernel} kernel: {name} must be int32, got "
                             f"{tensors[name].dtype}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{kernel} kernel: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _check_cuda_inputs(q, k_cache, v_cache, block_req, q_pos, kv_len,
                       blk_q):
    _check_tensors("ragged_decode",
                   {"q": q, "k_cache": k_cache, "v_cache": v_cache,
                    "block_req": block_req, "q_pos": q_pos, "kv_len": kv_len},
                   ("block_req", "q_pos", "kv_len"))
    t, hq, dh = q.shape
    R, S, hkv, dh_k = k_cache.shape
    if v_cache.shape != k_cache.shape or dh_k != dh:
        raise ValueError(f"ragged_decode kernel: cache shapes {k_cache.shape}"
                         f", {v_cache.shape} do not fit q {q.shape}")
    if dh not in RAGGED_HEAD_DIMS:
        raise ValueError(f"ragged_decode kernel: head_dim {dh} not in "
                         f"{RAGGED_HEAD_DIMS}")
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
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.data_ptr() % 16:
            raise ValueError(f"ragged_decode kernel: {name} is not 16-byte "
                             f"aligned (the kernel loads 16 bytes a thread)")


def ragged_tiling(blk_q: int, dh: int):
    """(rows a CTA, kv slots a tile) of the bf16 kernel: decode (blk_q 1)
    16 rows over 64-slot tiles, prefill 64 rows over 64-slot tiles (32 at
    head_dim 256; 64 at 192, whose 96 accumulators a thread leave room for
    the score fragment)."""
    if blk_q == 1:
        return 16, 64
    return 64, 32 if dh == 256 else 64


def ragged_split_plan(nq: int, blk_q: int, hq: int, hkv: int, S: int,
                      dh: int, n_sms: int):
    """The bf16 kernel's grid and split-kv scratch, from shapes alone (the
    live kv range is data on the card; each CTA cuts its own, see
    ``kv_split_ranges``).  Returns (CTAs per split, n_split, scratch f32
    elements).  The grid is (q block, kv head, row tile) CTAs, each q
    block's rows being its blk_q x rep (q row, q head) pairs; with fewer
    CTAs than SMs (a decode step) the kv range is cut in up to
    ``2 * n_sms // CTAs`` parts: one wave of ~2 CTAs an SM, the kernel's
    occupancy, with no partial second wave; a part keeps at least
    MIN_SPLIT_TILES of the cache's tiles."""
    bm, bn = ragged_tiling(blk_q, dh)
    rows = blk_q * (hq // hkv)
    base = nq * hkv * (-(-rows // bm))
    n_split = 1
    if base < n_sms:
        n_split = max(1, min(2 * n_sms // base, MAX_SPLITS,
                             (S // bn) // MIN_SPLIT_TILES))
    scratch = base * n_split * bm * (dh + 2) if n_split > 1 else 0
    return base, n_split, scratch


def kv_split_ranges(t_lo: int, t_hi: int, n_split: int):
    """The kernel's cut of a CTA's live tiles [t_lo, t_hi) into n_split
    parts: ``per`` = ceil(n / n_split) tiles each, in order, empty parts
    dropped.  Returns the non-empty parts' [lo, hi) tile ranges."""
    n = max(0, t_hi - t_lo)
    if n == 0:
        return []
    per = -(-n // n_split)
    return [(t_lo + s * per, min(t_hi, t_lo + (s + 1) * per))
            for s in range(-(-n // per))]


# split scratch per (device, stream) of the bf16 ragged_decode and flash
# dk/dv kernels: the f32 parts and the int32 counters, which the kernels
# leave at zero, reused call after call (calls on one stream run in order)
_split_scratch: dict = {}


def _scratch(device, stream: int, n_part: int, n_counters: int):
    part, counters = _split_scratch.get((device, stream), (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _split_scratch[(device, stream)] = (part, counters)
    return part, counters


def ragged_decode_fwd(q_blocks, k_cache, v_cache, block_req, kv_len, q_pos,
                      *, window=0, softcap=0.0, scale=None):
    """Launch the CUDA kernel on the current stream.  Layout of the TPU
    kernel: q_blocks [nq, blk_q, Hq, dh], q_pos [nq, blk_q]; returns
    [nq, blk_q, Hq, dh] in q's dtype.  CUDA tensors only.  bf16 inputs
    take the tensor-core kernel with its split-kv scratch (kept per device
    and stream), f32 inputs the exact FMA kernel."""
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
        n_split, part, counters = 1, None, None
        if q.dtype == torch.bfloat16:
            base, n_split, scratch = ragged_split_plan(
                nq, blk_q, hq, hkv, S, dh,
                torch.cuda.get_device_properties(
                    q.device).multi_processor_count)
            if n_split > 1:
                part, counters = _scratch(q.device, stream, scratch, base)
        err = lib.ragged_decode_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_req.data_ptr(), kv_len.data_ptr(), pos.data_ptr(),
            out.data_ptr(), 0 if part is None else part.data_ptr(),
            0 if counters is None else counters.data_ptr(), nq, blk_q, hq,
            hkv, S, dh, _DTYPES[q.dtype], n_split, int(window or 0),
            float(softcap or 0.0), float(scale), stream)
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

    CUDA tensors launch the kernel (f32 or bf16, head_dim 64, 128, 192 or 256,
    blk_q 1 or 128, any Hq / Hkv); anything it does not cover raises.  CPU
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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------- CA-server batch
def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions accumulate in f32, or in f64 for f64 inputs (the
    tests' autograd check)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _server_pair(qf, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos, j, *,
                 softcap, window, scale, rep, sink, rate):
    """Masked logits of relative kv block ``j`` for every task (the port of
    ``dispatch._server_pair``), with GQA as a [Hkv, rep] split of the q
    heads.  qf [T, blk, Hq, dh] in the accumulation dtype.  Returns
    (logits [T, Hkv, rep, blk, blk], mask like it, kj, vj in qf's dtype,
    the block index [T])."""
    t, blk, hq, dh = qf.shape
    n, _, hkv, _ = k_buf.shape
    idx = (kv_start.long() + j).clamp(0, n - 1)
    kj = k_buf[idx].to(qf.dtype)                            # [T,blk,g,d]
    vj = v_buf[idx].to(qf.dtype)
    pq = q_pos.long()[:, None, None, :, None]
    pk = kv_pos.long()[idx][:, None, None, None, :]
    logits = torch.einsum("tqgrd,tkgd->tgrqk",
                          qf.reshape(t, blk, hkv, rep, dh), kj) * scale
    if softcap and softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    live = (j < kv_len.long())[:, None, None, None, None]
    msk = (pq >= pk) & (pq >= 0) & (pk >= 0) & live
    if window and window > 0:
        w = (pq - pk) < window
        if sink and sink > 0:
            w = w | (pk < sink)
        msk = msk & w
    if rate and rate > 1:
        msk = msk & (((pq // blk) - (pk // blk)) % rate == 0)
    return torch.where(msk, logits, NEG_INF), msk, kj, vj, idx


def ca_fwd_init(q_tasks, hkv):
    """A fresh online-softmax carry ``(m, l, acc)`` for a task batch, in
    the accumulation dtype: m [T, Hkv, rep, blk] at NEG_INF, l zeros like
    it, acc [T, Hkv, rep, blk, dh] zeros (the port of
    ``dispatch._accum_init``)."""
    t, blk, hq, dh = q_tasks.shape
    rep = hq // hkv
    acc_dt = _acc_dtype(q_tasks)
    dev = q_tasks.device
    return (torch.full((t, hkv, rep, blk), NEG_INF, dtype=acc_dt,
                       device=dev),
            torch.zeros((t, hkv, rep, blk), dtype=acc_dt, device=dev),
            torch.zeros((t, hkv, rep, blk, dh), dtype=acc_dt, device=dev))


def ca_fwd_steps(carry, q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                 kv_pos, j0, j1, *, window=0, sink=0, rate=1, softcap=0.0,
                 scale=None):
    """The online-softmax steps over relative kv blocks ``j0 <= j < j1``
    on a carry from :func:`ca_fwd_init` (the port of
    ``dispatch._accum_body``).  A step past a task's ``kv_len`` is an
    exact no-op (its logits are NEG_INF: the carry is multiplied by
    exp(0) == 1 and incremented by 0), so splitting ``[0, jmax)`` into
    ranges runs the same operations in the same order as one range."""
    _, _, hq, dh = q_tasks.shape
    rep = hq // k_buf.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qf = q_tasks.to(_acc_dtype(q_tasks))
    m_acc, l_acc, acc = carry
    for j in range(j0, j1):
        logits, msk, _, vj, _ = _server_pair(
            qf, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos, j,
            softcap=softcap, window=window, scale=scale, rep=rep, sink=sink,
            rate=rate)
        m_new = torch.maximum(m_acc, logits.amax(-1))
        p = torch.where(msk, torch.exp(logits - m_new[..., None]), 0.0)
        corr = torch.exp(m_acc - m_new)
        l_acc = l_acc * corr + p.sum(-1)
        acc = acc * corr[..., None] \
            + torch.einsum("tgrqk,tkgd->tgrqd", p, vj)
        m_acc = m_new
    return m_acc, l_acc, acc


def ca_fwd_finalize(carry, dtype):
    """Normalize a finished carry into (out [T, blk, Hq, dh] in
    ``dtype``, lse [T, Hq, blk] in the accumulation dtype); rows that saw
    no visible pair give out 0 and lse LSE_DEAD (the port of
    ``dispatch._accum_finalize``)."""
    m_acc, l_acc, acc = carry
    t, hkv, rep, blk, dh = acc.shape
    live = m_acc > NEG_INF / 2
    out = acc / l_acc.clamp(min=1e-30)[..., None]
    out = torch.where(live[..., None], out, 0.0)
    lse = torch.where(live, m_acc + torch.log(l_acc.clamp(min=1e-30)),
                      LSE_DEAD)
    # [T, g, r, q, d] -> [T, q, g, r, d] -> [T, blk, Hq, dh]
    out = out.permute(0, 3, 1, 2, 4).reshape(t, blk, hkv * rep, dh)
    return out.to(dtype).contiguous(), lse.reshape(t, hkv * rep, blk)


def ca_server_fwd_reference(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                            kv_pos, *, jmax=0, window=0, sink=0, rate=1,
                            softcap=0.0, scale=None):
    """Plain PyTorch version of ``ca_server_fwd`` (the port of
    ``dispatch._xla_server_fwd_impl``): an online-softmax loop over the
    relative kv block index j < jmax, gathering each task's j-th block:
    :func:`ca_fwd_init`, :func:`ca_fwd_steps` over ``[0, jmax)`` and
    :func:`ca_fwd_finalize`.  Returns (out like q_tasks, lse [T, Hq, blk]
    in the accumulation dtype)."""
    jmax = jmax or k_buf.shape[0]
    carry = ca_fwd_steps(ca_fwd_init(q_tasks, k_buf.shape[2]), q_tasks,
                         k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos, 0,
                         jmax, window=window, sink=sink, rate=rate,
                         softcap=softcap, scale=scale)
    return ca_fwd_finalize(carry, q_tasks.dtype)


def ca_server_fwd_range_reference(q_tasks, k_buf, v_buf, kv_start, kv_len,
                                  q_pos, kv_pos, *, j0, j1, carry=None,
                                  finalize=True, jmax=0, window=0, sink=0,
                                  rate=1, softcap=0.0, scale=None):
    """Plain version of ``ca_server_fwd_range``: the steps over relative kv
    blocks ``[j0, min(j1, jmax))`` on ``carry`` (a fresh one when None);
    returns (out, lse) when ``finalize``, else the carry ``(m, l, acc)``."""
    jmax = jmax or k_buf.shape[0]
    if carry is None:
        carry = ca_fwd_init(q_tasks, k_buf.shape[2])
    carry = ca_fwd_steps(carry, q_tasks, k_buf, v_buf, kv_start, kv_len,
                         q_pos, kv_pos, j0, min(j1, jmax), window=window,
                         sink=sink, rate=rate, softcap=softcap, scale=scale)
    return ca_fwd_finalize(carry, q_tasks.dtype) if finalize else carry


def ca_server_bwd_reference(q_tasks, k_buf, v_buf, out, lse, do, kv_start,
                            kv_len, q_pos, kv_pos, *, jmax=0, window=0,
                            sink=0, rate=1, softcap=0.0, scale=None,
                            g_lse=None):
    """Plain PyTorch version of ``ca_server_bwd`` (the port of
    ``dispatch._xla_server_bwd_impl``): p is rebuilt from the saved lse
    block by block; dk/dv fold the GQA group and add into the kv buffer
    rows each task read.  ``g_lse`` [T, Hq, blk] is the cotangent of the
    lse output (a ring partial's): it joins the score gradient as
    ``ds = p * (dp - (delta - g_lse))``.  Returns (dq, dk, dv) in the
    dtypes of q_tasks, k_buf, v_buf."""
    t, blk, hq, dh = q_tasks.shape
    n, _, hkv, _ = k_buf.shape
    rep = hq // hkv
    jmax = jmax or n
    scale = scale if scale is not None else dh ** -0.5
    acc_dt = _acc_dtype(q_tasks)
    qf = q_tasks.to(acc_dt)
    g5 = do.to(acc_dt).reshape(t, blk, hkv, rep, dh)
    q5 = qf.reshape(t, blk, hkv, rep, dh)
    delta = torch.einsum("tqgrd,tqgrd->tgrq", g5,
                         out.to(acc_dt).reshape(t, blk, hkv, rep, dh))
    lse5 = lse.to(acc_dt).reshape(t, hkv, rep, blk)
    if g_lse is not None:
        delta = delta - g_lse.to(acc_dt).reshape(t, hkv, rep, blk)
    dq = torch.zeros((t, blk, hkv, rep, dh), dtype=acc_dt,
                     device=q_tasks.device)
    dk = torch.zeros((n, blk, hkv, dh), dtype=acc_dt, device=k_buf.device)
    dv = torch.zeros_like(dk)
    for j in range(jmax):
        logits, msk, kj, vj, idx = _server_pair(
            qf, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos, j,
            softcap=softcap, window=window, scale=scale, rep=rep, sink=sink,
            rate=rate)
        p = torch.where(msk, torch.exp(logits - lse5[..., None]), 0.0)
        dvj = torch.einsum("tgrqk,tqgrd->tkgd", p, g5)
        dp = torch.einsum("tqgrd,tkgd->tgrqk", g5, vj)
        ds = p * (dp - delta[..., None])
        if softcap and softcap > 0:
            sc = torch.where(msk, logits / softcap, 0.0)
            ds = ds * (1.0 - sc * sc)
        ds = ds * scale
        dq = dq + torch.einsum("tgrqk,tkgd->tqgrd", ds, kj)
        dkj = torch.einsum("tgrqk,tqgrd->tkgd", ds, q5)
        live = (j < kv_len.long()).to(acc_dt)[:, None, None, None]
        dk.index_add_(0, idx, dkj * live)
        dv.index_add_(0, idx, dvj * live)
    return (dq.reshape(t, blk, hq, dh).to(q_tasks.dtype),
            dk.to(k_buf.dtype), dv.to(v_buf.dtype))


def _check_ca_inputs(q, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos,
                     extra=()):
    """Raise on anything the CA-server kernels do not take."""
    _check_tensors("ca_server",
                   {"q_tasks": q, "k_buf": k_buf, "v_buf": v_buf,
                    "kv_start": kv_start, "kv_len": kv_len, "q_pos": q_pos,
                    "kv_pos": kv_pos, **dict(extra)},
                   ("kv_start", "kv_len", "q_pos", "kv_pos"))
    t, blk, hq, dh = q.shape
    n, blk_k, hkv, dh_k = k_buf.shape
    if v_buf.shape != k_buf.shape or blk_k != blk or dh_k != dh:
        raise ValueError(f"ca_server kernel: kv buffers {k_buf.shape}, "
                         f"{v_buf.shape} do not fit q_tasks {q.shape}")
    if dh not in CA_HEAD_DIMS:
        raise ValueError(f"ca_server kernel: head_dim {dh} not in "
                         f"{CA_HEAD_DIMS}")
    if blk not in CA_BLOCKS:
        raise ValueError(f"ca_server kernel: block {blk} not in {CA_BLOCKS}")
    if hq % hkv:
        raise ValueError(f"ca_server kernel: {hq} q heads over {hkv} kv "
                         f"heads")
    if kv_start.shape != (t,) or kv_len.shape != (t,) \
            or q_pos.shape != (t, blk) or kv_pos.shape != (n, blk):
        raise ValueError(f"ca_server kernel: metadata shapes "
                         f"{tuple(kv_start.shape)}, {tuple(kv_len.shape)}, "
                         f"{tuple(q_pos.shape)}, {tuple(kv_pos.shape)} do "
                         f"not fit T={t}, N={n}, blk={blk}")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernels load q, k, v, do, out and kv_pos 16
        # bytes a thread
        for name, x in (("q_tasks", q), ("k_buf", k_buf), ("v_buf", v_buf),
                        ("kv_pos", kv_pos),
                        *[(nm, y) for nm, y in extra if nm in ("do", "out")]):
            if x.data_ptr() % 16:
                raise ValueError(f"ca_server kernel: {name} is not 16-byte "
                                 f"aligned")


def _ca_scalars(q, k_buf, jmax, window, sink, rate, softcap, scale):
    t, blk, hq, dh = q.shape
    n, _, hkv, _ = k_buf.shape
    scale = scale if scale is not None else dh ** -0.5
    return (t, n, blk, hq, hkv, dh, _DTYPES[q.dtype], int(jmax or n),
            int(window or 0), int(sink or 0), int(rate or 1),
            float(softcap or 0.0), float(scale))


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ca_server_fwd(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos,
                  *, jmax=0, window=0, sink=0, rate=1, softcap=0.0,
                  scale=None):
    """Launch the forward kernel on the current stream.  Layout of the TPU
    kernel ``ca_server_fwd``; returns (out like q_tasks, lse [T, Hq, blk]
    f32).  CUDA tensors only.  bf16 takes the tensor-core kernel, f32 the
    exact FMA kernel."""
    _check_ca_inputs(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos)
    t, blk, hq, dh = q_tasks.shape
    lib = load_ca_server_library()
    out = torch.empty_like(q_tasks)
    lse = torch.empty((t, hq, blk), dtype=torch.float32,
                      device=q_tasks.device)
    with torch.cuda.device(q_tasks.device):
        stream = torch.cuda.current_stream(q_tasks.device).cuda_stream
        err = lib.ca_server_fwd(
            q_tasks.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(),
            kv_start.data_ptr(), kv_len.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *_ca_scalars(q_tasks, k_buf, jmax, window, sink, rate, softcap,
                         scale), stream)
    _raise_on(err, "ca_server_fwd")
    launches["ca_server_fwd"] += 1
    return out, lse


def ca_server_bwd(q_tasks, k_buf, v_buf, out, lse, do, kv_start, kv_len,
                  q_pos, kv_pos, *, jmax=0, window=0, sink=0, rate=1,
                  softcap=0.0, scale=None, g_lse=None):
    """The backward from the saved (out, lse): the dq kernel and the dk/dv
    kernel on the current stream, with ``delta = rowsum(do * out)`` in
    f32.  Returns (dq, dk, dv) in the dtypes of q_tasks and k_buf.  CUDA
    tensors only.  bf16 takes the tensor-core kernels: the dq kernel
    computes delta for its rows and writes it for dk/dv, which lists each
    kv block's covering tasks itself, on the card.  f32 takes the exact
    FMA kernels, with delta a torch op outside them as in the
    reference.  ``g_lse`` [T, Hq, blk] f32, the cotangent of the lse
    output (a ring partial's), makes delta ``rowsum(do * out) - g_lse``:
    in the bf16 dq kernel, or in the f32 path's torch op."""
    extra = (("out", out), ("lse", lse), ("do", do))
    if g_lse is not None:
        extra += (("g_lse", g_lse),)
    _check_ca_inputs(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos,
                     extra=extra)
    t, blk, hq, _ = q_tasks.shape
    if do.shape != q_tasks.shape or do.dtype != q_tasks.dtype \
            or out.shape != q_tasks.shape or out.dtype != q_tasks.dtype \
            or lse.shape != (t, hq, blk) or lse.dtype != torch.float32 \
            or (g_lse is not None and (g_lse.shape != lse.shape
                                       or g_lse.dtype != torch.float32)):
        raise ValueError(f"ca_server_bwd: do {tuple(do.shape)} {do.dtype}, "
                         f"out {tuple(out.shape)} {out.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}, g_lse "
                         f"{None if g_lse is None else tuple(g_lse.shape)} "
                         f"do not fit q_tasks {tuple(q_tasks.shape)} "
                         f"{q_tasks.dtype}")
    lib = load_ca_server_library()
    if q_tasks.dtype == torch.bfloat16:     # written by the dq kernel
        delta = torch.empty((t, hq, blk), dtype=torch.float32,
                            device=q_tasks.device)
    else:
        delta = torch.einsum("tqhd,tqhd->thq", do.float(),
                             out.float()).contiguous()
        if g_lse is not None:
            delta = (delta - g_lse).contiguous()
    dq = torch.empty_like(q_tasks)
    dk = torch.empty_like(k_buf)
    dv = torch.empty_like(v_buf)
    scalars = _ca_scalars(q_tasks, k_buf, jmax, window, sink, rate, softcap,
                          scale)
    ins = (q_tasks.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(),
           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           kv_start.data_ptr(), kv_len.data_ptr(), q_pos.data_ptr(),
           kv_pos.data_ptr())
    with torch.cuda.device(q_tasks.device):
        stream = torch.cuda.current_stream(q_tasks.device).cuda_stream
        g_ptr = _ptr(g_lse) if q_tasks.dtype == torch.bfloat16 else 0
        err = lib.ca_server_bwd_dq(*ins[:4], out.data_ptr(), *ins[4:6],
                                   g_ptr, *ins[6:], dq.data_ptr(), *scalars,
                                   stream)
        _raise_on(err, "ca_server_bwd_dq")
        launches["ca_server_bwd_dq" if g_lse is None
                 else "ca_server_bwd_glse"] += 1
        err = lib.ca_server_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                    *scalars, stream)
        _raise_on(err, "ca_server_bwd_dkv")
        launches["ca_server_bwd_dkv"] += 1
    return dq, dk, dv


class _KernelAttention(torch.autograd.Function):
    """Attention over a kernel pair with the shape both pairs share:
    ``fwd(q, k, v, *index, **opts) -> (out, lse)`` and
    ``bwd(q, k, v, out, lse, do, *index, **opts) -> (dq, dk, dv)``, with
    four int32 index tensors.  ``kernels`` is (fwd, bwd) for CUDA tensors
    and (fwd, bwd) plain versions for CPU tensors.  Forward saves the
    inputs and (out, lse); backward rebuilds p from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, i0, i1, i2, i3, kernels, opts):
        fwd, bwd = kernels[0] if q.is_cuda else kernels[1]
        out, lse = fwd(q, k, v, i0, i1, i2, i3, **opts)
        ctx.save_for_backward(q, k, v, i0, i1, i2, i3, out, lse)
        ctx.bwd, ctx.opts = bwd, opts
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, *index, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, g.contiguous(), *index,
                             **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def ca_server_attention(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                        kv_pos, *, window=0, softcap=0.0, scale=None, jmax=0,
                        sink=0, rate=1):
    """Fused CA-task batch on an attention server (paper §4.1), causal.

    q_tasks [T, blk, Hq, dh]; k_buf / v_buf [N, blk, Hkv, dh];
    kv_start / kv_len [T] int32; q_pos [T, blk], kv_pos [N, blk] int32
    in-document positions (-1 = padding).  Task t attends kv blocks
    ``[kv_start[t], kv_start[t] + min(kv_len[t], jmax))``; ``jmax`` 0
    means N.  ``window``/``sink``/``rate`` carry a MaskSpec
    (DESIGN.md §12).  Differentiable in q_tasks, k_buf and v_buf.

    CUDA tensors launch the kernels (f32 or bf16, head_dim 64, 128, 192 or
    256, blk 64 or 128, any Hq / Hkv); anything they do not cover raises.
    CPU tensors run the plain versions."""
    if not q_tasks.is_cuda and q_tasks.device.type != "cpu":
        raise ValueError(f"ca_server_attention: no kernel for device "
                         f"{q_tasks.device}")
    opts = dict(jmax=jmax, window=window, sink=sink, rate=rate,
                softcap=softcap, scale=scale)
    kernels = ((ca_server_fwd, ca_server_bwd),
               (ca_server_fwd_reference, ca_server_bwd_reference))
    return _KernelAttention.apply(q_tasks, k_buf, v_buf, kv_start, kv_len,
                                  q_pos, kv_pos, kernels, opts)


def ca_carry_floats(t: int, hq: int, blk: int, dh: int) -> int:
    """f32 words of a kernel carry for a task batch: per (task, q head, q
    row) dh accumulators and 8 words of running max and sum (the bf16
    kernel keeps each thread's registers as they are: m and l of its two
    rows, l summed per lane and reduced over the quad only when
    finalized; the f32 kernel keeps m, l and the row's accumulators)."""
    return t * hq * blk * (dh + 8)


def ca_server_fwd_range(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                        kv_pos, *, j0, j1, carry=None, finalize=True, jmax=0,
                        window=0, sink=0, rate=1, softcap=0.0, scale=None):
    """The CA forward over relative kv blocks ``[j0, min(j1, jmax))`` with
    a carry: chunked KV streaming's unit (DESIGN.md §11).  ``carry`` None
    starts a fresh one.  Returns (out, lse) when ``finalize``, else the
    carry, which the next range takes.  Ranges that split ``[0, jmax)``
    give out and lse bitwise equal to the unstreamed forward.

    CUDA tensors launch ``ca_server_fwd_range`` of ``csrc/ca_server.cu``
    (the forward kernels with their state stored to and loaded from the
    carry, an f32 tensor of :func:`ca_carry_floats` words, updated in
    place); CPU tensors run the plain version, whose carry is the tuple
    ``(m, l, acc)``.  Forward only: inputs that require grad raise while
    grad mode is on."""
    if torch.is_grad_enabled() \
            and any(x.requires_grad for x in (q_tasks, k_buf, v_buf)):
        raise ValueError("ca_server_fwd_range: the streamed forward has no "
                         "backward (every streamed serve is forward only); "
                         "call it under torch.no_grad() or on detached "
                         "inputs")
    opts = dict(jmax=jmax, window=window, sink=sink, rate=rate,
                softcap=softcap, scale=scale)
    if not q_tasks.is_cuda:
        if q_tasks.device.type != "cpu":
            raise ValueError(f"ca_server_fwd_range: no kernel for device "
                             f"{q_tasks.device}")
        return ca_server_fwd_range_reference(
            q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos, j0=j0,
            j1=j1, carry=carry, finalize=finalize, **opts)
    _check_ca_inputs(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos)
    t, blk, hq, dh = q_tasks.shape
    words = ca_carry_floats(t, hq, blk, dh)
    load = carry is not None
    if load and (not torch.is_tensor(carry) or carry.dtype != torch.float32
                 or carry.numel() != words or carry.device != q_tasks.device
                 or not carry.is_contiguous()):
        raise ValueError(f"ca_server_fwd_range: carry must be a contiguous "
                         f"f32 tensor of {words} words on {q_tasks.device}")
    if not load:
        carry = torch.empty(words, dtype=torch.float32, device=q_tasks.device)
    out = lse = None
    if finalize:
        out = torch.empty_like(q_tasks)
        lse = torch.empty((t, hq, blk), dtype=torch.float32,
                          device=q_tasks.device)
    lib = load_ca_server_library()
    scalars = _ca_scalars(q_tasks, k_buf, jmax, window, sink, rate, softcap,
                          scale)
    with torch.cuda.device(q_tasks.device):
        stream = torch.cuda.current_stream(q_tasks.device).cuda_stream
        err = lib.ca_server_fwd_range(
            q_tasks.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(),
            kv_start.data_ptr(), kv_len.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), _ptr(out), _ptr(lse), carry.data_ptr(),
            *scalars, int(j0), int(j1), int(load), int(finalize), stream)
    _raise_on(err, "ca_server_fwd_range")
    launches["ca_server_fwd_range"] += 1
    return (out, lse) if finalize else carry


def ca_server_fwd_chunked(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                          kv_pos, *, chunk_blocks, jmax=0,
                          fwd_range=ca_server_fwd_range, **opts):
    """The CA forward as ranges of ``chunk_blocks`` kv blocks with the
    carry threaded through: a streamed serve's launches (DESIGN.md §11).
    Returns (out, lse), bitwise equal to the unstreamed forward.
    ``fwd_range`` is :func:`ca_server_fwd_range`, or its plain version to
    run the plain ranges on the same tensors; ``opts`` are the mask and
    score options."""
    jmax = jmax or k_buf.shape[0]
    args = (q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos)
    carry = None
    for j0 in range(0, jmax, chunk_blocks):
        last = j0 + chunk_blocks >= jmax
        res = fwd_range(*args, j0=j0, j1=j0 + chunk_blocks, carry=carry,
                        finalize=last, jmax=jmax, **opts)
        if last:
            return res
        carry = res


class _PartialAttention(torch.autograd.Function):
    """A CA forward returning (out, lse), both differentiable: backward
    takes the lse cotangent into the score gradient (``g_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v, i0, i1, i2, i3, opts):
        fwd = ca_server_fwd if q.is_cuda else ca_server_fwd_reference
        out, lse = fwd(q, k, v, i0, i1, i2, i3, **opts)
        ctx.save_for_backward(q, k, v, i0, i1, i2, i3, out, lse)
        ctx.opts = opts
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, *index, out, lse = ctx.saved_tensors
        bwd = ca_server_bwd if q.is_cuda else ca_server_bwd_reference
        dq, dk, dv = bwd(q, k, v, out, lse, g_out.contiguous(), *index,
                         **ctx.opts, g_lse=g_lse.float().contiguous())
        return dq, dk, dv, None, None, None, None, None


def ca_partial_attention(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                         kv_pos, *, jmax=0, window=0, softcap=0.0,
                         scale=None, sink=0, rate=1):
    """One ring pass of a fused CA-task batch (DESIGN.md §13): attention
    over the pass's kv range ``[kv_start, kv_start + min(kv_len, jmax))``
    returning the finalized ``(out, lse)`` partial, both differentiable,
    so :func:`merge_softmax_partials` chains across passes.  ``kv_len``
    0 rows give a dead partial (out 0, lse LSE_DEAD) that merges as a
    bitwise no-op.  The port of ``ops.ca_partial_attention``: the CA
    kernels on CUDA tensors (backward with the lse cotangent, ``g_lse``),
    their plain versions on CPU tensors."""
    if not q_tasks.is_cuda and q_tasks.device.type != "cpu":
        raise ValueError(f"ca_partial_attention: no kernel for device "
                         f"{q_tasks.device}")
    opts = dict(jmax=jmax, window=window, sink=sink, rate=rate,
                softcap=softcap, scale=scale)
    return _PartialAttention.apply(q_tasks, k_buf, v_buf, kv_start, kv_len,
                                   q_pos, kv_pos, opts)


def _lse_dead(lse):
    """Rows whose partial saw no live kv (the LSE_DEAD marker)."""
    return lse >= LSE_DEAD / 2


def _merge_weights(lse_a, lse_b, lse):
    """Softmax merge weights, zeroed on dead partials; with one side live
    its weight is exp(0) == 1 exactly."""
    w_a = torch.where(_lse_dead(lse_a), 0.0, torch.exp(lse_a - lse))
    w_b = torch.where(_lse_dead(lse_b), 0.0, torch.exp(lse_b - lse))
    return w_a, w_b


def _broadcast_rows(w):
    """[..., hq, blk] row weights -> [..., blk, hq, 1]."""
    return w.transpose(-1, -2)[..., None]


class _MergePartials(torch.autograd.Function):
    """The port of ``ops.merge_softmax_partials``' custom VJP."""

    @staticmethod
    def forward(ctx, out_a, lse_a, out_b, lse_b):
        dead_a, dead_b = _lse_dead(lse_a), _lse_dead(lse_b)
        # dead sentinels neutralized before the max-stabilized logaddexp
        la = torch.where(dead_a, -LSE_DEAD, lse_a)
        lb = torch.where(dead_b, -LSE_DEAD, lse_b)
        m = torch.maximum(la, lb)
        lse_m = m + torch.log(torch.exp(la - m) + torch.exp(lb - m))
        w_a, w_b = _merge_weights(lse_a, lse_b, lse_m)
        out_m = (_broadcast_rows(w_a) * out_a.float()
                 + _broadcast_rows(w_b) * out_b.float()).to(out_a.dtype)
        # bitwise select: a dead partial must not perturb the live side
        # (0.0 * x + 1.0 * y is not bitwise y when y holds -0.0)
        out = torch.where(_broadcast_rows(dead_b), out_a,
                          torch.where(_broadcast_rows(dead_a), out_b, out_m))
        lse = torch.where(dead_b, lse_a, torch.where(dead_a, lse_b, lse_m))
        ctx.save_for_backward(out_a, lse_a, out_b, lse_b, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        out_a, lse_a, out_b, lse_b, out, lse = ctx.saved_tensors
        gf = g_out.float()
        of = out.float()
        w_a, w_b = _merge_weights(lse_a, lse_b, lse)
        d_out_a = (_broadcast_rows(w_a) * gf).to(out_a.dtype)
        d_out_b = (_broadcast_rows(w_b) * gf).to(out_b.dtype)
        # d lse_i = w_i * (sum_dh g_out * (out_i - out) + g_lse)
        da = (gf * (out_a.float() - of)).sum(-1).transpose(-1, -2)
        db = (gf * (out_b.float() - of)).sum(-1).transpose(-1, -2)
        return d_out_a, w_a * (da + g_lse), d_out_b, w_b * (db + g_lse)


def merge_softmax_partials(out_a, lse_a, out_b, lse_b):
    """Online-softmax merge of two finalized attention partials (the port
    of ``ops.merge_softmax_partials``).  ``out_*`` [..., blk, hq, dh]
    (normalized), ``lse_*`` [..., hq, blk]; leading dims broadcast
    elementwise, so per-server [T, ...] and stacked [D, T, ...] layouts
    merge with the same operations.  A dead partial (lse LSE_DEAD) is a
    bitwise no-op: the live side is selected, not blended.  Both outputs
    are differentiable.  Plain torch ops on either device."""
    return _MergePartials.apply(out_a, lse_a, out_b, lse_b)


def load_ca_server_library() -> ctypes.CDLL:
    lib = build.load("ca_server", _CA_SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i32] * 11 + [f32, f32, ptr]    # ints, softcap, scale, stream
    signatures = {"ca_server_fwd": [ptr] * 9 + scalars,
                  "ca_server_bwd_dq": [ptr] * 13 + scalars,
                  "ca_server_bwd_dkv": [ptr] * 12 + scalars,
                  # + carry; j0, j1, load, finalize after the scalars
                  "ca_server_fwd_range": [ptr] * 10 + scalars[:-1]
                  + [i32] * 4 + [ptr]}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------ packed flash
def _flash_blocks(sq, skv, blk_q, blk_k, rate):
    """The TPU kernel's block sizes (``kernel.py:148-152``)."""
    blk_q, blk_k = min(blk_q, sq), min(blk_k, skv)
    if sq % blk_q or skv % blk_k:
        raise ValueError(f"pad the sequence to the block: Sq {sq} / blk_q "
                         f"{blk_q}, Skv {skv} / blk_k {blk_k}")
    if rate and rate > 1 and blk_q != blk_k:
        raise ValueError("dilated masks need square blocks (blk_q == blk_k)")
    return blk_q, blk_k


def _flash_pair_mask(seg_q, pos_q, seg_k, pos_k, j, *, causal, window, sink,
                     rate, blk_q, blk_k):
    """Visible pairs of every q row against kv block ``j`` [B, Sq, blk_k]:
    the token mask (``_flash_mask`` is ``mask_fn`` with the dilation at
    blk_q), and ``_flash_block_live`` of the chunk-order block pair
    (row // blk_q, j)."""
    m = mask_fn(seg_q.long(), pos_q.long(), seg_k.long(), pos_k.long(),
                causal=causal, window=window, sink=sink, rate=rate, blk=blk_q)
    i = torch.arange(seg_q.shape[1], device=seg_q.device) // blk_q
    run = torch.ones_like(i, dtype=torch.bool)
    if causal:
        run = run & (j * blk_k < (i + 1) * blk_q)
    if window and window > 0 and not sink:
        run = run & ((j + 1) * blk_k - 1 >= i * blk_q - window)
    if rate and rate > 1:
        run = run & ((i - j) % rate == 0)
    return m & run[None, :, None]


def _flash_block_logits(qf, k, seg_q, pos_q, seg_kv, pos_kv, j, *, causal,
                        window, sink, rate, softcap, scale, blk_q, blk_k):
    """Masked logits of every q row against kv block ``j``, with GQA as a
    [Hkv, rep] split of the q heads.  qf [B, Sq, Hkv, rep, dh] in the
    accumulation dtype.  Returns (logits [B, Hkv, rep, Sq, blk_k], mask
    like it, kj [B, blk_k, Hkv, dh] in qf's dtype, the block's slice)."""
    sl = slice(j * blk_k, (j + 1) * blk_k)
    kj = k[:, sl].to(qf.dtype)
    msk = _flash_pair_mask(seg_q, pos_q, seg_kv[:, sl], pos_kv[:, sl], j,
                           causal=causal, window=window, sink=sink, rate=rate,
                           blk_q=blk_q, blk_k=blk_k)[:, None, None]
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qf, kj) * scale
    if softcap and softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return torch.where(msk, logits, NEG_INF), msk, kj, sl


def flash_fwd_reference(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *,
                        causal=True, window=0, sink=0, rate=1, softcap=0.0,
                        scale=None, blk_q=FLASH_BLOCK, blk_k=FLASH_BLOCK):
    """Plain PyTorch version of ``flash_fwd`` (``kernel.py:140``): the
    online softmax over kv blocks of ``blk_k`` slots, every q row at once,
    on the pairs the TPU kernel visits (its chunk-order block prune and
    token mask).  A pruned or fully masked block is an exact no-op.
    Returns (out like q, lse [B, Hq, Sq] in the accumulation dtype; dead
    rows give out 0 and lse LSE_DEAD)."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    blk_q, blk_k = _flash_blocks(sq, skv, blk_q, blk_k, rate)
    acc_dt = _acc_dtype(q)
    qf = q.to(acc_dt).reshape(b, sq, hkv, rep, dh)
    dev = q.device
    m_acc = torch.full((b, hkv, rep, sq), NEG_INF, dtype=acc_dt, device=dev)
    l_acc = torch.zeros((b, hkv, rep, sq), dtype=acc_dt, device=dev)
    acc = torch.zeros((b, hkv, rep, sq, dh), dtype=acc_dt, device=dev)
    for j in range(skv // blk_k):
        logits, msk, _, sl = _flash_block_logits(
            qf, k, seg_q, pos_q, seg_kv, pos_kv, j, causal=causal,
            window=window, sink=sink, rate=rate, softcap=softcap,
            scale=scale, blk_q=blk_q, blk_k=blk_k)
        m_new = torch.maximum(m_acc, logits.amax(-1))
        p = torch.where(msk, torch.exp(logits - m_new[..., None]), 0.0)
        corr = torch.exp(m_acc - m_new)
        l_acc = l_acc * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p, v[:, sl].to(acc_dt))
        m_acc = m_new
    live = m_acc > NEG_INF / 2
    out = acc / l_acc.clamp(min=1e-30)[..., None]
    out = torch.where(live[..., None], out, 0.0)
    lse = torch.where(live, m_acc + torch.log(l_acc.clamp(min=1e-30)),
                      LSE_DEAD)
    # [B, g, r, q, d] -> [B, q, g, r, d] -> [B, Sq, Hq, dh]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype).contiguous(), lse.reshape(b, hq, sq)


def flash_bwd_reference(q, k, v, out, lse, do, seg_q, pos_q, seg_kv, pos_kv,
                        *, causal=True, window=0, sink=0, rate=1,
                        softcap=0.0, scale=None, blk_q=FLASH_BLOCK,
                        blk_k=FLASH_BLOCK):
    """Plain PyTorch version of ``flash_bwd`` (``kernel.py:310``): p
    rebuilt from the saved lse block by block on the forward's pairs,
    ``delta = rowsum(do * out)``, ``_ds_from_p``'s softcap chain rule, and
    dk/dv summed over the GQA group.  Returns (dq, dk, dv) in the dtypes of
    q, k, v."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    blk_q, blk_k = _flash_blocks(sq, skv, blk_q, blk_k, rate)
    acc_dt = _acc_dtype(q)
    qf = q.to(acc_dt).reshape(b, sq, hkv, rep, dh)
    g5 = do.to(acc_dt).reshape(b, sq, hkv, rep, dh)
    delta = torch.einsum("bqgrd,bqgrd->bgrq", g5,
                         out.to(acc_dt).reshape(b, sq, hkv, rep, dh))
    lse5 = lse.to(acc_dt).reshape(b, hkv, rep, sq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, skv, hkv, dh), dtype=acc_dt, device=k.device)
    dv = torch.zeros_like(dk)
    for j in range(skv // blk_k):
        logits, msk, kj, sl = _flash_block_logits(
            qf, k, seg_q, pos_q, seg_kv, pos_kv, j, causal=causal,
            window=window, sink=sink, rate=rate, softcap=softcap,
            scale=scale, blk_q=blk_q, blk_k=blk_k)
        p = torch.where(msk, torch.exp(logits - lse5[..., None]), 0.0)
        dv[:, sl] = torch.einsum("bgrqk,bqgrd->bkgd", p, g5)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", g5, v[:, sl].to(acc_dt))
        ds = p * (dp - delta[..., None])
        if softcap and softcap > 0:
            sc = torch.where(msk, logits / softcap, 0.0)
            ds = ds * (1.0 - sc * sc)
        ds = ds * scale
        dq = dq + torch.einsum("bgrqk,bkgd->bqgrd", ds, kj)
        dk[:, sl] = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf)
    return (dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_flash_inputs(q, k, v, seg_q, pos_q, seg_kv, pos_kv, blk_q, blk_k,
                        rate, extra=()):
    """Raise on anything the flash kernels do not take."""
    _check_tensors("flash",
                   {"q": q, "k": k, "v": v, "seg_q": seg_q, "pos_q": pos_q,
                    "seg_kv": seg_kv, "pos_kv": pos_kv, **dict(extra)},
                   ("seg_q", "pos_q", "seg_kv", "pos_kv"))
    b, sq, hq, dh = q.shape
    bk, skv, hkv, dh_k = k.shape
    if v.shape != k.shape or bk != b or dh_k != dh:
        raise ValueError(f"flash kernel: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {dh} not in "
                         f"{FLASH_HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"flash kernel: {hq} q heads over {hkv} kv heads")
    if min(b, sq, skv, hq) < 1 or sq % FLASH_TILE or skv % FLASH_TILE:
        raise ValueError(f"flash kernel: B {b}, Sq {sq}, Skv {skv} must be "
                         f"positive, the lengths multiples of {FLASH_TILE}")
    if seg_q.shape != (b, sq) or pos_q.shape != (b, sq) \
            or seg_kv.shape != (b, skv) or pos_kv.shape != (b, skv):
        raise ValueError(f"flash kernel: segment/position shapes "
                         f"{tuple(seg_q.shape)}, {tuple(pos_q.shape)}, "
                         f"{tuple(seg_kv.shape)}, {tuple(pos_kv.shape)} do "
                         f"not fit B={b}, Sq={sq}, Skv={skv}")
    return _flash_blocks(sq, skv, blk_q, blk_k, rate)


_BIG = 2 ** 30


def _kv_tile_groups(seg, pos):
    """Per kv tile of FLASH_TILE slots [B, S / 64], its live slots (seg >
    0) in three groups: those of its smallest segment id, those of its
    largest, and those between.  For each group: (smallest and largest
    segment id it may hold, smallest and largest position, whether it has
    a slot).  A packed tile holds the tail of one document and the head of
    the next, so the first two groups keep the two documents' positions
    apart."""
    b, s = seg.shape
    seg = seg.reshape(b, s // FLASH_TILE, FLASH_TILE).long()
    pos = pos.reshape(b, s // FLASH_TILE, FLASH_TILE).long()
    live = seg > 0
    lo = torch.where(live, seg, _BIG).amin(-1, keepdim=True)
    hi = seg.amax(-1, keepdim=True)
    groups = []
    for sel, s0, s1 in ((live & (seg == lo), lo, lo),
                        (live & (seg == hi), hi, hi),
                        ((seg > lo) & (seg < hi), lo + 1, hi - 1)):
        groups.append((s0[..., 0], s1[..., 0],
                       torch.where(sel, pos, _BIG).amin(-1),
                       torch.where(sel, pos, -_BIG).amax(-1), sel.any(-1)))
    return groups


def _first_last(keep):
    """[.., n] bool -> [.., 2] int32: the first kept index and one past the
    last, (0, 0) where none is kept."""
    n = keep.shape[-1]
    idx = torch.arange(n, device=keep.device)
    lo = torch.where(keep, idx, n).amin(-1)
    hi = torch.where(keep, idx + 1, 0).amax(-1)
    return torch.stack([torch.minimum(lo, hi), hi], -1).to(torch.int32) \
        .contiguous()


def flash_tile_ranges_reference(seg_q, pos_q, seg_kv, pos_kv, *,
                                causal=True, window=0, sink=0):
    """Plain PyTorch version of the document prune of the bf16 flash
    kernels (``flash_tile_ranges``), over tiles of FLASH_TILE rows or
    slots.  A q row may see a kv tile only if one of the tile's slot
    groups (``_kv_tile_groups``) may hold its segment id and meets the
    row's masks on the group's positions: some position at most the row's
    (causal), some inside the window or a sink slot.  A (q tile, kv tile)
    pair is kept when one of the q tile's rows may see the kv tile, so no
    pair visible under ``mask_fn`` is dropped.  Returns (kv_range [B, Sq /
    64, 2], q_range [B, Skv / 64, 2]) int32: per q tile the kv tiles [lo,
    hi) from the first to the last pair kept, per kv tile the q tiles;
    (0, 0) where none.  The kernels test each warp tile inside a range
    exactly, so the prune changes no bit."""
    b, sq = seg_q.shape
    sr = seg_q.long()[:, :, None]                         # [B, Sq, 1]
    pr = pos_q.long()[:, :, None]
    see = torch.zeros((), dtype=torch.bool, device=seg_q.device)
    for s0, s1, p0, p1, some in _kv_tile_groups(seg_kv, pos_kv):
        s0, s1, p0, p1, some = (x[:, None, :]
                                for x in (s0, s1, p0, p1, some))
        ok = some & (s0 <= sr) & (sr <= s1)
        if causal:
            ok = ok & (p0 <= pr)
        if window and window > 0:
            near = pr - p1 < window
            if sink and sink > 0:
                near = near | (p0 < sink)
            ok = ok & near
        see = see | ok                                    # [B, Sq, nT]
    see = see & (sr > 0)
    keep = see.reshape(b, sq // FLASH_TILE, FLASH_TILE, -1).any(2)
    return _first_last(keep), _first_last(keep.transpose(1, 2))


def flash_tile_ranges(seg_q, pos_q, seg_kv, pos_kv, *, causal=True,
                      window=0, sink=0):
    """The document prune of the bf16 flash kernels, on the device before
    any tile is touched: (kv_range [B, Sq / 64, 2], q_range [B, Skv / 64,
    2]) int32, as ``flash_tile_ranges_reference``, which CPU tensors run.
    CUDA tensors (int32, contiguous, lengths multiples of 64) launch the
    kernels ``flash_keep_kernel`` and ``flash_q_range_kernel`` of
    ``csrc/flash.cu`` on the current stream, or raise."""
    if seg_q.device.type == "cpu":
        return flash_tile_ranges_reference(seg_q, pos_q, seg_kv, pos_kv,
                                           causal=causal, window=window,
                                           sink=sink)
    ids = {"seg_q": seg_q, "pos_q": pos_q, "seg_kv": seg_kv,
           "pos_kv": pos_kv}
    for name, x in ids.items():
        if not x.is_cuda or x.device != seg_q.device \
                or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"flash_tile_ranges kernel: {name} must be a "
                             f"contiguous int32 CUDA tensor on "
                             f"{seg_q.device}, got {x.dtype} on {x.device}")
    (b, sq), skv = seg_q.shape, seg_kv.shape[1]
    if pos_q.shape != (b, sq) or seg_kv.shape != (b, skv) \
            or pos_kv.shape != (b, skv) or sq % FLASH_TILE \
            or skv % FLASH_TILE:
        raise ValueError(f"flash_tile_ranges kernel: shapes "
                         f"{tuple(seg_q.shape)}, {tuple(seg_kv.shape)} "
                         f"(lengths multiples of {FLASH_TILE})")
    lib = load_flash_library()
    nq, nt = sq // FLASH_TILE, skv // FLASH_TILE
    dev = seg_q.device
    kv_range = torch.empty((b, nq, 2), dtype=torch.int32, device=dev)
    q_range = torch.empty((b, nt, 2), dtype=torch.int32, device=dev)
    keep = torch.empty((b, nq, nt), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_tile_ranges(
            seg_q.data_ptr(), pos_q.data_ptr(), seg_kv.data_ptr(),
            pos_kv.data_ptr(), kv_range.data_ptr(), q_range.data_ptr(),
            keep.data_ptr(), b, sq, skv, int(bool(causal)),
            int(window or 0), int(sink or 0), stream)
    _raise_on(err, "flash_tile_ranges")
    launches["flash_tile_ranges"] += 1
    return kv_range, q_range


def flash_dkv_split(b: int, skv: int, hkv: int, rep: int, dh: int,
                    n_sms: int):
    """The bf16 dk/dv kernel's grid from shapes alone.  Returns (CTAs per
    head part: batch rows x kv heads x kv-row tiles of 64, 32 at head_dim
    192/256; n_split, the parts the group's rep q heads are cut into; the
    f32 scratch elements of the parts' partial dk/dv).  n_split doubles
    while it divides rep and the grid has fewer than
    FLASH_DKV_CTAS_PER_SM CTAs an SM: recurrentgemma's MQA (one kv head,
    rep 16) has 256 kv-row tiles for 132 SMs, each with 16 heads to walk."""
    rows = 64 if dh <= 128 else 32
    base = b * hkv * (skv // rows)
    n_split = 1
    while base * n_split < FLASH_DKV_CTAS_PER_SM * n_sms \
            and rep % (2 * n_split) == 0:
        n_split *= 2
    scratch = base * n_split * 2 * rows * dh if n_split > 1 else 0
    return base, n_split, scratch


def _flash_scalars(q, k, blk_q, blk_k, causal, window, sink, rate, softcap,
                   scale):
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    return (b, sq, skv, hq, hkv, dh, _DTYPES[q.dtype], int(bool(causal)),
            int(window or 0), int(sink or 0), int(rate or 1), blk_q, blk_k,
            float(softcap or 0.0), float(scale))


def flash_fwd(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *, causal=True,
              window=0, sink=0, rate=1, softcap=0.0, scale=None,
              blk_q=FLASH_BLOCK, blk_k=FLASH_BLOCK):
    """Launch the forward kernel on the current stream.  Layout of the TPU
    kernel ``flash_fwd`` with ``return_lse``; returns (out like q, lse
    [B, Hq, Sq] f32).  CUDA tensors only.  bf16 takes the tensor-core
    kernel over ``flash_tile_ranges``' kv ranges, f32 the exact FMA
    kernel."""
    blk_q, blk_k = _check_flash_inputs(q, k, v, seg_q, pos_q, seg_kv,
                                       pos_kv, blk_q, blk_k, rate)
    b, sq, hq, _ = q.shape
    lib = load_flash_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kv_range = None
        if q.dtype == torch.bfloat16:
            kv_range, _ = flash_tile_ranges(seg_q, pos_q, seg_kv, pos_kv,
                                            causal=causal, window=window,
                                            sink=sink)
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
            pos_q.data_ptr(), seg_kv.data_ptr(), pos_kv.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _ptr(kv_range),
            *_flash_scalars(q, k, blk_q, blk_k, causal, window, sink, rate,
                            softcap, scale), stream)
    _raise_on(err, "flash_fwd")
    launches["flash_fwd"] += 1
    return out, lse


def flash_bwd(q, k, v, out, lse, do, seg_q, pos_q, seg_kv, pos_kv, *,
              causal=True, window=0, sink=0, rate=1, softcap=0.0, scale=None,
              blk_q=FLASH_BLOCK, blk_k=FLASH_BLOCK):
    """The backward from the saved (out, lse): ``delta = rowsum(do * out)``
    in f32 (a torch op, outside the kernels as in the reference), then the
    dq kernel and the dk/dv kernel on the current stream.  Returns
    (dq, dk, dv) in the dtypes of q and k.  CUDA tensors only.  bf16 takes
    the tensor-core kernels over ``flash_tile_ranges``' ranges, dk/dv with
    the head split of ``flash_dkv_split`` (its scratch kept per device and
    stream); f32 the exact FMA kernels."""
    blk_q, blk_k = _check_flash_inputs(
        q, k, v, seg_q, pos_q, seg_kv, pos_kv, blk_q, blk_k, rate,
        extra=(("out", out), ("lse", lse), ("do", do)))
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or out.shape != q.shape \
            or lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: do {tuple(do.shape)} {do.dtype}, out "
                         f"{tuple(out.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype} do not fit q {tuple(q.shape)} "
                         f"{q.dtype}")
    lib = load_flash_library()
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(),
                         out.float()).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scalars = _flash_scalars(q, k, blk_q, blk_k, causal, window, sink, rate,
                             softcap, scale)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), seg_q.data_ptr(),
           pos_q.data_ptr(), seg_kv.data_ptr(), pos_kv.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kv_range = q_range = part = counters = None
        n_split = 1
        if q.dtype == torch.bfloat16:
            kv_range, q_range = flash_tile_ranges(
                seg_q, pos_q, seg_kv, pos_kv, causal=causal, window=window,
                sink=sink)
            base, n_split, n_part = flash_dkv_split(
                b, k.shape[1], k.shape[2], hq // k.shape[2], q.shape[3],
                torch.cuda.get_device_properties(
                    q.device).multi_processor_count)
            if n_split > 1:
                part, counters = _scratch(q.device, stream, n_part, base)
        err = lib.flash_bwd_dq(*ins, dq.data_ptr(), _ptr(kv_range),
                               *scalars, stream)
        _raise_on(err, "flash_bwd_dq")
        launches["flash_bwd_dq"] += 1
        err = lib.flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                _ptr(q_range), _ptr(part), _ptr(counters),
                                *scalars, n_split, stream)
        _raise_on(err, "flash_bwd_dkv")
        launches["flash_bwd_dkv"] += 1
    return dq, dk, dv


def packed_flash_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv,
                           causal=True, window=0, softcap=0.0, scale=None,
                           sink=0, rate=1):
    """Packed-document self-attention (the colocated baseline), the port
    of ``repro.kernels.packed_flash.ops.packed_flash_attention`` without
    its ``bwd_impl`` switch.

    q [B, Sq, Hq, dh]; k / v [B, Skv, Hkv, dh]; seg_* / pos_* [B, S]
    segment ids (0 = padding) and in-document positions.  ``window`` /
    ``sink`` / ``rate`` carry a MaskSpec (DESIGN.md §12), the dilation in
    units of the kernel's 128-token block.  Differentiable in q, k, v.

    CUDA tensors launch the kernels (f32 or bf16, head_dim 64, 128, 192 or
    256, any Hq / Hkv, lengths multiples of 64); anything they do not cover
    raises.
    CPU tensors run the plain versions."""
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"packed_flash_attention: no kernel for device "
                         f"{q.device}")
    opts = dict(causal=causal, window=window, sink=sink, rate=rate,
                softcap=softcap, scale=scale)
    ids = (x.to(torch.int32).contiguous()
           for x in (seg_q, pos_q, seg_kv, pos_kv))
    kernels = ((flash_fwd, flash_bwd),
               (flash_fwd_reference, flash_bwd_reference))
    return _KernelAttention.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), *ids, kernels, opts)


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def load_flash_library() -> ctypes.CDLL:
    lib = build.load("flash", _FLASH_SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i32] * 13 + [f32, f32]         # ints, softcap, scale
    signatures = {"flash_fwd": [ptr] * 10 + scalars + [ptr],
                  "flash_bwd_dq": [ptr] * 12 + scalars + [ptr],
                  "flash_bwd_dkv": [ptr] * 15 + scalars + [i32, ptr]}
    signatures["flash_tile_ranges"] = [ptr] * 7 + [i32] * 6 + [ptr]
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
