"""Packed-flash attention kernels: each CUDA kernel's wrapper beside its
plain PyTorch version.

* ``ragged_decode_attention``: serving cache attention (DESIGN.md §8),
  kernel ``csrc/ragged_decode.cu``, plain version
  ``ragged_decode_reference``.
* ``ca_server_attention``: the attention server's fused CA-task batch
  with its backward (paper §4.1), a ``torch.autograd.Function`` over the
  kernels ``ca_server_fwd``, ``ca_server_bwd_dq`` and
  ``ca_server_bwd_dkv`` of ``csrc/ca_server.cu``; plain versions
  ``ca_server_fwd_reference`` / ``ca_server_bwd_reference``.

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

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
LSE_DEAD = 2.0 ** 30          # lse of a fully masked row
KV_TILE = 64                  # the CUDA kernel's kv tile; S must divide by it
_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "ragged_decode.cu"
_CA_SOURCE = _CSRC / "ca_server.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
_BLK_Q = (1, 128)
CA_BLOCKS = (64, 128)         # the CA-server kernels' task block sizes

#: kernel launches made by the wrappers (plain counts a run resets and
#: reads to show that the main path went through the kernels)
launches = {"ragged_decode": 0, "ca_server_fwd": 0, "ca_server_bwd_dq": 0,
            "ca_server_bwd_dkv": 0}


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


def ca_server_fwd_reference(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                            kv_pos, *, jmax=0, window=0, sink=0, rate=1,
                            softcap=0.0, scale=None):
    """Plain PyTorch version of ``ca_server_fwd`` (the port of
    ``dispatch._xla_server_fwd_impl``): an online-softmax loop over the
    relative kv block index j < jmax, gathering each task's j-th block.
    Iterations past a task's ``kv_len`` are exact no-ops.  Returns
    (out like q_tasks, lse [T, Hq, blk] in the accumulation dtype)."""
    t, blk, hq, dh = q_tasks.shape
    hkv = k_buf.shape[2]
    rep = hq // hkv
    jmax = jmax or k_buf.shape[0]
    scale = scale if scale is not None else dh ** -0.5
    acc_dt = _acc_dtype(q_tasks)
    qf = q_tasks.to(acc_dt)
    dev = q_tasks.device
    m_acc = torch.full((t, hkv, rep, blk), NEG_INF, dtype=acc_dt, device=dev)
    l_acc = torch.zeros((t, hkv, rep, blk), dtype=acc_dt, device=dev)
    acc = torch.zeros((t, hkv, rep, blk, dh), dtype=acc_dt, device=dev)
    for j in range(jmax):
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
    live = m_acc > NEG_INF / 2
    out = acc / l_acc.clamp(min=1e-30)[..., None]
    out = torch.where(live[..., None], out, 0.0)
    lse = torch.where(live, m_acc + torch.log(l_acc.clamp(min=1e-30)),
                      LSE_DEAD)
    # [T, g, r, q, d] -> [T, q, g, r, d] -> [T, blk, Hq, dh]
    out = out.permute(0, 3, 1, 2, 4).reshape(t, blk, hq, dh)
    return out.to(q_tasks.dtype).contiguous(), lse.reshape(t, hq, blk)


def ca_server_bwd_reference(q_tasks, k_buf, v_buf, out, lse, do, kv_start,
                            kv_len, q_pos, kv_pos, *, jmax=0, window=0,
                            sink=0, rate=1, softcap=0.0, scale=None):
    """Plain PyTorch version of ``ca_server_bwd`` (the port of
    ``dispatch._xla_server_bwd_impl`` without the lse cotangent): p is
    rebuilt from the saved lse block by block; dk/dv fold the GQA group
    and add into the kv buffer rows each task read.  Returns (dq, dk, dv)
    in the dtypes of q_tasks, k_buf, v_buf."""
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
    tensors = {"q_tasks": q, "k_buf": k_buf, "v_buf": v_buf,
               "kv_start": kv_start, "kv_len": kv_len, "q_pos": q_pos,
               "kv_pos": kv_pos, **dict(extra)}
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"ca_server kernel: {name} is on {x.device}, "
                             f"the kernel runs on CUDA tensors only")
        if x.device != q.device:
            raise ValueError(f"ca_server kernel: {name} is on {x.device}, "
                             f"q_tasks on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"ca_server kernel: {name} not contiguous")
    for name in ("kv_start", "kv_len", "q_pos", "kv_pos"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"ca_server kernel: {name} must be int32, got "
                             f"{tensors[name].dtype}")
    if q.dtype not in _DTYPES or k_buf.dtype != q.dtype \
            or v_buf.dtype != q.dtype:
        raise ValueError(f"ca_server kernel: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k_buf.dtype}, "
                         f"{v_buf.dtype}")
    t, blk, hq, dh = q.shape
    n, blk_k, hkv, dh_k = k_buf.shape
    if v_buf.shape != k_buf.shape or blk_k != blk or dh_k != dh:
        raise ValueError(f"ca_server kernel: kv buffers {k_buf.shape}, "
                         f"{v_buf.shape} do not fit q_tasks {q.shape}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"ca_server kernel: head_dim {dh} not in "
                         f"{KERNEL_HEAD_DIMS}")
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
    f32).  CUDA tensors only."""
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
                  softcap=0.0, scale=None):
    """The backward from the saved (out, lse): ``delta = rowsum(do * out)``
    in f32 (a torch op, outside the kernels as in the reference), then
    the dq kernel and the dk/dv kernel on the current stream.  Returns
    (dq, dk, dv) in the dtypes of q_tasks and k_buf.  CUDA tensors only."""
    _check_ca_inputs(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos,
                     extra=(("out", out), ("lse", lse), ("do", do)))
    if do.shape != q_tasks.shape or do.dtype != q_tasks.dtype \
            or lse.dtype != torch.float32:
        raise ValueError(f"ca_server_bwd: do {tuple(do.shape)} {do.dtype}, "
                         f"lse {lse.dtype} do not fit q_tasks "
                         f"{tuple(q_tasks.shape)} {q_tasks.dtype}")
    lib = load_ca_server_library()
    delta = torch.einsum("tqhd,tqhd->thq", do.float(),
                         out.float()).contiguous()
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
        err = lib.ca_server_bwd_dq(*ins, dq.data_ptr(), *scalars, stream)
        _raise_on(err, "ca_server_bwd_dq")
        launches["ca_server_bwd_dq"] += 1
        err = lib.ca_server_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                    *scalars, stream)
        _raise_on(err, "ca_server_bwd_dkv")
        launches["ca_server_bwd_dkv"] += 1
    return dq, dk, dv


class _CAServerAttention(torch.autograd.Function):
    """Forward saves (q, k_buf, v_buf, out, lse); backward rebuilds p from
    the saved lse.  CUDA tensors run the kernels, CPU tensors the plain
    versions."""

    @staticmethod
    def forward(ctx, q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos,
                opts):
        fwd = ca_server_fwd if q_tasks.is_cuda else ca_server_fwd_reference
        out, lse = fwd(q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos,
                       kv_pos, **opts)
        ctx.save_for_backward(q_tasks, k_buf, v_buf, kv_start, kv_len,
                              q_pos, kv_pos, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g):
        q_tasks, k_buf, v_buf, kv_start, kv_len, q_pos, kv_pos, out, lse = \
            ctx.saved_tensors
        bwd = ca_server_bwd if q_tasks.is_cuda else ca_server_bwd_reference
        dq, dk, dv = bwd(q_tasks, k_buf, v_buf, out, lse, g.contiguous(),
                         kv_start, kv_len, q_pos, kv_pos, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


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

    CUDA tensors launch the kernels (f32 or bf16, head_dim 64 or 128,
    blk 64 or 128, any Hq / Hkv); anything they do not cover raises.  CPU
    tensors run the plain versions."""
    if not q_tasks.is_cuda and q_tasks.device.type != "cpu":
        raise ValueError(f"ca_server_attention: no kernel for device "
                         f"{q_tasks.device}")
    opts = dict(jmax=jmax, window=window, sink=sink, rate=rate,
                softcap=softcap, scale=scale)
    return _CAServerAttention.apply(q_tasks, k_buf, v_buf, kv_start, kv_len,
                                    q_pos, kv_pos, opts)


def load_ca_server_library() -> ctypes.CDLL:
    lib = build.load("ca_server", _CA_SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i32] * 11 + [f32, f32, ptr]    # ints, softcap, scale, stream
    signatures = {"ca_server_fwd": [ptr] * 9,
                  "ca_server_bwd_dq": [ptr] * 11,
                  "ca_server_bwd_dkv": [ptr] * 12}
    for name, ptrs in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ptrs + scalars
            fn.restype = ctypes.c_int
    return lib
