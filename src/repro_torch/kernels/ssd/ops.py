"""Mamba-2 SSD intra-chunk step: the CUDA kernels' wrappers beside their
plain PyTorch versions.

* ``ssd_chunk``: the intra-chunk ('dual attention') part of the chunked
  SSD scan with its backward, a ``torch.autograd.Function`` over the
  kernels ``ssd_chunk_fwd``, ``ssd_chunk_bwd_dc`` and
  ``ssd_chunk_bwd_dbx`` of ``csrc/ssd_chunk.cu``; plain versions
  ``ssd_chunk_fwd_reference`` / ``ssd_chunk_bwd_reference``.

It replaces the TPU kernel ``ssd_chunk`` of the JAX package
(``repro/kernels/ssd/kernel.py:57``, body ``_ssd_chunk_kernel`` at :25),
which has no backward: the reference trains mamba2 only through its
einsum route.  The backward here is the gradient of the same function,
written by hand (no Pallas counterpart).  Per (batch, chunk, head) tile,
with ``S = C·Bᵀ``::

    dec[i,j] = exp(clip(csum_i - csum_j, -80, 0)) if i >= j and
               nr_i == nr_j, else 0
    y[i]     = sum_j S_ij · dec_ij · dt_j · x_j
    e_j      = exp(clip(csum_end - csum_j, -80, 0)) · [nr_j == nr_end]
    state    = sum_j (B_j · e_j · dt_j) x_jᵀ

The layout is the reference's: C, B ``[Bt, K, c, G, N]``, x
``[Bt, K, c, H, P]``, dt, csum ``[Bt, K, c, H]``, nr ``[Bt, K, c]``
int32; y ``[Bt, K, c, H, P]`` and states ``[Bt, K, H, N, P]`` in f32.
The head axis of C and B has G entries, the number of groups, which
divides H: head h reads group ``h // (H / G)``.  H-sized C and B give
the reference's call exactly; ``_ssd_chunked`` passes the G-sized ones,
so the reference's H/G-fold repeat of B and C never exists.

The derivative of ``clip`` is 1 strictly inside (-80, 0), 0 outside and
1/2 at a bound, JAX's convention for ``jnp.clip`` (``torch.clamp`` would
pass the whole gradient at a bound): the plain backward writes it out.

What bounds the kernels on an H100 SXM (3.35 TB/s; 495 TFLOP/s for f32
operands on the TF32 tensor cores, 67 TFLOP/s on the FMA pipes), at
mamba2-370m's training shape (Bt 4, K 16, c 256, H 32, N 128, P 64,
G 1: 2048 tiles), counting the live (i, j) pairs of a batch of long
documents and C·Bᵀ, dC and dB once per group: the forward needs ~16
GFLOP against ~0.36 GB moved, the backward ~32 GFLOP against ~0.51 GB;
at the tensor-core rate bytes bound both (~0.11 and ~0.15 ms).  The
first kernels do their products on the f32 FMA pipes (where operations
would bound them, at ~0.24 and ~0.48 ms) and compute C·Bᵀ once per head,
not once per group; tensor cores and the per-group products are ROADMAP
queue 2 work.  ``csrc/ssd_chunk.cu`` describes the design.

On CUDA tensors a wrapper launches its kernel (built with ``nvcc`` at
first use) or raises; on CPU tensors it runs the plain version.  There
is no other route.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
TILE = 64                        # the kernels' row tile; c must divide by it
KERNEL_STATE_DIMS = (32, 64, 128)    # N the kernels take
KERNEL_HEAD_DIMS = (32, 64)          # P the kernels take
CLIP_LO = -80.0

#: kernel launches made by the wrappers (plain counts a run resets and
#: reads to show that the main path went through the kernels)
launches = {"ssd_chunk_fwd": 0, "ssd_chunk_bwd_dc": 0,
            "ssd_chunk_bwd_dbx": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ plain versions
def _clip_grad(d: torch.Tensor) -> torch.Tensor:
    """d clip(d, -80, 0) / dd in JAX's convention: 1 inside, 1/2 at a
    bound, 0 outside."""
    inside = (d > CLIP_LO) & (d < 0.0)
    bound = (d == CLIP_LO) | (d == 0.0)
    return inside.float() + 0.5 * bound.float()


def _tile_terms(C, B, csum, nr, rep):
    """The scores S = C·Bᵀ [Bt,K,i,j,H] (each head its group's), the
    differences d = csum_i - csum_j and the masked decay dec, all f32."""
    c = csum.shape[2]
    S = torch.einsum("bkign,bkjgn->bkijg", C.float(), B.float())
    S = S.repeat_interleave(rep, dim=-1)
    d = csum[:, :, :, None, :] - csum[:, :, None, :, :]
    iota = torch.arange(c, device=csum.device)
    tri = iota[:, None] >= iota[None, :]
    same = nr[:, :, :, None] == nr[:, :, None, :]
    live = (tri & same)[..., None]
    dec = torch.where(live, torch.exp(d.clamp(CLIP_LO, 0.0)), 0.0)
    return S, d, dec


def _end_terms(csum, nr):
    """e_j = exp(clip(csum_end - csum_j)) on inputs with no reset after
    them, and d_end = csum_end - csum_j, [Bt,K,c,H]."""
    live = (nr == nr[:, :, -1:])[..., None]
    d_end = csum[:, :, -1:, :] - csum
    e = torch.where(live, torch.exp(d_end.clamp(CLIP_LO, 0.0)), 0.0)
    return e, d_end


def ssd_chunk_fwd_reference(C, B, x, dt, csum, nr):
    """Plain PyTorch version of the forward kernel (the reference's einsum
    route with G-sized C and B).  Returns (y, states) in f32."""
    H = x.shape[3]
    rep = H // C.shape[3]
    x = x.float()
    S, _, dec = _tile_terms(C, B, csum, nr, rep)
    w = S * dec * dt[:, :, None, :, :]
    y = torch.einsum("bkijh,bkjhp->bkihp", w, x)
    e, _ = _end_terms(csum, nr)
    sB = B.float().repeat_interleave(rep, dim=3) * (e * dt)[..., None]
    states = torch.einsum("bkjhn,bkjhp->bkhnp", sB, x)
    return y, states


def ssd_chunk_bwd_reference(C, B, x, dt, csum, nr, dy, dstate):
    """Plain PyTorch version of the backward kernels: the gradient of
    (y, states) with respect to (C, B, x, dt, csum), written out by hand
    (no autograd).  dC and dB are summed over each group's heads.
    Returns (dC, dB, dx, ddt, dcsum) in f32."""
    Bt, K, c, H, P = x.shape
    G, N = C.shape[3], C.shape[4]
    rep = H // G
    x, dy, dstate = x.float(), dy.float(), dstate.float()
    Ch = C.float().repeat_interleave(rep, dim=3)             # [b,k,c,H,N]
    Bh = B.float().repeat_interleave(rep, dim=3)
    S, d, dec = _tile_terms(C, B, csum, nr, rep)
    dtj = dt[:, :, None, :, :]
    dW = torch.einsum("bkihp,bkjhp->bkijh", dy, x)
    dx = torch.einsum("bkijh,bkihp->bkjhp", S * dec * dtj, dy)
    dS = dW * dec * dtj
    dC = torch.einsum("bkijh,bkjhn->bkihn", dS, Bh)
    dB = torch.einsum("bkijh,bkihn->bkjhn", dS, Ch)
    ddt = (dW * S * dec).sum(2)
    # the decay's dependence on csum; on the diagonal both sides of the
    # difference are one variable, so its terms cancel
    off = ~torch.eye(c, dtype=torch.bool, device=x.device)[..., None]
    g = torch.where(off, dW * S * dtj * dec * _clip_grad(d), 0.0)
    dcsum = g.sum(3) - g.sum(2)
    # the chunk end state
    e, d_end = _end_terms(csum, nr)
    u = e * dt
    q = torch.einsum("bkhnp,bkjhp->bkjhn", dstate, x)        # dstate x_j
    dB = dB + u[..., None] * q
    s = (Bh * q).sum(-1)                                     # B_j·dstate x_j
    ddt = ddt + e * s
    dx = dx + u[..., None] * torch.einsum("bkhnp,bkjhn->bkjhp", dstate, Bh)
    hj = dt * s * e * _clip_grad(d_end)
    hj[:, :, -1] = 0.0
    dcsum = dcsum - hj
    dcsum[:, :, -1] += hj.sum(2)
    dC = dC.reshape(Bt, K, c, G, rep, N).sum(4)
    dB = dB.reshape(Bt, K, c, G, rep, N).sum(4)
    return dC, dB, dx, ddt, dcsum


# ------------------------------------------------------------------ kernels
def _check_inputs(C, B, x, dt, csum, nr, extra=()):
    """Raise unless the tensors are contiguous CUDA tensors on one device,
    f32 (nr int32), of shapes the kernels take."""
    tensors = dict(C=C, B=B, x=x, dt=dt, csum=csum, nr=nr, **dict(extra))
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_chunk kernel: {name} is on {t.device}, "
                             f"x on {x.device}; the kernels run on CUDA "
                             f"tensors only")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk kernel: {name} not contiguous")
        want = torch.int32 if name == "nr" else torch.float32
        if t.dtype != want:
            raise ValueError(f"ssd_chunk kernel: {name} must be {want}, got "
                             f"{t.dtype}")
    Bt, K, c, H, P = x.shape
    G, N = C.shape[3], C.shape[4]
    if C.shape != (Bt, K, c, G, N) or B.shape != C.shape \
            or dt.shape != (Bt, K, c, H) or csum.shape != dt.shape \
            or nr.shape != (Bt, K, c) or G < 1 or H % G:
        raise ValueError(f"ssd_chunk kernel: shapes C {tuple(C.shape)}, B "
                         f"{tuple(B.shape)}, x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, csum {tuple(csum.shape)}, nr "
                         f"{tuple(nr.shape)} do not fit")
    if c % TILE or N not in KERNEL_STATE_DIMS or P not in KERNEL_HEAD_DIMS:
        raise ValueError(f"ssd_chunk kernel: chunk {c} (a multiple of "
                         f"{TILE}), N {N} (one of {KERNEL_STATE_DIMS}) or "
                         f"P {P} (one of {KERNEL_HEAD_DIMS}) not covered")
    return Bt * K, c, H, G, N, P


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ssd_chunk_fwd(C, B, x, dt, csum, nr):
    """Launch the forward kernel on the current stream; returns (y,
    states) in f32.  CUDA tensors only."""
    dims = _check_inputs(C, B, x, dt, csum, nr)
    Bt, K, c, H, P = x.shape
    N = C.shape[4]
    lib = load_library()
    y = torch.empty_like(x)
    states = torch.empty((Bt, K, H, N, P), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk_fwd(C.data_ptr(), B.data_ptr(), x.data_ptr(),
                                dt.data_ptr(), csum.data_ptr(),
                                nr.data_ptr(), y.data_ptr(),
                                states.data_ptr(), *dims, stream)
    _raise_on(err, "ssd_chunk_fwd")
    launches["ssd_chunk_fwd"] += 1
    return y, states


def ssd_chunk_bwd_buffers(C, B, x, dt):
    """The backward kernels' outputs, uninitialised: (dC, dB, dx, ddt,
    row, col, hend), where row and col are the csum_i and csum_j sides of
    dcsum and hend the end state's terms for csum_end."""
    return (torch.empty_like(C), torch.empty_like(B), torch.empty_like(x),
            *(torch.empty_like(dt) for _ in range(4)))


def ssd_chunk_bwd_kernels(C, B, x, dt, csum, nr, dy, dstate, out):
    """Launch the backward kernels on the current stream into ``out``
    (``ssd_chunk_bwd_buffers``): the row kernel (dC and row), then the
    column kernel (dB, dx, ddt, col and hend).  CUDA tensors only."""
    dims = _check_inputs(C, B, x, dt, csum, nr,
                         extra=(("dy", dy), ("dstate", dstate)))
    Bt, K, c, H, P = x.shape
    N = C.shape[4]
    if dy.shape != x.shape or dstate.shape != (Bt, K, H, N, P):
        raise ValueError(f"ssd_chunk_bwd: dy {tuple(dy.shape)}, dstate "
                         f"{tuple(dstate.shape)} do not fit x "
                         f"{tuple(x.shape)}, N {N}")
    like = (C, B, x) + (dt,) * 4
    if len(out) != 7 or any(o.shape != t.shape or o.dtype != t.dtype
                            or o.device != t.device or not o.is_contiguous()
                            for o, t in zip(out, like)):
        raise ValueError("ssd_chunk_bwd: out must be ssd_chunk_bwd_buffers "
                         "of these inputs")
    lib = load_library()
    dC, dB, dx, ddt, row, col, hend = out
    ins = (C.data_ptr(), B.data_ptr(), x.data_ptr(), dt.data_ptr(),
           csum.data_ptr(), nr.data_ptr(), dy.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk_bwd_dc(*ins, dC.data_ptr(), row.data_ptr(),
                                   *dims, stream)
        _raise_on(err, "ssd_chunk_bwd_dc")
        launches["ssd_chunk_bwd_dc"] += 1
        err = lib.ssd_chunk_bwd_dbx(*ins, dstate.data_ptr(), dB.data_ptr(),
                                    dx.data_ptr(), ddt.data_ptr(),
                                    col.data_ptr(), hend.data_ptr(), *dims,
                                    stream)
        _raise_on(err, "ssd_chunk_bwd_dbx")
        launches["ssd_chunk_bwd_dbx"] += 1


def ssd_chunk_bwd(C, B, x, dt, csum, nr, dy, dstate):
    """The backward on the current stream: the two kernels, then torch
    ops add the two dcsum parts and the end state's sum into csum_end.
    Returns (dC, dB, dx, ddt, dcsum) in f32.  CUDA tensors only."""
    out = ssd_chunk_bwd_buffers(C, B, x, dt)
    ssd_chunk_bwd_kernels(C, B, x, dt, csum, nr, dy, dstate, out)
    dC, dB, dx, ddt, row, col, hend = out
    dcsum = row + col
    dcsum[:, :, -1] += hend.sum(2)
    return dC, dB, dx, ddt, dcsum


class _SSDChunk(torch.autograd.Function):
    """(y, states) of the intra-chunk step over (fwd, bwd): the kernels
    for CUDA tensors, the plain versions for CPU tensors.  Saves the
    inputs; the backward recomputes S and dec."""

    @staticmethod
    def forward(ctx, C, B, x, dt, csum, nr):
        fwd, bwd = ((ssd_chunk_fwd, ssd_chunk_bwd) if x.is_cuda else
                    (ssd_chunk_fwd_reference, ssd_chunk_bwd_reference))
        y, states = fwd(C, B, x, dt, csum, nr)
        ctx.save_for_backward(C, B, x, dt, csum, nr)
        ctx.bwd = bwd
        return y, states

    @staticmethod
    def backward(ctx, dy, dstate):
        C, B, x, dt, csum, nr = ctx.saved_tensors
        dC, dB, dx, ddt, dcsum = ctx.bwd(C, B, x, dt, csum, nr,
                                         dy.contiguous(),
                                         dstate.contiguous())
        return dC, dB, dx, ddt, dcsum, None


def ssd_chunk(C, B, x, dt, csum, nr):
    """The Mamba-2 intra-chunk step (module docstring), differentiable in
    C, B, x, dt and csum.  Inputs are taken to f32 (nr to int32); returns
    (y [Bt,K,c,H,P], states [Bt,K,H,N,P]) in f32.

    CUDA tensors launch the kernels (chunk a multiple of 64, N 32/64/128,
    P 32/64, any G dividing H); anything they do not cover raises.  CPU
    tensors run the plain versions."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    f32 = (t.float().contiguous() for t in (C, B, x, dt, csum))
    return _SSDChunk.apply(*f32, nr.to(torch.int32).contiguous())


def load_library() -> ctypes.CDLL:
    lib = build.load("ssd_chunk", _SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dims = [i32] * 6 + [ptr]            # BK, c, H, G, N, P, stream
    signatures = {"ssd_chunk_fwd": [ptr] * 8,
                  "ssd_chunk_bwd_dc": [ptr] * 9,
                  "ssd_chunk_bwd_dbx": [ptr] * 13}
    for name, ptrs in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ptrs + dims
            fn.restype = ctypes.c_int
    return lib
