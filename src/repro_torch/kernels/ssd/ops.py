"""Mamba-2 SSD intra-chunk step: the CUDA kernels' wrappers beside their
plain PyTorch versions.

* ``ssd_chunk``: the intra-chunk ('dual attention') part of the chunked
  SSD scan with its backward, a ``torch.autograd.Function`` over the
  kernels of ``csrc/ssd_chunk.cu``; plain versions
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
so the reference's H/G-fold repeat of B and C never exists.  nr counts
the resets before each row of the chunk, so it never falls along it.

C, B and x come in one dtype, f32 or bf16 (the model's compute dtype:
in a bf16 model they are the outputs of a bf16 projection and causal
conv, so the TPU kernel's in-kernel f32 cast of them is exact); dt and
csum are f32.  The route follows the dtype:

* bf16 launches the tensor-core kernels (``ssd_fwd_mma``, and for the
  backward ``ssd_bwd_part`` then ``ssd_bwd_fold``): every product on
  mma.sync with f32 accumulators, S = C·Bᵀ once per group, the heads of
  a group split into parts for the backward and the parts summed in a
  fixed order by the fold kernel (no float atomics), dcsum written whole.
* f32 launches the exact FMA kernels (``ssd_chunk_fwd``,
  ``ssd_chunk_bwd_dc``, ``ssd_chunk_bwd_dbx``, then ``ssd_chunk_bwd_dcsum``
  folds their dcsum parts): their forward sums in the order cuBLAS's f32
  products do, which the exactness checks rely on.

The plain versions take either dtype and compute in f32 from the cast
values, so a bf16 call on the CPU equals an f32 call on the same values
bit for bit.  Gradients come back in each input's dtype.

The derivative of ``clip`` is 1 strictly inside (-80, 0), 0 outside and
1/2 at a bound, JAX's convention for ``jnp.clip`` (``torch.clamp`` would
pass the whole gradient at a bound): the plain backward writes it out.

What bounds the kernels on an H100 SXM (3.35 TB/s; 989 TFLOP/s for bf16
operands on the tensor cores, 495 for f32 ones on the TF32 tensor cores,
67 TFLOP/s on the FMA pipes), at mamba2-370m's training shape (Bt 4, K
16, c 256, H 32, N 128, P 64, G 1), counting the live (i, j) pairs of a
batch of long documents and C·Bᵀ, dC and dB once per group: bytes, at
the tensor-core rate, for both directions and both dtypes (``chip_smoke.py``
phase 12 counts them for its inputs).  The f32 FMA kernels compute C·Bᵀ
once per head on the FMA pipes and sit far off that bound; the bf16
kernels are the training path's.  ``csrc/ssd_chunk.cu`` describes both
designs.

On CUDA tensors a wrapper launches its kernel (built with ``nvcc`` at
first use) or raises; on CPU tensors it runs the plain version.  There
is no other route: no fallback from bf16 to the FMA kernels.
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
BF16_MAX_CHUNK = 256                 # c the tensor-core kernels take at most
CLIP_LO = -80.0
#: CTAs the backward's head-part kernel aims for, in SMs of the card: so
#: many waves of one CTA an SM leave a short tail behind the heavy first
#: j-tiles
PART_WAVES = 4

#: kernel launches made by the wrappers (plain counts a run resets and
#: reads to show that the main path went through the kernels): the f32
#: FMA kernels, then the bf16 tensor-core kernels
launches = {"ssd_chunk_fwd": 0, "ssd_chunk_bwd_dc": 0,
            "ssd_chunk_bwd_dbx": 0, "ssd_chunk_bwd_dcsum": 0,
            "ssd_fwd_mma": 0, "ssd_bwd_part": 0, "ssd_bwd_fold": 0}


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
_OPERANDS = ("C", "B", "x")
_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(C, B, x, dt, csum, nr, extra=()):
    """Raise unless C, B and x share one dtype (f32 or bf16), dt, csum
    (and the extra cotangents) are f32 and nr int32, all contiguous CUDA
    tensors on one device, of shapes the kernels take."""
    tensors = dict(C=C, B=B, x=x, dt=dt, csum=csum, nr=nr, **dict(extra))
    if x.dtype not in _DTYPES or C.dtype != x.dtype or B.dtype != x.dtype:
        raise ValueError(f"ssd_chunk kernel: C, B and x must share one dtype "
                         f"of {_DTYPES}, got {C.dtype}, {B.dtype}, {x.dtype} "
                         f"(mixed dtypes are refused)")
    for name, t in tensors.items():
        want = (torch.int32 if name == "nr" else
                x.dtype if name in _OPERANDS else torch.float32)
        if t.dtype != want:
            raise ValueError(f"ssd_chunk kernel: {name} must be {want}, got "
                             f"{t.dtype}")
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_chunk kernel: {name} is on {t.device}, "
                             f"x on {x.device}; the kernels run on CUDA "
                             f"tensors only")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk kernel: {name} not contiguous")
        if name in _OPERANDS and t.data_ptr() % 16:
            raise ValueError(f"ssd_chunk kernel: {name} not 16-byte aligned")
    Bt, K, c, H, P = x.shape
    G, N = C.shape[3], C.shape[4]
    if C.shape != (Bt, K, c, G, N) or B.shape != C.shape \
            or dt.shape != (Bt, K, c, H) or csum.shape != dt.shape \
            or nr.shape != (Bt, K, c) or G < 1 or H % G:
        raise ValueError(f"ssd_chunk kernel: shapes C {tuple(C.shape)}, B "
                         f"{tuple(B.shape)}, x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, csum {tuple(csum.shape)}, nr "
                         f"{tuple(nr.shape)} do not fit")
    if c % TILE or N not in KERNEL_STATE_DIMS or P not in KERNEL_HEAD_DIMS \
            or (x.dtype == torch.bfloat16 and c > BF16_MAX_CHUNK):
        raise ValueError(f"ssd_chunk kernel: chunk {c} (a multiple of "
                         f"{TILE}, at most {BF16_MAX_CHUNK} in bf16), N {N} "
                         f"(one of {KERNEL_STATE_DIMS}) or P {P} (one of "
                         f"{KERNEL_HEAD_DIMS}) not covered")
    return Bt * K, c, H, G, N, P


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def ssd_chunk_fwd(C, B, x, dt, csum, nr):
    """Launch the forward kernel of the inputs' dtype on the current
    stream: bf16 C, B, x the tensor-core kernel, f32 the FMA kernel.
    Returns (y, states) in f32.  CUDA tensors only."""
    dims = _check_inputs(C, B, x, dt, csum, nr)
    Bt, K, c, H, P = x.shape
    N = C.shape[4]
    lib = load_library()
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    states = torch.empty((Bt, K, H, N, P), dtype=torch.float32,
                         device=x.device)
    name, fn = (("ssd_fwd_mma", lib.ssd_chunk_fwd_bf16)
                if x.dtype == torch.bfloat16 else
                ("ssd_chunk_fwd", lib.ssd_chunk_fwd))
    with torch.cuda.device(x.device):
        err = fn(C.data_ptr(), B.data_ptr(), x.data_ptr(), dt.data_ptr(),
                 csum.data_ptr(), nr.data_ptr(), y.data_ptr(),
                 states.data_ptr(), *dims, _stream(x))
    _raise_on(err, name)
    launches[name] += 1
    return y, states


def ssd_head_parts(bk: int, g: int, nt: int, rep: int, sms: int) -> int:
    """The number of parts the bf16 backward splits a group's rep heads
    into: the least divisor of rep that gives the head-part kernel
    PART_WAVES x ``sms`` CTAs (one a (batch·chunk, group, j-tile, part)),
    or rep.  mamba2-370m's training shape (bk 64, g 1, nt 4, rep 32) on
    132 SMs: 4 parts of 8 heads, 1024 CTAs."""
    for d in range(1, rep + 1):
        if rep % d == 0 and bk * g * nt * d >= PART_WAVES * sms:
            return d
    return rep


def _n_parts(x, G):
    Bt, K, c, H, _ = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return ssd_head_parts(Bt * K, G, c // TILE, H // G, sms)


def _bwd_shapes(C, B, x, dt):
    """Shapes of the backward's f32 buffers: the five gradients, then the
    route's scratch (f32: row, col, hend; bf16: dsp, dbp, rowp, hsum)."""
    grads = [C.shape, B.shape, x.shape, dt.shape, dt.shape]
    if x.dtype != torch.bfloat16:
        return grads + [dt.shape] * 3
    Bt, K, c, H, _ = x.shape
    G, N = C.shape[3], C.shape[4]
    bk, nt, np_ = Bt * K, c // TILE, _n_parts(x, G)
    return grads + [(bk * G * nt * (nt + 1) // 2 * np_ * TILE * TILE,),
                    (bk * G * nt * np_ * TILE * N,), (bk * H * nt * c,),
                    (bk * H * nt,)]


def ssd_chunk_bwd_buffers(C, B, x, dt):
    """The backward's outputs and scratch for the route of the inputs'
    dtype, uninitialised, all f32: (dC, dB, dx, ddt, dcsum), then for f32
    inputs the FMA kernels' dcsum parts (row, col, hend [Bt, K, c, H]), for
    bf16 the tensor-core kernels' scratch (dsp, dbp, rowp, hsum; see
    ``csrc/ssd_chunk.cu``) sized for ``ssd_head_parts``'s split."""
    return tuple(torch.empty(s, dtype=torch.float32, device=x.device)
                 for s in _bwd_shapes(C, B, x, dt))


def _check_bwd(C, B, x, dt, csum, nr, dy, dstate):
    """``_check_inputs`` with the cotangents, whose shapes must fit."""
    dims = _check_inputs(C, B, x, dt, csum, nr,
                         extra=(("dy", dy), ("dstate", dstate)))
    Bt, K, c, H, P = x.shape
    N = C.shape[4]
    if dy.shape != x.shape or dstate.shape != (Bt, K, H, N, P):
        raise ValueError(f"ssd_chunk_bwd: dy {tuple(dy.shape)}, dstate "
                         f"{tuple(dstate.shape)} do not fit x "
                         f"{tuple(x.shape)}, N {N}")
    return dims


def _launch_bwd(dims, C, B, x, dt, csum, nr, dy, dstate, out):
    """The backward kernels of the inputs' dtype on the current stream,
    into ``out``, on inputs ``_check_bwd`` passed."""
    lib = load_library()
    dC, dB, dx, ddt, dcsum, *scratch = out
    ins = (C.data_ptr(), B.data_ptr(), x.data_ptr(), dt.data_ptr(),
           csum.data_ptr(), nr.data_ptr(), dy.data_ptr())
    with torch.cuda.device(x.device):
        stream = _stream(x)
        if x.dtype == torch.bfloat16:
            dsp, dbp, rowp, hsum = (t.data_ptr() for t in scratch)
            np_ = _n_parts(x, C.shape[3])
            err = lib.ssd_chunk_bwd_part_bf16(
                *ins, dstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                dcsum.data_ptr(), dsp, dbp, rowp, hsum, *dims, np_, stream)
            _raise_on(err, "ssd_bwd_part")
            launches["ssd_bwd_part"] += 1
            err = lib.ssd_chunk_bwd_fold_bf16(
                B.data_ptr(), nr.data_ptr(), dsp, dbp, rowp, hsum,
                dC.data_ptr(), dB.data_ptr(), dcsum.data_ptr(), *dims, np_,
                stream)
            _raise_on(err, "ssd_bwd_fold")
            launches["ssd_bwd_fold"] += 1
            return
        row, col, hend = scratch
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
        err = lib.ssd_chunk_bwd_dcsum(row.data_ptr(), col.data_ptr(),
                                      hend.data_ptr(), dcsum.data_ptr(),
                                      dims[0], dims[1], dims[2], stream)
        _raise_on(err, "ssd_chunk_bwd_dcsum")
        launches["ssd_chunk_bwd_dcsum"] += 1


def ssd_chunk_bwd_kernels(C, B, x, dt, csum, nr, dy, dstate, out):
    """Launch the backward kernels of the inputs' dtype on the current
    stream into ``out`` (``ssd_chunk_bwd_buffers``).  bf16: the head-part
    kernel (dx, ddt, dcsum's csum_j side, the parts' dB and dS̄ᵀ), then the
    fold kernel (dC, dB, dcsum whole).  f32: the row kernel (dC and the
    csum_i side), the column kernel (dB, dx, ddt, the csum_j side, the end
    state's terms), then the dcsum fold.  CUDA tensors only."""
    dims = _check_bwd(C, B, x, dt, csum, nr, dy, dstate)
    shapes = _bwd_shapes(C, B, x, dt)
    if len(out) != len(shapes) or any(
            o.shape != s or o.dtype != torch.float32 or o.device != x.device
            or not o.is_contiguous() for o, s in zip(out, shapes)):
        raise ValueError("ssd_chunk_bwd: out must be ssd_chunk_bwd_buffers "
                         "of these inputs")
    _launch_bwd(dims, C, B, x, dt, csum, nr, dy, dstate, out)


def ssd_chunk_bwd(C, B, x, dt, csum, nr, dy, dstate):
    """The backward on the current stream: the kernels of the inputs'
    dtype write every gradient whole, dcsum included; no torch op runs
    after them.  Returns (dC, dB, dx, ddt, dcsum) in f32.  CUDA tensors
    only."""
    dims = _check_bwd(C, B, x, dt, csum, nr, dy, dstate)
    out = ssd_chunk_bwd_buffers(C, B, x, dt)
    _launch_bwd(dims, C, B, x, dt, csum, nr, dy, dstate, out)
    return out[:5]


class _SSDChunk(torch.autograd.Function):
    """(y, states) of the intra-chunk step over (fwd, bwd): the kernels
    for CUDA tensors, the plain versions for CPU tensors.  Saves the
    inputs; the backward recomputes S and dec, and returns each gradient
    in its input's dtype (one cast, here)."""

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
        return (dC.to(C.dtype), dB.to(B.dtype), dx.to(x.dtype), ddt, dcsum,
                None)


def ssd_chunk(C, B, x, dt, csum, nr):
    """The Mamba-2 intra-chunk step (module docstring), differentiable in
    C, B, x, dt and csum.  C, B and x in one dtype, f32 or bf16 (anything
    else raises); dt and csum are taken to f32, nr to int32; returns
    (y [Bt,K,c,H,P], states [Bt,K,H,N,P]) in f32.

    CUDA tensors launch the kernels of the dtype (chunk a multiple of 64,
    at most 256 in bf16, N 32/64/128, P 32/64, any G dividing H); anything
    they do not cover raises.  CPU tensors run the plain versions."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or C.dtype != x.dtype or B.dtype != x.dtype:
        raise ValueError(f"ssd_chunk: C, B and x must share one dtype of "
                         f"{_DTYPES}, got {C.dtype}, {B.dtype}, {x.dtype}")
    ops_ = (t.contiguous() for t in (C, B, x))
    f32 = (t.float().contiguous() for t in (dt, csum))
    return _SSDChunk.apply(*ops_, *f32, nr.to(torch.int32).contiguous())


def load_library() -> ctypes.CDLL:
    lib = build.load("ssd_chunk", _SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dims = [i32] * 6                    # BK, c, H, G, N, P
    signatures = {"ssd_chunk_fwd": [ptr] * 8 + dims + [ptr],
                  "ssd_chunk_bwd_dc": [ptr] * 9 + dims + [ptr],
                  "ssd_chunk_bwd_dbx": [ptr] * 13 + dims + [ptr],
                  "ssd_chunk_bwd_dcsum": [ptr] * 4 + [i32] * 3 + [ptr],
                  "ssd_chunk_fwd_bf16": [ptr] * 8 + dims + [ptr],
                  "ssd_chunk_bwd_part_bf16": [ptr] * 15 + dims + [i32, ptr],
                  "ssd_chunk_bwd_fold_bf16": [ptr] * 9 + dims + [i32, ptr]}
    for name, args in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    fn = lib.ssd_chunk_smem_bf16
    if fn.argtypes is None:
        fn.argtypes = [i32] * 4
        fn.restype = ctypes.c_longlong
    return lib


def bf16_smem_bytes(N: int, P: int, c: int) -> dict:
    """Dynamic shared memory of each bf16 kernel at (N, P, c), in bytes,
    as the library computes it (a report for the chip run)."""
    lib = load_library()
    return {name: int(lib.ssd_chunk_smem_bf16(k, N, P, c)) for k, name in
            enumerate(("ssd_fwd_mma", "ssd_bwd_part", "ssd_bwd_fold"))}
