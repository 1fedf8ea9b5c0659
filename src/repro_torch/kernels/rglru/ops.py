"""RG-LRU linear recurrence: the CUDA kernels' wrappers beside their
plain PyTorch versions.

* ``lru_scan``: ``h_t = a_t·h_{t-1} + b_t`` over the sequence axis of
  ``[B, S, W]`` per (batch, channel), ``h_{-1} = 0``, with its backward, a
  ``torch.autograd.Function`` over the kernels ``lru_scan_fwd`` and
  ``lru_scan_bwd`` of ``csrc/lru_scan.cu``; plain versions
  ``lru_scan_fwd_reference`` / ``lru_scan_bwd_reference``.

It replaces the TPU kernel ``lru_scan`` of the JAX package
(``repro/kernels/rglru/kernel.py:56``, body ``_lru_kernel``) and the
custom VJP around it (``repro/kernels/rglru/ops.py:32-44``).  Given the
cotangent g of h, the backward is the reverse recurrence::

    db_t = g_t + a_{t+1}·db_{t+1}      (a_S = 0, db_S = 0)
    da_t = db_t·h_{t-1}                (h_{-1} = 0)

The reference runs it as a second forward scan over reversed, shifted
copies of a and g; the backward kernel walks the sequence backwards once
instead.  db comes out in g's dtype and da is formed from that rounded
db, in a's dtype, as the reference's VJP does.

Both versions take one step after another, each step a product then a
sum rounded separately (no fused multiply-add), accumulating in f32 (f64
for f64 inputs): the kernels and the plain versions give the same bits.
The plain forward under autograd is also the recurrence of the model's
``xla`` route (the counterpart of the reference's
``jax.lax.associative_scan``).

The scan moves bytes: two products a value.  On the card one warp walks
32 channels of a batch row (lane = channel) while a producer warp of the
same CTA keeps a ring of 64-step stages (~96 KB) full in shared memory,
one TMA load of a [64, 32] box of each input a stage, completing on
mbarriers, so that enough bytes are in flight to reach the card's memory
rate.  Inputs a tensor map cannot take (W·itemsize not a multiple of 16
bytes, or an input not 16-byte aligned) run a direct variant whose lanes
load ahead into registers; the C side picks the variant, the steps are
the same.  ``kernel_info`` reports each kernel's registers, shared memory
and resident CTAs an SM.

On CUDA tensors a wrapper launches its kernel (built with ``nvcc`` at
first use) or raises; on CPU tensors it runs the plain version.  There
is no other route.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

_SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches made by the wrappers (plain counts a run resets and
#: reads to show that the main path went through the kernels)
launches = {"lru_scan_fwd": 0, "lru_scan_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ plain versions
def _acc_dtype(*tensors: torch.Tensor) -> torch.dtype:
    return torch.float64 if any(t.dtype == torch.float64 for t in tensors) \
        else torch.float32


def lru_scan_fwd_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h [B, S, W] in b's dtype from a, b [B, S, W]: the recurrence one
    step at a time (differentiable by autograd)."""
    acc = _acc_dtype(a, b)
    h = torch.zeros_like(b[:, 0], dtype=acc)
    hs = []
    for at, bt in zip(a.to(acc).unbind(1), b.to(acc).unbind(1)):
        h = at * h + bt
        hs.append(h)
    return torch.stack(hs, 1).to(b.dtype)


def lru_scan_bwd_reference(a: torch.Tensor, h: torch.Tensor,
                           g: torch.Tensor):
    """(da in a's dtype, db in g's dtype) from the forward's a and h and
    the cotangent g, all [B, S, W]: the reverse recurrence one step at a
    time."""
    acc = _acc_dtype(a, h, g)
    af, hf, gf = (t.to(acc) for t in (a, h, g))
    s = a.shape[1]
    d = torch.zeros_like(gf[:, 0])
    dbs = [None] * s
    for t in range(s - 1, -1, -1):
        a_next = af[:, t + 1] if t + 1 < s else torch.zeros_like(d)
        d = gf[:, t] + a_next * d
        dbs[t] = d
    db = torch.stack(dbs, 1).to(g.dtype)
    h_prev = torch.cat([torch.zeros_like(hf[:, :1]), hf[:, :-1]], 1)
    da = (db.to(acc) * h_prev).to(a.dtype)
    return da, db


# ------------------------------------------------------------------ kernels
def _check_inputs(kernel, tensors):
    """Raise unless the tensors are contiguous CUDA tensors of one shape
    [B, S, W] and one dtype (f32 or bf16) on one device."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}; "
                             f"the kernels run on CUDA tensors of one "
                             f"device only")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} not contiguous")
        if t.dtype not in _DTYPES or t.dtype != first.dtype:
            raise ValueError(f"{kernel} kernel: {name} is {t.dtype}; the "
                             f"inputs must share one dtype, float32 or "
                             f"bfloat16")
        if t.dim() != 3 or t.shape != first.shape:
            raise ValueError(f"{kernel} kernel: {name} {tuple(t.shape)}; "
                             f"all inputs must be one [B, S, W] shape")
    b, s, w = first.shape
    if min(b, s, w) < 1:
        raise ValueError(f"{kernel} kernel: empty shape {tuple(first.shape)}")
    return b, s, w, _DTYPES[first.dtype]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def lru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream; returns h like b.
    CUDA tensors only."""
    dims = _check_inputs("lru_scan_fwd", dict(a=a, b=b))
    lib = load_library()
    h = torch.empty_like(b)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.lru_scan_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               *dims, stream)
    _raise_on(err, "lru_scan_fwd")
    launches["lru_scan_fwd"] += 1
    return h


def lru_scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """Launch the backward kernel on the current stream; returns (da, db)
    like a.  CUDA tensors only."""
    dims = _check_inputs("lru_scan_bwd", dict(a=a, h=h, g=g))
    lib = load_library()
    da = torch.empty_like(a)
    db = torch.empty_like(g)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.lru_scan_bwd(a.data_ptr(), h.data_ptr(), g.data_ptr(),
                               da.data_ptr(), db.data_ptr(), *dims, stream)
    _raise_on(err, "lru_scan_bwd")
    launches["lru_scan_bwd"] += 1
    return da, db


class _LRUScan(torch.autograd.Function):
    """h of the recurrence over (fwd, bwd): the kernels for CUDA tensors,
    the plain versions for CPU tensors.  Saves a and h."""

    @staticmethod
    def forward(ctx, a, b):
        fwd, bwd = ((lru_scan_fwd, lru_scan_bwd) if b.is_cuda else
                    (lru_scan_fwd_reference, lru_scan_bwd_reference))
        h = fwd(a, b)
        ctx.save_for_backward(a, h)
        ctx.bwd = bwd
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return ctx.bwd(a, h, g.contiguous())


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t (module docstring), a, b [B, S, W] ->
    h [B, S, W] in b's dtype, differentiable in a and b.

    CUDA tensors launch the kernels (f32 or bf16, a and b of one dtype,
    any B, S, W); anything they do not cover raises.  CPU tensors run the
    plain versions."""
    if not b.is_cuda and b.device.type != "cpu":
        raise ValueError(f"lru_scan: no kernel for device {b.device}")
    return _LRUScan.apply(a.contiguous(), b.contiguous())


def load_library() -> ctypes.CDLL:
    lib = build.load("lru_scan", _SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dims = [i32] * 4 + [ptr]            # B, S, W, dtype, stream
    for name, args in (("lru_scan_fwd", [ptr] * 3 + dims),
                       ("lru_scan_bwd", [ptr] * 5 + dims),
                       ("lru_scan_kernel_info", [i32, ptr])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


#: the kernels ``kernel_info`` describes, in the C side's order
KERNELS = ("lru_scan_fwd_kernel", "lru_scan_bwd_kernel",
           "lru_scan_fwd_direct_kernel", "lru_scan_bwd_direct_kernel")


def kernel_info(dtype: torch.dtype) -> dict:
    """For each kernel of ``KERNELS`` in ``dtype`` (f32 or bf16), on the
    current CUDA device: registers a thread, shared memory a CTA (bytes,
    the ring's included) and CTAs resident an SM."""
    out = (ctypes.c_int * (3 * len(KERNELS)))()
    _raise_on(load_library().lru_scan_kernel_info(_DTYPES[dtype], out),
              "lru_scan_kernel_info")
    return {k: dict(registers=out[3 * i], smem_bytes=out[3 * i + 1],
                    ctas_per_sm=out[3 * i + 2])
            for i, k in enumerate(KERNELS)}
