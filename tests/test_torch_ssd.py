"""The port's SSD intra-chunk step (``repro_torch.kernels.ssd``, its plain
versions on CPU tensors) and the Mamba-2 layer functions around it against
the JAX package: the forward against the TPU kernel ``K.ssd_chunk`` in
interpret mode (as ``tests/test_kernels_ssd.py`` runs it) and the oracle
``ref_ssd_chunk``; G-sized against H-sized B and C; the hand-written
backward against ``jax.vjp`` of the oracle (the TPU kernel has none);
``_ssd_chunked`` under ``pallas`` and ``xla`` and ``ssd_apply`` against the
reference's; the route by dtype (bf16 C, B and x on the CPU equal to the
f32 call on the same values, bit for bit; the wrappers' refusals); the
backward's head split; the build's header hash.  Inputs from numpy seeds.

Tolerances: ``KERNEL_TOL`` (atol 2e-5, rtol 1e-5) on y and states, whose
sums run in another order in each framework; gradients rtol 1e-4 with an
atol of 1e-5 x max |grad| (a gradient sums up to two chunks' worth of
products, so its rounding scales with its largest entry); the layer
functions ``MODEL_TOL``."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.ssd import kernel as K
from repro.kernels.ssd import ref as R
from repro.models import layers as JL
from repro.parallel import ParallelContext as JCtx
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops
from repro_torch.models import layers as TL
from repro_torch.parallel import ParallelContext
from test_torch_helpers import KERNEL_TOL, MODEL_TOL, to_numpy, to_torch

RESETS = ("none", "chunk start", "mid-chunk", "every position",
          "csum below -80")


def make(seed, Bt, Kc, c, H, N, P, G=None, reset="mid-chunk"):
    """Kernel inputs (numpy, f32): C/B [Bt,K,c,G,N] (G = H unless given),
    x, dt, csum, nr, and a cotangent (dy, dstate).  ``reset`` picks nr and
    the decay as in ``chip_smoke.py``'s phase 2."""
    rng = np.random.default_rng(seed)
    G = H if G is None else G

    def softplus(v):
        return np.log1p(np.exp(v))
    f32 = np.float32
    C = rng.standard_normal((Bt, Kc, c, G, N)).astype(f32)
    B = rng.standard_normal((Bt, Kc, c, G, N)).astype(f32)
    x = rng.standard_normal((Bt, Kc, c, H, P)).astype(f32)
    dt = softplus(rng.standard_normal((Bt, Kc, c, H))).astype(f32)
    la = -softplus(rng.standard_normal((Bt, Kc, c, H)))
    if reset == "none":
        nr = np.zeros((Bt, Kc, c))
    elif reset == "chunk start":
        nr = np.ones((Bt, Kc, c))
    elif reset == "mid-chunk":
        nr = np.sort(rng.integers(0, 3, (Bt, Kc, c)), axis=-1)
        la[rng.random(la.shape) < 0.2] = 0.0     # equal csums off-diagonal
    elif reset == "every position":
        nr = np.broadcast_to(np.arange(c), (Bt, Kc, c))
    else:
        nr = np.zeros((Bt, Kc, c))
        la = la * 8.0
    csum = np.cumsum(la, axis=2).astype(f32)
    dy = rng.standard_normal((Bt, Kc, c, H, P)).astype(f32)
    dstate = rng.standard_normal((Bt, Kc, H, N, P)).astype(f32)
    args = (C, B, x, dt, csum, np.ascontiguousarray(nr, dtype=np.int32))
    return args, (dy, dstate)


def _repeat(args, H):
    """The H-sized C and B of G-sized inputs (the reference's repeat)."""
    C, B, *rest = args
    rep = H // C.shape[3]
    return (np.repeat(C, rep, axis=3), np.repeat(B, rep, axis=3), *rest)


def _oracle(C, B, x, dt, csum, nr):
    """``ref_ssd_chunk`` over every (batch, chunk, head), H-sized C/B."""
    per_head = jax.vmap(R.ref_ssd_chunk, in_axes=(1, 1, 1, 1, 1, None),
                        out_axes=(1, 0))
    return jax.vmap(jax.vmap(per_head))(C, B, x, dt, csum, nr)


def _torch(args):
    return [to_torch(a) for a in args]


@pytest.mark.parametrize("Bt,Kc,c,H,N,P,reset", [
    (2, 3, 128, 2, 64, 32, "mid-chunk"),
    (1, 2, 256, 1, 128, 64, "none"),
    (2, 2, 64, 4, 32, 64, "chunk start"),
    (2, 2, 64, 2, 32, 32, "every position"),
    (2, 2, 64, 2, 32, 32, "csum below -80"),
])
def test_forward_matches_tpu_kernel_and_oracle(Bt, Kc, c, H, N, P, reset):
    args, _ = make(0, Bt, Kc, c, H, N, P, reset=reset)
    y, st = ops.ssd_chunk(*_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    y_k, st_k = K.ssd_chunk(*jargs)
    y_o, st_o = _oracle(*jargs)
    for want in ((y_k, st_k), (y_o, st_o)):
        np.testing.assert_allclose(to_numpy(y), np.asarray(want[0]),
                                   **KERNEL_TOL)
        np.testing.assert_allclose(to_numpy(st), np.asarray(want[1]),
                                   **KERNEL_TOL)


@pytest.mark.parametrize("G,H", [(1, 4), (2, 8)])
def test_group_sized_inputs_match_repeated(G, H):
    """Head h reads group h // (H / G): G-sized C and B give what the
    reference's H-sized (repeated) ones give, forward and backward (the
    group's gradients summed over its heads)."""
    args, cot = make(1, 2, 2, 64, H, 32, 32, G=G)
    full = _repeat(args, H)
    got = ops.ssd_chunk_fwd_reference(*_torch(args))
    want = ops.ssd_chunk_fwd_reference(*_torch(full))
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), **KERNEL_TOL)
    g_got = ops.ssd_chunk_bwd_reference(*_torch(args), *_torch(cot))
    g_full = ops.ssd_chunk_bwd_reference(*_torch(full), *_torch(cot))
    rep = H // G
    for k, (a, b) in enumerate(zip(g_got, g_full)):
        if k < 2:                       # dC, dB: fold the group's heads
            b = b.reshape(*b.shape[:3], G, rep, -1).sum(4)
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("reset", RESETS)
@pytest.mark.parametrize("G", [1, 4])
def test_backward_matches_jax_vjp_of_oracle(reset, G):
    """dC, dB, dx, ddt and dcsum of the plain backward against
    ``jax.vjp`` of the oracle, whose ``jnp.clip`` passes half the gradient
    at a bound (the equal csums of ``mid-chunk`` hit the upper bound off
    the diagonal, ``csum below -80`` the lower range)."""
    H = 4
    args, cot = make(2, 2, 2, 64, H, 32, 16, G=G, reset=reset)
    C, B, x, dt, csum, nr = _repeat(args, H)
    f = lambda *a: _oracle(*a, jnp.asarray(nr))  # noqa: E731
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (C, B, x, dt, csum)))
    want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot))]
    rep = H // G
    for k in (0, 1):
        want[k] = want[k].reshape(*want[k].shape[:3], G, rep, -1).sum(4)
    got = ops.ssd_chunk_bwd_reference(*_torch(args), *_torch(cot))
    # and the autograd Function over the same plain versions
    leaves = [t.requires_grad_() for t in _torch(args[:5])]
    y, st = ops.ssd_chunk(*leaves, to_torch(args[5]))
    auto = torch.autograd.grad((y, st), leaves, _torch(cot))
    for name, g, a, w in zip(("dC", "dB", "dx", "ddt", "dcsum"), got, auto,
                             want):
        tol = dict(rtol=1e-4, atol=1e-5 * float(np.abs(w).max()))
        np.testing.assert_allclose(to_numpy(g), w, err_msg=name, **tol)
        np.testing.assert_array_equal(to_numpy(a), to_numpy(g),
                                      err_msg=name)


def _chunked_inputs(seed, b=2, S=128, H=4, P=16, G=2, N=16):
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def softplus(v):
        return np.log1p(np.exp(v)).astype(f32)
    x = rng.standard_normal((b, S, H, P)).astype(f32)
    dt = softplus(rng.standard_normal((b, S, H)))
    log_a = -softplus(rng.standard_normal((b, S, H)))
    B_ = rng.standard_normal((b, S, G, N)).astype(f32)
    C_ = rng.standard_normal((b, S, G, N)).astype(f32)
    first = np.zeros((b, S), bool)
    first[:, 0] = True
    first[0, [40, 64, 100]] = True      # a reset on a chunk boundary too
    first[1, 90] = True
    return x, dt, log_a, B_, C_, first


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ssd_chunked_matches_reference(impl):
    """``_ssd_chunked`` over 4 chunks of 32 with resets mid-chunk and on a
    chunk boundary, against the reference's under the same impl (its
    ``pallas`` route is the TPU kernel in interpret mode)."""
    *arrays, first = _chunked_inputs(3)
    want = JL._ssd_chunked(*(jnp.asarray(a) for a in arrays), 32,
                           jnp.asarray(first), ctx=JCtx(attn_impl=impl))
    arrays.append(first)
    x, dt, la, B_, C_, first = (to_torch(a) for a in arrays)
    got = TL._ssd_chunked(x, dt, la, B_, C_, 32, first,
                          ctx=ParallelContext(attn_impl=impl))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


def test_ssd_chunked_routes_agree_and_pallas_runs_the_op(monkeypatch):
    """Under ``pallas`` the intra-chunk step goes through ``ssd_chunk``
    with the G-sized B and C; the einsum route gives the same y."""
    calls = []
    real = TL.ssd_ops.ssd_chunk

    def spy(**args):
        calls.append((tuple(args["C"].shape), tuple(args["B"].shape)))
        return real(**args)
    monkeypatch.setattr(TL.ssd_ops, "ssd_chunk", spy)
    x, dt, la, B_, C_, first = (to_torch(a) for a in _chunked_inputs(4))
    ys = {impl: TL._ssd_chunked(x, dt, la, B_, C_, 32, first,
                                ctx=ParallelContext(attn_impl=impl))
          for impl in ("pallas", "xla")}
    assert calls == [((2, 4, 32, 2, 16), (2, 4, 32, 2, 16))]
    np.testing.assert_allclose(to_numpy(ys["pallas"]), to_numpy(ys["xla"]),
                               **MODEL_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ssd_apply_matches_reference(impl):
    """The whole Mamba-2 mixer on mamba2-370m-reduced widths (in_proj,
    the document-gated causal conv, softplus dt, the chunked scan, the
    gated out_norm and out_proj), two documents in the second row."""
    cfg_j = jax_config("mamba2-370m-reduced")
    cfg_t = torch_config("mamba2-370m-reduced")
    p = JL.ssd_init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 128, cfg_j.d_model)).astype(np.float32)
    seg = np.ones((2, 128), np.int32)
    seg[1, 70:] = 2
    want = JL.ssd_apply(p, jnp.asarray(h), {"segment_ids": jnp.asarray(seg)},
                        cfg_j, JCtx(attn_impl=impl))
    pt = {k: (to_torch(v) if not isinstance(v, dict) else
              {kk: to_torch(vv) for kk, vv in v.items()})
          for k, v in p.items()}
    got = TL.ssd_apply(pt, to_torch(h), {"segment_ids": to_torch(seg)},
                       cfg_t, ParallelContext(attn_impl=impl))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)
    assert dataclasses.asdict(cfg_t.ssm) == dataclasses.asdict(cfg_j.ssm)


def test_causal_conv_gates_document_boundaries():
    """Against the reference's ``_causal_conv`` with a boundary: taps that
    reach back across a document start contribute nothing."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    first = np.zeros((2, 16), bool)
    first[:, 0] = True
    first[1, 5] = True
    want, _ = JL._causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                              first=jnp.asarray(first))
    got, _ = TL._causal_conv(*(to_torch(a) for a in (x, w, b)),
                             first=to_torch(first))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)
    # row 1 from position 5 on equals the conv of that document alone (to
    # rounding: silu's vectorised and scalar paths may differ in the last
    # bit)
    alone, _ = TL._causal_conv(to_torch(x[1:, 5:]), to_torch(w),
                               to_torch(b),
                               first=torch.tensor([[True] + [False] * 10]))
    np.testing.assert_allclose(to_numpy(got[1:, 5:]), to_numpy(alone),
                               rtol=1e-6, atol=1e-7)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels run on CUDA tensors only; the CPU route is
    ``ssd_chunk``'s plain version, never a fallback inside a wrapper."""
    args, cot = make(7, 1, 1, 64, 2, 32, 32)
    t = _torch(args)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ssd_chunk_fwd(*t)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ssd_chunk_bwd(*t, *_torch(cot))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ssd_chunk_bwd_kernels(*t, *_torch(cot),
                                  ops.ssd_chunk_bwd_buffers(*t[:4]))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd_chunk(*(x.to("meta") for x in t))


def _bf16_values(args):
    """The inputs with C, B and x rounded to bf16 (numpy f32 arrays
    holding bf16 values) and the same as bf16 CPU tensors."""
    t = _torch(args)
    low = [a.to(torch.bfloat16) if k < 3 else a for k, a in enumerate(t)]
    vals = [to_numpy(a.float()) if k < 3 else args[k]
            for k, a in enumerate(low)]
    return vals, low


@pytest.mark.parametrize("G,reset", [(1, "mid-chunk"), (2, "none"),
                                     (4, "every position")])
def test_bf16_call_equals_f32_call_bitwise(G, reset):
    """bf16 C, B and x on CPU tensors: ``ssd_chunk`` runs the plain
    versions in f32 from the cast values, so forward and backward equal an
    f32 call on the same values bit for bit; the gradients of C, B and x
    come back in bf16 (the f32 gradients cast), dt's and csum's in f32."""
    args, cot = make(8, 2, 2, 64, 4, 32, 16, G=G, reset=reset)
    vals, low = _bf16_values(args)
    f32 = [t.requires_grad_() for t in _torch(vals[:5])]
    bf = [t.clone().requires_grad_() for t in low[:5]]
    nr = to_torch(args[5])
    out32 = ops.ssd_chunk(*f32, nr)
    out16 = ops.ssd_chunk(*bf, nr)
    for a, b in zip(out16, out32):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)
    g32 = torch.autograd.grad(out32, f32, _torch(cot))
    g16 = torch.autograd.grad(out16, bf, _torch(cot))
    for k, (a, b) in enumerate(zip(g16, g32)):
        want = torch.bfloat16 if k < 3 else torch.float32
        assert a.dtype == want
        assert torch.equal(a, b.to(want))


@pytest.mark.parametrize("reset", ["mid-chunk", "csum below -80"])
def test_bf16_rounded_inputs_match_tpu_kernel(reset):
    """The bf16-rounded inputs through the TPU kernel in interpret mode
    (which casts them to f32 inside, as the port's kernels read them) and
    through ``ssd_chunk`` with bf16 C, B and x: within ``KERNEL_TOL``."""
    args, _ = make(9, 2, 2, 128, 2, 64, 32, reset=reset)
    vals, low = _bf16_values(args)
    y, st = ops.ssd_chunk(*low)
    y_k, st_k = K.ssd_chunk(*(jnp.asarray(a) for a in vals))
    np.testing.assert_allclose(to_numpy(y), np.asarray(y_k), **KERNEL_TOL)
    np.testing.assert_allclose(to_numpy(st), np.asarray(st_k), **KERNEL_TOL)


def test_ssd_chunked_hands_the_op_the_compute_dtype(monkeypatch):
    """Under ``pallas`` in bf16, ``_ssd_chunked`` hands ``ssd_chunk`` x, B
    and C in bf16 (the tensor-core route on the card) with dt and csum in
    f32; the einsum route, on f32 casts of the same values, gives the same
    y bit for bit."""
    calls = []
    real = TL.ssd_ops.ssd_chunk

    def spy(**args):
        calls.append({k: v.dtype for k, v in args.items()})
        return real(**args)
    monkeypatch.setattr(TL.ssd_ops, "ssd_chunk", spy)
    x, dt, la, B_, C_, first = (to_torch(a) for a in _chunked_inputs(10))
    x, B_, C_ = (t.to(torch.bfloat16) for t in (x, B_, C_))
    ys = {impl: TL._ssd_chunked(x, dt, la, B_, C_, 32, first,
                                ctx=ParallelContext(attn_impl=impl))
          for impl in ("pallas", "xla")}
    bf, f32 = torch.bfloat16, torch.float32
    assert calls == [dict(C=bf, B=bf, x=bf, dt=f32, csum=f32,
                          nr=torch.int32)]
    assert ys["pallas"].dtype == bf
    assert torch.equal(ys["pallas"], ys["xla"])


def test_kernel_wrappers_refuse_mixed_dtypes():
    """C, B and x must share one dtype, f32 or bf16, and dt, csum, dy and
    dstate be f32: the wrappers and ``ssd_chunk`` refuse anything else
    before they look at the device; bf16 CPU tensors are refused by the
    kernel wrappers like f32 ones."""
    args, cot = make(11, 1, 1, 64, 2, 32, 32)
    t = _torch(args)
    mixed = [t[0].to(torch.bfloat16), *t[1:]]
    for fn in (ops.ssd_chunk_fwd, ops.ssd_chunk):
        with pytest.raises(ValueError, match="one dtype"):
            fn(*mixed)
    with pytest.raises(ValueError, match="one dtype"):
        ops.ssd_chunk_bwd(*mixed, *_torch(cot))
    with pytest.raises(ValueError, match="one dtype"):
        ops.ssd_chunk(*(a.half() if k < 3 else a for k, a in enumerate(t)))
    low = [a.to(torch.bfloat16) if k < 3 else a for k, a in enumerate(t)]
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        ops.ssd_chunk_fwd(*low[:3], low[3].to(torch.bfloat16), *low[4:])
    with pytest.raises(ValueError, match="dy must be torch.float32"):
        ops.ssd_chunk_bwd(*low, cot_bf := _torch(cot)[0].bfloat16(),
                          _torch(cot)[1])
    assert cot_bf.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ssd_chunk_fwd(*low)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ssd_chunk_bwd(*low, *_torch(cot))


@pytest.mark.parametrize("bk,g,nt,rep,sms,want", [
    (64, 1, 4, 32, 132, 4),     # mamba2-370m's training shape: 1024 CTAs
    (64, 1, 4, 32, 16, 1),      # a small card: the group in one part
    (4, 1, 4, 32, 132, 32),     # too few chunks: every head its own part
    (4, 2, 2, 4, 132, 4),
    (16, 2, 4, 6, 132, 6),      # 6 heads: 3 parts give 384 < 528 CTAs
])
def test_head_parts_fill_the_card(bk, g, nt, rep, sms, want):
    """The backward's head split: the least divisor of rep whose grid
    reaches PART_WAVES x sms CTAs, or rep."""
    got = ops.ssd_head_parts(bk, g, nt, rep, sms)
    assert got == want
    assert rep % got == 0


def test_build_hash_covers_every_included_header(tmp_path, monkeypatch):
    """``build.included_headers`` follows ``#include "..."`` through the
    headers, beside the including file first and then in the shared
    ``kernels/csrc``, so a header edit changes the library's tag; the SSD
    source reaches the shared ``mma.cuh``, the flash source its two local
    headers and ``mma.cuh`` through ``common.cuh``."""
    ssd_src = Path(ops.__file__).parent / "csrc" / "ssd_chunk.cu"
    assert [p.name for p in build.included_headers(ssd_src)] == ["mma.cuh"]
    flash = Path(build.__file__).parent / "packed_flash" / "csrc" / "flash.cu"
    assert [p.name for p in build.included_headers(flash)] == [
        "common.cuh", "tiles.cuh", "mma.cuh"]
    src = tmp_path / "k.cu"
    src.write_text('#include "local.cuh"\n#include <cstdint>\n')
    (tmp_path / "local.cuh").write_text('#include "mma.cuh"\nint a;\n')
    tag0 = build.source_tag(src)
    assert [p.name for p in build.included_headers(src)] == [
        "local.cuh", "mma.cuh"]
    (tmp_path / "local.cuh").write_text('#include "mma.cuh"\nint b;\n')
    assert build.source_tag(src) != tag0
    monkeypatch.setattr(build, "INCLUDE_DIR", tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="mma.cuh"):
        build.included_headers(src)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("reset", RESETS)
def test_chip_smoke_witnesses_match_oracle(reset):
    """The witnesses ``chip_smoke.py`` sets beside mamba2's full-depth loss
    gap compute the intra-chunk step's function, each in another
    arithmetic: the plain version in f64, in f32 summing j in 16-row
    blocks, and with S from the TF32 products (on the CPU, f32 ones).  On
    bf16-rounded G-sized inputs, each within ``KERNEL_TOL`` of the JAX
    oracle ``ref_ssd_chunk`` on the H-sized ones."""
    cs = _chip_smoke()
    args, _ = make(10, 2, 2, 64, 4, 32, 16, G=2, reset=reset)
    vals, low = _bf16_values(args)
    jargs = [jnp.asarray(a) for a in _repeat(vals, 4)]
    y_o, st_o = (np.asarray(a) for a in _oracle(*jargs))
    kw = dict(zip(("C", "B", "x", "dt", "csum", "nr"), low))
    for y, st in (cs._plain64(torch, ops, **kw),
                  cs._plain_split(torch, ops, rows=16, **kw),
                  cs._plain_split(torch, ops, tf32=True, **kw)):
        assert y.dtype == st.dtype == torch.float32
        np.testing.assert_allclose(to_numpy(y), y_o, **KERNEL_TOL)
        np.testing.assert_allclose(to_numpy(st), st_o, **KERNEL_TOL)
