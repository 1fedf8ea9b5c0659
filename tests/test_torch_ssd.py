"""The port's SSD intra-chunk step (``repro_torch.kernels.ssd``, its plain
versions on CPU tensors) and the Mamba-2 layer functions around it against
the JAX package: the forward against the TPU kernel ``K.ssd_chunk`` in
interpret mode (as ``tests/test_kernels_ssd.py`` runs it) and the oracle
``ref_ssd_chunk``; G-sized against H-sized B and C; the hand-written
backward against ``jax.vjp`` of the oracle (the TPU kernel has none);
``_ssd_chunked`` under ``pallas`` and ``xla`` and ``ssd_apply`` against the
reference's.  Inputs from numpy seeds, f32.

Tolerances: ``KERNEL_TOL`` (atol 2e-5, rtol 1e-5) on y and states, whose
sums run in another order in each framework; gradients rtol 1e-4 with an
atol of 1e-5 x max |grad| (a gradient sums up to two chunks' worth of
products, so its rounding scales with its largest entry); the layer
functions ``MODEL_TOL``."""
import dataclasses

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
    got = TL._causal_conv(*(to_torch(a) for a in (x, w, b)),
                          first=to_torch(first))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)
    # row 1 from position 5 on equals the conv of that document alone (to
    # rounding: silu's vectorised and scalar paths may differ in the last
    # bit)
    alone = TL._causal_conv(to_torch(x[1:, 5:]), to_torch(w), to_torch(b),
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
