"""The port's RG-LRU recurrence (``repro_torch.kernels.rglru``, its plain
versions on CPU tensors) and the RecurrentGemma layer functions around it
against the JAX package: the plain forward against the TPU kernel
``K.lru_scan`` in interpret mode (as ``tests/test_kernels_rglru.py`` runs
it) and the oracle ``ref_lru_scan``; the backward against ``jax.vjp`` of
``repro.kernels.rglru.ops.lru_scan`` (the custom VJP that reruns the
kernel on reversed inputs); reset isolation; ``_rglru_scan`` and
``rglru_apply`` under ``pallas`` and ``xla`` against the reference's.
Inputs from numpy seeds, f32.

Tolerances: h within 1e-5 x max(1, max |h|) (the TPU kernel composes a
tile's rows as a log-depth prefix, the plain version steps one row at a
time: other rounding, growing with |h|); gradients within 1e-4 x max(1,
max |grad|); the layer functions ``MODEL_TOL``."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.rglru import kernel as K
from repro.kernels.rglru import ops as JO
from repro.kernels.rglru import ref as R
from repro.models import layers as JL
from repro.parallel import ParallelContext as JCtx
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels.rglru import ops
from repro_torch.models import layers as TL
from repro_torch.parallel import ParallelContext
from test_torch_helpers import MODEL_TOL, to_numpy, to_torch

RESETS = ("none", "start", "mid-sequence", "everywhere", "near one")


def make(seed, B, S, W, reset="mid-sequence"):
    """a in (0.5, 1) (or as ``reset`` says), b and a cotangent g standard
    normal, numpy f32 [B, S, W]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    g = rng.standard_normal((B, S, W)).astype(np.float32)
    if reset == "start":
        a[:, 0] = 0.0
    elif reset == "mid-sequence":
        a[rng.random((B, S)) < 0.05] = 0.0
    elif reset == "everywhere":
        a[:] = 0.0
    elif reset == "near one":
        a[:] = 0.999
    return a, b, g


def _tol(ref, rel):
    return rel * max(1.0, float(np.abs(ref).max()))


# the card's ring edges that the TPU kernel also takes (S under 256 or a
# multiple of it, W under 128 or a multiple of it), one reset pattern
# each: S under one 64-step stage, one stage minus and plus one, W not a
# multiple of 32, W under 32, B 3; the kernels must equal the plain
# versions bitwise on them (chip_smoke.py's phase 2)
EDGE_SHAPES = ((3, 100, 100), (1, 65, 128), (2, 63, 24), (1, 40, 100))


def _cases(shape):
    """The five reset patterns at ``shape`` (ids: the pattern), then each
    edge shape of EDGE_SHAPES with resets mid-sequence."""
    return [pytest.param(shape, r, id=r) for r in RESETS] + [
        pytest.param(e, "mid-sequence", id="x".join(map(str, e)))
        for e in EDGE_SHAPES]


@pytest.mark.parametrize("shape,reset", _cases((1, 512, 256)))
def test_plain_forward_matches_tpu_kernel(shape, reset):
    """The plain forward against the TPU kernel in interpret mode (S 512:
    two sequence tiles, the carry between them; W 256: two channel tiles;
    then the edge shapes, one tile each) and the oracle."""
    a, b, _ = make(1, *shape, reset)
    got = to_numpy(ops.lru_scan_fwd_reference(to_torch(a), to_torch(b)))
    want = np.asarray(K.lru_scan(jnp.asarray(a), jnp.asarray(b),
                                 interpret=True))
    oracle = np.asarray(R.ref_lru_scan(jnp.asarray(a), jnp.asarray(b)))
    for ref in (want, oracle):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref, 1e-5))


@pytest.mark.parametrize("shape,reset", _cases((2, 256, 128)))
def test_lru_scan_gradients_match_jax_vjp(shape, reset):
    """``lru_scan``'s autograd (the plain backward on CPU tensors) against
    ``jax.vjp`` of the reference's custom-VJP ``lru_scan``."""
    a, b, g = make(2, *shape, reset)
    h_j, vjp = jax.vjp(JO.lru_scan, jnp.asarray(a), jnp.asarray(b))
    da_j, db_j = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    at, bt = to_torch(a).requires_grad_(), to_torch(b).requires_grad_()
    h = ops.lru_scan(at, bt)
    da, db = torch.autograd.grad(h, (at, bt), to_torch(g))
    np.testing.assert_allclose(to_numpy(h), np.asarray(h_j), rtol=0,
                               atol=_tol(h_j, 1e-5))
    for got, want in ((da, da_j), (db, db_j)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                                   atol=_tol(want, 1e-4))


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    """The hand-written reverse recurrence equals autograd through the
    step-by-step forward (the ``xla`` route's gradient): each step is one
    product and one sum either way, so the bits agree."""
    a, b, g = (to_torch(x) for x in make(3, 2, 96, 32, "mid-sequence"))
    at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = ops.lru_scan_fwd_reference(at, bt)
    want = torch.autograd.grad(h, (at, bt), g)
    got = ops.lru_scan_bwd_reference(a, h.detach(), g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_reset_splits_the_sequence_exactly():
    """a = 0 at position k: from k on, h is the scan of the suffix alone,
    bit for bit; before k it is the scan of the prefix alone."""
    a, b, g = make(4, 1, 200, 64, "none")
    k = 77
    a[:, k] = 0.0
    at, bt, gt = (to_torch(x) for x in (a, b, g))
    h = ops.lru_scan_fwd_reference(at, bt)
    assert torch.equal(h[:, k:], ops.lru_scan_fwd_reference(at[:, k:],
                                                            bt[:, k:]))
    assert torch.equal(h[:, :k], ops.lru_scan_fwd_reference(at[:, :k],
                                                            bt[:, :k]))
    # the gradient of the prefix does not see the suffix's cotangent
    da, db = ops.lru_scan_bwd_reference(at, h, gt)
    da_p, db_p = ops.lru_scan_bwd_reference(at[:, :k], h[:, :k], gt[:, :k])
    assert torch.equal(db[:, :k], db_p) and torch.equal(da[:, :k], da_p)


def test_dtypes_follow_the_reference():
    """h comes out in b's dtype; da in a's and db in g's, the sums in f32
    (f64 for f64 inputs)."""
    a, b, g = (to_torch(x) for x in make(5, 1, 64, 16))
    assert ops.lru_scan_fwd_reference(a, b.bfloat16()).dtype == \
        torch.bfloat16
    da, db = ops.lru_scan_bwd_reference(a.double(), b.double(), g)
    assert da.dtype == torch.float64 and db.dtype == torch.float32
    h64 = ops.lru_scan_fwd_reference(a.double(), b.double())
    np.testing.assert_allclose(to_numpy(h64), to_numpy(
        ops.lru_scan_fwd_reference(a, b)), rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels run on CUDA tensors only; ``lru_scan`` takes the plain
    versions for CPU tensors and nothing else."""
    a, b, g = (to_torch(x) for x in make(6, 1, 32, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lru_scan_fwd(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lru_scan_bwd(a, b, g)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.lru_scan(a.to("meta"), b.to("meta"))


def test_chip_smoke_lru_cases_reach_both_variants():
    """``chip_smoke.py``'s phase 2 sends each dtype through both kernels
    of ``lru_scan.cu``: ``lru_variant`` (the C side's rule: inputs whose
    rows are a multiple of 16 bytes at 16-byte aligned addresses take the
    TMA ring) names the ring for the layer shape, the direct variant for
    bf16 rows of 100 values and for inputs one value off alignment, and
    every S of ``EDGE_SHAPES`` is among phase 2's shapes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for dtype in (torch.float32, torch.bfloat16):
        off = torch.empty(257, dtype=dtype)[1:].view(1, 1, 256)
        assert off.is_contiguous() and cs.lru_variant(off) == "direct"
        seen = {cs.lru_variant(torch.empty((1, 1, w), dtype=dtype))
                for _, _, w in cs.LRU_SHAPES}
        assert seen | {cs.lru_variant(off)} == {"ring", "direct"}, dtype
        assert cs.lru_variant(torch.empty((1, 1, 4096), dtype=dtype)) == \
            "ring"
    assert cs.lru_variant(torch.empty((1, 1, 100))) == "ring"
    assert cs.lru_variant(torch.empty((1, 1, 100),
                                      dtype=torch.bfloat16)) == "direct"
    assert {s for _, s, _ in EDGE_SHAPES} <= {s for _, s, _ in cs.LRU_SHAPES}


def test_clip_gradient_is_jax_clip():
    """``_clip01``: jnp.clip's value and gradient, 1/2 at a bound."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(
        jnp.asarray(x)))
    xt = to_torch(x).requires_grad_()
    y = TL._clip01(xt)
    (got,) = torch.autograd.grad(y.sum(), xt)
    np.testing.assert_array_equal(to_numpy(y), np.clip(x, 0.0, 1.0))
    np.testing.assert_array_equal(to_numpy(got), want)


def _scan_inputs(seed, W=128, S=128):
    cfg_j = jax_config("recurrentgemma-9b-reduced")
    cfg_j = dataclasses.replace(cfg_j, rglru=dataclasses.replace(
        cfg_j.rglru, lru_width=W))
    p = JL.rglru_init(jax.random.PRNGKey(seed), cfg_j)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, W)).astype(np.float32)
    first = np.zeros((2, S), bool)
    first[:, 0] = True
    first[1, [30, 64]] = True
    return p, x, first


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_rglru_scan_matches_reference(impl):
    """``_rglru_scan`` (gates, resets at document starts, the scan) and its
    gradients in x and the gate weights, against the reference's under the
    same impl (its ``pallas`` route: the TPU kernel in interpret mode and
    its custom VJP)."""
    p, x, first = _scan_inputs(7)
    keys = ("w_rec_gate", "w_input_gate", "lru_a")

    def jfn(xx, *ws):
        pp = dict(p, **dict(zip(keys, ws)))
        return JL._rglru_scan(pp, xx, jnp.asarray(first),
                              ctx=JCtx(attn_impl=impl))
    rng = np.random.default_rng(8)
    g = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(jfn, jnp.asarray(x), *(p[k] for k in keys))
    grads_j = vjp(jnp.asarray(g))
    xt = to_torch(x).requires_grad_()
    wt = [to_torch(p[k]).requires_grad_() for k in keys]
    got = TL._rglru_scan(dict(zip(keys, wt)), xt, to_torch(first),
                         ctx=ParallelContext(attn_impl=impl))
    grads_t = torch.autograd.grad(got, [xt, *wt], to_torch(g))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)
    for name, gt, gj in zip(("x",) + keys, grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(to_numpy(gt), gj, rtol=1e-4,
                                   atol=_tol(gj, 1e-5), err_msg=name)


def test_rglru_scan_routes(monkeypatch):
    """Under ``pallas`` with W and S multiples of 128 the recurrence goes
    through ``lru_scan`` (and the hook sees its f32 a and bterm); with S
    96 it takes the plain route, as the reference's condition says; both
    give the same h."""
    calls, seen = [], []
    real = TL.rglru_ops.lru_scan

    def spy(a, b):
        calls.append((tuple(a.shape), a.dtype, b.dtype))
        return real(a, b)
    monkeypatch.setattr(TL.rglru_ops, "lru_scan", spy)
    p, x, first = _scan_inputs(9)
    pt = {k: to_torch(v) for k, v in p.items()}
    xt, ft = to_torch(x), to_torch(first)
    pallas = ParallelContext(attn_impl="pallas")
    h_k = TL._rglru_scan(pt, xt, ft, ctx=pallas, hook=seen.append)
    h_x = TL._rglru_scan(pt, xt, ft, ctx=ParallelContext(attn_impl="xla"))
    assert calls == [((2, 128, 128), torch.float32, torch.float32)]
    assert sorted(seen[0]) == ["a", "bterm"]
    assert torch.equal(h_k, h_x)
    TL._rglru_scan(pt, xt[:, :96], ft[:, :96], ctx=pallas)
    assert len(calls) == 1


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_rglru_apply_matches_reference(impl):
    """The whole RG-LRU mixer on recurrentgemma-9b-reduced widths (the gelu
    branch, the document-gated causal conv, the gates, the scan, w_out),
    two documents in the second row."""
    cfg_j = jax_config("recurrentgemma-9b-reduced")
    cfg_t = torch_config("recurrentgemma-9b-reduced")
    p = JL.rglru_init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 128, cfg_j.d_model)).astype(np.float32)
    seg = np.ones((2, 128), np.int32)
    seg[1, 70:] = 2
    want = JL.rglru_apply(p, jnp.asarray(h),
                          {"segment_ids": jnp.asarray(seg)}, cfg_j,
                          JCtx(attn_impl=impl))
    got = TL.rglru_apply({k: to_torch(v) for k, v in p.items()},
                         to_torch(h), {"segment_ids": to_torch(seg)}, cfg_t,
                         ParallelContext(attn_impl=impl))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


def test_rglru_init_layout_matches_reference():
    """Names, shapes and the lru_a initialisation of ``rglru_init``."""
    cfg_j = jax_config("recurrentgemma-9b-reduced")
    cfg_t = torch_config("recurrentgemma-9b-reduced")
    want = JL.rglru_init(jax.random.PRNGKey(0), cfg_j)
    got = TL.rglru_init(torch.Generator().manual_seed(0), cfg_t)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    np.testing.assert_allclose(to_numpy(got["lru_a"]),
                               np.asarray(want["lru_a"]), rtol=1e-6)
