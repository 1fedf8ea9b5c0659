"""The port's attention-server batch (``ca_server_attention`` and its plain
versions in ``repro_torch.kernels.packed_flash.ops``) against the JAX
package: the TPU kernels ``ca_server_fwd``/``ca_server_bwd`` in interpret
mode, the blockwise ``dispatch._xla_server`` path and ``jax.vjp`` of the
materialised oracle, on the same numpy inputs.  f32 tolerances: 1e-5 on
out and lse, 1e-4 on the gradients (the two sides sum the same terms in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro.core.mask import spec_from_params
from repro.kernels.packed_flash import kernel as JK
from repro.kernels.packed_flash import ref as JR
from repro_torch.kernels import build
from repro_torch.kernels.packed_flash import ops
from test_torch_helpers import to_numpy, to_torch

OUT_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# name -> (T, blk, Hq, Hkv, dh, N, mask/softcap options, jmax rule)
CASES = {
    "gqa4/2": (4, 64, 4, 2, 64, 8, {}, None),
    "gqa8/1": (4, 64, 8, 1, 32, 8, {}, None),
    "mha": (4, 64, 2, 2, 32, 6, {}, None),
    "window": (4, 64, 4, 2, 32, 8, {"window": 48}, None),
    "window+sink": (4, 64, 4, 2, 32, 8, {"window": 40, "sink": 8}, None),
    "dilated": (4, 64, 4, 2, 32, 8, {"rate": 2}, None),
    "softcap": (4, 64, 4, 2, 32, 8, {"softcap": 5.0}, None),
    "jmax": (4, 64, 4, 2, 32, 8, {}, "max_len"),
    # nemotron's head_dim and gemma2's (with its attention softcap), which
    # the CUDA kernels take since the tensor-core redesign
    "dh192": (3, 64, 2, 1, 192, 4, {}, None),
    "dh256+softcap": (3, 64, 4, 2, 256, 4, {"softcap": 50.0}, None),
}
# the interpret-mode TPU kernels take seconds per grid of this size, so
# they run on a smaller batch
SMALL = {
    "gqa2/1+window+sink+softcap": (3, 64, 2, 1, 32, 4,
                                   {"window": 40, "sink": 8,
                                    "softcap": 5.0}, None),
    "dilated+jmax": (3, 64, 2, 1, 32, 4, {"rate": 2}, "max_len"),
    "dh192": (2, 64, 2, 1, 192, 3, {}, None),
    "dh256+softcap": (2, 64, 2, 1, 256, 3, {"softcap": 50.0}, None),
}


def make_server_batch(T, blk, hq, hkv, dh, N, seed=0):
    """A ragged CA-task batch: each task a q block against a random kv
    range holding its document prefix (overlapping ranges), the last task
    zero-length with padded rows, and a padded tail in one kv block."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, blk, hq, dh)).astype(np.float32)
    k = rng.standard_normal((N, blk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((N, blk, hkv, dh)).astype(np.float32)
    kv_start = np.zeros(T, np.int32)
    kv_len = np.zeros(T, np.int32)
    q_pos = np.zeros((T, blk), np.int32)
    kv_pos = np.tile(np.arange(blk, dtype=np.int32), (N, 1))
    for t in range(T):
        ln = int(rng.integers(1, min(N, 4) + 1))
        st = int(rng.integers(0, N - ln + 1))
        kv_start[t], kv_len[t] = st, ln
        q_pos[t] = np.arange((ln - 1) * blk, ln * blk)
        for jj in range(ln):
            kv_pos[st + jj] = np.arange(jj * blk, (jj + 1) * blk)
    kv_len[-1] = 0
    q_pos[-1] = -1
    q_pos[0, blk // 2:] = -1              # padded rows in a live task
    return q, k, v, kv_start, kv_len, q_pos, kv_pos


def _case(spec, seed=0):
    T, blk, hq, hkv, dh, N, opts, jrule = spec
    arrays = make_server_batch(T, blk, hq, hkv, dh, N, seed=seed)
    jmax = int(arrays[4].max()) if jrule == "max_len" else 0
    kw = {"window": 0, "sink": 0, "rate": 1, "softcap": 0.0, **opts}
    return arrays, jmax, kw


def _torch_args(arrays, dtype=torch.float32):
    q, k, v, st, ln, qp, kp = arrays
    return ([to_torch(x, dtype) for x in (q, k, v)]
            + [to_torch(x) for x in (st, ln, qp, kp)])


def _assert_close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


def _jax_xla_fwd(arrays, jmax, kw):
    fwd = jax.jit(lambda *a: JD._xla_server_fwd_impl(
        *a, jmax or arrays[1].shape[0], kw["softcap"], kw["window"], None,
        kw["sink"], kw["rate"]))
    return fwd(*(jnp.asarray(x) for x in arrays))


def _grads_cotangent(arrays, seed=1):
    T, blk, hq, dh = arrays[0].shape
    return np.random.default_rng(seed).standard_normal(
        (T, blk, hq, dh)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_fwd_matches_xla_server(case):
    arrays, jmax, kw = _case(CASES[case])
    out, lse = ops.ca_server_fwd_reference(*_torch_args(arrays), jmax=jmax,
                                           **kw)
    want_out, want_lse = _jax_xla_fwd(arrays, jmax, kw)
    _assert_close(out, want_out, OUT_TOL)
    _assert_close(lse, want_lse, OUT_TOL)


@pytest.mark.parametrize("case", list(SMALL))
def test_plain_fwd_matches_interpret_kernel(case):
    arrays, jmax, kw = _case(SMALL[case])
    out, lse = ops.ca_server_fwd_reference(*_torch_args(arrays), jmax=jmax,
                                           **kw)
    want_out, want_lse = JK.ca_server_fwd(
        *(jnp.asarray(x) for x in arrays), jmax=jmax or None,
        interpret=True, return_lse=True, **kw)
    _assert_close(out, want_out, OUT_TOL)
    _assert_close(lse, want_lse, OUT_TOL)


def _jax_vjp(arrays, jmax, kw, g):
    """jax.vjp through the materialised oracle (the whole buffer), or
    through the blockwise server when jmax cuts a task's range."""
    q, k, v, st, ln, qp, kp = (jnp.asarray(x) for x in arrays)
    if jmax:
        def f(q_, k_, v_):
            return JD._xla_server(q_, k_, v_, st, ln, qp, kp, jmax,
                                  kw["softcap"], kw["window"], None,
                                  kw["sink"], kw["rate"])
    else:
        spec = spec_from_params(kw["window"], kw["sink"], kw["rate"])
        w = 0 if (spec is not None and spec.kind == "sliding") \
            else kw["window"]

        def f(q_, k_, v_):
            return JR.ref_ca_server_attention(
                q_, k_, v_, st, ln, qp, kp, softcap=kw["softcap"],
                window=w, mask=spec)
    @jax.jit
    def vjp(q_, k_, v_, g_):
        return jax.vjp(f, q_, k_, v_)[1](g_)
    return vjp(q, k, v, jnp.asarray(g))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_jax_vjp(case):
    arrays, jmax, kw = _case(CASES[case], seed=2)
    args = _torch_args(arrays)
    out, lse = ops.ca_server_fwd_reference(*args, jmax=jmax, **kw)
    g = _grads_cotangent(arrays)
    got = ops.ca_server_bwd_reference(*args[:3], out, lse, to_torch(g),
                                      *args[3:], jmax=jmax, **kw)
    for a, b in zip(got, _jax_vjp(arrays, jmax, kw, g)):
        _assert_close(a, b, GRAD_TOL)


@pytest.mark.parametrize("case", list(SMALL))
def test_plain_bwd_matches_interpret_kernel(case):
    arrays, jmax, kw = _case(SMALL[case], seed=3)
    args = _torch_args(arrays)
    g = _grads_cotangent(arrays)
    out, lse = ops.ca_server_fwd_reference(*args, jmax=jmax, **kw)
    got = ops.ca_server_bwd_reference(*args[:3], out, lse, to_torch(g),
                                      *args[3:], jmax=jmax, **kw)
    q, k, v, st, ln, qp, kp = (jnp.asarray(x) for x in arrays)
    j_out, j_lse = JK.ca_server_fwd(q, k, v, st, ln, qp, kp,
                                    jmax=jmax or None, interpret=True,
                                    return_lse=True, **kw)
    want = JK.ca_server_bwd(q, k, v, j_out, j_lse, jnp.asarray(g), st, ln,
                            qp, kp, jmax=jmax or None, interpret=True,
                            **kw)
    for a, b in zip(got, want):
        _assert_close(a, b, GRAD_TOL)


@pytest.mark.parametrize("case", ["gqa4/2", "window+sink", "dilated",
                                  "softcap", "jmax"])
def test_plain_bwd_equals_autograd_f64(case):
    """The hand-written backward is the derivative of the plain forward:
    autograd through ``ca_server_fwd_reference`` in f64 gives the same
    gradients."""
    arrays, jmax, kw = _case(CASES[case], seed=4)
    args = _torch_args(arrays, torch.float64)
    q, k, v = (x.requires_grad_() for x in args[:3])
    out, lse = ops.ca_server_fwd_reference(q, k, v, *args[3:], jmax=jmax,
                                           **kw)
    g = to_torch(_grads_cotangent(arrays), torch.float64)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = ops.ca_server_bwd_reference(q.detach(), k.detach(), v.detach(),
                                      out.detach(), lse.detach(), g,
                                      *args[3:], jmax=jmax, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-9, rtol=1e-9)


def test_dead_rows_and_empty_tasks():
    arrays, _, kw = _case(CASES["gqa4/2"])
    out, lse = ops.ca_server_fwd_reference(*_torch_args(arrays), **kw)
    assert bool((out[-1] == 0).all()) and bool((lse[-1] == ops.LSE_DEAD)
                                                .all())
    assert bool((out[0, 32:] == 0).all())
    assert bool((lse[0, :, 32:] == ops.LSE_DEAD).all())


def test_autograd_function_on_cpu_runs_the_plain_versions():
    arrays, jmax, kw = _case(CASES["window+sink"], seed=5)
    args = _torch_args(arrays)
    q, k, v = (x.clone().requires_grad_() for x in args[:3])
    out = ops.ca_server_attention(q, k, v, *args[3:], jmax=jmax, **kw)
    g = to_torch(_grads_cotangent(arrays))
    got = torch.autograd.grad(out, (q, k, v), g)
    want_out, lse = ops.ca_server_fwd_reference(*args, jmax=jmax, **kw)
    want = ops.ca_server_bwd_reference(*args[:3], want_out, lse, g,
                                       *args[3:], jmax=jmax, **kw)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_launchers_reject_cpu_tensors():
    """The kernel entry points take CUDA tensors only: handed CPU tensors
    they raise instead of running anything else."""
    arrays, _, _ = _case(CASES["gqa4/2"])
    args = _torch_args(arrays)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ca_server_fwd(*args)
    out, lse = ops.ca_server_fwd_reference(*args)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ca_server_bwd(*args[:3], out, lse, torch.ones_like(out),
                          *args[3:])


def test_cpu_path_never_builds_the_kernels(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CUDA kernel was built on the CPU path")
    monkeypatch.setattr(build, "load", no_build)
    arrays, _, _ = _case(CASES["gqa4/2"])
    args = _torch_args(arrays)
    q = args[0].clone().requires_grad_()
    before = dict(ops.launches)
    ops.ca_server_attention(q, *args[1:]).sum().backward()
    assert ops.launches == before, "the plain versions are not launches"
    assert not build._libs
