"""The port's ragged cache attention against the JAX package.

``repro_torch.kernels.packed_flash.ops.ragged_decode_reference`` (the plain
version the wrapper runs on CPU tensors) is held against the JAX oracle
``ref_ragged_decode``, the Pallas kernel in interpret mode and the
blockwise XLA path, on the same numpy inputs.  The CUDA kernel itself is
held against the same plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed_flash import ops as jax_ops
from repro.kernels.packed_flash import ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels.packed_flash import ops
from repro_torch.kernels.packed_flash import ref as torch_ref
from test_torch_helpers import KERNEL_TOL, to_numpy, to_torch

# name: (blk_q, rep, window, softcap)
CASES = {
    "prefill": (128, 1, 0, 0.0),
    "prefill-gqa-window-softcap": (128, 2, 50, 50.0),
    "decode-gqa": (1, 2, 0, 0.0),
    "decode-window-softcap": (1, 1, 37, 50.0),
}


def _inputs(blk_q, rep, seed=0, hkv=2, dh=32, R=4, S=256):
    """Ragged kv_len with one request at 0, padded rows inside a block and
    a dead block; with blk_q 128 the windows cut the early kv blocks."""
    rng = np.random.default_rng(seed)
    hq = hkv * rep
    k = rng.normal(size=(R, S, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(R, S, hkv, dh)).astype(np.float32)
    kv_len = np.array([250, 130, 0, 77], np.int32)
    if blk_q == 1:
        block_req = np.array([0, 1, -1, 2, 3], np.int32)
        pos = np.array([249, 129, -1, 0, 76], np.int32)
    else:
        block_req = np.array([0, 1, -1, 3], np.int32)
        rows = [np.arange(122, 250), np.arange(2, 130), -np.ones(128),
                np.arange(-51, 77)]
        rows[1][100:] = -1                        # padded rows mid-block
        pos = np.concatenate(rows).astype(np.int32)
        pos[pos < -1] = -1                        # request 3 fills 0..76
    q = rng.normal(size=(len(block_req) * blk_q, hq, dh)).astype(np.float32)
    return q, k, v, block_req, pos, kv_len


def _port(q, k, v, block_req, pos, kv_len, window, softcap):
    return to_numpy(ops.ragged_decode_reference(
        to_torch(q), to_torch(k), to_torch(v), to_torch(block_req),
        to_torch(pos), to_torch(kv_len), window=window, softcap=softcap))


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_oracle(case):
    blk_q, rep, window, softcap = CASES[case]
    q, k, v, block_req, pos, kv_len = _inputs(blk_q, rep)
    nq = len(block_req)
    hq, dh = q.shape[1:]
    want = jax_ref.ref_ragged_decode(
        jnp.asarray(q.reshape(nq, blk_q, hq, dh)), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(block_req), jnp.asarray(kv_len),
        jnp.asarray(pos.reshape(nq, blk_q)), window=window, softcap=softcap)
    got = _port(q, k, v, block_req, pos, kv_len, window, softcap)
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape),
                               **KERNEL_TOL)
    dead = got.reshape(nq, blk_q, hq, dh)[block_req < 0]
    assert (dead == 0).all(), "a dead block writes zeros"


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_kernel_paths(case, impl):
    """Pallas ``ragged_decode_fwd`` in interpret mode and the blockwise
    XLA fallback, through the JAX wrapper with the same signature."""
    blk_q, rep, window, softcap = CASES[case]
    q, k, v, block_req, pos, kv_len = _inputs(blk_q, rep, seed=1)
    want = jax_ops.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(block_req), jnp.asarray(pos), jnp.asarray(kv_len),
        window=window, softcap=softcap, impl=impl)
    got = _port(q, k, v, block_req, pos, kv_len, window, softcap)
    np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("blk_q", [128, 1])
def test_head_dim_256_matches_jax_kernel_paths(blk_q, impl):
    """gemma2-2b's attention shape, cut down: head_dim 256, rep 2 over 2 kv
    heads, a window and softcap 50, on a 256-slot cache."""
    q, k, v, block_req, pos, kv_len = _inputs(blk_q, 2, seed=2, dh=256)
    want = jax_ops.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(block_req), jnp.asarray(pos), jnp.asarray(kv_len),
        window=50, softcap=50.0, impl=impl)
    got = _port(q, k, v, block_req, pos, kv_len, 50, 50.0)
    np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)
    assert 256 in ops.RAGGED_HEAD_DIMS


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("blk_q", [128, 1])
def test_head_dim_192_matches_jax_kernel_paths(blk_q, impl):
    """nemotron-4-340b's head_dim 192, cut down: rep 2 over 2 kv heads, a
    window and softcap 50, on a 256-slot cache."""
    q, k, v, block_req, pos, kv_len = _inputs(blk_q, 2, seed=4, dh=192)
    want = jax_ops.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(block_req), jnp.asarray(pos), jnp.asarray(kv_len),
        window=50, softcap=50.0, impl=impl)
    got = _port(q, k, v, block_req, pos, kv_len, 50, 50.0)
    np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)
    assert 192 in ops.RAGGED_HEAD_DIMS


def _mqa_decode_inputs(seed, S=2304, dh=256):
    """recurrentgemma-9b's local-layer decode step: 16 q heads over one kv
    head of 256, kv lengths past its 2048 window, a dead row."""
    rng = np.random.default_rng(seed)
    R = 3
    k = rng.normal(size=(R, S, 1, dh)).astype(np.float32)
    v = rng.normal(size=(R, S, 1, dh)).astype(np.float32)
    kv_len = np.array([2200, 2049, 700], np.int32)
    block_req = np.array([0, -1, 1, 2], np.int32)
    pos = np.array([2199, -1, 2048, 699], np.int32)
    q = rng.normal(size=(4, 16, dh)).astype(np.float32)
    return q, k, v, block_req, pos, kv_len


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mqa_rep16_window_2048_matches_jax_kernel_paths(impl):
    """All 16 rows of the kernel's decode tile from one request's group:
    rep 16 over 1 kv head, head_dim 256, window 2048, against the TPU
    kernel in interpret mode and the XLA path."""
    q, k, v, block_req, pos, kv_len = _mqa_decode_inputs(5)
    want = jax_ops.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(block_req), jnp.asarray(pos), jnp.asarray(kv_len),
        window=2048, impl=impl)
    got = _port(q, k, v, block_req, pos, kv_len, 2048, 0.0)
    np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)
    assert (got[1] == 0).all(), "a dead row writes zeros"
    # the window binds: slots older than 2048 positions change nothing
    k2, v2 = k.copy(), v.copy()
    k2[0, :152] = 7.0
    v2[0, :152] = -7.0
    got2 = _port(q, k2, v2, block_req, pos, kv_len, 2048, 0.0)
    np.testing.assert_array_equal(got2[0], got[0])


@pytest.mark.parametrize("n_split", [1, 2, 3, 8, 17, 32])
def test_kv_splits_cover_every_live_tile_once_in_order(n_split):
    """The kernel's cut of a CTA's live tiles into split-kv parts: the
    parts are non-empty, at most n_split, contiguous and in order, and
    together cover [t_lo, t_hi) exactly once."""
    for t_lo in range(0, 5):
        for t_hi in range(0, 70):
            parts = ops.kv_split_ranges(t_lo, t_hi, n_split)
            tiles = [t for lo, hi in parts for t in range(lo, hi)]
            assert tiles == list(range(t_lo, max(t_lo, t_hi)))
            assert len(parts) <= n_split
            assert all(lo < hi for lo, hi in parts)


def test_split_plan_and_scratch_sizing():
    """Grid and scratch from shapes: a llama3-8b decode step at batch 4
    (32 CTAs) is cut in 8 parts of the 2048-slot cache, so 256 CTAs, one
    wave at 2 CTAs an SM; its prefill chunk (256 CTAs) is not cut;
    gemma2-2b's (8 q over 4 kv heads of 256, 6144 slots) are cut in 16
    and 4.  Scratch holds (acc, m, l) of every row of every part, and
    nothing when there is one part."""
    plan = ops.ragged_split_plan
    assert plan(4, 1, 32, 8, 2048, 128, 132) == (32, 8, 32 * 8 * 16 * 130)
    assert plan(4, 128, 32, 8, 2048, 128, 132) == (256, 1, 0)
    assert plan(4, 1, 8, 4, 6144, 256, 132) == (16, 16, 16 * 16 * 16 * 258)
    assert plan(4, 128, 8, 4, 6144, 256, 132) == (64, 4, 64 * 4 * 64 * 258)
    # a short cache keeps MIN_SPLIT_TILES tiles a part
    assert plan(1, 1, 4, 1, 256, 64, 132) == (1, 1, 0)
    assert plan(1, 1, 4, 1, 512, 64, 132) == (1, 2, 2 * 16 * 66)
    # rep 32 decode rows take two 16-row tiles; MAX_SPLITS caps the cut
    base, n_split, _ = plan(1, 1, 32, 1, 1 << 16, 128, 132)
    assert (base, n_split) == (2, ops.MAX_SPLITS)
    assert ops.ragged_tiling(1, 256) == (16, 64)
    assert ops.ragged_tiling(128, 256) == (64, 32)
    # head_dim 192: 64-slot tiles both ways, scratch rows of dh + 2;
    # nemotron's decode step (96 q over 8 kv heads, 4 slots of 2048)
    assert ops.ragged_tiling(1, 192) == (16, 64)
    assert ops.ragged_tiling(128, 192) == (64, 64)
    assert plan(4, 1, 96, 8, 2048, 192, 132) == (32, 8, 32 * 8 * 16 * 194)
    assert plan(4, 128, 96, 8, 2048, 192, 132) == (768, 1, 0)
    # recurrentgemma's local decode step: rep 16 fills one 16-row tile
    assert plan(4, 1, 16, 1, 2048, 256, 132) == (4, 8, 4 * 8 * 16 * 258)


def test_kv_len_zero_and_padded_rows_write_zeros():
    q, k, v, block_req, pos, kv_len = _inputs(1, 1)
    got = _port(q, k, v, block_req, pos, kv_len, 0, 0.0)
    assert (got[2] == 0).all()              # dead block
    assert (got[3] == 0).all()              # request 2 has kv_len 0
    assert np.abs(got[[0, 1, 4]]).min() > 0


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k, v, block_req, pos, kv_len = (to_torch(x) for x in _inputs(128, 2))
    a = ops.ragged_decode_attention(q, k, v, block_req, pos, kv_len,
                                    window=50, softcap=50.0)
    b = ops.ragged_decode_reference(q, k, v, block_req, pos, kv_len,
                                    window=50, softcap=50.0)
    assert torch.equal(a, b)


def test_materialised_oracle_matches_plain_version():
    q, k, v, block_req, pos, kv_len = (to_torch(x) for x in _inputs(128, 2))
    nq, hq, dh = len(block_req), q.shape[1], q.shape[2]
    want = torch_ref.ref_ragged_decode(
        q.reshape(nq, 128, hq, dh), k, v, block_req, kv_len,
        pos.reshape(nq, 128), window=50, softcap=50.0)
    got = ops.ragged_decode_reference(q, k, v, block_req, pos, kv_len,
                                      window=50, softcap=50.0)
    torch.testing.assert_close(got, want.reshape(got.shape), **KERNEL_TOL)


def test_cuda_launcher_rejects_cpu_tensors():
    """The kernel entry point takes CUDA tensors only: handed CPU tensors
    it raises instead of running anything else."""
    q, k, v, block_req, pos, kv_len = (to_torch(x) for x in _inputs(1, 1))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ragged_decode_fwd(q.reshape(5, 1, *q.shape[1:]), k, v,
                              block_req, kv_len, pos.reshape(5, 1))


def test_cpu_path_never_builds_the_kernel(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("the CUDA kernel was built on the CPU path")
    monkeypatch.setattr(build, "load", no_build)
    q, k, v, block_req, pos, kv_len = (to_torch(x) for x in _inputs(1, 2))
    before = dict(ops.launches)
    ops.ragged_decode_attention(q, k, v, block_req, pos, kv_len)
    assert ops.launches == before, "the plain version is not a launch"
    assert not build._libs
