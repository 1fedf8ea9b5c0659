"""The port's packed-flash attention (``repro_torch.kernels.packed_flash``:
``flash_fwd_reference``, ``flash_bwd_reference``, the autograd Function
``packed_flash_attention``) and its blockwise ``xla_flash_attention``
against the JAX package on the CPU, on the same numpy inputs:

* the plain versions against the TPU kernels ``K.flash_fwd`` /
  ``K.flash_bwd`` in interpret mode (out, lse, dq, dk, dv; f32, atol
  2e-5) over every mask family, softcap, GQA 1 and 2, padding rows and
  blocks 64 and 128, chunk-order block pruning included;
* ``packed_flash_attention``'s autograd gradients against ``jax.vjp`` of
  ``O.packed_flash_attention``;
* ``xla_flash_attention`` forward and gradients against JAX's, with a
  sequence that is no multiple of the block and ``skip_masked_blocks`` on
  and off;
* ``flash_tile_ranges``, the bf16 kernels' document prune, against the
  dense mask: every visible pair lies inside its tiles' ranges;
  ``flash_dkv_split``'s head split of the dk/dv grid.

The CUDA kernels themselves run only on the card (``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.kernels.packed_flash import kernel as K
from repro.kernels.packed_flash import ops as O
from repro_torch.core import attention as TA
from repro_torch.kernels.packed_flash import ops
from test_torch_helpers import KERNEL_TOL, to_numpy, to_torch

B = 2


def make_packed(seed, s, hq, hkv, dh, n_docs=3, pad=10):
    """Random document boundaries per row (not block-aligned), in-document
    positions, the last ``pad`` tokens of each row padding (segment 0)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, s), np.int32)
    pos = np.zeros((B, s), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, s - pad), size=n_docs - 1,
                                  replace=False))
        bounds = np.concatenate([[0], cuts, [s - pad]])
        for d in range(n_docs):
            lo, hi = bounds[d], bounds[d + 1]
            seg[b, lo:hi] = d + 1
            pos[b, lo:hi] = np.arange(hi - lo)
    q, do = (rng.standard_normal((B, s, hq, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do, seg, pos


# (mask options, blk, GQA rep, dh)
CASES = {
    "causal-blk128-gqa2": (dict(), 128, 2, 32),
    "causal-blk64-mha": (dict(), 64, 1, 64),
    "noncausal-blk128-gqa2": (dict(causal=False), 128, 2, 32),
    "window-blk64-gqa2": (dict(window=48), 64, 2, 32),
    "window-sink-blk128": (dict(window=48, sink=8), 128, 1, 32),
    "dilated-blk64-gqa2": (dict(rate=2), 64, 2, 32),
    "dilated-noncausal-blk128": (dict(rate=2, causal=False), 128, 1, 32),
    "softcap-blk128-gqa2": (dict(softcap=5.0), 128, 2, 64),
    "softcap-window-blk64": (dict(softcap=5.0, window=48), 64, 1, 32),
    "causal-blk128-gqa2-dh192": (dict(), 128, 2, 192),
    "window-sink-softcap-blk64-dh192": (dict(window=48, sink=8, softcap=5.0),
                                        64, 1, 192),
}


def _jax_flash(q, k, v, do, seg, pos, kw, blk):
    arr = [jnp.asarray(x) for x in (q, k, v, seg, pos, seg, pos)]
    out, lse = K.flash_fwd(*arr, blk_q=blk, blk_k=blk, return_lse=True,
                           **kw)
    grads = K.flash_bwd(*arr[:3], out, lse, jnp.asarray(do), *arr[3:],
                        blk_q=blk, blk_k=blk, **kw)
    return out, lse, grads


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_tpu_kernels(case):
    kw, blk, rep, dh = CASES[case]
    q, k, v, do, seg, pos = make_packed(len(case), 256, 2 * rep, 2, dh)
    out_j, lse_j, grads_j = _jax_flash(q, k, v, do, seg, pos, kw, blk)
    t = [to_torch(x) for x in (q, k, v, seg, pos, seg, pos)]
    out, lse = ops.flash_fwd_reference(*t, blk_q=blk, blk_k=blk, **kw)
    np.testing.assert_allclose(to_numpy(out), np.asarray(out_j),
                               **KERNEL_TOL)
    np.testing.assert_allclose(to_numpy(lse), np.asarray(lse_j),
                               **KERNEL_TOL)
    # padding rows are dead: out 0, lse LSE_DEAD
    dead = torch.from_numpy(seg == 0)
    assert bool((out[dead] == 0).all())
    assert bool((lse.transpose(1, 2)[dead] == ops.LSE_DEAD).all())
    # the backward from the TPU kernel's own (out, lse), as it runs
    grads = ops.flash_bwd_reference(*t[:3], to_torch(out_j), to_torch(lse_j),
                                    to_torch(do), *t[3:], blk_q=blk,
                                    blk_k=blk, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   err_msg=name, **KERNEL_TOL)


@pytest.mark.parametrize("kw,pruned", [(dict(), False),
                                       (dict(rate=2), True)])
def test_block_prune_is_the_tpu_kernels(kw, pruned):
    """Causal chunk-order pruning drops no pair of packed documents; the
    dilated prune ``(i - j) % rate`` on chunk blocks does drop pairs of
    documents that are not block-aligned, which the token mask alone
    keeps.  The plain version reproduces the TPU kernel there (held
    against it above), so it departs from the unpruned oracle."""
    q, k, v, _, seg, pos = make_packed(7, 256, 2, 2, 32)
    t = [to_torch(x) for x in (q, k, v, seg, pos, seg, pos)]
    out, _ = ops.flash_fwd_reference(*t, blk_q=64, blk_k=64, **kw)
    oracle = TA.ref_attention(*t, blk=64, **kw)
    diff = float((out - oracle).abs().max())
    assert (diff > 1e-3) if pruned else (diff < 1e-5), diff


GRAD_CASES = {"causal-softcap-gqa2": (dict(softcap=5.0), 2),
              "window-sink": (dict(window=48, sink=8), 1),
              "dilated-gqa2": (dict(rate=2), 2)}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_packed_flash_attention_grads_match_jax_vjp(case):
    kw, rep = GRAD_CASES[case]
    q, k, v, do, seg, pos = make_packed(len(case), 256, 2 * rep, 2, 32)
    j_ids = [jnp.asarray(x) for x in (seg, pos, seg, pos)]
    out_j, vjp = jax.vjp(
        lambda a, b_, c: O.packed_flash_attention(a, b_, c, *j_ids, **kw),
        *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    qkv = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = ops.packed_flash_attention(
        *qkv, *(to_torch(x) for x in (seg, pos, seg, pos)), **kw)
    grads = torch.autograd.grad(out, qkv, to_torch(do))
    np.testing.assert_allclose(to_numpy(out), np.asarray(out_j),
                               **KERNEL_TOL)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   err_msg="d" + name, **KERNEL_TOL)


XLA_CASES = {
    "causal-skip-gqa2": (dict(), 2),
    "causal-noskip": (dict(skip_masked_blocks=False), 1),
    "noncausal-gqa2": (dict(causal=False), 2),
    "window-softcap": (dict(window=40, softcap=5.0), 1),
    "window-sink-gqa2": (dict(window=40, sink=8), 2),
    "dilated-blk32": (dict(rate=2, blk=32), 1),
}


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_xla_flash_attention_matches_reference(case):
    """S = 200 is no multiple of the 64-token blocks: both pad to 256."""
    kw, rep = XLA_CASES[case]
    kw = dict(kw, q_block=64, kv_block=64)
    q, k, v, do, seg, pos = make_packed(len(case), 200, 2 * rep, 2, 16)
    j_ids = [jnp.asarray(x) for x in (seg, pos, seg, pos)]
    out_j, vjp = jax.vjp(
        lambda a, b_, c: JA.xla_flash_attention(a, b_, c, *j_ids, **kw),
        *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    qkv = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = TA.xla_flash_attention(
        *qkv, *(to_torch(x) for x in (seg, pos, seg, pos)), **kw)
    grads = torch.autograd.grad(out, qkv, to_torch(do))
    np.testing.assert_allclose(to_numpy(out), np.asarray(out_j),
                               **KERNEL_TOL)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   err_msg="d" + name, **KERNEL_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(window=64)],
                         ids=["causal", "window64"])
def test_head_dim_256_mqa_matches_tpu_kernels(kw):
    """recurrentgemma's local layers: head_dim 256, 16 q heads over 1 kv
    head, blocks of 128.  The plain forward against the TPU kernel in
    interpret mode, and ``packed_flash_attention``'s gradients (the plain
    backward, which sums dk/dv over the 16 heads) against ``jax.vjp`` of
    the reference's (``K.flash_bwd``)."""
    q, k, v, do, seg, pos = make_packed(11, 256, 16, 1, 256)
    out_j, lse_j, _ = _jax_flash(q, k, v, do, seg, pos, kw, 128)
    t = [to_torch(x) for x in (q, k, v, seg, pos, seg, pos)]
    out, lse = ops.flash_fwd_reference(*t, **kw)
    np.testing.assert_allclose(to_numpy(out), np.asarray(out_j),
                               **KERNEL_TOL)
    np.testing.assert_allclose(to_numpy(lse), np.asarray(lse_j),
                               **KERNEL_TOL)
    j_ids = [jnp.asarray(x) for x in (seg, pos, seg, pos)]
    _, vjp = jax.vjp(
        lambda a, b_, c: O.packed_flash_attention(a, b_, c, *j_ids, **kw),
        *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    qkv = [to_torch(x).requires_grad_() for x in (q, k, v)]
    got = ops.packed_flash_attention(*qkv, *t[3:], **kw)
    grads = torch.autograd.grad(got, qkv, to_torch(do))
    for name, g, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(to_numpy(g), np.asarray(want),
                                   err_msg="d" + name, **KERNEL_TOL)
    assert 256 in ops.FLASH_HEAD_DIMS \
        and ops.CA_HEAD_DIMS == ops.FLASH_HEAD_DIMS


def test_kernel_wrappers_take_cuda_tensors_only():
    q, k, v, do, seg, pos = make_packed(0, 128, 2, 2, 64)
    t = [to_torch(x) for x in (q, k, v, seg, pos, seg, pos)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_fwd(*t)
    out, lse = ops.flash_fwd_reference(*t)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_bwd(*t[:3], out, lse, to_torch(do), *t[3:])
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.packed_flash_attention(*meta)


RANGE_MASKS = {"causal": dict(), "non-causal": dict(causal=False),
               "window": dict(window=48), "window+sink": dict(window=48,
                                                              sink=8),
               "dilated": dict(rate=2)}


@pytest.mark.parametrize("mask", list(RANGE_MASKS))
def test_flash_tile_ranges_cover_every_visible_pair(mask):
    """Over random packed layouts (documents shorter and longer than a
    tile, padding), every pair the dense token mask allows lies in a
    (q tile, kv tile) pair inside both ranges; and the prune drops tiles
    wherever a row holds more than one document."""
    kw = RANGE_MASKS[mask]
    tile, s = ops.FLASH_TILE, 512
    for seed in range(6):
        _, _, _, _, seg, pos = make_packed(seed, s, 1, 1, 8,
                                           n_docs=2 + 3 * seed, pad=seed * 7)
        seg, pos = torch.from_numpy(seg), torch.from_numpy(pos)
        kv_range, q_range = ops.flash_tile_ranges(
            seg, pos, seg, pos, causal=kw.get("causal", True),
            window=kw.get("window", 0), sink=kw.get("sink", 0))
        dense = TA.mask_fn(seg, pos, seg, pos, causal=kw.get("causal", True),
                           window=kw.get("window", 0), sink=kw.get("sink", 0),
                           rate=kw.get("rate", 1), blk=128)
        n = s // tile
        need = dense.reshape(B, n, tile, n, tile).any(4).any(2)
        idx = torch.arange(n)
        in_kv = (kv_range[..., :1] <= idx) & (idx < kv_range[..., 1:])
        in_q = (q_range[..., :1] <= idx) & (idx < q_range[..., 1:])
        assert bool((in_kv | ~need).all()), (seed, kv_range)
        assert bool((in_q | ~need.transpose(1, 2)).all()), (seed, q_range)
        assert int(in_kv.sum()) < B * n * n, seed


def test_flash_dkv_split_cuts_small_grids_only():
    """llama3-8b's colocated step (4 x 4096, 8 kv heads, rep 4) has 2048
    dk/dv CTAs: no split.  recurrentgemma's MQA (2 x 4096, 1 kv head, rep
    16, head_dim 256) has 256 CTAs of 32 kv rows: its heads are cut in 4
    parts of 4, with f32 partial dk and dv for each."""
    assert ops.flash_dkv_split(4, 4096, 8, 4, 128, 132) == (2048, 1, 0)
    base, n_split, scratch = ops.flash_dkv_split(2, 4096, 1, 16, 256, 132)
    assert (base, n_split) == (256, 4)
    assert scratch == base * n_split * 2 * 32 * 256
    for rep in (1, 3, 6, 16):
        _, n_split, _ = ops.flash_dkv_split(1, 64, 1, rep, 64, 132)
        assert rep % n_split == 0
