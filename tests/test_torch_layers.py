"""The port's layers (``repro_torch.models.layers``) against
``repro.models.layers`` on the same numpy inputs and weights."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.parallel import ParallelContext
from repro_torch.configs import get_config as torch_config
from repro_torch.models import layers as TL
from test_torch_helpers import MODEL_TOL, to_numpy, to_torch

CTX = ParallelContext(attn_impl="ref", remat=False)


def _configs(arch, **overrides):
    return (dataclasses.replace(jax_config(arch).reduced(), **overrides),
            dataclasses.replace(torch_config(arch).reduced(), **overrides))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    want = JL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = TL.norm_apply({k: to_torch(v) for k, v in p.items()},
                        to_torch(x), kind)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 2048, size=(2, 7)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(to_torch(x), to_torch(pos), theta)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


def test_sinusoidal_pos():
    pos = np.arange(0, 300, 7, dtype=np.int32)[None]
    want = JL.sinusoidal_pos(jnp.asarray(pos), 64, jnp.float32)
    got = TL.sinusoidal_pos(to_torch(pos), 64, to_torch(pos).float().dtype)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("arch,n_kv", [("llama3-8b", None),
                                       ("llama3-8b", 2),
                                       ("gemma2-2b", None)])
def test_qkv_proj(arch, n_kv):
    cfg_j, cfg_t = _configs(arch, **({"n_kv_heads": n_kv} if n_kv else {}))
    rng = np.random.default_rng(2)
    d, dh = cfg_j.d_model, cfg_j.head_dim
    w = {"wq": (d, cfg_j.n_heads * dh), "wk": (d, cfg_j.n_kv_heads * dh),
         "wv": (d, cfg_j.n_kv_heads * dh)}
    p = {k: rng.normal(size=s).astype(np.float32) * d ** -0.5
         for k, s in w.items()}
    h = rng.normal(size=(1, 9, d)).astype(np.float32)
    pos = np.array([[0, 1, 2, 50, 51, 200, 201, 202, 203]], np.int32)
    want = JL.qkv_proj({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(h), cfg_j, jnp.asarray(pos))
    got = TL.qkv_proj({k: to_torch(v) for k, v in p.items()}, to_torch(h),
                      cfg_t, to_torch(pos))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w_), **MODEL_TOL)


@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", True),
                                              ("gelu", False),
                                              ("relu2", False)])
def test_ffn_apply(activation, gated):
    cfg_j, cfg_t = _configs("smollm-360m", activation=activation,
                            gated_mlp=gated)
    rng = np.random.default_rng(3)
    d, f = cfg_j.d_model, cfg_j.d_ff
    names = (("w_gate", (d, f)),) if gated else ()
    names += (("w_up", (d, f)), ("w_down", (f, d)))
    p = {k: rng.normal(size=s).astype(np.float32) * s[0] ** -0.5
         for k, s in names}
    h = rng.normal(size=(1, 6, d)).astype(np.float32)
    want = JL.ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(h), cfg_j, CTX)
    got = TL.ffn_apply({k: to_torch(v) for k, v in p.items()}, to_torch(h),
                       cfg_t)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


def test_dense_init_scale_and_dtype():
    import torch
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, 256, (256, 512), torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(float(w.float().std()) - 256 ** -0.5) < 2e-3


# ----------------------------------------------------- recurrent decoding
def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.mark.parametrize("steps", [1, 5])
def test_causal_conv_with_state(steps):
    """The decode form of the depthwise conv: the previous W-1 inputs as
    state in, the last W-1 out, over one token and over five."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, steps, 8)).astype(np.float32)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    state = rng.normal(size=(2, 3, 8)).astype(np.float32)
    want_y, want_s = JL._causal_conv(*(jnp.asarray(a)
                                       for a in (x, w, b, state)))
    got_y, got_s = TL._causal_conv(*(to_torch(a) for a in (x, w, b, state)))
    np.testing.assert_allclose(to_numpy(got_y), np.asarray(want_y),
                               **MODEL_TOL)
    np.testing.assert_array_equal(to_numpy(got_s), np.asarray(want_s))


def test_ssd_decode_matches_reference():
    """Three one-token SSD steps from a random conv window and f32 state
    (mamba2-370m-reduced, 16 heads over one B/C group): out, conv state and
    SSM state each step."""
    import jax
    cfg_j, cfg_t = _configs("mamba2-370m")
    p = JL.ssd_init(jax.random.PRNGKey(1), cfg_j)
    pt = _tree(p, lambda v: to_torch(np.asarray(v)))
    s = cfg_j.ssm
    d_in = s.expand * cfg_j.d_model
    rng = np.random.default_rng(5)
    conv = rng.normal(size=(3, s.conv_width - 1,
                            d_in + 2 * s.n_groups * s.d_state))
    state = rng.normal(size=(3, d_in // s.head_dim, s.d_state, s.head_dim))
    conv_j, state_j = jnp.asarray(conv, jnp.float32), jnp.asarray(
        state, jnp.float32)
    conv_t, state_t = to_torch(conv, torch.float32), to_torch(
        state, torch.float32)
    for step in range(3):
        h = rng.normal(size=(3, 1, cfg_j.d_model)).astype(np.float32)
        y_j, conv_j, state_j = JL.ssd_decode(p, jnp.asarray(h), conv_j,
                                             state_j, cfg_j)
        y_t, conv_t, state_t = TL.ssd_decode(pt, to_torch(h), conv_t,
                                             state_t, cfg_t)
        for got, want in ((y_t, y_j), (conv_t, conv_j), (state_t, state_j)):
            np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                       err_msg=f"step {step}", **MODEL_TOL)
    assert state_t.dtype == torch.float32


def test_rglru_decode_matches_reference():
    """One RG-LRU step of three rows, the first reset (a document start:
    its decay is zeroed) and the others carrying their state."""
    import jax
    cfg_j, _ = _configs("recurrentgemma-9b")
    p = JL.rglru_init(jax.random.PRNGKey(2), cfg_j)
    pt = _tree(p, lambda v: to_torch(np.asarray(v)))
    w = cfg_j.rglru.lru_width
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 1, w)).astype(np.float32)
    h = rng.normal(size=(3, w)).astype(np.float32)
    reset = np.array([True, False, False])
    want = JL.rglru_decode(p, jnp.asarray(x), jnp.asarray(h),
                           reset=jnp.asarray(reset))
    got = TL.rglru_decode(pt, to_torch(x), to_torch(h),
                          reset=to_torch(reset))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)
    # the reset row forgets h: it equals the step from a zero state
    zero = TL.rglru_decode(pt, to_torch(x), torch.zeros(3, w),
                           reset=to_torch(reset))
    assert torch.equal(got[0], zero[0])
    assert not torch.equal(got[1], zero[1])
