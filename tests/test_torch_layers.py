"""The port's layers (``repro_torch.models.layers``) against
``repro.models.layers`` on the same numpy inputs and weights."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

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
