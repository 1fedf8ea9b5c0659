"""The port's serving model (``repro_torch.models.model``) against
``repro.models.model`` with the same weights, carried across by
``convert.params_from_jax``: one fused prefill chunk and one decode step,
logits and cache."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.parallel import ParallelContext
from repro.train.step import make_serve_chunk_step as jax_chunk_step
from repro_torch.configs import ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.models import convert
from repro_torch.models.model import Transformer, check_arch
from repro_torch.train.step import make_serve_chunk_step
from test_torch_helpers import MODEL_TOL, load_jax_params, to_numpy, to_torch

ARCHS = ["llama3-8b", "smollm-360m", "gemma2-2b", "llama3-34b",
         "mistral-large-123b", "nemotron-4-340b"]

# (arch, n_kv_heads override, JAX decode impl).  The reduced configs all
# have rep = 1, so the llama3 variant with 2 kv heads covers GQA.
VARIANTS = [("llama3-8b", None, "xla"), ("llama3-8b", 2, "xla"),
            ("gemma2-2b", None, "xla"), ("gemma2-2b", None, "pallas")]


def _configs(arch, n_kv=None):
    over = {"n_kv_heads": n_kv} if n_kv else {}
    return (dataclasses.replace(jax_config(arch).reduced(), **over),
            dataclasses.replace(torch_config(arch).reduced(), **over))


def _steps(vocab, seed=0):
    """A fused prefill chunk (slot 0: 150 prompt tokens over two q blocks,
    the second padded; slot 1: 90 tokens; slot 2 idle) and then one decode
    step (slot 2 dead).  Positions past 64 cross gemma2's reduced window."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros(384, np.int32)
    pos = -np.ones(384, np.int32)
    tokens[:150] = rng.integers(1, vocab, 150)
    pos[:150] = np.arange(150)
    tokens[256:346] = rng.integers(1, vocab, 90)
    pos[256:346] = np.arange(90)
    prefill = (tokens, pos, np.array([0, 0, 1], np.int32),
               np.array([150, 90, 0], np.int32))
    decode = (np.array([rng.integers(1, vocab), rng.integers(1, vocab), 0],
                       np.int32),
              np.array([150, 90, -1], np.int32),
              np.array([0, 1, -1], np.int32),
              np.array([151, 91, 0], np.int32))
    return prefill, decode


@pytest.mark.parametrize("arch,n_kv,impl", VARIANTS)
def test_serve_chunk_step_matches_reference(arch, n_kv, impl):
    cfg_j, cfg_t = _configs(arch, n_kv)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    ctx = ParallelContext(attn_impl="ref", remat=False, decode_impl=impl)
    step_j = jax.jit(jax_chunk_step(cfg_j, ctx))
    cache_j = JM.init_cache(params, cfg_j, 3, 256, ctx=ctx, layout="serve")

    model = load_jax_params(cfg_t, params)
    step_t = make_serve_chunk_step(model)
    cache_t = model.init_cache(3, 256, layout="serve")

    for phase, args in zip(("prefill", "decode"), _steps(cfg_j.vocab_size)):
        lg_j, cache_j = step_j(params, cache_j,
                               *(jnp.asarray(a) for a in args))
        lg_t = step_t(cache_t, *(to_torch(a) for a in args))
        np.testing.assert_allclose(to_numpy(lg_t), np.asarray(lg_j),
                                   err_msg=phase, **MODEL_TOL)
        np.testing.assert_array_equal(to_numpy(cache_t["kv_len"]),
                                      np.asarray(cache_j["kv_len"]))
        for li, slot in enumerate(cache_t["slots"]):
            g, si = divmod(li, cfg_t.period)
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    to_numpy(slot[name]),
                    np.asarray(cache_j["slots"][si][name][g]),
                    err_msg=f"{phase} layer {li} {name}", **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_reference(arch, reduced):
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    if reduced:
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.pdtype == getattr(torch, cfg_j.param_dtype)
    assert cfg_t.n_params() == cfg_j.n_params()


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b", "llama3-34b",
                                  "mistral-large-123b", "nemotron-4-340b"])
def test_convert_shapes_at_full_width(arch):
    """The full-width layout, by shape only: the reference's init through
    ``jax.eval_shape`` against the port built on the meta device."""
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    shapes = jax.eval_shape(lambda k: JM.init(k, cfg_j),
                            jax.random.PRNGKey(0))
    want = convert.param_shapes(shapes, cfg_t)
    model = Transformer(cfg_t, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == cfg_t.n_params() + cfg_t.d_model * (2 * cfg_t.n_layers + 1
                                                    + 2 * cfg_t.n_layers
                                                    * cfg_t.post_norms)


def _tiny(**over):
    base = dict(arch_id="tiny", family="dense", source="test", n_layers=2,
                d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                vocab_size=64)
    base.update(over)
    return ModelConfig(**base)


@pytest.mark.parametrize("over,match", [
    ({"layer_pattern": ("ssd",), "family": "ssm",
      "ssm": SSMConfig(d_state=16, head_dim=16, chunk_size=16)},
     "layout='decode'"),
    ({"qk_norm": True}, "qk_norm"),
    ({"layer_pattern": ("cross",)}, "cross-attention"),
    ({"moe": MoEConfig(n_experts=4, top_k=2, d_ff_expert=32)}, "MoE"),
])
def test_outside_the_slice_raises(over, match):
    """Serving raises for every arch outside the port.  mamba2 and
    recurrentgemma serve from the ragged cache (their legacy dense decode
    cache still raises); qk_norm, cross-attention and MoE layers raise
    when the serving arch is checked and when a model is built."""
    cfg = _tiny(**over)
    if {"ssd", "rglru"} & set(cfg.layer_pattern):
        check_arch(cfg)
        model = Transformer(cfg, device="cpu")
        assert "conv" in model.init_cache(2, 64)["slots"][0]
        with pytest.raises(NotImplementedError, match=match):
            model.init_cache(2, 64, layout="decode")
    else:
        with pytest.raises(NotImplementedError, match=match):
            check_arch(cfg)
        with pytest.raises(NotImplementedError, match=match):
            Transformer(cfg, device="cpu")


def test_engine_head_dim_guard_reads_the_kernel_set(monkeypatch):
    """On the card the engine serves a config only if the ragged
    cache-attention kernel takes its head_dim: gemma2-2b's 256 and
    nemotron-4-340b's 192 now, an uncovered 96 not; the guard reads
    ``ops.RAGGED_HEAD_DIMS``."""
    from repro_torch.kernels.packed_flash import ops
    from repro_torch.serve import engine
    gemma = torch_config("gemma2-2b")
    assert gemma.head_dim == 256
    engine.check_kernel_head_dim(gemma)
    nemotron = torch_config("nemotron-4-340b")
    assert nemotron.head_dim == 192
    engine.check_kernel_head_dim(nemotron)
    with pytest.raises(NotImplementedError,
                       match=r"head_dim 96 .*\(64, 128, 192, 256\)"):
        engine.check_kernel_head_dim(_tiny(head_dim=96))
    monkeypatch.setattr(ops, "RAGGED_HEAD_DIMS", (64, 128))
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        engine.check_kernel_head_dim(gemma)


def test_legacy_decode_cache_raises():
    model = Transformer(_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="layout='decode'"):
        model.init_cache(2, 64, layout="decode")
    cache = model.init_cache(2, 200)
    assert cache["slots"][0]["k"].shape == (2, 256, 2, 32)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(_tiny())
