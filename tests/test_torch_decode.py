"""The legacy dense decode path of the port (``Transformer.init_cache(
layout="decode")``, ``decode_step``, ``train.step.make_serve_step`` and the
engine's legacy branch) against the JAX package's, with the reference
weights carried across by ``convert.params_from_jax``; the cross layers'
``xgate`` is set to ``XGATE`` first (``test_torch_cross.gated_params``).

``decode_step`` logits, token by token, within f32 ``MODEL_TOL`` of the
reference's for the seven archs of ``test_models_smoke.py::
test_decode_matches_forward``, and within that test's 5e-4 of the port's
own teacher-forced ``forward``; the local ring buffer past its window;
``Engine.generate`` tokens equal to the reference engine's; the legacy
branch's refusals; and the reference's out-of-range clamp beside the
port's raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.parallel import ParallelContext as JCtx
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.train.step import make_serve_step as jax_serve_step
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as launch
from repro_torch.parallel import ParallelContext
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.step import make_serve_step
from test_torch_cross import gated_params
from test_torch_helpers import MODEL_TOL, load_jax_params, to_numpy, to_torch

CTX = JCtx(attn_impl="ref", remat=False)
ARCHS = ["smollm-360m", "gemma2-2b", "mamba2-370m", "recurrentgemma-9b",
         "whisper-large-v3", "llama-3.2-vision-11b", "qwen2-moe-a2.7b"]
FORWARD_TOL = 5e-4       # test_decode_matches_forward's bound


def _model(cfg_j, cfg_t, seed):
    if "cross" in cfg_j.layer_pattern:
        params = gated_params(cfg_j, seed)
    else:
        params = JM.init(jax.random.PRNGKey(seed), cfg_j)
    return params, load_jax_params(cfg_t, params)


def _inputs(cfg, b, s, seed=2):
    """Tokens [B, S] and, for an arch with an encoder or cross layers, a
    memory [B, M, D] (M the encoder's n_ctx, else 16), normal x 0.02."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    mem = None
    if cfg.encoder or cfg.family == "vlm":
        m = cfg.encoder.n_ctx if cfg.encoder else 16
        mem = (rng.standard_normal((b, m, cfg.d_model)) * 0.02) \
            .astype(np.float32)
    return toks, mem


def _decode_all(model, toks, mem, max_seq):
    """The port's per-token logits [B, S, V] through ``make_serve_step``."""
    b, s = toks.shape
    cache = model.init_cache(b, max_seq, layout="decode",
                             memory=None if mem is None else to_torch(mem))
    step = make_serve_step(model)
    outs = []
    for t in range(s):
        nxt, lg = step(cache, to_torch(toks[:, t:t + 1]),
                       torch.full((b,), t, dtype=torch.int32))
        assert nxt.dtype == torch.int32 and lg.shape[1] == 1
        outs.append(lg[:, 0])
    return torch.stack(outs, 1)


def _forward(model, toks, mem):
    b, s = toks.shape
    batch = dict(tokens=to_torch(toks),
                 segment_ids=torch.ones((b, s), dtype=torch.int32),
                 positions=torch.arange(s, dtype=torch.int32).expand(b, s))
    if mem is not None:
        batch["memory"] = to_torch(mem)
    with torch.no_grad():
        return model(batch, ParallelContext(attn_impl="ref",
                                            remat=False))[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """16 tokens of 2 rows: the port's ``decode_step`` logits against the
    reference's ``decode_step`` (through ``make_serve_step``), and every
    dense cache slot after the last step."""
    cfg_j, cfg_t = jax_config(arch).reduced(), torch_config(arch).reduced()
    params, model = _model(cfg_j, cfg_t, 2)
    b, s = 2, 16
    toks, mem = _inputs(cfg_t, b, s)
    cache_j = JM.init_cache(params, cfg_j, b, s,
                            memory=None if mem is None else jnp.asarray(mem),
                            ctx=CTX)
    step_j = jax.jit(jax_serve_step(cfg_j, CTX))
    want = []
    for t in range(s):
        _, lg, cache_j = step_j(params, cache_j, jnp.asarray(toks[:, t:t + 1]),
                                jnp.full((b,), t, jnp.int32))
        want.append(np.asarray(lg[:, 0]))
    cache_t = model.init_cache(b, s, layout="decode",
                               memory=None if mem is None else to_torch(mem))
    step_t = make_serve_step(model)
    for t in range(s):
        _, lg = step_t(cache_t, to_torch(toks[:, t:t + 1]),
                       torch.full((b,), t, dtype=torch.int32))
        np.testing.assert_allclose(to_numpy(lg[:, 0]), want[t],
                                   err_msg=f"token {t}", **MODEL_TOL)
    for li, slot in enumerate(cache_t["slots"]):
        g, si = divmod(li, cfg_t.period)
        ref = cache_j["slots"][si]
        assert sorted(slot) == sorted(ref), (li, sorted(slot))
        for name, x in slot.items():
            w = np.asarray(ref[name][g])
            if name == "kv_pos":
                np.testing.assert_array_equal(to_numpy(x), w)
            else:
                np.testing.assert_allclose(to_numpy(x), w, atol=1e-4,
                                           rtol=1e-4,
                                           err_msg=f"layer {li} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own decode against its own teacher-forced ``forward``
    within the reference test's 5e-4 (the reference's seed and shapes)."""
    cfg_j, cfg_t = jax_config(arch).reduced(), torch_config(arch).reduced()
    _, model = _model(cfg_j, cfg_t, 2)
    toks, mem = _inputs(cfg_t, 2, 16)
    err = float((_forward(model, toks, mem)
                 - _decode_all(model, toks, mem, 16)).abs().max())
    assert err < FORWARD_TOL, f"decode mismatch {err}"


def test_local_ring_buffer_window():
    """gemma2-reduced with window 8 decoded for 32 tokens: the local
    layers keep a ring of 8 slots (written at pos % 8, ``kv_pos`` holding
    positions 24..31 at the end), and the logits match the reference's
    decode and the port's windowed forward."""
    cfg_j = dataclasses.replace(jax_config("gemma2-2b").reduced(), window=8)
    cfg_t = dataclasses.replace(torch_config("gemma2-2b").reduced(),
                                window=8)
    params, model = _model(cfg_j, cfg_t, 3)
    toks, _ = _inputs(cfg_t, 1, 32, seed=3)
    got = _decode_all(model, toks, None, 32)
    cache_j = JM.init_cache(params, cfg_j, 1, 32, ctx=CTX)
    step_j = jax.jit(jax_serve_step(cfg_j, CTX))
    want = []
    for t in range(32):
        _, lg, cache_j = step_j(params, cache_j, jnp.asarray(toks[:, t:t + 1]),
                                jnp.full((1,), t, jnp.int32))
        want.append(np.asarray(lg[:, 0]))
    np.testing.assert_allclose(to_numpy(got), np.stack(want, 1), **MODEL_TOL)
    assert float((_forward(model, toks, None) - got).abs().max()) \
        < FORWARD_TOL
    cache = model.init_cache(1, 32, layout="decode")
    local = [c for blk, c in zip(model.layers, cache["slots"])
             if blk.kind == "local"]
    assert local and all(c["k"].shape[1] == 8 for c in local)
    step = make_serve_step(model)
    for t in range(32):
        step(cache, to_torch(toks[:, t:t + 1]),
             torch.full((1,), t, dtype=torch.int32))
    for c in local:
        assert sorted(c["kv_pos"][0].tolist()) == list(range(24, 32))


# ---------------------------------------------------------------- engine
GEN_ARCHS = ["whisper-large-v3", "llama-3.2-vision-11b", "smollm-360m"]


def _engines(arch, b=2, max_seq=24, new=6):
    cfg_j, cfg_t = jax_config(arch).reduced(), torch_config(arch).reduced()
    params, model = _model(cfg_j, cfg_t, 0)
    rng = np.random.default_rng(5)
    m = cfg_t.encoder.n_ctx if cfg_t.encoder else 16
    mem = (rng.standard_normal((b, m, cfg_t.d_model)) * 0.02) \
        .astype(np.float32)
    prompt = rng.integers(1, cfg_t.vocab_size, (b, 8)).astype(np.int32)
    j_eng = JaxEngine(cfg_j, params, CTX,
                      JaxServeConfig(max_seq=max_seq, max_new_tokens=new),
                      memory=jnp.asarray(mem), batch_size=b)
    t_eng = Engine(model, ServeConfig(max_seq=max_seq, max_new_tokens=new),
                   batch_size=b, device="cpu", memory=to_torch(mem))
    return j_eng, t_eng, prompt, mem


@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_generate_with_memory_matches_reference(arch):
    """``Engine.generate`` with a memory (the legacy branch; smollm too,
    which takes it because it was given one) gives the reference engine's
    tokens, twice in a row on the same engine; with the prompts and the
    memory rows permuted together the tokens come out permuted."""
    j_eng, t_eng, prompt, mem = _engines(arch)
    assert not t_eng.serve_layout and not t_eng.fused_ok
    want = np.asarray(j_eng.generate(jnp.asarray(prompt)))
    got = to_numpy(t_eng.generate(prompt))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_numpy(t_eng.generate(prompt)), want)
    assert t_eng.n_chunk_calls == 2 * (prompt.shape[1] + 5)
    flipped = Engine(t_eng.model, t_eng.scfg, batch_size=2, device="cpu",
                     memory=to_torch(mem[::-1].copy()))
    np.testing.assert_array_equal(to_numpy(flipped.generate(prompt[::-1])),
                                  want[::-1])


def test_legacy_prefill_rejects_fused_and_return_logits():
    """The reference's ``test_serve.py`` refusals: fused prefill and
    ``return_logits`` raise on the legacy branch, a plain prefill gives
    the last logits."""
    cfg = torch_config("whisper-large-v3").reduced()
    model = load_jax_params(cfg, gated_params(
        jax_config("whisper-large-v3").reduced()))
    mem = torch.randn((1, cfg.encoder.n_ctx, cfg.d_model),
                      generator=torch.Generator().manual_seed(1)) * 0.02
    eng = Engine(model, ServeConfig(max_seq=16), batch_size=1,
                 device="cpu", memory=mem)
    toks = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError, match="fused prefill unsupported"):
        eng.prefill(toks, mode="fused")
    with pytest.raises(ValueError, match="return_logits"):
        eng.prefill(toks, return_logits=True)
    assert eng.prefill(toks).shape == (1, cfg.vocab_size)


@pytest.mark.parametrize("entry", ["serve", "make_scheduler"])
def test_legacy_branch_refuses_continuous_batching(entry):
    """Continuous batching needs the serving layout: ``serve()`` and
    ``make_scheduler`` raise on the legacy branch, as the reference's."""
    _, eng, prompt, _ = _engines("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="serving cache layout"):
        if entry == "serve":
            eng.serve([prompt[0]])
        else:
            eng.make_scheduler()


def test_cross_arch_refuses_the_serve_layout_and_no_memory():
    """A cross arch has no serve-layout cache, its decode cache needs a
    memory, and the launcher, which cannot give one, raises naming
    ``Engine(memory=...)`` (the reference's reaches an assert)."""
    cfg = torch_config("whisper-large-v3").reduced()
    _, model = _model(jax_config("whisper-large-v3").reduced(), cfg, 0)
    with pytest.raises(ValueError, match="serve cache layout"):
        model.init_cache(1, 16, layout="serve")
    with pytest.raises(ValueError, match=r"Engine\(memory=\.\.\.\)"):
        model.init_cache(1, 16, layout="decode")
    with pytest.raises(ValueError, match=r"memory=\.\.\."):
        Engine(model, ServeConfig(max_seq=16), device="cpu")
    args = launch.parse_args(["--device", "cpu"])
    with pytest.raises(ValueError, match=r"Engine\(model, serve_cfg, "
                                         r"memory=\.\.\.\)"):
        launch.build_engine(args, cfg)


def test_write_past_the_end_clamps_in_the_reference_and_raises_here():
    """The reference's ``_write_cache`` moves a position past the cache's
    end onto its last slot (``dynamic_update_slice`` clamps); the port's
    ``decode_step`` raises before writing.  The engine's max_seq guard
    keeps ``generate`` inside the cache either way."""
    b, size, hkv, dh = 1, 4, 1, 2
    ck = jnp.zeros((b, size, hkv, dh))
    kp = -jnp.ones((b, size), jnp.int32)
    k_new = jnp.ones((b, 1, hkv, dh))
    ck2, _, kp2 = JM._write_cache(ck, ck, kp, k_new, k_new,
                                  jnp.full((b,), size + 3, jnp.int32),
                                  ring=False)
    assert np.asarray(kp2).tolist() == [[-1, -1, -1, size + 3]]
    assert float(ck2[0, size - 1].sum()) == hkv * dh
    cfg = torch_config("smollm-360m").reduced()
    _, model = _model(jax_config("smollm-360m").reduced(), cfg, 0)
    cache = model.init_cache(b, size, layout="decode")
    with pytest.raises(ValueError, match="past the end"):
        model.decode_step(cache, torch.ones((b, 1), dtype=torch.int32),
                          torch.full((b,), size, dtype=torch.int32))
    assert int(cache["slots"][0]["kv_pos"].max()) == -1
    eng = Engine(model, ServeConfig(max_seq=size, max_new_tokens=2),
                 batch_size=b, device="cpu", memory=torch.zeros((b, 2, 1)))
    with pytest.raises(ValueError, match="does not fit max_seq"):
        eng.generate(np.ones((b, size), np.int32))
