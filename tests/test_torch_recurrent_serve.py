"""Recurrent serving (mamba2's SSD layers, recurrentgemma's RG-LRU layers
with their local attention) in the port against the JAX package, on the
reduced configs with the reference's weights carried across by
``convert.params_from_jax``.

Against the reference: decode-mode ``serve_chunk_step`` over several
steps, with dead rows, a slot reset and a ``pos == 0`` restart, logits and
every cache slot within ``MODEL_TOL``; ``Engine.generate`` and
``Engine.serve`` tokens equal.  Inside the port: concurrent serving equals
solo serving bitwise, batch size one works, a reused engine starts from
zeroed state, and fused prefill raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.parallel import ParallelContext
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.train.step import make_serve_chunk_step as jax_chunk_step
from repro_torch.configs import get_config as torch_config
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.step import make_serve_chunk_step
from test_torch_helpers import MODEL_TOL, load_jax_params, to_numpy, to_torch

ARCHS = ["mamba2-370m", "recurrentgemma-9b"]
CTX = ParallelContext(attn_impl="ref", remat=False, decode_impl="xla")


def _configs(arch):
    return jax_config(arch).reduced(), torch_config(arch).reduced()


def _model(arch, seed=0):
    cfg_j, cfg_t = _configs(arch)
    params = JM.init(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, params, load_jax_params(cfg_t, params)


# (pos per slot, slots reset before the step); -1 = an idle row.  Slot 0
# runs 0..2, is reset and restarts at 0; slot 1 idles, then starts at 0;
# slot 2 runs, idles a step and resumes where it stopped.
STEPS = [([0, -1, 0], []), ([1, -1, 1], []), ([2, 0, -1], []),
         ([0, 1, 2], [0]), ([1, 2, 3], []), ([2, -1, 4], [])]


def _step_args(vocab, rng, pos, kv_len):
    """Decode-mode step: one row a slot, block_req = the slot or -1."""
    pos = np.asarray(pos, np.int32)
    live = pos >= 0
    tokens = np.where(live, rng.integers(1, vocab, len(pos)), 0)
    block_req = np.where(live, np.arange(len(pos)), -1).astype(np.int32)
    kv_len = np.where(live, pos + 1, kv_len).astype(np.int32)
    return tokens.astype(np.int32), pos, block_req, kv_len


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Six decode-mode steps of three slots through both packages: logits
    and every cache slot (conv, state / h, and the local layer's k/v)."""
    cfg_j, cfg_t, params, model = _model(arch)
    step_j = jax.jit(jax_chunk_step(cfg_j, CTX))
    reset_j = jax.jit(lambda c, m: JM.reset_serve_slots(c, cfg_j, m))
    cache_j = JM.init_cache(params, cfg_j, 3, 64, ctx=CTX, layout="serve")
    step_t = make_serve_chunk_step(model)
    cache_t = model.init_cache(3, 64, layout="serve")
    rng = np.random.default_rng(3)
    kv_len = np.zeros(3, np.int32)
    for si, (pos, resets) in enumerate(STEPS):
        if resets:
            mask = np.isin(np.arange(3), resets)
            cache_j = reset_j(cache_j, jnp.asarray(mask))
            model.reset_serve_slots(cache_t, torch.as_tensor(mask))
            kv_len[mask] = 0
        args = _step_args(cfg_j.vocab_size, rng, pos, kv_len)
        kv_len = args[3]
        lg_j, cache_j = step_j(params, cache_j,
                               *(jnp.asarray(a) for a in args))
        lg_t = step_t(cache_t, *(to_torch(a) for a in args))
        live = args[1] >= 0
        np.testing.assert_allclose(to_numpy(lg_t)[live],
                                   np.asarray(lg_j)[live],
                                   err_msg=f"step {si}", **MODEL_TOL)
        for li, slot in enumerate(cache_t["slots"]):
            g, pi = divmod(li, cfg_t.period)
            for name, x in slot.items():
                np.testing.assert_allclose(
                    to_numpy(x), np.asarray(cache_j["slots"][pi][name][g]),
                    err_msg=f"step {si} layer {li} {name}", **MODEL_TOL)
        np.testing.assert_array_equal(to_numpy(cache_t["kv_len"]),
                                      np.asarray(cache_j["kv_len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_idle_rows_keep_their_state_bitwise(arch):
    """A row with pos == -1 leaves its slot's conv window and state (and
    an rglru layer's h, whose pos == 0 reset must not fire) bit for bit,
    while the live rows' advance."""
    _, _, _, model = _model(arch)
    step = make_serve_chunk_step(model)
    cache = model.init_cache(2, 64, layout="serve")
    rng = np.random.default_rng(4)
    for t in range(3):
        step(cache, *(to_torch(a) for a in _step_args(
            512, rng, [t, t], np.zeros(2, np.int32))))
    before = [{k: v.clone() for k, v in s.items()} for s in cache["slots"]]
    step(cache, *(to_torch(a) for a in _step_args(
        512, rng, [3, -1], np.array([3, 3], np.int32))))
    n_recurrent = 0
    for b, s in zip(before, cache["slots"]):
        if "conv" not in s:
            continue
        n_recurrent += 1
        for name in s:
            assert torch.equal(s[name][1], b[name][1]), name
            assert not torch.equal(s[name][0], b[name][0]), name
    assert n_recurrent >= 1


def _pair(arch, scfg_kw, batch_size):
    cfg_j, cfg_t, params, model = _model(arch)
    ref = JaxEngine(cfg_j, params, CTX, JaxServeConfig(**scfg_kw),
                    batch_size=batch_size)
    port = Engine(model, ServeConfig(**scfg_kw), batch_size=batch_size,
                  device="cpu")
    return ref, port, cfg_j.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch):
    """Greedy generation of 3 prompts of 70 tokens (past the reduced local
    window of 64), 6 new tokens each; the reference's tokens exactly."""
    ref, port, vocab = _pair(arch, dict(max_seq=96, max_new_tokens=6), 3)
    prompt = np.random.default_rng(5).integers(1, vocab, (3, 70))
    want = np.asarray(ref.generate(jnp.asarray(prompt)))
    got = to_numpy(port.generate(prompt))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_reference(arch):
    """Continuous batching through 2 slots: 4 ragged requests, per-token
    prefill, greedy; the same tokens and the same scheduler trace."""
    ref, port, vocab = _pair(arch, dict(max_seq=128, max_new_tokens=4), 2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, vocab, n).astype(np.int32)
               for n in (9, 40, 3, 22)]
    want = ref.serve(prompts)
    got = port.serve(prompts)
    assert sorted(got) == sorted(want) == list(range(4))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert port.last_trace == ref.last_trace


def _engine(arch, batch_size, **kw):
    _, _, _, model = _model(arch)
    scfg = ServeConfig(**dict(dict(max_seq=128, max_new_tokens=5), **kw))
    return Engine(model, scfg, batch_size=batch_size, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_concurrent_serving_equals_solo_bitwise(arch):
    """The reference's isolation test: a request's tokens do not depend on
    what shares the batch.  Each prompt served alone through the same
    slot count gives, bitwise, what it gets served among the others."""
    port = _engine(arch, 3)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, n).astype(np.int32)
               for n in (12, 30, 5, 19)]
    together = port.serve(prompts)
    for i, pr in enumerate(prompts):
        alone = port.serve([pr])
        np.testing.assert_array_equal(alone[0], together[i])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_size_one_and_engine_reuse(arch):
    """One slot serves; a second generate on the same engine starts from
    zeroed recurrent state (bitwise the first), and so does a fresh one."""
    port = _engine(arch, 1)
    prompt = np.random.default_rng(8).integers(1, 512, (1, 17))
    first = port.generate(prompt)
    assert first.shape == (1, 5)
    assert torch.equal(port.generate(prompt), first)
    assert torch.equal(_engine(arch, 1).generate(prompt), first)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_prefill_raises(arch):
    """Recurrent mixers are sequential: fused chunked prefill raises in
    the engine and in the model, and the default prefill is per token."""
    port = _engine(arch, 2)
    assert not port.fused_ok
    prompt = np.random.default_rng(9).integers(1, 512, (2, 10))
    with pytest.raises(ValueError, match="fused prefill unsupported"):
        port.prefill(prompt, mode="fused")
    last = port.prefill(prompt)
    assert last.shape == (2, 512)
    tokens = torch.zeros(128, dtype=torch.int32)
    pos = torch.arange(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        port.model.serve_chunk_step(
            port.cache, tokens, pos, torch.zeros(1, dtype=torch.int32),
            torch.full((2,), 128, dtype=torch.int32))


def test_full_width_serve_cache_by_shape():
    """The recurrent slots at full width, on the meta device: mamba2's
    conv [B, 3, 2048 + 2·128] and state [B, 32, 128, 64] f32, and
    recurrentgemma's conv [B, 3, 4096] and h [B, 4096] f32 beside its
    local layers' k/v."""
    from repro_torch.models.model import Transformer
    m = Transformer(torch_config("mamba2-370m"), device="meta")
    c = m.init_cache(4, 600)
    assert len(c["slots"]) == 48
    assert c["slots"][0]["conv"].shape == (4, 3, 2304)
    assert c["slots"][0]["state"].shape == (4, 32, 128, 64)
    assert c["slots"][0]["state"].dtype == torch.float32
    cfg = torch_config("recurrentgemma-9b")
    c = Transformer(cfg, device="meta").init_cache(4, 600)
    kinds = [cfg.layer_pattern[i % cfg.period] for i in range(38)]
    for kind, slot in zip(kinds, c["slots"]):
        if kind == "rglru":
            assert slot["conv"].shape == (4, 3, 4096)
            assert slot["h"].shape == (4, 4096)
            assert slot["conv"].dtype == cfg.cdtype
        else:
            assert slot["k"].shape == (4, 640, 1, 256)
    assert kinds.count("local") == 12
