"""The MoE archs in the port (``models.layers.moe_apply``, the MoE block,
its training step and decode-mode serving) against the JAX package, on
``qwen2-moe-a2.7b-reduced`` (top-2 of 4 experts, 1 shared) and
``llama4-maverick-400b-a17b-reduced`` (top-1 of 4, 1 shared), with the
reference weights carried across by ``convert.params_from_jax``.

``moe_apply``: outputs within f32 atol 1e-5 x max(1, max |ref|), the
auxiliary losses within 1e-6 relative, gradients of x and of every MoE
weight within 1e-4 x max(1, max |grad|) of ``jax.vjp``, at the reduced
``capacity_factor`` 8 (nothing dropped) and at 1.0 (tokens dropped: the
test asserts that some were), and under ``no_drop``.  The model: logits,
aux losses and every gradient of lm loss + aux under the ``ref``,
``xla``, ``pallas`` (the kernels' plain versions on the CPU) and ``cad``
routes, with and without drops; a 3-step loss stream of the trainer;
decode-mode ``serve_chunk_step`` logits and every cache slot; generated
and served tokens; concurrent == solo; fused prefill raises; the AdamW
decay mask; both launchers at reduced width."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cad import CADSession as JSession
from repro.configs import get_config as jax_config
from repro.data.pipeline import PipelineConfig as JPipe
from repro.data.pipeline import raw_batches as j_raw_batches
from repro.models import layers as JL
from repro.models import model as JM
from repro.parallel import ParallelContext as JCtx
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.train.loss import lm_loss as j_lm_loss
from repro.train.step import make_serve_chunk_step as jax_chunk_step
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import train as j_train
from repro_torch.cad import CADSession
from repro_torch.configs import get_config as torch_config
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Transformer, check_arch
from repro_torch.parallel import ParallelContext
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.loss import lm_loss
from repro_torch.train.step import batch_to_device, make_serve_chunk_step
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import (MODEL_TOL, load_jax_params, params_to_numpy,
                                to_numpy, to_torch)

QWEN, MAVERICK = "qwen2-moe-a2.7b-reduced", "llama4-maverick-400b-a17b-reduced"
ARCHS = [QWEN, MAVERICK]
# the reduced configs' capacity factor drops nothing; 1.0 drops
NO_DROPS, DROPS = 8.0, 1.0
OUT_ATOL = 1e-5          # x max(1, max |ref|)
AUX_RTOL = 1e-6
GRAD_REL = 1e-4          # x max(1, max |grad|)
PIPE = dict(distribution="prolong", max_doc_len=256, seq_len=256,
            global_batch=2, n_ranks=2, seed=0)
SERVE_CTX = JCtx(attn_impl="ref", remat=False, decode_impl="xla")


def _configs(arch, capacity_factor=None):
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    if capacity_factor is not None:
        cfg_j, cfg_t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (cfg_j, cfg_t))
    return cfg_j, cfg_t


def _dropped(cfg, router, x):
    """How many (token, choice) pairs fall past their expert's capacity
    (numpy, from the router's top-k as the reference picks it)."""
    e = cfg.moe
    logits = x.reshape(-1, x.shape[-1]) @ router
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :e.top_k]
    n_tok = logits.shape[0]
    cap = max(1, int(n_tok * e.top_k / e.n_experts * e.capacity_factor))
    counts = np.bincount(idx.reshape(-1), minlength=e.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


def _moe_pair(arch, capacity_factor, no_drop=False, seed=0):
    """The reference's moe_apply with its vjp, and the port's with its
    gradients, on the same numpy inputs and cotangents."""
    cfg_j, cfg_t = _configs(arch, capacity_factor)
    p = JL.moe_init(jax.random.PRNGKey(seed), cfg_j)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 48, cfg_j.d_model)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    ctx = JCtx(mesh=None)

    @jax.jit
    def run(pp, hh, gg):
        (o, a), vjp = jax.vjp(lambda p_, h_: JL.moe_apply(
            p_, h_, cfg_j, ctx, no_drop=no_drop), pp, hh)
        one = jnp.float32(1.0)
        return o, a, vjp((gg, {"moe_lb": one, "moe_z": one}))
    out_j, aux_j, (gp_j, gh_j) = run(p, jnp.asarray(h), jnp.asarray(g))
    pt = {k: to_torch(v).requires_grad_() for k, v in p.items()}
    ht = to_torch(h).requires_grad_()
    out_t, aux_t = TL.moe_apply(pt, ht, cfg_t, no_drop=no_drop)
    total = (out_t * to_torch(g)).sum() + aux_t["moe_lb"] + aux_t["moe_z"]
    grads = torch.autograd.grad(total, [ht, *pt.values()])
    want = {"x": np.asarray(gh_j), **{k: np.asarray(v)
                                      for k, v in gp_j.items()}}
    got = dict(zip(["x", *pt], (to_numpy(x) for x in grads)))
    dropped = _dropped(cfg_j, np.asarray(p["router"]), h)
    return (out_t, aux_t, got), (np.asarray(out_j), aux_j, want), dropped


def _assert_moe(got, want):
    (out_t, aux_t, g_t), (out_j, aux_j, g_j) = got, want
    scale = max(1.0, float(np.abs(out_j).max()))
    np.testing.assert_allclose(to_numpy(out_t), out_j, rtol=0,
                               atol=OUT_ATOL * scale)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux_t[k].detach()),
                                   float(aux_j[k]), rtol=AUX_RTOL, err_msg=k)
    assert sorted(g_t) == sorted(g_j)
    for name, w in g_j.items():
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        assert np.abs(g_t[name] - w).max() <= tol, name


@pytest.mark.parametrize("capacity_factor", [NO_DROPS, DROPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, capacity_factor):
    got, want, dropped = _moe_pair(arch, capacity_factor)
    _assert_moe(got, want)
    assert (dropped > 0) == (capacity_factor == DROPS), dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_no_drop_matches_reference(arch):
    """Serving's ``no_drop`` (cap = n_tok) at the factor that drops in
    training: nothing is dropped, as in the reference."""
    got, want, dropped = _moe_pair(arch, DROPS, no_drop=True, seed=1)
    assert dropped > 0
    _assert_moe(got, want)


def test_top_k_ties_pick_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3]])
    vals, idx = TL._top_k(probs, 2)
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want[0]))


# ----------------------------------------------------------------- model
def _jax_model(cfg_j, params, batch, ctx):
    """The reference's logits, aux losses and gradients of lm loss + aux
    of one packed batch."""
    jb = {k: jnp.asarray(batch[k]) for k in
          ("tokens", "labels", "segment_ids", "positions")}
    if "plan" in batch:
        ctx = ctx.cad.bind_plan(ctx, jax.tree.map(jnp.asarray,
                                                  batch["plan"]))

    def loss_fn(p):
        logits, aux = JM.forward(p, cfg_j, jb, ctx)
        loss = j_lm_loss(logits, jb["labels"], jb["segment_ids"])[0]
        return loss + aux["moe_lb"] + aux["moe_z"], (logits, aux)
    (_, (logits, aux)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return logits, aux, grads


def _torch_model(model, batch, ctx):
    b = batch_to_device(batch, "cpu")
    if "plan" in b:
        ctx = ctx.cad.bind_plan(ctx, b["plan"])
    logits, aux = model(b, ctx)
    loss, _ = lm_loss(logits, b["labels"], b["segment_ids"])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss + aux["moe_lb"] + aux["moe_z"],
                                list(model.parameters()))
    return logits, aux, dict(zip(names, grads))


@pytest.mark.parametrize("impl,capacity_factor", [
    ("ref", NO_DROPS), ("xla", NO_DROPS), ("pallas", NO_DROPS),
    ("cad", NO_DROPS), ("ref", DROPS), ("cad", DROPS)])
def test_model_matches_reference(impl, capacity_factor, monkeypatch):
    """qwen2-moe-reduced under every route: logits within ``MODEL_TOL``,
    aux losses within 1e-6 relative, every gradient within 1e-4 x
    max(1, max |grad|); at the factor 1.0 the layers drop tokens."""
    cfg_j, cfg_t = _configs(QWEN, capacity_factor)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    pipe = dict(PIPE, vocab_size=cfg_j.vocab_size)
    if impl == "cad":
        j_sess = JSession.for_pipeline(cfg_j, JPipe(**pipe), prefetch=0)
        t_sess = CADSession.for_pipeline(cfg_t, PipelineConfig(**pipe),
                                         prefetch=0)
        batch_j = next(j_sess.attach_plans(j_raw_batches(JPipe(**pipe))))
        batch_t = next(t_sess.attach_plans(raw_batches(
            PipelineConfig(**pipe))))
        ctx_j, ctx_t = j_sess.context(), t_sess.context()
    else:
        batch_j = batch_t = next(raw_batches(PipelineConfig(**pipe)))
        ctx_j = JCtx(attn_impl=impl, remat=True)
        ctx_t = ParallelContext(attn_impl=impl, remat=True)
    logits_j, aux_j, grads_j = _jax_model(cfg_j, params, batch_j, ctx_j)
    dropped, moe_apply = [], TL.moe_apply

    def spy(p, h, cfg, **kw):
        dropped.append(_dropped(cfg, to_numpy(p["router"]), to_numpy(h)))
        return moe_apply(p, h, cfg, **kw)
    monkeypatch.setattr(TL, "moe_apply", spy)
    logits_t, aux_t, grads_t = _torch_model(load_jax_params(cfg_t, params),
                                            batch_t, ctx_t)
    assert (max(dropped) > 0) == (capacity_factor == DROPS), dropped
    np.testing.assert_allclose(to_numpy(logits_t), np.asarray(logits_j),
                               **MODEL_TOL)
    for k in ("moe_lb", "moe_z"):
        assert aux_t[k].dtype == torch.float32 and aux_t[k].dim() == 0
        np.testing.assert_allclose(float(aux_t[k].detach()),
                                   float(aux_j[k]), rtol=AUX_RTOL, err_msg=k)
    want = params_from_jax(params_to_numpy(grads_j), cfg_t)
    assert sorted(want) == sorted(grads_t)
    assert any(".moe.experts_gate" in n for n in want)
    for name, g in grads_t.items():
        w = to_numpy(want[name])
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        assert np.abs(to_numpy(g) - w).max() <= tol, name


def test_maverick_model_matches_reference():
    """llama4-maverick-reduced (top-1) under the ``ref`` route."""
    cfg_j, cfg_t = _configs(MAVERICK)
    params = JM.init(jax.random.PRNGKey(1), cfg_j)
    batch = next(raw_batches(PipelineConfig(**dict(
        PIPE, vocab_size=cfg_j.vocab_size))))
    logits_j, aux_j, grads_j = _jax_model(cfg_j, params, batch,
                                          JCtx(attn_impl="ref", remat=True))
    logits_t, aux_t, grads_t = _torch_model(
        load_jax_params(cfg_t, params), batch,
        ParallelContext(attn_impl="ref", remat=True))
    np.testing.assert_allclose(to_numpy(logits_t), np.asarray(logits_j),
                               **MODEL_TOL)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux_t[k].detach()),
                                   float(aux_j[k]), rtol=AUX_RTOL)
    want = params_from_jax(params_to_numpy(grads_j), cfg_t)
    for name, g in grads_t.items():
        w = to_numpy(want[name])
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        assert np.abs(to_numpy(g) - w).max() <= tol, name


def test_three_step_loss_stream_matches_reference():
    """The trainer under CAD against the reference's (``make_train_step``
    inside its ``train``): the lm loss and both aux losses of 3 steps."""
    cfg_j, cfg_t = _configs(QWEN)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    pipe = dict(PIPE, vocab_size=cfg_j.vocab_size)
    tc = dict(steps=3, peak_lr=1e-3, warmup=1, log_every=1)
    want = j_train(cfg_j, JPipe(**pipe), JTrainConfig(**tc), params=params,
                   session=JSession.for_pipeline(cfg_j, JPipe(**pipe),
                                                 prefetch=0))["history"]
    got = train(cfg_t, PipelineConfig(**pipe), TrainConfig(**tc),
                model=load_jax_params(cfg_t, params), device="cpu",
                session=CADSession.for_pipeline(
                    cfg_t, PipelineConfig(**pipe), prefetch=0))["history"]
    for key, tol in (("loss", 1e-4), ("moe_lb", 1e-6), ("moe_z", 1e-6),
                     ("total_loss", 1e-4)):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], atol=tol, rtol=0,
                                   err_msg=key)


def test_decay_mask_matches_reference():
    """The reference decays a leaf of its layer-stacked tree when ``ndim
    >= 2``: every MoE weight (router, stacked experts, shared experts)
    and every per-layer vector; ``convert.decay_mask`` says the same of
    the port's tensors (one AdamW update of each agrees)."""
    import test_torch_train
    test_torch_train.test_adamw_decay_mask_matches_reference(QWEN)
    model = Transformer(torch_config(QWEN), device="cpu")
    from repro_torch.models.convert import decay_mask
    decay = dict(zip((n for n, _ in model.named_parameters()),
                     decay_mask(model)))
    moe = [n for n in decay if ".moe." in n]
    assert len(moe) == 2 * 7 and all(decay[n] for n in moe)


# --------------------------------------------------------------- serving
def _serve_model(arch, seed=0):
    cfg_j, cfg_t = _configs(arch)
    params = JM.init(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, params, load_jax_params(cfg_t, params)


# (pos per slot); -1 = an idle row
STEPS = [[0, -1, 0], [1, -1, 1], [2, 0, -1], [3, 1, 2], [4, 2, 3]]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Five decode-mode steps of three slots (idle rows among them):
    logits and every cache slot within ``MODEL_TOL``."""
    cfg_j, cfg_t, params, model = _serve_model(arch)
    step_j = jax.jit(jax_chunk_step(cfg_j, SERVE_CTX))
    cache_j = JM.init_cache(params, cfg_j, 3, 64, ctx=SERVE_CTX,
                            layout="serve")
    step_t = make_serve_chunk_step(model)
    cache_t = model.init_cache(3, 64, layout="serve")
    rng = np.random.default_rng(3)
    kv_len = np.zeros(3, np.int32)
    for si, pos in enumerate(STEPS):
        pos = np.asarray(pos, np.int32)
        live = pos >= 0
        tokens = np.where(live, rng.integers(1, cfg_j.vocab_size, 3),
                          0).astype(np.int32)
        block_req = np.where(live, np.arange(3), -1).astype(np.int32)
        kv_len = np.where(live, pos + 1, kv_len).astype(np.int32)
        args = (tokens, pos, block_req, kv_len)
        lg_j, cache_j = step_j(params, cache_j,
                               *(jnp.asarray(a) for a in args))
        lg_t = step_t(cache_t, *(to_torch(a) for a in args))
        np.testing.assert_allclose(to_numpy(lg_t)[live],
                                   np.asarray(lg_j)[live],
                                   err_msg=f"step {si}", **MODEL_TOL)
        for li, slot in enumerate(cache_t["slots"]):
            for name, x in slot.items():
                np.testing.assert_allclose(
                    to_numpy(x), np.asarray(cache_j["slots"][0][name][li]),
                    err_msg=f"step {si} layer {li} {name}", **MODEL_TOL)


def _pair(arch, scfg_kw, batch_size):
    cfg_j, _, params, model = _serve_model(arch)
    ref = JaxEngine(cfg_j, params, SERVE_CTX, JaxServeConfig(**scfg_kw),
                    batch_size=batch_size)
    port = Engine(model, ServeConfig(**scfg_kw), batch_size=batch_size,
                  device="cpu")
    return ref, port, cfg_j.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_serve_tokens_match_reference(arch):
    """Greedy ``generate`` of 2 prompts of 20 tokens, and continuous
    batching of 3 ragged requests through 2 slots: the reference's tokens
    and scheduler trace."""
    ref, port, vocab = _pair(arch, dict(max_seq=64, max_new_tokens=4), 2)
    assert not port.fused_ok
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, vocab, (2, 20))
    np.testing.assert_array_equal(to_numpy(port.generate(prompt)),
                                  np.asarray(ref.generate(
                                      jnp.asarray(prompt))))
    prompts = [rng.integers(1, vocab, n).astype(np.int32)
               for n in (9, 17, 3)]
    want, got = ref.serve(prompts), port.serve(prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert port.last_trace == ref.last_trace


@pytest.mark.parametrize("arch", ARCHS)
def test_concurrent_serving_equals_solo_bitwise(arch):
    """Under ``no_drop`` routing is row-independent: each prompt served
    alone through the same slots gets, bitwise, what it gets among the
    others."""
    _, _, _, model = _serve_model(arch)
    port = Engine(model, ServeConfig(max_seq=64, max_new_tokens=4),
                  batch_size=3, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, n).astype(np.int32)
               for n in (12, 25, 5, 19)]
    together = port.serve(prompts)
    for i, pr in enumerate(prompts):
        np.testing.assert_array_equal(port.serve([pr])[0], together[i])


def test_fused_prefill_raises():
    """MoE routing is batch-global in training's capacity terms, so MoE
    archs prefill a token a step: fused prefill raises in the engine and
    in the model, and the default prefill is per token."""
    _, _, _, model = _serve_model(QWEN)
    port = Engine(model, ServeConfig(max_seq=256), batch_size=2,
                  device="cpu")
    prompt = np.random.default_rng(9).integers(1, 512, (2, 10))
    with pytest.raises(ValueError, match="fused prefill unsupported"):
        port.prefill(prompt, mode="fused")
    assert port.prefill(prompt).shape == (2, 512)
    with pytest.raises(ValueError, match="without MoE"):
        model.serve_chunk_step(
            port.cache, torch.zeros(128, dtype=torch.int32),
            torch.arange(128, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.full((2,), 128, dtype=torch.int32))


# --------------------------------------------------------- entry points
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_configs_match_reference(arch, reduced):
    """The port's copies of the two configs, widths and ``reduced()``
    rule, field for field the reference's."""
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    if reduced:
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.n_params() == cfg_j.n_params()
    assert cfg_t.n_active_params() == cfg_j.n_active_params()


def test_full_width_layouts_by_shape():
    """Both archs build at every width on the meta device (one layer), the
    MoE weights shaped as ``params_from_jax`` carries the reference's."""
    from repro_torch.models.convert import param_shapes
    for arch, n_exp, d, f in (("qwen2-moe-a2.7b", 60, 2048, 1408),
                              ("llama4-maverick-400b-a17b", 128, 5120,
                               8192)):
        cfg_j = dataclasses.replace(jax_config(arch), n_layers=1)
        cfg_t = dataclasses.replace(torch_config(arch), n_layers=1)
        check_arch(cfg_t)
        m = Transformer(cfg_t, device="meta")
        want = param_shapes(jax.eval_shape(
            lambda c=cfg_j: JM.init(jax.random.PRNGKey(0), c)), cfg_t)
        assert {k: tuple(v.shape) for k, v in m.state_dict().items()} \
            == want
        assert want["layers.0.moe.experts_gate"] == (n_exp, d, f)
        assert want["layers.0.moe.router"] == (d, n_exp)
        assert not hasattr(m.layers[0], "ffn")


def test_train_launcher_at_reduced_width(capsys):
    from repro_torch.launch.train import main
    res = main(["--arch", QWEN, "--device", "cpu", "--cad", "--steps", "2",
                "--seq", "256", "--batch", "4", "--ranks", "2"])
    hist = res["history"]
    assert len(hist) == 2
    assert all(math.isfinite(h[k]) for h in hist
               for k in ("loss", "moe_lb", "moe_z"))
    out = capsys.readouterr().out
    assert "moe_lb" in out and "done: loss" in out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_launcher_at_reduced_width(arch):
    from repro_torch.launch import serve as launch
    args = launch.parse_args(["--arch", arch, "--device", "cpu",
                              "--max-seq", "64", "--max-new", "3",
                              "--slots", "2"])
    engine = launch.build_engine(args)
    assert engine.cfg.arch_id == arch + "-reduced"
    rng = np.random.default_rng(11)
    out = engine.serve([rng.integers(1, 512, n) for n in (7, 13)])
    assert sorted(out) == [0, 1]
    assert all(len(t) == 3 for t in out.values())
