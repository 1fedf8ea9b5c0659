"""The cross-attention archs in the port (``models.layers.cross_attn_apply``,
the ``cross`` and ``enc`` blocks, ``Transformer.encode`` and the memory
handling of ``forward``, the CAD training step with a memory) against the
JAX package, on ``whisper-large-v3-reduced`` (2 encoder + 2 decoder
``cross`` layers, LayerNorm, sinusoidal positions) and
``llama-3.2-vision-11b-reduced`` (``global`` + ``cross``; its reduced
config gets the reference's 2-layer encoder, the full one has none), with
the reference weights carried across by ``convert.params_from_jax``.

``xgate`` starts at zero in the reference (``tanh(0) = 0``: a cross layer
adds nothing at init and its ``xw*`` get no gradient), so every
comparison here first sets it to ``XGATE`` in the reference's pytree.

Tolerances: f32 ``MODEL_TOL`` on logits and encoder outputs, gradients
within 1e-4 x max(1, max |grad|)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cad import CADSession as JSession
from repro.configs import get_config as jax_config
from repro.core.attention import xla_flash_attention as j_xla_flash
from repro.data.pipeline import PipelineConfig as JPipe
from repro.data.pipeline import raw_batches as j_raw_batches
from repro.models import model as JM
from repro.parallel import ParallelContext as JCtx
from repro.train.loss import lm_loss as j_lm_loss
from repro_torch.cad import CADSession
from repro_torch.configs import get_config as torch_config
from repro_torch.core import attention as TA
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.convert import decay_mask, params_from_jax
from repro_torch.models.model import Transformer
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.parallel import ParallelContext
from repro_torch.train.loss import lm_loss
from repro_torch.train.step import batch_to_device, make_train_step
from test_torch_helpers import (KERNEL_TOL, MODEL_TOL, load_jax_params,
                                params_to_numpy, to_numpy, to_torch)

WHISPER, VISION = "whisper-large-v3-reduced", "llama-3.2-vision-11b-reduced"
ARCHS = [WHISPER, VISION]
XGATE = 0.5
GRAD_REL = 1e-4          # x max(1, max |grad|)
PIPE = dict(distribution="prolong", max_doc_len=256, seq_len=256,
            global_batch=2, n_ranks=2, seed=0)
MEM_KEYS = ("tokens", "labels", "segment_ids", "positions", "memory",
            "memory_mask")


def gated_params(cfg_j, seed=0, gate=XGATE):
    """The reference's init with every cross layer's ``xgate`` set to
    ``gate`` (0 at init would hide a broken cross-attention)."""
    params = JM.init(jax.random.PRNGKey(seed), cfg_j)
    blocks = tuple(dict(slot, attn=dict(slot["attn"], xgate=jnp.full_like(
        slot["attn"]["xgate"], gate))) if "xgate" in slot["attn"] else slot
        for slot in params["blocks"])
    assert any("xgate" in slot["attn"] for slot in blocks)
    return dict(params, blocks=blocks)


def memory_for(cfg, batch_size, seed=1):
    """Seeded memory [B, n_ctx, d_model]: 0.02 x (a normal vector each
    row's frames share + a normal vector per frame), as ``chip_smoke.py``
    makes it (per-frame draws alone average away under near-uniform
    attention)."""
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal((batch_size, 1, cfg.d_model))
    frames = rng.standard_normal((batch_size, cfg.encoder.n_ctx,
                                  cfg.d_model))
    return ((shared + frames) * 0.02).astype(np.float32)


def small_batch(cfg, seed=0):
    """B 2, S 32: row 0 holds two documents (20 and 8 tokens) and 4
    padding tokens (segment 0), row 1 one document; and the memory."""
    rng = np.random.default_rng(seed)
    seg = np.ones((2, 32), np.int32)
    seg[0, 20:28] = 2
    seg[0, 28:] = 0
    pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    pos[0, 20:28] = np.arange(8)
    pos[0, 28:] = 0
    tokens = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    tokens[seg == 0] = 0
    nxt, nseg = np.roll(tokens, -1, -1), np.roll(seg, -1, -1)
    labels = np.where((seg > 0) & (seg == nseg), nxt, -1).astype(np.int32)
    return dict(tokens=tokens, labels=labels, segment_ids=seg,
                positions=pos, memory=memory_for(cfg, 2, seed + 1))


def _jax_run(cfg_j, params, batch, ctx, grads=True):
    """The reference's logits (and lm-loss gradients) of one batch with
    its memory."""
    jb = {k: jnp.asarray(batch[k]) for k in MEM_KEYS if k in batch}
    if "plan" in batch:
        ctx = ctx.cad.bind_plan(ctx, jax.tree.map(jnp.asarray,
                                                  batch["plan"]))

    def loss_fn(p):
        logits, _ = JM.forward(p, cfg_j, jb, ctx)
        return j_lm_loss(logits, jb["labels"], jb["segment_ids"])[0], logits
    if not grads:
        return jax.jit(lambda p: JM.forward(p, cfg_j, jb, ctx)[0])(params), \
            None, None
    (loss, logits), g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return logits, loss, g


def _torch_run(model, batch, ctx, grads=True):
    b = batch_to_device(batch, "cpu")
    if "plan" in b:
        ctx = ctx.cad.bind_plan(ctx, b["plan"])
    if not grads:
        with torch.no_grad():
            return model(b, ctx)[0], None, None
    logits, _ = model(b, ctx)
    loss, _ = lm_loss(logits, b["labels"], b["segment_ids"])
    names = [n for n, _ in model.named_parameters()]
    g = torch.autograd.grad(loss, list(model.parameters()))
    return logits, loss, dict(zip(names, g))


def _cad_batches(cfg_j, cfg_t, policy="balanced"):
    """The first pipeline batch with its plan from each package's session,
    and the same seeded memory added to both."""
    pipe = dict(PIPE, vocab_size=cfg_j.vocab_size)
    j_sess = JSession.for_pipeline(cfg_j, JPipe(**pipe), prefetch=0,
                                   plan_policy=policy)
    t_sess = CADSession.for_pipeline(cfg_t, PipelineConfig(**pipe),
                                     prefetch=0, plan_policy=policy)
    batch_j = next(j_sess.attach_plans(j_raw_batches(JPipe(**pipe))))
    batch_t = next(t_sess.attach_plans(raw_batches(PipelineConfig(**pipe))))
    mem = memory_for(cfg_t, PIPE["global_batch"])
    batch_j["memory"] = batch_t["memory"] = mem
    return batch_j, batch_t, j_sess.context(), t_sess.context()


def _setup(arch, impl):
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    params = gated_params(cfg_j)
    if impl == "cad":
        batch_j, batch_t, ctx_j, ctx_t = _cad_batches(cfg_j, cfg_t)
    else:
        batch_j = batch_t = small_batch(cfg_t)
        ctx_j = JCtx(attn_impl=impl, remat=True)
        ctx_t = ParallelContext(attn_impl=impl, remat=True)
    return cfg_j, cfg_t, params, batch_j, batch_t, ctx_j, ctx_t


# ------------------------------------------------------------ the encoder
@pytest.mark.parametrize("arch", ARCHS)
def test_encode_matches_reference(arch):
    """``Transformer.encode`` (sinusoidal positions, the non-causal ``enc``
    layers, ``enc_final_norm``) against ``repro.models.model.encode``."""
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    assert cfg_t.encoder.n_layers == 2 and cfg_t.encoder.n_ctx == 24
    params = gated_params(cfg_j)
    mem = memory_for(cfg_t, 2)
    want = JM.encode(params, cfg_j, jnp.asarray(mem),
                     JCtx(attn_impl="ref", remat=False))
    model = load_jax_params(cfg_t, params)
    with torch.no_grad():
        got = model.encode(to_torch(mem), ParallelContext(attn_impl="ref",
                                                          remat=False))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


# -------------------------------------------------- forward and gradients
@pytest.mark.parametrize("impl", ["ref", "xla", "pallas", "cad"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    """Logits with a memory under every route against the reference's same
    route (``pallas``: the memory of 24 divides its block, and the flash
    kernels' plain versions run; ``cad``: cross-attention and the encoder
    take the non-plan ``xla`` route, the causal self-attention the plan)."""
    cfg_j, cfg_t, params, batch_j, batch_t, ctx_j, ctx_t = _setup(arch,
                                                                  impl)
    want, _, _ = _jax_run(cfg_j, params, batch_j, ctx_j, grads=False)
    got, _, _ = _torch_run(load_jax_params(cfg_t, params), batch_t, ctx_t,
                           grads=False)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("impl", ["ref", "cad"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, impl):
    """The lm loss and every parameter's gradient, ``xw*``, ``xgate`` and
    the encoder's included, against ``jax.value_and_grad``."""
    cfg_j, cfg_t, params, batch_j, batch_t, ctx_j, ctx_t = _setup(arch,
                                                                  impl)
    _, loss_j, grads_j = _jax_run(cfg_j, params, batch_j, ctx_j)
    _, loss_t, grads_t = _torch_run(load_jax_params(cfg_t, params), batch_t,
                                    ctx_t)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = params_from_jax(params_to_numpy(grads_j), cfg_t)
    assert sorted(want) == sorted(grads_t)
    cross = [n for n in want if ".attn.x" in n]
    assert any(n.endswith(".xgate") for n in cross)
    assert any(n.startswith("enc_layers.") for n in want)
    for name, g in grads_t.items():
        w = to_numpy(want[name])
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        assert np.abs(to_numpy(g) - w).max() <= tol, name
    # with the gate open, cross-attention's weights learn
    assert all(float(grads_t[n].abs().max()) > 0 for n in cross)


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_mask_matches_reference(arch):
    """``memory_mask`` (honoured in training only) hides memory rows from
    every query, as in the reference; it changes the logits."""
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    params = gated_params(cfg_j)
    batch = small_batch(cfg_t)
    mask = np.ones((2, cfg_t.encoder.n_ctx), np.int32)
    mask[1, 16:] = 0
    masked = dict(batch, memory_mask=mask)
    model = load_jax_params(cfg_t, params)
    for impl in ("ref", "xla"):
        want, _, _ = _jax_run(cfg_j, params, masked,
                              JCtx(attn_impl=impl, remat=False),
                              grads=False)
        got, _, _ = _torch_run(model, masked,
                               ParallelContext(attn_impl=impl, remat=False),
                               grads=False)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   err_msg=impl, **MODEL_TOL)
    plain, _, _ = _torch_run(model, batch, ParallelContext(attn_impl="ref",
                                                           remat=False),
                             grads=False)
    assert float((plain[1] - got[1]).abs().max()) > 1e-3
    np.testing.assert_allclose(to_numpy(plain[0]), to_numpy(got[0]),
                               **MODEL_TOL)


def test_xla_cross_attention_visits_the_whole_rectangle():
    """``xla_flash_attention`` with Sq != Skv, non-causal, at blocks of 8:
    every (q block, kv block) pair is visited (the triangle prune needs
    causal and Sq == Skv), padding queries (segment 0) come out 0, and
    the output and gradients agree with the reference's
    ``xla_flash_attention`` and with ``ref_attention``."""
    rng = np.random.default_rng(3)
    b, sq, m, h, dh = 2, 32, 24, 4, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, sq, h, dh), (b, m, h // 2, dh), (b, m, h // 2, dh)))
    seg_q = np.ones((b, sq), np.int32)
    seg_q[0, 28:] = 0
    pos_q = np.tile(np.arange(sq, dtype=np.int32), (b, 1))
    seg_kv = np.ones((b, m), np.int32)
    pos_kv = np.zeros((b, m), np.int32)
    opts = dict(causal=False, q_block=8, kv_block=8)
    pairs = TA._prep_blocks(*(to_torch(x) for x in (q, k, v, seg_q, pos_q,
                                                   seg_kv, pos_kv)),
                            8, 8, False, True)[7]
    assert len(pairs) == (sq // 8) * (m // 8)
    qt, kt, vt = (to_torch(x).requires_grad_() for x in (q, k, v))
    idx = [to_torch(x) for x in (seg_q, pos_q, seg_kv, pos_kv)]
    out = TA.xla_flash_attention(qt, kt, vt, *idx, **opts)
    assert float(out.detach()[0, 28:].abs().max()) == 0.0
    ref = TA.ref_attention(qt, kt, vt, *idx, causal=False)
    np.testing.assert_allclose(to_numpy(out), to_numpy(ref), **KERNEL_TOL)
    g = rng.standard_normal(out.shape).astype(np.float32)
    got = torch.autograd.grad(out, (qt, kt, vt), to_torch(g))
    want_ref = torch.autograd.grad(ref, (qt, kt, vt), to_torch(g))
    jargs = [jnp.asarray(x) for x in (seg_q, pos_q, seg_kv, pos_kv)]
    want, vjp = jax.vjp(lambda a, c, d: j_xla_flash(a, c, d, *jargs,
                                                    **opts),
                        *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(to_numpy(out), np.asarray(want), **KERNEL_TOL)
    for name, x, y, z in zip("qkv", got, vjp(jnp.asarray(g)), want_ref):
        np.testing.assert_allclose(to_numpy(x), np.asarray(y), err_msg=name,
                                   **KERNEL_TOL)
        np.testing.assert_allclose(to_numpy(x), to_numpy(z), err_msg=name,
                                   **KERNEL_TOL)


# ----------------------------------------------------------- AdamW's mask
@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_reference(arch):
    """One AdamW update of the reference on its stacked tree and of the
    port with ``convert.decay_mask`` agree; the encoder's per-layer
    vectors decay (``[n_enc_layers, d]`` leaves), ``enc_final_norm`` and
    the 0-d ``xgate`` (a ``[n_groups]`` leaf) do not."""
    import test_torch_train
    test_torch_train.test_adamw_decay_mask_matches_reference(arch)
    model = Transformer(torch_config(arch), device="cpu")
    decay = dict(zip((n for n, _ in model.named_parameters()),
                     decay_mask(model)))
    gates = [n for n in decay if n.endswith(".xgate")]
    assert gates and not any(decay[n] for n in gates)
    assert not decay["enc_final_norm.scale"]
    assert decay["enc_layers.0.norm1.scale"] and decay["enc_layers.1.attn.wq"]
    assert all(decay[n] for n in decay if ".attn.xw" in n)


# ------------------------------------------------------ the training step
def _step0_loss(cfg_t, params, policy, rotate=False):
    """Step 0's loss of ``make_train_step`` under a CAD session of
    ``policy``, the memory added to the batch (rows rotated across the
    batch with ``rotate``)."""
    pipe = PipelineConfig(**dict(PIPE, vocab_size=cfg_t.vocab_size))
    sess = CADSession.for_pipeline(cfg_t, pipe, prefetch=0,
                                   plan_policy=policy)
    model = load_jax_params(cfg_t, params)
    opt = AdamW(lr=cosine_schedule(1e-3, 1, 3), weight_decay=0.1)
    params_t = list(model.parameters())
    step = make_train_step(model, sess.context(), opt, decay_mask(model))
    batch = next(sess.attach_plans(raw_batches(pipe)))
    mem = memory_for(cfg_t, PIPE["global_batch"])
    batch["memory"] = np.roll(mem, 1, axis=0) if rotate else mem
    _, metrics = step(opt.init(params_t), batch)
    assert torch.isfinite(metrics["grad_norm"])
    return metrics["loss"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cad_train_step_with_memory(arch):
    """Inside the port: a CAD train step with a memory gives step-0 losses
    bitwise equal under ``identity`` and ``balanced`` plans (plans move
    attention, not math), while the memory rows rotated across the batch
    change it (the control that cross-attention reaches the loss)."""
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    params = gated_params(cfg_j)
    balanced = _step0_loss(cfg_t, params, "balanced")
    identity = _step0_loss(cfg_t, params, "identity")
    rotated = _step0_loss(cfg_t, params, "balanced", rotate=True)
    assert torch.equal(balanced, identity), (balanced, identity)
    # ~10 f32 ulps of the loss: far from rounding, a moved result
    assert abs(float(rotated) - float(balanced)) > 1e-5, (rotated, balanced)


def test_batch_to_device_carries_the_memory():
    """``memory`` and ``memory_mask`` reach the device batch, from host
    arrays or tensors."""
    batch = dict(tokens=np.ones((1, 4), np.int32),
                 memory=torch.ones((1, 3, 2)),
                 memory_mask=np.ones((1, 3), np.int32), memory_extra=1)
    out = batch_to_device(batch, "cpu")
    assert sorted(out) == ["memory", "memory_mask", "tokens"]
    assert out["memory"].shape == (1, 3, 2)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_configs_match_reference(arch, reduced):
    """The port's copies, field for field the reference's (the reduced
    vision config carries the reference's 2-layer encoder)."""
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    if reduced:
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.n_params() == cfg_j.n_params()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_full_width_layouts_by_shape(arch):
    """Both archs build at full size on the meta device (whisper's 32
    encoder and 32 decoder layers, vision's 40 with every 5th a cross
    layer), shaped as ``params_from_jax`` carries the reference's."""
    from repro_torch.models.convert import param_shapes
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    model = Transformer(cfg_t, device="meta")
    want = param_shapes(jax.eval_shape(
        lambda: JM.init(jax.random.PRNGKey(0), cfg_j)), cfg_t)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == want
    kinds = [blk.kind for blk in model.layers]
    assert kinds.count("cross") == (32 if arch.startswith("whisper")
                                    else 8)
    gate = "layers.4.attn.xgate" if "vision" in arch \
        else "layers.0.attn.xgate"
    assert want[gate] == ()
    assert len(getattr(model, "enc_layers", [])) == \
        (32 if arch.startswith("whisper") else 0)
