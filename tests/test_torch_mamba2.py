"""Mamba-2 training in the port against the JAX package, on
``mamba2-370m-reduced`` (2 ssd layers, d_model 256, 16 heads of 32, d_state
32, chunk 64) with the reference weights carried across by
``convert.params_from_jax``, f32: logits under ``pallas`` (the port's
kernel route, plain versions on the CPU) and ``xla`` (the einsum route)
against the reference's within 5e-4, the reference's own limit for mamba2
(``tests/test_pallas_model_paths.py``); the kernel route's loss and
gradients against ``jax.grad`` of the reference under ``xla`` (its
``pallas`` route cannot be differentiated: the TPU kernel has no VJP);
packed-document isolation; a 3-step loss stream through ``trainer.train``
against the reference trainer; the launcher; the full-width layout; and
``cuda`` without a card."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import PipelineConfig as JPipe
from repro.models import model as JM
from repro.parallel import ParallelContext as JCtx
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import train as j_train
from repro_torch.configs import get_config as torch_config
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models.model import Transformer
from repro_torch.parallel import ParallelContext
from repro_torch.train.step import batch_to_device
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import (jax_loss_and_grads, load_jax_params,
                                params_to_numpy, to_numpy,
                                torch_loss_and_grads)

ARCH = "mamba2-370m-reduced"
# documents of 100 tokens: resets inside the 64-token chunks, padding last
PIPE = dict(distribution="pretrain", max_doc_len=100, seq_len=256,
            global_batch=2, n_ranks=1, seed=0)
LOGIT_TOL = dict(atol=5e-4, rtol=0)


def _setup():
    cfg_j, cfg_t = jax_config(ARCH), torch_config(ARCH)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    pipe = dict(PIPE, vocab_size=cfg_j.vocab_size)
    return cfg_j, cfg_t, params, pipe


def _batch(pipe):
    return next(raw_batches(PipelineConfig(**pipe)))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_logits_match_reference(impl):
    cfg_j, cfg_t, params, pipe = _setup()
    batch = _batch(pipe)
    jb = {k: jnp.asarray(batch[k]) for k in
          ("tokens", "labels", "segment_ids", "positions")}
    want, _ = JM.forward(params, cfg_j, jb, JCtx(attn_impl=impl,
                                                 remat=False))
    model = load_jax_params(cfg_t, params)
    with torch.no_grad():
        got, aux = model(batch_to_device(batch, "cpu"),
                         ParallelContext(attn_impl=impl, remat=False))
    assert aux == {}
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **LOGIT_TOL)


def test_kernel_route_gradients_match_reference():
    """The port's ``pallas`` route (``ssd_chunk`` and its hand-written
    backward) against ``jax.grad`` of the reference's einsum route, every
    weight: loss rtol 1e-5, gradients rtol 1e-4 (atol 1e-6)."""
    cfg_j, cfg_t, params, pipe = _setup()
    batch = _batch(pipe)
    loss_j, logits_j, grads_j = jax_loss_and_grads(
        cfg_j, params, batch, JCtx(attn_impl="xla", remat=True))
    loss_t, logits_t, grads_t = torch_loss_and_grads(
        load_jax_params(cfg_t, params), batch,
        ParallelContext(attn_impl="pallas", remat=True))
    np.testing.assert_allclose(to_numpy(logits_t), np.asarray(logits_j),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = convert.params_from_jax(params_to_numpy(grads_j), cfg_t)
    assert sorted(want) == sorted(grads_t)
    assert "layers.1.mixer.out_norm.scale" in want
    for name, g in grads_t.items():
        np.testing.assert_allclose(to_numpy(g), to_numpy(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_bf16_logits_agree_across_routes():
    """mamba2-370m-reduced in bf16 (weights and compute, seeded): the
    kernel route hands ``ssd_chunk`` bf16 x, B and C, whose plain versions
    on the CPU compute in f32 from the cast values, as the einsum route
    does from its f32 casts, so the two give the same logits bit for bit
    (on the card the bf16 route is the tensor-core kernels; ``chip_smoke.py``
    holds their loss gap within MAMBA_LOSS_LIMIT)."""
    cfg = dataclasses.replace(torch_config(ARCH), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Transformer(cfg, device="cpu", seed=0)
    batch = batch_to_device(_batch(dict(PIPE, vocab_size=cfg.vocab_size)),
                            "cpu")
    with torch.no_grad():
        logits = {impl: model(batch, ParallelContext(attn_impl=impl,
                                                     remat=False))[0]
                  for impl in ("pallas", "xla")}
    assert torch.isfinite(logits["pallas"]).all()
    assert torch.equal(logits["pallas"], logits["xla"])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_packed_doc_isolation(impl):
    """Packing two documents in one row gives the logits of running the
    second alone (the reset counts gate the scan, the conv taps stop at
    the boundary), as ``tests/test_models_smoke.py`` checks for the
    reference."""
    cfg = torch_config(ARCH)
    model = Transformer(cfg, device="cpu", seed=4)
    S = 96                              # a boundary inside the 2nd chunk
    rng = np.random.default_rng(5)
    t1, t2 = (torch.tensor(rng.integers(1, cfg.vocab_size, (1, S)),
                           dtype=torch.int32) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32)[None]
    packed = dict(tokens=torch.cat([t1, t2], 1),
                  segment_ids=torch.cat([torch.ones_like(t1),
                                         2 * torch.ones_like(t2)], 1),
                  positions=torch.cat([pos, pos], 1))
    # the single document padded to a chunk multiple, padding after it
    single = dict(tokens=torch.cat([t2, torch.zeros_like(t2)], 1),
                  segment_ids=torch.cat([torch.ones_like(t2),
                                         torch.zeros_like(t2)], 1),
                  positions=torch.cat([pos, pos], 1))
    ctx = ParallelContext(attn_impl=impl, remat=False)
    with torch.no_grad():
        lp, _ = model(packed, ctx)
        ls, _ = model(single, ctx)
    err = float((lp[:, S:] - ls[:, :S]).abs().max())
    assert err < 5e-4, f"doc leakage, err={err}"


def test_three_step_loss_stream_matches_reference():
    """``trainer.train`` on the kernel route against the reference trainer
    on its einsum route, same weights and batches: AdamW, schedule and
    loss included (atol 1e-4, as the dense stream in
    ``test_torch_train.py``)."""
    cfg_j, cfg_t, params, pipe = _setup()
    tc = dict(steps=3, peak_lr=1e-3, warmup=1, log_every=1)
    res = j_train(cfg_j, JPipe(**pipe), JTrainConfig(**tc),
                  ctx=JCtx(attn_impl="xla", remat=True), params=params)
    want = [h["loss"] for h in res["history"]]
    res = train(cfg_t, PipelineConfig(**pipe), TrainConfig(**tc),
                ctx=ParallelContext(attn_impl="pallas", remat=True),
                model=load_jax_params(cfg_t, params), device="cpu")
    got = [h["loss"] for h in res["history"]]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_launcher_trains_mamba2_on_the_cpu(monkeypatch, capsys):
    """``--cad`` on an attention-free arch prints the reference's note and
    trains colocated on the einsum route (``attn_impl="xla"``, as the
    reference's launcher): the kernel op is never called."""
    from repro_torch.launch.train import main
    calls = []
    monkeypatch.setattr(TL.ssd_ops, "ssd_chunk",
                        lambda **kw: calls.append(kw))
    res = main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq",
                "256", "--batch", "2", "--ranks", "2", "--cad"])
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert calls == []
    out = capsys.readouterr().out
    assert "attention-free; CAD is inapplicable" in out
    assert "done: loss" in out


def test_convert_shapes_at_full_width():
    """mamba2-370m's layout at full width, by shape only: the reference's
    init through ``jax.eval_shape`` against the port on the meta device;
    the count is ``n_params()`` plus what the analytic count leaves out
    (conv, A_log, D_skip, dt_bias, the norms)."""
    cfg_j, cfg_t = jax_config("mamba2-370m"), torch_config("mamba2-370m")
    shapes = jax.eval_shape(lambda k: JM.init(k, cfg_j),
                            jax.random.PRNGKey(0))
    want = convert.param_shapes(shapes, cfg_t)
    model = Transformer(cfg_t, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    s = cfg_t.ssm
    d_in = s.expand * cfg_t.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    extra = cfg_t.n_layers * ((s.conv_width + 1) * conv_ch + 3 * nh + d_in
                              + cfg_t.d_model) + cfg_t.d_model
    n = sum(int(np.prod(v)) for v in got.values())
    assert n == cfg_t.n_params() + extra
    assert cfg_t.n_params() == cfg_j.n_params() == 367632384


def test_transformer_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda does not raise")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Transformer(torch_config(ARCH), device="cuda")


def test_serving_mamba2_raises():
    """Serving admits ssd layers now (``ssd_decode`` and the recurrent
    cache, ``tests/test_torch_recurrent_serve.py``), and so does the
    legacy dense decode cache (``tests/test_torch_decode.py``); what still
    raises is a model on a card that is not there."""
    model = Transformer(torch_config(ARCH), device="cpu")
    assert set(model.init_cache(2, 256)["slots"][0]) == {"conv", "state"}
    assert set(model.init_cache(2, 256, layout="decode")["slots"][0]) \
        == {"conv", "state"}
