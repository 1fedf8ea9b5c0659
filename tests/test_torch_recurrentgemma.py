"""RecurrentGemma training in the port against the JAX package, on
``recurrentgemma-9b-reduced`` (an rglru and a local layer, d_model 256,
lru_width 256, 4 q heads of 64 over 1 kv head, window 64) with the
reference weights carried across by ``convert.params_from_jax``, f32:
logits under ``pallas`` (the port's kernel route: ``lru_scan`` and the
flash kernels, plain versions on the CPU; the reference's TPU kernels in
interpret mode) and ``xla`` (the plain scan, blockwise attention) within
5e-4, as ``tests/test_torch_mamba2.py``; loss and gradients of every
weight under ``pallas`` against ``jax.grad`` of the reference's
``pallas`` route (its kernels carry custom VJPs); packed-document
isolation; a 3-step loss stream through ``trainer.train`` against the
reference trainer; the launcher; the full-width layout; ``cuda`` without
a card; and serving, which is still to come."""
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
from repro_torch.models.model import Transformer, check_arch
from repro_torch.parallel import ParallelContext
from repro_torch.train.step import batch_to_device
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import (jax_loss_and_grads, load_jax_params,
                                params_to_numpy, to_numpy,
                                torch_loss_and_grads)

ARCH = "recurrentgemma-9b-reduced"
# documents of up to 100 tokens: resets inside every row, padding last;
# seq 256 is a multiple of 128, so ``pallas`` takes the kernel route
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


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_reference(reduced):
    """The port's recurrentgemma-9b and its ``reduced()`` variant field by
    field, with the reference's parameter count; the reduced pattern is
    the compacted (rglru, local)."""
    name = "recurrentgemma-9b" + ("-reduced" if reduced else "")
    cfg_j, cfg_t = jax_config(name), torch_config(name)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.n_params() == cfg_j.n_params()
    if reduced:
        assert (cfg_t.layer_pattern, cfg_t.n_layers, cfg_t.d_model,
                cfg_t.rglru.lru_width, cfg_t.head_dim, cfg_t.window) == \
            (("rglru", "local"), 2, 256, 256, 64, 64)


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


def test_kernel_route_gradients_match_reference(monkeypatch):
    """The port's ``pallas`` route (``lru_scan`` and the flash functions,
    each with its hand-written backward) against ``jax.grad`` of the
    reference's ``pallas`` route, every weight: loss rtol 1e-5, gradients
    rtol 1e-4 (atol 1e-6).  Both ops are called once per layer."""
    calls = {"lru_scan": 0, "flash": 0}
    real_scan = TL.rglru_ops.lru_scan
    from repro_torch.kernels.packed_flash import ops as pf_ops
    real_flash = pf_ops.packed_flash_attention

    def scan(a, b):
        calls["lru_scan"] += 1
        return real_scan(a, b)

    def flash(*args, **kw):
        calls["flash"] += 1
        return real_flash(*args, **kw)
    monkeypatch.setattr(TL.rglru_ops, "lru_scan", scan)
    monkeypatch.setattr(pf_ops, "packed_flash_attention", flash)
    cfg_j, cfg_t, params, pipe = _setup()
    batch = _batch(pipe)
    loss_j, logits_j, grads_j = jax_loss_and_grads(
        cfg_j, params, batch, JCtx(attn_impl="pallas", remat=True))
    loss_t, logits_t, grads_t = torch_loss_and_grads(
        load_jax_params(cfg_t, params), batch,
        ParallelContext(attn_impl="pallas", remat=True))
    # one forward each, and once more in the backward (remat)
    assert calls == {"lru_scan": 2, "flash": 2}
    np.testing.assert_allclose(to_numpy(logits_t), np.asarray(logits_j),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = convert.params_from_jax(params_to_numpy(grads_j), cfg_t)
    assert sorted(want) == sorted(grads_t)
    assert "layers.0.mixer.lru_a" in want and "layers.1.attn.wq" in want
    for name, g in grads_t.items():
        np.testing.assert_allclose(to_numpy(g), to_numpy(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_packed_doc_isolation(impl):
    """Packing two documents in one row gives the logits of running the
    second alone (the scan resets at the boundary, the conv taps stop
    there, attention keeps to the document), as
    ``tests/test_models_smoke.py`` checks for the reference."""
    cfg = torch_config(ARCH)
    model = Transformer(cfg, device="cpu", seed=4)
    S = 128
    rng = np.random.default_rng(5)
    t1, t2 = (torch.tensor(rng.integers(1, cfg.vocab_size, (1, S)),
                           dtype=torch.int32) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32)[None]
    packed = dict(tokens=torch.cat([t1, t2], 1),
                  segment_ids=torch.cat([torch.ones_like(t1),
                                         2 * torch.ones_like(t2)], 1),
                  positions=torch.cat([pos, pos], 1))
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
    on its ``pallas`` route, same weights and batches: AdamW, schedule and
    loss included, with the default weight decay (atol 1e-4, as the
    dense stream in ``test_torch_train.py``)."""
    cfg_j, cfg_t, params, pipe = _setup()
    tc = dict(steps=3, peak_lr=1e-3, warmup=1, log_every=1)
    res = j_train(cfg_j, JPipe(**pipe), JTrainConfig(**tc),
                  ctx=JCtx(attn_impl="pallas", remat=True), params=params)
    want = [h["loss"] for h in res["history"]]
    res = train(cfg_t, PipelineConfig(**pipe), TrainConfig(**tc),
                ctx=ParallelContext(attn_impl="pallas", remat=True),
                model=load_jax_params(cfg_t, params), device="cpu")
    got = [h["loss"] for h in res["history"]]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cad", [False, True])
def test_launcher_trains_recurrentgemma_on_the_cpu(monkeypatch, capsys,
                                                   cad):
    """The launcher trains on ``attn_impl="xla"`` as the reference's does:
    without --cad colocated, with --cad through the attention service,
    whose dispatch sends windowed layers to the blockwise fallback.  The
    recurrence takes the plain route either way: ``lru_scan`` is never
    called."""
    from repro_torch.launch.train import main
    calls = []
    monkeypatch.setattr(TL.rglru_ops, "lru_scan",
                        lambda *a: calls.append(a))
    res = main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq",
                "256", "--batch", "2", "--ranks", "2"]
               + (["--cad"] if cad else []))
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert calls == []
    assert "done: loss" in capsys.readouterr().out


def test_convert_shapes_at_full_width():
    """recurrentgemma-9b's layout at full width, by shape only: the
    reference's init through ``jax.eval_shape`` against the port on the
    meta device; the count is ``n_params()`` plus what the analytic count
    leaves out (the rglru convs, the norms)."""
    cfg_j = jax_config("recurrentgemma-9b")
    cfg_t = torch_config("recurrentgemma-9b")
    shapes = jax.eval_shape(lambda k: JM.init(k, cfg_j),
                            jax.random.PRNGKey(0))
    want = convert.param_shapes(shapes, cfg_t)
    model = Transformer(cfg_t, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["layers.0.mixer.w_input_gate"] == (4096, 4096)
    assert got["layers.2.attn.wk"] == (4096, 256)
    w, d, L = 4096, cfg_t.d_model, cfg_t.n_layers
    n_rglru = sum(k == "rglru" for k in cfg_t.layer_pattern) * cfg_t.n_groups
    # the conv (weights and bias) of each rglru layer, two norms a layer,
    # the final norm
    extra = n_rglru * (cfg_t.rglru.conv_width + 1) * w + L * 2 * d + d
    n = sum(int(np.prod(v)) for v in got.values())
    assert n == cfg_t.n_params() + extra
    assert cfg_t.n_params() == cfg_j.n_params() == 9395347456


def test_transformer_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda does not raise")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Transformer(torch_config(ARCH), device="cuda")


def test_serving_recurrentgemma_raises():
    """Serving admits rglru layers now (``rglru_decode`` and the
    recurrent cache, ``tests/test_torch_recurrent_serve.py``), and so does
    the legacy dense decode cache since the cross-attention slice: its
    local layer keeps a ring of ``min(window, max_seq)`` slots
    (``tests/test_torch_decode.py``)."""
    check_arch(torch_config("recurrentgemma-9b"))
    model = Transformer(torch_config(ARCH), device="cpu")
    slots = model.init_cache(2, 256)["slots"]
    assert [set(s) for s in slots] == [{"conv", "h"}, {"k", "v"}]
    cfg = torch_config(ARCH)
    slots = model.init_cache(2, 256, layout="decode")["slots"]
    assert [set(s) for s in slots] == [{"conv", "h"}, {"k", "v", "kv_pos"}]
    assert slots[1]["k"].shape[1] == min(cfg.window, 256)
