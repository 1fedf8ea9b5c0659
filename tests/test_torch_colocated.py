"""The colocated training routes of the port (``attn_impl`` ``xla`` and
``pallas``: each layer computes its own packed-document attention, no
attention servers) against the JAX package, mirroring
``tests/test_pallas_model_paths.py`` for the dense archs: logits, loss and
every weight gradient of ``smollm-360m-reduced`` and ``gemma2-2b-reduced``
(window cut to 64 so its local layers bite at S = 256) with the reference
weights carried across by ``convert.params_from_jax`` (f32; logits
``MODEL_TOL``, loss rtol 1e-5, gradients rtol 1e-4); one CAD step of
``gemma2-2b-reduced``, whose local layers take the dispatch's windowed
fallback; and the training launcher without ``--cad``."""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.cad import CADSession as JSession
from repro.configs import get_config as jax_config
from repro.data.pipeline import PipelineConfig as JPipe
from repro.data.pipeline import raw_batches as j_raw_batches
from repro.models import model as JM
from repro.parallel import ParallelContext as JCtx
from repro_torch.cad import CADSession
from repro_torch.configs import get_config as torch_config
from repro_torch.core import attention as TA
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import ParallelContext
from test_torch_helpers import (MODEL_TOL, jax_loss_and_grads,
                                load_jax_params, params_to_numpy, to_numpy,
                                torch_loss_and_grads)

ARCHS = {"smollm-360m-reduced": {}, "gemma2-2b-reduced": {"window": 64}}
PIPE = dict(distribution="prolong", max_doc_len=256, seq_len=256,
            global_batch=4, n_ranks=2, seed=0)


def _configs(arch):
    over = ARCHS[arch]
    return (dataclasses.replace(jax_config(arch), **over),
            dataclasses.replace(torch_config(arch), **over))


def _assert_match(cfg_t, got, want):
    loss_t, logits_t, grads_t = got
    loss_j, logits_j, grads_j = want
    np.testing.assert_allclose(to_numpy(logits_t), np.asarray(logits_j),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    ref = params_from_jax(params_to_numpy(grads_j), cfg_t)
    assert sorted(ref) == sorted(grads_t)
    for name, g in grads_t.items():
        np.testing.assert_allclose(to_numpy(g), to_numpy(ref[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_colocated_logits_and_grads_match_reference(arch, impl):
    cfg_j, cfg_t = _configs(arch)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    batch = next(raw_batches(PipelineConfig(
        **dict(PIPE, global_batch=2, n_ranks=1),
        vocab_size=cfg_j.vocab_size)))
    batch["segment_ids"][:, -16:] = 0           # padding rows at the end
    want = jax_loss_and_grads(cfg_j, params, batch,
                              JCtx(attn_impl=impl, remat=True))
    got = torch_loss_and_grads(load_jax_params(cfg_t, params), batch,
                               ParallelContext(attn_impl=impl, remat=True))
    _assert_match(cfg_t, got, want)


def test_cad_step_with_local_layers_matches_reference():
    """gemma2's local layers go to ``xla_flash_attention`` inside
    ``cad_attention`` (the reference's fallback), its global layers to the
    attention servers."""
    cfg_j, cfg_t = _configs("gemma2-2b-reduced")
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    pipe = dict(PIPE, vocab_size=cfg_j.vocab_size)
    j_sess = JSession.for_pipeline(cfg_j, JPipe(**pipe), prefetch=0)
    t_sess = CADSession.for_pipeline(cfg_t, PipelineConfig(**pipe),
                                     prefetch=0)
    batch_j = next(j_sess.attach_plans(j_raw_batches(JPipe(**pipe))))
    batch_t = next(t_sess.attach_plans(raw_batches(PipelineConfig(**pipe))))
    want = jax_loss_and_grads(cfg_j, params, batch_j, j_sess.context())
    got = torch_loss_and_grads(load_jax_params(cfg_t, params), batch_t,
                               t_sess.context())
    _assert_match(cfg_t, got, want)


def test_launcher_without_cad_trains_colocated_xla(monkeypatch, capsys):
    from repro_torch.launch.train import main
    calls = []
    real = TA.xla_flash_attention

    def spy(*args, **kw):
        calls.append(args[0].device.type)
        return real(*args, **kw)
    monkeypatch.setattr(TA, "xla_flash_attention", spy)
    res = main(["--arch", "smollm-360m-reduced", "--device", "cpu",
                "--steps", "2", "--seq", "256", "--batch", "2", "--ranks",
                "2"])
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    # 2 layers x (forward + remat forward) per step
    n_layers = torch_config("smollm-360m-reduced").n_layers
    assert calls == ["cpu"] * (2 * 2 * n_layers)
    assert "done: loss" in capsys.readouterr().out
