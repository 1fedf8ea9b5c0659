"""The port's training path (model forward, loss, AdamW, train step,
trainer, CAD session and launcher) against the JAX package on
``smollm-360m-reduced`` (the AdamW decay mask on recurrentgemma's too), with the reference weights carried across by
``convert.params_from_jax``: logits, loss and every gradient for
``attn_impl`` ref and cad (f32; loss rtol 1e-5, gradients rtol 1e-4), one
AdamW update, and a 3-step loss stream.  Inside the port: CAD losses are
bitwise equal across plan prefetch settings, and the step-0 loss across
plan policies (a plan moves tasks, not arithmetic)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cad import CADSession as JSession
from repro.configs import get_config as jax_config
from repro.data.pipeline import PipelineConfig as JPipe
from repro.data.pipeline import raw_batches as j_raw_batches
from repro.models import model as JM
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as j_cosine
from repro.parallel import ParallelContext as JCtx
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import train as j_train
from repro_torch.cad import CADSession
from repro_torch.configs import get_config as torch_config
from repro_torch.data.pipeline import PipelineConfig, raw_batches
from repro_torch.models.convert import decay_mask, params_from_jax
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.parallel import ParallelContext
from repro_torch.train.step import make_eval_step
from repro_torch.train.trainer import TrainConfig, train
from test_torch_helpers import (MODEL_TOL, jax_loss_and_grads,
                                load_jax_params, params_to_numpy, to_numpy,
                                torch_loss_and_grads)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m-reduced"
PIPE = dict(distribution="prolong", max_doc_len=256, seq_len=256,
            global_batch=4, n_ranks=2, seed=0)


def _setup(seed=0):
    cfg_j, cfg_t = jax_config(ARCH), torch_config(ARCH)
    params = JM.init(jax.random.PRNGKey(seed), cfg_j)
    pipe = dict(PIPE, vocab_size=cfg_j.vocab_size)
    return cfg_j, cfg_t, params, pipe


def _sessions(cfg_j, cfg_t, pipe, **kw):
    return (JSession.for_pipeline(cfg_j, JPipe(**pipe), prefetch=0, **kw),
            CADSession.for_pipeline(cfg_t, PipelineConfig(**pipe),
                                    prefetch=0, **kw))


@pytest.mark.parametrize("impl", ["ref", "cad"])
def test_forward_loss_and_gradients_match_reference(impl):
    cfg_j, cfg_t, params, pipe = _setup()
    model = load_jax_params(cfg_t, params)
    if impl == "cad":
        j_sess, t_sess = _sessions(cfg_j, cfg_t, pipe)
        batch_j = next(j_sess.attach_plans(j_raw_batches(JPipe(**pipe))))
        batch_t = next(t_sess.attach_plans(raw_batches(
            PipelineConfig(**pipe))))
        ctx_j, ctx_t = j_sess.context(), t_sess.context()
    else:
        batch_j = batch_t = next(raw_batches(PipelineConfig(**pipe)))
        ctx_j = JCtx(attn_impl="ref", remat=True)
        ctx_t = ParallelContext(attn_impl="ref", remat=True)
    loss_j, logits_j, grads_j = jax_loss_and_grads(cfg_j, params, batch_j,
                                                    ctx_j)
    loss_t, logits_t, grads_t = torch_loss_and_grads(model, batch_t, ctx_t)
    np.testing.assert_allclose(to_numpy(logits_t), np.asarray(logits_j),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    evaluated = make_eval_step(model, ctx_t)(batch_t)
    assert float(evaluated["loss"]) == float(loss_t.detach())
    want = params_from_jax(params_to_numpy(grads_j), cfg_t)
    assert sorted(want) == sorted(grads_t)
    for name, g in grads_t.items():
        np.testing.assert_allclose(to_numpy(g), to_numpy(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_adamw_update_matches_reference():
    """One update of the reference's AdamW and the port's on the same
    weights and gradients, tensor by tensor.  The reference optimizer is
    handed the port's per-layer tensors, so it decays the tensors of
    ``dim() >= 2`` among them, and the port is given that mask;
    ``test_adamw_decay_mask_matches_reference`` holds the mask of the
    trainer against the reference's own stacked tree."""
    _, cfg_t, params, _ = _setup()
    model = load_jax_params(cfg_t, params)
    names = [n for n, _ in model.named_parameters()]
    plist = [p for _, p in model.named_parameters()]
    rng = np.random.default_rng(0)
    grads = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
             for n, p in zip(names, plist)}
    # copies: jnp.asarray of a CPU tensor's numpy view shares its memory,
    # and the port's update below writes the parameters in place while
    # JAX's asynchronous update may still be reading them
    flat = {n: jnp.array(to_numpy(p), copy=True)
            for n, p in zip(names, plist)}
    j_opt = JAdamW(lr=j_cosine(1e-3, 2, 10), weight_decay=0.1)
    new_j, state_j, gnorm_j = jax.jit(j_opt.update)(
        {n: jnp.asarray(g) for n, g in grads.items()}, j_opt.init(flat),
        flat)

    opt = AdamW(lr=cosine_schedule(1e-3, 2, 10), weight_decay=0.1)
    state, gnorm = opt.update([torch.from_numpy(grads[n]) for n in names],
                              opt.init(plist), plist,
                              [p.dim() >= 2 for p in plist])
    assert state.step == 1
    np.testing.assert_allclose(float(gnorm), float(gnorm_j), rtol=1e-6)
    for label, got, want in (("param", plist, new_j),
                             ("mu", state.mu, state_j.mu),
                             ("nu", state.nu, state_j.nu)):
        for n, x in zip(names, got):
            np.testing.assert_allclose(to_numpy(x), np.asarray(want[n]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{label} {n}")


@pytest.mark.parametrize("arch", [ARCH, "recurrentgemma-9b-reduced"])
def test_adamw_decay_mask_matches_reference(arch):
    """One update of the reference's AdamW on its own layer-stacked param
    tree, and of the port's on the converted model with
    ``convert.decay_mask``: parameters, mu and nu agree after conversion.
    On the stacked tree every per-layer vector is 2-D and decays (norm
    scales; on recurrentgemma also ``lru_a`` and ``conv_b``), the
    top-level ``final_norm`` does not."""
    cfg_j, cfg_t = jax_config(arch), torch_config(arch)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    j_opt = JAdamW(lr=j_cosine(1e-3, 2, 10), weight_decay=0.1)
    new_j, state_j, gnorm_j = jax.jit(j_opt.update)(
        jax.tree.map(jnp.asarray, grads), j_opt.init(params), params)

    model = load_jax_params(cfg_t, params)
    names = [n for n, _ in model.named_parameters()]
    plist = [p for _, p in model.named_parameters()]
    decay = decay_mask(model)
    by_name = dict(zip(names, decay))
    assert not by_name["final_norm.scale"] and by_name["embed"]
    assert any(d and p.dim() == 1 for d, p in zip(decay, plist))
    g_t = params_from_jax(grads, cfg_t)
    opt = AdamW(lr=cosine_schedule(1e-3, 2, 10), weight_decay=0.1)
    state, gnorm = opt.update([g_t[n] for n in names], opt.init(plist),
                              plist, decay)
    np.testing.assert_allclose(float(gnorm), float(gnorm_j), rtol=1e-6)
    for label, got, want in (("param", plist, new_j),
                             ("mu", state.mu, state_j.mu),
                             ("nu", state.nu, state_j.nu)):
        want = params_from_jax(params_to_numpy(want), cfg_t)
        for n, x in zip(names, got):
            np.testing.assert_allclose(to_numpy(x), to_numpy(want[n]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{label} {n}")


def _torch_losses(cfg_t, params, pipe, steps=3, **session_kw):
    model = load_jax_params(cfg_t, params)
    sess = CADSession.for_pipeline(cfg_t, PipelineConfig(**pipe),
                                   **session_kw)
    res = train(cfg_t, PipelineConfig(**pipe),
                TrainConfig(steps=steps, peak_lr=1e-3, warmup=1,
                            log_every=1),
                model=model, session=sess, device="cpu")
    return [h["loss"] for h in res["history"]]


def test_three_step_loss_stream_matches_reference(capsys):
    cfg_j, cfg_t, params, pipe = _setup()
    j_sess, _ = _sessions(cfg_j, cfg_t, pipe)
    res = j_train(cfg_j, JPipe(**pipe),
                  JTrainConfig(steps=3, peak_lr=1e-3, warmup=1,
                               log_every=1),
                  params=params, session=j_sess)
    want = [h["loss"] for h in res["history"]]
    got = _torch_losses(cfg_t, params, pipe, prefetch=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cad_losses_bitwise_across_prefetch():
    _, cfg_t, params, pipe = _setup()
    assert _torch_losses(cfg_t, params, pipe, steps=2, prefetch=0) \
        == _torch_losses(cfg_t, params, pipe, steps=2, prefetch=2)


def test_step0_loss_bitwise_across_policies(record_property):
    """A plan moves tasks between servers, not arithmetic: the first
    loss (before any update) is bitwise equal under every policy.  Later
    steps sum each kv block's gradient over its tasks in plan order, so
    whether they stay bitwise equal is recorded, not asserted."""
    _, cfg_t, params, pipe = _setup()
    streams = {p: _torch_losses(cfg_t, params, pipe, steps=2, prefetch=0,
                                plan_policy=p)
               for p in ("identity", "per_doc_cp", "balanced")}
    base = streams["identity"]
    for policy, losses in streams.items():
        assert losses[0] == base[0], policy
        record_property(f"later_steps_bitwise_{policy}",
                        losses[1:] == base[1:])


def test_launcher_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "2", "--seq", "256", "--batch", "4",
         "--ranks", "2", "--cad", "--plan-policy", "balanced"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and "done: loss" in proc.stdout


# --calibrate and --stream-chunk (the first two cases until queue 1 item
# 7 was ported) work (tests/test_torch_calibration.py); their places held
# --ckpt-dir and a fault schedule under --cad, which raised until queue 1
# items 5 and 8 were ported.  The name is kept so the test's history stays
# one line: each flag now reaches the trainer's config (the run itself is
# in tests/test_torch_elastic.py).
@pytest.mark.parametrize("flag", [["--ckpt-dir", "ckpt"],
                                  ["--cad", "--fault-schedule", "kill:0@1"],
                                  ["--fault-schedule", "kill:1@1"],
                                  ["--ckpt-every", "1"], ["--trace", "t"]])
def test_launcher_raises_for_what_is_not_ported(flag, monkeypatch,
                                                tmp_path):
    import repro_torch.launch.train as launch
    from repro_torch.obs import get_recorder, set_recorder
    seen = {}

    def fake_train(cfg, pipe, tc, ctx=None, session=None, device=None,
                   **kw):
        seen.update(tc=tc, session=session)
        return {"history": [{"loss": 1.0}]}
    monkeypatch.setattr(launch, "train", fake_train)
    monkeypatch.chdir(tmp_path)            # the trace file lands here
    prev = get_recorder()
    try:
        launch.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                     *flag])
        tracing = get_recorder().enabled
    finally:
        set_recorder(prev)
    tc, cad = seen["tc"], "--cad" in flag
    assert tc.ckpt_dir == ("ckpt" if "--ckpt-dir" in flag
                           else TrainConfig().ckpt_dir)
    assert tc.ckpt_every == (1 if "--ckpt-every" in flag else 0)
    assert (seen["session"] is not None) == cad
    # a schedule reaches the trainer only with a CAD session
    assert tc.fault_schedule == (flag[-1] if cad else "")
    assert tracing == ("--trace" in flag)
    assert (tmp_path / "t").exists() == ("--trace" in flag)


@pytest.mark.parametrize("kw", [{"calibrate": True}, {"stream_chunk": 4}])
def test_session_raises_for_what_is_not_ported(kw):
    """Calibration and streaming sessions build (they raised until queue 1
    item 7 was ported), and so does an elastic pool (until item 8); the
    name is kept so the test's history stays one line.  A pool of another
    size than the session's geometry raises."""
    from repro_torch.runtime import ServerPool
    _, cfg_t, _, pipe = _setup()
    sess = CADSession.for_pipeline(cfg_t, PipelineConfig(**pipe), **kw)
    assert (sess.calibrator is not None) == bool(kw.get("calibrate"))
    assert sess.cfg.stream_chunk == kw.get("stream_chunk", 0)
    pool = ServerPool(2, calibrator=sess.calibrator)
    assert sess.with_pool(pool).pool is pool and sess.pool is None
    with pytest.raises(ValueError, match="slots"):
        sess.with_pool(ServerPool(3))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg_t, _, pipe = _setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg_t, PipelineConfig(**pipe), TrainConfig(steps=1))
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", ARCH, "--steps", "1"])
