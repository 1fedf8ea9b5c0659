"""The port's checkpoints (``repro_torch.checkpoint.ckpt``): the reference's
layout (``ckpt_{step:08d}.npz`` + metadata json with ``step``, ``paths``
and ``extra.calibration``), save -> restore bitwise for bf16 and f32
tensors and the port's ``AdamWState``, in the dtypes of the target;
``latest_step``; the calibration round trip and its three no-op cases
(``tests/test_elastic.py``); calibration state crossing between the two
packages in both directions; and the trainer's ``ckpt_every``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core.cost_model import CostModel as JCost
from repro.core.cost_model import GridCalibrator as JCal
from repro_torch.cad import CADSession
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core.cost_model import CostModel, GridCalibrator
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.models.model import Transformer
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.trainer import TrainConfig, train
import test_torch_helpers  # noqa: F401  (torch on one thread)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"embed.weight": torch.randn(5, 3, generator=g)
              .to(torch.bfloat16),
              "norm.scale": torch.randn(3, generator=g),
              "out.weight": torch.randn(3, 5, generator=g)
              .to(torch.bfloat16)}
    opt = AdamWState(step=seed, mu=[torch.randn(5, 3, generator=g),
                                    torch.randn(3, generator=g)],
                     nu=[torch.rand(5, 3, generator=g),
                         torch.rand(3, generator=g)])
    return params, opt


def test_save_restore_bitwise_in_the_targets_dtypes(tmp_path):
    params, opt = _tree(3)
    fname = ckpt.save(str(tmp_path), 3, params, opt)
    assert fname.endswith("ckpt_00000003.npz")
    meta = ckpt.read_meta(str(tmp_path), 3)
    assert meta["step"] == 3 and meta["extra"] == {}
    assert meta["paths"][0] == "['params']['embed.weight']"
    assert meta["paths"][3] == "['opt_state'].step"
    assert meta["dtypes"][:4] == ["torch.bfloat16", "torch.float32",
                                  "torch.bfloat16", "int"]
    like_p, like_o = _tree(0)
    got = ckpt.restore(str(tmp_path), 3, {"params": like_p,
                                          "opt_state": like_o})
    assert isinstance(got["opt_state"], AdamWState)
    assert got["opt_state"].step == 3
    for name, t in params.items():
        r = got["params"][name]
        assert r.dtype == t.dtype and torch.equal(_bits(r), _bits(t))
    for a, b in zip(got["opt_state"].mu + got["opt_state"].nu,
                    opt.mu + opt.nu):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    # a target in f32 takes the bf16 values (exactly: bf16 -> f32)
    f32 = {k: v.float() for k, v in like_p.items()}
    got = ckpt.restore(str(tmp_path), 3, {"params": f32,
                                          "opt_state": like_o})
    assert got["params"]["embed.weight"].dtype == torch.float32
    assert torch.equal(got["params"]["embed.weight"],
                       params["embed.weight"].float())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 3, {"params": like_p})
    bad = dict(like_p, **{"norm.scale": torch.zeros(4)})
    with pytest.raises(ValueError, match="norm.scale"):
        ckpt.restore(str(tmp_path), 3, {"params": bad, "opt_state": like_o})


def test_layout_equals_reference_for_f32_arrays(tmp_path):
    """The same tree of f32 arrays saved by both packages: the same
    leaves in the same order under the same paths."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((2, 3)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    ckpt.save(str(tmp_path / "t"), 1, params)
    jckpt.save(str(tmp_path / "j"), 1, params)
    meta_t = ckpt.read_meta(str(tmp_path / "t"), 1)
    meta_j = jckpt.read_meta(str(tmp_path / "j"), 1)
    assert meta_t["paths"] == meta_j["paths"]
    assert meta_t["step"] == meta_j["step"]
    with np.load(tmp_path / "t" / "ckpt_00000001.npz") as t, \
            np.load(tmp_path / "j" / "ckpt_00000001.npz") as j:
        assert t.files == j.files
        for f in t.files:
            assert t[f].tobytes() == j[f].tobytes()


def test_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    for step in (7, 12, 8):
        ckpt.save(str(tmp_path), step, {"w": torch.ones(2)})
    assert ckpt.latest_step(str(tmp_path)) == 12


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], list):          # grids with NaN cells
            np.testing.assert_array_equal(np.asarray(a[key], float),
                                          np.asarray(b[key], float),
                                          err_msg=key)
        else:
            assert a[key] == b[key], key


def _fed(cls, cost, n=2):
    calib = cls(cost, n)
    calib.observe(128, 1024, 3e-3, server=0)
    calib.observe(128, 2048, 5e-3, server=1)
    return calib


def test_calibration_roundtrip_and_no_ops(tmp_path):
    calib = _fed(GridCalibrator, CostModel.analytic(2, 8))
    params = {"w": torch.ones(2, 2)}
    ckpt.save(str(tmp_path), 7, params, calibrator=calib)
    fresh = GridCalibrator(CostModel.analytic(2, 8), 2)
    assert ckpt.restore_calibration(str(tmp_path), 7, fresh)
    _assert_state_equal(fresh.state_dict(), calib.state_dict())
    np.testing.assert_allclose(fresh.speeds(), calib.speeds())
    # a checkpoint without calibration restores as a no-op
    ckpt.save(str(tmp_path), 8, params)
    untouched = GridCalibrator(CostModel.analytic(2, 8), 2)
    before = untouched.state_dict()
    assert not ckpt.restore_calibration(str(tmp_path), 8, untouched)
    _assert_state_equal(untouched.state_dict(), before)
    # so does a missing step
    assert not ckpt.restore_calibration(str(tmp_path), 99, untouched)
    # and a state of another pool size
    other = GridCalibrator(CostModel.analytic(2, 8), 5)
    before = other.state_dict()
    assert not ckpt.restore_calibration(str(tmp_path), 7, other)
    _assert_state_equal(other.state_dict(), before)
    with pytest.raises(ValueError):
        other.load_state_dict(calib.state_dict())


def test_calibration_state_crosses_packages(tmp_path):
    """A port checkpoint's calibration loads into the reference's
    calibrator, and a reference checkpoint's into the port's."""
    cost = CostModel.analytic(2, 8)
    jcost = JCost.from_dict(cost.to_dict())
    ours, theirs = _fed(GridCalibrator, cost), _fed(JCal, jcost)
    _assert_state_equal(ours.state_dict(), theirs.state_dict())
    ckpt.save(str(tmp_path / "t"), 1, {"w": torch.ones(2)},
              calibrator=ours)
    jckpt.save(str(tmp_path / "j"), 1, {"w": np.ones(2, np.float32)},
               calibrator=theirs)
    into_ref = JCal(jcost, 2)
    assert jckpt.restore_calibration(str(tmp_path / "t"), 1, into_ref)
    into_port = GridCalibrator(cost, 2)
    assert ckpt.restore_calibration(str(tmp_path / "j"), 1, into_port)
    _assert_state_equal(into_ref.state_dict(), ours.state_dict())
    _assert_state_equal(into_port.state_dict(), theirs.state_dict())
    np.testing.assert_array_equal(into_port.speeds(), into_ref.speeds())


def test_trainer_checkpoints_restore_bitwise(tmp_path, capsys):
    """Two CAD steps of smollm-360m-reduced in bf16 with a calibrator and
    ``ckpt_every=1``: the step-1 checkpoint restores into a fresh model
    and a fresh ``AdamWState`` bitwise, dtypes kept, the calibrator's
    state equal; a later run starts from that calibration."""
    cfg = dataclasses.replace(get_config("smollm-360m-reduced"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    pipe = PipelineConfig(distribution="prolong", max_doc_len=256,
                          seq_len=256, global_batch=4, n_ranks=2,
                          vocab_size=cfg.vocab_size, seed=0)
    sess = CADSession.for_pipeline(cfg, pipe, calibrate=True, prefetch=0)
    tc = TrainConfig(steps=2, peak_lr=1e-3, warmup=1, log_every=1,
                     ckpt_every=1, ckpt_dir=str(tmp_path),
                     calibrate_every=1)
    res = train(cfg, pipe, tc, session=sess, device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 1
    model = Transformer(cfg, device="cpu", seed=5)
    opt = AdamW().init(list(model.parameters()))
    got = ckpt.restore(str(tmp_path), 1, {"params": model.state_dict(),
                                          "opt_state": opt})
    want = res["model"].state_dict()
    assert got["params"].keys() == want.keys()
    assert all(got["params"][k].dtype == torch.bfloat16 for k in want)
    model.load_state_dict(got["params"])
    for k, v in model.state_dict().items():
        assert torch.equal(_bits(v), _bits(want[k])), k
    state = res["opt_state"]
    assert got["opt_state"].step == state.step == 2
    for a, b in zip(got["opt_state"].mu + got["opt_state"].nu,
                    state.mu + state.nu):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    saved = ckpt.read_meta(str(tmp_path), 1)["extra"]["calibration"]
    assert saved["n_obs"] > 0
    again = CADSession.for_pipeline(cfg, pipe, calibrate=True, prefetch=0)
    train(cfg, pipe, dataclasses.replace(tc, steps=1), session=again,
          device="cpu")
    assert "restored calibration state from step 1" in capsys.readouterr().out
