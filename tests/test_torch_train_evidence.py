"""The port's initial weights at its entry points, and its training-evidence
tools, on the CPU (torch only).

  * ``training_loop`` (no steps: ``total_kimg`` 0) returns the weights and
    EMA that ``init_weights_`` draws from ``tcfg.seed``;
    ``generator_weights(model, None)`` (the render CLIs' and the
    visualizer's fallback) and ``calc_metrics``' fallback draw seed 0's.
    (``init_weights_`` itself is held to the JAX package's ``model.init``
    leaf by leaf in ``tests/test_torch_train.py``.)
  * ``sherf_tpu_torch.tools.train_convergence.main`` and
    ``train_generalization.main`` at a tiny shape: one JSON line with the
    JAX tools' keys, finite values, overflow 0.  The tools build the
    default widths; here their ``ModelConfig`` and voxel grid are narrowed
    to the other port tests' small model (backbone 32, channel_max 32,
    2 cm voxels, 2 sparse-conv layers) to keep the file within seconds.
  * slow: the port's counterpart of the JAX package's
    ``tests/test_train.py::test_training_converges_on_synthetic_scene``
    (same configuration and gate) from ``init_weights_`` (seed 0).  It
    fails: that draw starts with every density at or below 0, so no
    gradient reaches the density head (with zero biases and the relu
    density clamp, JAX's draws do so too: ROADMAP Queue C,
    ``tests/torch_train_trajectories.py``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sherf_tpu_torch.cli import calc_metrics as t_calc
from sherf_tpu_torch.cli.common import generator_weights
from sherf_tpu_torch.core.config import (DataConfig, ModelConfig, RenderConfig,
                                         TrainConfig)
from sherf_tpu_torch.data.base import host_smpl_verts
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.eval import gan_metrics as t_gm
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator, init_weights_
from sherf_tpu_torch import smpl as t_smpl
from sherf_tpu_torch.tools import train_convergence as t_conv
from sherf_tpu_torch.tools import train_generalization as t_gen
from sherf_tpu_torch.train import (create_train_state, make_train_step,
                                   training_loop)
from sherf_tpu_torch.tools.train_convergence import masked_psnr

SMALL = dict(backbone_resolution=32, channel_base=1024, channel_max=32,
             voxel_size=0.02, sparse_conv_layers=2)
CONV_KEYS = {"steps", "H", "D", "psnr_curve", "start_psnr", "end_psnr",
             "final_loss", "ms_per_step"}
GEN_KEYS = {"steps", "H", "D", "subjects", "heldout_sid", "held_curve",
            "seen_curve", "held_gain_db", "max_overflow", "ms_per_step"}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads (as ``tests/test_torch_train.py``): the suite
    runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _seed_draw(model, seed):
    """``model``'s parameter names -> the values ``init_weights_`` draws
    from ``seed`` for a fresh model of its configuration."""
    fresh = SHERFGenerator(model.cfg, out_sh=model.renderer.out_sh,
                           device="cpu")
    init_weights_(fresh, torch.Generator().manual_seed(seed))
    return dict(fresh.named_parameters())


def _assert_equal_params(named, ref):
    named = dict(named)
    assert named.keys() == ref.keys()
    for k, p in named.items():
        assert torch.equal(p.detach(), ref[k].detach()), k


# ------------------------------------------------------------- the callers

def test_training_loop_starts_from_init_weights(tmp_path):
    ts = t_smpl.synthetic_smpl(0, device="cpu")
    batch = make_synthetic_batch(ts, batch_size=1, H=8, W=8, seed=0,
                                 device="cpu")
    cfg = ModelConfig(**SMALL, render=RenderConfig(depth_resolution=4))
    tcfg = TrainConfig(batch_size=1, total_kimg=0, seed=3,
                       outdir=str(tmp_path))
    state = training_loop(cfg, tcfg, DataConfig(), ts,
                          batch_source=lambda: batch, device="cpu")
    assert state.step == 0
    ref = _seed_draw(state.model, 3)
    _assert_equal_params(state.model.named_parameters(), ref)
    _assert_equal_params(state.ema, ref)


def test_generator_weights_without_resume_draw_seed_0():
    m = SHERFGenerator(ModelConfig(**SMALL), out_sh=(32, 96, 96),
                       device="cpu")
    assert generator_weights(m, None) is m
    _assert_equal_params(m.named_parameters(), _seed_draw(m, 0))


class _Drawn(Exception):
    pass


def test_calc_metrics_fallback_draws_seed_0(monkeypatch):
    """Without ``--resume`` calc_metrics scores ``init_weights_``' seed-0
    weights (stopped right after the draw)."""
    build = t_calc.model_config_from_args
    monkeypatch.setattr(t_calc, "model_config_from_args",
                        lambda a: dataclasses.replace(build(a), **SMALL))
    monkeypatch.setattr(t_gm, "default_extractor", lambda device: object())
    drawn = []

    def init_and_stop(model, generator):
        drawn.append(init_weights_(model, generator))
        raise _Drawn
    monkeypatch.setattr(t_calc, "init_weights_", init_and_stop)
    with pytest.raises(_Drawn):
        t_calc.main(["--cfg", "synthetic", "--device", "cpu"])
    (model,) = drawn
    _assert_equal_params(model.named_parameters(), _seed_draw(model, 0))


# --------------------------------------------------------------- the tools

@pytest.fixture
def small_tools(monkeypatch):
    for mod in (t_conv, t_gen):
        monkeypatch.setattr(mod, "ModelConfig", lambda **kw: ModelConfig(
            **{**kw, **SMALL, "sparse_caps": None}))
        monkeypatch.setattr(mod, "prepare_voxel_volume",
                            lambda tv: prepare_voxel_volume(tv, voxel_size=0.02))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _finite(x):
    return all(_finite(v) for v in x) if isinstance(x, list) else \
        bool(np.isfinite(x))


def test_train_convergence_tool_on_the_cpu(small_tools, capsys):
    res = t_conv.main(steps=3, H=16, D=4, eval_every=1, device="cpu")
    line = _last_json(capsys)
    assert set(line) == CONV_KEYS and res == {**line, "max_overflow": 0}
    assert (line["steps"], line["H"], line["D"]) == (3, 16, 4)
    assert [s for s, _ in line["psnr_curve"]] == [0, 1, 2, 3]
    assert line["start_psnr"] == line["psnr_curve"][0][1]
    assert line["end_psnr"] == line["psnr_curve"][-1][1]
    assert all(_finite(line[k]) for k in CONV_KEYS)


def test_train_generalization_tool_on_the_cpu(small_tools, capsys):
    res = t_gen.main(steps=2, H=16, D=4, subjects=2, n_eval=1, eval_every=1,
                     device="cpu")
    line = _last_json(capsys)
    assert line == res and set(line) == GEN_KEYS
    assert (line["subjects"], line["heldout_sid"]) == (2, 100)
    for k in ("held_curve", "seen_curve"):
        assert [s for s, _ in line[k]] == [0, 1, 2]
    assert line["held_gain_db"] == round(
        line["held_curve"][-1][1] - line["held_curve"][0][1], 2)
    assert line["max_overflow"] == 0
    assert all(_finite(line[k]) for k in GEN_KEYS)


def test_tools_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (t_conv.main, t_gen.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(steps=1)


# -------------------------------------------------------- slow: convergence

@pytest.mark.slow
def test_training_converges_on_synthetic_scene():
    """The JAX package's slow convergence test on the port: one synthetic
    16x16 image overfit for 300 steps at lr 1e-3 (backbone 32, 2 cm voxels,
    6 samples, point budget 0.5, f32) from ``init_weights_`` (seed 0); the
    JAX test's gate, masked PSNR ``end > start + 2.2 and end > 11.3``."""
    smpl = t_smpl.synthetic_smpl(0, device="cpu")
    bp = t_smpl.big_pose_params()
    t_verts = host_smpl_verts(smpl, bp["poses"], bp["shapes"])[0]
    _, out_sh = prepare_voxel_volume(t_verts, voxel_size=0.02)
    cfg = ModelConfig(backbone_resolution=32, voxel_size=0.02,
                      render=RenderConfig(depth_resolution=6,
                                          point_capacity_frac=0.5,
                                          density_noise=0.0))
    tcfg = TrainConfig(batch_size=1, lr=1e-3)
    model = SHERFGenerator(cfg, out_sh=out_sh, device="cpu")
    init_weights_(model, torch.Generator().manual_seed(0))
    batch = make_synthetic_batch(smpl, batch_size=1, H=16, W=16, seed=0,
                                 device="cpu")
    state = create_train_state(model, tcfg)
    step = make_train_step(model, smpl, tcfg)
    start = masked_psnr(model, smpl, batch)
    gen = torch.Generator().manual_seed(7)
    for i in range(300):
        metrics = step(state, batch, gen)
        assert np.isfinite(float(metrics["loss"])), f"loss blew up at {i}"
    end = masked_psnr(model, smpl, batch)
    print(f"masked PSNR {start:.2f} -> {end:.2f} dB")
    assert end > start + 2.2 and end > 11.3, (start, end)
