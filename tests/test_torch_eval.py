"""The port's eval path against the JAX package's, on the CPU:

  * ``psnr_np``, ``ssim_np`` and ``crop_metrics`` on random images and
    masks: to 1e-12 (``crop_metrics`` crops by the mask's bounding box in
    numpy where the JAX package calls ``cv2.boundingRect``);
  * the port's PNG writer: decoded by imageio, its pixels equal ``to8b``;
  * ``run_eval`` with a stub renderer: 7 renders and the JAX stub's file
    names;
  * ``run_eval`` driven by the generator on the synthetic_grid rig at
    32x32x8 (``tests/test_torch_e2e.py``'s small model, shared weights, the
    decoder's density bias raised by 5): every frame >= 45 dB against JAX,
    the aggregates within the tolerance measured here (see the test), the
    same file tree;
  * trained weights: the tracked JAX snapshot
    ``runs/lifecycle/checkpoints/snapshot-003000`` bridged into the port,
    one subject100 item at 32x32x48 in f32: >= 45 dB, and a mean alpha
    well above the random-weight frame's;
  * a small lifecycle: ``training_loop`` through ``build_dataset``,
    snapshot, restore into a fresh state (EMA bit-equal), ``run_eval`` with
    the restored EMA weights;
  * the eval calibration sweep fed one batch at a time fits the budgets the
    list of its batches fits.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch

from sherf_tpu.cli.common import build_model as j_build_model
from sherf_tpu.core.config import ModelConfig as JModelConfig
from sherf_tpu.core.config import RenderConfig as JRenderConfig
from sherf_tpu.core.config import TrainConfig as JTrainConfig
from sherf_tpu.data import SyntheticHumanDataset as JGrid
from sherf_tpu.data import collate as j_collate
from sherf_tpu.eval import metrics as j_metrics
from sherf_tpu.eval import test_loop as j_test_loop
from sherf_tpu.models import SHERFGenerator as JGenerator
from sherf_tpu.train.checkpoint import restore_checkpoint as j_restore
from sherf_tpu.train.train_state import create_train_state as j_create_state
from sherf_tpu import smpl as j_smpl
from sherf_tpu_torch.cli import eval as t_cli_eval
from sherf_tpu_torch.cli.common import build_model, calibrated_config
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.config import (DataConfig, EVAL_DEFAULTS, ModelConfig,
                                         RenderConfig, TrainConfig)
from sherf_tpu_torch.data import SyntheticHumanDataset as TGrid
from sherf_tpu_torch.data import collate as t_collate
from sherf_tpu_torch.eval import metrics as t_metrics
from sherf_tpu_torch.eval import test_loop as t_test_loop
from sherf_tpu_torch.eval.png import write_png
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator
from sherf_tpu_torch import smpl as t_smpl
from sherf_tpu_torch.train import create_train_state, training_loop
from sherf_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "runs", "lifecycle", "checkpoints",
                        "snapshot-003000")
SCALING = 1 / 16
D = 8
MODEL_KW = dict(backbone_resolution=64, channel_base=1024, channel_max=32,
                voxel_size=0.02)
DENSITY_BIAS = 5.0
# run_eval over the grid: 2 poses; novel view renders views {2, 4} of both
# (view 0 is the observation), novel pose views {0, 2, 4} of pose 1
PROTO = dict(nv_pose_start=0, np_pose_start=0, pose_interval=1, pose_num=2,
             data_interval=2)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes on one
    machine (as ``tests/test_torch_train.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _psnr(a, b):
    a = (np.asarray(a) + 1) / 2
    b = (np.asarray(b) + 1) / 2
    return 10 * np.log10(1.0 / np.mean((a - b) ** 2))


def _grid_factory(cls, smpl):
    def make(root, pose_start, pose_interval, pose_num):
        return cls(root, smpl, resolution=512, image_scaling=SCALING,
                   split="test", multi_person=False, num_instance=1,
                   poses_start=pose_start, poses_interval=pose_interval,
                   poses_num=pose_num)
    return make


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _strip_value(name):
    """psnr_2731.npy -> psnr_*.npy (the value in the name may round apart)."""
    head, tail = os.path.split(name)
    if tail.endswith(".npy"):
        tail = tail.split("_")[0] + "_*.npy"
    return os.path.join(head, tail)


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    H, W = 40, 56
    gt = rng.rand(H, W, 3).astype(np.float32)
    pred = np.clip(gt + rng.randn(H, W, 3).astype(np.float32) * 0.1, 0, 1)
    mask = np.zeros((H, W), bool)
    y0, x0 = rng.randint(0, 12, 2)
    mask[y0:y0 + 20 + seed, x0:x0 + 25] = rng.rand(20 + seed, 25) < 0.8
    assert (t_metrics.psnr_np(pred, gt, mask)
            == pytest.approx(j_metrics.psnr_np(pred, gt, mask), abs=1e-12))
    assert (t_metrics.ssim_np(pred, gt)
            == pytest.approx(j_metrics.ssim_np(pred, gt), abs=1e-12))
    pm, gm = pred * mask[..., None], gt * mask[..., None]
    ts, tl = t_metrics.crop_metrics(pm, gm, mask, device="cpu")
    js, jl = j_metrics.crop_metrics(pm, gm, mask)
    assert tl is None and jl is None
    assert ts == pytest.approx(js, abs=1e-12)


def test_png_writer_decodes_to_to8b(tmp_path):
    import imageio.v2 as imageio

    img = np.random.RandomState(0).rand(33, 47, 3) * 1.4 - 0.2
    path = str(tmp_path / "x.png")
    write_png(path, t_test_loop.to8b(img))
    got = imageio.imread(path)
    np.testing.assert_array_equal(got, j_test_loop.to8b(img))
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


# ------------------------------------------------------------ run_eval

def test_run_eval_with_a_stub_renderer(tmp_path):
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    calls = {"jax": 0, "torch": 0}

    def j_render(batch):
        calls["jax"] += 1
        return {"image_raw": np.zeros_like(np.asarray(batch.img))}

    def t_render(batch):
        calls["torch"] += 1
        return {"image_raw": torch.zeros_like(batch.img)}

    kw = dict(subjects=["subject100"], obs_views=[0], obs_pose_mode="first",
              verbose=False, **PROTO)
    jr = j_test_loop.run_eval(j_render, _grid_factory(JGrid, js),
                              savedir=str(tmp_path / "jax"), **kw)
    tr = t_test_loop.run_eval(t_render, _grid_factory(TGrid, ts),
                              savedir=str(tmp_path / "torch"), device="cpu",
                              **kw)
    assert calls == {"jax": 7, "torch": 7}
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    for protocol in ("novel_view", "novel_pose"):
        assert np.isfinite(tr[protocol]["psnr"])
        assert tr[protocol]["lpips"] is None
        assert tr[protocol]["psnr"] == pytest.approx(jr[protocol]["psnr"],
                                                     abs=0.05)


@pytest.fixture(scope="module")
def shared_model():
    """JAX and port generators on the same weights (e2e's small model)."""
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    bp = t_smpl.big_pose_params()
    tv = t_smpl.smpl_forward(ts, torch.from_numpy(bp["poses"]),
                             torch.from_numpy(bp["shapes"]))[0].numpy()
    _, out_sh = prepare_voxel_volume(tv, voxel_size=MODEL_KW["voxel_size"])
    jcfg = JModelConfig(**MODEL_KW, render=JRenderConfig(depth_resolution=D,
                                                          density_noise=0.0))
    jm = JGenerator(jcfg, out_sh=out_sh)
    jb = j_collate([_grid_factory(JGrid, js)("subject100", 0, 1, 1)[0]])
    v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, js))(jb)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    v.pop("diag", None)
    v["params"]["renderer"]["decoder"]["alpha"]["bias"] += DENSITY_BIAS
    tcfg = ModelConfig(**MODEL_KW, render=RenderConfig(depth_resolution=D,
                                                      density_noise=0.0))
    tm = SHERFGenerator(tcfg, out_sh=out_sh, device="cpu").eval()
    tm.load_state_dict(from_flax(v), strict=True)
    return dict(js=js, ts=ts, jm=jm, v=v, tm=tm)


def test_run_eval_driven_by_the_model_matches_jax(shared_model, tmp_path,
                                                  record_property):
    js, ts, jm, v, tm = (shared_model[k] for k in ("js", "ts", "jm", "v", "tm"))
    j_apply = jax.jit(lambda b: jm.apply(v, b, js))
    j_imgs, t_imgs = [], []

    def j_render(batch):
        out = jax.device_get(j_apply(batch))
        j_imgs.append(np.asarray(out["image_raw"]))
        return out

    @torch.no_grad()
    def t_render(batch):
        out, diag = tm(batch, ts)
        assert all(int(n) == 0 for n in diag.values())
        t_imgs.append(out["image_raw"].numpy())
        return out

    kw = dict(subjects=["subject100"], obs_views=[0], verbose=False, **PROTO)
    jr = j_test_loop.run_eval(j_render, _grid_factory(JGrid, js),
                              savedir=str(tmp_path / "jax"), **kw)
    tr = t_test_loop.run_eval(t_render, _grid_factory(TGrid, ts),
                              savedir=str(tmp_path / "torch"), device="cpu",
                              **kw)
    assert len(t_imgs) == len(j_imgs) == 7
    psnrs = [_psnr(a, b) for a, b in zip(t_imgs, j_imgs)]
    record_property("frame_psnr_db_min", float(min(psnrs)))
    assert min(psnrs) >= 45.0, psnrs
    assert max(float(((a + 1) / 2).max()) for a in t_imgs) > 0.3  # not blank
    # aggregates: the frames differ by f32 rounding (147 dB at worst) and
    # no splat pixel flips on this scene; measured |dPSNR| 3.6e-7 dB and
    # |dSSIM| 1.2e-8, held to 1e-3 dB and 1e-5
    for protocol in ("novel_view", "novel_pose"):
        record_property(f"{protocol}_dpsnr",
                        tr[protocol]["psnr"] - jr[protocol]["psnr"])
        record_property(f"{protocol}_dssim",
                        tr[protocol]["ssim"] - jr[protocol]["ssim"])
        assert tr[protocol]["psnr"] == pytest.approx(jr[protocol]["psnr"],
                                                     abs=1e-3)
        assert tr[protocol]["ssim"] == pytest.approx(jr[protocol]["ssim"],
                                                     abs=1e-5)
    assert ([_strip_value(n) for n in _tree(tmp_path / "torch")]
            == [_strip_value(n) for n in _tree(tmp_path / "jax")])


# ---------------------------------------------------------- trained weights

def test_trained_snapshot_renders_like_jax(record_property):
    """The tracked JAX snapshot (trained by tools/lifecycle_artifact.sh) at
    its own model config, EMA weights, parity mode (every sample computed)."""
    opts = json.load(open(os.path.join(os.path.dirname(os.path.dirname(
        SNAPSHOT)), "training_options.json")))
    jcfg = JModelConfig.from_json(opts["model"])
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(
        jcfg.render, point_capacity_frac=1.0, density_noise=0.0))
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    jm, out_sh, jcfg = j_build_model(jcfg, js)
    item = _grid_factory(JGrid, js)("subject100", 0, 1, 4)[2 * 6 + 2]
    jb = j_collate([item])
    abstract = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b, js),
                              jb)
    params = dict(abstract).pop("params")
    extra = {k: x for k, x in abstract.items() if k != "params"}
    state = jax.eval_shape(lambda p, e: j_create_state(p, e, JTrainConfig()),
                           params, extra)
    state = j_restore(SNAPSHOT, state)
    assert int(state.step) == 3000
    variables = {"params": state.ema_params,
                 **{k: x for k, x in state.extra_vars.items() if k != "diag"}}
    jo = jax.device_get(jax.jit(lambda v, b: jm.apply(v, b, js))(variables, jb))

    tcfg = ModelConfig.from_json(opts["model"])
    tcfg = dataclasses.replace(tcfg, render=dataclasses.replace(
        tcfg.render, point_capacity_frac=1.0, density_noise=0.0))
    tm, t_out_sh, tcfg = build_model(tcfg, ts, device="cpu")
    assert t_out_sh == tuple(out_sh)
    assert tuple(tcfg.sparse_caps) == tuple(jcfg.sparse_caps)
    tm.load_state_dict(from_flax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(variables))), strict=True)
    with torch.no_grad():
        to, diag = tm.eval()(t_collate([item], device="cpu"), ts)
    assert all(int(n) == 0 for n in diag.values())
    psnr = _psnr(to["image_raw"].numpy(), jo["image_raw"])
    alpha = float(to["weights_image"].mean())
    record_property("psnr_db", float(psnr))
    record_property("mean_alpha", alpha)
    assert psnr >= 45.0
    # the random-weight production frame's mean alpha is 0.0014 (PERF.md)
    assert alpha > 0.01
    np.testing.assert_allclose(alpha, float(np.mean(jo["weights_image"])),
                               rtol=1e-3)


# ---------------------------------------------------------- the lifecycle

def test_lifecycle_train_snapshot_restore_eval(tmp_path):
    ts = t_smpl.synthetic_smpl(0, device="cpu")
    cfg = ModelConfig(backbone_resolution=32, channel_base=1024, channel_max=32,
                      voxel_size=0.02,
                      render=RenderConfig(depth_resolution=4,
                                          point_capacity_frac=0.5))
    tcfg = TrainConfig(batch_size=1, total_kimg=0.002, report_imgs=1, lr=1e-3,
                       outdir=str(tmp_path / "run"))
    dcfg = DataConfig(name="synthetic_grid", num_instance=2, poses_num=2,
                      image_scaling=SCALING, num_workers=2)
    state = training_loop(cfg, tcfg, dcfg, ts, device="cpu")
    assert state.step == 2
    assert os.path.exists(tmp_path / "run" / "fakes000002.png")
    path = latest_checkpoint(str(tmp_path / "run" / "checkpoints"))

    model = SHERFGenerator(state.model.cfg, out_sh=state.model.renderer.out_sh,
                           device="cpu")
    fresh = restore_checkpoint(path, create_train_state(model, TrainConfig()))
    assert fresh.step == 2
    assert all(torch.equal(state.ema[k], fresh.ema[k]) for k in state.ema)
    t_cli_eval.load_weights(model, path, use_ema=True)
    assert all(torch.equal(p, state.ema[n]) for n, p in model.named_parameters())
    assert any(not torch.equal(p, dict(state.model.named_parameters())[n])
               for n, p in model.named_parameters())

    @torch.no_grad()
    def render(batch):
        return model.eval()(batch, ts)[0]

    res = t_test_loop.run_eval(render, _grid_factory(TGrid, ts), ["subject100"],
                               [0], str(tmp_path / "eval"), verbose=False,
                               device="cpu", **PROTO)
    names = _tree(tmp_path / "eval")
    assert sum(n.endswith("_input.png") for n in names) == 7
    assert sum(n.endswith(".npy") for n in names) == 8   # 2 x (2 + 2)
    for protocol in ("novel_view", "novel_pose"):
        assert np.isfinite(res[protocol]["psnr"])
        assert np.isfinite(res[protocol]["ssim"])


def test_calibration_sweep_one_batch_at_a_time_fits_the_list():
    ts = t_smpl.synthetic_smpl(0, device="cpu")
    cfg = ModelConfig(render=RenderConfig(depth_resolution=24))
    proto = dict(EVAL_DEFAULTS["synthetic_grid"], pose_num=2)
    sweep = t_cli_eval.calibration_sweep(_grid_factory(TGrid, ts),
                                         ["subject100"], proto, "cpu")
    as_list = list(sweep)
    assert len(as_list) == 2 * 3          # 2 poses x views 0, 2, 4
    streamed = calibrated_config(cfg, sweep, margin=1.5)
    listed = calibrated_config(cfg, as_list, margin=1.5)
    assert dataclasses.asdict(streamed) == dataclasses.asdict(listed)
    assert streamed.render.prune_step_margin != cfg.render.prune_step_margin
    with pytest.raises(TypeError, match="re-iterable"):
        calibrated_config(cfg, iter(as_list), margin=1.5)
