"""The port's generator forward against ``sherf_tpu``'s, with shared weights,
on the same synthetic batch, in parity mode (every sample computed) and in
budgeted mode (calibrated ray / point / exact budgets — the production
path).  Small shape: 32x32 rays x 8 samples, backbone 64 with narrow
channels, 2 cm voxels, batch of 2.

Gate: ``image_raw`` PSNR >= 45 dB against JAX and every overflow counter 0.
Exact agreement is not expected: on the CPU the JAX package's KNN is
``nn_1_ref`` (the |q|^2 - 2 q.v + |v|^2 expansion), while the port follows
the Pallas kernel's centred elementwise distances.  To keep the comparison
from being vacuous (random weights render almost nothing), the shared
decoder's density bias is raised by 5, so that most body rays are opaque.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.core.calibrate import calibrate_budgets as j_calibrate
from sherf_tpu.core.config import ModelConfig as JModelConfig
from sherf_tpu.core.config import RenderConfig as JRenderConfig
from sherf_tpu.core.diag import overflow_report
from sherf_tpu.data import make_synthetic_batch as j_make_batch
from sherf_tpu.models import SHERFGenerator as JGenerator
from sherf_tpu import smpl as j_smpl
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.calibrate import calibrate_budgets
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig
from sherf_tpu_torch.core.diag import overflow_report as t_overflow_report
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator
from sherf_tpu_torch import smpl as t_smpl

H = W = 32
D = 8
MODEL_KW = dict(backbone_resolution=64, channel_base=1024, channel_max=32,
                voxel_size=0.02)
DENSITY_BIAS = 5.0


def _psnr(a, b):
    a = (np.asarray(a) + 1) / 2
    b = (np.asarray(b) + 1) / 2
    return 10 * np.log10(1.0 / np.mean((a - b) ** 2))


@pytest.fixture(scope="module")
def scene():
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    bp = j_smpl.big_pose_params()
    tv = t_smpl.smpl_forward(ts, torch.from_numpy(bp["poses"]),
                             torch.from_numpy(bp["shapes"]))[0].numpy()
    _, out_sh = prepare_voxel_volume(tv, voxel_size=MODEL_KW["voxel_size"])
    jb = j_make_batch(js, batch_size=2, H=H, W=W, seed=0)
    tb = SHERFBatch.from_numpy(jax.device_get(jb))
    jcfg = JModelConfig(**MODEL_KW, render=JRenderConfig(depth_resolution=D,
                                                          density_noise=0.0))
    jm = JGenerator(jcfg, out_sh=out_sh)
    v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, js))(jb)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    v.pop("diag", None)
    v["params"]["renderer"]["decoder"]["alpha"]["bias"] += DENSITY_BIAS
    return dict(js=js, ts=ts, out_sh=out_sh, jb=jb, tb=tb, jcfg=jcfg, v=v)


def test_synthetic_batch_matches_jax():
    """Same seed, same batch: host numpy draws are identical; the SMPL
    forward differs by f32 rounding (atol 2e-5 m), and the few rays or
    splatted pixels that sit exactly on an edge may flip."""
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    jb = jax.device_get(j_make_batch(js, batch_size=2, H=24, W=24, seed=3))
    tb = make_synthetic_batch(ts, batch_size=2, H=24, W=24, seed=3, device="cpu")
    for name in ("t_vertices", "t_bounds", "vertices", "ray_o", "ray_d",
                 "obs_K", "obs_R", "obs_T"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)), atol=2e-5,
                                   err_msg=name)
    for pose in ("pose", "t_pose", "obs_pose"):
        for f in ("poses", "shapes", "R", "Th"):
            np.testing.assert_array_equal(
                getattr(getattr(tb, pose), f).numpy(),
                np.asarray(getattr(getattr(jb, pose), f)))
    mask_j = np.asarray(jb.mask_at_box)
    assert (tb.mask_at_box.numpy() != mask_j).mean() < 0.01
    same = tb.mask_at_box.numpy() == mask_j
    np.testing.assert_allclose(tb.near.numpy()[same], np.asarray(jb.near)[same],
                               atol=1e-4)
    for img in ("img", "obs_img"):
        assert (np.abs(getattr(tb, img).numpy() - np.asarray(getattr(jb, img)))
                > 1e-4).mean() < 0.01


@pytest.mark.parametrize("mode", ["parity", "budgeted"])
def test_generator_matches_jax(scene, mode, record_property):
    js, ts, v = scene["js"], scene["ts"], scene["v"]
    jcfg = scene["jcfg"]
    tcfg = ModelConfig(**MODEL_KW, render=RenderConfig(depth_resolution=D,
                                                      density_noise=0.0))
    if mode == "budgeted":
        fitted, worst = j_calibrate([scene["jb"]], jcfg, margin=1.15,
                                    round_to=128)
        t_fitted, t_worst = calibrate_budgets([scene["tb"]], tcfg, margin=1.15,
                                              round_to=128)
        assert t_worst == pytest.approx(worst)
        assert dataclasses.asdict(t_fitted) == dataclasses.asdict(fitted)
        assert fitted.point_capacity_frac < 1 and fitted.ray_capacity_frac < 1 \
            and fitted.exact_capacity_frac < 1
        jcfg = dataclasses.replace(jcfg, render=fitted)
        tcfg = dataclasses.replace(tcfg, render=t_fitted)
    jm = JGenerator(jcfg, out_sh=scene["out_sh"])
    jo, mv = jax.jit(lambda v, b: jm.apply(v, b, js, mutable=["diag"]))(
        v, scene["jb"])
    jo = jax.device_get(jo)
    assert all(n == 0 for n in overflow_report(jax.device_get(mv["diag"])).values())

    tm = SHERFGenerator(tcfg, out_sh=scene["out_sh"], device="cpu")
    tm.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        to, diag = tm.eval()(scene["tb"], ts)
    assert set(t_overflow_report(diag)) >= ({"site_overflow"} if mode == "parity" else
                         {"ray_overflow", "point_overflow", "exact_overflow",
                          "site_overflow"})
    assert all(int(n) == 0 for n in diag.values()), diag
    for k in ("image_raw", "image_depth", "weights_image"):
        assert to[k].shape == jo[k].shape
        assert bool(torch.isfinite(to[k]).all())
    acc = to["weights_image"].numpy()
    assert acc.max() > 0.5                      # the render is not vacuous
    psnr = _psnr(to["image_raw"].numpy(), jo["image_raw"])
    record_property("image_raw_psnr_db", float(psnr))
    assert psnr >= 45.0
    np.testing.assert_allclose(acc, np.asarray(jo["weights_image"]), atol=1e-2)
