"""The port's four file-backed loaders and LPIPS against the JAX package's,
on the CPU, on trees that the tests write (the real datasets are not in
the repository):

  * RenderPeople, THuman, HuMMan and ZJU-MoCap: the port's items equal the
    JAX items key by key and dtype by dtype.  Images and masks are exact;
    rays, near and far within 1e-6; what comes from the host SMPL forward
    (RenderPeople's and HuMMan's vertices, their bounds, HuMMan's pelvis
    corrected Th, the canonical body) within 2e-5, the two forwards' f32
    rounding (tests/test_torch_e2e.py).  Then ``collate``.  Both
    packages' native ray paths are patched out (``prepare_rays_native``
    returns None), so both take numpy's rays; one more case holds the
    items with both native paths on (the same ``host_ops.cpp`` built with
    the same flags: bit-equal rays);
  * LPIPS: one random state dict in the ``lpips`` package's key layout,
    loaded by ``import_lpips_state_dict`` (JAX) and ``load_state_dict``
    (port): forward to rtol 1e-5, input gradients to relative L2 1e-3;
    ``reconstruction_loss`` with it on fixed arrays; ``crop_metrics``
    against JAX's; ``training_loop`` builds ``lpips_fn`` exactly when
    ``SHERF_LPIPS_WEIGHTS`` names a file; the port's ``run_eval`` on the
    THuman tree writes ``lpips_*.npy``.
"""

import io
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import sherf_tpu.native as j_native
import sherf_tpu_torch.native as t_native
from sherf_tpu.core.config import TrainConfig as JTrainConfig
from sherf_tpu.data import DATASETS as J_DATASETS
from sherf_tpu.data import collate as j_collate
from sherf_tpu.eval import metrics as j_metrics
from sherf_tpu.train import lpips as j_lpips
from sherf_tpu.train.loss import reconstruction_loss as j_loss
from sherf_tpu import smpl as j_smpl
from sherf_tpu_torch.core.config import (DataConfig, ModelConfig,
                                         RenderConfig, TrainConfig)
from sherf_tpu_torch.data import DATASETS as T_DATASETS
from sherf_tpu_torch.data import collate as t_collate
from sherf_tpu_torch.data.base import host_smpl_verts
from sherf_tpu_torch.data.synthetic import synthetic_camera
from sherf_tpu_torch.eval import metrics as t_metrics
from sherf_tpu_torch.eval import test_loop as t_test_loop
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
from sherf_tpu_torch import smpl as t_smpl
from sherf_tpu_torch.train import loop as t_loop
from sherf_tpu_torch.train import lpips as t_lpips
from sherf_tpu_torch.train.loss import reconstruction_loss as t_loss

N_VIEWS, N_POSES = 3, 2
TH = 64           # the THuman tree's size
# keys whose values come from the host SMPL forward in RenderPeople / HuMMan
SMPL_KEYS = ("vertices", "obs_vertices", "t_vertices", "t_world_bounds")
SMPL_ATOL = 2e-5


NATIVE_RAYS = (j_native.prepare_rays_native, t_native.prepare_rays_native)


@pytest.fixture(autouse=True)
def _numpy_rays(monkeypatch):
    """Both packages on numpy's rays: the native library matches numpy
    only to a 0.999 mask agreement (tests/test_native.py)."""
    monkeypatch.setattr(j_native, "prepare_rays_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(t_native, "prepare_rays_native",
                        lambda *a, **k: None)


@pytest.fixture(scope="module")
def smpls():
    return j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")


def _image(h, w, rng):
    """A smooth RGB photo with noise: every DCT frequency gets some
    energy."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    ph = rng.rand(3, 3) * 6
    img = np.stack([np.sin(ph[c, 0] * xx + ph[c, 1] * yy + ph[c, 2])
                    for c in range(3)], -1) * 90 + 128
    img += rng.randn(h, w, 3) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


def _mask(h, w, rng):
    m = np.zeros((h, w), np.uint8)
    y0, x0 = rng.randint(2, h // 4), rng.randint(2, w // 4)
    m[y0:h - y0, x0:w - x0] = 255
    return m


def _jpeg(path, img, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path, "JPEG", quality=90, **kw)


def _png(path, arr, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, "PNG", **kw)


def _palette_mask(path, m):
    """A CIHP-style palette mask: index 1 is (0, 128, 0), whose red is 0,
    so the loaders' ``msk[..., 0]`` reads it as background; index 2 is
    (200, 0, 0), body."""
    idx = np.zeros(m.shape, np.uint8)
    idx[m != 0] = 2
    idx[: m.shape[0] // 2][m[: m.shape[0] // 2] != 0] = 1
    im = Image.fromarray(idx, "P")
    im.putpalette([0, 0, 0, 0, 128, 0, 200, 0, 0] + [0] * 759)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    im.save(path)


def _cams(H, W, rng, n=N_VIEWS, dist=False, zoom=1.0):
    cams = {"K": [], "D": [], "R": [], "T": []}
    for _ in range(n):
        K, R, T = synthetic_camera(H, W, rng)
        K[:2, :2] *= zoom
        cams["K"].append(K.astype(np.float64))
        cams["D"].append(np.array([rng.randn() * 0.05, rng.randn() * 0.02,
                                   rng.randn() * 1e-3, rng.randn() * 1e-3,
                                   0.0]) if dist else np.zeros(5))
        cams["R"].append(R.astype(np.float64))
        cams["T"].append(T.astype(np.float64))
    return cams


def _posed(ts, rng):
    pose = (rng.randn(72) * 0.2).astype(np.float32)
    shape = (rng.randn(10) * 0.2).astype(np.float32)
    return pose, shape, host_smpl_verts(ts, pose, shape)[0]


@pytest.fixture(scope="module")
def trees(tmp_path_factory, smpls):
    """One subject of each dataset in its reference layout."""
    ts = smpls[1]
    base = tmp_path_factory.mktemp("loaders")
    rng = np.random.RandomState(0)
    out = {}

    # RenderPeople: 48x48 JPEG, grey PNG masks, refit npz
    root = base / "renderpeople" / "subject_0000"
    cams = {}
    for v in range(N_VIEWS):
        K, R, T = synthetic_camera(48, 48, rng)
        cams[f"camera{v:04d}"] = {"K": K.tolist(), "R": R.tolist(),
                                  "T": T.reshape(3).tolist()}
        for p in range(N_POSES):
            _jpeg(str(root / "img" / f"camera{v:04d}" / f"{p:04d}.jpg"),
                  _image(48, 48, rng), subsampling=2)
            _png(str(root / "mask" / f"camera{v:04d}" / f"{p:04d}.png"),
                 _mask(48, 48, rng))
    with open(root / "cameras.json", "w") as f:
        json.dump(cams, f)
    os.makedirs(root / "outputs_re_fitting")
    np.savez(root / "outputs_re_fitting" / "refit_smpl_2nd.npz", smpl=dict(
        betas=(rng.randn(10) * 0.2).astype(np.float32),
        global_orient=(rng.randn(N_POSES, 3) * 0.1).astype(np.float32),
        body_pose=(rng.randn(N_POSES, 69) * 0.2).astype(np.float32),
        transl=(rng.randn(N_POSES, 3) * 0.05).astype(np.float32)))
    out["renderpeople"] = (str(root), dict(image_scaling=1.0))

    # THuman: 64x64 JPEG (4:4:4), palette masks, distorted cameras zoomed
    # in (LPIPS needs a person crop of 16 pixels or more)
    root = base / "thuman" / "subject00"
    cams = _cams(TH, TH, rng, dist=True, zoom=2.0)
    ims = []
    for p in range(N_POSES):
        pose, shape, verts = _posed(ts, rng)
        os.makedirs(root / "new_vertices", exist_ok=True)
        os.makedirs(root / "new_params_neutral", exist_ok=True)
        np.save(root / "new_vertices" / f"{p}.npy", verts)
        np.save(root / "new_params_neutral" / f"{p}.npy", dict(
            poses=pose.reshape(1, 72), shapes=shape.reshape(1, 10),
            R=np.eye(3, dtype=np.float32), Th=np.zeros((1, 3), np.float32)))
        row = []
        for v in range(N_VIEWS):
            name = f"view{v}/{p}.jpg"
            _jpeg(str(root / name), _image(TH, TH, rng), subsampling=0)
            _palette_mask(str(root / "mask_cihp" / name)[:-4] + ".png",
                          _mask(TH, TH, rng))
            row.append(name)
        ims.append({"ims": row})
    np.save(root / "annots.npy", {"cams": cams, "ims": ims})
    out["thuman"] = (str(root), dict(image_scaling=1.0))

    # HuMMan: 96x72 PNG RGB (filtered by PIL), RGBA masks; 1/3 -> 32x24
    root = base / "humman" / "p000001_a000001"
    cams = {}
    for v in range(N_VIEWS):
        K, R, T = synthetic_camera(72, 96, rng)
        cams[f"kinect_color_{v:03d}"] = {"K": K.tolist(), "R": R.tolist(),
                                         "T": T.reshape(3).tolist()}
        for p in range(N_POSES):
            _png(str(root / "kinect_color" / f"kinect_{v:03d}"
                     / f"{p:06d}.png"), _image(72, 96, rng))
            m = _mask(72, 96, rng)
            _png(str(root / "kinect_mask" / f"kinect_{v:03d}"
                     / f"{p:06d}.png"), np.stack([m, m, m, m], -1))
    with open(root / "cameras.json", "w") as f:
        json.dump(cams, f)
    os.makedirs(root / "smpl_params")
    for p in range(N_POSES):
        np.savez(root / "smpl_params" / f"{p:06d}.npz",
                 betas=(rng.randn(1, 10) * 0.2).astype(np.float32),
                 body_pose=(rng.randn(1, 69) * 0.2).astype(np.float32),
                 global_orient=(rng.randn(1, 3) * 0.3).astype(np.float32),
                 transl=(rng.randn(1, 3) * 0.05).astype(np.float32))
    out["humman"] = (str(root), dict(image_scaling=1 / 3))

    # ZJU-MoCap: CoreView_313 (file-name remap), 64x64 JPEG (4:2:0), T in
    # mm, Rh; scaled by 0.5 -> 32x32
    out["zju"] = (_zju_tree(base / "zju", ts, rng), dict(image_scaling=0.5))
    # the same with the cameras zoomed in, so that the bounds' box runs off
    # the image
    out["zju_off_image"] = (
        _zju_tree(base / "zju_off_image", ts, np.random.RandomState(1),
                  zoom=1.6), dict(image_scaling=0.5))
    return out


def _zju_tree(base, ts, rng, zoom=1.0):
    root = base / "CoreView_313"
    cams = _cams(64, 64, rng, zoom=zoom)
    cams["T"] = [t * 1000.0 for t in cams["T"]]
    ims = []
    for p in range(N_POSES):
        pose, shape, verts = _posed(ts, rng)
        os.makedirs(root / "new_vertices", exist_ok=True)
        os.makedirs(root / "new_params", exist_ok=True)
        np.save(root / "new_vertices" / f"{p}.npy", verts)
        np.save(root / "new_params" / f"{p}.npy", dict(
            poses=pose.reshape(1, 72), shapes=shape.reshape(1, 10),
            Rh=(rng.randn(1, 3) * 0.3), Th=(rng.randn(1, 3) * 0.05)))
        # the loader keeps its 20 views' names; files only for those read
        row = [f"Camera ({v + 1})/CoreView_313_Camera_({v + 1})_{p:04d}_"
               f"2019-08-23_16-08-50.592.jpg" for v in range(20)]
        for v in range(N_VIEWS):
            name = f"Camera ({v + 1})/{p:04d}.jpg"
            _jpeg(str(root / name), _image(64, 64, rng), subsampling=2)
            _png(str(root / "mask_cihp" / name)[:-4] + ".png",
                 _mask(64, 64, rng))
        ims.append({"ims": row})
    np.save(root / "annots.npy", {"cams": cams, "ims": ims})
    return str(root)


def _datasets(name, trees, smpls, tree=None, **extra):
    root, kw = trees[tree or name]
    kw = {**kw, "split": "train", "multi_person": False, "num_instance": 1,
          "poses_num": N_POSES, **extra}
    jd = J_DATASETS[name](root, smpls[0], **kw)
    td = T_DATASETS[name](root, smpls[1], **kw)
    for ds in (jd, td):
        ds.camera_view_num = N_VIEWS
        ds.obs_view_index = 1
    return jd, td


def _assert_item_equal(name, ji, ti):
    assert set(ji) == set(ti)
    smpl_made = name in ("renderpeople", "humman")
    for key in ji:
        jv, tv = ji[key], ti[key]
        if isinstance(jv, dict):
            assert set(jv) == set(tv), key
            for f in jv:
                a, b = np.asarray(jv[f]), np.asarray(tv[f])
                assert a.dtype == b.dtype, (key, f)
                atol = SMPL_ATOL if (smpl_made and f == "Th") else 0
                np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                           err_msg=f"{key}.{f}")
            continue
        jv, tv = np.asarray(jv), np.asarray(tv)
        assert jv.dtype == tv.dtype and jv.shape == tv.shape, key
        if key in ("ray_o", "ray_d", "near", "far"):
            np.testing.assert_allclose(tv, jv, rtol=0,
                                       atol=SMPL_ATOL if (smpl_made and key in
                                                          ("near", "far"))
                                       else 1e-6, err_msg=key)
        elif key in SMPL_KEYS and (smpl_made or key.startswith("t_")):
            np.testing.assert_allclose(tv, jv, rtol=0, atol=SMPL_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=key)


@pytest.mark.parametrize("name", ["renderpeople", "thuman", "humman", "zju"])
def test_loader_items_match_jax(name, trees, smpls):
    # THuman / ZJU: poses_num above the poses on disk redraws the pose from
    # the dataset's rng (index 7 is pose 2 of 2)
    extra = {"poses_num": 3} if name in ("thuman", "zju") else {}
    jd, td = _datasets(name, trees, smpls, **extra)
    assert len(jd) == len(td)
    items = []
    for k in (0, len(td) - 1 if not extra else 7, 4):
        ji, ti = jd[k], td[k]
        _assert_item_equal(name, ji, ti)
        assert ti["mask_at_box"].any() and ti["bkgd_msk"].any()
        items.append((ji, ti))
    jb = jax.device_get(j_collate([j for j, _ in items]))
    tb = t_collate([t for _, t in items], device="cpu")
    for f in ("img", "obs_img", "mask_at_box", "bkgd_msk", "obs_K", "obs_R",
              "obs_T"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_allclose(tb.ray_d.numpy(), np.asarray(jb.ray_d),
                               rtol=0, atol=1e-6)
    if name in ("thuman", "zju"):
        np.testing.assert_array_equal(tb.pose.R.numpy(), np.asarray(jb.pose.R))


@pytest.mark.parametrize("name", ["thuman", "zju"])
def test_loader_items_with_native_rays_match_jax(name, trees, smpls,
                                                 monkeypatch):
    """Both packages on their native ray paths (as their loaders run
    whenever the library builds): every key held as in
    test_loader_items_match_jax, and the rays, near, far and box mask
    bit-equal (the same source, flags and machine)."""
    if j_native.lib() is None or t_native.lib() is None:
        pytest.skip("no C++ toolchain: the native libraries did not build")
    monkeypatch.setattr(j_native, "prepare_rays_native", NATIVE_RAYS[0])
    monkeypatch.setattr(t_native, "prepare_rays_native", NATIVE_RAYS[1])
    jd, td = _datasets(name, trees, smpls)
    for k in (0, len(td) - 1):
        ji, ti = jd[k], td[k]
        _assert_item_equal(name, ji, ti)
        assert ti["mask_at_box"].any()
        for key in ("ray_o", "ray_d", "near", "far", "mask_at_box"):
            np.testing.assert_array_equal(ti[key], ji[key], err_msg=key)


def test_zju_items_with_bounds_partly_off_the_image(trees, smpls):
    """Cameras zoomed in so that the bounds' box runs off the 32x32 image
    (its faces clipped as cv2 clips them): every key, ``bkgd_msk`` and
    ``img`` too, held as in test_loader_items_match_jax."""
    jd, td = _datasets("zju", trees, smpls, tree="zju_off_image")
    off = 0
    for k in range(len(td)):
        ji, ti = jd[k], td[k]
        box = ti["mask_at_box"].reshape(32, 32)
        off += bool(box[0].any() or box[-1].any() or box[:, 0].any()
                    or box[:, -1].any())
        assert ti["bkgd_msk"].any()
        _assert_item_equal("zju", ji, ti)
    assert off == len(td)


def test_palette_mask_quirk(trees, smpls):
    """CIHP palette masks read through PLTE: the body half drawn in
    (0, 128, 0) is background, the other half body, in both packages."""
    jd, td = _datasets("thuman", trees, smpls)
    ti = td[0]
    m = ti["bkgd_msk"].reshape(TH, TH)
    assert m[:TH // 2 - 2].sum() == 0 and m[TH // 2 + 2:].sum() > 0
    np.testing.assert_array_equal(m, jd[0]["bkgd_msk"].reshape(TH, TH))


# ---------------------------------------------------------------- LPIPS


@pytest.fixture(scope="module")
def lpips_sd():
    """A random state dict in the lpips package's key layout (He-scaled
    convolutions, small non-negative linear weights)."""
    rng = np.random.RandomState(7)
    sd = {}
    for k, v in t_lpips.LPIPS().state_dict().items():
        if k.startswith("scaling_layer."):
            sd[k] = v.clone()
        elif k.startswith("lins."):
            sd[k] = torch.from_numpy(
                np.abs(rng.randn(*v.shape)).astype(np.float32) * 0.1)
        elif k.endswith(".weight"):
            fan_in = int(np.prod(v.shape[1:]))
            sd[k] = torch.from_numpy((rng.randn(*v.shape)
                                      * np.sqrt(2.0 / fan_in)).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((rng.randn(*v.shape) * 0.05
                                      ).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def lpips_pair(lpips_sd):
    jp = j_lpips.import_lpips_state_dict(
        {k: v.numpy() for k, v in lpips_sd.items()})
    jm = j_lpips.LPIPS()
    tm = t_lpips.load_lpips_state_dict(t_lpips.LPIPS(), lpips_sd).eval()
    return jax.jit(lambda a, b: jm.apply({"params": jp}, a, b)), tm


@pytest.mark.parametrize("hw", [(32, 32), (64, 48)])
def test_lpips_forward_and_vjp_match_jax(lpips_pair, hw):
    j_fn, tm = lpips_pair
    rng = np.random.RandomState(hw[1])
    x = (rng.rand(2, *hw, 3) * 2 - 1).astype(np.float32)
    y = np.clip(x + rng.randn(2, *hw, 3).astype(np.float32) * 0.3, -1, 1)
    jv, vjp = jax.vjp(lambda a: j_fn(a, jnp.asarray(y)), jnp.asarray(x))
    cot = np.array([1.0, -0.5], np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv = tm(xt, torch.from_numpy(y))
    (tv * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-5)
    jg = np.asarray(jg)
    rel = np.linalg.norm(xt.grad.numpy() - jg) / np.linalg.norm(jg)
    assert rel <= 1e-3, rel


def test_lpips_on_a_crop_under_16_pixels_is_nan_as_in_jax(lpips_pair):
    """A person crop narrower than 16 pixels leaves the fifth stage empty:
    JAX's VALID pools average over nothing (NaN); the port returns NaN
    too, where torch's pool would raise."""
    j_fn, tm = lpips_pair
    x = np.zeros((1, 12, 40, 3), np.float32)
    assert np.isnan(np.asarray(j_fn(jnp.asarray(x), jnp.asarray(x)))).all()
    assert torch.isnan(tm(torch.from_numpy(x), torch.from_numpy(x))).all()


def test_reconstruction_loss_with_lpips_matches_jax(lpips_pair):
    j_fn, tm = lpips_pair
    rng = np.random.RandomState(3)
    B, H, W = 2, 32, 32
    img_raw = (rng.rand(B, H, W, 3) * 2 - 1).astype(np.float32)
    weights = rng.rand(B, H, W).astype(np.float32)
    gt = rng.rand(B, H, W, 3).astype(np.float32)
    mask = rng.rand(B, H * W) > 0.3
    bkgd = (rng.rand(B, H * W) > 0.5).astype(np.float32)
    jb = types.SimpleNamespace(img=jnp.asarray(gt), mask_at_box=jnp.asarray(mask),
                               bkgd_msk=jnp.asarray(bkgd))
    tb = types.SimpleNamespace(img=torch.from_numpy(gt),
                               mask_at_box=torch.from_numpy(mask),
                               bkgd_msk=torch.from_numpy(bkgd))
    jl, jm = j_loss({"image_raw": jnp.asarray(img_raw),
                     "weights_image": jnp.asarray(weights)}, jb, JTrainConfig(),
                    lpips_fn=j_fn)
    with torch.no_grad():
        tl, tmet = t_loss({"image_raw": torch.from_numpy(img_raw),
                           "weights_image": torch.from_numpy(weights)}, tb,
                          TrainConfig(), lpips_fn=tm)
    assert float(tmet["lpips"]) > 0
    for k in ("loss", "img_loss", "acc_loss", "ssim", "lpips", "psnr"):
        np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


@pytest.fixture
def lpips_file(lpips_sd, tmp_path, monkeypatch):
    """SHERF_LPIPS_WEIGHTS names the random state dict; both packages'
    once-only lookups start afresh (and are restored afterwards)."""
    path = str(tmp_path / "lpips_vgg.pt")
    torch.save(lpips_sd, path)
    monkeypatch.setenv("SHERF_LPIPS_WEIGHTS", path)
    for mod in (j_lpips, t_lpips):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LPIPS_PARAMS", None)
    monkeypatch.setattr(j_metrics, "_LPIPS_APPLY", None)
    monkeypatch.setattr(t_metrics, "_LPIPS", {})
    return path


def test_crop_metrics_with_lpips_match_jax(lpips_file):
    rng = np.random.RandomState(5)
    for H, W in ((40, 40), (36, 52)):
        pred = rng.rand(H, W, 3).astype(np.float32)
        gt = np.clip(pred + rng.randn(H, W, 3).astype(np.float32) * 0.1, 0, 1)
        mask = np.zeros((H, W), bool)
        mask[3:H - 2, 5:W - 4] = True
        pm, gm = pred * mask[..., None], gt * mask[..., None]
        js, jl = j_metrics.crop_metrics(pm, gm, mask)
        ts_, tl = t_metrics.crop_metrics(pm, gm, mask, device="cpu")
        assert jl is not None and tl is not None and tl > 0
        assert ts_ == pytest.approx(js, abs=1e-12)
        assert tl == pytest.approx(jl, rel=1e-5)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("with_file", [False, True], ids=["no_file", "file"])
def test_training_loop_builds_lpips_fn_when_weights_exist(
        with_file, lpips_sd, tmp_path, monkeypatch, smpls):
    if with_file:
        path = str(tmp_path / "w.pt")
        torch.save(lpips_sd, path)
        monkeypatch.setenv("SHERF_LPIPS_WEIGHTS", path)
    else:
        monkeypatch.setenv("SHERF_LPIPS_WEIGHTS", str(tmp_path / "absent.pt"))
    monkeypatch.setattr(t_lpips, "_TRIED", False)
    monkeypatch.setattr(t_lpips, "_LPIPS_PARAMS", None)
    seen = {}

    def make_train_step(model, smpl, tcfg, lpips_fn=None):
        seen["lpips_fn"] = lpips_fn
        raise _Stop

    monkeypatch.setattr(t_loop, "make_train_step", make_train_step)
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    batch = make_synthetic_batch(smpls[1], batch_size=1, H=16, W=16, seed=0,
                                 device="cpu")
    cfg = ModelConfig(backbone_resolution=32, channel_base=1024,
                      channel_max=32, voxel_size=0.02,
                      render=RenderConfig(depth_resolution=4))
    with pytest.raises(_Stop):
        t_loop.training_loop(cfg, TrainConfig(outdir=str(tmp_path / "run")),
                             DataConfig(), smpls[1],
                             batch_source=lambda: batch, device="cpu")
    fn = seen["lpips_fn"]
    assert (fn is not None) == with_file
    assert t_lpips.lpips_available() == with_file
    if with_file:
        assert isinstance(fn, t_lpips.LPIPS) and not fn.training
        assert torch.equal(fn.lins[0].model[1].weight,
                           lpips_sd["lins.0.model.1.weight"])


def test_run_eval_on_the_thuman_tree_writes_lpips(trees, smpls, lpips_file,
                                                  tmp_path):
    """The port alone (a tiny random model on the CPU): run_eval over the
    THuman tree writes lpips_*.npy beside psnr_* and ssim_*."""
    ts = smpls[1]
    bp = t_smpl.big_pose_params()
    tv = host_smpl_verts(ts, bp["poses"], bp["shapes"])[0]
    _, out_sh = prepare_voxel_volume(tv, voxel_size=0.02)
    cfg = ModelConfig(backbone_resolution=32, channel_base=1024,
                      channel_max=32, voxel_size=0.02,
                      render=RenderConfig(depth_resolution=4,
                                          density_noise=0.0))
    model = SHERFGenerator(cfg, out_sh=out_sh, device="cpu").eval()
    random_init_(model, torch.Generator().manual_seed(0))
    root, kw = trees["thuman"]

    def make_dataset(data_root, poses_start, poses_interval, poses_num):
        ds = T_DATASETS["thuman"](data_root, ts, split="test",
                                  multi_person=False, num_instance=1,
                                  poses_start=poses_start,
                                  poses_interval=poses_interval,
                                  poses_num=poses_num, **kw)
        ds.camera_view_num = N_VIEWS
        return ds

    @torch.no_grad()
    def render(batch):
        return model(batch, ts)[0]

    res = t_test_loop.run_eval(render, make_dataset, [root], [1],
                               str(tmp_path / "eval"), nv_pose_start=0,
                               np_pose_start=0, pose_interval=1,
                               pose_num=N_POSES, data_interval=2,
                               verbose=False, obs_pose_mode="first",
                               device="cpu")
    for protocol in ("novel_view", "novel_pose"):
        assert res[protocol]["lpips"] is not None
        assert np.isfinite(res[protocol]["lpips"])
        names = os.listdir(tmp_path / "eval" / protocol)
        for key in ("psnr", "ssim", "lpips"):
            assert any(n.startswith(key + "_") for n in names), (key, names)
        sub = os.listdir(tmp_path / "eval" / protocol / "obs_view_1"
                         / "subject00")
        assert any(n.startswith("lpips_") for n in sub)
