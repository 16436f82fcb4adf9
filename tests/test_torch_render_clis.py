"""The port's render-side entry points against the JAX package's, on the
CPU, with the same weights and seeded numpy inputs:

  * reference-checkpoint import: ``compat/legacy_import.import_sherf_generator``
    equals ``from_flax`` of the JAX import, key for key and bit for bit, on
    a synthetic reference (PyTorch SHERF) ``state_dict`` made here (as
    ``tests/test_legacy_import.py`` makes one, with the backbone's widths
    as arguments): the default flags, the OSG decoder, no transformer, two
    banks and one bank, 1-4 sparse-conv layers, both spconv layouts.  No
    JAX graph is compiled for it.  The default import loads into the
    port's generator with ``strict=True``; a generator of another width
    refuses it; a reference persistence pickle raises the named error;
  * the host numpy: ``_orbit_camera`` (bit-equal), ``geometry/shape.py``
    (vertices and faces equal on an analytic sphere, ``.ply`` / ``.mrc``
    byte-equal), the GIF writer (decoded by PIL here only: equal to the
    port's quantised frames, within the palette's bound of the frames);
  * the CLIs at a small size (backbone 32 with narrow channels, 2 cm
    voxels, 16x16 rays x 8 samples, budgeted with
    ``point_capacity_frac`` 0.25 as the CLIs run), the weights imported
    from one reference ``state_dict`` on both sides and the decoder's
    density bias raised by 5 (as ``tests/test_torch_e2e.py``, so that the
    frames are not empty): ``render_demo`` and three ``gen_videos`` frames
    through ``main([... "--device", "cpu", "--resume", <port checkpoint>])``
    >= 45 dB from the JAX CLIs' frames, every overflow counter 0 on both
    sides; ``query_canonical`` on a 12^3 grid (``gen_samples --shapes``,
    rtol 1e-4 of the largest |sigma|); ``debug_project``'s pixels equal to
    the JAX CLI's but for the synthetic body's SMPL f32 rounding flips
    (counted, < 1% of the pixels).

JAX graphs compiled: the generator forward at 16x16 x 8 (shared by the
demo and the three orbit frames) and ``query_canonical`` on the grid.
"""

import dataclasses
import os
import pickle
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.cli import common as j_common
from sherf_tpu.cli import debug_project as j_debug_project
from sherf_tpu.cli import gen_samples as j_gen_samples
from sherf_tpu.cli import gen_videos as j_gen_videos
from sherf_tpu.compat import legacy_import as j_legacy
from sherf_tpu.core.config import ModelConfig as JModelConfig
from sherf_tpu.core.config import RenderConfig as JRenderConfig
from sherf_tpu.core.diag import overflow_report as j_overflow_report
from sherf_tpu.data import make_synthetic_batch as j_make_batch
from sherf_tpu.geometry import shape as j_shape
from sherf_tpu.geometry.rays import get_rays_np as j_get_rays_np
from sherf_tpu.geometry.rays import near_far_aabb_np as j_near_far_aabb_np
from sherf_tpu import smpl as j_smpl
from sherf_tpu_torch.cli import common as t_common
from sherf_tpu_torch.cli import debug_project as t_debug_project
from sherf_tpu_torch.cli import gen_samples as t_gen_samples
from sherf_tpu_torch.cli import gen_videos as t_gen_videos
from sherf_tpu_torch.cli import render_demo as t_render_demo
from sherf_tpu_torch.compat import legacy_import as t_legacy
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.config import ModelConfig
from sherf_tpu_torch.data.png_read import decode_png
from sherf_tpu_torch.data.synthetic import make_synthetic_batch as t_make_batch
from sherf_tpu_torch.eval import gif as t_gif
from sherf_tpu_torch.geometry import shape as t_shape
from sherf_tpu_torch.models.generator import SHERFGenerator
from sherf_tpu_torch import smpl as t_smpl
from sherf_tpu_torch.train.checkpoint import save_checkpoint
from sherf_tpu_torch.train.train_state import create_train_state
from sherf_tpu_torch.core.config import TrainConfig

SIZE, DEPTH, FRAMES, GRID = 16, 8, 3, 12
SMALL = dict(backbone_resolution=32, channel_base=1024, channel_max=32,
             voxel_size=0.02)
IMPORT_SMALL = dict(backbone_resolution=32)
DENSITY_BIAS = 5.0


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads (as ``tests/test_torch_train.py``): the suite
    runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _psnr_u8(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ------------------------------------------------ a reference state_dict

def _resnet18_sd(sd, prefix, r):
    def add(k, *shape):
        sd[prefix + k] = r.randn(*shape).astype(np.float32) * 0.05

    def bn(k, c):
        add(k + ".weight", c)
        add(k + ".bias", c)
        add(k + ".running_mean", c)
        sd[prefix + k + ".running_var"] = np.ones(c, np.float32)

    add("conv1.weight", 64, 3, 7, 7)
    bn("bn1", 64)
    chans = [64, 128, 256, 512]
    for i in range(1, 5):
        cin = chans[max(i - 2, 0)]
        cout = chans[i - 1]
        for b in range(2):
            c_in = cin if b == 0 else cout
            add(f"layer{i}.{b}.conv1.weight", cout, c_in, 3, 3)
            add(f"layer{i}.{b}.conv2.weight", cout, cout, 3, 3)
            bn(f"layer{i}.{b}.bn1", cout)
            bn(f"layer{i}.{b}.bn2", cout)
            if b == 0 and i > 1:
                add(f"layer{i}.{b}.downsample.0.weight", cout, c_in, 1, 1)
                bn(f"layer{i}.{b}.downsample.1", cout)


def _stylegan_sd(sd, prefix, r, img_resolution, channel_base, channel_max):
    def add(k, *shape):
        sd[prefix + k] = np.asarray(r.randn(*shape), np.float32) * 0.05

    for i in range(2):
        add(f"mapping.fc{i}.weight", 512, 512)
        add(f"mapping.fc{i}.bias", 512)
    add("mapping.w_avg", 512)
    res_list = [2 ** i for i in range(2, int(np.log2(img_resolution)) + 1)]
    chans = {res: min(channel_base // res, channel_max) for res in res_list}
    for res in res_list:
        c = chans[res]
        b = f"synthesis.b{res}"
        if res == 4:
            add(b + ".const", c, 4, 4)
        else:
            add(b + ".conv0.weight", c, chans[res // 2], 3, 3)
            add(b + ".conv0.bias", c)
            add(b + ".conv0.affine.weight", chans[res // 2], 512)
            add(b + ".conv0.affine.bias", chans[res // 2])
            add(b + ".conv0.noise_strength")
            add(b + ".conv0.noise_const", res, res)
        add(b + ".conv1.weight", c, c, 3, 3)
        add(b + ".conv1.bias", c)
        add(b + ".conv1.affine.weight", c, 512)
        add(b + ".conv1.affine.bias", c)
        add(b + ".conv1.noise_strength")
        add(b + ".conv1.noise_const", res, res)
        add(b + ".torgb.weight", 96, c, 1, 1)
        add(b + ".torgb.bias", 96)
        add(b + ".torgb.affine.weight", c, 512)
        add(b + ".torgb.affine.bias", c)


def reference_state_dict(backbone_resolution=256, channel_base=1024,
                         channel_max=32, spconv_layout="native", seed=0):
    """A reference TriPlaneGenerator ``state_dict`` of random numpy weights
    (both decoders' keys, every sparse-conv stage) with the backbone's
    widths as given."""
    r = np.random.RandomState(seed)
    sd = {}

    def add(k, *shape):
        sd[k] = r.randn(*shape).astype(np.float32) * 0.05

    _resnet18_sd(sd, "encoder_2d.backbone.", r)
    _resnet18_sd(sd, "encoder_2d_feature.backbone.", r)
    add("conv1d_projection.weight", 32, 96, 1)
    add("conv1d_projection.bias", 32)
    _stylegan_sd(sd, "backbone.", r, backbone_resolution, channel_base,
                 channel_max)
    add("renderer.conv1d_projection.weight", 96, 192, 1)
    add("renderer.conv1d_projection.bias", 96)
    add("renderer.conv1d_reprojection.weight", 32, 96, 1)
    add("renderer.conv1d_reprojection.bias", 32)
    # transformer (dim 32, heads 3, dim_head 16)
    t = "renderer.transformer.layers.0"
    add(t + ".0.fn.norm.weight", 32)
    add(t + ".0.fn.norm.bias", 32)
    add(t + ".0.fn.fn.to_qkv.weight", 144, 32)
    add(t + ".0.fn.fn.to_out.0.weight", 32, 48)
    add(t + ".0.fn.fn.to_out.0.bias", 32)
    add(t + ".1.fn.norm.weight", 32)
    add(t + ".1.fn.norm.bias", 32)
    add(t + ".1.fn.fn.net.0.weight", 32, 32)
    add(t + ".1.fn.fn.net.0.bias", 32)
    add(t + ".1.fn.fn.net.3.weight", 32, 32)
    add(t + ".1.fn.fn.net.3.bias", 32)
    # NeRF decoder
    dims_in = [71] + [128] * 4 + [199] + [128] * 2
    for i, din in enumerate(dims_in):
        add(f"decoder.pts_linears.{i}.weight", 128, din)
        add(f"decoder.pts_linears.{i}.bias", 128)
    add("decoder.alpha_linear.weight", 1, 128)
    add("decoder.alpha_linear.bias", 1)
    add("decoder.feature_linear.weight", 128, 128)
    add("decoder.feature_linear.bias", 128)
    add("decoder.views_linear.weight", 64, 187)
    add("decoder.views_linear.bias", 64)
    add("decoder.rgb_linear.weight", 3, 64)
    add("decoder.rgb_linear.bias", 3)
    # OSG decoder (EG3D's: 32 -> 64 -> 1 + 3)
    add("decoder.net.0.weight", 64, 32)
    add("decoder.net.0.bias", 64)
    add("decoder.net.2.weight", 4, 64)
    add("decoder.net.2.bias", 4)

    # sparse conv net: spconv's native (out, kd, kh, kw, in), or (kd, kh,
    # kw, in, out)
    def sp(name, cin, cout, n):
        for i in range(n):
            c_in = cin if i == 0 else cout
            key = f"renderer.encoder_3d.{name}.{3 * i}.weight"
            add(key, cout, 3, 3, 3, c_in)
            if spconv_layout != "native":
                sd[key] = np.ascontiguousarray(
                    np.transpose(sd[key], (1, 2, 3, 4, 0)))
            bn = f"renderer.encoder_3d.{name}.{3 * i + 1}"
            add(bn + ".weight", cout)
            add(bn + ".bias", cout)
            add(bn + ".running_mean", cout)
            sd[bn + ".running_var"] = np.ones(cout, np.float32)
    sp("conv0", 32, 32, 2)
    sp("down0", 32, 32, 1)
    sp("conv1", 32, 32, 2)
    sp("down1", 32, 64, 1)
    sp("conv2", 64, 64, 3)
    sp("down2", 64, 96, 1)
    sp("conv3", 96, 96, 3)
    return sd


def write_reference_pickle(path, sd):
    """``sd`` pickled as the reference's networks dict {'G_ema': module}:
    an ``nn.Module`` whose ``state_dict()`` is ``sd``."""
    root = torch.nn.Module()
    for key, arr in sd.items():
        *mods, leaf = key.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, torch.nn.Module())
            node = getattr(node, m)
        node.register_buffer(leaf, torch.from_numpy(np.array(arr)))
    with open(path, "wb") as f:
        pickle.dump({"G_ema": root}, f)


def _jax_import(sd, **kwargs):
    params, stats, noise, ema = j_legacy.import_sherf_generator(sd, **kwargs)
    return jax.device_get({"params": params, "batch_stats": stats,
                           "noise": noise, "ema": ema})


# ------------------------------------------------ import

@pytest.fixture(scope="module")
def ref_sd():
    return reference_state_dict()


IMPORT_CASES = {
    "default": {},
    "osg_decoder": dict(use_nerf_decoder=False),
    "no_transformer": dict(use_trans=False),
    "two_banks": dict(use_3d_feature=False),
    "one_bank": dict(use_2d_feature=False, use_3d_feature=False),
    "sparse_layers_1": dict(sparse_layers=1),
    "sparse_layers_2": dict(sparse_layers=2),
    "sparse_layers_3": dict(sparse_layers=3),
    "sparse_layers_4": dict(sparse_layers=4),
    "spconv_flat_layout": dict(spconv_layout="flat"),
}


@pytest.mark.parametrize("case", list(IMPORT_CASES))
def test_import_equals_jax_import(ref_sd, case):
    kw = IMPORT_CASES[case]
    sd = (reference_state_dict(spconv_layout="flat")
          if kw.get("spconv_layout") == "flat" else ref_sd)
    got = t_legacy.import_sherf_generator(sd, **kw)
    ref = from_flax(_jax_import(sd, **kw))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    if "sparse_layers" in kw:
        stages = {k.split(".")[2] for k in got
                  if k.startswith("renderer.encoder_3d.")}
        assert len(stages) == min(2 * kw["sparse_layers"], 7)


def test_import_loads_strict_and_refuses_other_widths(ref_sd):
    state = t_legacy.import_sherf_generator(ref_sd)
    wide = dict(channel_base=1024, channel_max=32, voxel_size=0.02)
    model = SHERFGenerator(ModelConfig(**wide), out_sh=(64, 128, 64),
                           device="cpu")
    model.load_state_dict(state, strict=True)
    assert torch.equal(model.backbone.mapping.w_avg,
                       torch.from_numpy(ref_sd["backbone.mapping.w_avg"]))
    other = SHERFGenerator(ModelConfig(**dict(wide, backbone_resolution=128)),
                           out_sh=(64, 128, 64), device="cpu")
    with pytest.raises(RuntimeError, match="b256"):
        other.load_state_dict(state, strict=True)


def test_reference_pickles_load_and_persistence_pickles_name_the_module(
        tmp_path, ref_sd):
    path = str(tmp_path / "ref.pkl")
    write_reference_pickle(path, ref_sd)
    nets = t_legacy.load_reference_pickle(path)
    assert set(nets) == {"G_ema"} and set(nets["G_ema"]) == set(ref_sd)
    assert all(np.array_equal(nets["G_ema"][k], v) for k, v in ref_sd.items())
    # a mapping of arrays loads too
    with open(tmp_path / "sd.pkl", "wb") as f:
        pickle.dump({"G": {"w": np.ones(3, np.float32)}}, f)
    assert list(t_legacy.load_reference_pickle(str(tmp_path / "sd.pkl"))) == ["G"]

    # a persistence pickle: its first object is rebuilt by the reference's
    # torch_utils.persistence, which is not installed
    mod = types.ModuleType("torch_utils.persistence")
    pkg = types.ModuleType("torch_utils")
    mod._reconstruct_persistent_obj = lambda meta: meta
    mod._reconstruct_persistent_obj.__module__ = "torch_utils.persistence"
    mod._reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    pkg.persistence = mod

    class Persistent:
        def __reduce__(self):
            return (mod._reconstruct_persistent_obj, ({"type": "class"},))

    sys.modules.update({"torch_utils": pkg, "torch_utils.persistence": mod})
    try:
        data = pickle.dumps({"G_ema": Persistent()})
    finally:
        del sys.modules["torch_utils"], sys.modules["torch_utils.persistence"]
    (tmp_path / "SHERF_ref.pkl").write_bytes(data)
    with pytest.raises(ModuleNotFoundError,
                       match="'torch_utils'.*reference .PyTorch SHERF. sources"):
        t_legacy.load_reference_pickle(str(tmp_path / "SHERF_ref.pkl"))


# ------------------------------------------------ host numpy

@pytest.mark.parametrize("i", range(5))
def test_orbit_camera_matches_jax(i):
    theta = 2 * np.pi * i / 5 + 0.1
    for got, ref in zip(t_gen_videos._orbit_camera(512, 384, theta),
                        j_gen_videos._orbit_camera(512, 384, theta)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _sphere(n=29, r=0.6):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(x * x + y * y + z * z) - r, 2.0 / (n - 1)


def test_shape_export_matches_jax(tmp_path):
    sdf, step = _sphere()
    for dedupe in (True, False):
        kw = dict(level=0.05, spacing=(step,) * 3, origin=(-1.0, -1.0, -1.0),
                  dedupe=dedupe)
        tv, tf = t_shape.marching_tetrahedra(sdf, **kw)
        jv, jf = j_shape.marching_tetrahedra(sdf, **kw)
        assert len(tf) > 1000
        assert np.array_equal(tv, jv) and np.array_equal(tf, jf)
    for mod, name in ((t_shape, "t"), (j_shape, "j")):
        mod.convert_sdf_samples_to_ply(sdf, [-1.0, -1.0, -1.0], step,
                                       str(tmp_path / f"{name}.ply"),
                                       offset=[0.5, 0.0, 0.0], scale=2.0)
        mod.write_mrc(str(tmp_path / f"{name}.mrc"), sdf, voxel_size=step)
    for ext in ("ply", "mrc"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    v, f = t_shape.read_ply(str(tmp_path / "t.ply"))
    assert len(f) > 1000
    assert np.array_equal(t_shape.read_mrc(str(tmp_path / "t.mrc")), sdf)


def _gif_frames(path):
    from PIL import Image
    im = Image.open(path)
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.array(im.convert("RGB")))
    return out


def test_gif_decodes_to_the_quantised_frames(tmp_path):
    """Random frames fill the LZW table (4096 codes) and clear it; the
    ramps reach every level."""
    rng = np.random.RandomState(0)
    ramp = np.stack(np.meshgrid(np.arange(256), np.arange(96),
                                indexing="xy"), -1)
    frames = [rng.randint(0, 256, (96, 256, 3)).astype(np.uint8),
              np.stack([ramp[..., 0], ramp[..., 0][:, ::-1],
                        (ramp[..., 1] * 2) % 256], -1).astype(np.uint8),
              np.zeros((96, 256, 3), np.uint8)]
    t_gif.write_gif(str(tmp_path / "a.gif"), frames)
    dec = _gif_frames(str(tmp_path / "a.gif"))
    assert len(dec) == len(frames)
    for d, f in zip(dec, frames):
        assert np.array_equal(d, t_gif.quantize(f))
        err = np.abs(d.astype(int) - f.astype(int)).reshape(-1, 3).max(0)
        assert np.all(err <= np.asarray(t_gif.QUANT_BOUND)), err
    # the bound is reached: it is the palette's, not a loose one
    assert tuple(np.abs(dec[1].astype(int) - frames[1]).reshape(-1, 3).max(0)
                 ) == t_gif.QUANT_BOUND


# ------------------------------------------------ the CLIs

def _small_build(cfg, smpl, device="cuda"):
    return t_common.build_model(dataclasses.replace(cfg, **SMALL), smpl,
                                device=device)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Weights imported from one reference state_dict on both sides; the
    port's written as a port checkpoint; the JAX forward compiled once."""
    tmp = tmp_path_factory.mktemp("render_clis")
    sd = reference_state_dict(backbone_resolution=32, seed=3)
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    tcfg = dataclasses.replace(t_common.render_cli_config(DEPTH), **SMALL)
    model, _, tcfg = t_common.build_model(tcfg, ts, device="cpu")
    model.load_state_dict(t_legacy.import_sherf_generator(sd, **IMPORT_SMALL),
                          strict=True)
    with torch.no_grad():
        model.renderer.decoder.alpha.bias += DENSITY_BIAS
    ckpt = save_checkpoint(str(tmp / "ckpt"),
                           create_train_state(model, TrainConfig()))
    jcfg = JModelConfig(**SMALL, render=JRenderConfig(
        depth_resolution=DEPTH, point_capacity_frac=0.25, density_noise=0.0))
    jmodel, _, jcfg = j_common.build_model(jcfg, js)
    assert jcfg.sparse_caps == tcfg.sparse_caps
    v = _jax_import(sd, **IMPORT_SMALL)
    alpha = v["params"]["renderer"]["decoder"]["alpha"]
    alpha["bias"] = alpha["bias"] + DENSITY_BIAS
    fwd = jax.jit(lambda v, b: jmodel.apply(v, b, js, mutable=["diag"]))
    base = j_make_batch(js, batch_size=1, H=SIZE, W=SIZE, seed=0)
    return dict(tmp=tmp, ckpt=ckpt, js=js, jmodel=jmodel, v=v, fwd=fwd,
                base=base)


def _jax_frame(cli, batch):
    out, mv = cli["fwd"](cli["v"], batch)
    out = jax.device_get(out)
    assert all(n == 0 for n in j_overflow_report(
        jax.device_get(mv.get("diag", {}))).values())
    return out


def test_render_demo_matches_jax(cli, monkeypatch, record_property):
    monkeypatch.setattr(t_render_demo, "build_model", _small_build)
    path = str(cli["tmp"] / "demo.png")
    res = t_render_demo.main(["--out", path, "--size", str(SIZE), "--depth",
                              str(DEPTH), "--device", "cpu", "--resume",
                              cli["ckpt"]])
    assert set(res["overflow"]) >= {"point_overflow"}
    assert all(n == 0 for n in res["overflow"].values()), res["overflow"]
    got = decode_png(open(path, "rb").read())
    assert got.shape == (SIZE, 3 * SIZE, 3) and np.array_equal(got,
                                                                res["panel"])
    # the JAX CLI's panel (sherf_tpu/cli/render_demo.py:41-50) of JAX's frame
    out = _jax_frame(cli, cli["base"])
    img = np.asarray(out["image_raw"][0]) / 2.0 + 0.5
    depth = np.asarray(out["image_depth"][0])
    acc = np.asarray(out["weights_image"][0])
    assert acc.max() > 0.5
    dn = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-6)
    ref = (np.concatenate([np.clip(img, 0, 1), np.repeat(dn[..., None], 3, -1),
                           np.repeat(np.clip(acc, 0, 1)[..., None], 3, -1)],
                          axis=1) * 255).astype(np.uint8)
    psnr = _psnr_u8(got, ref)
    record_property("render_demo_psnr_db", psnr)
    assert psnr >= 45.0, psnr


def test_gen_videos_matches_jax(cli, monkeypatch, capsys, record_property):
    monkeypatch.setattr(t_gen_videos, "build_model", _small_build)
    out_mp4 = str(cli["tmp"] / "orbit.mp4")
    res = t_gen_videos.main(["--out", out_mp4, "--frames", str(FRAMES),
                             "--size", str(SIZE), "--depth", str(DEPTH),
                             "--device", "cpu", "--resume", cli["ckpt"]])
    gif_path = str(cli["tmp"] / "orbit.gif")
    assert res["path"] == gif_path and not os.path.exists(out_mp4)
    assert f"mp4 writer unavailable; wrote {gif_path}" in capsys.readouterr().out
    for ov in res["overflow"]:
        assert ov and all(n == 0 for n in ov.values()), ov
    # the JAX CLI's loop (sherf_tpu/cli/gen_videos.py:70-86) on JAX's model
    base = cli["base"]
    verts = np.asarray(base.vertices[0])
    wb = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
    psnrs = []
    for i in range(FRAMES):
        K, R, T = j_gen_videos._orbit_camera(SIZE, SIZE,
                                             2 * np.pi * i / FRAMES)
        ro, rd = j_get_rays_np(SIZE, SIZE, K, R, T)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        near, far, _ = j_near_far_aabb_np(wb, ro, rd)
        batch = base.replace(ray_o=jnp.asarray(ro)[None],
                             ray_d=jnp.asarray(rd)[None],
                             near=jnp.asarray(near)[None],
                             far=jnp.asarray(far)[None])
        img = np.asarray(_jax_frame(cli, batch)["image_raw"][0]) / 2 + 0.5
        ref = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        psnrs.append(_psnr_u8(res["frames"][i], ref))
    record_property("gen_videos_psnr_db", psnrs)
    assert min(psnrs) >= 45.0, psnrs
    # the GIF holds the frames, quantised to its palette
    dec = _gif_frames(gif_path)
    assert len(dec) == FRAMES
    for d, f in zip(dec, res["frames"]):
        assert np.array_equal(d, t_gif.quantize(f))
        assert np.all(np.abs(d.astype(int) - f).reshape(-1, 3).max(0)
                      <= np.asarray(t_gif.QUANT_BOUND))


def test_gen_samples_query_canonical_matches_jax(cli, monkeypatch,
                                                record_property):
    ref = np.asarray(j_gen_samples.sample_density_grid(
        cli["jmodel"], cli["v"], cli["base"], cli["js"], GRID))
    level = float(np.median(ref))       # an iso-level the field crosses
    monkeypatch.setattr(t_gen_samples, "build_model", _small_build)
    outdir = cli["tmp"] / "samples"
    res = t_gen_samples.main(["--outdir", str(outdir), "--seeds", "0",
                              "--size", str(SIZE), "--depth", str(DEPTH),
                              "--shapes", "--shape_res", str(GRID),
                              "--shape_level", repr(level), "--device", "cpu",
                              "--resume", cli["ckpt"]])
    assert all(n == 0 for n in res[0]["overflow"].values())
    (chunk_ov,) = res[0]["chunk_overflow"]          # 12^3 < one chunk
    assert set(chunk_ov) == {"site_overflow"} and chunk_ov["site_overflow"] == 0
    png = decode_png((outdir / "seed0000.png").read_bytes())
    assert png.shape == (SIZE, SIZE, 3)
    sigma = t_shape.read_mrc(str(outdir / "seed0000.mrc"))
    assert sigma.shape == ref.shape == (GRID,) * 3
    err = np.abs(sigma - ref)
    spread = float(ref.max() - ref.min())
    record_property("query_canonical_max_abs_err", float(err.max()))
    record_property("query_canonical_sigma_spread", spread)
    # the field of random weights is nearly flat (a spread of ~1% of its
    # level): the error is held to the spread as well as to the level
    assert spread > 0
    np.testing.assert_allclose(sigma, ref, rtol=1e-5, atol=1e-4 * spread)
    # the mesh is the port's marching tetrahedra of that volume, over the
    # port's own canonical bounds (1 ulp from JAX's host SMPL)
    tb = t_make_batch(t_smpl.synthetic_smpl(0, device="cpu"), batch_size=1,
                      H=SIZE, W=SIZE, seed=0, device="cpu").t_bounds[0].numpy()
    lo, hi = tb[0], tb[1]
    voxel = float((hi - lo).max()) / (GRID - 1)
    v, f = t_shape.read_ply(str(outdir / "seed0000.ply"))
    v2, f2 = t_shape.marching_tetrahedra(sigma, level=level,
                                         spacing=(voxel,) * 3, origin=lo)
    assert len(f) > 100 and np.array_equal(v, v2) and np.array_equal(f, f2)


def test_debug_project_matches_jax(tmp_path, record_property):
    j_debug_project.main(["--out", str(tmp_path / "j.png")])
    res = t_debug_project.main(["--out", str(tmp_path / "t.png"),
                                "--device", "cpu"])
    got = decode_png((tmp_path / "t.png").read_bytes())
    ref = decode_png((tmp_path / "j.png").read_bytes())
    assert got.shape == ref.shape == (256, 256, 3)
    assert np.array_equal(got, res["image"])
    red = (got == [255, 0, 0]).all(-1)
    assert red.sum() > 1000
    flips = int((got != ref).any(-1).sum())
    record_property("debug_project_pixels_differing", flips)
    assert flips < 0.01 * got.shape[0] * got.shape[1], flips


@pytest.mark.parametrize("main", [t_render_demo.main, t_gen_videos.main,
                                  t_gen_samples.main, t_debug_project.main],
                         ids=["render_demo", "gen_videos", "gen_samples",
                              "debug_project"])
def test_render_clis_default_to_cuda_and_never_fall_back(monkeypatch, main,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--out" if main is not t_gen_samples.main else "--outdir",
              str(tmp_path / "x")])
