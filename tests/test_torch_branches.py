"""The port's off-default model branches against the JAX package's, on the
CPU, with shared weights and seeded numpy inputs:

  * modules: ``sample_pdf`` / ``sample_importance`` in det mode (u at 0 and
    1, random, flat and all-zero weights; ``z_fine`` atol 1e-5, 1e-4 at
    u = 1, where the two cumsums' last entries round to either side of 1:
    measured 4.5e-5), and the
    random-u mode drawing from its generator only; ``capsule_radii`` (rtol
    1e-6) and ``capsule_mask`` (equal, but for points within 1e-5 of a
    capsule surface, counted and bounded); ``OSGDecoder`` (rtol 1e-5);
    ``SuperresolutionHybrid`` at 128 / 256 / 512 (rtol 1e-4) and
    ``resize_bilinear`` (atol 1e-6);
  * the generator at 16x16 rays x 6 samples (4 importance samples), batch
    1, backbone 32 with narrow channels, 2 cm voxels, two sparse-conv
    layers: the importance pass in parity and in budgeted mode, the
    capsule prune and the OSG decoder in budgeted mode, the SR head and
    the feature-bank ablations {1d, 2d}, {1d, 3d}, {2d, 3d} and
    {1d, 2d, 3d} without the transformer in parity mode: ``image_raw``
    (and the SR head's ``image``) >= 45 dB from JAX, every overflow counter
    0, and an alpha above 0.5 somewhere (the shared decoder's density bias
    is raised by 5, as in ``tests/test_torch_e2e.py``).  The calibrated
    budgets equal JAX's for a config with the importance pass.  The port
    runs its whole ``SHERFGenerator``; on the JAX side the parts every
    configuration shares (mapping, backbone, encoder, observation volume:
    the first half of ``SHERFGenerator.synthesis``, with the same weights in
    every configuration) run once, and each configuration's
    ``SHERFRenderer`` (and SR head) is applied to them: one JAX compile per
    configuration instead of two;
  * gradients of one train step with the OSG decoder and the importance
    pass (det u on both sides, no density noise), the port in budgeted
    mode against JAX in parity mode (with no budget overflowing, the same
    samples reach the pixels; the JAX package's budgeted backward takes
    ~2.5 minutes to compile here): relative L2 <= 1e-3 per parameter, with
    the JAX side's sparse-conv VJP and its vertex voxel / visibility
    decisions shared as in ``tests/test_torch_train.py``.

The weights: the port's ``random_init_`` draws them, and ``_to_flax``
hands them to JAX (the inverse of ``compat/flax_bridge.from_flax``, whose
round trip the tests check), so that no JAX init is compiled.
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
from sherf_tpu.core.config import TrainConfig as JTrainConfig
from sherf_tpu.core.diag import overflow_report
from sherf_tpu.data import make_synthetic_batch as j_make_batch
from sherf_tpu.features import sparseconv as j_sc
from sherf_tpu.features import superresolution as j_sr
from sherf_tpu.kernels import capsules as j_caps
from sherf_tpu.models import SHERFGenerator as JGenerator
from sherf_tpu.models import generator as j_generator
from sherf_tpu.nerf import decoders as j_dec
from sherf_tpu.nerf import importance as j_imp
from sherf_tpu.nerf.renderer import SHERFRenderer as JRenderer
from sherf_tpu.nerf.warp import make_pose_context as j_pose_context
from sherf_tpu import smpl as j_smpl
from sherf_tpu import train as j_train
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.calibrate import calibrate_budgets
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig, TrainConfig
from sherf_tpu_torch.core.diag import overflow_report as t_overflow_report
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.features import layers as t_layers
from sherf_tpu_torch.features import sparseconv as t_sc
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.features.superresolution import (
    SuperresolutionHybrid, resize_bilinear)
from sherf_tpu_torch.geometry.rays import backface_mask as t_backface_mask
from sherf_tpu_torch.kernels.capsules import capsule_mask, capsule_radii, prune_mask
from sherf_tpu_torch.models.generator import (SHERFGenerator, init_weights_,
                                              random_init_)
from sherf_tpu_torch.nerf.decoders import OSGDecoder
from sherf_tpu_torch.nerf.importance import sample_importance, sample_pdf
from sherf_tpu_torch.nerf.warp import batch_pose_contexts
from sherf_tpu_torch import smpl as t_smpl
from sherf_tpu_torch import train as t_train
from torch_init_check import init_rejections

T = torch.from_numpy
H = W = 16
D, DI = 6, 4
MODEL_KW = dict(backbone_resolution=32, channel_base=1024, channel_max=32,
                voxel_size=0.02, sparse_conv_layers=2)
DENSITY_BIAS = 5.0


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads (as ``tests/test_torch_train.py``): the suite
    runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jax.device_get(x))


def _psnr(a, b):
    a = (np.asarray(a, np.float64) + 1) / 2
    b = (np.asarray(b, np.float64) + 1) / 2
    return 10 * np.log10(1.0 / np.mean((a - b) ** 2))


# ------------------------------------------------------------ port -> flax

def _to_flax(model: torch.nn.Module) -> dict:
    """The port's parameters and buffers as flax variables: the inverse of
    ``from_flax``, by the module that owns each tensor."""
    out = {}

    def put(coll, path, arr):
        node = out.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr, order="C")

    for mname, mod in model.named_modules():
        mpath = tuple(mname.split(".")) if mname else ()
        for leaf, p in mod.named_parameters(recurse=False):
            a = p.detach().cpu().numpy()
            if leaf == "weight" and isinstance(mod, torch.nn.Linear):
                put("params", mpath + ("kernel",), a.T)
            elif leaf == "weight" and isinstance(mod, torch.nn.Conv2d):
                put("params", mpath + ("kernel",), a.transpose(2, 3, 1, 0))
            elif leaf == "weight" and isinstance(
                    mod, (t_layers.FrozenBatchNorm, t_layers.LayerNorm,
                          t_sc.MaskedBatchNorm)):
                put("params", mpath + ("scale",), a)
            elif leaf == "weight" and a.ndim == 4:
                put("params", mpath + ("weight",), a.transpose(2, 3, 1, 0))
            elif leaf == "const" and a.ndim == 3:
                put("params", mpath + ("const",), a.transpose(1, 2, 0))
            else:
                put("params", mpath + (leaf,), a)
        for leaf, b in mod.named_buffers(recurse=False):
            a = b.detach().cpu().numpy()
            if leaf in ("running_mean", "running_var"):
                put("batch_stats", mpath + (leaf[len("running_"):],), a)
            elif leaf == "noise_const":
                put("noise", mpath + (leaf,), a)
            elif leaf == "w_avg":
                put("ema", mpath + (leaf,), a)
            else:
                raise KeyError(f"buffer {mname}.{leaf} has no flax home")
    return out


def _sub(v, name):
    return {c: t[name] for c, t in v.items() if name in t}


# ------------------------------------------------------------ modules

def test_sample_pdf_det_matches_jax(record_property):
    rng = np.random.RandomState(0)
    R, Dz = 64, 9
    z = np.sort(rng.uniform(1.0, 3.0, (R, Dz)), axis=1).astype(np.float32)
    w = rng.exponential(1.0, (R, Dz)).astype(np.float32)
    w[:8] = 1.0                              # flat
    w[8:16] = 0.0                            # all zero
    w[16:24, ::2] = 0.0                      # gaps
    w[24:32] = 0.0
    w[24:32, 4] = 5.0                        # one spike
    worst_last = 0.0
    for n in (2, 5, 16):                     # linspace u hits 0 and 1
        got = sample_importance(T(z), T(w), n, det=True).numpy()
        ref = _np(jax.jit(lambda z, w: j_imp.sample_importance(
            z, w, n, det=True))(jnp.asarray(z), jnp.asarray(w)))
        np.testing.assert_allclose(got[:, :-1], ref[:, :-1], rtol=0, atol=1e-5)
        # u = 1: the CDF's last entry rounds to either side of 1 (torch's
        # CPU cumsum adds in f64, XLA's in f32 in its own order), which
        # picks the last bin or its right edge: the gap is that rounding
        # over the last bin's mass, times the bin
        np.testing.assert_allclose(got[:, -1], ref[:, -1], rtol=0, atol=1e-4)
        worst_last = max(worst_last, float(np.abs(got[:, -1] - ref[:, -1]).max()))
        assert np.all(np.diff(got, axis=1) >= 0)
    record_property("z_fine_u1_max_abs_err", worst_last)
    bins = np.sort(rng.uniform(0, 1, (R, 6)), axis=1).astype(np.float32)
    wts = rng.uniform(0, 1, (R, 5)).astype(np.float32)
    wts[:4] = 0.0
    np.testing.assert_allclose(
        sample_pdf(T(bins), T(wts), 7, det=True).numpy(),
        _np(j_imp.sample_pdf(jnp.asarray(bins), jnp.asarray(wts), 7,
                             det=True)), rtol=0, atol=1e-5)


def test_sample_pdf_random_u_draws_from_its_generator():
    rng = np.random.RandomState(1)
    bins = T(np.sort(rng.uniform(0, 1, (32, 6)), axis=1).astype(np.float32))
    wts = T(rng.uniform(0, 1, (32, 5)).astype(np.float32))
    a = sample_pdf(bins, wts, 8, generator=torch.Generator().manual_seed(3))
    b = sample_pdf(bins, wts, 8, generator=torch.Generator().manual_seed(3))
    c = sample_pdf(bins, wts, 8, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((a >= bins[:, :1]).all() and (a <= bins[:, -1:]).all())
    with pytest.raises(ValueError, match="Generator"):
        sample_pdf(bins, wts, 8, det=False)


def test_capsules_match_jax(record_property):
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    jb = jax.device_get(j_make_batch(js, batch_size=1, H=8, W=8, seed=2))
    tb = SHERFBatch.from_numpy(jb)
    ct = batch_pose_contexts(ts, tb.pose)[0]
    verts = ((tb.vertices[0] - ct.Th) @ ct.R).numpy()       # SMPL frame
    joints = ct.joints.numpy()
    radius = 0.05
    r_t = capsule_radii(T(verts), T(joints), ts, radius).numpy()
    r_j = _np(jax.jit(lambda v, j: j_caps.capsule_radii(v, j, js, radius))(
        jnp.asarray(verts), jnp.asarray(joints)))
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6)
    rng = np.random.RandomState(0)
    lo, hi = verts.min(0) - 0.2, verts.max(0) + 0.2
    pts = np.concatenate([
        verts[rng.randint(0, len(verts), 20000)]
        + rng.normal(0, 0.06, (20000, 3)),
        rng.uniform(lo, hi, (20000, 3))]).astype(np.float32)
    m_t = capsule_mask(T(pts), T(joints), T(r_j), ts.parents).numpy()
    m_j = _np(jax.jit(lambda p, j, r: j_caps.capsule_mask(p, j, r, js.parents))(
        jnp.asarray(pts), jnp.asarray(joints), jnp.asarray(r_j)))
    # the points whose answers differ sit on a capsule surface (f64)
    par = np.asarray(ts.parents)
    a, b = joints[par].astype(np.float64), joints.astype(np.float64)
    p = pts.astype(np.float64)[:, None]
    ab = b - a
    t = np.clip(((p - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-12),
                0, 1)
    dist = np.linalg.norm(p - (a + t[..., None] * ab), axis=-1)   # (N, 24)
    gap = np.abs(dist - r_j.astype(np.float64)).min(axis=1)
    diff = m_t != m_j
    record_property("capsule_mask_differences", int(diff.sum()))
    assert m_t.sum() > 10000 and (~m_t).sum() > 1000
    assert diff.sum() <= 4 and np.all(gap[diff] <= 1e-5), gap[diff]
    # prune_mask is the two in one
    assert torch.equal(prune_mask(T(pts), T(verts), T(joints), ts, radius),
                       capsule_mask(T(pts), T(joints),
                                    capsule_radii(T(verts), T(joints), ts,
                                                  radius), ts.parents))


def test_osg_decoder_matches_jax():
    rng = np.random.RandomState(0)
    sf = rng.normal(0, 1, (3, 500, 32)).astype(np.float32)
    jd = j_dec.OSGDecoder()
    v = jax.device_get(jd.init(jax.random.PRNGKey(1), jnp.asarray(sf)))
    # the port's init of the branch against that JAX init, leaf by leaf
    # (``tests/torch_init_check.py``): EqualDense weights normal(1 /
    # lr_multiplier), biases ``bias_init``
    bad, _ = init_rejections(init_weights_(
        OSGDecoder(), torch.Generator().manual_seed(1)), v, from_flax)
    assert not bad, bad
    v["params"]["fc1"]["bias"] = rng.normal(0, 1, 4).astype(np.float32)
    ref = jax.device_get(jd.apply(v, jnp.asarray(sf)))
    td = OSGDecoder()
    td.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        got = td(T(sf), None)
    for k in ("rgb", "sigma"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("res,inp", [(128, 16), (256, 128), (512, 64)])
def test_superresolution_matches_jax(res, inp):
    """Each variant at its own input (2X from a 16x16 image resized to 64,
    4X at its 128 input, 8XDC from 64 resized to 128)."""
    rng = np.random.RandomState(res)
    rgb = rng.uniform(-1, 1, (1, inp, inp, 3)).astype(np.float32)
    ws = rng.normal(0, 1, (1, 4, 512)).astype(np.float32)
    tm = SuperresolutionHybrid(img_resolution=res, channels=3)
    random_init_(tm, torch.Generator().manual_seed(res))
    jm = j_sr.SuperresolutionHybrid(img_resolution=res, channels=3)
    args = (jnp.asarray(rgb), jnp.asarray(rgb), jnp.asarray(ws))
    ref = _np(jax.jit(lambda v, *a: jm.apply(v, *a))(_to_flax(tm), *args))
    with torch.no_grad():
        got = tm(T(rgb), T(rgb), T(ws)).numpy()
    assert got.shape == (1, res, res, 3) == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("src,size", [(512, 128), (200, 128), (128, 64),
                                      (64, 128)])
def test_resize_bilinear_matches_jax(src, size):
    x = np.random.RandomState(src).uniform(-1, 1, (1, src, src, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        resize_bilinear(T(x), size).numpy(),
        _np(j_sr.resize_bilinear(jnp.asarray(x), size)), rtol=0, atol=1e-6)


# ------------------------------------------------------------ the generator

def _j_upstream(m, batch, smpl, train=False):
    """The first half of ``SHERFGenerator.synthesis`` (the JAX package's,
    line for line): everything the renderer and the SR head read."""
    cfg = m.cfg
    B = batch.obs_img.shape[0]
    ws = m.mapping(batch.obs_img, train=train)
    planes = m.backbone.synthesis(ws, noise_mode="none",
                                  fused_modconv=not train)
    Hp, Wp = planes.shape[1:3]
    planes = jnp.moveaxis(planes.reshape(B, Hp, Wp, cfg.n_planes,
                                         cfg.plane_channels), 3, 1)
    obs_feat = m.encoder_2d_feature(batch.obs_img, extract_feature=True,
                                    train=train)
    ctx = jax.vmap(lambda p: j_pose_context(smpl, p))
    ctx_big, ctx_obs = ctx(batch.t_pose), ctx(batch.obs_pose)
    min_dhw = (jnp.min(batch.t_vertices, axis=1) - 0.05)[:, (2, 1, 0)]
    vol_feats, vol_coords = m._observation_volume(batch, obs_feat, smpl,
                                                  min_dhw, ctx_obs, ctx_big)
    return ws, planes, obs_feat, vol_feats, vol_coords, min_dhw


def _j_render(cfg, out_sh, v, up, batch, smpl, train=False):
    """The second half: the configuration's renderer (and SR head) on the
    shared upstream.  Returns (out dict, diag)."""
    ws, planes, obs_feat, vol_feats, vol_coords, min_dhw = up
    ctx = jax.vmap(lambda p: j_pose_context(smpl, p))
    use3 = cfg.use_3d_feature
    (rgb, depth, acc), mv = JRenderer(cfg, out_sh).apply(
        _sub(v, "renderer"), planes if cfg.use_1d_feature else None,
        batch.obs_img, obs_feat, vol_feats if use3 else None,
        vol_coords if use3 else None, min_dhw, batch.ray_o, batch.ray_d,
        batch.near, batch.far, ctx(batch.pose), ctx(batch.t_pose),
        ctx(batch.obs_pose), batch.vertices, batch.t_vertices,
        batch.t_bounds, batch.obs_K, batch.obs_R, batch.obs_T, smpl,
        train=train, ray_mask=batch.mask_at_box, mutable=["diag"])
    B, Hh, Ww = batch.img.shape[:3]
    out = {"image_raw": rgb.reshape(B, Hh, Ww, 3),
           "image_depth": depth.reshape(B, Hh, Ww),
           "weights_image": acc.reshape(B, Hh, Ww)}
    out["image"] = out["image_raw"]
    if cfg.use_sr_module:
        out["image"] = j_sr.SuperresolutionHybrid(
            img_resolution=cfg.img_resolution, channels=3).apply(
            _sub(v, "superresolution"), out["image_raw"], out["image_raw"],
            ws, noise_mode="none", fused_modconv=not train)
    return out, mv.get("diag", {})


@pytest.fixture(scope="module")
def scene():
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    bp = j_smpl.big_pose_params()
    tv = t_smpl.smpl_forward(ts, torch.from_numpy(bp["poses"]),
                             torch.from_numpy(bp["shapes"]))[0].numpy()
    _, out_sh = prepare_voxel_volume(tv, voxel_size=MODEL_KW["voxel_size"])
    jb = j_make_batch(js, batch_size=1, H=H, W=W, seed=0)
    tb = SHERFBatch.from_numpy(jax.device_get(jb))
    render = JRenderConfig(depth_resolution=D, depth_resolution_importance=DI,
                           density_noise=0.0)
    jcfg = JModelConfig(**MODEL_KW, render=render)
    fitted, worst = j_calibrate([jb], jcfg, margin=1.15, round_to=128)
    base = SHERFGenerator(ModelConfig(**MODEL_KW), out_sh=out_sh, device="cpu")
    random_init_(base, torch.Generator().manual_seed(0))
    base_sd = base.state_dict()
    base_v = _to_flax(base)
    up = jax.jit(lambda v, b: JGenerator(jcfg, out_sh=out_sh).apply(
        v, b, js, method=_j_upstream))(base_v, jb)
    return dict(js=js, ts=ts, jb=jb, tb=tb, out_sh=out_sh, jcfg=jcfg,
                fitted=fitted, worst=worst, base_sd=base_sd, up=up)


def _model(sc, cfg):
    """The port's generator for ``cfg``: the shared modules carry the base
    weights, the others the configuration's own draw; the decoder's density
    bias raised."""
    m = SHERFGenerator(cfg, out_sh=sc["out_sh"], device="cpu")
    random_init_(m, torch.Generator().manual_seed(1))
    sd = m.state_dict()
    sd.update({k: t for k, t in sc["base_sd"].items()
               if k in sd and sd[k].shape == t.shape})
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        if cfg.use_nerf_decoder:
            m.renderer.decoder.alpha.bias += DENSITY_BIAS
        else:
            m.renderer.decoder.fc1.bias[0] += DENSITY_BIAS
    return m


def test_to_flax_round_trips(scene):
    m = _model(scene, ModelConfig(**MODEL_KW, use_nerf_decoder=False,
                                  use_sr_module=True, img_resolution=128))
    sd = from_flax(_to_flax(m))
    ref = m.state_dict()
    assert set(sd) == set(ref)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


def test_importance_budgets_match_jax(scene):
    """``calibrate_budgets`` with the importance pass on: JAX's fitted
    config field for field, ``importance_capacity_frac`` = the ray budget's
    share."""
    cfg = ModelConfig(**MODEL_KW, render=RenderConfig(
        **dataclasses.asdict(scene["jcfg"].render)))
    fitted, worst = calibrate_budgets([scene["tb"]], cfg, margin=1.15,
                                      round_to=128)
    assert worst == pytest.approx(scene["worst"])
    assert dataclasses.asdict(fitted) == dataclasses.asdict(scene["fitted"])
    assert fitted.importance_capacity_frac == fitted.ray_capacity_frac < 1


def _capsule_render(sc):
    """Budgets for the capsule prune: the point budget from its own
    survivors over every sample of the frame (a superset of the compacted
    rays' samples) at margin 1.15, the rest as calibrated."""
    tb, ts = sc["tb"], sc["ts"]
    ct = batch_pose_contexts(ts, tb.pose)[0]
    dep = tb.near[0][:, None] + (tb.far[0] - tb.near[0])[:, None] * \
        torch.linspace(0, 1, D)
    pts = (tb.ray_o[0][:, None] + dep[..., None] * tb.ray_d[0][:, None])
    q = (pts.reshape(-1, 3) - ct.Th) @ ct.R
    verts = (tb.vertices[0] - ct.Th) @ ct.R
    n = int(prune_mask(q, verts, ct.joints, ts, 0.05).sum())
    M = H * W * D
    cap = min(-(-int(n * 1.15) // 128) * 128, M)
    assert cap < M
    return dataclasses.replace(sc["fitted"], depth_resolution_importance=0,
                               importance_capacity_frac=None,
                               prune_mode="capsule",
                               point_capacity_frac=cap / M)


CASES = {
    "importance_parity": lambda sc: dict(render=sc["jcfg"].render),
    "importance_budgeted": lambda sc: dict(render=sc["fitted"]),
    "capsule_budgeted": lambda sc: dict(render=_capsule_render(sc)),
    "osg_budgeted": lambda sc: dict(use_nerf_decoder=False,
                                    render=_no_importance(sc["fitted"])),
    "sr": lambda sc: dict(use_sr_module=True, img_resolution=128,
                          render=_no_importance(sc["jcfg"].render)),
    "banks_1d_2d": lambda sc: dict(use_3d_feature=False,
                                   render=_no_importance(sc["jcfg"].render)),
    "banks_1d_3d": lambda sc: dict(use_2d_feature=False,
                                   render=_no_importance(sc["jcfg"].render)),
    "banks_2d_3d": lambda sc: dict(use_1d_feature=False,
                                   render=_no_importance(sc["jcfg"].render)),
    "banks_1d_2d_3d_no_trans": lambda sc: dict(
        use_trans=False, render=_no_importance(sc["jcfg"].render)),
}


def _no_importance(render):
    return dataclasses.replace(render, depth_resolution_importance=0,
                               importance_capacity_frac=None)


def _check_case(sc, case, record_property):
    kw = CASES[case](sc)
    render = kw.pop("render")
    jcfg = JModelConfig(**MODEL_KW, **kw, render=render)
    tcfg = ModelConfig(**MODEL_KW, **kw, render=RenderConfig(
        **dataclasses.asdict(render)))
    tm = _model(sc, tcfg)
    v = _to_flax(tm)
    jo, jdiag = jax.jit(lambda v, up, b: _j_render(
        jcfg, sc["out_sh"], v, up, b, sc["js"]))(v, sc["up"], sc["jb"])
    jo = jax.device_get(jo)
    assert all(n == 0 for n in overflow_report(jax.device_get(jdiag)).values())
    with torch.no_grad():
        to, diag = tm.eval()(sc["tb"], sc["ts"])
    names = set(t_overflow_report(diag))
    if render.point_capacity_frac < 1:
        assert {"ray_overflow"} <= names
        assert ({"imp_coarse_overflow", "imp_fine_overflow"} <= names
                if render.depth_resolution_importance else
                {"point_overflow", "exact_overflow"} <= names)
    assert all(int(n) == 0 for n in diag.values()), diag
    assert float(to["weights_image"].max()) > 0.5
    keys = ("image_raw", "image") if tcfg.use_sr_module else ("image_raw",)
    for k in keys:
        assert to[k].shape == jo[k].shape and bool(torch.isfinite(to[k]).all())
        psnr = _psnr(to[k].numpy(), jo[k])
        record_property(f"{k}_psnr_db", float(psnr))
        assert psnr >= 45.0, (k, psnr)
    np.testing.assert_allclose(to["weights_image"].numpy(),
                               jo["weights_image"], atol=1e-2)


@pytest.mark.parametrize("case", ["importance_parity", "importance_budgeted",
                                  "capsule_budgeted", "osg_budgeted", "sr"])
def test_generator_branch_matches_jax(scene, case, record_property):
    _check_case(scene, case, record_property)


@pytest.mark.parametrize("case", ["banks_1d_2d", "banks_1d_3d", "banks_2d_3d",
                                  "banks_1d_2d_3d_no_trans"])
def test_feature_bank_ablation_matches_jax(scene, case, record_property):
    _check_case(scene, case, record_property)


def _exact_conv_core(feats, nbr, w, inv_nbr, valid_in):
    """The JAX sparse conv core differentiated by autodiff (the package's
    custom VJP is the adjoint only while no two sites share a voxel; see
    ``tests/test_torch_train.py``)."""
    return jnp.einsum("ski,kio->so", j_sc._conv_rows(feats, nbr), w)


def test_osg_importance_train_gradients_match_jax(scene, record_property,
                                                  monkeypatch):
    """One train step's gradients, OSG decoder + importance pass (the port
    budgeted, JAX in parity mode): relative L2 <= 1e-3 on every parameter
    whose JAX gradient norm exceeds 1e-8.  The port's vertex voxels and visibility are handed to the JAX
    side, and its sparse conv is differentiated by autodiff (ROADMAP Queue
    C: the two differences of the JAX side that are not the port's)."""
    sc = scene
    tb, ts, js = sc["tb"], sc["ts"], sc["js"]
    kw = dict(MODEL_KW, use_nerf_decoder=False)
    tcfg = ModelConfig(**kw, render=RenderConfig(
        **dataclasses.asdict(sc["fitted"])))
    # the JAX side renders in parity mode: every sample decoded, those
    # that fail the exact test masked; with no budget overflowing, the
    # same samples reach the pixels as in budgeted mode
    jcfg = JModelConfig(**kw, render=sc["jcfg"].render)
    tm = _model(sc, tcfg)
    with torch.no_grad():
        obs_feat = tm.encoder_2d_feature(tb.obs_img, extract_feature=True)
        min_dhw = (tb.t_vertices.amin(dim=1) - 0.05)[:, [2, 1, 0]]
        _, t_coords = tm._observation_volume(
            tb, obs_feat, ts, min_dhw, batch_pose_contexts(ts, tb.obs_pose),
            batch_pose_contexts(ts, tb.t_pose))
        t_vis = t_backface_mask(tb.obs_vertices[0], ts.faces, tb.obs_K[0],
                                tb.obs_R[0], tb.obs_T[0])
    monkeypatch.setattr(j_sc, "_conv_core", _exact_conv_core)
    monkeypatch.setattr(j_generator, "backface_mask",
                        lambda *a: jnp.asarray(t_vis.numpy()))
    v = _to_flax(tm)
    params, extra = v["params"], {k: x for k, x in v.items() if k != "params"}
    jm = JGenerator(jcfg, out_sh=sc["out_sh"])

    def loss_fn(p):
        vv = {"params": p, **extra}
        up = jm.apply(vv, sc["jb"], js, train=True, method=_j_upstream)
        up = up[:4] + (jnp.asarray(t_coords.numpy()),) + up[5:]
        out, _ = _j_render(jcfg, sc["out_sh"], vv, up, sc["jb"], js,
                           train=True)
        return j_train.reconstruction_loss(out, sc["jb"],
                                           JTrainConfig(batch_size=1))[0]
    loss_j, g_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    g_j = from_flax({"params": jax.device_get(g_j)})

    out, diag = tm(tb, ts, train=True)
    assert all(int(x) == 0 for x in diag.values()), diag
    assert {"imp_coarse_overflow", "imp_fine_overflow"} <= set(diag)
    loss_t, _ = t_train.reconstruction_loss(out, tb, TrainConfig(batch_size=1))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    worst, worst_name, checked = 0.0, None, 0
    for name, p in tm.named_parameters():
        ref = g_j[name].numpy().astype(np.float64)
        got = (np.zeros_like(ref) if p.grad is None
               else p.grad.numpy().astype(np.float64))
        norm = np.linalg.norm(ref)
        if norm <= 1e-8:
            assert np.linalg.norm(got) <= 1e-6, name
            continue
        rel = float(np.linalg.norm(got - ref) / norm)
        if rel > worst:
            worst, worst_name = rel, name
        checked += 1
    record_property("worst_rel_l2", float(worst))
    record_property("worst_param", str(worst_name))
    assert checked > 50
    assert tm.renderer.decoder.fc0.weight.grad is not None
    assert worst <= 1e-3, (worst_name, worst)
