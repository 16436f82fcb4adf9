"""Each ported module against its JAX counterpart on the same numpy inputs
and the same weights (flax params through ``compat.flax_bridge.from_flax``),
in float32 on the CPU.  Every tolerance states its reason."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.core.types import SMPLPose as JPose
from sherf_tpu.features import encoding as j_enc
from sherf_tpu.features import resnet as j_resnet
from sherf_tpu.features import sparseconv as j_sc
from sherf_tpu.features import stylegan2 as j_sg2
from sherf_tpu.features import transformer as j_tr
from sherf_tpu.geometry import rays as j_rays
from sherf_tpu.kernels import grid_sample as j_gs
from sherf_tpu.kernels import occupancy as j_occ
from sherf_tpu.nerf import decoders as j_dec
from sherf_tpu.nerf import renderer as j_renderer
from sherf_tpu.nerf import march as j_march
from sherf_tpu.nerf import warp as j_warp
from sherf_tpu import smpl as j_smpl
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.diag import Diag, overflow_report
from sherf_tpu_torch.core.types import SMPLPose
from sherf_tpu_torch.features import encoding as t_enc
from sherf_tpu_torch.features import resnet as t_resnet
from sherf_tpu_torch.features import sparseconv as t_sc
from sherf_tpu_torch.features import stylegan2 as t_sg2
from sherf_tpu_torch.features import transformer as t_tr
from sherf_tpu_torch.geometry import rays as t_rays
from sherf_tpu_torch.kernels import grid_sample as t_gs
from sherf_tpu_torch.kernels import occupancy as t_occ
from sherf_tpu_torch.nerf import decoders as t_dec
from sherf_tpu_torch.nerf import march as t_march
from sherf_tpu_torch.nerf import warp as t_warp
from sherf_tpu_torch.nerf import renderer as t_renderer
from sherf_tpu_torch.nerf.renderer import linspace01
from sherf_tpu_torch import smpl as t_smpl

T = torch.from_numpy


def _np(x):
    return np.asarray(jax.device_get(x))


def _load(module, variables):
    module.load_state_dict(from_flax(jax.device_get(variables)), strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def bodies():
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    rng = np.random.RandomState(0)
    poses = []
    for _ in range(2):
        p = (rng.randn(72) * 0.25).astype(np.float32)
        p[:3] = 0
        poses.append((p, (rng.randn(10) * 0.3).astype(np.float32)))
    return js, ts, poses


# ---------------------------------------------------------------- SMPL / warp

def test_synthetic_smpl_is_identical(bodies):
    js, ts, _ = bodies
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
              "faces"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      _np(getattr(js, f)), err_msg=f)
    assert ts.parents == js.parents


def test_smpl_forward_and_transforms(bodies):
    """f32 FK chains of 24 4x4 products: atol 2e-5 m (rounding only)."""
    js, ts, poses = bodies
    for p, s in poses + [(j_smpl.big_pose_params()["poses"],
                          np.zeros(10, np.float32))]:
        vj, jj = j_smpl.smpl_forward(js, jnp.asarray(p), jnp.asarray(s))
        vt, jt = t_smpl.smpl_forward(ts, T(p), T(s))
        np.testing.assert_allclose(vt.numpy(), _np(vj), atol=2e-5)
        np.testing.assert_allclose(jt.numpy(), _np(jj), atol=2e-5)
        Aj, _ = j_smpl.transform_params(js, jnp.asarray(p), jnp.asarray(s))
        At, _ = t_smpl.transform_params(ts, T(p), T(s))
        np.testing.assert_allclose(At.numpy(), _np(Aj), atol=2e-5)
    r = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(t_smpl.rodrigues(T(r)).numpy(),
                               _np(j_smpl.rodrigues(jnp.asarray(r))), atol=1e-6)


def test_warps_match(bodies):
    """Inverse-LBS warps of random points: f32, closed-form 3x3 inverses;
    atol 5e-5 m (rounding amplified by the inverse)."""
    js, ts, poses = bodies
    bp = j_smpl.big_pose_params()

    def poses_of(p, s):
        kw = dict(poses=p, shapes=s, R=np.eye(3, dtype=np.float32),
                  Th=np.asarray([0.01, -0.02, 0.03], np.float32))
        return (JPose(**{k: jnp.asarray(v) for k, v in kw.items()}),
                SMPLPose(**{k: T(np.asarray(v)) for k, v in kw.items()}))

    jt, tt = poses_of(*poses[0])
    jb, tb = poses_of(bp["poses"], bp["shapes"])
    cj_t, cj_b = j_warp.make_pose_context(js, jt), j_warp.make_pose_context(js, jb)
    ct_t, ct_b = t_warp.make_pose_context(ts, tt), t_warp.make_pose_context(ts, tb)
    rng = np.random.RandomState(2)
    vid = rng.randint(0, 6890, 500)
    q = (_np(js.v_template)[vid] + rng.randn(500, 3) * 0.02).astype(np.float32)
    qd = rng.randn(500, 3).astype(np.float32)
    pay_j = j_warp.target2c_tables(js, cj_t, cj_b)[vid]
    pay_t = t_warp.target2c_tables(ts, ct_t, ct_b)[T(vid)]
    np.testing.assert_allclose(pay_t.numpy(), _np(pay_j), atol=1e-6)
    cj, dj = j_warp.deform_target2c_from_tables(cj_t, cj_b, pay_j,
                                                jnp.asarray(q), jnp.asarray(qd))
    ct, dt = t_warp.deform_target2c_from_tables(ct_t, ct_b, pay_t, T(q), T(qd))
    np.testing.assert_allclose(ct.numpy(), _np(cj), atol=5e-5)
    np.testing.assert_allclose(dt.numpy(), _np(dj), atol=5e-5)
    pc_j = j_warp.c2source_tables(js, cj_t, cj_b)[vid]
    pc_t = t_warp.c2source_tables(ts, ct_t, ct_b)[T(vid)]
    sj, wj, _ = j_warp.deform_c2source_from_tables(cj_t, cj_b, pc_j,
                                                   jnp.asarray(q))
    st, wt, _ = t_warp.deform_c2source_from_tables(ct_t, ct_b, pc_t, T(q))
    np.testing.assert_allclose(st.numpy(), _np(sj), atol=5e-5)
    np.testing.assert_allclose(wt.numpy(), _np(wj), atol=5e-5)


def test_deform_c2source_matches(bodies):
    """The table-gathering ``deform_c2source``, with and without a
    weights correction, on the canonical vertices (points that lie on the
    gathered vertex, as the renderer's canonical samples do): atol 1e-5 m."""
    js, ts, poses = bodies
    bp = j_smpl.big_pose_params()
    kw = dict(poses=poses[1][0], shapes=poses[1][1],
              R=np.asarray(j_smpl.rodrigues(jnp.asarray([[0.1, -0.4, 0.2]],
                                                        jnp.float32)))[0],
              Th=np.asarray([0.3, -0.1, 2.5], np.float32))
    big = dict(poses=bp["poses"], shapes=bp["shapes"],
               R=np.eye(3, dtype=np.float32), Th=np.zeros(3, np.float32))
    cj = [j_warp.make_pose_context(js, JPose(**{k: jnp.asarray(v)
                                               for k, v in d.items()}))
          for d in (kw, big)]
    ct = [t_warp.make_pose_context(ts, SMPLPose(**{k: T(np.array(v))
                                                  for k, v in d.items()}))
          for d in (kw, big)]
    rng = np.random.RandomState(3)
    vid = rng.randint(0, 6890, 700)
    t_verts = _np(j_smpl.smpl_forward(js, jnp.asarray(bp["poses"]),
                                      jnp.asarray(bp["shapes"]))[0])
    q = t_verts[vid]
    corr = (rng.randn(700, 24) * 0.05).astype(np.float32)
    for wc in (None, corr):
        got = t_warp.deform_c2source(ts, ct[0], ct[1], T(vid), T(q),
                                     None if wc is None else T(wc))
        want = j_warp.deform_c2source(js, cj[0], cj[1], jnp.asarray(vid),
                                      jnp.asarray(q),
                                      None if wc is None else jnp.asarray(wc))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=1e-5)


def test_geometry_matches():
    """Rays, AABB near/far, projection and backface culling: f32 rounding
    (atol 1e-5; projected pixels 1e-3).  The backface mask may flip where
    n.v rounds across 0: fewer than 0.1% of the vertices."""
    rng = np.random.RandomState(3)
    K = np.asarray([[60, 0, 16], [0, 60, 16], [0, 0, 1]], np.float32)
    R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    Tc = np.asarray([[0.1], [0.2], [3.0]], np.float32)
    oj, dj = j_rays.get_rays(32, 32, jnp.asarray(K), jnp.asarray(R), jnp.asarray(Tc))
    ot, dt = t_rays.get_rays(32, 32, T(K), T(R), T(Tc))
    np.testing.assert_allclose(ot.numpy(), _np(oj), atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), _np(dj), atol=1e-5)
    bounds = np.asarray([[-0.5, -1, -0.3], [0.5, 1, 0.3]], np.float32)
    nj = j_rays.near_far_aabb(jnp.asarray(bounds), oj.reshape(-1, 3), dj.reshape(-1, 3))
    nt = t_rays.near_far_aabb(T(bounds), ot.reshape(-1, 3), dt.reshape(-1, 3))
    for a, b in zip(nt, nj):
        np.testing.assert_allclose(a.numpy().astype(np.float32),
                                   _np(b).astype(np.float32), atol=1e-5)
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    v = _np(js.v_template)
    xj, _ = j_rays.project_points(jnp.asarray(v), K, R, Tc)
    xt, _ = t_rays.project_points(T(v), T(K), T(R), T(Tc))
    np.testing.assert_allclose(xt.numpy(), _np(xj), atol=1e-3)  # pixels
    bj = _np(j_rays.backface_mask(jnp.asarray(v), js.faces, K, R, Tc))
    bt = t_rays.backface_mask(T(v), ts.faces, T(K), T(R), T(Tc)).numpy()
    assert (bj != bt).mean() < 1e-3


# ---------------------------------------------------------------- kernels (plain torch)

def test_occupancy_matches():
    """Integer EDT and floor-indexed lookups: exactly equal."""
    rng = np.random.RandomState(4)
    verts = (rng.randn(2000, 3) * [0.2, 0.5, 0.1]).astype(np.float32)
    lo = verts.min(0) - (0.05 + 2 * t_occ.CELL)
    w = t_occ.edt_window_cells(0.05)
    np.testing.assert_array_equal(
        t_occ.distance_grid(T(verts), T(lo), w).numpy(),
        _np(j_occ.distance_grid(jnp.asarray(verts), jnp.asarray(lo), w)))
    q = (rng.randn(4000, 3) * [0.3, 0.6, 0.2]).astype(np.float32)
    np.testing.assert_array_equal(
        t_occ.occupancy_mask(T(q), T(verts)).numpy(),
        _np(j_occ.occupancy_mask(jnp.asarray(q), jnp.asarray(verts))))
    pts = q[:3000].reshape(100, 30, 3)
    np.testing.assert_array_equal(
        t_occ.strided_occupancy(T(pts), T(verts), stride=3,
                                step_margin=0.03).numpy(),
        _np(j_occ.strided_occupancy(jnp.asarray(pts), jnp.asarray(verts),
                                    stride=3, step_margin=0.03)))


def test_grid_sample_matches():
    """Bilinear / trilinear taps with f32 weights: atol 1e-6."""
    rng = np.random.RandomState(5)
    img = rng.randn(9, 11, 4).astype(np.float32)
    c = (rng.rand(300, 2) * 2.4 - 1.2).astype(np.float32)     # incl. outside
    for ac in (False, True):
        np.testing.assert_allclose(
            t_gs.grid_sample_2d(T(img), T(c), align_corners=ac).numpy(),
            _np(j_gs.grid_sample_2d(jnp.asarray(img), jnp.asarray(c),
                                    align_corners=ac)), atol=1e-6)
    vol = rng.randn(5, 6, 7, 3).astype(np.float32)
    c3 = (rng.rand(300, 3) * 2.4 - 1.2).astype(np.float32)
    np.testing.assert_allclose(
        t_gs.grid_sample_3d(T(vol), T(c3)).numpy(),
        _np(j_gs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(c3))), atol=1e-6)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Distance in bf16 ulps (bit patterns as ordered integers)."""
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(ordered(a) - ordered(b))


def _planes_and_points(seed, m=6000):
    rng = np.random.RandomState(seed)
    planes = rng.randn(3, 16, 24, 8).astype(np.float32)
    pts = (rng.rand(m, 3) * 2.6 - 1.3).astype(np.float32)   # incl. outside
    pts[:300] = rng.choice([-1.0, 1.0], (300, 3))          # on the edges
    pts[300:600, 0] = 1.0
    pts[600:900, 2] = -1.0
    pts[900:1000] = np.round(pts[900:1000] * 4) / 4        # on texel rows
    return planes, pts


def test_sample_from_planes_bf16_matches_jax():
    """bf16 planes: the JAX corner-packed sampler rounds its weights to
    bf16 and returns bf16; the port's four-tap form must agree within one
    bf16 ulp, points on the edges and outside [-1, 1] included."""
    planes, pts = _planes_and_points(12)
    jp = jnp.asarray(planes).astype(jnp.bfloat16)
    yj = j_renderer.sample_from_planes(jp, jnp.asarray(pts))
    assert yj.dtype == jnp.bfloat16
    yt = t_renderer.sample_from_planes(T(planes).to(torch.bfloat16), T(pts))
    assert yt.dtype == torch.bfloat16
    ref = T(np.array(_np(yj.astype(jnp.float32))))
    assert _bf16_ulps(yt.float(), ref).max() <= 1
    assert bool(yt.float().abs().max() > 0)


def test_sample_from_planes_f32_is_the_four_tap_lerp():
    """The f32 path is bit for bit the four-tap lerp it was before the bf16
    repair, and agrees with the JAX sampler to f32 rounding (atol 1e-6)."""
    planes, pts = _planes_and_points(13)
    yt = t_renderer.sample_from_planes(T(planes), T(pts))
    assert yt.dtype == torch.float32

    def lerp(img, c):
        H, W, C = img.shape
        x = ((c[:, 0] + 1.0) * W - 1.0) / 2.0
        y = ((c[:, 1] + 1.0) * H - 1.0) / 2.0
        x0f, y0f = torch.floor(x), torch.floor(y)
        x0, y0 = x0f.long(), y0f.long()
        wx, wy = (x - x0f)[:, None], (y - y0f)[:, None]

        def tap(ix, iy):
            ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            f = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
            return img.reshape(H * W, C)[f].float() * ok[:, None]
        top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
        bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
        return top * (1 - wy) + bot * wy
    p = T(pts)
    old = torch.stack([lerp(T(planes[0]), p[:, [0, 1]]),
                       lerp(T(planes[1]), p[:, [0, 2]]),
                       lerp(T(planes[2]), p[:, [2, 1]])])
    assert torch.equal(yt, old)
    np.testing.assert_allclose(
        yt.numpy(), _np(j_renderer.sample_from_planes(jnp.asarray(planes),
                                                      jnp.asarray(pts))),
        atol=1e-6)


def test_linspace_matches_jnp():
    for D in (2, 8, 47, 48, 64):
        np.testing.assert_array_equal(linspace01(D, "cpu").numpy(),
                                      _np(jnp.linspace(0.0, 1.0, D)))


def test_positional_encoding_matches():
    """One folded sine, same layout (incl. the renderer's 33 -> 32 cut):
    atol 2e-6 (sin implementations differ in the last bits)."""
    x = np.random.RandomState(6).randn(200, 3).astype(np.float32)
    for f in (4, 5, 6):
        np.testing.assert_allclose(
            t_enc.positional_encoding(T(x), f).numpy(),
            _np(j_enc.positional_encoding(jnp.asarray(x), f)), atol=2e-6)


def test_ray_marchers_match():
    """Dense and segmented compositing: atol 1e-5.  The port sums the
    segmented log-transmittance in f64 (the JAX package in f32)."""
    rng = np.random.RandomState(7)
    N, D = 40, 8
    near = (2.0 + rng.rand(N)).astype(np.float32)
    far = (near + 0.5 + rng.rand(N)).astype(np.float32)
    rd = rng.randn(N, 3).astype(np.float32)
    steps = linspace01(D, "cpu").numpy()
    depths = (near[:, None] + (far - near)[:, None] * steps).astype(np.float32)
    col = rng.rand(N, D, 3).astype(np.float32)
    sig = (rng.randn(N, D) * 3).astype(np.float32)
    rj = j_march.ray_march(jnp.asarray(col), jnp.asarray(sig), jnp.asarray(depths),
                           jnp.asarray(rd))
    rt = t_march.ray_march(T(col), T(sig), T(depths), T(rd))
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)
    keep = rng.rand(N * D) < 0.4
    gidx = np.nonzero(keep)[0].astype(np.int32)
    P = len(gidx) + 7
    g = np.concatenate([gidx, np.full(7, N * D, np.int32)])
    valid = np.arange(P) < len(gidx)
    c = np.concatenate([col.reshape(-1, 3)[gidx], np.zeros((7, 3), np.float32)])
    s = np.concatenate([sig.reshape(-1)[gidx], np.zeros(7, np.float32)])
    sj = j_march.ray_march_segmented(jnp.asarray(c), jnp.asarray(s), jnp.asarray(g),
                                     jnp.asarray(valid), jnp.asarray(near),
                                     jnp.asarray(far), jnp.asarray(rd), D)
    st = t_march.ray_march_segmented(T(c), T(s), T(g), T(valid), T(near), T(far),
                                     T(rd), D)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)


# ---------------------------------------------------------------- networks

def test_resnet18_matches():
    """Conv stacks in f32 (NCHW vs NHWC, oneDNN vs XLA): rtol/atol 1e-4."""
    x = np.random.RandomState(8).rand(2, 32, 32, 3).astype(np.float32)
    for feat in (False, True):
        jm = j_resnet.ResNet18()
        v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), extract_feature=feat)
        # non-trivial running statistics
        v = jax.tree_util.tree_map(np.array, jax.device_get(v))
        rs = np.random.RandomState(9)
        for leaf in jax.tree_util.tree_leaves(v["batch_stats"]):
            leaf[...] = rs.rand(*leaf.shape) * 0.5 + (0.75 if leaf.min() > 0 else 0)
        tm = _load(t_resnet.ResNet18(feature_only=feat), v)
        yj = _np(jm.apply(v, jnp.asarray(x), extract_feature=feat))
        yt = tm(T(x), extract_feature=feat).detach().numpy()
        np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-4)


def test_stylegan2_backbone_matches():
    """Mapping + skip synthesis with fused modulated convs, f32:
    rtol/atol 2e-4 (5 conv blocks of f32 rounding)."""
    kw = dict(z_dim=64, w_dim=64, img_resolution=32, img_channels=12,
              channel_base=256, channel_max=16)
    jm = j_sg2.StyleGAN2Backbone(**kw)
    z = np.random.RandomState(10).randn(2, 64).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(z), noise_mode="const",
                fused_modconv=True)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        if "noise_strength" in jax.tree_util.keystr(path):
            leaf[...] = 0.1
    tm = _load(t_sg2.StyleGAN2Backbone(**kw), v)
    for mode in ("none", "const"):
        yj = _np(jm.apply(v, jnp.asarray(z), noise_mode=mode, fused_modconv=True))
        yt = tm(T(z), noise_mode=mode).detach().numpy()
        np.testing.assert_allclose(yt.transpose(0, 2, 3, 1), yj, rtol=2e-4,
                                   atol=2e-4)


def test_transformer_and_decoder_match():
    """Tiny matmul stacks in f32: atol 1e-5."""
    rng = np.random.RandomState(11)
    x = rng.randn(50, 3, 32).astype(np.float32)
    jm = j_tr.PlaneTransformer(dim=32)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tm = _load(t_tr.PlaneTransformer(dim=32), v)
    np.testing.assert_allclose(tm(T(x)).detach().numpy(),
                               _np(jm.apply(v, jnp.asarray(x))), atol=1e-5)
    pe = rng.randn(50, 39).astype(np.float32)
    sf = rng.randn(3, 50, 32).astype(np.float32)
    ve = rng.randn(50, 27).astype(np.float32)
    jd = j_dec.NeRFDecoder()
    vd = jd.init(jax.random.PRNGKey(4), *map(jnp.asarray, (pe, sf, ve)))
    td = _load(t_dec.NeRFDecoder(), vd)
    oj = jd.apply(vd, *map(jnp.asarray, (pe, sf, ve)))
    ot = td(T(pe), T(sf), T(ve))
    for k in ("rgb", "sigma"):
        np.testing.assert_allclose(ot[k].detach().numpy(), _np(oj[k]), atol=1e-5)


def _volume_inputs(seed, n_sites=600, shape=(24, 40, 36)):
    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(2, s - 2, n_sites) for s in shape], -1).astype(np.int32)
    f = rng.randn(n_sites, 32).astype(np.float32)
    q = (rng.rand(400, 3) * (np.asarray(shape) - 1)).astype(np.float32)
    q[:50] = c[:50] + rng.rand(50, 3).astype(np.float32) * 0.5  # near sites
    return c, f, q


def test_sparse_conv_net_matches():
    """Sparse conv stack + trilinear readout at three scales, f32, running-
    stat BatchNorm: rtol/atol 1e-4; overflow counters equal."""
    shape, caps = (24, 40, 36), (512, 256, 128)
    c, f, q = _volume_inputs(12, shape=shape)
    jm = j_sc.SparseConvNet(num_layers=4, out_sh=shape, caps=caps)
    args = (jnp.asarray(f), jnp.asarray(c), jnp.asarray(q))
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(5), *a))(*args)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    yj, mv = jax.jit(lambda v, *a: jm.apply(v, *a, mutable=["diag"]))(v, *args)
    tm = _load(t_sc.SparseConvNet(num_layers=4, out_sh=shape, caps=caps), v)
    diag = Diag()
    yt = tm(T(f), T(c), T(q), diag).detach().numpy()
    assert yt.shape == (400, 192)
    np.testing.assert_allclose(yt, _np(yj), rtol=1e-4, atol=1e-4)
    assert np.abs(_np(yj)).max() > 0
    j_over = max(int(x) for x in jax.tree_util.tree_leaves(jax.device_get(mv)))
    assert overflow_report(diag)["site_overflow"] == j_over


def test_sparse_conv_primitives_match():
    """Submanifold and strided conv through the index grid: rtol/atol 1e-5."""
    shape = (24, 40, 36)
    c, f, _ = _volume_inputs(14, shape=shape)
    rng = np.random.RandomState(15)
    w = (rng.randn(3, 3, 3, 32, 16) * 0.05).astype(np.float32)
    valid = np.ones(len(c), bool)
    gj = j_sc.build_index_grid(jnp.asarray(c), jnp.asarray(valid), shape)
    gt = t_sc.build_index_grid(T(c), T(valid), shape)
    np.testing.assert_allclose(
        t_sc.subm_conv3d(T(f), T(c), gt, shape, T(w)).numpy(),
        _np(j_sc.subm_conv3d(jnp.asarray(f), jnp.asarray(c), gj, shape,
                             jnp.asarray(w), jnp.asarray(valid))),
        rtol=1e-5, atol=1e-5)
    oc, ov, _, _ = t_sc.downsample_sites(T(c), T(valid), shape, 512)
    np.testing.assert_allclose(
        t_sc.stride_conv3d(T(f), gt, shape, oc, T(w)).numpy(),
        _np(j_sc.stride_conv3d(jnp.asarray(f), gj, shape, jnp.asarray(oc.numpy()),
                               jnp.asarray(w), jnp.asarray(ov.numpy()),
                               jnp.asarray(valid))),
        rtol=1e-5, atol=1e-5)


def test_duplicate_voxels_resolve_like_jax_last_writer():
    """Duplicate site coordinates: the index grid and the downsampled site
    set resolve exactly as JAX's ``.at[].set`` (last writer wins)."""
    shape = (12, 14, 10)
    rng = np.random.RandomState(13)
    base = np.stack([rng.randint(0, s, 40) for s in shape], -1).astype(np.int32)
    coords = np.concatenate([base, base[::-1], base[:7]])     # many duplicates
    valid = np.ones(len(coords), bool)
    valid[5] = False
    gj = _np(j_sc.build_index_grid(jnp.asarray(coords), jnp.asarray(valid), shape))
    gt = t_sc.build_index_grid(T(coords), T(valid), shape).numpy()
    np.testing.assert_array_equal(gt, gj)
    for cap in (30, 200):
        oj = j_sc.downsample_sites(jnp.asarray(coords), jnp.asarray(valid), shape, cap)
        ot = t_sc.downsample_sites(T(coords), T(valid), shape, cap)
        np.testing.assert_array_equal(ot[0].numpy(), _np(oj[0]))
        np.testing.assert_array_equal(ot[1].numpy(), _np(oj[1]))
        assert ot[2] == oj[2]
        assert int(ot[3]) == int(oj[3])
