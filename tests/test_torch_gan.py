"""The port's adversarial training path against the JAX package's, on the
CPU, with shared weights and seeded numpy inputs:

  * ``filter2d`` / ``downsample2d`` (atol 1e-6); ``filters.conv2d``'s
    gradients of every order (gradcheck, gradgradcheck, R1's weight
    gradient against torch's own conv); ``EqualConv2d`` for
    k in {1, 3}, down in {1, 2}, linear and lrelu, at gain sqrt(0.5)
    (rtol 1e-5, atol 1e-6); ``minibatch_stddev`` (rtol 1e-5);
  * ``Discriminator`` logits at img_resolution 16, channel_max 32 (the D of
    ``tests/test_gan.py``) with minibatch-stddev groups of 1 and 2, at 24x24
    (not a power of two: two blocks and a 6x6 final map), and
    ``DualDiscriminator`` with an 8x8 raw input (rtol 1e-5, atol 1e-6); its
    ``ValueError`` on a non-square image;
  * the losses, R1, and their D-parameter gradients (rtol 1e-5, atol 1e-5
    of the largest entry);
  * one adversarial round at ``tests/test_gan.py``'s scene (16x16 rays x 4
    samples, batch 2, adv_weight 0.1, d_reg_interval 2, no density noise)
    with narrow widths: the G phase (reconstruction + adversarial term),
    Dmain (G re-rendered) and Dreg (R1).  Each phase starts both sides from
    the same weights (the port's, after its previous phase), and its
    gradients are held per parameter at relative L2 <= 1e-4, its metrics at
    rtol 1e-4.  The port runs budgeted (overflow 0), JAX in parity mode:
    with no budget overflowing the same samples reach the pixels, and the
    JAX budgeted backward compiles too slowly here.  The JAX side's
    sparse-conv VJP and its vertex voxel / visibility decisions are shared
    as in ``tests/test_torch_train.py`` (ROADMAP Queue C);
  * the D optimizer against optax (zero-nans, Adam with betas ** mb_ratio,
    rate d_lr * mb_ratio) over JAX's Dmain and Dreg gradients: one state,
    a step count of 2, moments rtol 1e-6, parameters rtol 1e-6 + atol 1e-8.

The generator keeps ``random_init_``'s draw: with the decoder's density
bias raised (as other tests do for an opaque body), the gradients of the
observation-volume path shrink to norms of ~1e-8 and f32 rounding alone
spreads them by ~5e-4 between the packages.

The JAX pieces are the package's own (``make_gan_losses``,
``r1_penalty``, ``reconstruction_loss``, ``create_d_train_state``),
composed as ``make_gan_train_step`` composes them, and compiled once per
graph for the whole module.  Weights are the port's draws handed to JAX by
the inverse of ``from_flax`` (no JAX init is compiled).
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.core.config import ModelConfig as JModelConfig
from sherf_tpu.core.config import RenderConfig as JRenderConfig
from sherf_tpu.core.config import TrainConfig as JTrainConfig
from sherf_tpu.data import make_synthetic_batch as j_make_batch
from sherf_tpu.features import discriminator as j_disc
from sherf_tpu.features import sparseconv as j_sc
from sherf_tpu.features import stylegan2 as j_sg2
from sherf_tpu.kernels import filters as j_filters
from sherf_tpu.models import SHERFGenerator as JGenerator
from sherf_tpu.models import generator as j_generator
from sherf_tpu import smpl as j_smpl
from sherf_tpu import train as j_train
from sherf_tpu.train import gan as j_gan
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.calibrate import calibrate_budgets
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig, TrainConfig
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.features import discriminator as t_disc
from sherf_tpu_torch.features import layers as t_layers
from sherf_tpu_torch.features import sparseconv as t_sc
from sherf_tpu_torch.features import stylegan2 as t_sg2
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.geometry.rays import backface_mask as t_backface_mask
from sherf_tpu_torch.kernels import filters as t_filters
from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
from sherf_tpu_torch.nerf.warp import batch_pose_contexts
from sherf_tpu_torch import smpl as t_smpl
from sherf_tpu_torch.train import create_train_state
from sherf_tpu_torch.train import gan as t_gan

T = torch.from_numpy
H = W = 16
DEPTH = 4
BATCH = 2
MODEL_KW = dict(backbone_resolution=32, channel_base=1024, channel_max=32,
                voxel_size=0.02, sparse_conv_layers=2)
D_KW = dict(img_resolution=16, channel_max=32)
TRAIN_KW = dict(batch_size=BATCH, lr=1e-3, adv_weight=0.1, d_reg_interval=2)


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


def _to_flax(model: torch.nn.Module) -> dict:
    """The port's parameters and buffers as flax variables: the inverse of
    ``from_flax`` (as in ``tests/test_torch_branches.py``)."""
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


def _nhwc(x):
    return T(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ------------------------------------------------------------ filters


FIR = {"default": j_filters.setup_filter([1, 3, 3, 1]),
       "asym": np.random.RandomState(4).rand(3, 4).astype(np.float32)}


@pytest.mark.parametrize("fn,padding", [
    ("filter2d", 0), ("filter2d", [1, 2, 0, 3]),
    ("downsample2d", 0), ("downsample2d", [1, 0, 2, 1])])
def test_filter2d_and_downsample2d_match_jax(fn, padding):
    """Every filter (symmetric and not), flip and gain: atol 1e-6."""
    x = np.random.RandomState(3).randn(2, 13, 11, 3).astype(np.float32)
    for name, f in FIR.items():
        for flip in (False, True):
            kw = dict(padding=padding, flip_filter=flip, gain=1.5)
            yj = _np(getattr(j_filters, fn)(jnp.asarray(x), f, **kw))
            yt = getattr(t_filters, fn)(_nhwc(x), f, **kw)
            np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), yj,
                                       atol=1e-6, err_msg=f"{name} {flip}")


@pytest.mark.parametrize("groups", [1, 2])
def test_conv2d_gradients_of_every_order(groups):
    """``filters.conv2d`` (convs, dgrads and wgrads for gradients of every
    order): gradcheck and gradgradcheck in f64, and R1's second-order
    weight gradient equal to torch's own conv's (rtol 1e-10)."""
    g = torch.Generator().manual_seed(groups)
    x = torch.randn(2, 4, 7, 6, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(6, 4 // groups, 3, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    fn = lambda a, b: t_filters.conv2d(a, b, groups)
    assert torch.autograd.gradcheck(fn, (x, w))
    assert torch.autograd.gradgradcheck(fn, (x, w))

    def r1_weight_grad(conv):
        xi = x.detach().requires_grad_(True)
        (gx,) = torch.autograd.grad(conv(xi, w).square().sum(), xi,
                                    create_graph=True)
        return torch.autograd.grad(gx.square().sum(), w)[0]
    ref = r1_weight_grad(lambda a, b: torch.nn.functional.conv2d(
        a, b, groups=groups))
    torch.testing.assert_close(r1_weight_grad(fn), ref, rtol=1e-10, atol=0)


# ------------------------------------------------------------ D modules


@pytest.mark.parametrize("act", ["linear", "lrelu"])
@pytest.mark.parametrize("down", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_equal_conv2d_matches_jax(k, down, act):
    """rtol 1e-5, atol 1e-6, at gain sqrt(0.5) (the D blocks' gain)."""
    x = np.random.RandomState(k * 10 + down).randn(2, 9, 10, 5).astype(
        np.float32)
    jm = j_sg2.EqualConv2d(7, k, activation=act, down=down)
    v = jm.init(jax.random.PRNGKey(k + down), jnp.asarray(x))
    v = {"params": {"weight": v["params"]["weight"],
                    "bias": jnp.asarray(np.random.RandomState(1).randn(7),
                                        jnp.float32)}}
    gain = float(np.sqrt(0.5))
    yj = _np(jm.apply(v, jnp.asarray(x), gain=gain))
    tm = t_sg2.EqualConv2d(5, 7, k, activation=act, down=down)
    tm.load_state_dict(from_flax(jax.device_get(v)), strict=True)
    yt = tm(_nhwc(x), gain=gain).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


def test_minibatch_stddev_matches_jax():
    """Groups of 2, two stddev channels: rtol 1e-5."""
    x = np.random.RandomState(5).randn(4, 5, 6, 8).astype(np.float32)
    yj = _np(j_disc.minibatch_stddev(jnp.asarray(x), 2, num_channels=2))
    yt = t_disc.minibatch_stddev(_nhwc(x), 2, num_channels=2)
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), yj, rtol=1e-5)


D_CASES = {"mbstd1": (16, 1, 2), "mbstd2": (16, 2, 4), "res24": (24, 1, 2)}


@pytest.mark.parametrize("case", list(D_CASES) + ["dual"])
def test_discriminator_logits_match_jax(case):
    """The port's D with the JAX D's weights (bridged by ``from_flax``):
    rtol 1e-5, atol 1e-6.  ``res24``: a 24x24 image at img_resolution 24
    (int(log2 24) = 4: blocks b16 and b8, a 6x6 final map into ``fc``)."""
    rng = np.random.RandomState(len(case))
    if case == "dual":
        img = rng.randn(2, 16, 16, 3).astype(np.float32)
        raw = rng.randn(2, 8, 8, 3).astype(np.float32)
        jm = j_disc.DualDiscriminator(**D_KW)
        v = jm.init(jax.random.PRNGKey(1), img, raw)
        yj = _np(jm.apply(v, img, raw))
        tm = t_disc.DualDiscriminator(**D_KW)
        tm.load_state_dict(from_flax(jax.device_get(v)), strict=True)
        yt = tm(T(img), T(raw)).detach().numpy()
    else:
        res, group, n = D_CASES[case]
        x = rng.randn(n, res, res, 3).astype(np.float32)
        jm = j_disc.Discriminator(img_resolution=res, channel_max=32,
                                  mbstd_group_size=group)
        v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
        yj = _np(jm.apply(v, jnp.asarray(x)))
        tm = t_disc.Discriminator(img_resolution=res, channel_max=32,
                                  mbstd_group_size=group)
        tm.load_state_dict(from_flax(jax.device_get(v)), strict=True)
        yt = tm(_nhwc(x)).detach().numpy()
        if case == "res24":
            assert tm.resolutions == [16, 8] and tm.fc.weight.shape[1] == 32 * 36
    assert yt.shape == yj.shape == (len(yj), 1)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


def test_dual_discriminator_rejects_a_non_square_image():
    """The JAX module fails at its concat on such an image; the port names
    the shape (ROADMAP Queue C)."""
    d = t_disc.DualDiscriminator(**D_KW)
    with pytest.raises(ValueError, match=r"\(2, 16, 12, 3\)"):
        d(torch.zeros(2, 16, 12, 3), torch.zeros(2, 8, 6, 3))


# ------------------------------------------------------------ losses


@pytest.fixture(scope="module")
def d_pair():
    """A DualDiscriminator (16, channel_max 32) drawn by the port's
    ``init_discriminator_`` (seed 1), and its JAX twin."""
    tm = t_disc.DualDiscriminator(**D_KW)
    t_gan.init_discriminator_(tm, torch.Generator().manual_seed(1))
    return tm, j_disc.DualDiscriminator(**D_KW), _to_flax(tm)["params"]


def _grads_close(tm, g_j, rtol=1e-5):
    g_j = from_flax({"params": jax.device_get(g_j)})
    for name, p in tm.named_parameters():
        ref = g_j[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(), err_msg=name)


def test_gan_losses_and_r1_match_jax(d_pair):
    """``g_term``, ``d_term`` (with and without R1) and ``r1_penalty``:
    values and D-parameter gradients at rtol 1e-5 (gradients with an atol
    of 1e-5 of their largest entry)."""
    tm, jm, params = d_pair
    rng = np.random.RandomState(9)
    img = rng.randn(2, 16, 16, 3).astype(np.float32)
    raw = rng.randn(2, 8, 8, 3).astype(np.float32)
    fake = {"image": img + 0.1, "image_raw": raw}
    g_term_j, d_term_j = j_gan.make_gan_losses(jm)
    g_term_t, d_term_t = t_gan.make_gan_losses(tm)
    jfake = {k: jnp.asarray(x) for k, x in fake.items()}
    tfake = {k: T(x) for k, x in fake.items()}

    gv, gg = jax.jit(jax.value_and_grad(g_term_j))(params, jfake)
    tm.zero_grad(set_to_none=True)
    gt = g_term_t(tfake)
    gt.backward()
    np.testing.assert_allclose(float(gt.detach()), float(gv), rtol=1e-5)
    _grads_close(tm, gg)

    (dv, dm), dg = jax.jit(jax.value_and_grad(d_term_j, has_aux=True),
                           static_argnums=(4, 5))(
        params, jfake, jnp.asarray(img), jnp.asarray(raw), 10.0, True)
    tm.zero_grad(set_to_none=True)
    dt, mt = d_term_t(tfake, T(img), T(raw), 10.0, True)
    dt.backward()
    np.testing.assert_allclose(float(dt.detach()), float(dv), rtol=1e-5)
    assert set(mt) == set(dm) == {"d_loss", "scores_fake", "scores_real",
                                  "r1_penalty"}
    for k in dm:
        np.testing.assert_allclose(float(mt[k]), float(dm[k]), rtol=1e-5,
                                   err_msg=k)
    _grads_close(tm, dg)
    assert float(mt["r1_penalty"]) > 0
    # the terms themselves: softplus losses on given logits
    logits = rng.randn(5, 1).astype(np.float32)
    other = rng.randn(5, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(t_gan.g_adversarial_loss(T(logits))),
        float(j_gan.g_adversarial_loss(jnp.asarray(logits))), rtol=1e-6)
    np.testing.assert_allclose(
        float(t_gan.d_loss(T(logits), T(other))),
        float(j_gan.d_loss(jnp.asarray(logits), jnp.asarray(other))),
        rtol=1e-6)


def test_r1_counts_the_image_path_only(d_pair):
    """The same tensor as both inputs: R1 is the gradient through
    ``image`` alone (the raw path's share left out), as JAX's
    ``jax.grad`` over the ``image`` argument."""
    tm, jm, params = d_pair
    real = np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)

    def j_apply(p, image, image_raw):
        return jm.apply({"params": p}, image, image_raw)
    ref = float(jax.jit(lambda p, x: j_gan.r1_penalty(j_apply, p, x, x))(
        params, jnp.asarray(real)))
    x = T(real)
    got = float(t_gan.r1_penalty(tm, x, x))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    both = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(tm(both, both).sum(), both)
    assert abs(float((g * g).sum(dim=(1, 2, 3)).mean()) - got) > 1e-3 * got


# ------------------------------------------------------------ the round


def _exact_conv_core(feats, nbr, w, inv_nbr, valid_in):
    """The JAX sparse conv core differentiated by autodiff (its custom VJP
    is the adjoint only while no two sites share a voxel; see
    ``tests/test_torch_train.py``)."""
    return jnp.einsum("ski,kio->so", j_sc._conv_rows(feats, nbr), w)


def _rel_l2(grads, g_ref):
    """(worst relative L2, its parameter, parameters compared) of the
    port's ``captured`` gradients against ``g_ref`` (a state dict)."""
    worst, worst_name, checked = 0.0, None, 0
    for name, got in grads.items():
        ref = g_ref[name].numpy().astype(np.float64)
        got = got.numpy().astype(np.float64)
        norm = np.linalg.norm(ref)
        if norm <= 1e-8:
            assert np.linalg.norm(got) <= 1e-6, name
            continue
        rel = float(np.linalg.norm(got - ref) / norm)
        if rel > worst:
            worst, worst_name = rel, name
        checked += 1
    return worst, worst_name, checked


def _capture(state):
    """Record the gradients each ``apply_gradients`` of ``state`` steps
    on, by parameter name, in a list."""
    seen = []
    orig = state.apply_gradients

    def apply():
        seen.append({n: (p.grad.detach().clone() if p.grad is not None
                         else torch.zeros_like(p))
                     for n, p in state.model.named_parameters()})
        orig()
    state.apply_gradients = apply
    return seen


@pytest.fixture(scope="module")
def gan_round():
    """One adversarial round on both sides; returns what the tests hold."""
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    bp = j_smpl.big_pose_params()
    tv = t_smpl.smpl_forward(ts, T(bp["poses"]), T(bp["shapes"]))[0].numpy()
    _, out_sh = prepare_voxel_volume(tv, voxel_size=MODEL_KW["voxel_size"])
    jb = j_make_batch(js, batch_size=BATCH, H=H, W=W, seed=0)
    tb = SHERFBatch.from_numpy(jax.device_get(jb))
    render = RenderConfig(depth_resolution=DEPTH, density_noise=0.0)
    fitted, _ = calibrate_budgets([tb], ModelConfig(**MODEL_KW, render=render),
                                  margin=1.15, round_to=128)
    assert fitted.ray_capacity_frac < 1 and fitted.point_capacity_frac < 1

    # the port's G (budgeted) and D, drawn from seeds; JAX gets them bridged
    tm = SHERFGenerator(ModelConfig(**MODEL_KW, render=fitted),
                        out_sh=out_sh, device="cpu")
    random_init_(tm, torch.Generator().manual_seed(0))
    td = t_disc.DualDiscriminator(**D_KW)
    tcfg = TrainConfig(**TRAIN_KW)
    d_state = t_gan.create_d_train_state(td, tcfg,
                                         generator=torch.Generator().manual_seed(1))
    jd = j_disc.DualDiscriminator(**D_KW)
    gv = _to_flax(tm)
    d0 = _to_flax(td)["params"]

    # the port's discrete observation-volume decisions, handed to JAX
    with torch.no_grad():
        obs_feat = tm.encoder_2d_feature(tb.obs_img, extract_feature=True)
        min_dhw = (tb.t_vertices.amin(dim=1) - 0.05)[:, [2, 1, 0]]
        _, t_coords = tm._observation_volume(
            tb, obs_feat, ts, min_dhw, batch_pose_contexts(ts, tb.obs_pose),
            batch_pose_contexts(ts, tb.t_pose))
        t_vis = np.stack([t_backface_mask(
            tb.obs_vertices[b], ts.faces, tb.obs_K[b], tb.obs_R[b],
            tb.obs_T[b]).numpy() for b in range(BATCH)])
    obs_v = _np(jb.obs_vertices)
    orig_volume = JGenerator._observation_volume

    def shared_volume(self, *a, **kw):
        feats, _ = orig_volume(self, *a, **kw)
        return feats, jnp.asarray(t_coords.numpy())

    def shared_vis(verts, faces, K, R, T_):
        out = jnp.asarray(t_vis[0])
        for b in range(1, BATCH):
            out = jnp.where(jnp.all(verts == jnp.asarray(obs_v[b])),
                            jnp.asarray(t_vis[b]), out)
        return out

    jcfg = JModelConfig(**MODEL_KW, render=JRenderConfig(
        depth_resolution=DEPTH, density_noise=0.0))        # parity mode
    jtcfg = JTrainConfig(**TRAIN_KW)
    jm = JGenerator(jcfg, out_sh=out_sh)
    g_adv_j, d_term_j = j_gan.make_gan_losses(jd)
    extra = {k: x for k, x in gv.items() if k != "params"}
    key = jax.random.PRNGKey(3)

    def g_loss(p, dp):
        # make_gan_train_step's g_loss_fn, returning the images too
        out = jm.apply({"params": p, **extra}, jb, js, train=True,
                       noise_mode="none", rngs={"density": key,
                                                "noise": jax.random.fold_in(key, 1)})
        loss, metrics = j_train.reconstruction_loss(out, jb, jtcfg)
        adv = g_adv_j(dp, out)
        metrics["g_adv"] = adv
        metrics["loss"] = loss + jtcfg.adv_weight * adv
        imgs = {"image": out["image"], "image_raw": out["image_raw"]}
        return metrics["loss"], (metrics, imgs)

    def d_main(dp, imgs, real):
        return d_term_j(dp, jax.lax.stop_gradient(imgs), real, real,
                        r1_gamma=jtcfg.r1_gamma, do_r1=False)

    def d_reg(dp, real):
        r1 = j_gan.r1_penalty(lambda p, i, r: jd.apply({"params": p}, i, r),
                              dp, real, real)
        return r1 * (jtcfg.r1_gamma / 2.0) * float(jtcfg.d_reg_interval), r1

    real_j = jb.img * 2.0 - 1.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sc, "_conv_core", _exact_conv_core)
        mp.setattr(JGenerator, "_observation_volume", shared_volume)
        mp.setattr(j_generator, "backface_mask", shared_vis)
        g_vg = jax.jit(jax.value_and_grad(g_loss, has_aux=True))

        # ---- G phase
        (_, (gm_j, _)), gg_j = g_vg(gv["params"], d0)
        g_state = create_train_state(tm, tcfg)
        g_seen = _capture(g_state)
        g_step, d_main_step, d_reg_step = t_gan.make_gan_train_step(tm, ts,
                                                                    tcfg)
        gen = torch.Generator().manual_seed(0)
        gm_t = g_step(g_state, d_state, tb, gen)
        d_untouched = all(p.grad is None for p in td.parameters())

        # ---- Dmain on the G the port's step left (the JAX G re-renders it)
        (_, (_, imgs1)), _ = g_vg(_to_flax(tm)["params"], d0)
        (_, dm_j), dg_main = jax.jit(jax.value_and_grad(d_main, has_aux=True))(
            d0, imgs1, real_j)
        seen_out = []
        hook = tm.register_forward_hook(lambda m, i, o: seen_out.append(o))
        d_seen = _capture(d_state)
        dm_t = d_main_step(d_state, g_state, tb, gen)
        hook.remove()

        # ---- Dreg on the D the port's Dmain left
        d1 = _to_flax(td)["params"]
        (_, r1_j), dg_reg = jax.jit(jax.value_and_grad(d_reg, has_aux=True))(
            d1, real_j)
        dr_t = d_reg_step(d_state, tb)

    (out1, diag1), = seen_out
    return dict(gm_j=jax.device_get(gm_j), gm_t=gm_t,
                gg_j=from_flax({"params": jax.device_get(gg_j)}),
                g_grads=g_seen[0], d_untouched=d_untouched,
                imgs1=jax.device_get(imgs1), out1=out1, diag1=diag1,
                dm_j=jax.device_get(dm_j), dm_t=dm_t,
                dg_main=jax.device_get(dg_main), d_main_grads=d_seen[0],
                r1_j=float(r1_j), dr_t=dr_t,
                dg_reg=jax.device_get(dg_reg), d_reg_grads=d_seen[1],
                d_state=d_state, d0=d0, jd=jd, tcfg=tcfg, jtcfg=jtcfg,
                real=_np(real_j))


def test_gan_round_g_phase_matches_jax(gan_round, record_property):
    """Reconstruction + 0.1 softplus(-D(fake)): the metrics at rtol 1e-4
    and each G parameter's gradient at relative L2 <= 1e-4; D's parameters
    take no gradient; the port's budgets do not overflow."""
    r = gan_round
    gm_t, gm_j = r["gm_t"], r["gm_j"]
    assert int(gm_t["overflow"]) == 0
    assert set(gm_j) <= set(gm_t) and "g_adv" in gm_j
    for k in gm_j:
        np.testing.assert_allclose(float(gm_t[k]), float(gm_j[k]), rtol=1e-4,
                                   err_msg=k)
    assert r["d_untouched"]
    worst, name, checked = _rel_l2(r["g_grads"], r["gg_j"])
    record_property("worst_rel_l2", worst)
    record_property("worst_param", str(name))
    assert checked > 50
    assert worst <= 1e-4, (name, worst)


def test_gan_round_d_main_matches_jax(gan_round, record_property):
    """Dmain: G re-rendered without a graph (its image within 1e-4 of
    JAX's, overflow 0), metrics at rtol 1e-4, D gradients at relative L2
    <= 1e-4 on every parameter."""
    r = gan_round
    assert not r["out1"]["image"].requires_grad
    assert all(int(v) == 0 for v in r["diag1"].values()), r["diag1"]
    for k in ("image", "image_raw"):
        np.testing.assert_allclose(r["out1"][k].numpy(), r["imgs1"][k],
                                   atol=1e-4, err_msg=k)
    assert set(r["dm_t"]) == set(r["dm_j"])
    for k in r["dm_j"]:
        np.testing.assert_allclose(float(r["dm_t"][k]), float(r["dm_j"][k]),
                                   rtol=1e-4, err_msg=k)
    worst, name, checked = _rel_l2(r["d_main_grads"], from_flax(
        {"params": r["dg_main"]}))
    record_property("worst_rel_l2", worst)
    assert checked == len(r["d_main_grads"])
    assert worst <= 1e-4, (name, worst)


def test_gan_round_d_reg_matches_jax(gan_round, record_property):
    """Dreg (R1 scaled by gamma / 2 and the interval): the penalty at rtol
    1e-4, D gradients at relative L2 <= 1e-4.  R1 reaches every weight and
    no bias (a bias shifts the logits, not their slope in the image): the
    biases step on zeros on both sides."""
    r = gan_round
    np.testing.assert_allclose(float(r["dr_t"]["r1_penalty"]), r["r1_j"],
                               rtol=1e-4)
    worst, name, checked = _rel_l2(r["d_reg_grads"], from_flax(
        {"params": r["dg_reg"]}))
    record_property("worst_rel_l2", worst)
    weights = [n for n in r["d_reg_grads"] if n.endswith("weight")]
    assert checked == len(weights)
    assert not any(g.any() for n, g in r["d_reg_grads"].items()
                   if n.endswith("bias"))
    assert worst <= 1e-4, (name, worst)
    assert r["d_state"].step == 2


def test_d_optimizer_matches_optax(gan_round):
    """JAX's Dmain and Dreg gradients through optax (``create_d_train_state``)
    and through the port's D state: one state for both phases, a step count
    of 2 (every parameter's, ``out.bias`` included, which Dreg leaves
    without a gradient in the port, as every bias), moments rtol 1e-6, parameters rtol
    1e-6 + atol 1e-8 (optax's f32 bias correction; see
    ``tests/test_torch_train.py::test_optimizer_matches_optax``)."""
    r = gan_round
    real = jnp.asarray(r["real"])
    js = j_gan.create_d_train_state(r["jd"], real, real, r["jtcfg"],
                                    rng=jax.random.PRNGKey(0))
    js = js.replace(params=r["d0"], opt_state=js.tx.init(r["d0"]))
    td = t_disc.DualDiscriminator(**D_KW)
    td.load_state_dict(from_flax({"params": r["d0"]}), strict=True)
    ts = t_gan.create_d_train_state(td, r["tcfg"])
    for phase in ("dg_main", "dg_reg"):
        g = r[phase]
        js = js.apply_gradients(g)
        gt = from_flax({"params": g})
        for n, p in td.named_parameters():
            p.grad = None if not gt[n].any() else gt[n].clone()
        if phase == "dg_reg":
            assert td.disc.out.bias.grad is None
        t_gan._step_d(ts)
    assert ts.step == int(js.step) == 2
    adam = js.opt_state[1]
    mu = from_flax({"params": jax.device_get(adam.mu)})
    nu = from_flax({"params": jax.device_get(adam.nu)})
    params = from_flax({"params": jax.device_get(js.params)})
    for n, p in td.named_parameters():
        st = ts.opt.state[p]
        assert int(st["step"]) == 2, n
        np.testing.assert_allclose(p.detach().numpy(), params[n].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=n)
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[n].numpy(),
                                   rtol=1e-6, err_msg=n)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[n].numpy(),
                                   rtol=1e-6, err_msg=n)
