"""The port's training path against the JAX package's, on the CPU, on the
same numpy inputs made from a seed and the same weights.

  * ``weighted_accumulate`` (the table-gradient kernel's plain version)
    against ``_scatter_accumulate`` on every row and against the Pallas
    kernel in interpret mode on rows 1.. (the Pallas tile skip leaves out
    id 0, whose row its callers discard): rtol 1e-5, atol 1e-6 (f32 sums
    in another order over bf16-rounded products);
  * ``weighted_gather`` forward (rtol 1e-6) and its table and weight
    gradients against ``jax.grad`` (rtol / atol 1e-4);
  * the train-mode sparse-volume readout: ids and weights equal, values
    rtol 1e-6;
  * the unfused modulated conv (rtol 1e-5), SSIM and the loss (rtol 1e-5);
  * the optimizer: five steps of one gradient sequence, with a NaN entry and
    a learning-rate decay on the way, through optax and through the port:
    moments within rtol 1e-6, parameters and EMA within rtol 1e-6 plus the
    atol that optax's f32 bias correction accounts for (see the test);
  * gradients of the sparse conv stack, and of the whole generator (f32,
    12x12 rays x 4 samples, backbone 32, 2 cm voxels, batch 2) in parity
    and in budgeted mode: relative L2 error <= 1e-3 on every parameter whose
    JAX gradient norm exceeds 1e-8 (the worst is recorded as the test's
    ``worst_rel_l2`` property).  Two differences of the JAX side that are
    not the port's are taken out of its oracle, as the tests say (ROADMAP
    Queue C): its custom submanifold-conv VJP is not the adjoint when sites
    share a voxel, and f32 rounding puts 2 vertices of the generator scene
    into other voxels and flips the visibility of 1;
  * the bf16 budgeted gradients (the production dtype) against JAX's bf16
    ones, gated by JAX's own bf16 error (see BF16_GRAD_FACTOR); JAX's f32
    budgeted gradients are computed once for both budgeted tests;
  * a 3-step ``training_loop`` through ``batch_source``: stats.jsonl holds
    the final partial interval, and its checkpoint restores bit-exactly
    (the loop through ``build_dataset`` is in ``tests/test_torch_eval.py``).
"""

import dataclasses
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.core.calibrate import calibrate_budgets as j_calibrate
from sherf_tpu.core.config import ModelConfig as JModelConfig
from sherf_tpu.core.config import RenderConfig as JRenderConfig
from sherf_tpu.core.config import TrainConfig as JTrainConfig
from sherf_tpu.data import make_synthetic_batch as j_make_batch
from sherf_tpu.features import sparseconv as j_sc
from sherf_tpu.features import stylegan2 as j_sg2
from sherf_tpu.geometry import rays as j_rays
from sherf_tpu.kernels import segment_accum as j_sa
from sherf_tpu.models import SHERFGenerator as JGenerator
from sherf_tpu.models import generator as j_generator
from sherf_tpu.nerf import warp as j_warp
from sherf_tpu import smpl as j_smpl
from sherf_tpu import train as j_train
from sherf_tpu.train import train_state as j_ts
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.config import (DataConfig, ModelConfig, RenderConfig,
                                         TrainConfig)
from sherf_tpu_torch.core.diag import Diag
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.features import sparseconv as t_sc
from sherf_tpu_torch.features import stylegan2 as t_sg2
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.geometry.rays import backface_mask as t_backface_mask
from sherf_tpu_torch.kernels import segment_accum as t_sa
from sherf_tpu_torch.models.generator import SHERFGenerator
from sherf_tpu_torch.nerf.warp import batch_pose_contexts
from sherf_tpu_torch import smpl as t_smpl
from sherf_tpu_torch import train as t_train
from sherf_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads while this module's tests run: the suite runs
    several test processes on one machine, and torch's default of one
    OpenMP thread per core oversubscribes it (the 3-step loop took 116 s
    beside five other workers, 6 s alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jax.device_get(x))


def _accum_inputs(n, k, c, n_rows, seed):
    """ids with duplicates inside rows, ids of 0 and a few ids past the
    table; weights of both signs; f32 grad rows (both sides round to bf16)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n_rows, (n, k)).astype(np.int32)
    dup = rng.rand(n) < 0.3
    ids[dup, 5] = ids[dup, 1]
    ids[dup[::-1], 7] = ids[dup[::-1], 6]
    ids[rng.rand(n) < 0.2, 2] = 0
    ids[rng.rand(n) < 0.05, 3] = n_rows + 7
    w = (rng.rand(n, k) * 2 - 0.5).astype(np.float32)
    g = rng.randn(n, c).astype(np.float32)
    return ids, w, g


@pytest.mark.parametrize("c", [16, 40])
def test_weighted_accumulate_plain_matches_jax(c):
    n, k, n_rows = 5000, 8, 3000
    ids, w, g = _accum_inputs(n, k, c, n_rows, seed=c)
    got = t_sa.weighted_accumulate(T(ids), T(w), T(g), n_rows).numpy()
    ref = _np(j_sa._scatter_accumulate(jnp.asarray(ids), jnp.asarray(w),
                                       jnp.asarray(g), n_rows))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(got[0]).max() > 0          # row 0 is computed, not skipped
    pallas = _np(j_sa.weighted_accumulate(jnp.asarray(ids), jnp.asarray(w),
                                          jnp.asarray(g), n_rows))
    np.testing.assert_allclose(got[1:], pallas[1:], rtol=1e-5, atol=1e-6)


def test_weighted_accumulate_plain_matches_pallas_on_one_id():
    """The CUDA kernel's worst contention, held on its plain version: every
    tap of half the rows on one id, the rest with ids past the table and
    negative ones; against the Pallas kernel in interpret mode on rows 1..
    (same shapes as the test above, so the same compiled kernel)."""
    n, k, c, n_rows = 5000, 8, 16, 3000
    ids, w, g = _accum_inputs(n, k, c, n_rows, seed=31)
    ids[: n // 2] = 7
    rng = np.random.RandomState(32)
    ids[rng.rand(n) < 0.1, 4] = n_rows + 3
    ids[rng.rand(n) < 0.1, 6] = -2
    got = t_sa.weighted_accumulate(T(ids), T(w), T(g), n_rows).numpy()
    pallas = _np(j_sa.weighted_accumulate(jnp.asarray(ids), jnp.asarray(w),
                                          jnp.asarray(g), n_rows))
    np.testing.assert_allclose(got[1:], pallas[1:], rtol=1e-5, atol=1e-6)
    assert np.abs(got[7]).max() > 10 * np.abs(np.delete(got, 7, 0)).max()


def test_weighted_accumulate_rounds_after_deduplication():
    """Two taps on one id in one row: their f32 weights are summed, THEN
    rounded to bf16: 1 + 1.5 * 2^-8 rounds to 1 + 2^-7, where the two
    weights, each exact in bf16, would add up to 1 + 1.5 * 2^-8."""
    ids = torch.tensor([[3, 3, 1]], dtype=torch.int32)
    w = torch.tensor([[1.0, 1.5 * 2 ** -8, 0.5]])
    g = torch.tensor([[1.0, -2.0]])
    out = t_sa.weighted_accumulate(ids, w, g, 5)
    expect = torch.zeros(5, 2)
    expect[3] = torch.tensor([1 + 2 ** -7, -2 * (1 + 2 ** -7)])
    expect[1] = torch.tensor([0.5, -1.0])
    assert torch.equal(out, expect)


def test_weighted_accumulate_cuda_rejects_cpu_tensors():
    """The CUDA entry point checks the device before touching the library;
    the public wrapper takes the plain version only for CPU tensors."""
    ids = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_sa.weighted_accumulate_cuda(ids, torch.zeros(4, 8),
                                      torch.zeros(4, 2), 3)
    with pytest.raises(ValueError):
        t_sa.weighted_accumulate(ids, torch.zeros(4, 7), torch.zeros(4, 2), 3)
    with pytest.raises(TypeError):
        t_sa.weighted_accumulate(ids.float(), torch.zeros(4, 8),
                                 torch.zeros(4, 2), 3)


@pytest.mark.parametrize("w_grad", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_gather_matches_jax(w_grad, dtype):
    rng = np.random.RandomState(5)
    s, c, n, k = 400, 24, 1500, 8
    table = rng.randn(s, c).astype(np.float32)
    ids = rng.randint(0, s, (n, k)).astype(np.int32)
    ids[::7, 3] = ids[::7, 0]
    w = rng.rand(n, k).astype(np.float32)
    cot = rng.randn(n, c).astype(np.float32)
    jt = jnp.asarray(table).astype(dtype)

    def jloss(tab, ww):
        return jnp.sum(j_sa.weighted_gather(tab, jnp.asarray(ids), ww,
                                            w_grad=w_grad) * jnp.asarray(cot))
    yj = _np(j_sa.weighted_gather(jt, jnp.asarray(ids), jnp.asarray(w),
                                  w_grad=w_grad))
    gt_j, gw_j = jax.grad(jloss, argnums=(0, 1))(jt, jnp.asarray(w))

    tt = T(table).to(getattr(torch, dtype)).requires_grad_(True)
    tw = T(w).requires_grad_(True)
    yt = t_sa.weighted_gather(tt, T(ids), tw, w_grad=w_grad)
    (yt * T(cot)).sum().backward()
    assert yt.dtype == torch.float32 and tt.grad.dtype == tt.dtype
    np.testing.assert_allclose(yt.detach().numpy(), yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.grad.float().numpy(),
                               _np(gt_j.astype(jnp.float32)), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), _np(gw_j), rtol=1e-4,
                               atol=1e-4)
    if not w_grad:
        assert not tw.grad.any()


def test_train_readout_matches_jax(monkeypatch):
    """The JAX train-mode readout (corner-packed grid -> weighted_gather)
    against the port's direct 8-corner form, with queries inside, on the
    edges of and outside the volume.  Inside, every (id, weight) tap is
    equal; at the edges the packed grid files the same sites under other
    slots, so there the taps are compared as the (N, S) interpolation
    matrix (column 0, the zero row, excluded)."""
    rng = np.random.RandomState(7)
    shape = (9, 11, 13)
    s, c = 300, 16
    coords = np.stack([rng.randint(0, d, s) for d in shape], -1).astype(np.int32)
    valid = rng.rand(s) < 0.9
    feats = rng.randn(s, c).astype(np.float32)
    n = 4000
    pos = (rng.rand(n, 3) * (np.asarray(shape) + 1.0) - 1.0).astype(np.float32)
    pos[:200] = np.round(pos[:200])                     # on grid planes
    pos[200:300, 0] = shape[0] - 1                      # on the upper face
    pos[300:400, 2] = -0.5                              # half outside

    captured = {}
    orig = j_sc.weighted_gather

    def capture(table, ids, w, w_grad=True):
        captured.update(ids=ids, w=w)
        return orig(table, ids, w, w_grad=w_grad)
    monkeypatch.setattr(j_sc, "weighted_gather", capture)
    jgrid = j_sc.build_index_grid(jnp.asarray(coords), jnp.asarray(valid), shape)
    yj = _np(j_sc.trilinear_site_sample_packed(jnp.asarray(feats), jgrid, shape,
                                               jnp.asarray(pos)))
    ids_j, w_j = _np(captured["ids"]), _np(captured["w"])

    tgrid = t_sc.build_index_grid(T(coords), T(valid), shape)
    assert np.array_equal(tgrid.numpy(), _np(jgrid))
    ids_t, w_t = t_sc.trilinear_corners(tgrid, shape, T(pos))
    yt = t_sc.trilinear_site_sample(T(feats), tgrid, shape, T(pos)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)

    inside = np.all((np.floor(pos) >= 0) & (np.floor(pos) <= np.asarray(shape) - 2),
                    axis=1)
    assert inside.sum() > 1000 and (~inside).sum() > 500
    assert np.array_equal(ids_t.numpy()[inside], ids_j[inside])
    assert np.array_equal(w_t.numpy()[inside], w_j[inside])

    def matrix(ids, w):
        m = np.zeros((n, s + 1), np.float32)
        np.add.at(m, (np.repeat(np.arange(n), 8), ids.reshape(-1)), w.reshape(-1))
        return m[:, 1:]
    assert np.array_equal(matrix(ids_t.numpy(), w_t.numpy()), matrix(ids_j, w_j))


@pytest.mark.parametrize("up,k,demod", [(1, 3, True), (2, 3, True), (1, 1, False)])
def test_unfused_modconv_matches_jax(up, k, demod):
    rng = np.random.RandomState(up * 10 + k)
    b, cin, cout, h = 2, 6, 5, 8
    x = rng.randn(b, h, h, cin).astype(np.float32)
    wgt = rng.randn(k, k, cin, cout).astype(np.float32)
    styles = rng.randn(b, cin).astype(np.float32)
    noise = rng.randn(1, h * up, h * up, 1).astype(np.float32) * 0.1
    kw = dict(up=up, padding=k // 2, demodulate=demod, flip_weight=(up == 1))
    yj = _np(j_sg2.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(styles),
        noise=jnp.asarray(noise), fused_modconv=False,
        resample_filter=j_sg2.DEFAULT_FILTER if up > 1 else None, **kw))
    kw["resample_filter"] = t_sg2.DEFAULT_FILTER if up > 1 else None
    yt = t_sg2.modulated_conv2d(T(x).permute(0, 3, 1, 2),
                                T(wgt).permute(3, 2, 0, 1), T(styles),
                                noise=T(noise).permute(0, 3, 1, 2),
                                fused_modconv=False, **kw)
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), yj, rtol=1e-5,
                               atol=1e-5)
    # the fused form computes the same function
    yf = t_sg2.modulated_conv2d(T(x).permute(0, 3, 1, 2),
                                T(wgt).permute(3, 2, 0, 1), T(styles),
                                noise=T(noise).permute(0, 3, 1, 2),
                                fused_modconv=True, **kw)
    np.testing.assert_allclose(yf.numpy(), yt.numpy(), rtol=1e-4, atol=1e-4)


def test_ssim_and_loss_match_jax():
    rng = np.random.RandomState(3)
    b, h, w = 2, 24, 20
    img = rng.rand(b, h, w, 3).astype(np.float32)
    raw = np.clip(img + rng.randn(b, h, w, 3) * 0.2, 0, 1).astype(np.float32) * 2 - 1
    mask = rng.rand(b, h * w) < 0.7
    bkgd = (rng.rand(b, h * w) < 0.5).astype(np.uint8)
    acc = rng.rand(b, h, w).astype(np.float32)
    pred = raw / 2 + 0.5
    m2 = mask.reshape(b, h, w).astype(np.float32)
    for mk in (None, m2):
        np.testing.assert_allclose(
            t_train.ssim(T(pred), T(img), mask=None if mk is None else T(mk)).numpy(),
            _np(j_train.ssim(jnp.asarray(pred), jnp.asarray(img),
                             mask=None if mk is None else jnp.asarray(mk))),
            rtol=1e-5, atol=1e-6)
    tcfg = TrainConfig()
    jb = types.SimpleNamespace(img=jnp.asarray(img), mask_at_box=jnp.asarray(mask),
                               bkgd_msk=jnp.asarray(bkgd))
    tb = types.SimpleNamespace(img=T(img), mask_at_box=T(mask), bkgd_msk=T(bkgd))
    _, mj = j_train.reconstruction_loss(
        {"image_raw": jnp.asarray(raw), "weights_image": jnp.asarray(acc)}, jb,
        JTrainConfig())
    _, mt = t_train.reconstruction_loss(
        {"image_raw": T(raw), "weights_image": T(acc)}, tb, tcfg)
    assert set(mt) == set(mj)
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)


def test_optimizer_matches_optax():
    """zero-nans + Adam(0, 0.99) + step LR + EMA: five steps of the same
    gradients, one holding a NaN, with the rate halving after step 3."""
    rng = np.random.RandomState(11)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    init = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.randn(*s) * 10.0 ** rng.randint(-3, 2)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(5)]
    grads[1]["a"][2, 1] = np.nan
    kw = dict(batch_size=2, lr=1e-2, lr_decay_images=6, ema_kimg=0.01)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    beta = j_ts.ema_beta(jcfg.batch_size, jcfg.ema_kimg)
    assert beta == t_train.ema_beta(tcfg.batch_size, tcfg.ema_kimg)

    js = j_train.create_train_state({n: jnp.asarray(v) for n, v in init.items()},
                                    {}, jcfg)
    model = torch.nn.Module()
    for n, v in init.items():
        model.register_parameter(n, torch.nn.Parameter(T(v.copy())))
    ts = t_train.create_train_state(model, tcfg)
    for g in grads:
        js = js.apply_gradients({n: jnp.asarray(v) for n, v in g.items()})
        js = js.replace(ema_params=j_train.ema_update(js.ema_params, js.params,
                                                      beta))
        for n, p in model.named_parameters():
            p.grad = T(g[n].copy())
        ts.apply_gradients()
        t_train.ema_update(ts.ema, model.named_parameters(), beta)
    assert ts.step == int(js.step) == 5
    adam = js.opt_state[1]
    # Parameters and EMA: rtol 1e-6, plus atol 5e-8 for entries that the
    # updates have carried close to zero.  optax takes Adam's bias
    # corrections in f32 (1 - 0.99 ** 1 is off by ~1e-6 relative), torch in
    # f64, so each update of ~lr differs by up to ~1e-6 * lr: five steps at
    # lr 1e-2 give 5e-8.  The moments do not see the bias correction.
    for n, p in model.named_parameters():
        st = ts.opt.state[p]
        for got, ref, atol in ((p.detach(), js.params[n], 5e-8),
                               (ts.ema[n], js.ema_params[n], 5e-8),
                               (st["exp_avg"], adam.mu[n], 0.0),
                               (st["exp_avg_sq"], adam.nu[n], 0.0)):
            np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6,
                                       atol=atol, err_msg=n)
    assert not np.isnan(model.a.detach().numpy()).any()


# ------------------------------------------------- whole-generator gradients

GRAD_KW = dict(backbone_resolution=32, voxel_size=0.02, channel_base=1024,
               channel_max=32)


def _exact_conv_core(feats, nbr, w, inv_nbr, valid_in):
    """The JAX submanifold / strided conv core differentiated by autodiff:
    the adjoint of its forward.  The JAX package's custom VJP
    (``sparseconv._conv_core``) takes the inverse neighbour table
    ``nbr[:, ::-1]``, which is the adjoint only while no two sites share a
    voxel; the observation volume's vertex sites do share voxels."""
    return jnp.einsum("ski,kio->so", j_sc._conv_rows(feats, nbr), w)


@pytest.mark.parametrize("dup", [False, True])
def test_sparse_conv_net_gradients_match_jax(dup, monkeypatch):
    """Gradients of the sparse conv stack + 3-scale readout (f32) for the
    weights and the site features: rtol / atol 1e-4 (measured ~1e-6).
    With unique site coordinates the oracle is the JAX package's own custom
    VJP; with sites that share voxels (as the SMPL vertices do) it is the
    autodiff adjoint of the same forward (see ``_exact_conv_core``)."""
    rng = np.random.RandomState(21)
    shape, caps, n = (24, 40, 36), (512, 256, 128), 600
    c = np.stack([rng.randint(2, d - 2, n) for d in shape], -1).astype(np.int32)
    if dup:
        c[1::3] = c[0::3][:len(c[1::3])]
        monkeypatch.setattr(j_sc, "_conv_core", _exact_conv_core)
    else:
        c = np.unique(c, axis=0)
        rng.shuffle(c)
    f = rng.randn(len(c), 32).astype(np.float32)
    q = (rng.rand(400, 3) * (np.asarray(shape) - 1)).astype(np.float32)
    cot = rng.randn(400, 192).astype(np.float32)
    jm = j_sc.SparseConvNet(num_layers=4, out_sh=shape, caps=caps)
    args = (jnp.asarray(f), jnp.asarray(c), jnp.asarray(q))
    v = jax.tree_util.tree_map(np.array, jax.device_get(
        jax.jit(lambda *a: jm.init(jax.random.PRNGKey(5), *a))(*args)))

    def loss(p, ff):
        return jnp.sum(jm.apply({**v, "params": p}, ff, args[1], args[2],
                                train=True) * jnp.asarray(cot))
    gp, gf = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], args[0])
    gp = from_flax({"params": jax.device_get(gp)})
    tm = t_sc.SparseConvNet(num_layers=4, out_sh=shape, caps=caps)
    tm.load_state_dict(from_flax(v), strict=True)
    tf = T(f).requires_grad_(True)
    (tm(tf, T(c), T(q), Diag()) * T(cot)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), _np(gf), rtol=1e-4, atol=1e-4)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gp[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def grad_scene():
    js, ts = j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")
    bp = j_smpl.big_pose_params()
    tv = t_smpl.smpl_forward(ts, torch.from_numpy(bp["poses"]),
                             torch.from_numpy(bp["shapes"]))[0].numpy()
    _, out_sh = prepare_voxel_volume(tv, voxel_size=GRAD_KW["voxel_size"])
    jb = j_make_batch(js, batch_size=2, H=12, W=12, seed=0)
    tb = SHERFBatch.from_numpy(jax.device_get(jb))
    render = JRenderConfig(depth_resolution=4, density_noise=0.0)
    jm = JGenerator(JModelConfig(**GRAD_KW, render=render), out_sh=out_sh)
    v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, js))(jb)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    v.pop("diag", None)
    # the port's discrete observation-volume decisions (each vertex's site
    # voxel and its visibility), handed to the JAX side too
    tm = SHERFGenerator(ModelConfig(**GRAD_KW), out_sh=out_sh, device="cpu")
    tm.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        obs_feat = tm.encoder_2d_feature(tb.obs_img, extract_feature=True)
        min_dhw = (tb.t_vertices.amin(dim=1) - 0.05)[:, [2, 1, 0]]
        _, t_coords = tm._observation_volume(
            tb, obs_feat, ts, min_dhw, batch_pose_contexts(ts, tb.obs_pose),
            batch_pose_contexts(ts, tb.t_pose))
        t_vis = torch.stack([t_backface_mask(tb.obs_vertices[b], ts.faces,
                                             tb.obs_K[b], tb.obs_R[b],
                                             tb.obs_T[b])
                             for b in range(tb.obs_vertices.shape[0])])
    return dict(js=js, ts=ts, jb=jb, tb=tb, v=v, out_sh=out_sh, render=render,
                t_coords=t_coords.numpy(), t_vis=t_vis.numpy())


def _render_config(scene, mode):
    render = scene["render"]
    if mode == "parity":
        return render
    # the production budgeted path: calibrated ray / point / exact budgets
    fitted, _ = j_calibrate([scene["jb"]], JModelConfig(**GRAD_KW, render=render),
                            margin=1.15, round_to=128)
    assert fitted.ray_capacity_frac < 1 and fitted.point_capacity_frac < 1 \
        and fitted.exact_capacity_frac < 1
    return fitted


def _share_port_decisions(mp, sc):
    """Take out of the JAX oracle the differences that are not the port's
    (ROADMAP Queue C).  Its submanifold conv is differentiated by autodiff
    (``_exact_conv_core``).  And it is handed two discrete decisions of the
    port's observation volume that f32 rounding flips between the packages
    on this scene: the site voxel of each vertex (2 of the 13,780 vertices
    land in a neighbouring voxel) and each vertex's visibility (1 grazing
    vertex flips).  Left in, they move the coarse sparse-conv gradients by
    up to ~1.5e-2 (custom VJP: ~0.5)."""
    mp.setattr(j_sc, "_conv_core", _exact_conv_core)
    orig_volume = JGenerator._observation_volume

    def shared_volume(self, *a, **kw):
        feats, coords = orig_volume(self, *a, **kw)
        assert coords.shape == sc["t_coords"].shape
        return feats, jnp.asarray(sc["t_coords"])
    mp.setattr(JGenerator, "_observation_volume", shared_volume)
    obs_v = _np(sc["jb"].obs_vertices)

    def shared_vis(verts, faces, K, R, T):
        # called per batch item under vmap: pick the item by its vertices
        out = jnp.asarray(sc["t_vis"][0])
        for b in range(1, len(obs_v)):
            out = jnp.where(jnp.all(verts == jnp.asarray(obs_v[b])),
                            jnp.asarray(sc["t_vis"][b]), out)
        return out
    mp.setattr(j_generator, "backface_mask", shared_vis)


def _jax_grads(sc, render, compute_dtype="float32"):
    """JAX's loss and gradients (a port ``state_dict`` of numpy-backed
    tensors) of one train-mode forward on the scene, with the port's
    decisions shared."""
    with pytest.MonkeyPatch.context() as mp:
        _share_port_decisions(mp, sc)
        jm = JGenerator(JModelConfig(**GRAD_KW, render=render,
                                     compute_dtype=compute_dtype),
                        out_sh=sc["out_sh"])
        params, extra = sc["v"]["params"], {k: x for k, x in sc["v"].items()
                                            if k != "params"}
        jcfg_t = JTrainConfig(batch_size=2)

        def loss_fn(p):
            out = jm.apply({"params": p, **extra}, sc["jb"], sc["js"],
                           train=True, noise_mode="none",
                           rngs={"density": jax.random.PRNGKey(3),
                                 "noise": jax.random.PRNGKey(4)})
            return j_train.reconstruction_loss(out, sc["jb"], jcfg_t)[0]
        loss_j, g_j = jax.jit(jax.value_and_grad(loss_fn))(params)
        return float(loss_j), from_flax({"params": jax.device_get(g_j)})


@pytest.fixture(scope="module")
def budgeted_f32_grads(grad_scene):
    """JAX's f32 gradients in budgeted mode (the production budgets),
    computed once for the f32 and the bf16 gradient tests."""
    render = _render_config(grad_scene, "budgeted")
    return render, _jax_grads(grad_scene, render)


def _port_grads(sc, render, compute_dtype="float32"):
    cfg = ModelConfig(**GRAD_KW, compute_dtype=compute_dtype,
                      render=RenderConfig(**dataclasses.asdict(render)))
    tm = SHERFGenerator(cfg, out_sh=sc["out_sh"], device="cpu")
    tm.load_state_dict(from_flax(sc["v"]), strict=True)
    out, diag = tm(sc["tb"], sc["ts"], train=True)
    assert all(int(x) == 0 for x in diag.values()), diag
    loss_t, _ = t_train.reconstruction_loss(out, sc["tb"], TrainConfig(batch_size=2))
    loss_t.backward()
    return float(loss_t.detach()), tm


def _rel_l2(got, ref):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("mode", ["parity", "budgeted"])
def test_generator_gradients_match_jax(grad_scene, mode, record_property,
                                       budgeted_f32_grads):
    """The JAX side runs with the port's discrete decisions shared and its
    conv VJP taken by autodiff (``_share_port_decisions``)."""
    sc = grad_scene
    if mode == "budgeted":
        render, (loss_j, g_j) = budgeted_f32_grads
    else:
        render = _render_config(sc, mode)
        loss_j, g_j = _jax_grads(sc, render)
    loss_t, tm = _port_grads(sc, render)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)

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
    assert checked > 100
    assert worst <= 1e-3, (worst_name, worst)


# The bf16 gradient gates (measured on this scene, with oneDNN off as the
# test runs: over 204 leaves, rel(port bf16, JAX bf16) / rel(JAX bf16, JAX
# f32) has median 1.21 and maximum 1.99; rel(port bf16, JAX f32) / rel(JAX
# bf16, JAX f32) median 1.05, maximum 2.04; the port's f32 gradients sit
# ~1e-6 from JAX's).  The two packages round to bf16 at the same casting
# points but accumulate in other orders, so their bf16 errors are of one
# size and largely independent: two independent errors of equal size e sit
# ~sqrt(2) e apart.  Hence, per leaf, the port's bf16 gradient lies within
# BF16_GRAD_FACTOR times JAX's own bf16 error (floored at BF16_GRAD_FLOOR)
# of JAX's bf16 gradient, and the median of that ratio over the leaves is
# at most BF16_GRAD_MEDIAN (sqrt(2) and a margin).  The literal gate, the
# port no farther from JAX bf16 than JAX bf16 is from JAX f32 on every leaf,
# holds on 37 of the 204 (ROADMAP Queue C); the count is recorded.
BF16_GRAD_FLOOR = 1e-3
BF16_GRAD_FACTOR = 3.0
BF16_GRAD_MEDIAN = 1.5


def test_bf16_budgeted_gradients_match_jax(grad_scene, budgeted_f32_grads,
                                           record_property):
    """The production dtype's gradients (bf16, budgeted), on every leaf
    whose JAX f32 gradient norm exceeds 1e-8, held by JAX's own bf16 error
    (see BF16_GRAD_FACTOR).  And the port ran bf16: its gradients sit as far
    from JAX's f32 ones as JAX's bf16 ones do (median ratio >= 0.5; a port
    left in f32 sits ~1e-6 away).

    The port's bf16 gradients are taken with oneDNN off: torch's CPU
    (oneDNN) bf16 convolution returns wrong weight gradients, NaN or
    ~1e17, for a 1x1 input at stride 2, which this 12x12 scene gives
    ResNet18's layer4 (ROADMAP Queue C); torch's own CPU kernel is right.
    The card runs cuDNN."""
    sc = grad_scene
    render, (_, g_f32) = budgeted_f32_grads
    loss_j, g_bf16 = _jax_grads(sc, render, "bfloat16")
    with torch.backends.mkldnn.flags(enabled=False):
        loss_t, tm = _port_grads(sc, render, "bfloat16")
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-2)
    ratios, own, literal, worst_name = [], [], 0, None
    for name, p in tm.named_parameters():
        ref32 = g_f32[name].numpy()
        if np.linalg.norm(ref32.astype(np.float64)) <= 1e-8:
            continue
        ref = g_bf16[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        jax_err = _rel_l2(ref, ref32)
        port = _rel_l2(got, ref)
        literal += port <= jax_err
        ratio = port / max(jax_err, BF16_GRAD_FLOOR)
        if not ratios or ratio > max(ratios):
            worst_name = name
        ratios.append(ratio)
        own.append(_rel_l2(got, ref32) / max(jax_err, BF16_GRAD_FLOOR))
    record_property("bf16_worst_ratio", float(max(ratios)))
    record_property("bf16_median_ratio", float(np.median(ratios)))
    record_property("bf16_worst_param", str(worst_name))
    record_property("bf16_literal_gate_leaves", f"{literal}/{len(ratios)}")
    assert len(ratios) > 100
    assert max(ratios) <= BF16_GRAD_FACTOR, (worst_name, max(ratios))
    assert np.median(ratios) <= BF16_GRAD_MEDIAN, np.median(ratios)
    assert np.median(own) >= 0.5, np.median(own)


def test_shared_volume_decisions_match_jax(grad_scene, record_property):
    """The port's vertex voxels and visibility, which the gradient test
    hands to the JAX side, against the JAX package's own on the same scene:
    at most 2 vertices lie in another voxel, each within f32 rounding of a
    voxel boundary (its unrounded voxel coordinate within 1e-4 of a half
    integer; measured 4.8e-7), and at most 1 vertex differs in visibility, on a grazing face
    (|cos| of its normal and view ray below 1e-3).  A port fault in either
    decision moves far more vertices than that."""
    sc = grad_scene
    js, jb, vs = sc["js"], sc["jb"], GRAD_KW["voxel_size"]
    jm = JGenerator(JModelConfig(**GRAD_KW, render=sc["render"]),
                    out_sh=sc["out_sh"])

    @jax.jit
    def jax_decisions(batch):
        ctx = jax.vmap(lambda p: j_warp.make_pose_context(js, p))
        ctx_obs, ctx_big = ctx(batch.obs_pose), ctx(batch.t_pose)
        min_dhw = (jnp.min(batch.t_vertices, axis=1) - 0.05)[:, (2, 1, 0)]
        obs_feat = jnp.zeros(batch.obs_img.shape[:3] + (64,), jnp.float32)
        _, coords = jm.apply({k: x for k, x in sc["v"].items()}, batch,
                             obs_feat, js, min_dhw, ctx_obs, ctx_big,
                             method=JGenerator._observation_volume)
        smpl_obs = jnp.einsum("bvc,bcd->bvd", batch.obs_vertices
                              - ctx_obs.Th[:, None], ctx_obs.R,
                              precision=jax.lax.Precision.HIGHEST)
        vid = jnp.arange(smpl_obs.shape[1])
        warped = jax.vmap(lambda co, cb, q: j_warp.deform_target2c(
            js, co, cb, vid, q))(ctx_obs, ctx_big, smpl_obs)
        f = jax.vmap(lambda p, m: j_sc.world_to_voxel_f(p, m, vs))(warped,
                                                                   min_dhw)

        def view(v, K, R, T):
            _, cam = j_rays.project_points(v, K, R, T)
            n_cam = j_rays.vertex_normals(v, js.faces) @ R.T
            cos = jnp.sum(n_cam * cam, -1) / jnp.maximum(
                jnp.linalg.norm(n_cam, axis=-1) * jnp.linalg.norm(cam, axis=-1),
                1e-12)
            return j_rays.backface_mask(v, js.faces, K, R, T), cos
        vis, cos = jax.vmap(view)(batch.obs_vertices, batch.obs_K, batch.obs_R,
                                  batch.obs_T)
        return coords, f, vis, cos

    coords, f, vis, cos = map(_np, jax_decisions(jb))
    np.testing.assert_array_equal(coords, np.round(f).astype(np.int32))
    moved = np.any(coords != sc["t_coords"], axis=-1)          # (B, V)
    flipped = vis != sc["t_vis"]
    # distance of each moved vertex's nearest axis to a rounding boundary
    off = np.abs(np.abs(f - np.floor(f)) - 0.5)[moved].min(axis=-1)
    record_property("voxels_moved", int(moved.sum()))
    record_property("vis_flipped", int(flipped.sum()))
    record_property("boundary_offset", float(off.max(initial=0.0)))
    assert moved.sum() <= 2, np.argwhere(moved)
    assert np.all(np.abs(coords - sc["t_coords"])[moved] <= 1)
    assert np.all(off <= 1e-4), off
    assert flipped.sum() <= 1, np.argwhere(flipped)
    assert np.all(np.abs(cos[flipped]) <= 1e-3), cos[flipped]


# ----------------------------------------------------------- training loop

def test_training_loop_writes_stats_and_restorable_checkpoint(tmp_path):
    ts = t_smpl.synthetic_smpl(0, device="cpu")
    cfg = ModelConfig(**GRAD_KW, render=RenderConfig(depth_resolution=4,
                                                     point_capacity_frac=0.5))
    # 3 steps at batch 1, a report every 2: the 3rd step is a partial interval
    tcfg = TrainConfig(batch_size=1, total_kimg=0.003, report_imgs=2,
                       lr=1e-3, outdir=str(tmp_path))
    seeds = iter(range(100))

    def batch_source():
        return make_synthetic_batch(ts, batch_size=1, H=12, W=12,
                                    seed=next(seeds), device="cpu")
    state = t_train.training_loop(cfg, tcfg, DataConfig(), ts,
                                  batch_source=batch_source, device="cpu")
    assert state.step == 3
    lines = [json.loads(x) for x in open(tmp_path / "stats.jsonl")]
    loss_lines = [x for x in lines if "Loss/loss" in x]
    assert [x["step"] for x in loss_lines] == [2, 3]
    assert all(np.isfinite(x["Loss/loss"]) and x["Loss/overflow"] == 0
               for x in loss_lines)

    path = latest_checkpoint(str(tmp_path / "checkpoints"))
    assert path is not None and path.endswith("snapshot-000003.pt")
    model = SHERFGenerator(state.model.cfg, out_sh=state.model.renderer.out_sh,
                           device="cpu")
    fresh = t_train.create_train_state(model, tcfg)
    restore_checkpoint(path, fresh)
    assert fresh.step == 3
    sd0, sd1 = state.model.state_dict(), fresh.model.state_dict()
    assert sd0.keys() == sd1.keys()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert all(torch.equal(state.ema[k], fresh.ema[k]) for k in state.ema)
    o0, o1 = state.opt.state_dict(), fresh.opt.state_dict()
    assert o0["param_groups"] == o1["param_groups"]
    assert o0["state"].keys() == o1["state"].keys()
    for i in o0["state"]:
        for key in o0["state"][i]:
            assert torch.equal(o0["state"][i][key], o1["state"][i][key])


def test_training_loop_needs_a_batch_source(tmp_path):
    """Without a batch_source the loop builds its dataset: a file-backed
    loader without its files raises instead of a stand-in."""
    ts = t_smpl.synthetic_smpl(0, device="cpu")
    with pytest.raises(FileNotFoundError):
        t_train.training_loop(ModelConfig(), TrainConfig(outdir=str(tmp_path)),
                              DataConfig(name="thuman"), ts, device="cpu")
