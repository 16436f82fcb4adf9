"""The port's GAN metric suite against the JAX package's, on the CPU, and
the two GAN entry points run through the port alone:

  * ``InceptionV3`` pool3 features and logits against the JAX module on 2
    images of 320x320 (larger than 299, so the antialiased shrink is
    covered), with one random state dict in torchvision naming loaded into
    both (JAX through ``import_inception_state_dict``): rtol 1e-4, atol
    1e-4; the state-dict loader's strictness;
  * every ``eval/gan_metrics.py`` function against JAX's on the same
    features (rtol 1e-6; both are numpy, the port's is a copy);
  * ``default_extractor``'s order: Inception, then the LPIPS VGG tower,
    then None;
  * the train CLI with ``--adv_weight 0.1 --d_reg_interval 2`` for 2 steps
    at a small size (its stats.jsonl carries ``g_adv``, ``d_loss``,
    ``scores_*`` and ``r1_penalty``), then the calc_metrics CLI with
    ``--resume`` on its snapshot and random Inception and LPIPS state
    dicts through the environment variables: every metric finite, EQ-T and
    EQ-R reported; and the FID of a feature set against itself below 1e-4.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.eval import gan_metrics as j_gm
from sherf_tpu.features import inception as j_inc
from sherf_tpu_torch.cli import calc_metrics as t_calc
from sherf_tpu_torch.cli import train as t_train_cli
from sherf_tpu_torch.eval import gan_metrics as t_gm
from sherf_tpu_torch.features import discriminator as t_disc
from sherf_tpu_torch.features import inception as t_inc
from sherf_tpu_torch.train import lpips as t_lpips
from sherf_tpu_torch.train.checkpoint import latest_checkpoint
import sherf_tpu_torch.train.loop as t_loop

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads (as ``tests/test_torch_train.py``): the suite
    runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def random_inception_state_dict(seed: int):
    """A random state dict in torchvision's InceptionV3 naming: He-scaled
    convolutions, BN statistics and affines near the identity, a small
    fc."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in t_inc.InceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
        elif v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("bn.weight"):
            sd[k] = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
        elif k == "fc.weight":
            sd[k] = torch.randn(v.shape, generator=g) * 0.02
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    return sd


def random_lpips_state_dict(seed: int):
    """A random state dict in the lpips package's naming (as
    ``tests/test_torch_loaders.py``)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in t_lpips.LPIPS().state_dict().items():
        if k.startswith("scaling_layer."):
            sd[k] = v.clone()
        elif k.startswith("lins."):
            sd[k] = torch.rand(v.shape, generator=g) * 0.1
        elif v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
    return sd


@pytest.fixture(scope="module")
def inception_sd():
    return random_inception_state_dict(0)


# ------------------------------------------------------------ InceptionV3


def test_inception_matches_jax_above_299(inception_sd):
    """2 images of 320x320 in [0, 1]: pool3 (N, 2048) and logits (N, 1008)
    at rtol 1e-4, atol 1e-4; the features are not degenerate."""
    x = np.random.RandomState(0).rand(2, 320, 320, 3).astype(np.float32)
    params = j_inc.import_inception_state_dict(
        {k: v.numpy() for k, v in inception_sd.items()})
    fj, lj = jax.jit(lambda p, x: j_inc.InceptionV3().apply(
        {"params": p}, x))(params, jnp.asarray(x))
    net = t_inc.make_inception(inception_sd, device="cpu")
    with torch.no_grad():
        ft, lt = net(T(x))
    assert ft.shape == (2, t_inc.FEATURE_DIM) and lt.shape == (2, 1008)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    assert float(ft.std()) > 1e-2 and not torch.equal(ft[0], ft[1])


def test_inception_state_dict_loading(inception_sd, tmp_path, monkeypatch):
    """torchvision's extra auxiliary head and a missing
    ``num_batches_tracked`` load; a missing weight raises; the file is
    read from ``SHERF_INCEPTION_WEIGHTS`` only when it exists."""
    sd = {k: v for k, v in inception_sd.items()
          if not k.endswith("num_batches_tracked")}
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    t_inc.load_inception_state_dict(t_inc.InceptionV3(), sd)
    bad = dict(sd)
    del bad["Mixed_7c.branch_pool.conv.weight"]
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool.conv.weight"):
        t_inc.load_inception_state_dict(t_inc.InceptionV3(), bad)
    monkeypatch.setenv("SHERF_INCEPTION_WEIGHTS", str(tmp_path / "absent.pt"))
    assert t_inc.load_inception_params() is None
    assert t_inc.inception_extractor(device="cpu") is None
    path = tmp_path / "inception.pt"
    torch.save(sd, path)
    monkeypatch.setenv("SHERF_INCEPTION_WEIGHTS", str(path))
    assert set(t_inc.load_inception_params()) == set(sd)


# ------------------------------------------------------------ statistics


def _feats(seed, n=40, d=12):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) @ rng.randn(d, d) * 0.3 + rng.randn(d)).astype(
        np.float32)


def _feature_stats(m):
    s = m.FeatureStats(capture_all=True, max_items=33)
    s.append(_feats(1)[:25])
    s.append(_feats(1)[25:])            # cut to max_items
    return s.get_mean_cov() + (s.get_all(), s.num_items)


def _softmax(x):
    e = np.exp(x - x.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


STATS = {
    "feature_stats": _feature_stats,
    "frechet_distance": lambda m: m.frechet_distance(
        _feats(1).mean(0), np.cov(_feats(1).T), _feats(2).mean(0),
        np.cov(_feats(2).T)),
    "kernel_distance": lambda m: m.kernel_distance(
        _feats(1), _feats(2), num_subsets=20, max_subset_size=30),
    "precision_recall": lambda m: m.precision_recall(_feats(1), _feats(3)),
    "slerp": lambda m: m.slerp(_feats(1)[:5], _feats(2)[:5],
                               np.linspace(0, 1, 5)[:, None]),
    "perceptual_path_length": lambda m: m.perceptual_path_length(
        np.abs(_feats(4)[:, 0]) * 1e-8, epsilon=1e-4),
    "inception_score": lambda m: m.inception_score(_softmax(_feats(5)),
                                                   num_splits=4),
    "equivariance_psnr": lambda m: (
        m.equivariance_psnr(_feats(1) / 9, _feats(2) / 9),
        m.equivariance_psnr(_feats(1) / 9, _feats(2) / 9, _feats(3) > 0),
        m.equivariance_psnr(_feats(1), _feats(1), np.zeros((40, 12), bool))),
    "compute_fid": lambda m: m.compute_fid(
        _feats(1).reshape(40, 2, 2, 3), _feats(2).reshape(40, 2, 2, 3),
        lambda x: np.asarray(x).reshape(len(x), -1)),
}


@pytest.mark.parametrize("name", sorted(STATS))
def test_gan_metrics_match_jax(name):
    """The port's statistics against the JAX package's on the same
    features: rtol 1e-6 (NaN where JAX gives NaN)."""
    got, ref = STATS[name](t_gm), STATS[name](j_gm)
    if not isinstance(ref, tuple):
        got, ref = (got,), (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r, np.float64), rtol=1e-6,
                                   err_msg=name)


def test_default_extractor_order(inception_sd, tmp_path, monkeypatch):
    """Inception when its weights exist; else the LPIPS VGG tower (its last
    stage, averaged over space: (N, 512)); else None.  The FID of a set
    against itself is below 1e-4."""
    monkeypatch.setattr(t_lpips, "_TRIED", False)
    monkeypatch.setattr(t_lpips, "_LPIPS_PARAMS", None)
    monkeypatch.setenv("SHERF_INCEPTION_WEIGHTS", str(tmp_path / "none.pt"))
    monkeypatch.setenv("SHERF_LPIPS_WEIGHTS", str(tmp_path / "none.pt"))
    assert t_gm.default_extractor("cpu") is None
    lp = tmp_path / "lpips.pt"
    torch.save(random_lpips_state_dict(1), lp)
    monkeypatch.setattr(t_lpips, "_TRIED", False)
    monkeypatch.setenv("SHERF_LPIPS_WEIGHTS", str(lp))
    imgs = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    ext = t_gm.default_extractor("cpu")
    vgg = ext(imgs)
    assert vgg.shape == (2, 512) and np.isfinite(vgg).all()
    # the FID of a feature set against itself (the scipy square root of a
    # 512-dim covariance; Inception's 2048 take ~11 s here)
    more = np.random.RandomState(3).rand(6, 32, 32, 3).astype(np.float32)
    assert t_gm.compute_fid(more, more, ext) < 1e-4
    inc = tmp_path / "inception.pt"
    torch.save(inception_sd, inc)
    monkeypatch.setenv("SHERF_INCEPTION_WEIGHTS", str(inc))
    feats = t_gm.default_extractor("cpu")(imgs)
    assert feats.shape == (2, t_inc.FEATURE_DIM)


# ------------------------------------------------------------ entry points


SMALL = dict(backbone_resolution=32, channel_base=1024, channel_max=32,
             voxel_size=0.02, sparse_conv_layers=2)
FLAGS = ["--neural_rendering_resolution_initial", "32", "--depth_resolution",
         "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    """The train CLI with the adversarial phases on: 2 steps at batch 1 on
    the synthetic_grid rig at 32x32 rays x 4 samples, with the small
    generator widths and a D of channel_max 32 (the CLI's own D is
    512 channels wide; what is held is the CLI's handling of the phases)."""
    run = tmp_path_factory.mktemp("gan_run")
    with pytest.MonkeyPatch.context() as mp:
        build = t_train_cli.model_config_from_args
        mp.setattr(t_train_cli, "model_config_from_args",
                   lambda a: dataclasses.replace(build(a), **SMALL))
        train = t_loop.training_loop
        mp.setattr(t_loop, "training_loop", lambda cfg, tcfg, *a, **kw: train(
            cfg, dataclasses.replace(tcfg, total_kimg=0.002), *a, **kw))
        dual = t_disc.DualDiscriminator
        mp.setattr(t_disc, "DualDiscriminator",
                   lambda img_resolution: dual(img_resolution, channel_max=32))
        t_train_cli.main(["--outdir", str(run), "--cfg", "synthetic_grid",
                          "--batch", "1", "--workers", "1", "--num_instance",
                          "2", "--adv_weight", "0.1", "--d_reg_interval",
                          "2"] + FLAGS)
    return run


def test_train_cli_runs_the_adversarial_phases(gan_run):
    """``--adv_weight 0.1`` trains (no longer refused): the flushed line
    holds the G and D metrics, R1's from step 0, and a snapshot of G."""
    lines = [json.loads(x) for x in open(gan_run / "stats.jsonl")]
    loss = [x for x in lines if "Loss/loss" in x]
    assert [x["step"] for x in loss] == [2]
    for k in ("g_adv", "d_loss", "scores_fake", "scores_real", "r1_penalty",
              "loss", "overflow"):
        assert np.isfinite(loss[0][f"Loss/{k}"]), k
    assert loss[0]["Loss/overflow"] == 0
    snap = latest_checkpoint(str(gan_run / "checkpoints"))
    assert snap.endswith("snapshot-000002.pt")
    ck = torch.load(snap, map_location="cpu", weights_only=True)
    assert not any(k.startswith("disc.") for k in ck["model"])


def test_calc_metrics_cli_on_the_snapshot(gan_run, inception_sd, tmp_path,
                                          monkeypatch):
    """``--resume`` on the GAN run's snapshot with random Inception and
    LPIPS state dicts through the environment: FID / KID / precision /
    recall / IS / PPL / EQ-T / EQ-R finite, overflow 0; the weights scored
    are the snapshot's."""
    inc, lp = tmp_path / "inception.pt", tmp_path / "lpips.pt"
    torch.save(inception_sd, inc)
    torch.save(random_lpips_state_dict(1), lp)
    monkeypatch.setenv("SHERF_INCEPTION_WEIGHTS", str(inc))
    monkeypatch.setenv("SHERF_LPIPS_WEIGHTS", str(lp))
    monkeypatch.setattr(t_lpips, "_TRIED", False)
    monkeypatch.setattr(t_lpips, "_LPIPS_PARAMS", None)
    build = t_calc.model_config_from_args
    monkeypatch.setattr(t_calc, "model_config_from_args",
                        lambda a: dataclasses.replace(build(a), **SMALL))
    loaded = []
    load = t_calc.load_weights
    monkeypatch.setattr(t_calc, "load_weights",
                        lambda m, p: loaded.append(p) or load(m, p))
    snap = latest_checkpoint(str(gan_run / "checkpoints"))
    out = tmp_path / "metrics.json"
    res = t_calc.main(["--cfg", "synthetic", "--resume", snap, "--metrics",
                       "fid", "kid", "pr", "is", "ppl", "eqt", "eqr",
                       "--num_items", "4", "--size", "32", "--out", str(out),
                       "--neural_rendering_resolution_initial", "32",
                       "--depth_resolution", "4", "--device", "cpu"])
    assert loaded == [snap]
    assert json.load(open(out)) == res
    for k in ("fid", "kid", "precision", "recall", "is_mean", "is_std", "ppl",
              "eqt_int_psnr", "eqr90_psnr"):
        assert np.isfinite(res[k]), (k, res[k])
    assert res["overflow"] == 0 and res["is_mean"] >= 1.0
