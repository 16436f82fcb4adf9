"""The port's ADA pipe (``sherf_tpu_torch/features/augment.py``) against the
JAX package's, on the CPU.

  * Value for value: JAX's draws are recorded by wrapping
    ``jax.random.uniform`` / ``normal`` (pytest's ``monkeypatch``) and
    replayed into the port's pipe through ``ReplayDraws``, which also
    checks that the port asks for each draw in JAX's order with JAX's
    kind and shape.  Each knob group alone and all together, C = 3 and
    C = 1, 16x16 and 24x20, p in {0, 0.5, 1}: atol 1e-5 (f32 rounding of
    the composed matrices, the inverse and the 65-tap band filters; the
    bilinear gather is continuous in its coordinates).
  * The distribution checks of ``tests/test_augment.py`` on the port's own
    ``torch.Generator``.
  * The matrix helpers and ``ada_adjust`` equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherf_tpu.features import augment as J
from sherf_tpu_torch.features import augment as A
from sherf_tpu_torch.features.augment import AugmentPipe, ReplayDraws

GROUPS = {
    "blit": dict(xflip=1, rotate90=1, xint=1),
    "geom": dict(scale=1, rotate=1, aniso=1, xfrac=1),
    "color": dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    "imgfilter": dict(imgfilter=1, imgfilter_bands=(1.0, 0.5, 1.0, 0.25)),
    "noise": dict(noise=1),
    "cutout": dict(cutout=1),
}
GROUPS["all"] = {k: v for g in GROUPS.values() for k, v in g.items()}


@pytest.fixture
def recorded(monkeypatch):
    """Calls JAX's pipe and returns its output and its draws, in order."""
    draws = []
    uniform, normal = jax.random.uniform, jax.random.normal

    def rec(kind, fn):
        def draw(key, shape=(), *a, **k):
            v = fn(key, shape, *a, **k)
            draws.append((kind, np.asarray(v)))
            return v
        return draw

    monkeypatch.setattr(jax.random, "uniform", rec("uniform", uniform))
    monkeypatch.setattr(jax.random, "normal", rec("normal", normal))

    def call(pipe, x, seed, p):
        draws.clear()
        out = np.asarray(pipe(jnp.asarray(x), jax.random.PRNGKey(seed), p))
        return out, list(draws)
    return call


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1,
                                                                 2))))


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_pipe_matches_jax_on_replayed_draws(recorded, group, channels,
                                            record_property):
    kw = GROUPS[group]
    worst = 0.0
    for H, W in ((16, 16), (24, 20)):
        for p in (0.0, 0.5, 1.0):
            x = np.random.RandomState(H + channels).uniform(
                -1, 1, (4, H, W, channels)).astype(np.float32)
            want, draws = recorded(J.AugmentPipe(**kw), x, H + W, p)
            replay = ReplayDraws(draws)
            got = AugmentPipe(**kw)(_nchw(x), p, draws=replay)
            assert replay.exhausted, (H, W, p)
            got = got.permute(0, 2, 3, 1).numpy()
            assert got.shape == want.shape
            err = float(np.abs(got - want).max())
            assert err <= 1e-5, (H, W, p, err)
            worst = max(worst, err)
    record_property("max_abs_err", worst)


def test_replay_refuses_a_draw_of_another_shape():
    replay = ReplayDraws([("uniform", np.zeros(3, np.float32))])
    with pytest.raises(ValueError, match="asked normal"):
        replay.normal((3,))
    with pytest.raises(ValueError, match=r"asked uniform \(4,\)"):
        replay.uniform((4,))


def test_pipe_needs_a_draw_source():
    with pytest.raises(ValueError, match="draws or a generator"):
        AugmentPipe(xflip=1)(torch.zeros(1, 3, 4, 4), 1.0)


# ------------------------------------------------- the port's own draws

def _imgs(B=8, H=16, W=16, C=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(B, C, H, W, generator=g) * 2 - 1


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_identity_when_all_off():
    x = _imgs()
    assert torch.equal(AugmentPipe()(x, 1.0, generator=_gen(1)), x)


def test_identity_when_p_zero():
    x = _imgs()
    pipe = AugmentPipe(xflip=1, rotate90=1, xint=1, scale=1, rotate=1,
                       aniso=1, xfrac=1, brightness=1, contrast=1,
                       lumaflip=1, hue=1, saturation=1, noise=1, cutout=1)
    out = pipe(x, 0.0, generator=_gen(1))
    np.testing.assert_allclose(out.numpy(), x.numpy(), atol=1e-4)


def test_xflip_is_exact_mirror():
    x = _imgs(B=64).numpy()
    out = AugmentPipe(xflip=1)(torch.from_numpy(x), 1.0,
                               generator=_gen(2)).numpy()
    is_id = np.array([np.allclose(out[i], x[i], atol=1e-4)
                      for i in range(64)])
    is_fl = np.array([np.allclose(out[i], x[i, :, :, ::-1], atol=1e-4)
                      for i in range(64)])
    assert (is_id | is_fl).all()
    assert 10 < is_fl.sum() < 54


def test_rotate90_orbits():
    x = _imgs(B=32).numpy()
    out = AugmentPipe(rotate90=1)(torch.from_numpy(x), 1.0,
                                  generator=_gen(3)).numpy()
    for i in range(32):
        cands = [np.rot90(x[i], k, axes=(1, 2)) for k in range(4)]
        assert any(np.allclose(out[i], c, atol=1e-4) for c in cands), i


def test_brightness_shifts_mean():
    x = _imgs(B=128)
    out = AugmentPipe(brightness=1, brightness_std=0.5)(x, 1.0,
                                                        generator=_gen(4))
    d = (out - x).reshape(128, -1).numpy()
    shifted = np.abs(d.mean(axis=1)) > 1e-3
    assert shifted.sum() > 30
    assert (d.std(axis=1)[shifted] < 1e-3).all()


def test_noise_and_cutout():
    x = _imgs(B=4)
    out = AugmentPipe(noise=1)(x, 1.0, generator=_gen(5))
    assert not torch.allclose(out, x)
    out = AugmentPipe(cutout=1)(x, 1.0, generator=_gen(6))
    assert int((out == 0).sum()) > 4 * 16 * 16 * 3 * 0.1


def test_imgfilter_preserves_shape_and_energy():
    x = _imgs(B=16)
    out = AugmentPipe(imgfilter=1)(x, 1.0, generator=_gen(7))
    assert out.shape == x.shape and torch.isfinite(out).all()
    ratio = float((out ** 2).mean() / (x ** 2).mean())
    assert 0.3 < ratio < 3.0


def test_same_generator_seed_same_output_and_recorded_replay():
    x = _imgs(B=4)
    pipe = AugmentPipe(**GROUPS["all"])
    rec = A.Draws(_gen(8), record=True)
    a = pipe(x, 0.7, draws=rec)
    b = pipe(x, 0.7, generator=_gen(8))
    assert torch.equal(a, b)
    replay = ReplayDraws(rec.record)
    assert torch.equal(pipe(x, 0.7, draws=replay), a) and replay.exhausted


def test_matrix_helpers_match_jax():
    rng = np.random.RandomState(9)
    a, b = rng.randn(2, 5).astype(np.float32)
    axis = rng.randn(5, 3).astype(np.float32)
    v = rng.randn(5, 3).astype(np.float32)
    T = torch.from_numpy
    pairs = [(A.translate2d(T(a), T(b)), J.translate2d(a, b)),
             (A.scale2d(T(a), T(b)), J.scale2d(a, b)),
             (A.rotate2d(T(a)), J.rotate2d(a)),
             (A.translate3d(T(v)), J.translate3d(v)),
             (A.scale3d(T(v)), J.scale3d(v)),
             (A.rotate3d(T(axis), T(a)), J.rotate3d(axis, a))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    gray = torch.tensor([0.3, 0.3, 0.3, 1.0])
    R = A.rotate3d(torch.ones(1, 3), torch.tensor([1.0]))[0]
    np.testing.assert_allclose((R @ gray).numpy(), gray.numpy(), atol=1e-6)
    for got, want in zip(A._freq_bands(), J._freq_bands()):
        assert got.shape == (65,)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("p,rt,nimg", [(0.5, 0.9, 4000), (0.5, 0.3, 4000),
                                       (0.0, 0.3, 4000), (1.0, 0.9, 4000),
                                       (0.2, 0.6, 64), (0.999, 0.7, 10000)])
def test_ada_adjust_matches_jax(p, rt, nimg):
    got = A.ada_adjust(p, rt=rt, target=0.6, nimg_delta=nimg)
    assert got == J.ada_adjust(p, rt=rt, target=0.6, nimg_delta=nimg)
    assert 0.0 <= got <= 1.0
    if rt != 0.6 and 0.0 < p < 1.0:
        assert (got > p) == (rt > 0.6)
