"""The port's StyleGAN3 synthesis (``sherf_tpu_torch/features/stylegan3.py``)
and ``kernels.filters.filtered_lrelu`` against the JAX package's, on the
CPU, with the JAX weights carried across by ``compat.flax_bridge.from_flax``
(a strict ``load_state_dict``: no key missing, none unexpected).

  * ``filtered_lrelu`` on the four (up, down, taps, padding) cases of
    ``tests/test_stylegan3.py``: f32, rtol / atol 1e-5 (the same
    convolutions in another summation order);
  * ``design_lowpass_filter``: bit-equal (both numpy and scipy on the same
    inputs), separable and radial, odd and even taps;
  * ``SynthesisLayer`` at both ``is_torgb`` values and once with radial
    filters, B = 2 (the styles are normalised over the whole batch, so a
    per-sample norm would differ), random bias and a magnitude EMA off 1:
    max abs <= 1e-4;
  * JAX's small ``SG3Generator`` (z 16, w 32, 32 px, 4 layers, cbase 1024,
    cmax 32) with every parameter perturbed off its init: the image within
    relative L2 1e-5; every ``magnitude_ema`` after an ``update_emas`` call
    within rtol 1e-6; each parameter's gradient of the image's sum within
    relative L2 1e-4 of ``jax.grad``.  JAX compiles one graph (image,
    gradients and the EMA update together), shared by the three tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherf_tpu.features import stylegan3 as J
from sherf_tpu.kernels import filters as j_filters
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.features import stylegan3 as Tm
from sherf_tpu_torch.kernels import filters as t_filters

T = torch.from_numpy


def _nhwc(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.mark.parametrize("up,down,taps_u,taps_d,pad", [
    (1, 1, 1, 1, 0),
    (2, 1, 12, 1, (3, 2, 4, 1)),
    (2, 2, 12, 12, (8, 7, 8, 7)),
    (1, 2, 1, 12, 11),
])
def test_filtered_lrelu_matches_jax(up, down, taps_u, taps_d, pad):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 9, 8).astype(np.float32)             # NCHW
    b = rng.randn(5).astype(np.float32)
    fu = rng.rand(taps_u).astype(np.float32) if taps_u > 1 else None
    fd = rng.rand(taps_d).astype(np.float32) if taps_d > 1 else None
    fu = None if fu is None else np.outer(fu, fu) / fu.sum() ** 2
    fd = None if fd is None else np.outer(fd, fd) / fd.sum() ** 2
    kw = dict(fu=fu, fd=fd, up=up, down=down, padding=pad,
              gain=np.sqrt(2), slope=0.2, clamp=4.0)
    want = _nhwc(j_filters.filtered_lrelu(
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))), b=jnp.asarray(b), **kw))
    got = t_filters.filtered_lrelu(T(x), b=T(b), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("numtaps,radial", [
    (12, False), (13, False), (12, True), (13, True), (1, False)])
def test_design_lowpass_filter_is_bit_equal(numtaps, radial):
    args = (numtaps, 2.8, 10.4, 32.0)
    want = J.design_lowpass_filter(*args, radial=radial)
    got = Tm.design_lowpass_filter(*args, radial=radial)
    if numtaps == 1:
        assert got is None and want is None
        return
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((numtaps,) * (2 if radial else 1))
    np.testing.assert_array_equal(got, want)


def _layer_spec(is_torgb, radial=False):
    return dict(
        w_dim=32, is_torgb=is_torgb, is_critically_sampled=is_torgb,
        in_channels=8, out_channels=4 if is_torgb else 6,
        in_size=16, out_size=16, in_sampling_rate=16, out_sampling_rate=16,
        in_cutoff=2.0, out_cutoff=2.0 if is_torgb else 2.8,
        in_half_width=6.0, out_half_width=6.0 if is_torgb else 5.2,
        use_radial_filters=radial)


@pytest.mark.parametrize("is_torgb,radial", [(False, False), (True, False),
                                             (False, True)],
                         ids=["layer", "torgb", "radial"])
def test_synthesis_layer_matches_jax(is_torgb, radial):
    spec = _layer_spec(is_torgb, radial)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, spec["in_channels"]).astype(np.float32)
    w = rng.randn(2, spec["w_dim"]).astype(np.float32)
    jl = J.SynthesisLayer(**spec)
    v = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(w)))
    v = {"params": dict(v["params"]), "batch_stats": {
        "magnitude_ema": np.float32(2.3)}}
    v["params"]["bias"] = rng.randn(spec["out_channels"]).astype(np.float32)
    want = _nhwc(jl.apply(v, jnp.asarray(x), jnp.asarray(w)))

    tl = Tm.SynthesisLayer(**spec)
    tl.load_state_dict(from_flax(v), strict=True)
    if radial:
        assert tl.down_filter.shape == (12, 12)
    with torch.no_grad():
        got = tl(T(np.transpose(x, (0, 3, 1, 2)).copy()), T(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


SMALL = dict(z_dim=16, w_dim=32, img_resolution=32, img_channels=3,
             num_layers=4, channel_base=1024, channel_max=32)


def _perturbed(params, rng):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*np.shape(a))).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def small_generator():
    """JAX's small generator with perturbed weights, and in one compiled
    graph its image, the gradient of the image's sum and the batch stats
    after an ``update_emas`` call; the port's generator with the same
    variables."""
    g = J.SG3Generator(**SMALL)
    z = np.random.RandomState(0).randn(2, 16).astype(np.float32)
    v = jax.device_get(g.init(jax.random.PRNGKey(0), jnp.asarray(z)))
    rest = {k: v[k] for k in v if k != "params"}
    params = _perturbed(v["params"], np.random.RandomState(1))

    @jax.jit
    def run(params, z):
        def img_sum(p):
            img = g.apply({**rest, "params": p}, z)
            return jnp.sum(img), img
        (_, img), grads = jax.value_and_grad(img_sum, has_aux=True)(params)
        _, upd = g.apply({**rest, "params": params}, z, update_emas=True,
                         mutable=["batch_stats"])
        return img, grads, upd["batch_stats"]

    img, grads, stats = jax.device_get(run(params, jnp.asarray(z)))
    variables = {**rest, "params": params}
    tg = Tm.SG3Generator(**SMALL)
    tg.load_state_dict(from_flax(variables), strict=True)
    return dict(z=z, variables=variables, img=img, grads=grads,
                stats=stats, port=tg)


def test_sg3_generator_matches_jax(small_generator, record_property):
    s = small_generator
    with torch.no_grad():
        got = s["port"](T(s["z"])).numpy()
    want = _nhwc(s["img"])
    assert got.shape == want.shape == (2, 3, 32, 32)
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    record_property("image_rel_l2", float(rel))
    assert rel <= 1e-5, rel


def test_sg3_magnitude_ema_update_matches_jax(small_generator):
    s = small_generator
    tg = Tm.SG3Generator(**SMALL)
    tg.load_state_dict(from_flax(s["variables"]), strict=True)
    with torch.no_grad():
        tg(T(s["z"]), update_emas=True)
    want = from_flax({"batch_stats": s["stats"]})
    assert len(want) == 5
    sd = tg.state_dict()
    for k, v in want.items():
        assert float(sd[k]) != 1.0, k
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-6,
                                   err_msg=k)


def test_sg3_gradients_match_jax(small_generator, record_property):
    s = small_generator
    tg = Tm.SG3Generator(**SMALL)
    tg.load_state_dict(from_flax(s["variables"]), strict=True)
    tg(T(s["z"])).sum().backward()
    want = from_flax({"params": s["grads"]})
    got = {k: p.grad for k, p in tg.named_parameters()}
    assert sorted(got) == sorted(want)
    worst = {}
    for k, g in got.items():
        w = want[k].numpy()
        worst[k] = float(np.linalg.norm(g.numpy() - w)
                         / max(np.linalg.norm(w), 1e-12))
    name = max(worst, key=worst.get)
    record_property("worst_grad_rel_l2", (name, worst[name]))
    assert worst[name] <= 1e-4, (name, worst[name])


def test_sg3_generator_redraw_is_seeded():
    a = Tm.SG3Generator(**SMALL, generator=torch.Generator().manual_seed(0))
    b = Tm.SG3Generator(**SMALL, generator=torch.Generator().manual_seed(0))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    fc = a.mapping.fc0.weight.detach()
    assert 50 < float(fc.std()) < 200      # N(0, 1 / lr_multiplier = 100)
    img = a(torch.randn(2, 16, generator=torch.Generator().manual_seed(1)))
    assert img.shape == (2, 3, 32, 32) and torch.isfinite(img).all()


def test_from_flax_names_tuple_leaves_or_refuses():
    got = from_flax({"buffers": {"input": {"freqs_phases": (
        np.ones((4, 2), np.float32), np.zeros(4, np.float32))}}})
    assert sorted(got) == ["input.freqs", "input.phases"]
    assert got["input.freqs"].shape == (4, 2)
    with pytest.raises(ValueError, match="'pair' of 3 arrays"):
        from_flax({"buffers": {"pair": (np.ones(1), np.ones(1),
                                        np.ones(1))}})
