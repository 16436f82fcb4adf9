"""The port's native host-ops library (``sherf_tpu_torch/native``) against
the JAX package's (``sherf_tpu/native``), on the CPU: the same
``host_ops.cpp`` built with the same flags on the same machine, so rays,
near / far, box masks and filled polygons are bit-equal.  Then the port's
own contract: the build is atomic and keyed, a failed build leaves the
numpy paths and says so once, and the loaders take the native rays when
the library builds.
"""

import filecmp

import numpy as np
import pytest

import sherf_tpu.native as j_native
import sherf_tpu_torch.native as t_native
from sherf_tpu_torch.data import base as t_base
from sherf_tpu_torch.geometry.rays import get_rays_np, near_far_aabb_np


@pytest.fixture(scope="module")
def libs():
    if j_native.lib() is None or t_native.lib() is None:
        pytest.skip("no C++ toolchain: the native libraries did not build")


def _camera(rng, H, W):
    from sherf_tpu_torch.data.imgproc import rodrigues

    R = rodrigues(rng.randn(3) * 0.4).astype(np.float32)
    cam = np.array([0.3, -0.2, 3.0], np.float32) + rng.randn(3).astype(
        np.float32) * 0.2
    T = (-R @ cam).reshape(3, 1)
    f = 300.0 + rng.rand() * 200
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return K, R, T


def test_the_source_is_the_jax_packages():
    assert filecmp.cmp(j_native._SRC, str(t_native.SRC), shallow=False)
    assert t_native.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC")


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (37, 29)])
def test_prepare_rays_bit_equal_to_jax(libs, hw):
    H, W = hw
    rng = np.random.RandomState(H * W)
    for _ in range(3):
        K, R, T = _camera(rng, H, W)
        bounds = np.array([[-0.5, -1.0, -0.3], [0.5, 0.8, 0.3]], np.float32)
        bounds += rng.randn(2, 3).astype(np.float32) * 0.05
        got = t_native.prepare_rays_native(H, W, K, R, T, bounds)
        ref = j_native.prepare_rays_native(H, W, K, R, T, bounds)
        for a, b, what in zip(got, ref, ("ray_o", "ray_d", "near", "far",
                                         "mask")):
            assert a.dtype == b.dtype and a.shape == b.shape, what
            np.testing.assert_array_equal(a, b, err_msg=what)
        # and close to numpy's, at tests/test_native.py's bounds
        ro, rd = get_rays_np(H, W, K, R, T)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        n_ref, f_ref, m_ref = near_far_aabb_np(bounds, ro, rd)
        np.testing.assert_allclose(got[0], ro, atol=1e-4)
        np.testing.assert_allclose(got[1], rd, atol=1e-4)
        assert (got[4] == m_ref).mean() > 0.999
        both = got[4] & m_ref
        np.testing.assert_allclose(got[2][both], n_ref[both], atol=1e-3)
        np.testing.assert_allclose(got[3][both], f_ref[both], atol=1e-3)


def test_fill_convex_poly_bit_equal_to_jax(libs):
    rng = np.random.RandomState(1)
    H, W = 64, 72
    for i in range(40):
        k = 3 + i % 4
        pts = rng.randint(-10, 80, size=(k, 2)).astype(np.int32)
        c = pts.mean(0)
        pts = pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]
        loop = np.concatenate([pts, pts[:1]], 0)
        ours = np.zeros((H, W), np.uint8)
        ref = np.zeros((H, W), np.uint8)
        assert t_native.fill_convex_poly_native(ours, loop)
        assert j_native.fill_convex_poly_native(ref, loop)
        np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="uint8"):
        t_native.fill_convex_poly_native(np.zeros((4, 4), np.float32), loop)


def test_sample_rays_takes_the_native_path(libs, monkeypatch):
    """``sample_rays_for_image`` returns the library's rays whenever it
    builds, and numpy's when it does not."""
    rng = np.random.RandomState(2)
    H = W = 48
    img = rng.rand(H, W, 3).astype(np.float32)
    msk = (rng.rand(H, W) > 0.5).astype(np.float32)
    K, R, T = _camera(rng, H, W)
    bounds = np.array([[-0.4, -0.6, -0.3], [0.4, 0.6, 0.3]], np.float32)
    out = t_base.sample_rays_for_image(img, msk, K, R, T, bounds)
    native = t_native.prepare_rays_native(H, W, K, R, T, bounds)
    for a, b in zip(out[1:6], native):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(t_native, "lib", lambda: None)
    out_np = t_base.sample_rays_for_image(img, msk, K, R, T, bounds)
    ro, rd = get_rays_np(H, W, K, R, T)
    np.testing.assert_array_equal(out_np[1], ro.reshape(-1, 3).astype(np.float32))
    np.testing.assert_array_equal(out_np[2], rd.reshape(-1, 3).astype(np.float32))


def test_failed_build_warns_once_and_falls_back(tmp_path, monkeypatch, capsys):
    """A compiler that fails: one warning, no library file, ``lib()`` None
    on every later call without another attempt, and the public calls
    report the fallback (None / False)."""
    calls = []

    def failing_run(cmd, **kw):
        calls.append(cmd)
        raise OSError("g++: not found")
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(t_native.subprocess, "run", failing_run)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_tried", False)
    assert t_native.lib() is None and t_native.lib() is None
    assert len(calls) == 1 and calls[0][0] == "g++"
    assert capsys.readouterr().out.count("WARNING") == 1
    assert list((tmp_path / "_build").iterdir()) == []
    K = np.eye(3, dtype=np.float32)
    assert t_native.prepare_rays_native(4, 4, K, K, np.zeros(3), np.zeros(6)) \
        is None
    assert not t_native.fill_convex_poly_native(np.zeros((4, 4), np.uint8),
                                                np.zeros((3, 2), np.int32))


def test_build_is_atomic_and_keyed(tmp_path, monkeypatch):
    """The build writes a temporary file and renames it: the keyed path
    appears whole, nothing else is left, and a second build reuses it."""
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    path = t_native.build()
    if path is None:
        pytest.skip("no C++ toolchain")
    assert path.parent == tmp_path and path.name.startswith("libsherf_host-")
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    mtime = path.stat().st_mtime_ns
    assert t_native.build() == path and path.stat().st_mtime_ns == mtime
