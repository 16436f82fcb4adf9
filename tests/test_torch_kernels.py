"""The port's kernel modules (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerances: indices, masks and compactions must be EQUAL; squared distances
within 2 ulp.  The port rounds every operation (its CUDA kernel uses the
_rn intrinsics, and is bit-equal to eager PyTorch), while XLA's CPU backend
contracts the interpret-mode kernel's sum into two FMAs,
fma(dz, dz, fma(dx, dx, dy*dy)), which moves d2 by at most 2 ulp.

Both sides centre their inputs on the vertex centroid, whose f32 mean XLA
and torch sum in different orders; the ulp comparisons therefore use vertex
sets whose centroid is exactly zero in any summation order (+-pairs on a
dyadic grid), so that both sides see the same centred coordinates.  On a
general body the centroids differ in their last bit, which moves d2 by up
to ~1e-5 relative: that case is held to rtol 1e-4 (indices still equal).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.kernels import compaction as jcomp
from sherf_tpu.kernels import knn_pallas as kp
from sherf_tpu.nerf.renderer import _compact_indices
from sherf_tpu_torch.kernels import _cuda
from sherf_tpu_torch.kernels.compaction import compact_mask
from sherf_tpu_torch.kernels.knn import nn_1, nn_1_tables, ray_body_mask


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _body(rng, v):
    return (rng.randn(v, 3) * [0.3, 0.6, 0.15] + [0.1, 0.2, 2.0]).astype(np.float32)


def _zero_centroid_body(rng, v):
    """+-pairs on a 2^-8 grid: every partial sum is exact in f32, so the
    centroid is exactly 0 whatever the summation order."""
    half = np.round(rng.randn(v // 2, 3) * [0.3, 0.6, 0.15] * 256) / 256
    return np.concatenate([half, -half]).astype(np.float32)


@pytest.mark.parametrize("n,v", [(700, 690), (1024, 6890)])
def test_nn_1_matches_pallas_kernel(n, v):
    rng = np.random.RandomState(n + v)
    verts = _zero_centroid_body(rng, v)
    # duplicate vertex (the lowest id must win), keeping the +- pairing
    verts[10], verts[10 + v // 2] = verts[3], -verts[3]
    q = verts[rng.randint(0, v, n)] + rng.randn(n, 3).astype(np.float32) * 0.03
    q[:8] = verts[3]                              # queries exactly on vertices
    q[8:16] = verts[rng.randint(0, v, 8)]
    d2_j, idx_j = kp.nn_1_pallas(jnp.asarray(q), jnp.asarray(verts),
                                 interpret=True)
    launches = dict(_cuda.LAUNCHES)
    d2_t, idx_t = nn_1(torch.from_numpy(q), torch.from_numpy(verts))
    assert _cuda.LAUNCHES == launches             # CPU tensors: no kernel launch
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(idx_t[0]) == 3
    assert _ulps(d2_t.numpy(), d2_j).max() <= 2


def test_nn_1_matches_pallas_kernel_on_a_parked_tail():
    """The inputs the CUDA kernel's cooperative scan takes: a tail of
    bit-identical queries (the budgets' padding) starting mid-tile, plus
    queries on a duplicated vertex (exact ties, lowest index).  The tail
    sits at a dyadic point 4 m from the body, where every d2 is exact, so
    ties among its vertices are exact on both sides too."""
    rng = np.random.RandomState(21)
    v = 690
    verts = _zero_centroid_body(rng, v)
    verts[10], verts[10 + v // 2] = verts[3], -verts[3]
    n, start = 700, 413
    q = verts[rng.randint(0, v, n)] + rng.randn(n, 3).astype(np.float32) * 0.03
    q[:8] = verts[3]
    q[start:] = [1.5, -2.25, 3.0]
    d2_j, idx_j = kp.nn_1_pallas(jnp.asarray(q), jnp.asarray(verts),
                                 interpret=True)
    d2_t, idx_t = nn_1(torch.from_numpy(q), torch.from_numpy(verts))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert set(idx_t[:8].tolist()) == {3}
    assert len(set(idx_t[start:].tolist())) == 1
    assert _ulps(d2_t.numpy(), d2_j).max() <= 2


def test_nn_1_matches_pallas_kernel_on_a_general_body():
    rng = np.random.RandomState(5)
    verts = _body(rng, 6890)
    q = verts[rng.randint(0, 6890, 1024)] \
        + rng.randn(1024, 3).astype(np.float32) * 0.03
    d2_j, idx_j = kp.nn_1_pallas(jnp.asarray(q), jnp.asarray(verts),
                                 interpret=True)
    d2_t, idx_t = nn_1(torch.from_numpy(q), torch.from_numpy(verts))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-4,
                               atol=1e-10)


def test_nn_1_tables_gathers_payload():
    rng = np.random.RandomState(3)
    verts = _body(rng, 900)
    q = verts[:300] + 0.01
    tab = rng.randn(900, 33).astype(np.float32)
    d2, idx, pay = nn_1_tables(torch.from_numpy(q), torch.from_numpy(verts),
                               torch.from_numpy(tab))
    np.testing.assert_array_equal(pay.numpy(), tab[idx.numpy()])


def _rays(rng, verts, n):
    o = np.tile(np.asarray([[0.1, 0.2, -1.0]], np.float32), (n, 1))
    tgt = verts[rng.randint(0, len(verts), n)] \
        + rng.randn(n, 3).astype(np.float32) * 0.15
    return o, (tgt - o).astype(np.float32)


def _line_min_dist(o, d, verts):
    """The kernel's arithmetic in numpy f32, op by op (zero centroid)."""
    v = verts
    dd = d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2]
    dd = dd + d[:, 2:3] * d[:, 2:3]
    dd_inv = np.float32(1.0) / np.maximum(dd, np.float32(1e-12))
    w = [v[None, :, k] - o[:, k:k + 1] for k in range(3)]
    a = w[0] * w[0] + w[1] * w[1]
    a = a + w[2] * w[2]
    b = d[:, 0:1] * w[0] + d[:, 1:2] * w[1]
    b = b + d[:, 2:3] * w[2]
    return (a - b * b * dd_inv).min(axis=1)


@pytest.mark.parametrize("with_active", [False, True])
def test_ray_body_mask_matches_pallas_kernel(with_active):
    rng = np.random.RandomState(11)
    verts = _body(rng, 1500)
    n = 1000
    o, d = _rays(rng, verts, n)
    thr = (0.05 + 1e-3) ** 2
    active = None
    if with_active:
        active = rng.rand(n) < 0.4
        active[:300] = False                       # whole 256-ray tile inactive
    m_j = kp.ray_body_mask_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.ones(n),
        jnp.asarray(verts), thr, interpret=True,
        active=None if active is None else jnp.asarray(active))
    m_t = ray_body_mask(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(verts), thr,
                        active=None if active is None else torch.from_numpy(active))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < int(m_t.sum()) < n
    if with_active:
        assert not m_t[:256].any()


def test_ray_body_mask_matches_pallas_kernel_on_one_active_tile():
    """513 rays (a partial third tile) with one active ray, the first of
    the second tile: only that tile is scanned, by every ray in it."""
    rng = np.random.RandomState(13)
    verts = _body(rng, 1500)
    n = 513
    o, d = _rays(rng, verts, n)
    active = np.zeros(n, bool)
    active[256] = True
    thr = (0.05 + 1e-3) ** 2
    m_j = kp.ray_body_mask_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.ones(n),
        jnp.asarray(verts), thr, interpret=True, active=jnp.asarray(active))
    m_t = ray_body_mask(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(verts), thr,
                        active=torch.from_numpy(active))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert not m_t[:256].any() and not m_t[512:].any()
    assert 0 < int(m_t[256:512].sum()) < 256


def test_ray_body_mask_on_the_threshold():
    """A ray whose minimum line distance IS the threshold fails the strict
    '<'; one ulp above, it passes.  Checked on the port alone: at an exact
    tie the JAX interpret path's FMA-contracted distances (see the module
    note) round to a neighbouring value, so the two sides can only be held
    equal away from ties (the test above)."""
    rng = np.random.RandomState(12)
    verts = _zero_centroid_body(rng, 700)
    o, d = _rays(rng, verts, 64)
    dmin = _line_min_dist(o, d, verts)
    for thr, want in ((float(dmin[5]), False),
                      (float(np.nextafter(dmin[5], np.float32(np.inf))), True)):
        m_t = ray_body_mask(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(verts), thr).numpy()
        np.testing.assert_array_equal(m_t, dmin < np.float32(thr))
        assert bool(m_t[5]) is want


@pytest.mark.parametrize("n,p,cap", [
    (5000, 0.3, 1000),     # cap below the survivor count (overflow)
    (5000, 0.3, None),     # cap exactly at the survivor count
    (5000, 0.3, 3000),     # cap above: sentinel tail
    (9000, 0.02, 512),
    (4096, 0.0, 256),      # all-False mask
    (300, 1.0, 300),       # all-True mask
    (4097, 0.3, 1000),     # one Pallas block + 1 entry, cap below survivors
    (4097, 0.3, 1500),     # ... and above them
])
def test_compact_mask_matches_pallas_kernel(n, p, cap):
    rng = np.random.RandomState(n + int(p * 100))
    mask = rng.rand(n) < p
    if cap is None:
        cap = int(mask.sum())
    idx_j, valid_j = jcomp.compact_mask(jnp.asarray(mask), cap, interpret=True)
    idx_r, valid_r = _compact_indices(jnp.asarray(mask), cap)
    idx_t, valid_t = compact_mask(torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_r))


def test_cuda_wrappers_reject_cpu_tensors_and_never_fall_back():
    """The *_cuda entry points check device and dtype before touching the
    library; the public wrappers only take the plain path for CPU tensors."""
    from sherf_tpu_torch.kernels import compaction as tcomp
    from sherf_tpu_torch.kernels import knn as tknn

    q = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tknn.nn_1_cuda(q, q)            # a CPU tensor is not on a CUDA device
    with pytest.raises(ValueError):
        tcomp.compact_mask_cuda(torch.zeros(4, dtype=torch.bool), 2)
    with pytest.raises(TypeError):
        nn_1(q.double(), q.double())
