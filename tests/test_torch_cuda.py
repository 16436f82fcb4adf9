"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: skipped where ``torch.cuda.is_available()`` is False.  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sherf_tpu_torch.kernels import compaction, knn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _verts(rng, v=6890):
    return (rng.randn(v, 3) * [0.3, 0.6, 0.15] + [0.1, 0.2, 2.0]).astype(np.float32)


@pytest.mark.parametrize("n", [1, 255, 100_003])
def test_nn_1_kernel_bit_equals_plain(dev, n):
    rng = np.random.RandomState(n)
    verts = _verts(rng)
    q = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.05
    # exact ties: duplicated vertices (the lowest index must win) and queries
    # sitting exactly on vertices
    verts[100] = verts[7]
    q[: min(n, 5)] = verts[7]
    q_c, v_c = knn._centre(torch.from_numpy(q).to(dev), torch.from_numpy(verts).to(dev))
    d2k, ik = knn.nn_1_cuda(q_c, v_c)
    d2p, ip = knn.nn_1_plain(q_c, v_c)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip)
    assert torch.equal(d2k, d2p)  # bit-equal: no FMA contraction in the kernel
    assert int(ik[0]) == 7


def test_nn_1_wrapper_counts_and_rejects(dev):
    rng = np.random.RandomState(0)
    verts = torch.from_numpy(_verts(rng)).to(dev)
    before = knn._cuda.LAUNCHES["nn_1"]
    knn.nn_1(verts[:10] + 0.01, verts)
    assert knn._cuda.LAUNCHES["nn_1"] == before + 1
    with pytest.raises(TypeError):
        knn.nn_1(verts[:10].double(), verts.double())
    with pytest.raises(ValueError):
        knn.nn_1_cuda(verts[:10, :2].contiguous(), verts)


@pytest.mark.parametrize("with_active", [False, True])
def test_ray_body_mask_kernel_equals_plain(dev, with_active):
    rng = np.random.RandomState(1)
    verts = _verts(rng)
    n = 70_001
    o = np.tile(np.asarray([[0.1, 0.2, -1.0]], np.float32), (n, 1))
    tgt = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.2
    d = (tgt - o).astype(np.float32)
    act = torch.from_numpy(rng.rand(n) < 0.3).to(dev) if with_active else None
    if with_active:
        act[:4096] = False        # whole tiles inactive -> skipped
    o_c, v_c = knn._centre(torch.from_numpy(o).to(dev), torch.from_numpy(verts).to(dev))
    d_t = torch.from_numpy(d).to(dev)
    thr = (0.05 + 1e-3) ** 2
    mk = knn.ray_body_mask_cuda(o_c, d_t, v_c, thr, act)
    mp = knn.ray_body_mask_plain(o_c, d_t, v_c, thr, act)
    torch.cuda.synchronize()
    assert torch.equal(mk, mp)
    assert 0 < int(mk.sum()) < n
    if with_active:
        assert not bool(mk[:4096].any())


@pytest.mark.parametrize("n,p,cap", [
    (1, 1.0, 1), (8191, 0.5, 100), (8192, 0.5, 4096), (100_000, 0.3, 30_000),
    (100_000, 0.3, 29_000), (100_000, 0.3, 40_000), (3_000_001, 0.05, 150_000),
    (50_000, 0.0, 256)])
def test_compact_mask_kernel_equals_plain(dev, n, p, cap):
    rng = np.random.RandomState(n)
    m = torch.from_numpy(rng.rand(n) < p).to(dev)
    ik, vk = compaction.compact_mask_cuda(m, cap)
    ip, vp = compaction.compact_mask_plain(m, cap)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip)
    assert torch.equal(vk, vp)
