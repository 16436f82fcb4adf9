"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: skipped where ``torch.cuda.is_available()`` is False.  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sherf_tpu_torch.kernels import compaction, knn, knn_cluster, segment_accum
from sherf_tpu_torch.smpl import synthetic_smpl

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _verts(rng, v=6890):
    return (rng.randn(v, 3) * [0.3, 0.6, 0.15] + [0.1, 0.2, 2.0]).astype(np.float32)


def _nn_1_bit_equal(dev, q, verts):
    """Kernel against plain on centred inputs: indices equal, d2 bit-equal
    (no FMA contraction in the kernel); returns the indices."""
    q_c, v_c = knn._centre(torch.from_numpy(q).to(dev),
                           torch.from_numpy(verts).to(dev))
    d2k, ik = knn.nn_1_cuda(q_c, v_c)
    d2p, ip = knn.nn_1_plain(q_c, v_c)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip)
    assert torch.equal(d2k, d2p)
    return ik.cpu().numpy()


@pytest.mark.parametrize("n", [1, 255, 100_003])
def test_nn_1_kernel_bit_equals_plain(dev, n):
    rng = np.random.RandomState(n)
    verts = _verts(rng)
    q = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.05
    # exact ties: duplicated vertices (the lowest index must win) and queries
    # sitting exactly on vertices
    verts[100] = verts[7]
    q[: min(n, 5)] = verts[7]
    assert _nn_1_bit_equal(dev, q, verts)[0] == 7


@pytest.mark.parametrize("start", [1000 + 13, 1024, 1024 + 32, 1024 + 77])
@pytest.mark.parametrize("park", ["far", "body"])
def test_nn_1_kernel_identical_tails(dev, start, park):
    """The budget's padding: a tail of bit-identical queries, parked at
    1e6 m or on the body, starting mid-warp, at a tile boundary (the
    kernel's tiles hold 128 queries) and mid-tile; bit-equal to plain."""
    rng = np.random.RandomState(start)
    verts = _verts(rng)
    n = start + 5000 + 3
    q = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.05
    q[start:] = [1e6, 1e6, 1e6] if park == "far" else q[start]
    # a whole tile of identical near-body queries before the tail too
    q[256:384] = verts[11] + np.float32(0.01)
    ik = _nn_1_bit_equal(dev, q, verts)
    assert len(set(ik[start:].tolist())) == 1


@pytest.mark.parametrize("n", [1, 255, 100_003])
@pytest.mark.parametrize("v", [1, 31, 32, 33])
def test_nn_1_kernel_few_vertices(dev, n, v):
    """V below, at and just above one 32-vertex chunk, and a single
    vertex (three of the four quarters empty)."""
    rng = np.random.RandomState(n + v)
    verts = _verts(rng, v)
    q = verts[rng.randint(0, v, n)] + rng.randn(n, 3).astype(np.float32) * 0.05
    _nn_1_bit_equal(dev, q, verts)


def test_nn_1_kernel_ties_in_and_across_chunks(dev):
    """Duplicated vertices inside one 32-vertex chunk, across chunks and
    across the warps' quarters of V: every query ties exactly between the
    two copies, and one on them takes the lower index, exactly as plain."""
    rng = np.random.RandomState(4)
    verts = _verts(rng)
    verts[40] = verts[35]                  # one chunk (32..63)
    verts[100] = verts[70]                 # chunks 2 and 3
    verts[6000] = verts[9]                 # quarters 0 and 3
    verts[5000] = verts[2000]              # quarters 1 and 2
    n = 4096
    q = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.05
    q[:128] = verts[35]                    # a whole tile (cooperative scan)
    q[128:200] = verts[70]
    q[200:260] = verts[9]
    q[260:300] = verts[2000]
    ik = _nn_1_bit_equal(dev, q, verts)
    assert set(ik[:128].tolist()) == {35}
    assert set(ik[128:200].tolist()) == {70}
    assert set(ik[200:260].tolist()) == {9}
    assert set(ik[260:300].tolist()) == {2000}


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


def _wa_inputs(rng, n, k, c, n_rows, sort):
    ids = rng.randint(0, n_rows, (n, k)).astype(np.int32)
    if sort:
        # id-coherent rows, as compacted ray-major queries give: neighbouring
        # rows read neighbouring sites
        base = np.sort(rng.randint(0, n_rows - 4, n))
        ids = (base[:, None] + rng.randint(0, 4, (n, k))).astype(np.int32)
    dup = rng.rand(n) < 0.3
    ids[dup, 5] = ids[dup, 1]
    ids[rng.rand(n) < 0.2, 2] = 0
    w = (rng.rand(n, k) * 2 - 0.5).astype(np.float32)
    g = rng.randn(n, c).astype(np.float32)
    return ids, w, g


def _wa_check(dev, ids, w, g, n_rows):
    """|kernel - plain| <= 1e-5 * plain(ids, |w|, |g|) + 1e-30: the f32
    atomics sum in another order, so the bound is the reassociation error
    of the absolute sums."""
    t = lambda a: torch.from_numpy(a).to(dev)
    got = segment_accum.weighted_accumulate_cuda(t(ids), t(w), t(g), n_rows)
    ref = segment_accum.weighted_accumulate_plain(t(ids), t(w), t(g), n_rows)
    mag = segment_accum.weighted_accumulate_plain(t(ids), t(np.abs(w)),
                                                  t(np.abs(g)), n_rows)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (n_rows, g.shape[1])
    assert bool(((got - ref).abs() <= 1e-5 * mag + 1e-30).all())
    return got


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("c", [32, 96])
def test_weighted_accumulate_kernel_matches_plain(dev, sort, c):
    rng = np.random.RandomState(c + sort)
    n_rows = 20_000
    ids, w, g = _wa_inputs(rng, 300_000, 8, c, n_rows, sort)
    before = segment_accum._cuda.LAUNCHES["weighted_accumulate"]
    got = _wa_check(dev, ids, w, g, n_rows)
    assert segment_accum._cuda.LAUNCHES["weighted_accumulate"] == before + 1
    assert bool(got[0].abs().max() > 0)       # row 0 is computed


def test_weighted_accumulate_kernel_edges(dev):
    rng = np.random.RandomState(3)
    # no rows: nothing launched, a zero table
    before = segment_accum._cuda.LAUNCHES["weighted_accumulate"]
    e = segment_accum.weighted_accumulate(
        torch.zeros((0, 8), dtype=torch.int32, device=dev),
        torch.zeros((0, 8), device=dev), torch.zeros((0, 5), device=dev), 7)
    assert segment_accum._cuda.LAUNCHES["weighted_accumulate"] == before
    assert e.shape == (7, 5) and not bool(e.any())
    # ids outside [0, n_rows) dropped, n_rows of 1
    ids, w, g = _wa_inputs(rng, 1000, 8, 5, 1, False)
    ids = rng.randint(-3, 4, (1000, 8)).astype(np.int32)
    got = _wa_check(dev, ids, w, g, 1)
    assert bool(got.abs().max() > 0)
    # K < 8 and a C that is not a multiple of 32
    ids, w, g = _wa_inputs(rng, 5000, 8, 40, 300, False)
    _wa_check(dev, np.ascontiguousarray(ids[:, :6]),
              np.ascontiguousarray(w[:, :6]), g, 300)
    with pytest.raises(ValueError):
        segment_accum.weighted_accumulate_cuda(
            torch.zeros((4, 9), dtype=torch.int32, device=dev),
            torch.zeros((4, 9), device=dev),
            torch.zeros((4, 2), device=dev), 3)
    with pytest.raises(TypeError):
        segment_accum.weighted_accumulate_cuda(
            torch.zeros((4, 8), dtype=torch.int64, device=dev),
            torch.zeros((4, 8), device=dev),
            torch.zeros((4, 2), device=dev), 3)


def test_weighted_accumulate_tiling(dev):
    """The production readout's rows split evenly over one wave of warps,
    in one pass with vector loads of the taps; 130 channels take two
    passes, K < 8 scalar loads."""
    t = segment_accum.weighted_accumulate_tiling(180_224, 8, 96)
    assert t["passes"] == 1 and t["vector_taps"] == 1
    assert t["warps"] * t["rows_per_warp"] >= 180_224
    assert (t["warps"] - 1) * t["rows_per_warp"] < 180_224
    t = segment_accum.weighted_accumulate_tiling(1000, 6, 130)
    assert t["passes"] == 2 and t["vector_taps"] == 0


@pytest.mark.parametrize("n_rows", [1, 4097, 200_000])
@pytest.mark.parametrize("c", [1, 33, 96, 130])
def test_weighted_accumulate_kernel_tables(dev, n_rows, c):
    """One site (every in-range tap on the zero row), the production
    table, and a table of 200,000 rows (more than one shared-memory tile
    could hold at one channel); C of 1, 33, 96 and 130 (two passes over
    the rows); ids out of range and negative, duplicates, id 0."""
    rng = np.random.RandomState(n_rows + c)
    n = 60_000
    ids, w, g = _wa_inputs(rng, n, 8, c, max(n_rows, 5), True)
    ids = np.minimum(ids, n_rows - 1)
    ids[rng.rand(n) < 0.05, 3] = n_rows + 2
    ids[rng.rand(n) < 0.05, 6] = -7
    _wa_check(dev, ids, w, g, n_rows)


@pytest.mark.parametrize("k", [8, 3])
def test_weighted_accumulate_kernel_one_id(dev, k):
    """Every tap of every row on one id: the most contention one address
    can see (after deduplication one kept tap per row)."""
    rng = np.random.RandomState(k)
    n, c, n_rows = 200_000, 96, 4097
    ids = np.full((n, k), 5, np.int32)
    w = (rng.rand(n, k) * 2 - 0.5).astype(np.float32)
    g = rng.randn(n, c).astype(np.float32)
    got = _wa_check(dev, ids, w, g, n_rows)
    assert bool(got[5].abs().max() > 0)
    assert int((got != 0).any(dim=1).sum()) == 1


def test_weighted_accumulate_kernel_non_finite_runs(dev):
    """The non-finite rows of the test below on a large table with C = 33
    and coherent ids (long runs of one id in a tap slot): NaN and inf where
    the plain version has them, also on the zero row."""
    rng = np.random.RandomState(10)
    n, k, c, n_rows = 20_000, 8, 33, 150_000
    ids, w, g = _wa_inputs(rng, n, k, c, n_rows, True)
    bad = rng.choice(n, 60, replace=False)
    g[bad[:20], rng.randint(0, c, 20)] = np.inf
    g[bad[20:40], rng.randint(0, c, 20)] = -np.inf
    g[bad[40:], rng.randint(0, c, 20)] = np.nan
    ids[bad, 4] = ids[bad, 0]
    ids[bad[::2], 6] = 0
    ids[bad[::2], 7] = 0                  # a dropped duplicate of id 0
    t = lambda a: torch.from_numpy(a).to(dev)
    got = segment_accum.weighted_accumulate_cuda(t(ids), t(w), t(g), n_rows)
    ref = segment_accum.weighted_accumulate_plain(t(ids), t(w), t(g), n_rows)
    mag = segment_accum.weighted_accumulate_plain(t(ids), t(np.abs(w)),
                                                  t(np.abs(g)), n_rows)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    assert bool(torch.isnan(ref[0]).any())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isposinf(got), torch.isposinf(ref))
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    assert bool(((got - ref).abs()[fin] <= 1e-5 * mag[fin] + 1e-30).all())


def test_weighted_accumulate_kernel_non_finite_rows(dev):
    """Grad rows with +inf, -inf and NaN entries, rows with duplicate ids
    (whose dropped taps add 0 * g: NaN on a non-finite g) and ids out of
    range: the kernel's NaN and inf entries sit exactly where the plain
    version's do; the finite ones are within the reassociation bound."""
    rng = np.random.RandomState(9)
    n, k, c, n_rows = 4000, 8, 40, 300
    ids, w, g = _wa_inputs(rng, n, k, c, n_rows, False)
    ids[rng.rand(n) < 0.1, 3] = n_rows + 5           # out of range
    ids[rng.rand(n) < 0.1, 6] = -1
    bad = rng.choice(n, 30, replace=False)
    g[bad[:10], rng.randint(0, c, 10)] = np.inf
    g[bad[10:20], rng.randint(0, c, 10)] = -np.inf
    g[bad[20:], rng.randint(0, c, 10)] = np.nan
    ids[bad, 4] = ids[bad, 0]                        # duplicates on those rows
    t = lambda a: torch.from_numpy(a).to(dev)
    got = segment_accum.weighted_accumulate_cuda(t(ids), t(w), t(g), n_rows)
    ref = segment_accum.weighted_accumulate_plain(t(ids), t(w), t(g), n_rows)
    mag = segment_accum.weighted_accumulate_plain(t(ids), t(np.abs(w)),
                                                  t(np.abs(g)), n_rows)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isposinf(got), torch.isposinf(ref))
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    assert bool(((got - ref).abs()[fin] <= 1e-5 * mag[fin] + 1e-30).all())


def _smpl_body(seed):
    """SMPL-like vertices: the synthetic model posed with random joints."""
    from sherf_tpu_torch.smpl import smpl_forward
    smpl = synthetic_smpl(0, device="cpu")
    rng = np.random.RandomState(seed)
    poses = torch.from_numpy((rng.randn(72) * 0.2).astype(np.float32))
    shapes = torch.from_numpy((rng.randn(10) * 0.5).astype(np.float32))
    with torch.no_grad():
        return smpl_forward(smpl, poses, shapes)[0].numpy()


def _cluster_body(kind, rng):
    if kind == "smpl":
        return _smpl_body(int(rng.randint(1000)))
    return _verts(rng, 5000 + 37)         # V not a multiple of 128 or 256


def _cluster_queries(kind, verts, rng, n):
    if kind == "far":                      # every query far from the body
        return rng.uniform(5.0, 9.0, (n, 3)).astype(np.float32)
    q = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.05
    q[: n // 8] = rng.uniform(-1.5, 1.5, (n // 8, 3)) + verts.mean(0)
    return q.astype(np.float32)


@pytest.mark.parametrize("body", ["random", "smpl"])
@pytest.mark.parametrize("n,qkind", [(0, "near"), (1, "near"), (1000, "near"),
                                     (70_001, "near"), (3000, "far")])
def test_clustered_nn_kernels_bit_equal_plain(dev, body, n, qkind):
    """nn_1_clustered and nn_1_shortlist: kernel == plain version (idx
    equal, d2 bit-equal) on the wrapper's own prep, and both realise the
    full scan's minimum."""
    rng = np.random.RandomState(n + len(body))
    verts = _cluster_body(body, rng)
    q = _cluster_queries(qkind, verts, rng, n)
    qt, vt = torch.from_numpy(q).to(dev), torch.from_numpy(verts).to(dev)
    cl = knn_cluster.make_clusters(vt, knn_cluster.C_SIZE, sorted_mean=True)
    q_c = (qt - cl.ctr0).contiguous()
    before = dict(knn._cuda.LAUNCHES)
    d2k, ik = knn_cluster.nn_1_clustered_cuda(q_c, cl)
    d2p, ip, _ = knn_cluster.nn_1_clustered_plain(q_c, cl)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(d2k, d2p)
    assert knn._cuda.LAUNCHES["nn_1_clustered"] == before["nn_1_clustered"] + (n > 0)

    sl = knn_cluster.make_clusters(vt, knn_cluster.SL_CSIZE, sorted_mean=False)
    q_s = (qt - sl.ctr0).contiguous()
    counts, ids, _, _ = knn_cluster.shortlist_tiles(q_s, sl)
    d2k, ik = knn_cluster.nn_1_shortlist_cuda(q_s, sl, counts, ids)
    d2p, ip, _ = knn_cluster.nn_1_shortlist_plain(q_s, sl, counts, ids)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(d2k, d2p)
    # the full scan's minimum distance, through the public wrappers
    d_full, _ = knn.nn_1(qt, vt)
    for wrap in (knn_cluster.nn_1_clustered,
                 lambda a, b: knn_cluster.nn_1_shortlist(a, b)[:2]):
        d2, idx = wrap(qt, vt)
        assert idx.dtype == torch.int32 and d2.shape == (n,)
        # centring differs from the full scan's in the last bit
        assert torch.allclose(d2, d_full, rtol=1e-4, atol=1e-10)
        d_at = ((qt.double() - vt.double()[idx.long()]) ** 2).sum(-1)
        d64 = torch.cdist(qt.double(), vt.double()).pow(2).amin(1) if n else d_at
        assert torch.allclose(d_at, d64, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("body", ["random", "smpl"])
@pytest.mark.parametrize("n,kind", [(0, "hit"), (1, "hit"), (70_001, "hit"),
                                    (4097, "miss")])
def test_ray_body_mask_clustered_kernel_equals_plain(dev, body, n, kind):
    rng = np.random.RandomState(n + 7)
    verts = _cluster_body(body, rng)
    o = np.tile(np.asarray([[0.1, 0.2, -1.0]], np.float32), (n, 1))
    tgt = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.2
    if kind == "miss":                     # every line passes far from the body
        tgt = o + np.asarray([[5.0, 0.0, 0.3]], np.float32) + rng.randn(n, 3) * 0.1
    d = (tgt - o).astype(np.float32)
    ot, dt = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    vt = torch.from_numpy(verts).to(dev)
    cl = knn_cluster.make_clusters(vt, knn_cluster.C_SIZE, sorted_mean=True)
    o_c = (ot - cl.ctr0).contiguous()
    thr = (0.05 + 1e-3) ** 2
    mk = knn_cluster.ray_body_mask_clustered_cuda(o_c, dt, cl, thr)
    mp, _ = knn_cluster.ray_body_mask_clustered_plain(o_c, dt, cl, thr)
    torch.cuda.synchronize()
    assert torch.equal(mk, mp)
    full = knn.ray_body_mask(ot, dt, vt, thr)
    # off the f32 borderline the full scan agrees (centring differs)
    assert int((mk != full).sum()) <= max(1, n // 10000)
    if kind == "miss":
        assert not bool(mk.any())
    elif n > 1:
        assert 0 < int(mk.sum()) < n


def test_clustered_wrappers_count_and_reject(dev):
    rng = np.random.RandomState(2)
    verts = torch.from_numpy(_verts(rng)).to(dev)
    q = verts[:100] + 0.01
    for key, call in (
            ("nn_1_clustered", lambda: knn_cluster.nn_1_clustered(q, verts)),
            ("nn_1_shortlist", lambda: knn_cluster.nn_1_shortlist(q, verts)),
            ("ray_body_mask_clustered", lambda: knn_cluster.ray_body_mask_clustered(
                q, q - verts[:100].mean(0), verts, 0.05 ** 2))):
        before = knn._cuda.LAUNCHES[key]
        call()
        assert knn._cuda.LAUNCHES[key] == before + 1
    cl = knn_cluster.make_clusters(verts, knn_cluster.C_SIZE, sorted_mean=True)
    cpu_q = (q - cl.ctr0).cpu()
    with pytest.raises(ValueError):        # a CPU tensor never falls back
        knn_cluster.nn_1_clustered_cuda(cpu_q, cl)
    with pytest.raises(ValueError):
        knn_cluster.ray_body_mask_clustered_cuda(cpu_q, cpu_q, cl, 0.01)
    sl = knn_cluster.make_clusters(verts, knn_cluster.SL_CSIZE, sorted_mean=False)
    counts, ids, _, _ = knn_cluster.shortlist_tiles((q - sl.ctr0).contiguous(), sl)
    with pytest.raises(ValueError):
        knn_cluster.nn_1_shortlist_cuda(cpu_q, sl, counts, ids)
    with pytest.raises(TypeError):
        knn_cluster.nn_1_shortlist_cuda((q - sl.ctr0).contiguous(), sl,
                                        counts.long(), ids)
