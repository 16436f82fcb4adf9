"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: skipped where ``torch.cuda.is_available()`` is False.  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sherf_tpu_torch.device_ops import device_work
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


def _rays_at(rng, verts, n, origin):
    """n rays aimed at the body (hits and misses).  origin "camera": one
    origin for all (a pinhole camera's rays, the kernel's shared-origin
    scan); "spread": each origin moved along its own ray by its own
    distance (every pair computed in full)."""
    o = np.tile(np.asarray([[0.1, 0.2, -1.0]], np.float32), (n, 1))
    tgt = verts[rng.randint(0, len(verts), n)] + rng.randn(n, 3).astype(np.float32) * 0.2
    d = (tgt - o).astype(np.float32)
    if origin == "spread":
        o = (o + d * rng.uniform(-0.3, 0.3, (n, 1))).astype(np.float32)
    return o, d


def _rbm_equal(dev, o, d, verts, thr, active=None):
    """Kernel against plain on centred inputs: raw masks equal."""
    o_c, v_c = knn._centre(torch.from_numpy(o).to(dev),
                           torch.from_numpy(verts).to(dev))
    d_t = torch.from_numpy(d).to(dev)
    act = None if active is None else torch.from_numpy(active).to(dev)
    mk = knn.ray_body_mask_cuda(o_c, d_t, v_c, thr, act)
    mp = knn.ray_body_mask_plain(o_c, d_t, v_c, thr, act)
    torch.cuda.synchronize()
    assert torch.equal(mk, mp)
    return mk.cpu().numpy()


THR = (0.05 + 1e-3) ** 2


@pytest.mark.parametrize("origin", ["camera", "spread"])
@pytest.mark.parametrize("v", [1, 31, 32, 33, 6890, "max"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 70_001, 262_144])
def test_ray_body_mask_kernel_shapes(dev, n, v, origin):
    """N at and around one 256-ray tile and the frame's 262,144; V below,
    at and above the eighth of a warp's range, SMPL's 6,890 and the most
    the shared memory holds."""
    if v == "max":
        v = knn._cuda.library().sherf_knn_max_vertices()
    rng = np.random.RandomState(n + v)
    verts = _verts(rng, v)
    o, d = _rays_at(rng, verts, n, origin)
    m = _rbm_equal(dev, o, d, verts, THR)
    if n >= 70_001 and v >= 6890:
        assert 0 < int(m.sum()) < n


@pytest.mark.parametrize("origin", ["camera", "spread"])
@pytest.mark.parametrize("which", ["0", "255", "256", "last", "all", "none"])
def test_ray_body_mask_kernel_active_tiles(dev, which, origin):
    """One active ray at a tile's first or last ray, or at the last ray of
    a partial last tile, every other tile inactive; all active; none."""
    rng = np.random.RandomState(7)
    verts = _verts(rng)
    n = 70_001
    o, d = _rays_at(rng, verts, n, origin)
    act = np.zeros(n, bool) if which != "all" else np.ones(n, bool)
    if which not in ("all", "none"):
        act[n - 1 if which == "last" else int(which)] = True
    m = _rbm_equal(dev, o, d, verts, THR, act)
    tile_any = np.pad(act, (0, -n % 256)).reshape(-1, 256).any(axis=1)
    assert not m[~np.repeat(tile_any, 256)[:n]].any()
    if which == "all":
        assert 0 < int(m.sum()) < n


@pytest.mark.parametrize("origin", ["camera", "spread"])
def test_ray_body_mask_kernel_odd_rays(dev, origin):
    """Zero-length directions (the 1e-12 clamp), rays parked at 1e6 m (the
    budget's padding) and a NaN in one ray's origin and another's
    direction, spread over tiles."""
    rng = np.random.RandomState(8)
    verts = _verts(rng)
    n = 5000
    o, d = _rays_at(rng, verts, n, origin)
    d[100:140] = 0.0                       # zero-length: the clamp
    d[3000] = 0.0
    o[600:900] = 1e6                       # parked far away
    o[4100:4400] = 1e6
    d[4100:4400] = [1.0, -2.0, 0.5]
    o[1234, 1] = np.nan
    d[2345, 2] = np.nan
    m = _rbm_equal(dev, o, d, verts, THR)
    assert not m[[1234, 2345]].any()
    assert not m[600:900].any() and not m[4100:4400].any()


@pytest.mark.parametrize("origin", ["camera", "spread"])
def test_ray_body_mask_kernel_on_the_threshold(dev, origin):
    """A ray whose minimum equals thr fails the strict '<'; with thr one
    ulp above (the minimum one ulp below thr), it passes."""
    rng = np.random.RandomState(9)
    verts = _verts(rng)
    o, d = _rays_at(rng, verts, 600, origin)
    o_c, v_c = knn._centre(torch.from_numpy(o).to(dev),
                           torch.from_numpy(verts).to(dev))
    d_t = torch.from_numpy(d).to(dev)
    dmin = knn.ray_line_min_plain(o_c, d_t, v_c).cpu().numpy()
    r = int(np.argmin(np.abs(dmin - THR)))
    for thr, want in ((dmin[r], False),
                      (np.nextafter(dmin[r], np.float32(np.inf)), True)):
        m = _rbm_equal(dev, o, d, verts, float(thr))
        assert bool(m[r]) is want


def test_ray_body_mask_kernel_back_to_back(dev):
    """Two calls with different inputs queued without a synchronise: the
    tile counter is reset by each launch."""
    rng = np.random.RandomState(10)
    verts = torch.from_numpy(_verts(rng)).to(dev)
    calls = []
    for n, origin in ((70_001, "camera"), (3000, "spread"),
                      (262_144, "camera")):
        o, d = _rays_at(rng, verts.cpu().numpy(), n, origin)
        o_c, v_c = knn._centre(torch.from_numpy(o).to(dev), verts)
        d_t = torch.from_numpy(d).to(dev)
        act = torch.from_numpy(rng.rand(n) < 0.5).to(dev)
        mk = knn.ray_body_mask_cuda(o_c, d_t, v_c, THR, act)
        calls.append((o_c, d_t, v_c, act, mk))
    for o_c, d_t, v_c, act, mk in calls:
        assert torch.equal(mk, knn.ray_body_mask_plain(o_c, d_t, v_c, THR, act))


def test_ray_body_mask_wrapper_counts_and_reports(dev):
    rng = np.random.RandomState(11)
    verts = torch.from_numpy(_verts(rng)).to(dev)
    before = knn._cuda.LAUNCHES["ray_body_mask"]
    knn.ray_body_mask(verts[:300] - 1.0, verts[:300], verts, THR)
    assert knn._cuda.LAUNCHES["ray_body_mask"] == before + 1
    attrs = knn.ray_body_mask_attrs()
    assert 0 < attrs["registers"] <= 128 and attrs["local_bytes"] >= 0
    too_many = knn._cuda.library().sherf_knn_max_vertices() + 1
    v_big = torch.zeros((too_many, 3), device=dev)
    with pytest.raises(ValueError):
        knn.ray_body_mask_cuda(verts[:4], verts[:4], v_big, THR)


@pytest.mark.parametrize("n,p,cap", [
    (1, 1.0, 1), (8191, 0.5, 100), (8192, 0.5, 4096), (100_000, 0.3, 30_000),
    (100_000, 0.3, 29_000), (100_000, 0.3, 40_000), (3_000_001, 0.05, 150_000),
    (50_000, 0.0, 256),
    # n around a 16-byte group and a 4096-byte tile, and the frame's 12.6M
    # samples, each with the caps around its survivor count
    *[(n, 0.3, "around") for n in (1, 15, 16, 17, "tile-1", "tile",
                                   "tile+1", 12_582_912)],
    # all-True and all-False masks
    *[(n, p, "around") for p in (1.0, 0.0) for n in (17, 4097, 100_003)]])
def test_compact_mask_kernel_equals_plain(dev, n, p, cap):
    """idx and valid equal plain's.  cap "around": 1, one below, at and one
    above the survivor count, and n."""
    tile = compaction._cuda.library().sherf_compact_tile()
    n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(n, n)
    rng = np.random.RandomState(n)
    m = torch.from_numpy(rng.rand(n) < p).to(dev)
    for c in _caps(int(m.sum()), n) if cap == "around" else [cap]:
        _cm_equal(dev, m, c)


def _cm_equal(dev, m, cap):
    """Kernel against plain: idx and valid equal."""
    ik, vk = compaction.compact_mask_cuda(m, cap)
    ip, vp = compaction.compact_mask_plain(m, cap)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(vk, vp)


def _caps(s, n):
    """1, one below, at and one above the survivor count s, and n."""
    return sorted({c for c in (1, s - 1, s, s + 1, n) if c >= 1})


@pytest.mark.parametrize("offset", [1, 3, 15])
@pytest.mark.parametrize("n", [10, 3 * 4096 + 5])
def test_compact_mask_kernel_unaligned_views(dev, offset, n):
    """A mask that is a view starting `offset` bytes into a larger tensor:
    its head and end are partial 16-byte groups (n = 10 at offset 3: one
    group holds both)."""
    rng = np.random.RandomState(offset + n)
    big = torch.from_numpy(rng.rand(n + 64) < 0.4).to(dev)
    big[:offset] = True                       # survivors just before the view
    big[offset + n:] = True                   # and just after it
    m = big[offset:offset + n]
    assert m.is_contiguous() and m.data_ptr() % 16 == offset % 16
    for cap in _caps(int(m.sum()), n):
        _cm_equal(dev, m, cap)


def test_compact_mask_kernel_back_to_back(dev):
    """Calls of different sizes queued without a synchronise (each zeroes
    its own scratch), and one launch counted per call."""
    rng = np.random.RandomState(12)
    before = compaction._cuda.LAUNCHES["compact_mask"]
    calls = []
    for n, cap in ((1_179_648, 417_792), (55_120, 21_248), (262_144, 24_576),
                   (17, 3), (1_179_648, 100)):
        m = torch.from_numpy(rng.rand(n) < 0.3).to(dev)
        calls.append((m, cap, compaction.compact_mask(m, cap)))
    assert compaction._cuda.LAUNCHES["compact_mask"] == before + len(calls)
    for m, cap, (ik, vk) in calls:
        ip, vp = compaction.compact_mask_plain(m, cap)
        assert torch.equal(ik, ip) and torch.equal(vk, vp)
    compaction.compact_mask(m, 0)                    # nothing to launch
    compaction.compact_mask(m[:0], 5)
    assert compaction._cuda.LAUNCHES["compact_mask"] == before + len(calls)


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


def _wa_refs(dev, ids, w, g, n_rows):
    """(kernel, ref64, mag): the kernel's table, the same deduplicated bf16
    products summed in f64 (exact products, so the true sum to ~1e-16),
    and the f32 sum of their absolute values."""
    t = lambda a: torch.from_numpy(a).to(dev)
    got = segment_accum.weighted_accumulate_cuda(t(ids), t(w), t(g), n_rows)
    ref64 = segment_accum.weighted_accumulate_plain(
        t(ids), t(w), t(g), n_rows, dtype=torch.float64)
    mag = segment_accum.weighted_accumulate_plain(t(ids), t(np.abs(w)),
                                                  t(np.abs(g)), n_rows)
    torch.cuda.synchronize()
    assert got.shape == ref64.shape == (n_rows, g.shape[1])
    return got, ref64, mag


def _wa_check(dev, ids, w, g, n_rows):
    """|kernel - ref64| <= 1e-5 * plain(ids, |w|, |g|) + 1e-30: the f32
    atomics sum in their own order, so the bound is the reassociation error
    of the absolute sums, measured against the true sum."""
    got, ref64, mag = _wa_refs(dev, ids, w, g, n_rows)
    assert bool(((got - ref64).abs() <= 1e-5 * mag + 1e-30).all())
    return got


def _wa_check_non_finite(got, ref64, mag):
    """NaN and +-inf where the f64 reference has them; the finite entries
    within the bound of :func:`_wa_check`."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref64))
    assert torch.equal(torch.isposinf(got), torch.isposinf(ref64))
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref64))
    fin = torch.isfinite(ref64)
    assert bool(((got - ref64).abs()[fin] <= 1e-5 * mag[fin] + 1e-30).all())


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
    got, ref, mag = _wa_refs(dev, ids, w, g, n_rows)
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    assert bool(torch.isnan(ref[0]).any())
    _wa_check_non_finite(got, ref, mag)


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
    got, ref, mag = _wa_refs(dev, ids, w, g, n_rows)
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    _wa_check_non_finite(got, ref, mag)


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


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _clustered_nn_bit_equal(dev, q, verts):
    """B5 and B6 on the card against their plain versions on the same
    (kernel-made) Clusters: idx equal, d2 bit-equal, B6's tile lists equal
    to shortlist_tiles; both on raw queries and with the remap."""
    qt, vt = torch.from_numpy(q).to(dev), torch.from_numpy(verts).to(dev)
    n = len(q)
    cl = knn_cluster.make_clusters(vt, knn_cluster.C_SIZE, sorted_mean=True)
    q_c = (qt - cl.ctr0).contiguous()
    before = dict(knn._cuda.LAUNCHES)
    d2k, ik = knn_cluster.nn_1_clustered_cuda(qt, cl)
    d2p, ip, _ = knn_cluster.nn_1_clustered_plain(q_c, cl)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(_bits(d2k), _bits(d2p))
    assert knn._cuda.LAUNCHES["nn_1_clustered"] == before["nn_1_clustered"] + (n > 0)
    d2r, ir = knn_cluster.nn_1_clustered_cuda(qt, cl, remap=True)
    assert torch.equal(_bits(d2r), _bits(d2k))
    assert torch.equal(ir.long(), cl.order[ik.long()])

    sl = knn_cluster.make_clusters(vt, knn_cluster.SL_CSIZE, sorted_mean=False)
    q_s = (qt - sl.ctr0).contiguous()
    counts, ids, _, _ = knn_cluster.shortlist_tiles(q_s, sl)
    lists = (torch.full_like(counts, -1), torch.full_like(ids, -1))
    d2k, ik, over = knn_cluster.nn_1_shortlist_cuda(qt, sl, lists=lists)
    d2p, ip, _ = knn_cluster.nn_1_shortlist_plain(q_s, sl, counts, ids)
    torch.cuda.synchronize()
    assert int(over) == 0 and over.shape == ()
    assert torch.equal(lists[0], counts) and torch.equal(lists[1], ids)
    assert torch.equal(ik, ip) and torch.equal(_bits(d2k), _bits(d2p))
    return qt, vt


def test_clustered_kernels_grain_matches_plain(dev):
    lib = knn._cuda.library()
    assert lib.sherf_nn1_cluster_unit() == knn_cluster.NN_GROUP
    assert lib.sherf_nn1_shortlist_tile() == knn_cluster.P_TILE


@pytest.mark.parametrize("sorted_mean", [True, False])
@pytest.mark.parametrize("csize", [128, 256])
@pytest.mark.parametrize("v", [1, 33, 1000, 5037, "smpl", "dupes", 16384])
def test_cluster_prep_bit_equals_plain(dev, v, csize, sorted_mean):
    """The prep kernel's Clusters equal make_clusters_plain's bit for bit:
    the stable Morton order (equal codes in ascending vertex order), the
    sorted centred rows, the f64-summed centre and centroids, the radii."""
    rng = np.random.RandomState(11)
    if v == "smpl":
        verts = _smpl_body(3)
    elif v == "dupes":                     # many equal Morton codes
        verts = _verts(rng, 3000)
        verts[1000:2000] = verts[rng.randint(0, 1000, 1000)]
        verts = np.round(verts * 20) / 20
    else:
        verts = _verts(rng, v)
    vt = torch.from_numpy(verts.astype(np.float32)).to(dev)
    before = knn._cuda.LAUNCHES["cluster_prep"]
    ck = knn_cluster.make_clusters_cuda(vt, csize, sorted_mean)
    cp = knn_cluster.make_clusters_plain(vt, csize, sorted_mean)
    torch.cuda.synchronize()
    assert knn._cuda.LAUNCHES["cluster_prep"] == before + 1
    for f in ("order", "vs", "ctr0", "cent", "rad"):
        a, b = getattr(ck, f), getattr(cp, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(_bits(a), _bits(b)), f
    assert torch.equal(ck.order.sort().values,
                       torch.arange(vt.shape[0], device=dev))


@pytest.mark.parametrize("body", ["random", "smpl"])
@pytest.mark.parametrize("n,qkind", [(0, "near"), (1, "near"), (129, "near"),
                                     (513, "near"), (1000, "near"),
                                     (70_001, "near"), (3000, "far")])
def test_clustered_nn_kernels_bit_equal_plain(dev, body, n, qkind):
    """nn_1_clustered and nn_1_shortlist: kernel == plain version (idx
    equal, d2 bit-equal) on the wrapper's own prep, and both realise the
    full scan's minimum."""
    rng = np.random.RandomState(n + len(body))
    verts = _cluster_body(body, rng)
    q = _cluster_queries(qkind, verts, rng, n)
    qt, vt = _clustered_nn_bit_equal(dev, q, verts)
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


@pytest.mark.parametrize("park", ["far", "body"])
@pytest.mark.parametrize("runs", ["all", "tail_13", "across_tile",
                                  "across_unit", "alternate"])
def test_clustered_nn_kernels_identical_queries(dev, runs, park):
    """Runs of bit-identical queries, which the kernels scan cooperatively
    where a whole unit of 128 is one point: every query one point; a tail
    from an odd offset (the budgets' padding); one run across the shortlist
    tile boundary at 512; one across a unit boundary only; runs of 64.
    Kernel == plain version on each."""
    rng = np.random.RandomState(5)
    verts = _smpl_body(7)
    n = 4000
    q = _cluster_queries("near", verts, rng, n)
    point = (np.asarray([5.0, 9.0, -3.0], np.float32) if park == "far"
             else verts[1234] + 0.01)
    if runs == "all":
        q[:] = point
    elif runs == "tail_13":
        q[1000 + 13:] = point
    elif runs == "across_tile":
        q[448:640] = point
    elif runs == "across_unit":
        q[64:192] = point
    else:
        for s in range(0, n, 128):
            q[s:s + 64] = q[s]
    _clustered_nn_bit_equal(dev, q, verts)


@pytest.mark.parametrize("where", ["duplicate", "mirrored"])
def test_clustered_nn_kernels_ties_in_cooperative_scan(dev, where):
    """Ties inside a cooperative scan go to the first row in visit order,
    as the sequential scan (strict '<') takes them: two duplicate vertices
    (adjacent rows), or three vertices 1/256 m from the query along +x, -x
    and +z (exact in f32 on a 1/1024 grid: the same d2, in other rows and
    clusters).  Every query of most units is that one point."""
    rng = np.random.RandomState(9)
    verts = np.round(_verts(rng, 3000) * 1024) / 1024
    p = verts[17].copy()
    if where == "duplicate":
        verts[18] = p
    else:
        e = np.float32(1 / 256)
        verts[17] = p + [0, 0, e]
        verts[100] = p + [e, 0, 0]
        verts[2900] = p - [e, 0, 0]
    verts = verts.astype(np.float32)
    for point in (p, p + np.float32(1e-3)):
        q = np.tile(point[None], (600, 1)).astype(np.float32)
        q[:100] += rng.randn(100, 3).astype(np.float32) * 0.01  # a mixed unit
        _clustered_nn_bit_equal(dev, q, verts)


def _frame_layout(o, d, dev):
    """(N, 3) views in the frame's layout: the origins of a (1, N, 3) batch
    tensor stored as (1, 3, N), read at strides (1, N); the directions as
    columns 3:6 of (N, 8) rows."""
    n = o.shape[0]
    o_v = torch.from_numpy(np.ascontiguousarray(o.T)).to(dev)[None].transpose(
        1, 2)[0]
    buf = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    buf[:, 3:6] = torch.from_numpy(d).to(dev)
    return o_v, buf[:, 3:6]


def test_clustered_wrappers_device_ops(dev):
    """Each public clustered wrapper is 3 device operations a call: the
    prep kernel, a memset and its kernel; for B7 also on the frame's
    strided rays (no centring, no copy)."""
    rng = np.random.RandomState(4)
    verts = torch.from_numpy(_smpl_body(2)).to(dev)
    q = torch.from_numpy(_cluster_queries("near", verts.cpu().numpy(), rng,
                                          20_000)).to(dev)
    d = (q - verts[:1]).contiguous()
    o_v, d_v = _frame_layout(q.cpu().numpy(), d.cpu().numpy(), dev)
    assert not o_v.is_contiguous() and not d_v.is_contiguous()
    for call in (lambda: knn_cluster.nn_1_clustered(q, verts),
                 lambda: knn_cluster.nn_1_shortlist(q, verts),
                 lambda: knn_cluster.ray_body_mask_clustered(q, d, verts,
                                                             0.05 ** 2),
                 lambda: knn_cluster.ray_body_mask_clustered(o_v, d_v, verts,
                                                             0.05 ** 2)):
        assert round(device_work(call, reps=10)["ops_per_call"]) == 3


def _rbmc_rays(rng, verts, n, origin):
    """n rays aimed at the body: one camera origin ("shared"), each origin
    moved along its own ray ("spread"), or every third one moved, so that
    a unit of 32 mixes both ("mixed")."""
    o, d = _rays_at(rng, verts, n, "camera")
    if origin != "shared":
        move = rng.uniform(-0.3, 0.3, (n, 1)).astype(np.float32)
        if origin == "mixed":
            move[np.arange(n) % 3 != 0] = 0.0
        o = (o + d * move).astype(np.float32)
    return o, d


def _rbmc_equal(dev, o, d, verts, thr, csize=None, layout=None):
    """B7's kernel on raw rays (contiguous, or in the given layout) against
    its plain version on the same kernel-made Clusters (masks equal); at
    the default cluster size the public wrapper too.  Returns the mask."""
    csize = csize or knn_cluster.C_SIZE
    vt = torch.from_numpy(verts).to(dev)
    ot, dt = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    o_k, d_k = (ot, dt) if layout is None else layout
    cl = knn_cluster.make_clusters(vt, csize, sorted_mean=True)
    before = knn._cuda.LAUNCHES["ray_body_mask_clustered"]
    mk = knn_cluster.ray_body_mask_clustered_cuda(o_k, d_k, cl, thr)
    mp, _ = knn_cluster.ray_body_mask_clustered_plain(
        (ot - cl.ctr0).contiguous(), dt, cl, thr)
    torch.cuda.synchronize()
    assert knn._cuda.LAUNCHES["ray_body_mask_clustered"] == before + (len(o) > 0)
    assert mk.dtype == torch.bool and mk.shape == (len(o),)
    assert torch.equal(mk, mp)
    if csize == knn_cluster.C_SIZE:
        assert torch.equal(knn_cluster.ray_body_mask_clustered(o_k, d_k, vt, thr),
                           mp)
    return mk


@pytest.mark.parametrize("origin", ["shared", "spread", "mixed"])
@pytest.mark.parametrize("body", ["random", "smpl"])
@pytest.mark.parametrize("n,kind", [
    (0, "hit"), (1, "hit"), (31, "hit"), (32, "hit"), (33, "hit"),
    (255, "hit"), (257, "hit"), (70_001, "hit"), (262_144, "hit"),
    (4097, "miss")])
def test_ray_body_mask_clustered_kernel_equals_plain(dev, body, n, kind,
                                                     origin):
    """Kernel == plain version (and wrapper == plain) at N around one unit
    of 32 rays, a partial last unit, and the frame's 262,144; origins
    shared, spread or mixed within a unit; off the f32 borderline the full
    scan agrees."""
    rng = np.random.RandomState(n + 7)
    verts = _cluster_body(body, rng)
    o, d = _rbmc_rays(rng, verts, n, origin)
    if kind == "miss":                     # every line passes far from the body
        tgt = o + np.asarray([[5.0, 0.0, 0.3]], np.float32) + rng.randn(n, 3) * 0.1
        d = (tgt - o).astype(np.float32)
    mk = _rbmc_equal(dev, o, d, verts, THR)
    full = knn.ray_body_mask(torch.from_numpy(o).to(dev),
                             torch.from_numpy(d).to(dev),
                             torch.from_numpy(verts).to(dev), THR)
    # off the f32 borderline the full scan agrees (centring differs)
    assert int((mk != full).sum()) <= max(1, n // 10000)
    if kind == "miss":
        assert not bool(mk.any())
    elif n > 100:
        assert 0 < int(mk.sum()) < n


@pytest.mark.parametrize("origin", ["shared", "spread"])
@pytest.mark.parametrize("v", [5037, "max"])
@pytest.mark.parametrize("csize", [32, 64, 128, 256])
def test_ray_body_mask_clustered_kernel_cluster_sizes(dev, csize, v, origin):
    """Clusters of 32 (216 of them at SMPL's size), 64, 128 (a pass) and
    256 (two passes); V not a multiple of any, and the most vertices the
    kernel's shared memory holds beside the cluster table."""
    if v == "max":
        cap = knn._cuda.library().sherf_knn_max_vertices()
        v = max(x for x in range(cap - cap // csize - 2, cap + 1)
                if x + -(-x // csize) <= cap)
    rng = np.random.RandomState(csize + 3)
    verts = _verts(rng, v)
    o, d = _rbmc_rays(rng, verts, 20_000, origin)
    m = _rbmc_equal(dev, o, d, verts, THR, csize=csize)
    assert 0 < int(m.sum()) < len(o)


@pytest.mark.parametrize("origin", ["shared", "spread"])
def test_ray_body_mask_clustered_kernel_odd_rays(dev, origin):
    """NaN in origins and directions (a whole unit's, and single rays'),
    zero-length directions (the 1e-12 clamp) and rays parked at 1e6 m (the
    budget's padding), spread over units."""
    rng = np.random.RandomState(8)
    verts = _smpl_body(5)
    n = 5000
    o, d = _rbmc_rays(rng, verts, n, origin)
    d[100:140] = 0.0
    d[3000] = 0.0
    o[600:900] = 1e6
    o[4100:4400] = 1e6
    d[4100:4400] = [1.0, -2.0, 0.5]
    o[1234, 1] = np.nan
    d[2345, 2] = np.nan
    o[2496:2528] = np.nan                  # one whole unit
    m = _rbmc_equal(dev, o, d, verts, THR).cpu().numpy()
    assert not m[[1234, 2345]].any() and not m[2496:2528].any()
    assert not m[600:900].any() and not m[4100:4400].any()


@pytest.mark.parametrize("origin", ["shared", "spread"])
def test_ray_body_mask_clustered_kernel_on_the_threshold(dev, origin):
    """A ray whose line minimum (every row of the Clusters, the plain
    version's operations) equals thr fails the strict '<'; with the minimum
    one ulp below thr it passes."""
    rng = np.random.RandomState(9)
    verts = _smpl_body(6)
    o, d = _rbmc_rays(rng, verts, 600, origin)
    vt = torch.from_numpy(verts).to(dev)
    cl = knn_cluster.make_clusters(vt, knn_cluster.C_SIZE, sorted_mean=True)
    o_c = (torch.from_numpy(o).to(dev) - cl.ctr0).contiguous()
    d_t = torch.from_numpy(d).to(dev)
    dd_inv, _ = knn_cluster.ray_cluster_bounds(o_c, d_t, cl)
    dmin = knn_cluster._line_terms(o_c, d_t, dd_inv, cl.vs).amin(1).cpu().numpy()
    r = int(np.argmin(np.abs(dmin - THR)))
    for thr, want in ((dmin[r], False),
                      (np.nextafter(dmin[r], np.float32(np.inf)), True)):
        m = _rbmc_equal(dev, o, d, verts, float(thr))
        assert bool(m[r]) is want


@pytest.mark.parametrize("layout", ["frame", "transposed", "expanded",
                                    "offset"])
def test_ray_body_mask_clustered_kernel_strided_rays(dev, layout):
    """The kernel reads rays in place at any strides: the frame's layout
    (origins at strides (1, N), directions as columns of wider rows), both
    transposed, one origin broadcast at stride 0, and views at a storage
    offset.  Each equals the plain version on contiguous copies."""
    rng = np.random.RandomState(13)
    verts = _smpl_body(4)
    n = 70_001
    o, d = _rbmc_rays(rng, verts, n, "shared")
    ot, dt = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    if layout == "frame":
        views = _frame_layout(o, d, dev)
    elif layout == "transposed":
        views = (ot.t().contiguous().t(), dt.t().contiguous().t())
    elif layout == "expanded":
        views = (ot[:1].expand(n, 3), dt)
    else:
        buf = torch.cat([dt[:7], ot, dt]).contiguous()
        views = (buf[7:7 + n], buf[7 + n:])
    assert torch.equal(views[0], ot) and torch.equal(views[1], dt)
    m = _rbmc_equal(dev, o, d, verts, THR, layout=views)
    assert 0 < int(m.sum()) < n


def test_ray_body_mask_clustered_kernel_two_streams(dev):
    """Two calls with different inputs on two streams, queued without a
    synchronise: each has its own unit counter."""
    rng = np.random.RandomState(10)
    verts = torch.from_numpy(_smpl_body(8)).to(dev)
    cl = knn_cluster.make_clusters(verts, knn_cluster.C_SIZE, sorted_mean=True)
    calls = []
    torch.cuda.synchronize()
    for n, origin in ((262_144, "shared"), (70_001, "spread")):
        o, d = _rbmc_rays(rng, verts.cpu().numpy(), n, origin)
        ot, dt = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        calls.append((ot, dt, torch.cuda.Stream()))
    torch.cuda.synchronize()
    outs = []
    for ot, dt, st in calls:
        with torch.cuda.stream(st):
            outs.append(knn_cluster.ray_body_mask_clustered_cuda(ot, dt, cl,
                                                                 THR))
    torch.cuda.synchronize()
    for (ot, dt, _), mk in zip(calls, outs):
        mp, _ = knn_cluster.ray_body_mask_clustered_plain(
            (ot - cl.ctr0).contiguous(), dt, cl, THR)
        assert torch.equal(mk, mp)


def test_nn_1_kernel_two_streams(dev):
    """Two calls with different inputs and sizes on two streams, queued
    without a synchronise: each has its own tile counter."""
    rng = np.random.RandomState(12)
    calls = []
    for n, v in ((262_144, 6890), (70_001, 3001)):
        verts = _verts(rng, v)
        q = (verts[rng.randint(0, v, n)]
             + rng.randn(n, 3).astype(np.float32) * 0.05)
        q_c, v_c = knn._centre(torch.from_numpy(q).to(dev),
                               torch.from_numpy(verts).to(dev))
        calls.append((q_c, v_c, torch.cuda.Stream()))
    torch.cuda.synchronize()
    outs = []
    for q_c, v_c, st in calls:
        with torch.cuda.stream(st):
            outs.append(knn.nn_1_cuda(q_c, v_c))
    torch.cuda.synchronize()
    for (q_c, v_c, _), (d2k, ik) in zip(calls, outs):
        d2p, ip = knn.nn_1_plain(q_c, v_c)
        assert torch.equal(ik, ip) and torch.equal(d2k, d2p)


def test_ray_body_mask_kernel_two_streams(dev):
    """Two calls with different inputs and sizes on two streams, queued
    without a synchronise: each has its own tile counter."""
    rng = np.random.RandomState(13)
    verts = torch.from_numpy(_verts(rng)).to(dev)
    calls = []
    for n, origin in ((262_144, "camera"), (70_001, "spread")):
        o, d = _rays_at(rng, verts.cpu().numpy(), n, origin)
        o_c, v_c = knn._centre(torch.from_numpy(o).to(dev), verts)
        act = torch.from_numpy(rng.rand(n) < 0.5).to(dev)
        calls.append((o_c, torch.from_numpy(d).to(dev), v_c, act,
                      torch.cuda.Stream()))
    torch.cuda.synchronize()
    outs = []
    for o_c, d_t, v_c, act, st in calls:
        with torch.cuda.stream(st):
            outs.append(knn.ray_body_mask_cuda(o_c, d_t, v_c, THR, act))
    torch.cuda.synchronize()
    for (o_c, d_t, v_c, act, _), mk in zip(calls, outs):
        mp = knn.ray_body_mask_plain(o_c, d_t, v_c, THR, act)
        assert torch.equal(mk, mp)
        assert 0 < int(mk.sum()) < o_c.shape[0]


def test_host_smpl_copy_follows_its_model(dev):
    """The data pipeline's CPU copy of a card model is made once and kept
    on that model: models made and dropped in sequence each give their
    own vertices."""
    from sherf_tpu_torch.data.base import host_smpl_verts
    from sherf_tpu_torch.smpl import big_pose_params, smpl_forward

    bp = big_pose_params()
    for seed in (0, 1, 0):
        m = synthetic_smpl(seed, device=dev)
        assert m.host() is m.host() and m.host().v_template.device.type == "cpu"
        v, _ = host_smpl_verts(m, bp["poses"], bp["shapes"])
        ref = synthetic_smpl(seed, device="cpu")
        with torch.no_grad():
            own = smpl_forward(ref, torch.from_numpy(bp["poses"]),
                               torch.from_numpy(bp["shapes"]))[0]
        assert np.array_equal(v, own.numpy())
        del m


def test_ray_body_mask_clustered_attrs(dev):
    attrs = knn_cluster.ray_body_mask_clustered_attrs()
    # one block of 1,024 threads an SM: at most 64 registers a thread
    assert 0 < attrs["registers"] <= 64 and attrs["local_bytes"] >= 0


def test_clustered_wrappers_count_and_reject(dev):
    rng = np.random.RandomState(2)
    verts = torch.from_numpy(_verts(rng)).to(dev)
    q = verts[:100] + 0.01
    for key, call in (
            ("nn_1_clustered", lambda: knn_cluster.nn_1_clustered(q, verts)),
            ("nn_1_shortlist", lambda: knn_cluster.nn_1_shortlist(q, verts)),
            ("ray_body_mask_clustered", lambda: knn_cluster.ray_body_mask_clustered(
                q, q - verts[:100].mean(0), verts, 0.05 ** 2))):
        before = dict(knn._cuda.LAUNCHES)
        call()
        assert knn._cuda.LAUNCHES[key] == before[key] + 1
        assert knn._cuda.LAUNCHES["cluster_prep"] == before["cluster_prep"] + 1
    cl = knn_cluster.make_clusters(verts, knn_cluster.C_SIZE, sorted_mean=True)
    cpu_q = q.cpu()
    with pytest.raises(ValueError):        # a CPU tensor never falls back
        knn_cluster.nn_1_clustered_cuda(cpu_q, cl)
    with pytest.raises(ValueError):
        knn_cluster.ray_body_mask_clustered_cuda(cpu_q, cpu_q, cl, 0.01)
    with pytest.raises(ValueError):
        knn_cluster.make_clusters_cuda(verts.cpu(), 128, True)
    with pytest.raises(ValueError):        # beyond the prep's sort
        knn_cluster.make_clusters_cuda(verts.new_zeros((16385, 3)), 128, True)
    sl = knn_cluster.make_clusters(verts, knn_cluster.SL_CSIZE, sorted_mean=False)
    counts, ids, _, _ = knn_cluster.shortlist_tiles((q - sl.ctr0).contiguous(), sl)
    with pytest.raises(ValueError):
        knn_cluster.nn_1_shortlist_cuda(cpu_q, sl)
    with pytest.raises(TypeError):
        knn_cluster.nn_1_shortlist_cuda(q, sl, lists=(counts.long(), ids))
    with pytest.raises(ValueError):        # more clusters than a tile ranks
        knn_cluster.nn_1_shortlist_cuda(q, knn_cluster.make_clusters(
            verts, 64, sorted_mean=False))


def test_train_step_with_lpips_on_the_card(dev):
    """A train step with LPIPS in the loss (a random state dict in the
    lpips package's layout): finite loss, LPIPS > 0 and equal to the CPU
    module's on the step's own inputs, every overflow counter 0."""
    import dataclasses

    from sherf_tpu_torch.core.calibrate import calibrate_budgets
    from sherf_tpu_torch.core.config import (ModelConfig, RenderConfig,
                                             TrainConfig)
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.smpl import big_pose_params, smpl_forward
    from sherf_tpu_torch.train import create_train_state, make_train_step
    from sherf_tpu_torch.train.lpips import LPIPS, load_lpips_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    sd = {}
    for k, v in LPIPS().state_dict().items():
        if k.startswith("scaling_layer."):
            sd[k] = v.clone()
        elif k.startswith("lins."):
            sd[k] = torch.rand(v.shape, generator=g) * 0.1
        elif v.dim() == 4:                 # He-scaled convolutions
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()
                                                         ) ** 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
    lp_dev = load_lpips_state_dict(LPIPS(), sd).to(dev).eval()
    lp_cpu = load_lpips_state_dict(LPIPS(), sd).eval()

    smpl = synthetic_smpl(0, device="cpu")
    bp = big_pose_params()
    with torch.no_grad():
        tv = smpl_forward(smpl, torch.from_numpy(bp["poses"]),
                          torch.from_numpy(bp["shapes"]))[0].numpy()
    cfg = ModelConfig(backbone_resolution=64, channel_base=1024,
                      channel_max=32, voxel_size=0.02,
                      render=RenderConfig(depth_resolution=8))
    _, out_sh = prepare_voxel_volume(tv, voxel_size=cfg.voxel_size)
    batch = make_synthetic_batch(smpl, batch_size=1, H=32, W=32, seed=0,
                                 device=dev)
    fitted, _ = calibrate_budgets([batch], cfg, margin=1.3)
    cfg = dataclasses.replace(cfg, render=fitted)
    model = SHERFGenerator(cfg, out_sh=out_sh, device=dev)
    random_init_(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, TrainConfig(batch_size=1))
    seen = []

    def lpips_fn(a, b):
        seen.append((a.detach().cpu(), b.detach().cpu()))
        return lp_dev(a, b)

    step = make_train_step(model, smpl.to(dev), TrainConfig(batch_size=1),
                           lpips_fn=lpips_fn)
    m = step(state, batch, torch.Generator(device=dev).manual_seed(0))
    assert int(m["overflow"]) == 0
    assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"]))
    assert float(m["lpips"]) > 0 and len(seen) == 1
    with torch.no_grad():
        ref = lp_cpu(*seen[0]).mean()
    assert float(m["lpips"]) == pytest.approx(float(ref), rel=1e-4)
