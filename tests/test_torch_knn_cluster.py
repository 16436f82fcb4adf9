"""The port's clustered nearest-vertex kernels (plain versions, on the CPU)
against the JAX package's Pallas kernels run in interpret mode, on the same
numpy inputs: ``nn_1_clustered`` (B5), ``nn_1_shortlist`` (B6) and
``ray_body_mask_clustered`` (B7), their prep, their dispatch, the generator
with both switches on, and the overflow counters of the sparse-conv stages.

Inputs are those of ``tests/test_knn.py`` (surface plus far-field queries,
1024 x 1500; coherent queries, 1024 x 1500; incoherent tiles, 512 x 2048;
rays, 512 x 1300) plus one SMPL-sized case (V = 6890, ``synthetic_smpl(0)``).

Two levels of comparison:
  * kernel: a spy on ``pl.pallas_call`` captures the Pallas kernel's own
    inputs (centred, sorted, padded), and the port's plain version runs on
    exactly those.  Indices and masks must be EQUAL, squared distances within
    2 ulp (XLA's CPU backend contracts the interpret-mode sums into FMAs; the
    port rounds every operation) — masks off the f32 borderline of thr.
  * wrapper: the public functions on the raw inputs.  Each side centres on
    its own f32 mean, summed in another order, which moves d2 by up to ~1e-5
    relative: d2 is held to rtol 1e-4, indices stay equal (B5), the index
    realises the f64 minimum (B6), masks agree off the borderline (B7).
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sherf_tpu.core.calibrate import calibrate_budgets as j_calibrate
from sherf_tpu.core.diag import overflow_report as j_overflow_report
from sherf_tpu.core.diag import overflow_total as j_overflow_total
from sherf_tpu.features import sparseconv as j_sc
from sherf_tpu.kernels import knn_pallas as kp
from sherf_tpu.models import SHERFGenerator as JGenerator
from sherf_tpu.smpl import synthetic_smpl as j_synthetic_smpl
from sherf_tpu_torch.compat.flax_bridge import from_flax
from sherf_tpu_torch.core.calibrate import calibrate_budgets
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig
from sherf_tpu_torch.core.diag import Diag, overflow_report, overflow_total
from sherf_tpu_torch.features import sparseconv as t_sc
from sherf_tpu_torch.kernels import _cuda, knn
from sherf_tpu_torch.kernels import knn_cluster as kc
from sherf_tpu_torch.models.generator import SHERFGenerator
from test_torch_e2e import D, MODEL_KW, _psnr, scene  # noqa: F401 (fixture)

T = torch.from_numpy
THR = (0.05 + 1e-3) ** 2


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---- the inputs of tests/test_knn.py, and an SMPL-sized body ---------------

def _surface_and_far():            # test_nn_clustered_matches_full_scan
    rng = np.random.RandomState(4)
    v = (rng.randn(1500, 3) * 0.4).astype(np.float32)
    q = np.concatenate([
        v[rng.randint(0, 1500, 700)] + rng.randn(700, 3).astype(np.float32) * 0.05,
        rng.uniform(-1.5, 1.5, (324, 3)).astype(np.float32)])
    return q, v


def _coherent():                   # test_nn_shortlist_matches_full_scan
    rng = np.random.RandomState(6)
    v = (rng.randn(1500, 3) * 0.4).astype(np.float32)
    q = v[np.argsort(v[:, 0])][rng.randint(0, 1500, 1024) // 2 * 2]
    return (q + rng.randn(1024, 3).astype(np.float32) * 0.03).astype(np.float32), v


def _incoherent():                 # test_nn_shortlist_exact_on_incoherent_tiles
    rng = np.random.RandomState(7)
    v = (rng.randn(2048, 3) * 0.5).astype(np.float32)
    return rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32), v


def _smpl_body():
    v = np.array(j_synthetic_smpl(0).v_template, np.float32)
    rng = np.random.RandomState(8)
    q = v[np.sort(rng.randint(0, len(v), 2048))] \
        + rng.randn(2048, 3).astype(np.float32) * 0.03
    return q.astype(np.float32), v


QUERY_SETS = {"surface_far": _surface_and_far, "coherent": _coherent,
              "incoherent": _incoherent, "smpl": _smpl_body}


def _rays(kind):
    if kind == "random":           # test_ray_body_mask_clustered_matches_full
        rng = np.random.RandomState(5)
        verts = (rng.randn(1300, 3) * 0.3).astype(np.float32)
        o = (rng.randn(512, 3) * 2.0).astype(np.float32)
        d = rng.randn(512, 3).astype(np.float32)
        return o, d, verts
    rng = np.random.RandomState(9)
    verts = np.array(j_synthetic_smpl(0).v_template, np.float32)
    o = np.tile(np.asarray([[0.1, 0.2, -2.0]], np.float32), (1000, 1))
    tgt = verts[rng.randint(0, len(verts), 1000)] \
        + rng.randn(1000, 3).astype(np.float32) * 0.1
    return o, (tgt - o).astype(np.float32), verts


def _line_min(o, d, verts):
    """f64 min over vertices of the squared distance to each ray's line."""
    o, d, v = (np.asarray(x, np.float64) for x in (o, d, verts))
    w = v[None] - o[:, None]
    b = (w * d[:, None]).sum(-1)
    return ((w ** 2).sum(-1) - b * b / (d * d).sum(-1)[:, None]).min(1)


@pytest.fixture
def pallas_inputs(monkeypatch):
    """Records, per pallas_call launch, its array arguments (numpy)."""
    seen = []
    real = kp.pl.pallas_call

    def spy(*a, **k):
        f = real(*a, **k)

        def call(*args):
            seen.append([np.array(x) for x in args])
            return f(*args)
        return call
    monkeypatch.setattr(kp.pl, "pallas_call", spy)
    return seen


def _clusters_from(vs_pad_t, n_real, csize, cent_t=None, rad_t=None):
    """A port Clusters over the Pallas kernel's own sorted centred rows."""
    vs_pad = T(np.array(vs_pad_t.T))
    C = vs_pad.shape[0] // csize
    if cent_t is None:
        cent, rad = kc.cluster_stats(vs_pad, n_real, csize)
    else:
        cent = T(np.array(cent_t.T[:C]))
        rad = T(np.array(rad_t[0, :C]))
    return kc.Clusters(vs_pad[:n_real].contiguous(), cent, rad,
                       torch.arange(n_real), torch.zeros(3), csize)


# ---- prep -------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(QUERY_SETS))
def test_morton_order_and_cluster_stats_match_jax(case):
    _, v = QUERY_SETS[case]()
    np.testing.assert_array_equal(kc.morton_order(T(v)).numpy(),
                                  np.asarray(kp.morton_order(jnp.asarray(v))))
    order = np.asarray(kp.morton_order(jnp.asarray(v)))
    for csize in (kc.C_SIZE, kc.SL_CSIZE):
        vs = v[order] - v[order].mean(0)
        vs_pad = np.concatenate([vs, np.full((-len(v) % csize, 3), kc.SENTINEL,
                                             np.float32)]).astype(np.float32)
        cj, rj = kp._cluster_stats_sized(jnp.asarray(vs_pad), len(v), csize)
        ct, rt = kc.cluster_stats(T(vs_pad), len(v), csize)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6)
    # an all-padding cluster parks its centroid on the sentinel
    pad = np.concatenate([v[:200], np.full((312, 3), kc.SENTINEL, np.float32)])
    ct, _ = kc.cluster_stats(T(pad), 200, 128)
    assert bool((ct[2:] == kc.SENTINEL).all()) and bool((ct[:2] < 10).all())


def test_lane_sum_is_the_prep_kernels_order():
    """The fixed-order f64 sums of the plain prep: lane l adds rows l, l +
    lanes, ... in turn, then lane l + h onto lane l, halving (the prep
    kernel's order), emulated here with Python floats; the centre is that
    sum over V rounded once, within an ulp of the exact mean."""
    rng = np.random.RandomState(13)
    x = (rng.randn(3000, 3) * [0.3, 0.6, 0.15] + [0.1, 0.2, 2.0]).astype(np.float32)
    for lanes in (kc.CLUSTER_LANES, kc.PREP_LANES):
        acc = [[0.0] * 3 for _ in range(lanes)]
        for r in range(len(x)):
            for d in range(3):
                acc[r % lanes][d] += float(x[r, d])
        h = lanes // 2
        while h:
            for l in range(h):
                for d in range(3):
                    acc[l][d] += acc[l + h][d]
            h //= 2
        got = kc._lane_sum(T(x), lanes)
        assert got.dtype == torch.float64
        assert got.tolist() == acc[0]
    cl = kc.make_clusters_plain(T(x), kc.C_SIZE, sorted_mean=False)
    exact = np.array([math.fsum(map(float, x[:, d])) / len(x) for d in range(3)])
    assert (_ulps(cl.ctr0.numpy(), exact.astype(np.float32)) <= 1).all()


@pytest.mark.parametrize("case", ["coherent", "incoherent", "smpl"])
def test_shortlist_tiles_match_jax(case, pallas_inputs):
    """counts and lb-sorted ids per 512-query tile equal the Pallas
    wrapper's, except in tiles where a cluster's lb_r lies within 1e-6
    relative of ub_r (counts) or of another cluster's lb_r (ids): there the
    last-bit difference of the two centroids may flip the comparison."""
    q, v = QUERY_SETS[case]()
    kp.nn_1_shortlist_pallas(jnp.asarray(q), jnp.asarray(v), interpret=True)
    meta = pallas_inputs[-1][0]
    cl = kc.make_clusters(T(v), kc.SL_CSIZE, sorted_mean=False)
    counts, ids, lb, ub = kc.shortlist_tiles((T(q) - cl.ctr0).contiguous(), cl)
    n_t, C = ids.shape
    cj, ij = meta[:n_t], meta[n_t:].reshape(n_t, C)
    lb, ub = lb.numpy().astype(np.float64), ub.numpy().astype(np.float64)
    compared = 0
    for t in range(n_t):
        tol = 1e-6 * ub[t]
        gaps = np.diff(np.sort(lb[t]))
        borderline = (np.abs(lb[t] - ub[t]) <= tol).any()
        near_tie = ((gaps > 0) & (gaps <= tol)).any() or (
            (lb[t] > 0) & (lb[t] <= tol)).any()
        if not borderline:
            assert int(counts[t]) == int(cj[t]), t
        if not (borderline or near_tie):
            np.testing.assert_array_equal(ids[t].numpy(), ij[t])
            compared += 1
    assert compared >= n_t // 2
    assert bool((counts >= 1).all())


# ---- B5 ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["surface_far", "incoherent", "smpl"])
def test_nn_1_clustered_matches_pallas_kernel(case, pallas_inputs):
    q, v = QUERY_SETS[case]()
    d2_j, idx_j = kp.nn_1_clustered_pallas(jnp.asarray(q), jnp.asarray(v),
                                           interpret=True)
    qt, vs_pad_t, cent_t, rad_t = pallas_inputs[-1]
    n = len(q)
    order = kc.morton_order(T(v))
    cl = _clusters_from(vs_pad_t, len(v), kc.C_SIZE, cent_t, rad_t)
    # the kernel on the Pallas kernel's own inputs
    d2_p, i_p, visits = kc.nn_1_clustered_plain(T(qt[:n]).contiguous(), cl)
    np.testing.assert_array_equal(order[i_p.long()].numpy(), np.asarray(idx_j))
    assert _ulps(d2_p.numpy(), d2_j).max() <= 2
    assert 0 < int(visits.sum()) <= n * len(v)
    # the public wrapper on the raw inputs: its own prep, CPU -> plain
    launches = dict(_cuda.LAUNCHES)
    d2_t, idx_t = kc.nn_1_clustered(T(q), T(v))
    assert _cuda.LAUNCHES == launches
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-4,
                               atol=1e-10)


def test_nn_1_clustered_ties_go_to_first_in_morton_order():
    rng = np.random.RandomState(3)
    v = (rng.randn(1100, 3) * 0.4).astype(np.float32)
    v[900] = v[17]                                   # an exact duplicate
    order = kc.morton_order(T(v)).numpy()
    pos = {int(o): i for i, o in enumerate(order)}
    first = 17 if pos[17] < pos[900] else 900
    _, idx = kc.nn_1_clustered(T(v[[17, 900]]), T(v))
    assert idx.tolist() == [first, first]


# ---- B6 ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["coherent", "incoherent", "smpl"])
def test_nn_1_shortlist_matches_pallas_kernel(case, pallas_inputs):
    q, v = QUERY_SETS[case]()
    d2_j, idx_j, over_j = kp.nn_1_shortlist_pallas(
        jnp.asarray(q), jnp.asarray(v), interpret=True)
    meta, qt, vs_pad_t = pallas_inputs[-1]
    n, C = len(q), vs_pad_t.shape[1] // kc.SL_CSIZE
    n_t = -(-n // kc.P_TILE)
    counts = T(meta[:n_t].astype(np.int32))
    ids = T(meta[n_t:].reshape(n_t, C).astype(np.int32))
    cl = _clusters_from(vs_pad_t, len(v), kc.SL_CSIZE)
    order = kc.morton_order(T(v))
    # the kernel on the Pallas kernel's own inputs and visit lists
    d2_p, i_p, visits = kc.nn_1_shortlist_plain(T(qt[:n]).contiguous(), cl,
                                                counts, ids)
    np.testing.assert_array_equal(order[i_p.long()].numpy(), np.asarray(idx_j))
    assert _ulps(d2_p.numpy(), d2_j).max() <= 2
    assert 0 < int(visits.sum()) <= n * len(v)
    # the public wrapper: d2 within rtol 1e-4, the index realises the f64
    # minimum, overflow 0
    d2_t, idx_t, over_t = kc.nn_1_shortlist(T(q), T(v), s_cap=4)
    assert int(over_t) == int(over_j) == 0
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-4,
                               atol=1e-10)
    q64, v64 = q.astype(np.float64), v.astype(np.float64)
    d64 = ((q64[:, None] - v64[None]) ** 2).sum(-1).min(1)
    d_at = ((q64 - v64[idx_t.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(d_at, d64, rtol=1e-5, atol=1e-7)


def _list_scan(q_c, cl, counts, ids):
    """B6 without the skip: every tile scans each listed cluster in list
    order, every query, strict '<' (the Pallas kernel's rule)."""
    n, cs, nv = q_c.shape[0], cl.csize, cl.vs.shape[0]
    d2 = torch.full((n,), float("inf"))
    idx = torch.zeros((n,), dtype=torch.int32)
    for t in range(ids.shape[0]):
        sl = slice(t * kc.P_TILE, min(n, (t + 1) * kc.P_TILE))
        for s in range(int(counts[t])):
            j0 = int(ids[t, s]) * cs
            m, j = kc._scan(q_c[sl], cl.vs[j0:min(j0 + cs, nv)])
            upd = m < d2[sl]
            d2[sl] = torch.where(upd, m, d2[sl])
            idx[sl] = torch.where(upd, (j + j0).to(torch.int32), idx[sl])
    return d2, idx


@pytest.mark.parametrize("park", ["body", "far_padding"])
def test_shortlist_skip_rule_keeps_the_list_scan_result(park):
    """The plain B6's per-group skip (a cluster none of the group's queries
    can lower or tie, by its f32 bound with the (1 - 1e-5) shrink) gives
    the d2 and idx of the unskipped list scan, on an SMPL-sized body and
    with the budgets' padding parked 1e6 m away (where f32 rounding of the
    bound is largest); the list holds more pairs than the result needs."""
    q, v = _smpl_body()
    if park == "far_padding":
        q[1300:] = np.float32([6e5, 8e5, 3.0])
    cl = kc.make_clusters(T(v), kc.SL_CSIZE, sorted_mean=False)
    q_c = (T(q) - cl.ctr0).contiguous()
    counts, ids, _, _ = kc.shortlist_tiles(q_c, cl)
    d2, idx, listed = kc.nn_1_shortlist_plain(q_c, cl, counts, ids)
    d2_r, idx_r = _list_scan(q_c, cl, counts, ids)
    assert torch.equal(idx, idx_r)
    assert torch.equal(d2.view(torch.int32), d2_r.view(torch.int32))
    assert kc.needed_pairs(q_c, cl, d2) < int(listed.sum())


def test_needed_pairs_matches_brute_force():
    """needed_pairs: each run of bit-identical queries once, the rows of
    every cluster whose f64 lower bound max(|q - c| - r, 0)^2 is <= the
    query's d2, against a loop over queries and clusters in numpy f64."""
    rng = np.random.RandomState(21)
    v = (rng.randn(700, 3) * 0.4).astype(np.float32)
    q = np.concatenate([v[rng.randint(0, 700, 300)] + rng.randn(300, 3) * 0.05,
                        rng.uniform(-1.5, 1.5, (100, 3))]).astype(np.float32)
    q[40:90] = q[40]                     # runs of identical queries
    q[200:260] = q[199]
    q[380:] = np.float32([1e6, 0.0, 0.0])
    cl = kc.make_clusters(T(v), 64, sorted_mean=True)
    q_c = (T(q) - cl.ctr0).contiguous()
    d2, _, _ = kc.nn_1_clustered_plain(q_c, cl)
    qn, dn = q_c.numpy().astype(np.float64), d2.numpy().astype(np.float64)
    cent, rad = cl.cent.numpy().astype(np.float64), cl.rad.numpy().astype(np.float64)
    rows = cl.rows.numpy()
    want, distinct = 0, 0
    for i in range(len(q)):
        if i and (q_c[i].numpy().view(np.int32) == q_c[i - 1].numpy().view(np.int32)).all():
            continue
        distinct += 1
        for c in range(len(cent)):
            lb = max(np.sqrt(((qn[i] - cent[c]) ** 2).sum()) - rad[c], 0.0) ** 2
            want += rows[c] if lb <= dn[i] else 0
    assert int(kc.run_starts(q_c).sum()) == distinct == 400 - 49 - 60 - 19
    assert kc.needed_pairs(q_c, cl, d2) == want
    # the nearest vertex's own cluster is always needed: at least one
    # cluster's rows per distinct query
    assert want >= distinct * int(rows.min())


# ---- B7 ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "smpl"])
def test_ray_body_mask_clustered_matches_pallas_kernel(kind, pallas_inputs):
    o, d, verts = _rays(kind)
    thr = 0.05 ** 2 if kind == "random" else THR
    near = np.full(len(o), 0.5, np.float32)
    m_j = np.asarray(kp.ray_body_mask_clustered_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
        jnp.asarray(near + 2.0), jnp.asarray(verts), thr, interpret=True))
    rows, vs_pad_t, cent_t, rad_t = pallas_inputs[-1]
    n = len(o)
    clear = np.abs(_line_min(o, d, verts) - thr) > 1e-6
    assert clear.mean() > 0.95 and 0 < m_j[clear].sum() < clear.sum()
    cl = _clusters_from(vs_pad_t, len(verts), kc.C_SIZE, cent_t, rad_t)
    m_p, visits = kc.ray_body_mask_clustered_plain(
        T(np.ascontiguousarray(rows[:n, 0:3])),
        T(np.ascontiguousarray(rows[:n, 3:6])), cl, thr)
    np.testing.assert_array_equal(m_p.numpy()[clear], m_j[clear])
    assert 0 < int(visits.sum()) < n * len(verts)
    m_t = kc.ray_body_mask_clustered(T(o), T(d), T(verts), thr)
    np.testing.assert_array_equal(m_t.numpy()[clear], m_j[clear])
    full = knn.ray_body_mask(T(o), T(d), T(verts), thr)
    np.testing.assert_array_equal(m_t.numpy()[clear], full.numpy()[clear])


def _borderline_rays(v64, origin, rng, n):
    """Rays from ``origin`` whose line passes at sqrt(THR) (f64, to 1e-8
    m^2) from its nearest vertex: 30 halvings between a direction through a
    vertex and one 1.5 m off it.  Rays still hitting at 1.5 m are dropped."""
    o = torch.tensor(origin, dtype=torch.float64).expand(n, 3)
    on = v64[torch.from_numpy(rng.randint(0, v64.shape[0], n))]
    off = torch.from_numpy(rng.randn(n, 3))
    off = on + off / off.norm(dim=1, keepdim=True) * 1.5

    def line_min(d):
        w = v64[None] - o[:, None]
        b = (w * d[:, None]).sum(-1)
        return ((w * w).sum(-1) - b * b / (d * d).sum(-1)[:, None]).amin(1)
    lo, hi = torch.zeros(n, dtype=torch.float64), torch.ones(n, dtype=torch.float64)
    for _ in range(30):
        mid = (lo + hi) / 2
        inside = line_min(on + mid[:, None] * (off - on) - o) < THR
        lo, hi = torch.where(inside, mid, lo), torch.where(inside, hi, mid)
    d = on + lo[:, None] * (off - on) - o
    ok = (line_min(d) - THR).abs() < 1e-8
    return o[ok].numpy(), d[ok].numpy()


@pytest.mark.parametrize("origins", ["shared", "spread"])
def test_ray_body_mask_clustered_skip_rule_keeps_every_hit(origins):
    """The plain B7 at its per-ray grain against an exhaustive scan of every
    row of the same Clusters with the same _line_terms operations, on an
    SMPL body: rays from one camera through and around the body, and rays
    whose line passes the body at the threshold (f32 minima within ~1e-6
    m^2 of it, on both sides); "spread" moves each origin along its own ray.
    The masks are equal (the skip rule dropped no hit), and each ray's
    visits are the rows of the clusters its bound admits, in ascending
    order, up to and including its first hit's cluster."""
    rng = np.random.RandomState(12)
    verts = np.array(j_synthetic_smpl(0).v_template, np.float32)
    cl = kc.make_clusters(T(verts), kc.C_SIZE, sorted_mean=True)
    cam = [[0.1, 0.2, -2.5]]
    n = 1500
    tgt = cl.vs.numpy()[rng.randint(0, len(verts), n)] + rng.randn(n, 3) * 0.1
    o_b, d_b = _borderline_rays(cl.vs.double(), cam, rng, 256)
    o = np.concatenate([np.repeat(cam, n, axis=0), o_b])
    d = np.concatenate([tgt - cam, d_b])
    if origins == "spread":
        o = o + d * rng.uniform(-0.3, 0.3, (len(o), 1))
    o_c, d_t = T(o.astype(np.float32)), T(d.astype(np.float32))
    hit, visits = kc.ray_body_mask_clustered_plain(o_c, d_t, cl, THR)

    thr = torch.tensor(THR, dtype=torch.float32)
    dd_inv, lb = kc.ray_cluster_bounds(o_c, d_t, cl)
    dist = kc._line_terms(o_c, d_t, dd_inv, cl.vs)
    assert torch.equal(hit, (dist < thr).any(dim=1))
    near = (dist.amin(dim=1) - thr).abs() < 1e-5
    assert int(near.sum()) >= 100 and 0 < int(hit[near].sum()) < int(near.sum())
    C, cs = cl.cent.shape[0], cl.csize
    pad = torch.nn.functional.pad(dist, (0, C * cs - dist.shape[1]),
                                  value=float("inf"))
    in_c = (pad.reshape(-1, C, cs) < thr).any(dim=2)              # (N, C)
    admitted = lb < thr
    first = torch.where((admitted & in_c).any(dim=1),
                        (admitted & in_c).int().argmax(dim=1), C)
    upto = torch.arange(C)[None] <= first[:, None]
    assert torch.equal(visits.long(), ((admitted & upto) * cl.rows).sum(dim=1))
    assert int(visits.sum()) < len(o) * len(verts) // 4


# ---- dispatch ----------------------------------------------------------------

def test_dispatch_follows_the_switches_and_the_vertex_count(monkeypatch):
    """CLUSTERED sends nn_1 of >= 8 * C_SIZE = 1024 vertices to B5, and
    nn_1_diag with s_cap > 0 to B6; below 1024 vertices both take the full
    scan, with overflow 0."""
    calls = []
    for mod, name in ((kc, "nn_1_clustered_plain"), (kc, "nn_1_shortlist_plain"),
                      (knn, "nn_1_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    monkeypatch.setattr(kc, "CLUSTERED", True)
    rng = np.random.RandomState(0)
    q = T(rng.randn(300, 3).astype(np.float32))
    for nv, b5, b6 in ((1024, "nn_1_clustered_plain", "nn_1_shortlist_plain"),
                       (1023, "nn_1_plain", "nn_1_plain")):
        v = T(rng.randn(nv, 3).astype(np.float32))
        d_full, _ = knn.nn_1_plain(q - v.mean(0), v - v.mean(0))
        calls.clear()
        d2, _ = knn.nn_1(q, v)
        d2s, _, over = knn.nn_1_diag(q, v, s_cap=8)
        _, _, pay, over2 = knn.nn_1_tables_diag(q, v, v, s_cap=8)
        assert calls == [b5, b6, b6], (nv, calls)
        assert int(over) == int(over2) == 0
        np.testing.assert_allclose(d2.numpy(), d_full.numpy(), rtol=1e-4)
        np.testing.assert_allclose(d2s.numpy(), d_full.numpy(), rtol=1e-4)
    # switched off, or s_cap 0: the full scan
    monkeypatch.setattr(kc, "CLUSTERED", False)
    calls.clear()
    knn.nn_1(q, v)
    knn.nn_1_diag(q, T(rng.randn(2000, 3).astype(np.float32)), s_cap=0)
    assert calls == ["nn_1_plain", "nn_1_plain"]


# ---- the generator with both switches on ------------------------------------

def test_generator_with_cluster_switches_matches_jax(scene, monkeypatch):
    """Budgeted mode, CLUSTERED and knn_shortlist = 8 in both packages, on
    the scene and weights of tests/test_torch_e2e.py: >= 45 dB against JAX
    (whose CPU backend takes its full-scan fallback: the port's plain
    versions are exact, so both compute the same function), every overflow
    counter 0, knn_shortlist_overflow recorded; the port's prune goes through
    B7 once and its two KNNs through B6 per batch item."""
    monkeypatch.setattr(kp, "CLUSTERED", True)
    monkeypatch.setattr(kc, "CLUSTERED", True)
    calls = {}
    for mod, name in ((kc, "nn_1_shortlist_plain"),
                      (kc, "ray_body_mask_clustered_plain"),
                      (kc, "nn_1_clustered_plain"), (knn, "nn_1_plain"),
                      (knn, "ray_body_mask_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _r(*a))[1])
    fitted, _ = j_calibrate([scene["jb"]], scene["jcfg"], margin=1.15,
                            round_to=128)
    tcfg = ModelConfig(**MODEL_KW, render=RenderConfig(depth_resolution=D,
                                                      density_noise=0.0))
    t_fitted, _ = calibrate_budgets([scene["tb"]], tcfg, margin=1.15,
                                    round_to=128)
    assert dataclasses.asdict(t_fitted) == dataclasses.asdict(fitted)
    jcfg = dataclasses.replace(scene["jcfg"], render=dataclasses.replace(
        fitted, knn_shortlist=8))
    tcfg = dataclasses.replace(tcfg, render=dataclasses.replace(
        t_fitted, knn_shortlist=8))
    jm = JGenerator(jcfg, out_sh=scene["out_sh"])
    jo, mv = jax.jit(lambda v, b: jm.apply(v, b, scene["js"],
                                           mutable=["diag"]))(scene["v"],
                                                              scene["jb"])
    jo = jax.device_get(jo)
    j_rep = j_overflow_report(jax.device_get(mv["diag"]))
    tm = SHERFGenerator(tcfg, out_sh=scene["out_sh"], device="cpu")
    tm.load_state_dict(from_flax(scene["v"]), strict=True)
    calls.clear()
    with torch.no_grad():
        to, diag = tm.eval()(scene["tb"], scene["ts"])
    B = scene["tb"].ray_o.shape[0]
    assert calls == {"nn_1_shortlist_plain": 2 * B,
                     "ray_body_mask_clustered_plain": B}, calls
    rep = overflow_report(diag)
    assert set(rep) == set(j_rep) and "knn_shortlist_overflow" in rep
    assert all(v == 0 for v in rep.values()) and all(
        v == 0 for v in j_rep.values())
    assert to["weights_image"].numpy().max() > 0.5
    assert _psnr(to["image_raw"].numpy(), jo["image_raw"]) >= 45.0


# ---- overflow counters of the sparse-conv stages ----------------------------

def test_sparse_stage_overflows_sum_like_jax():
    """Tight caps make two downsampling stages overflow at once: the total
    sums them (as JAX's overflow_total does) and the report keeps the max
    per leaf name (as JAX's overflow_report does), on the same volume and
    weights."""
    shape, caps = (24, 40, 36), (400, 160, 128)
    rng = np.random.RandomState(12)
    c = np.stack([rng.randint(2, s - 2, 600) for s in shape], -1).astype(np.int32)
    f = rng.randn(600, 32).astype(np.float32)
    q = (rng.rand(64, 3) * (np.asarray(shape) - 1)).astype(np.float32)
    jm = j_sc.SparseConvNet(num_layers=4, out_sh=shape, caps=caps)
    args = (jnp.asarray(f), jnp.asarray(c), jnp.asarray(q))
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(5), *a))(*args)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    _, mv = jax.jit(lambda v, *a: jm.apply(v, *a, mutable=["diag"]))(v, *args)
    j_diag = jax.device_get(mv["diag"])
    tm = t_sc.SparseConvNet(num_layers=4, out_sh=shape, caps=caps)
    tm.load_state_dict(from_flax(v), strict=True)
    diag = Diag()
    with torch.no_grad():
        tm.eval()(T(f), T(c), T(q), diag)
    assert sum(int(x) > 0 for x in diag.values()) >= 2, dict(diag)
    assert float(overflow_total(diag)) == float(j_overflow_total(j_diag))
    assert overflow_report(diag) == j_overflow_report(j_diag)
    assert float(overflow_total(diag)) > max(overflow_report(diag).values())
