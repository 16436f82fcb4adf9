"""Morton-clustered nearest-vertex kernels: ``nn_1_clustered``,
``nn_1_shortlist`` and ``ray_body_mask_clustered``.

Ports of the Pallas kernels ``nn_1_clustered_pallas`` (B5),
``nn_1_shortlist_pallas`` (B6) and ``ray_body_mask_clustered_pallas`` (B7)
(``sherf_tpu/kernels/knn_pallas.py:207, :318, :501``).  Each computes the
contract of a full scan in ``knn.py`` (``nn_1`` or ``ray_body_mask``) but
visits only the clusters of vertices that a bound says may matter:

  * the vertices are sorted along a Morton curve of their current positions
    (:func:`morton_order`) and cut into clusters of consecutive rows (128,
    or 256 for the shortlist), each with a centroid and an inflated radius
    (:func:`cluster_stats`);
  * B5: a query starts from ``best = min_c (d_c + r_c)^2 (1 + 1e-5) +
    1e-12`` and visits cluster c, in ascending order, when
    ``max(d_c - r_c, 0)^2 <= best``;
  * B6: per tile of 512 queries, a bounding sphere gives each cluster a
    lower bound ``lb_r`` and the tile an upper bound ``ub_r``; the tile
    visits the ``counts[t]`` clusters with ``lb_r <= ub_r`` in ascending
    ``lb_r`` order (a stable sort);
  * B7: a ray visits cluster c while it has not hit and
    ``max(sqrt(dl2) (1 - 1e-5) - r_c, 0)^2 < thr``, dl2 the squared
    distance from its line to the centroid.

Inside a visited cluster the distances are the full scan's exact
elementwise f32 ones.  The Pallas kernels take the visit decision for a
whole tile of 512 (256) queries; the CUDA kernels (``csrc/knn_cluster.cu``)
take it for a warp of 32 with ``__any_sync``.  A visit can only lower a
running minimum (or set a hit) where the bound says it may, so the grain
changes the work and not the result.  Ties go to the first vertex in visit
order: Morton order for B5, the tile's lb-sorted order for B6 — not the
lowest original index of the full scan.

The vertices are centred on their mean: of the SORTED array for B5 and B7
(``knn_pallas.py:222-223, :514-515``), of the unsorted one for B6
(``:343-348``).  Padding rows never enter a scan or a radius.

Each ``*_plain`` function applies the same visit rule as its kernel, at the
same warp grain, with the same f32 operations, so kernel and plain version
are bit-equal on the inputs the wrapper prepares.  The plain versions also
return, per query, how many (query, vertex) pairs its own bound test
admitted (B5, B7) or its tile visited (B6): the work the bound
counts.  CPU tensors take the plain versions; CUDA tensors take the
kernels, and nothing falls back.

The switches read the JAX package's environment names, so one setting
means the same in both packages: ``SHERF_KNN_CLUSTER`` (``CLUSTERED``),
``SHERF_KNN_CSIZE`` (``C_SIZE``), ``SHERF_KNN_SL_CSIZE`` (``SL_CSIZE``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from sherf_tpu_torch.kernels import _cuda
from sherf_tpu_torch.kernels.knn import _check_points

SENTINEL = 1e6          # centroid of an all-padding cluster
C_SIZE = int(os.environ.get("SHERF_KNN_CSIZE", "128"))
CLUSTERED = os.environ.get("SHERF_KNN_CLUSTER", "0") != "0"
SL_CSIZE = int(os.environ.get("SHERF_KNN_SL_CSIZE", "256"))
P_TILE = 512            # queries per shortlist tile (one CUDA block)
WARP = 32               # grain of the B5 / B7 visit decision (the Pallas
                        # kernels decide per tile of 512 / RSEG_P = 256)
PLAIN_CHUNK = 65536     # queries per step of the plain versions


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _sq3(x, y, z):
    """((x*x + y*y) + z*z), each operation rounded, as the kernels do."""
    return (x * x + y * y) + z * z


# ---------------------------------------------------------------------------
# cluster prep (plain torch on the tensors' device, no host sync)


def _morton_spread(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x (int64) so they occupy every 3rd bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(verts: torch.Tensor) -> torch.Tensor:
    """(V,) int64 permutation sorting the vertices along a Morton curve of
    their current positions (``knn_pallas.py:87``); stable on equal codes."""
    v = verts.float()
    lo = v.amin(dim=0)
    hi = v.amax(dim=0)
    g = torch.clamp((v - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0,
                    0.0, 1023.0).to(torch.int64)
    code = ((_morton_spread(g[:, 0]) << 2) | (_morton_spread(g[:, 1]) << 1)
            | _morton_spread(g[:, 2]))
    return torch.argsort(code, stable=True)


def cluster_stats(vs_pad: torch.Tensor, n_real: int, csize: int):
    """Per-cluster centroid (C, 3) and radius (C,) over consecutive
    ``csize`` rows of ``vs_pad`` (rows >= n_real are padding and ignored).
    The radius is inflated, ``sqrt(r2) (1 + 1e-5) + 1e-6``, so that bounds
    built from it in f32 stay conservative; an all-padding cluster's
    centroid sits on SENTINEL (``knn_pallas.py:104-120``)."""
    C = vs_pad.shape[0] // csize
    grp = vs_pad.reshape(C, csize, 3)
    mask = (torch.arange(C * csize, device=vs_pad.device)
            .reshape(C, csize) < n_real)
    n_in = mask.sum(dim=1)
    ctr = (torch.where(mask[..., None], grp, torch.zeros_like(grp)).sum(dim=1)
           / torch.clamp(n_in, min=1)[:, None])
    diff = grp - ctr[:, None]
    r2 = torch.where(mask, _sq3(diff[..., 0], diff[..., 1], diff[..., 2]),
                     torch.zeros_like(diff[..., 0])).amax(dim=1)
    rad = torch.sqrt(r2) * _f32(1.0 + 1e-5, r2) + _f32(1e-6, r2)
    ctr = torch.where((n_in == 0)[:, None], torch.full_like(ctr, SENTINEL), ctr)
    return ctr, rad


@dataclass
class Clusters:
    """A vertex set sorted into clusters: ``vs`` (V, 3) the sorted centred
    vertices (real rows only), ``cent`` (C, 3) and ``rad`` (C,) the cluster
    bounds, ``order`` (V,) sorted row -> original vertex id, ``ctr0`` (3,)
    the centre subtracted, ``csize`` rows per cluster."""
    vs: torch.Tensor
    cent: torch.Tensor
    rad: torch.Tensor
    order: torch.Tensor
    ctr0: torch.Tensor
    csize: int

    @property
    def rows(self) -> torch.Tensor:
        """(C,) int64 real rows of each cluster."""
        nv, C = self.vs.shape[0], self.cent.shape[0]
        start = torch.arange(C, device=self.vs.device) * self.csize
        return torch.clamp(nv - start, max=self.csize)

    def padded(self) -> torch.Tensor:
        """(C * csize, 3) vertices with SENTINEL padding rows."""
        return _pad_rows(self.vs, self.csize)


def _pad_rows(vs: torch.Tensor, csize: int) -> torch.Tensor:
    return torch.cat([vs, vs.new_full((-vs.shape[0] % csize, 3), SENTINEL)])


def make_clusters(ref: torch.Tensor, csize: int, sorted_mean: bool) -> Clusters:
    """Morton-sort ``ref``, centre it (on the mean of the sorted array when
    ``sorted_mean``, else of ``ref`` as given) and cut it into clusters."""
    order = morton_order(ref)
    vs = ref.float()[order]
    ctr0 = vs.mean(dim=0) if sorted_mean else ref.float().mean(dim=0)
    vs = (vs - ctr0).contiguous()
    cent, rad = cluster_stats(_pad_rows(vs, csize), vs.shape[0], csize)
    return Clusters(vs, cent.contiguous(), rad.contiguous(), order, ctr0, csize)


def _group_any(flag: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N,) bool: True where any entry of its warp of WARP
    consecutive entries is True (entries past N vote False)."""
    n = flag.shape[0]
    f = torch.nn.functional.pad(flag, (0, -n % WARP))
    return f.reshape(-1, WARP).any(dim=1).repeat_interleave(WARP)[:n]


def _scan(q: torch.Tensor, v: torch.Tensor):
    """Exact elementwise d2 of q (n, 3) against v (m, 3): (min (n,),
    first argmin (n,))."""
    d2 = _sq3(v[None, :, 0] - q[:, 0:1], v[None, :, 1] - q[:, 1:2],
              v[None, :, 2] - q[:, 2:3])
    return torch.min(d2, dim=1)


# ---------------------------------------------------------------------------
# B5: nn_1_clustered


def _centroid_dist(q: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(n, C) f32 distance from each query to each centroid."""
    return torch.sqrt(_sq3(q[:, 0:1] - cent[None, :, 0],
                           q[:, 1:2] - cent[None, :, 1],
                           q[:, 2:3] - cent[None, :, 2]))


def nn_1_clustered_plain(q_c: torch.Tensor, cl: Clusters):
    """Plain version on CENTRED queries: (d2 (N,) f32, idx (N,) int32 in
    the SORTED numbering, visits (N,) int32 vertices admitted by each
    query's own bound test)."""
    n, C = q_c.shape[0], cl.cent.shape[0]
    rows = cl.rows
    best = q_c.new_empty((n,))
    best_i = torch.zeros((n,), dtype=torch.int32, device=q_c.device)
    visits = torch.zeros((n,), dtype=torch.int32, device=q_c.device)
    chunk = PLAIN_CHUNK // WARP * WARP     # whole warps per step
    for s in range(0, n, chunk):
        q = q_c[s:s + chunk]
        dc = _centroid_dist(q, cl.cent)
        ub = ((dc + cl.rad) * (dc + cl.rad)).amin(dim=1)
        b = ub * _f32(1.0 + 1e-5, q) + _f32(1e-12, q)
        bi = torch.zeros_like(best_i[s:s + chunk])
        vis = torch.zeros_like(bi)
        for c in range(C):
            m = torch.clamp(dc[:, c] - cl.rad[c], min=0.0)
            want = m * m <= b
            vis += torch.where(want, rows[c], 0).to(torch.int32)
            sel = torch.nonzero(_group_any(want)).flatten()
            if sel.numel() == 0:
                continue
            j0 = c * cl.csize
            d2, j = _scan(q[sel], cl.vs[j0:j0 + cl.csize])
            upd = d2 < b[sel]
            b[sel] = torch.where(upd, d2, b[sel])
            bi[sel] = torch.where(upd, (j + j0).to(torch.int32), bi[sel])
        best[s:s + chunk], best_i[s:s + chunk], visits[s:s + chunk] = b, bi, vis
    return best, best_i, visits


def nn_1_clustered_cuda(q_c: torch.Tensor, cl: Clusters):
    """CUDA kernel on CENTRED queries -> (d2, idx in the SORTED numbering);
    counts its launch."""
    dev = q_c.device
    _cuda.require(q_c, "query", torch.float32, (None, 3), dev)
    _require_clusters(cl, dev)
    n, nv, nc = q_c.shape[0], cl.vs.shape[0], cl.cent.shape[0]
    lib = _cuda.library()
    if nv + nc > lib.sherf_knn_max_vertices():
        raise ValueError(f"nn_1_clustered: {nv} vertices and {nc} clusters "
                         f"exceed the shared-memory capacity")
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _cuda.check(lib.sherf_nn1_clustered(
            q_c.data_ptr(), n, cl.vs.data_ptr(), nv, cl.cent.data_ptr(),
            cl.rad.data_ptr(), nc, cl.csize, d2.data_ptr(), idx.data_ptr(),
            _cuda.stream_of(q_c)), "nn_1_clustered")
        _cuda.LAUNCHES["nn_1_clustered"] += 1
    return d2, idx


def _require_clusters(cl: Clusters, dev) -> None:
    _cuda.require(cl.vs, "vertices", torch.float32, (None, 3), dev)
    nc = cl.cent.shape[0]
    _cuda.require(cl.cent, "centroids", torch.float32, (nc, 3), dev)
    _cuda.require(cl.rad, "radii", torch.float32, (nc,), dev)
    if nc * cl.csize < cl.vs.shape[0]:
        raise ValueError(f"{nc} clusters of {cl.csize} cannot hold "
                         f"{cl.vs.shape[0]} vertices")


@torch.no_grad()
def nn_1_clustered(query: torch.Tensor, ref: torch.Tensor):
    """query (N, 3), ref (V, 3) float32 -> (dist_sq (N,) f32, idx (N,)
    int32 in the ORIGINAL numbering) of the nearest reference point, by
    Morton clusters of C_SIZE and branch and bound; ties go to the first
    vertex in Morton order."""
    _check_points(query, ref)
    cl = make_clusters(ref, C_SIZE, sorted_mean=True)
    q_c = (query - cl.ctr0).contiguous()
    if query.is_cuda:
        d2, idx = nn_1_clustered_cuda(q_c, cl)
    else:
        d2, idx, _ = nn_1_clustered_plain(q_c, cl)
    return d2, cl.order[idx.long()].to(torch.int32)


# ---------------------------------------------------------------------------
# B6: nn_1_shortlist


def shortlist_tiles(q_c: torch.Tensor, cl: Clusters):
    """Per tile of P_TILE centred queries (the last one padded with zero
    rows, as the Pallas wrapper pads): (counts (T,) int32, ids (T, C) int32
    cluster ids in ascending lb_r order, lb_r (T, C), ub_r (T,))
    (``knn_pallas.py:359-372``)."""
    n = q_c.shape[0]
    qt = torch.nn.functional.pad(q_c, (0, 0, 0, -n % P_TILE))
    q3 = qt.reshape(-1, P_TILE, 3)
    c_t = 0.5 * (q3.amin(dim=1) + q3.amax(dim=1))                # (T, 3)
    e = q3 - c_t[:, None]
    r_t = (torch.sqrt(_sq3(e[..., 0], e[..., 1], e[..., 2]).amax(dim=1))
           * _f32(1.0 + 1e-5, q_c) + _f32(1e-6, q_c))
    f = c_t[:, None] - cl.cent[None]
    dct = torch.sqrt(_sq3(f[..., 0], f[..., 1], f[..., 2]))     # (T, C)
    ub_r = (((dct + cl.rad[None]).amin(dim=1) + r_t) * _f32(1.0 + 1e-5, q_c)
            + _f32(1e-6, q_c))
    lb_r = (torch.clamp(dct - cl.rad[None] - r_t[:, None], min=0.0)
            * _f32(1.0 - 1e-5, q_c))
    counts = (lb_r <= ub_r[:, None]).sum(dim=1).to(torch.int32)
    ids = torch.argsort(lb_r, dim=1, stable=True).to(torch.int32)
    return counts, ids.contiguous(), lb_r, ub_r


def nn_1_shortlist_plain(q_c: torch.Tensor, cl: Clusters,
                         counts: torch.Tensor, ids: torch.Tensor):
    """Plain version on CENTRED queries: (d2 (N,) f32, idx (N,) int32 in
    the SORTED numbering, visits (N,) int32 vertices its tile visited)."""
    n = q_c.shape[0]
    T, C, cs = ids.shape[0], ids.shape[1], cl.csize
    q3 = torch.nn.functional.pad(q_c, (0, 0, 0, T * P_TILE - n)).reshape(
        T, P_TILE, 3)
    vs_pad = cl.padded().reshape(C, cs, 3)
    real = cl.rows[:, None] > torch.arange(cs, device=q_c.device)    # (C, cs)
    best = torch.full((T, P_TILE), float("inf"), device=q_c.device)
    best_i = torch.zeros((T, P_TILE), dtype=torch.int32, device=q_c.device)
    visits = torch.zeros((T,), dtype=torch.int64, device=q_c.device)
    step = max(1, PLAIN_CHUNK * 256 // (P_TILE * cs))    # tiles per step
    for s in range(C):
        for t0 in range(0, T, step):
            t = t0 + torch.nonzero(counts[t0:t0 + step] > s).flatten()
            if t.numel() == 0:
                continue
            cid = ids[t, s].long()
            v = vs_pad[cid]                                        # (t, cs, 3)
            q = q3[t]
            d2 = _sq3(v[:, None, :, 0] - q[..., 0:1], v[:, None, :, 1]
                      - q[..., 1:2], v[:, None, :, 2] - q[..., 2:3])
            d2 = torch.where(real[cid][:, None], d2,
                             torch.full_like(d2, float("inf")))
            m, j = torch.min(d2, dim=2)
            upd = m < best[t]
            best[t] = torch.where(upd, m, best[t])
            best_i[t] = torch.where(upd, (j + cid[:, None] * cs).to(torch.int32),
                                    best_i[t])
            visits[t] += cl.rows[cid]
    per_q = visits.repeat_interleave(P_TILE)[:n].to(torch.int32)
    return best.reshape(-1)[:n], best_i.reshape(-1)[:n], per_q


def nn_1_shortlist_cuda(q_c: torch.Tensor, cl: Clusters, counts: torch.Tensor,
                        ids: torch.Tensor):
    """CUDA kernel on CENTRED queries -> (d2, idx in the SORTED numbering);
    one block per tile reads its visit count and ids from device memory.
    Counts its launch."""
    dev = q_c.device
    _cuda.require(q_c, "query", torch.float32, (None, 3), dev)
    _require_clusters(cl, dev)
    n, nv, nc = q_c.shape[0], cl.vs.shape[0], cl.cent.shape[0]
    T = -(-n // P_TILE)
    _cuda.require(counts, "counts", torch.int32, (T,), dev)
    _cuda.require(ids, "ids", torch.int32, (T, nc), dev)
    lib = _cuda.library()
    if cl.csize > lib.sherf_knn_max_vertices():
        raise ValueError(f"nn_1_shortlist: clusters of {cl.csize} exceed the "
                         f"shared-memory capacity")
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _cuda.check(lib.sherf_nn1_shortlist(
            q_c.data_ptr(), n, cl.vs.data_ptr(), nv, counts.data_ptr(),
            ids.data_ptr(), nc, cl.csize, P_TILE, d2.data_ptr(),
            idx.data_ptr(), _cuda.stream_of(q_c)), "nn_1_shortlist")
        _cuda.LAUNCHES["nn_1_shortlist"] += 1
    return d2, idx


@torch.no_grad()
def nn_1_shortlist(query: torch.Tensor, ref: torch.Tensor, s_cap: int = 0):
    """query (N, 3), ref (V, 3) float32 -> (dist_sq (N,) f32, idx (N,) int32
    in the ORIGINAL numbering, overflow () int32) by per-tile cluster
    shortlists of SL_CSIZE.  The visit count per tile is dynamic, so the
    shortlist cannot overflow: ``s_cap`` is ignored and the overflow is 0,
    as in the Pallas kernel.  Ties go to the first vertex in the tile's
    visit order."""
    del s_cap
    _check_points(query, ref)
    cl = make_clusters(ref, SL_CSIZE, sorted_mean=False)
    q_c = (query - cl.ctr0).contiguous()
    counts, ids, _, _ = shortlist_tiles(q_c, cl)
    if query.is_cuda:
        d2, idx = nn_1_shortlist_cuda(q_c, cl, counts, ids)
    else:
        d2, idx, _ = nn_1_shortlist_plain(q_c, cl, counts, ids)
    return (d2, cl.order[idx.long()].to(torch.int32),
            torch.zeros((), dtype=torch.int32, device=query.device))


# ---------------------------------------------------------------------------
# B7: ray_body_mask_clustered


def _line_terms(o: torch.Tensor, d: torch.Tensor, dd_inv: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distance a - b*b/|d|^2 from each ray's line (o, d) to
    each point of v (m, 3), with w = v - o, a = |w|^2, b = d.w."""
    w0 = v[None, :, 0] - o[:, 0:1]
    w1 = v[None, :, 1] - o[:, 1:2]
    w2 = v[None, :, 2] - o[:, 2:3]
    a = _sq3(w0, w1, w2)
    b = (d[:, 0:1] * w0 + d[:, 1:2] * w1) + d[:, 2:3] * w2
    return a - b * b * dd_inv


def ray_body_mask_clustered_plain(o_c: torch.Tensor, d: torch.Tensor,
                                  cl: Clusters, threshold_sq: float):
    """Plain version on CENTRED origins: (hit (N,) bool, visits (N,) int32
    vertices admitted by each ray's own bound test)."""
    n, C = o_c.shape[0], cl.cent.shape[0]
    thr = _f32(threshold_sq, o_c)
    rows = cl.rows
    hit = torch.zeros((n,), dtype=torch.bool, device=o_c.device)
    visits = torch.zeros((n,), dtype=torch.int32, device=o_c.device)
    chunk = PLAIN_CHUNK // WARP * WARP
    for s in range(0, n, chunk):
        o, dr = o_c[s:s + chunk], d[s:s + chunk]
        dd_inv = torch.reciprocal(torch.clamp(
            _sq3(dr[:, 0:1], dr[:, 1:2], dr[:, 2:3]), min=1e-12))
        dl2 = torch.clamp(_line_terms(o, dr, dd_inv, cl.cent), min=0.0)
        m = torch.clamp(torch.sqrt(dl2) * _f32(1.0 - 1e-5, o) - cl.rad[None],
                        min=0.0)
        lb = m * m                                                  # (n, C)
        h = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
        vis = torch.zeros_like(visits[s:s + chunk])
        for c in range(C):
            want = ~h & (lb[:, c] < thr)
            vis += torch.where(want, rows[c], 0).to(torch.int32)
            sel = torch.nonzero(_group_any(want)).flatten()
            if sel.numel() == 0:
                continue
            j0 = c * cl.csize
            dist = _line_terms(o[sel], dr[sel], dd_inv[sel],
                               cl.vs[j0:j0 + cl.csize])
            h[sel] = h[sel] | (dist.amin(dim=1) < thr)
        hit[s:s + chunk], visits[s:s + chunk] = h, vis
    return hit, visits


def ray_body_mask_clustered_cuda(o_c: torch.Tensor, d: torch.Tensor,
                                 cl: Clusters, threshold_sq: float):
    """CUDA kernel on CENTRED origins -> (N,) bool; counts its launch."""
    dev = o_c.device
    _cuda.require(o_c, "ray_o", torch.float32, (None, 3), dev)
    n = o_c.shape[0]
    _cuda.require(d, "ray_d", torch.float32, (n, 3), dev)
    _require_clusters(cl, dev)
    nv, nc = cl.vs.shape[0], cl.cent.shape[0]
    lib = _cuda.library()
    if nv + nc > lib.sherf_knn_max_vertices():
        raise ValueError(f"ray_body_mask_clustered: {nv} vertices and {nc} "
                         f"clusters exceed the shared-memory capacity")
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _cuda.check(lib.sherf_ray_body_mask_clustered(
            o_c.data_ptr(), d.data_ptr(), n, cl.vs.data_ptr(), nv,
            cl.cent.data_ptr(), cl.rad.data_ptr(), nc, cl.csize,
            float(threshold_sq), out.data_ptr(), _cuda.stream_of(o_c)),
            "ray_body_mask_clustered")
        _cuda.LAUNCHES["ray_body_mask_clustered"] += 1
    return out


@torch.no_grad()
def ray_body_mask_clustered(ray_o: torch.Tensor, ray_d: torch.Tensor,
                            verts: torch.Tensor,
                            threshold_sq: float) -> torch.Tensor:
    """(N,) bool: does the LINE of ray (o, d) pass within sqrt(threshold_sq)
    of any vertex?  ``ray_body_mask``'s contract, by Morton clusters of
    C_SIZE; it has no ``active`` tile skip."""
    _check_points(ray_o, verts)
    if ray_d.shape != ray_o.shape or ray_d.dtype != torch.float32:
        raise ValueError("ray_d must match ray_o (N, 3) float32")
    cl = make_clusters(verts, C_SIZE, sorted_mean=True)
    o_c = (ray_o - cl.ctr0).contiguous()
    d = ray_d.contiguous()
    if ray_o.is_cuda:
        return ray_body_mask_clustered_cuda(o_c, d, cl, threshold_sq)
    return ray_body_mask_clustered_plain(o_c, d, cl, threshold_sq)[0]
