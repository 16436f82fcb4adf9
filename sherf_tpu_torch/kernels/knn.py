"""Nearest-SMPL-vertex queries: ``nn_1`` (K=1 nearest vertex) and
``ray_body_mask`` (does a ray's line pass within a radius of any vertex).

Ports of the Pallas kernels ``nn_1_pallas`` and ``ray_body_mask_pallas``
(``sherf_tpu/kernels/knn_pallas.py:608, :554``).  Both follow the KERNEL's
math, not the JAX package's CPU fallback ``nn_1_ref``: inputs are centred on
the vertex centroid and squared distances are built elementwise in f32 —
never the |q|^2 - 2 q.v + |v|^2 expansion (and never ``torch.cdist`` in its
default mode, which switches to it at larger sizes).

Each wrapper takes the CUDA kernel (``csrc/knn.cu``) for a CUDA tensor and
its plain torch version (``*_plain``, same arithmetic, bit-equal) for a CPU
tensor.  The public wrappers run outside autograd: their outputs (indices,
masks, and distances that only feed comparisons) carry no gradient.

``nn_1`` and ``nn_1_diag`` are also the dispatch points of the clustered
kernels in ``knn_cluster.py``, as ``sherf_tpu/kernels/knn.py:50-98`` is:
with ``knn_cluster.CLUSTERED`` set, ``nn_1`` of at least 8 * C_SIZE vertices
takes ``nn_1_clustered``; ``nn_1_diag`` with ``s_cap > 0`` takes
``nn_1_shortlist`` at that size.  (The JAX package takes them on a TPU
only; here a CUDA tensor takes their kernels and a CPU tensor their exact
plain versions.)
"""

from __future__ import annotations

from typing import Optional

import torch

from sherf_tpu_torch.kernels import _cuda

RAY_TILE = 256      # rays per tile whose scan an all-inactive tile skips
PLAIN_CHUNK = 16384  # queries per step of the plain versions


def _centre(pts: torch.Tensor, verts: torch.Tensor):
    ctr = verts.mean(dim=0)
    return (pts - ctr).contiguous(), (verts - ctr).contiguous()


def _check_points(query, ref):
    if query.dim() != 2 or query.shape[1] != 3:
        raise ValueError(f"query: shape {tuple(query.shape)}, expected (N, 3)")
    if ref.dim() != 2 or ref.shape[1] != 3 or ref.shape[0] == 0:
        raise ValueError(f"ref: shape {tuple(ref.shape)}, expected (V>0, 3)")
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError("nearest-vertex queries take float32 tensors")
    if query.device != ref.device:
        raise ValueError(f"query on {query.device}, ref on {ref.device}")


# ---------------------------------------------------------------------------
# nn_1


def nn_1_plain(q_c: torch.Tensor, v_c: torch.Tensor):
    """Plain version on CENTRED inputs: (d2 (N,) f32, idx (N,) int32)."""
    d2s, idxs = [], []
    vx, vy, vz = (v_c[None, :, k] for k in range(3))
    for s in range(0, q_c.shape[0], PLAIN_CHUNK):
        q = q_c[s:s + PLAIN_CHUNK]
        dx = vx - q[:, 0:1]
        dy = vy - q[:, 1:2]
        dz = vz - q[:, 2:3]
        d2 = dx * dx + dy * dy
        d2 = d2 + dz * dz
        m, i = torch.min(d2, dim=1)   # first minimum: lowest index on ties
        d2s.append(m)
        idxs.append(i.to(torch.int32))
    if not d2s:
        return (q_c.new_zeros((0,)),
                torch.zeros((0,), dtype=torch.int32, device=q_c.device))
    return torch.cat(d2s), torch.cat(idxs)


def nn_1_cuda(q_c: torch.Tensor, v_c: torch.Tensor):
    """CUDA kernel on CENTRED inputs; counts its launch."""
    dev = q_c.device
    _cuda.require(q_c, "query", torch.float32, (None, 3), dev)
    _cuda.require(v_c, "ref", torch.float32, (None, 3), dev)
    n, nv = q_c.shape[0], v_c.shape[0]
    lib = _cuda.library()
    if nv > lib.sherf_knn_max_vertices():
        raise ValueError(f"nn_1: {nv} vertices exceed the shared-memory "
                         f"capacity ({lib.sherf_knn_max_vertices()})")
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        # the tile counter: per-call scratch that the entry point zeroes
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        _cuda.check(lib.sherf_nn1(q_c.data_ptr(), n, v_c.data_ptr(), nv,
                                  d2.data_ptr(), idx.data_ptr(),
                                  counter.data_ptr(), _cuda.stream_of(q_c)),
                    "nn_1")
        _cuda.LAUNCHES["nn_1"] += 1
    return d2, idx


@torch.no_grad()
def nn_1(query: torch.Tensor, ref: torch.Tensor):
    """query (N, 3), ref (V, 3) float32 -> (dist_sq (N,) f32, idx (N,) int32)
    of the nearest reference point; ties go to the lowest index (to the
    first in Morton order when the clustered kernel is switched on)."""
    _check_points(query, ref)
    from sherf_tpu_torch.kernels import knn_cluster as kc  # it imports knn
    if kc.CLUSTERED and ref.shape[0] >= 8 * kc.C_SIZE:
        return kc.nn_1_clustered(query, ref)
    q_c, v_c = _centre(query, ref)
    if query.is_cuda:
        return nn_1_cuda(q_c, v_c)
    return nn_1_plain(q_c, v_c)


def nn_1_tables(query: torch.Tensor, ref: torch.Tensor, tables: torch.Tensor):
    """:func:`nn_1` fused with a per-vertex payload lookup: returns
    (dist_sq (N,), idx (N,), tables[idx] (N, C))."""
    d2, idx = nn_1(query, ref)
    return d2, idx, tables[idx.long()]


def nn_1_diag(query: torch.Tensor, ref: torch.Tensor, s_cap: int = 0):
    """K=1 NN with a shortlist-overflow slot: (dist_sq, idx, overflow ()
    int32).  ``s_cap > 0`` with at least 8 * C_SIZE vertices takes the
    cluster-shortlist kernel, whose dynamic visit count never overflows;
    otherwise :func:`nn_1`.  The overflow is 0 either way; the renderer
    records it as ``knn_shortlist_overflow``, as the JAX package does."""
    from sherf_tpu_torch.kernels import knn_cluster as kc  # it imports knn
    if s_cap > 0 and ref.shape[0] >= 8 * kc.C_SIZE:
        return kc.nn_1_shortlist(query, ref, s_cap)
    d2, idx = nn_1(query, ref)
    return d2, idx, torch.zeros((), dtype=torch.int32, device=query.device)


def nn_1_tables_diag(query: torch.Tensor, ref: torch.Tensor,
                     tables: torch.Tensor, s_cap: int = 0):
    """:func:`nn_1_diag` fused with the payload lookup: (dist_sq, idx,
    tables[idx], overflow)."""
    d2, idx, ov = nn_1_diag(query, ref, s_cap)
    return d2, idx, tables[idx.long()], ov


# ---------------------------------------------------------------------------
# ray_body_mask


def ray_line_min_plain(o_c: torch.Tensor, d: torch.Tensor,
                       v_c: torch.Tensor) -> torch.Tensor:
    """(N,) f32: each ray's minimum over the vertices of the squared
    distance from its LINE, a - b*b/max(|d|^2, 1e-12) with w = v - o,
    a = |w|^2, b = d.w, on CENTRED origins/vertices."""
    vx, vy, vz = (v_c[None, :, k] for k in range(3))
    outs = []
    for s in range(0, o_c.shape[0], PLAIN_CHUNK):
        o, dr = o_c[s:s + PLAIN_CHUNK], d[s:s + PLAIN_CHUNK]
        dd = dr[:, 0:1] * dr[:, 0:1] + dr[:, 1:2] * dr[:, 1:2]
        dd = dd + dr[:, 2:3] * dr[:, 2:3]
        dd_inv = torch.reciprocal(torch.clamp(dd, min=1e-12))
        w0 = vx - o[:, 0:1]
        w1 = vy - o[:, 1:2]
        w2 = vz - o[:, 2:3]
        a = w0 * w0 + w1 * w1
        a = a + w2 * w2
        b = dr[:, 0:1] * w0 + dr[:, 1:2] * w1
        b = b + dr[:, 2:3] * w2
        outs.append((a - b * b * dd_inv).amin(dim=1))
    return (torch.cat(outs) if outs
            else torch.zeros((0,), dtype=torch.float32, device=o_c.device))


def ray_body_mask_plain(o_c: torch.Tensor, d: torch.Tensor, v_c: torch.Tensor,
                        threshold_sq: float,
                        active: Optional[torch.Tensor] = None):
    """Plain version on CENTRED origins/vertices: (N,) bool."""
    n = o_c.shape[0]
    thr = torch.tensor(threshold_sq, dtype=torch.float32, device=o_c.device)
    out = ray_line_min_plain(o_c, d, v_c) < thr
    if active is not None:
        # a tile of RAY_TILE rays with no active ray skips its scan: False
        pad = -n % RAY_TILE
        act = torch.nn.functional.pad(active.to(torch.bool), (0, pad))
        tile_any = act.reshape(-1, RAY_TILE).any(dim=1)
        out = out & tile_any.repeat_interleave(RAY_TILE)[:n]
    return out


def ray_body_mask_cuda(o_c, d, v_c, threshold_sq: float, active=None):
    """CUDA kernel on CENTRED inputs; counts its launch."""
    dev = o_c.device
    _cuda.require(o_c, "ray_o", torch.float32, (None, 3), dev)
    n = o_c.shape[0]
    _cuda.require(d, "ray_d", torch.float32, (n, 3), dev)
    _cuda.require(v_c, "verts", torch.float32, (None, 3), dev)
    nv = v_c.shape[0]
    if 3 * n >= 2 ** 31:
        raise ValueError("ray_body_mask: 3 * n must fit an int32 offset")
    lib = _cuda.library()
    if nv > lib.sherf_knn_max_vertices():
        raise ValueError(f"ray_body_mask: {nv} vertices exceed the "
                         f"shared-memory capacity")
    act_ptr = None
    if active is not None:
        _cuda.require(active, "active", torch.bool, (n,), dev)
        act_ptr = active.data_ptr()
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        _cuda.check(lib.sherf_ray_body_mask(
            o_c.data_ptr(), d.data_ptr(), act_ptr, n, v_c.data_ptr(), nv,
            float(threshold_sq), out.data_ptr(), counter.data_ptr(),
            _cuda.stream_of(o_c)), "ray_body_mask")
        _cuda.LAUNCHES["ray_body_mask"] += 1
    return out


def ray_body_mask_attrs() -> dict:
    """The CUDA kernel as built for the current device: registers and
    spilled (local) bytes a thread."""
    return _cuda.kernel_attrs("sherf_ray_body_mask_attrs")


@torch.no_grad()
def ray_body_mask(ray_o: torch.Tensor, ray_d: torch.Tensor,
                  verts: torch.Tensor, threshold_sq: float,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) bool: does the LINE of ray (o, d) pass within sqrt(threshold_sq)
    of any vertex?  min over the line <= min over the segment <= min over
    its samples, so False means every sample of the ray fails the exact
    prune test.  ``active`` (N,) bool: a tile of 256 rays with no active ray
    returns False without a scan (the caller ANDs with the same mask)."""
    _check_points(ray_o, verts)
    if ray_d.shape != ray_o.shape or ray_d.dtype != torch.float32:
        raise ValueError("ray_d must match ray_o (N, 3) float32")
    o_c, v_c = _centre(ray_o, verts)
    d = ray_d.contiguous()
    if ray_o.is_cuda:
        act = None if active is None else active.to(torch.bool).contiguous()
        return ray_body_mask_cuda(o_c, d, v_c, threshold_sq, act)
    return ray_body_mask_plain(o_c, d, v_c, threshold_sq, active)
