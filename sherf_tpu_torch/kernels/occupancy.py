"""Conservative body-proximity prune via a bounded Euclidean distance field
(torch counterpart of ``sherf_tpu/kernels/occupancy.py``; plain torch).

A (G, G, G) int16 grid holds the squared distance, in cell units, from each
cell to the nearest vertex-occupied cell (a separable squared EDT truncated
at the window the threshold needs); a sample passes when its cell is within
the ball.  The accepted region is a strict superset of the exact "within
radius of a vertex" test, which the renderer re-applies on the survivors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRID_SIZE = 224          # static cells per axis (2.8 m cube at CELL)
CELL = 0.0125            # meters
INT16_W2_MAX = 300       # largest supported window^2 (int16 headroom)
_INF = 30000             # unreachable-cell sentinel


def _ball_threshold_cells_sq(radius: float, cell: float) -> int:
    """Largest int T2 such that accepting d2_cells <= T2 is a strict superset
    of the exact test (both endpoints anywhere in their cells)."""
    t = radius / cell + math.sqrt(3.0)
    return int(math.floor(t * t + 1e-9))


def edt_window_cells(radius: float, cell: float = CELL) -> int:
    """EDT window half-width (cells) the ball test needs for ``radius``."""
    return int(math.ceil(math.sqrt(_ball_threshold_cells_sq(radius, cell))))


def distance_grid(verts: torch.Tensor, lo: torch.Tensor, w: int,
                  cell: float = CELL, grid_size: int = GRID_SIZE):
    """(G, G, G) int16: squared cell distance to the nearest occupied cell,
    exact up to w*w.  Pass k: d2 <- min over |off| <= w of d2 shifted by off
    along axis k, plus off^2."""
    if w * w > INT16_W2_MAX:
        raise ValueError(
            f"EDT window w={w} (w*w={w * w}) exceeds the int16 headroom "
            f"{INT16_W2_MAX}: the prune radius + step margin is too large for "
            f"this grid")
    G = grid_size
    vidx = torch.floor((verts - lo) / cell).to(torch.int64)
    ok = ((vidx >= 0) & (vidx < G)).all(dim=-1)
    flat = (vidx[:, 0] * G + vidx[:, 1]) * G + vidx[:, 2]
    flat = torch.where(ok, flat, torch.full_like(flat, G ** 3))
    d2 = torch.full((G ** 3 + 1,), _INF, dtype=torch.int16, device=verts.device)
    d2.index_fill_(0, flat, 0)          # every writer writes 0: no race
    d2 = d2[:G ** 3].reshape(G, G, G)
    for axis in range(3):
        best = d2.clone()
        for off in range(1, w + 1):
            n = G - off
            o2 = off * off
            # shifted-in cells are the sentinel, which never wins the min
            b = best.narrow(axis, off, n)
            torch.minimum(b, d2.narrow(axis, 0, n) + o2, out=b)
            b = best.narrow(axis, 0, n)
            torch.minimum(b, d2.narrow(axis, off, n) + o2, out=b)
        d2 = best
    return d2


def occupancy_mask(query: torch.Tensor, verts: torch.Tensor,
                   radius: float = 0.05, cell: float = CELL,
                   grid_size: int = GRID_SIZE) -> torch.Tensor:
    """query (N, 3), verts (V, 3) in one frame -> (N,) bool, True whenever
    the query MIGHT be within ``radius`` of a vertex."""
    lo = verts.amin(dim=0) - (radius + 2 * cell)
    G = grid_size
    t2 = _ball_threshold_cells_sq(radius, cell)
    w = int(math.ceil(math.sqrt(t2)))
    occ = (distance_grid(verts, lo, w, cell=cell, grid_size=G) <= t2).reshape(-1)
    qidx = torch.floor((query - lo) / cell).to(torch.int64)
    inb = ((qidx >= 0) & (qidx < G)).all(dim=-1)
    qflat = torch.clamp((qidx[:, 0] * G + qidx[:, 1]) * G + qidx[:, 2],
                        0, G ** 3 - 1)
    return occ[qflat] & inb


def strided_occupancy(pts: torch.Tensor, verts: torch.Tensor,
                      radius: float = 0.05, stride: int = 3,
                      step_margin: float = 0.06, cell: float = CELL,
                      grid_size: int = GRID_SIZE) -> torch.Tensor:
    """Conservative occupancy over a (N, D, 3) sample grid testing every
    ``stride``-th depth (plus the last) at ``radius + step_margin`` and
    spreading each flag to its +-1 neighbours.  Returns (N * D,) bool."""
    N, D, _ = pts.shape
    if stride <= 1:
        return occupancy_mask(pts.reshape(-1, 3), verts, radius=radius,
                              cell=cell, grid_size=grid_size)
    ks = sorted(set(list(range(0, D, stride)) + [D - 1]))
    nbr = []
    for k in range(D):
        cands = [i for i, kp in enumerate(ks) if abs(kp - k) <= 1]
        if not cands:
            raise ValueError(f"stride {stride} leaves sample {k} uncovered")
        nbr.append((cands[0], cands[-1]))
    dev = pts.device
    lo = torch.as_tensor(np.asarray([a for a, _ in nbr]), device=dev)
    hi = torch.as_tensor(np.asarray([b for _, b in nbr]), device=dev)
    occ_t = occupancy_mask(pts[:, torch.as_tensor(ks, device=dev)].reshape(-1, 3),
                           verts, radius=radius + step_margin, cell=cell,
                           grid_size=grid_size).reshape(N, len(ks))
    return (occ_t[:, lo] | occ_t[:, hi]).reshape(N * D)
