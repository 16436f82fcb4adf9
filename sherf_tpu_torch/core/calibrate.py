"""Scene-adaptive sizing of the renderer's static budgets (torch counterpart
of ``sherf_tpu/core/calibrate.py``).

``calibrate_budgets`` measures the survivor counts of representative batches
on the device and returns a RenderConfig whose budgets cover the worst
frame times a margin.  Consumers must read the renderer's overflow counters
and treat any nonzero value as a corrupted frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch

from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.kernels.knn import nn_1, ray_body_mask
from sherf_tpu_torch.kernels.occupancy import (
    CELL, GRID_SIZE, INT16_W2_MAX, edt_window_cells, strided_occupancy)
from sherf_tpu_torch.nerf.renderer import linspace01


def _round_up(n: int, mult: int) -> int:
    return int(math.ceil(n / mult) * mult)


def measure_sparse_sites(t_vertices, voxel_size: float, pad: float = 0.05):
    """Exact occupied-site counts after each of the three stride-2 sparse
    downsamples of the canonical body (host numpy)."""
    t_vertices = np.asarray(t_vertices)
    min_dhw, out_sh = prepare_voxel_volume(t_vertices, pad=pad,
                                           voxel_size=voxel_size)
    dhw = t_vertices[:, [2, 1, 0]]
    coords = torch.round(torch.from_numpy(
        ((dhw - min_dhw) / voxel_size).astype(np.float32))).numpy().astype(np.int64)
    occ = np.zeros(out_sh, bool)
    occ[coords[:, 0], coords[:, 1], coords[:, 2]] = True
    counts = []
    for _ in range(3):
        so = tuple((s - 1) // 2 + 1 for s in occ.shape)
        padded = np.pad(occ, 1)
        nxt = np.zeros(so, bool)
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    nxt |= padded[dz:dz + 2 * so[0]:2, dy:dy + 2 * so[1]:2,
                                  dx:dx + 2 * so[2]:2]
        occ = nxt
        counts.append(int(occ.sum()))
    return counts


def calibrate_sparse_caps(t_vertices_list, voxel_size: float,
                          margin: float = 1.1, round_to: int = 256,
                          pad: float = 0.05):
    """``ModelConfig.sparse_caps`` fitted to the per-scale site counts."""
    worst = [0, 0, 0]
    for tv in t_vertices_list:
        counts = measure_sparse_sites(tv, voxel_size, pad=pad)
        worst = [max(w, c) for w, c in zip(worst, counts)]
    return tuple(_round_up(int(c * margin), round_to) for c in worst)


@torch.no_grad()
def measure_budgets(batch, cfg) -> dict:
    """Survivor counts of one batch at the production prune settings:
    {"rays", "voxel", "exact", "step_max", "span"}."""
    rcfg = cfg.render
    D = rcfg.depth_resolution
    steps = linspace01(D, batch.ray_o.device)
    out = {"rays": 0, "voxel": 0, "exact": 0, "step_max": 0.0, "span": 0.0}
    for b in range(batch.ray_o.shape[0]):
        near, far, verts = batch.near[b], batch.far[b], batch.vertices[b]
        dvals = near[:, None] + (far - near)[:, None] * steps
        pts = (batch.ray_o[b][:, None]
               + dvals[..., None] * batch.ray_d[b][:, None]).reshape(-1, 3)
        stride = rcfg.prune_stride if D >= 24 else 1
        occ_n = int(strided_occupancy(pts.reshape(-1, D, 3), verts,
                                      stride=stride,
                                      step_margin=rcfg.prune_step_margin).sum())
        # exact count estimated on a depth subsample that does not divide
        # into whole rays
        s = 8 if D >= 24 else max(1, D // 4)
        d2, _ = nn_1(pts[::s].contiguous(), verts)
        exact_n = int((d2 < rcfg.prune_threshold_sq).sum()) * s
        thr_ray = (float(np.sqrt(rcfg.prune_threshold_sq)) + 1e-3) ** 2
        seg = ray_body_mask(batch.ray_o[b], batch.ray_d[b], verts, thr_ray)
        hit = int((batch.mask_at_box[b].to(torch.bool) & seg).sum())
        out["rays"] = max(out["rays"], hit)
        out["voxel"] = max(out["voxel"], occ_n)
        out["exact"] = max(out["exact"], exact_n)
        out["step_max"] = max(out["step_max"],
                              float(((far - near) / (D - 1)).max()))
        out["span"] = max(out["span"],
                          float((verts.amax(0) - verts.amin(0)).max()))
    return out


def calibrate_budgets(batches: Iterable, cfg, margin: float = 1.2,
                      round_to: int = 8192):
    """Returns (RenderConfig with fitted budgets, measured worst dict).

    ``batches`` is iterated twice (the step margin is fitted over every
    batch before any survivor count is taken): pass a list, or a
    re-iterable whose every pass yields the same batches, one at a time,
    so that only one batch need be alive at once.

    The fitted budgets — including the fitted ``prune_step_margin`` — hold
    only for frames shaped like the calibration batches; every consumer must
    check the renderer's overflow counters."""
    if iter(batches) is batches:
        raise TypeError("calibrate_budgets iterates its batches twice: pass "
                        "a list or a re-iterable, not an iterator")
    rcfg = cfg.render
    D = rcfg.depth_resolution
    if rcfg.prune_stride > 1 and D >= 24:
        step_max = max((float(((b.far - b.near) / (D - 1)).max())
                        for b in batches), default=None)
        if step_max is None:
            raise ValueError("need at least one calibration batch")
        fitted_margin = math.ceil(step_max / 0.005) * 0.005
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            rcfg, prune_step_margin=fitted_margin))
        rcfg = cfg.render

    worst = {"rays": 0, "voxel": 0, "exact": 0, "step_max": 0.0, "span": 0.0}
    H_W = None
    for batch in batches:
        m = measure_budgets(batch, cfg)
        H_W = batch.ray_o.shape[1]
        for k in worst:
            worst[k] = max(worst[k], m[k])
    if H_W is None:
        raise ValueError("need at least one calibration batch")
    empty = [k for k in ("rays", "voxel", "exact") if worst[k] == 0]
    if empty:
        raise ValueError(f"calibration found no survivors for {empty}: the "
                         f"scene puts no sample near the body, so there is "
                         f"no budget to fit")
    radius = float(np.sqrt(rcfg.prune_threshold_sq))
    eff_margin = (rcfg.prune_step_margin
                  if rcfg.prune_stride > 1 and D >= 24 else 0.0)
    need = worst["span"] + 2 * (radius + eff_margin + 3 * CELL)
    if need >= GRID_SIZE * CELL:
        raise ValueError(f"body span {worst['span']:.2f}m + dilation needs "
                         f"{need:.2f}m > occupancy grid {GRID_SIZE * CELL:.2f}m")
    w = edt_window_cells(radius + eff_margin)
    if w * w > INT16_W2_MAX:
        raise ValueError(
            f"fitted prune_step_margin {eff_margin:.3f}m needs EDT window "
            f"w={w} (w*w={w * w} > {INT16_W2_MAX}); raise depth_resolution "
            f"or set prune_stride=1")
    M = H_W * D
    caps = {k: min(_round_up(int(worst[k] * margin), round_to), total)
            for k, total in (("rays", H_W), ("voxel", M), ("exact", M))}
    fitted = dataclasses.replace(
        rcfg,
        ray_capacity_frac=caps["rays"] / H_W,
        point_capacity_frac=caps["voxel"] / M,
        exact_capacity_frac=caps["exact"] / M,
    )
    if rcfg.depth_resolution_importance > 0:
        # the fine pass's PDF depths gather inside occupied space, so the
        # stratified grid's survivor share undersizes them: cover every
        # fine sample of every budgeted ray (rays_cap * Di), which the
        # prune can only shrink
        fitted = dataclasses.replace(
            fitted, importance_capacity_frac=caps["rays"] / H_W)
    return fitted, worst
