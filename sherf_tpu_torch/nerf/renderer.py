"""The SHERF volumetric renderer (torch counterpart of
``sherf_tpu/nerf/renderer.py``: ``SHERFRenderer.__call__`` in its budgeted
and parity branches, ``_compact_rays``, ``_scatter_rays_back`` and
``decode_points``).

Budgeted mode (``point_capacity_frac < 1``):
  ray compaction (AABB hit AND ``ray_body_mask``) -> stratified samples ->
  strided occupancy prune -> ``compact_mask`` to the point budget -> exact
  K=1 KNN (``nn_1``) vs the posed vertices -> second ``compact_mask`` of
  the exact survivors -> inverse-LBS warp -> feature banks (``nn_1`` vs the
  canonical vertices for the c2source warp) -> transformer + decoder ->
  segmented march -> scatter the pixels back.
Parity mode computes every sample and masks the output.

Batch items are independent; the renderer loops over them.  Overflow
counters (survivors - budget, clamped at 0) go to a ``Diag`` dict returned
beside the outputs; nonzero means the budget truncated real samples.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from sherf_tpu_torch.core.config import ModelConfig
from sherf_tpu_torch.core.diag import Diag
from sherf_tpu_torch.features.encoding import positional_encoding
from sherf_tpu_torch.features.layers import Dense
from sherf_tpu_torch.features.sparseconv import (
    SparseConvNet, readout_channels, world_to_voxel_f)
from sherf_tpu_torch.features.transformer import PlaneTransformer
from sherf_tpu_torch.geometry.rays import project_points
from sherf_tpu_torch.kernels.compaction import compact_mask
from sherf_tpu_torch.kernels.grid_sample import grid_sample_2d
from sherf_tpu_torch.kernels.knn import nn_1, nn_1_tables, ray_body_mask
from sherf_tpu_torch.kernels.occupancy import strided_occupancy
from sherf_tpu_torch.nerf.decoders import NeRFDecoder
from sherf_tpu_torch.nerf.march import ray_march, ray_march_segmented
from sherf_tpu_torch.nerf.warp import (
    PoseContext, c2source_tables, deform_c2source_from_tables,
    deform_target2c_from_tables, target2c_tables)
from sherf_tpu_torch.smpl.model import SMPLModel


def linspace01(D: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, D)`` value for value: i * (1 / (D - 1)) in f32,
    last entry exactly 1 (torch.linspace rounds its upper half differently)."""
    if D == 1:
        return torch.zeros(1, device=device)
    s = np.arange(D, dtype=np.float32) * np.float32(1.0 / (D - 1))
    s[-1] = 1.0
    return torch.from_numpy(s).to(device)


def sample_from_planes(planes: torch.Tensor, pts_norm: torch.Tensor):
    """Triplane lookup: planes (3, H, W, C), pts_norm (M, 3) in [-1, 1] ->
    (3, M, C); plane axes xy / xz / zy."""
    return torch.stack([
        grid_sample_2d(planes[0], pts_norm[:, [0, 1]], align_corners=False),
        grid_sample_2d(planes[1], pts_norm[:, [0, 2]], align_corners=False),
        grid_sample_2d(planes[2], pts_norm[:, [2, 1]], align_corners=False),
    ])


def _rot3(pts: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """out[..., d] = sum_c pts[..., c] R[c, d] as explicit f32 products and
    sums (the JAX package's elementwise form)."""
    p = pts.float()
    r = R.float()
    return torch.stack([p[..., 0] * r[0, d] + p[..., 1] * r[1, d]
                        + p[..., 2] * r[2, d] for d in range(3)], dim=-1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t[idx.long()]


class SHERFRenderer(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 out_sh: Tuple[int, int, int] = (128, 352, 416)):
        super().__init__()
        self.cfg = cfg
        self.out_sh = tuple(out_sh)
        cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.cdt = cdt
        if cfg.use_3d_feature:
            self.encoder_3d = SparseConvNet(
                num_layers=cfg.sparse_conv_layers, out_sh=self.out_sh,
                caps=cfg.resolved_sparse_caps, in_channels=cfg.plane_channels,
                dtype=cdt)
            self.conv1d_projection = Dense(
                readout_channels(cfg.sparse_conv_layers), 96, dtype=cdt)
        n_banks = (int(cfg.use_1d_feature) + int(cfg.use_2d_feature)
                   + int(cfg.use_3d_feature))
        if n_banks > 1:
            self.conv1d_reprojection = Dense(32 * n_banks, 32, dtype=cdt)
        if cfg.use_trans:
            self.transformer = PlaneTransformer(dim=cfg.plane_channels,
                                                dtype=cdt)
        if not cfg.use_nerf_decoder:
            raise NotImplementedError("the port has the NeRF decoder only")
        self.decoder = NeRFDecoder(dtype=cdt)

    # ------------------------------------------------------------------
    def forward(self, planes: Optional[torch.Tensor],      # (B, 3, Hp, Wp, C)
                obs_img: torch.Tensor,                      # (B, H, W, 3)
                obs_feat: Optional[torch.Tensor],           # (B, Hf, Wf, 64)
                vol_feats: Optional[torch.Tensor],          # (B, S, 32)
                vol_coords: Optional[torch.Tensor],         # (B, S, 3) int
                min_dhw: torch.Tensor,                      # (B, 3)
                ray_o, ray_d, near, far,                    # (B, N, 3) / (B, N)
                ctx_target: Sequence[PoseContext],
                ctx_big: Sequence[PoseContext],
                ctx_obs: Sequence[PoseContext],
                vertices, t_vertices, t_bounds,             # (B, 6890, 3), (B, 2, 3)
                obs_K, obs_R, obs_T, smpl: SMPLModel,
                ray_mask: Optional[torch.Tensor] = None):
        """Returns (rgb (B, N, 3), depth (B, N), acc (B, N), diag)."""
        rc = self.cfg.render
        if rc.depth_resolution_importance > 0:
            raise NotImplementedError("the importance pass is not ported")
        if rc.prune_mode != "voxel":
            raise NotImplementedError("only prune_mode='voxel' is ported")
        diag = Diag()
        outs = []
        for b in range(ray_o.shape[0]):
            pick = lambda t: None if t is None else t[b]
            outs.append(self._render_one(
                pick(planes), obs_img[b], pick(obs_feat), pick(vol_feats),
                pick(vol_coords), min_dhw[b], ray_o[b], ray_d[b], near[b],
                far[b], ctx_target[b], ctx_big[b], ctx_obs[b], vertices[b],
                t_vertices[b], t_bounds[b], obs_K[b], obs_R[b], obs_T[b],
                smpl, pick(ray_mask), diag))
        rgb, depth, acc = (torch.stack(t) for t in zip(*outs))
        return rgb, depth, acc, diag

    # ------------------------------------------------------------------
    def _render_one(self, planes, obs_img, obs_feat, vol_feats, vol_coords,
                    min_dhw, ray_o, ray_d, near, far, ct, cb, co, vertices,
                    t_vertices, t_bounds, obs_K, obs_R, obs_T, smpl, ray_mask,
                    diag: Diag):
        rc = self.cfg.render
        cdt = self.cdt
        D = rc.depth_resolution
        N = N_full = ray_o.shape[0]
        dev = ray_o.device

        ray_sel = None
        if (ray_mask is not None and rc.ray_capacity_frac < 1.0
                and rc.point_capacity_frac < 1.0):
            ray_o, ray_d, near, far, ray_sel, N = self._compact_rays(
                ray_o, ray_d, near, far, ray_mask, vertices, diag)
        planes = None if planes is None else planes.to(cdt)
        obs_feat = None if obs_feat is None else obs_feat.to(cdt)
        vol_feats = None if vol_feats is None else vol_feats.to(cdt)

        steps = linspace01(D, dev)
        depths = near[:, None] + (far - near)[:, None] * steps          # (N, D)
        pts = (ray_o[:, None] + depths[..., None] * ray_d[:, None]).reshape(-1, 3)
        tar_smpl = _rot3(vertices - ct.Th, ct.R)
        tab_t2c = target2c_tables(smpl, ct, cb)
        M = N * D

        if rc.point_capacity_frac < 1.0:
            radius = float(np.sqrt(rc.prune_threshold_sq))
            stride = rc.prune_stride if D >= 24 else 1
            if stride > 1:
                step_f = (far - near) / (D - 1)
                diag.record("step_overflow", torch.ceil(
                    (step_f.max() - rc.prune_step_margin) * 1e3).to(torch.int32))
            occ = strided_occupancy(pts.reshape(N, D, 3), vertices,
                                    radius=radius, stride=stride,
                                    step_margin=rc.prune_step_margin)
            # capacity is defined on the FULL candidate set
            cap = min(_round_up(max(int(N_full * D * rc.point_capacity_frac),
                                    128), 128), M)
            diag.record("point_overflow", occ.sum() - cap)
            idx, valid = compact_mask(occ, cap)
            gidx = torch.clamp(idx.long(), max=M - 1)
            # recompute each survivor's position from its ray row with the
            # same op sequence as `pts` (bit-equal)
            rr = gidx // D
            o_s, dirs_s = ray_o[rr], ray_d[rr]
            near_s, far_s = near[rr], far[rr]
            depth_s = near_s + (far_s - near_s) * steps[gidx % D]
            pts_s = o_s + depth_s[:, None] * dirs_s
            q_s = _rot3(pts_s - ct.Th, ct.R)
            qd_s = _rot3(dirs_s, ct.R)
            d2_s, vid_s = nn_1(q_s, tar_smpl)
            exact_s = valid & (d2_s < rc.prune_threshold_sq)
            if rc.exact_capacity_frac < 1.0:
                cap2 = min(_round_up(max(int(N_full * D * rc.exact_capacity_frac),
                                         128), 128), cap)
                diag.record("exact_overflow", exact_s.sum() - cap2)
                idx2, valid2 = compact_mask(exact_s, cap2)
                g2 = torch.clamp(idx2.long(), max=cap - 1)
                q_s, qd_s, vid_s = q_s[g2], qd_s[g2], vid_s[g2]
                # idx ascending and idx2 picks ascending slots of it
                idx = torch.where(valid2, idx[g2], torch.full_like(idx[g2], M))
                valid = exact_s = valid2
            pay_t2c = _take(tab_t2c, vid_s)
        else:
            # parity mode: exact full KNN, mask-only
            q_s = _rot3(pts - ct.Th, ct.R)
            qd_s = _rot3(ray_d[:, None].expand(N, D, 3).reshape(M, 3), ct.R)
            d2, _, pay_t2c = nn_1_tables(q_s, tar_smpl, tab_t2c)
            exact_s = d2 < rc.prune_threshold_sq
            idx = None

        can, can_dir = deform_target2c_from_tables(ct, cb, pay_t2c, q_s, qd_s)
        out = self.decode_points(planes, obs_img, obs_feat, vol_feats,
                                 vol_coords, min_dhw, can, can_dir, co, cb,
                                 t_vertices, t_bounds, obs_K, obs_R, obs_T,
                                 smpl, diag)
        rgb_pts = out["rgb"]
        sigma_pts = out["sigma"][:, 0]
        dens = torch.where(exact_s, sigma_pts, torch.full_like(sigma_pts, -80.0))

        if idx is not None:
            clip = None if ray_sel is None else (ray_sel[2], ray_sel[3])
            rgb, depth, acc = ray_march_segmented(
                rgb_pts, dens, idx, valid, near, far, ray_d, D,
                clamp_mode=rc.clamp_mode, white_back=rc.white_back,
                depth_clip=clip)
            if ray_sel is None:
                return rgb, depth, acc
            return self._scatter_rays_back(rgb, depth, acc, ray_sel, N_full)

        colors = (rgb_pts * exact_s[:, None]).reshape(N, D, 3)
        rgb, depth, weights = ray_march(colors, dens.reshape(N, D), depths,
                                        ray_d, clamp_mode=rc.clamp_mode,
                                        white_back=rc.white_back)
        return rgb, depth, weights.sum(dim=-1)

    # ------------------------------------------------------------------
    def _compact_rays(self, ray_o, ray_d, near, far, ray_mask, vertices,
                      diag: Diag):
        """Static-budget ray compaction: AABB-hitting rays whose line passes
        within the prune radius (+1 mm of slack, as in the JAX package) of a
        posed vertex.  Returns the rays gathered down to the budget and
        ray_sel = (ridx, rvalid, depth_lo, depth_hi) for the scatter-back."""
        rc = self.cfg.render
        N = ray_o.shape[0]
        ray_mask = ray_mask.reshape(-1).to(torch.bool)
        thr_ray = (float(np.sqrt(rc.prune_threshold_sq)) + 1e-3) ** 2
        ray_mask = ray_mask & ray_body_mask(ray_o, ray_d, vertices, thr_ray,
                                            active=ray_mask)
        depth_lo, depth_hi = near.min(), far.max()
        rcap = _round_up(max(int(N * rc.ray_capacity_frac), 128), 128)
        ridx, rvalid = compact_mask(ray_mask, rcap)
        diag.record("ray_overflow", ray_mask.sum() - rcap)
        gr = torch.clamp(ridx.long(), max=N - 1)
        # invalid tail rays park far outside the body: the prune drops them
        ray_o = torch.where(rvalid[:, None], ray_o[gr],
                            torch.full_like(ray_o[gr], 1e6))
        return (ray_o, ray_d[gr], near[gr], far[gr],
                (ridx, rvalid, depth_lo, depth_hi), rcap)

    def _scatter_rays_back(self, rgb, depth, acc, ray_sel, N_full):
        """Composited compacted-ray pixels -> the full ray set; dropped rays
        get the dense path's empty-ray values.  Valid ray indices are
        distinct, and the sentinel N lands in a slot that is cut off."""
        ridx, rvalid, depth_lo, depth_hi = ray_sel
        empty_rgb = 1.0 if self.cfg.render.white_back else -1.0
        slot = ridx.long()

        def scatter(fill, vals):
            out = fill.new_empty((N_full + 1,) + fill.shape[1:])
            out[:N_full] = fill
            out[slot] = vals
            return out[:N_full]

        dev = rgb.device
        rgb_f = scatter(torch.full((N_full, 3), empty_rgb, device=dev),
                        torch.where(rvalid[:, None], rgb,
                                    torch.full_like(rgb, empty_rgb)))
        depth_f = scatter(depth_hi.expand(N_full).float(),
                          torch.where(rvalid, depth, depth_hi))
        acc_f = scatter(torch.zeros(N_full, device=dev),
                        torch.where(rvalid, acc, torch.zeros_like(acc)))
        return rgb_f, depth_f, acc_f

    # ------------------------------------------------------------------
    def decode_points(self, planes, obs_img, obs_feat, vol_feats, vol_coords,
                      min_dhw, can, can_dir, ctx_obs: PoseContext,
                      ctx_big: PoseContext, t_vertices, t_bounds, obs_K,
                      obs_R, obs_T, smpl: SMPLModel, diag: Diag):
        """Feature-bank lookup + fusion + decoder at canonical points (M, 3)
        of one batch item.  Returns {"rgb": (M, 3), "sigma": (M, 1)}."""
        cfg = self.cfg
        banks = []
        if cfg.use_1d_feature:
            lo, hi = t_bounds[0], t_bounds[1]
            banks.append(sample_from_planes(planes, 2.0 * (can - lo) / (hi - lo)
                                            - 1.0))
        if cfg.use_2d_feature:
            tab_c2s = c2source_tables(smpl, ctx_obs, ctx_big)
            _, _, pay_c2s = nn_1_tables(can, t_vertices, tab_c2s)
            _, world_src, _ = deform_c2source_from_tables(ctx_obs, ctx_big,
                                                          pay_c2s, can)
            uv, _ = project_points(world_src, obs_K, obs_R, obs_T)
            wh = torch.tensor([obs_img.shape[1], obs_img.shape[0]],
                              dtype=torch.float32, device=can.device)
            uv_n = 2.0 * uv / wh - 1.0
            pix_feat = grid_sample_2d(obs_feat, uv_n, align_corners=True)
            pix_rgb = grid_sample_2d(obs_img, uv_n, align_corners=True)
            rgb_feat = positional_encoding(pix_rgb, 5)[..., :32]  # 33 -> 32 quirk
            p2d = torch.cat([pix_feat, rgb_feat], dim=-1)          # (M, 96)
            banks.append(p2d.reshape(-1, 3, 32).permute(1, 0, 2))
        if cfg.use_3d_feature:
            qdhw = world_to_voxel_f(can, min_dhw, cfg.voxel_size)
            f3 = self.encoder_3d(vol_feats, vol_coords, qdhw, diag)  # (M, 192)
            p3d = self.conv1d_projection(f3)                         # (M, 96)
            banks.append(p3d.reshape(-1, 3, 32).permute(1, 0, 2))
        fused = torch.cat([b.float() for b in banks], dim=-1)  # (3, M, 32*n)
        if len(banks) > 1:
            fused = self.conv1d_reprojection(fused)
        if cfg.use_trans:
            fused = self.transformer(fused.permute(1, 0, 2)).permute(1, 0, 2)
        return self.decoder(positional_encoding(can, 6), fused,
                            positional_encoding(can_dir, 4))
