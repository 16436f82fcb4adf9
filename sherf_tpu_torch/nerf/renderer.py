"""The SHERF volumetric renderer (torch counterpart of
``sherf_tpu/nerf/renderer.py``: ``SHERFRenderer.__call__`` in its budgeted
and parity branches, the importance pass of both, ``_compact_rays``,
``_scatter_rays_back`` and ``decode_points`` with either decoder).

Budgeted mode (``point_capacity_frac < 1``):
  ray compaction (AABB hit AND ``ray_body_mask``) -> stratified samples ->
  strided occupancy prune -> ``compact_mask`` to the point budget -> exact
  K=1 KNN (``nn_1``) vs the posed vertices -> second ``compact_mask`` of
  the exact survivors -> inverse-LBS warp -> feature banks (``nn_1`` vs the
  canonical vertices for the c2source warp) -> transformer + decoder ->
  segmented march -> scatter the pixels back.
With ``knn_cluster.CLUSTERED`` set, the KNNs take ``nn_1_clustered`` and the
ray prune ``ray_body_mask_clustered``; ``render.knn_shortlist > 0`` sends
both budgeted-mode KNNs to ``nn_1_shortlist`` and records
``knn_shortlist_overflow``.
``prune_mode="capsule"`` replaces the strided occupancy prune by the bone
capsules of ``kernels/capsules.py`` (a looser superset of the exact test:
size ``point_capacity_frac`` from its survivors, not the voxel prune's).
Parity mode computes every sample and masks the output.

``depth_resolution_importance > 0`` adds EG3D's fine pass
(``_render_one_importance``): the coarse pass's weights give each ray
``depth_resolution_importance`` more depths, decoded and marched together
with the coarse samples.  In budgeted mode each pass runs the stride-1
occupancy prune, ``compact_mask`` to its own budget and the exact KNN, and
scatters its samples back to a dense grid.

Training (``train=True``) adds density noise ``sigma + N(0, 1) *
density_noise`` to every decoded sample, drawn from the caller's
``torch.Generator``; everything between the parameters and the pixels is
differentiable, while the kernels' integer outputs (indices, masks) stay out
of autograd.

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
from sherf_tpu_torch.kernels.grid_sample import grid_sample_2d, triplane_sample_2d
from sherf_tpu_torch.kernels import knn_cluster
from sherf_tpu_torch.kernels.knn import (
    nn_1_diag, nn_1_tables, nn_1_tables_diag, ray_body_mask)
from sherf_tpu_torch.kernels.capsules import prune_mask
from sherf_tpu_torch.kernels.occupancy import occupancy_mask, strided_occupancy
from sherf_tpu_torch.nerf.decoders import NeRFDecoder, OSGDecoder
from sherf_tpu_torch.nerf.importance import sample_importance
from sherf_tpu_torch.nerf.march import linspace01, ray_march, ray_march_segmented
from sherf_tpu_torch.nerf.warp import (
    PoseContext, c2source_tables, deform_c2source_from_tables,
    deform_target2c_from_tables, target2c_tables)
from sherf_tpu_torch.smpl.model import SMPLModel


def sample_from_planes(planes: torch.Tensor, pts_norm: torch.Tensor):
    """Triplane lookup: planes (3, H, W, C), pts_norm (M, 3) in [-1, 1] ->
    (3, M, C) in the planes' dtype; plane axes xy / xz / zy.  Below f32 the
    weights are rounded to the planes' dtype, as the JAX package's
    corner-packed sampler rounds them (``triplane_sample_2d``)."""
    def sample(plane, xy):
        if plane.dtype == torch.float32:
            return grid_sample_2d(plane, xy, align_corners=False)
        return triplane_sample_2d(plane, xy)
    return torch.stack([sample(planes[k], pts_norm[:, axes])
                        for k, axes in enumerate(([0, 1], [0, 2], [2, 1]))])


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
        if cfg.use_nerf_decoder:
            self.decoder = NeRFDecoder(dtype=cdt)
        else:
            self.decoder = OSGDecoder(n_features=cfg.plane_channels, dtype=cdt)

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
                ray_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Returns (rgb (B, N, 3), depth (B, N), acc (B, N), diag).
        ``train`` adds density noise from ``generator`` (required when
        ``cfg.render.density_noise > 0``); with the importance pass on, a
        train-mode call with a ``generator`` also draws the fine pass's u
        from it (linspace otherwise, as the JAX package's
        ``train and has_rng("density")``)."""
        rc = self.cfg.render
        noise = None
        if train and rc.density_noise > 0:
            if generator is None:
                raise ValueError("train mode with density_noise > 0 draws its "
                                 "noise from an explicit torch.Generator")
            noise = (generator, rc.density_noise)
        if rc.prune_mode not in ("voxel", "capsule"):
            raise ValueError(f"unknown prune_mode {rc.prune_mode!r}")
        u_gen = generator if train else None
        diag = Diag()
        outs = []
        for b in range(ray_o.shape[0]):
            pick = lambda t: None if t is None else t[b]
            # decode_points' arguments around the points, in its order
            bank = (pick(planes), obs_img[b], pick(obs_feat), pick(vol_feats),
                    pick(vol_coords), min_dhw[b], ctx_obs[b], ctx_big[b],
                    t_vertices[b], t_bounds[b], obs_K[b], obs_R[b], obs_T[b],
                    smpl, diag)
            rays = (ray_o[b], ray_d[b], near[b], far[b])
            if rc.depth_resolution_importance > 0:
                outs.append(self._render_one_importance(
                    bank, *rays, ctx_target[b], vertices[b], pick(ray_mask),
                    noise, u_gen))
            else:
                outs.append(self._render_one(
                    bank, *rays, ctx_target[b], vertices[b], pick(ray_mask),
                    noise))
        rgb, depth, acc = (torch.stack(t) for t in zip(*outs))
        return rgb, depth, acc, diag

    # ------------------------------------------------------------------
    def _bank(self, bank):
        """The per-item feature-bank inputs in the compute dtype."""
        cdt = self.cdt
        cast = lambda t: None if t is None else t.to(cdt)
        planes, obs_img, obs_feat, vol_feats = bank[:4]
        return (cast(planes), obs_img, cast(obs_feat), cast(vol_feats)) \
            + tuple(bank[4:])

    def _shade(self, bank, ct, pay_t2c, q_s, qd_s, exact, noise):
        """Samples in the SMPL frame -> canonical -> feature banks and
        decoder: (rgb (M, 3), densities (M,)), the density -80 where
        ``exact`` is False and noised in training."""
        cb = bank[7]
        can, can_dir = deform_target2c_from_tables(ct, cb, pay_t2c, q_s, qd_s)
        out = self.decode_points(*bank[:6], can, can_dir, *bank[6:])
        sigma = out["sigma"][:, 0]
        if noise is not None:
            gen, scale = noise
            sigma = sigma + torch.randn(sigma.shape, generator=gen,
                                        device=sigma.device,
                                        dtype=sigma.dtype) * scale
        return out["rgb"], torch.where(exact, sigma,
                                       torch.full_like(sigma, -80.0))

    def _render_one(self, bank, ray_o, ray_d, near, far, ct, vertices,
                    ray_mask, noise=None):
        rc = self.cfg.render
        diag, smpl, cb = bank[-1], bank[-2], bank[7]
        D = rc.depth_resolution
        N = N_full = ray_o.shape[0]
        dev = ray_o.device

        ray_sel = None
        if (ray_mask is not None and rc.ray_capacity_frac < 1.0
                and rc.point_capacity_frac < 1.0):
            ray_o, ray_d, near, far, ray_sel, N = self._compact_rays(
                ray_o, ray_d, near, far, ray_mask, vertices, diag)
        bank = self._bank(bank)

        steps = linspace01(D, dev)
        depths = near[:, None] + (far - near)[:, None] * steps          # (N, D)
        pts = (ray_o[:, None] + depths[..., None] * ray_d[:, None]).reshape(-1, 3)
        tar_smpl = _rot3(vertices - ct.Th, ct.R)
        tab_t2c = target2c_tables(smpl, ct, cb)
        M = N * D

        if rc.point_capacity_frac < 1.0:
            radius = float(np.sqrt(rc.prune_threshold_sq))
            if rc.prune_mode == "capsule":
                # the bone capsules, in the SMPL frame
                occ = prune_mask(_rot3(pts - ct.Th, ct.R), tar_smpl,
                                 ct.joints, smpl, radius)
            else:
                stride = rc.prune_stride if D >= 24 else 1
                if stride > 1:
                    step_f = (far - near) / (D - 1)
                    diag.record("step_overflow", torch.ceil(
                        (step_f.max() - rc.prune_step_margin) * 1e3
                    ).to(torch.int32))
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
            # knn_shortlist > 0 sends the compacted queries to the
            # cluster-shortlist kernel (default 0: the full scan)
            d2_s, vid_s, sl_over = nn_1_diag(q_s, tar_smpl, rc.knn_shortlist)
            if rc.knn_shortlist > 0:
                diag.record("knn_shortlist_overflow", sl_over)
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

        rgb_pts, dens = self._shade(bank, ct, pay_t2c, q_s, qd_s, exact_s,
                                    noise)

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
    def _render_one_importance(self, bank, ray_o, ray_d, near, far, ct,
                               vertices, ray_mask, noise=None, u_gen=None):
        """The hierarchical pass: coarse samples on the stratified grid ->
        their weights -> importance depths from the smoothed PDF (no
        gradient through them) -> fine samples -> both sets sorted by depth
        and marched together.  Parity mode (``point_capacity_frac == 1``)
        computes every sample; budgeted mode compacts the rays (when
        ``ray_capacity_frac < 1``) and each pass's samples to its budget
        (``point_capacity_frac``, ``importance_capacity_frac``), counting
        ``imp_coarse_overflow`` / ``imp_fine_overflow``."""
        rc = self.cfg.render
        diag, smpl, cb = bank[-1], bank[-2], bank[7]
        D, Di = rc.depth_resolution, rc.depth_resolution_importance
        budgeted = rc.point_capacity_frac < 1.0
        N_full = ray_o.shape[0]
        ray_sel = None
        if budgeted and ray_mask is not None and rc.ray_capacity_frac < 1.0:
            ray_o, ray_d, near, far, ray_sel, _ = self._compact_rays(
                ray_o, ray_d, near, far, ray_mask, vertices, diag)
        bank = self._bank(bank)
        tar_smpl = _rot3(vertices - ct.Th, ct.R)
        tab_t2c = target2c_tables(smpl, ct, cb)
        fine_frac = (rc.importance_capacity_frac
                     if rc.importance_capacity_frac is not None
                     else rc.point_capacity_frac)

        def grid_pass(depths, cap_frac, name):
            args = (depths, ray_o, ray_d, ct, tar_smpl, tab_t2c, bank, noise)
            if budgeted:
                return self._eval_points_budgeted(
                    *args, vertices, cap_frac, N_full * depths.shape[1], name)
            return self._eval_points_full(*args)

        steps = linspace01(D, ray_o.device)
        depths = near[:, None] + (far - near)[:, None] * steps          # (N, D)
        col_c, den_c = grid_pass(depths, rc.point_capacity_frac,
                                 "imp_coarse_overflow")
        march = dict(clamp_mode=rc.clamp_mode, white_back=rc.white_back)
        _, _, w = ray_march(col_c, den_c, depths, ray_d, **march)
        z_fine = sample_importance(depths, w.detach(), Di, det=u_gen is None,
                                   generator=u_gen).detach()
        col_f, den_f = grid_pass(z_fine, fine_frac, "imp_fine_overflow")

        # the union, sorted by depth (stable, as jnp.argsort)
        all_d = torch.cat([depths, z_fine], dim=-1)
        order = torch.argsort(all_d, dim=-1, stable=True)
        all_d = all_d.gather(-1, order)
        all_c = torch.cat([col_c, col_f], dim=1).gather(
            1, order[..., None].expand(-1, -1, 3))
        all_s = torch.cat([den_c, den_f], dim=1).gather(1, order)
        rgb, depth, weights = ray_march(all_c, all_s, all_d, ray_d, **march)
        acc = weights.sum(dim=-1)
        if ray_sel is None:
            return rgb, depth, acc
        return self._scatter_rays_back(rgb, depth, acc, ray_sel, N_full)

    def _eval_points_full(self, depths, ray_o, ray_d, ct, tar_smpl, tab_t2c,
                          bank, noise):
        """Every sample of an (N, Dx) depth grid through the exact KNN and
        the decoder, failures masked: (colors (N, Dx, 3), dens (N, Dx))."""
        rc = self.cfg.render
        N, Dx = depths.shape
        pts = (ray_o[:, None] + depths[..., None] * ray_d[:, None]).reshape(-1, 3)
        q = _rot3(pts - ct.Th, ct.R)
        qd = _rot3(ray_d[:, None].expand(N, Dx, 3).reshape(-1, 3), ct.R)
        d2, _, pay = nn_1_tables(q, tar_smpl, tab_t2c)
        mask = d2 < rc.prune_threshold_sq
        rgb, dens = self._shade(bank, ct, pay, q, qd, mask, noise)
        return (rgb * mask[:, None]).reshape(N, Dx, 3), dens.reshape(N, Dx)

    def _eval_points_budgeted(self, depths, ray_o, ray_d, ct, tar_smpl,
                              tab_t2c, bank, noise, vertices, cap_frac: float,
                              n_total: int, name: str):
        """An (N, Dx) depth grid through the stride-1 occupancy prune, a
        ``compact_mask`` to ``cap_frac`` of ``n_total``, the exact KNN and
        the decoder, then scattered back to the dense grid (pruned samples
        empty): (colors (N, Dx, 3), dens (N, Dx)) in f32."""
        rc = self.cfg.render
        diag = bank[-1]
        N, Dx = depths.shape
        M = N * Dx
        pts = (ray_o[:, None] + depths[..., None] * ray_d[:, None]).reshape(M, 3)
        occ = occupancy_mask(pts, vertices,
                             radius=float(np.sqrt(rc.prune_threshold_sq)))
        cap = min(_round_up(max(int(n_total * cap_frac), 128), 128), M)
        diag.record(name, occ.sum() - cap)
        idx, valid = compact_mask(occ, cap)
        gidx = torch.clamp(idx.long(), max=M - 1)
        q_s = _rot3(pts[gidx] - ct.Th, ct.R)
        qd_s = _rot3(ray_d[gidx // Dx], ct.R)
        d2_s, _, pay_t2c, sl_over = nn_1_tables_diag(q_s, tar_smpl, tab_t2c,
                                                     rc.knn_shortlist)
        if rc.knn_shortlist > 0:
            diag.record("knn_shortlist_overflow", sl_over)
        exact_s = valid & (d2_s < rc.prune_threshold_sq)
        rgb, dens = self._shade(bank, ct, pay_t2c, q_s, qd_s, exact_s, noise)
        # each slot to its own row: the valid ones to their samples, the
        # rest past the grid (cut off), so autograd reaches every kept slot
        slot = torch.where(valid, gidx, M + torch.arange(cap, device=gidx.device))
        col = rgb.new_zeros((M + cap, 3), dtype=torch.float32).index_copy(
            0, slot, (rgb * exact_s[:, None]).float())
        den = torch.full((M + cap,), -80.0, device=dens.device).index_copy(
            0, slot, dens.float())
        return col[:M].reshape(N, Dx, 3), den[:M].reshape(N, Dx)

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
        if (knn_cluster.CLUSTERED
                and vertices.shape[0] >= 8 * knn_cluster.C_SIZE):
            body = knn_cluster.ray_body_mask_clustered(ray_o, ray_d, vertices,
                                                       thr_ray)
        else:
            # the AABB mask lets all-miss ray tiles skip the scan
            body = ray_body_mask(ray_o, ray_d, vertices, thr_ray,
                                 active=ray_mask)
        ray_mask = ray_mask & body
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
            # budgeted-mode queries arrive compacted: the shortlist applies
            slc = (cfg.render.knn_shortlist
                   if cfg.render.point_capacity_frac < 1.0 else 0)
            _, _, pay_c2s, sl_over = nn_1_tables_diag(can, t_vertices,
                                                      tab_c2s, slc)
            if slc > 0:
                diag.record("knn_shortlist_overflow", sl_over)
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
        if cfg.use_nerf_decoder:
            return self.decoder(positional_encoding(can, 6), fused,
                                positional_encoding(can_dir, 4))
        return self.decoder(fused, can_dir)
