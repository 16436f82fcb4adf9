"""Alpha-compositing ray marchers (torch counterpart of
``sherf_tpu/nerf/march.py``): the dense grid marcher of parity mode and the
segmented marcher that composites the compacted survivor points directly."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def linspace01(D: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, D)`` value for value: i * (1 / (D - 1)) in f32,
    last entry exactly 1 (torch.linspace rounds its upper half differently)."""
    if D == 1:
        return torch.zeros(1, device=device)
    s = np.arange(D, dtype=np.float32) * np.float32(1.0 / (D - 1))
    s[-1] = 1.0
    return torch.from_numpy(s).to(device)


def _sigma(densities: torch.Tensor, clamp_mode: str) -> torch.Tensor:
    if clamp_mode == "softplus":
        return F.softplus(densities - 1.0)
    if clamp_mode == "relu":
        return F.relu(densities)
    raise ValueError(f"unsupported clamp_mode {clamp_mode!r}")


def ray_march(colors, densities, depths, rays_d, clamp_mode: str = "relu",
              white_back: bool = False):
    """colors (N, D, 3); densities, depths (N, D); rays_d (N, 3).
    Returns (rgb (N, 3) in (-1, 1), depth (N,), weights (N, D))."""
    deltas = depths[:, 1:] - depths[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1)
    deltas = deltas * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-_sigma(densities, clamp_mode) * deltas)
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                        dim=-1)
    weights = alpha * torch.cumprod(shifted, dim=-1)[:, :-1]
    rgb = (weights[..., None] * colors).sum(dim=-2)
    acc = weights.sum(dim=-1)
    depth = (weights * depths).sum(dim=-1) / acc
    depth = torch.nan_to_num(depth, nan=float("inf"))
    depth = torch.clamp(depth, depths.min(), depths.max())
    if white_back:
        rgb = rgb + (1.0 - acc)[..., None]
    return rgb * 2.0 - 1.0, depth, weights


def ray_march_segmented(colors, densities, gidx, valid, near, far, rays_d,
                        depth_resolution: int, clamp_mode: str = "relu",
                        white_back: bool = False, depth_clip=None):
    """Composite compacted points without scattering them back to the
    (N, D) grid.  gidx (P,) ascending flat sample ids ray*D + k; valid (P,)
    a prefix; near, far (N,); rays_d (N, 3); depth_clip optional (lo, hi).

    Transmittance is a segmented exclusive sum of log(1 - alpha) over each
    ray's contiguous run.  The running sum is taken in float64: in f32 the
    global prefix over ~10^5-10^6 points loses the small per-ray
    differences (the JAX package sums in f32).
    Returns (rgb (N, 3) in (-1, 1), depth (N,), acc (N,))."""
    N = near.shape[0]
    D = depth_resolution
    colors = colors.float()
    densities = densities.float()
    near, far = near.float(), far.float()
    gidx = gidx.long()
    ray = gidx // D
    k = gidx % D
    seg = torch.where(valid, ray, torch.full_like(ray, N))

    dnorm = torch.linalg.norm(rays_d, dim=-1)
    rows = torch.stack([near, far, dnorm], dim=-1)[torch.clamp(ray, max=N - 1)]
    near_p, far_p, dn_p = rows[:, 0], rows[:, 1], rows[:, 2]
    step = (far_p - near_p) / (D - 1)
    depth_p = near_p + step * k.to(near_p.dtype)
    delta = torch.where(k == D - 1, torch.full_like(step, 1e10), step) * dn_p

    sigma = torch.where(valid, _sigma(densities, clamp_mode),
                        torch.zeros_like(densities))
    one_m_alpha = torch.exp(-sigma * delta)
    alpha = 1.0 - one_m_alpha
    logt = torch.clamp(torch.log(one_m_alpha + 1e-10), max=0.0).double()
    s = torch.cumsum(logt, dim=0) - logt                     # exclusive
    is_start = torch.ones_like(seg, dtype=torch.bool)
    is_start[1:] = seg[1:] != seg[:-1]
    start_vals = torch.where(is_start, s, torch.full_like(s, float("inf")))
    s_start = torch.cummin(start_vals, dim=0).values
    trans = torch.exp(s - s_start).float()
    w = alpha * trans * valid.to(alpha.dtype)

    def seg_sum(v):
        out = v.new_zeros((N + 1,) + v.shape[1:])
        return out.index_add_(0, seg, v)[:N]

    rgb = seg_sum(w[:, None] * colors)
    acc = seg_sum(w)
    wd = seg_sum(w * depth_p)
    lo, hi = depth_clip if depth_clip is not None else (near.min(), far.max())
    depth = torch.nan_to_num(wd / acc, nan=float("inf"))
    depth = torch.minimum(torch.maximum(depth, torch.as_tensor(lo)),
                          torch.as_tensor(hi))
    if white_back:
        rgb = rgb + (1.0 - acc)[..., None]
    return rgb * 2.0 - 1.0, depth, acc
