"""Hierarchical (importance) sampling along rays (torch counterpart of
``sherf_tpu/nerf/importance.py``): the coarse pass's weights, smoothed,
become a piecewise-constant PDF over the depth bins, and the fine depths are
its inverse CDF at ``n_importance`` values of u.

u is ``linspace(0, 1, n)`` (``det=True``) or uniform draws from the caller's
``torch.Generator``; there is no hidden global RNG.
"""

from __future__ import annotations

from typing import Optional

import torch

from sherf_tpu_torch.nerf.march import linspace01


def _smooth_weights(w: torch.Tensor) -> torch.Tensor:
    """max_pool1d(k=2, pad=1) then avg_pool1d(k=2) + 0.01: (R, D) -> (R, D)."""
    pad = torch.full_like(w[:, :1], float("-inf"))
    padded = torch.cat([pad, w, pad], dim=-1)
    mx = torch.maximum(padded[:, :-1], padded[:, 1:])
    return (mx[:, :-1] + mx[:, 1:]) / 2.0 + 0.01


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               det: bool = False, eps: float = 1e-5,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling.  bins (R, B + 1) depth bin edges, weights
    (R, B) -> (R, n_importance) depths."""
    R, B = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (R, B+1)
    if det:
        u = linspace01(n_importance, weights.device)[None].expand(R, -1)
    else:
        if generator is None:
            raise ValueError("sample_pdf(det=False) draws u from an explicit "
                             "torch.Generator")
        u = torch.rand((R, n_importance), generator=generator,
                       device=weights.device, dtype=weights.dtype)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def sample_importance(z_vals: torch.Tensor, weights: torch.Tensor,
                      n_importance: int, det: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """z_vals, weights (R, D) -> (R, n_importance) fine depths."""
    w = _smooth_weights(weights)
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    return sample_pdf(z_mid, w[:, 1:-1], n_importance, det=det,
                      generator=generator)
