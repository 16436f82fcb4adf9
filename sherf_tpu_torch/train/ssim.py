"""Mask-weighted SSIM (torch counterpart of ``sherf_tpu/train/ssim.py``).

pytorch_msssim's ``ssim`` defaults (the reference training loss): Gaussian
window 11, sigma 1.5, K = (0.01, 0.03), valid-mode filtering, here as two
depthwise ``F.conv2d`` passes of the separable 1-D window.  Images are
NHWC at the public functions, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_sep(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable valid-mode filtering of (B, C, H, W), H first."""
    C = x.shape[1]
    k = torch.as_tensor(k1d, dtype=x.dtype, device=x.device)
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(C, 1, -1, 1), groups=C)
    return F.conv2d(x, k.view(1, 1, 1, -1).expand(C, 1, 1, -1), groups=C)


def ssim_map(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
             win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
             k2: float = 0.03) -> torch.Tensor:
    """Per-pixel SSIM over valid windows.  x, y (B, H, W, C) ->
    (B, H - win + 1, W - win + 1, C)."""
    k = _gaussian_kernel(win_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    x = x.permute(0, 3, 1, 2)
    y = y.permute(0, 3, 1, 2)
    mu_x = _filter2d_sep(x, k)
    mu_y = _filter2d_sep(y, k)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2d_sep(x * x, k) - mu_xx
    sigma_yy = _filter2d_sep(y * y, k) - mu_yy
    sigma_xy = _filter2d_sep(x * y, k) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    m = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return m.permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         mask: Optional[torch.Tensor] = None, win_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per image, (B,).  With ``mask`` (B, H, W) the map is
    averaged over the windows whose centres are masked (the static-shape
    stand-in for the reference's bounding-box crop)."""
    m = ssim_map(x, y, data_range, win_size, sigma)
    if mask is None:
        return m.mean(dim=(1, 2, 3))
    off = (win_size - 1) // 2
    mc = mask[:, off: off + m.shape[1], off: off + m.shape[2]]
    w = mc[..., None].to(m.dtype)
    num = (m * w).sum(dim=(1, 2, 3))
    den = torch.clamp(w.sum(dim=(1, 2, 3)) * m.shape[-1], min=1.0)
    return num / den
