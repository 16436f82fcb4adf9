"""Host-side eval metrics (torch port's copy of ``sherf_tpu/eval/metrics.py``;
reference test_loop.py:36-84).

  * PSNR over mask_at_box pixels (img2mse + mse2psnr);
  * SSIM as skimage.structural_similarity(multichannel=True) on the
    person crop (the bounding box of the mask's nonzero pixels, what
    ``cv2.boundingRect`` returns).  The reference passes float images
    without ``data_range``, so legacy skimage assumes the float dtype's
    range of 2.0: ``data_range=2.0`` keeps that quirk for number parity;
  * LPIPS on the same crop, on the caller's device, when VGG weights exist
    (``train/lpips.py``); None without them, as in the JAX package.

NumPy (no cv2) and, for LPIPS, torch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def psnr_np(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    mse = float(np.mean((pred[mask] - gt[mask]) ** 2))
    return float(-10.0 * np.log(mse) / np.log(10.0))


def _uniform_filter(x: np.ndarray, win: int) -> np.ndarray:
    """Valid-mode win x win mean filter via cumsum (2D per channel)."""
    pad = np.cumsum(np.cumsum(x, axis=0), axis=1)
    pad = np.pad(pad, ((1, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2))
    s = (pad[win:, win:] - pad[:-win, win:] - pad[win:, :-win]
         + pad[:-win, :-win])
    return s / (win * win)


def ssim_np(a: np.ndarray, b: np.ndarray, data_range: float = 2.0,
            win: int = 7) -> float:
    """skimage.metrics.structural_similarity with default settings
    (uniform 7x7 window, unbiased covariance, channel-averaged)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    NP = win * win
    cov_norm = NP / (NP - 1)
    ux = _uniform_filter(a, win)
    uy = _uniform_filter(b, win)
    uxx = _uniform_filter(a * a, win)
    uyy = _uniform_filter(b * b, win)
    uxy = _uniform_filter(a * b, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = (((2 * ux * uy + C1) * (2 * vxy + C2))
         / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2)))
    return float(S.mean())


def bounding_rect(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of the nonzero pixels of a 2D mask; (0, 0, 0, 0) when
    there are none (``cv2.boundingRect`` of a mask image)."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return 0, 0, 0, 0
    x0, y0 = int(xs.min()), int(ys.min())
    return x0, y0, int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1


_LPIPS = {}


def _lpips_model(device):
    """The LPIPS module on ``device`` (built once; None without weights)."""
    key = str(device)
    if key not in _LPIPS:
        # imported here: the train package imports this one
        from sherf_tpu_torch.train.lpips import make_lpips
        _LPIPS[key] = make_lpips(device)
    return _LPIPS[key]


def crop_metrics(img_pred: np.ndarray, img_gt: np.ndarray,
                 mask_at_box: np.ndarray, device="cuda"
                 ) -> Tuple[float, Optional[float]]:
    """(SSIM, LPIPS or None) on the person crop (test_loop.ssim_metric:67-84);
    LPIPS runs on ``device``."""
    x, y, w, h = bounding_rect(mask_at_box)
    crop_pred = img_pred[y:y + h, x:x + w]
    crop_gt = img_gt[y:y + h, x:x + w]
    s = ssim_np(crop_pred, crop_gt)
    model = _lpips_model(device)
    if model is None:
        return s, None
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(
        device) * 2 - 1
    with torch.no_grad():
        lp = float(model(to(crop_pred), to(crop_gt))[0])
    return s, lp
