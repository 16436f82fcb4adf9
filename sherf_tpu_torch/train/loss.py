"""Reconstruction loss stack (torch counterpart of
``sherf_tpu/train/loss.py``): the reference objective with its GAN terms at
zero,

  100 * MSE(masked raw rgb) + 10 * MSE(accumulated weights vs fg mask)
  + (1 - SSIM) + LPIPS,

with the SSIM/LPIPS person crop taken as a mask weight.  ``lpips_fn=None``
gives LPIPS 0, as the JAX package does when no VGG weights exist.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from sherf_tpu_torch.core.config import TrainConfig
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.train.ssim import ssim


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def reconstruction_loss(out: Dict, batch: SHERFBatch, tcfg: TrainConfig,
                        lpips_fn=None) -> Tuple[torch.Tensor, Dict]:
    """out: the generator's image dict -> (scalar loss, metrics dict with
    loss, img_loss, acc_loss, ssim, lpips, psnr)."""
    B, H, W, _ = out["image_raw"].shape
    pred = out["image_raw"] / 2.0 + 0.5          # back to [0, 1]
    gt = batch.img
    mask = batch.mask_at_box.reshape(B, H, W).to(pred.dtype)
    fg = (batch.bkgd_msk.reshape(B, H, W) != 0).to(pred.dtype)

    denom = torch.clamp(mask.sum(), min=1.0)
    img_loss = (((pred - gt) ** 2) * mask[..., None]).sum() / (denom * 3.0)
    acc_loss = (((out["weights_image"].reshape(B, H, W) - fg) ** 2)
                * mask).sum() / denom

    ssim_val = ssim(pred, gt, data_range=1.0, mask=mask)  # (B,)
    ssim_loss = torch.mean(1.0 - ssim_val)

    lpips_loss = torch.zeros((), dtype=pred.dtype, device=pred.device)
    if lpips_fn is not None:
        m = mask[..., None]
        lpips_loss = torch.mean(lpips_fn(out["image_raw"] * m,
                                         (gt * 2.0 - 1.0) * m))

    total = (tcfg.w_img * img_loss + tcfg.w_acc * acc_loss
             + tcfg.w_ssim * ssim_loss + tcfg.w_lpips * lpips_loss)
    metrics = {
        "loss": total,
        "img_loss": img_loss,
        "acc_loss": acc_loss,
        "ssim": torch.mean(ssim_val),
        "lpips": lpips_loss,
        "psnr": mse2psnr(img_loss),
    }
    return total, metrics
