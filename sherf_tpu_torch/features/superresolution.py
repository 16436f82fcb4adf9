"""EG3D's hybrid super-resolution head (torch counterpart of
``sherf_tpu/features/superresolution.py``): a bilinear resize of the
rendered image to the head's input resolution, then two StyleGAN2 synthesis
blocks conditioned on the last w.  The variant follows the output
resolution: 128 -> 2X (input 64), 256 -> 4X (input 128), both with a first
block that does not upsample; 512 -> 8XDC (input 128, both blocks upsample;
``deep_channels=False`` is 8X).  Inputs and output are NHWC, as in the JAX
package; the blocks run NCHW in f32 with no conv clamp.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.features.stylegan2 import (
    DEFAULT_FILTER, SynthesisLayer, ToRGBLayer)
from sherf_tpu_torch.kernels.filters import upsample2d


def resize_bilinear(x: torch.Tensor, size: int, antialias: bool = True):
    """(B, H, W, C) -> (B, size, size, C): ``jax.image.resize(...,
    "linear", antialias)``, i.e. bilinear with half-pixel centres and, when
    shrinking, a triangle kernel widened by the scale."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False,
                      antialias=antialias)
    return y.permute(0, 2, 3, 1)


class SRSynthesisBlock(nn.Module):
    """Two synthesis layers and a toRGB; with ``up=False`` neither the
    features nor the skip image are upsampled."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, up: bool = True):
        super().__init__()
        self.up = up
        self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim,
                                    resolution, up=2 if up else 1,
                                    conv_clamp=None)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim,
                                    resolution, conv_clamp=None)
        self.torgb = ToRGBLayer(out_channels, 3, w_dim, conv_clamp=None)

    def forward(self, x, img, ws, noise_mode: str = "none",
                fused_modconv: bool = True):
        """x (B, C, h, w), img (B, 3, h, w) NCHW; ws (B, 3, w_dim)."""
        w0, w1, w2 = ws.unbind(dim=1)
        x = self.conv0(x, w0, noise_mode=noise_mode,
                       fused_modconv=fused_modconv)
        x = self.conv1(x, w1, noise_mode=noise_mode,
                       fused_modconv=fused_modconv)
        if self.up:
            img = upsample2d(img, DEFAULT_FILTER)
        return x, img + self.torgb(x, w2, fused_modconv=fused_modconv)


class SuperresolutionHybrid(nn.Module):
    def __init__(self, img_resolution: int = 512, channels: int = 32,
                 w_dim: int = 512, deep_channels: bool = True,
                 sr_antialias: bool = True):
        super().__init__()
        if img_resolution == 512:
            self.input_res, up0 = 128, True
            ch0, ch1 = (256, 128) if deep_channels else (128, 64)
            res0, res1 = 256, 512
        elif img_resolution == 256:
            self.input_res, up0 = 128, False
            ch0, ch1, res0, res1 = 128, 64, 128, 256
        elif img_resolution == 128:
            self.input_res, up0 = 64, False
            ch0, ch1, res0, res1 = 128, 64, 64, 128
        else:
            raise ValueError(f"unsupported SR resolution {img_resolution}")
        self.sr_antialias = sr_antialias
        self.block0 = SRSynthesisBlock(channels, ch0, w_dim, res0, up=up0)
        self.block1 = SRSynthesisBlock(ch0, ch1, w_dim, res1, up=True)

    def forward(self, rgb, x, ws, noise_mode: str = "none",
                fused_modconv: bool = True):
        """rgb (B, h, w, 3), x (B, h, w, C) feature image, ws (B, num_ws,
        w_dim) -> (B, img_resolution, img_resolution, 3) f32."""
        ws = ws[:, -1:].float().expand(-1, 3, -1)
        if x.shape[1] != self.input_res:
            x = resize_bilinear(x.float(), self.input_res, self.sr_antialias)
            rgb = resize_bilinear(rgb.float(), self.input_res,
                                  self.sr_antialias)
        x, rgb = (t.float().permute(0, 3, 1, 2) for t in (x, rgb))
        x, rgb = self.block0(x, rgb, ws, noise_mode=noise_mode,
                             fused_modconv=fused_modconv)
        x, rgb = self.block1(x, rgb, ws, noise_mode=noise_mode,
                             fused_modconv=fused_modconv)
        return rgb.permute(0, 2, 3, 1)
