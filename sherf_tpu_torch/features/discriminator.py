"""StyleGAN2 discriminator and EG3D's dual discriminator (torch counterpart
of ``sherf_tpu/features/discriminator.py``), NCHW inside.

The modules carry the flax names (``disc``, ``b{res}``, ``fromrgb``,
``skip``, ``conv0``, ``conv1``, ``conv``, ``fc``, ``out``), so
``compat.flax_bridge.from_flax`` carries a JAX discriminator's variables
across.  flax infers ``fc``'s input width from its first input; here it is
computed at construction from ``img_resolution`` (the size of the images
D sees) with the blocks' own resampling arithmetic, and ``fc`` reads the
final map flattened in (h, w, c) order, as the JAX module flattens its
NHWC map.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from sherf_tpu_torch.features.stylegan2 import (DEFAULT_FILTER, EqualConv2d,
                                                EqualDense)
from sherf_tpu_torch.features.superresolution import resize_bilinear


def _down2(n: int) -> int:
    """Output length of a block's 3x3 ``EqualConv2d(down=2)`` on ``n``
    pixels (its 1x1 skip gives the same): pad by 1 plus the FIR's
    (fw - 1) // 2 and (fw - 2) // 2, the conv, the FIR, then every second
    sample."""
    fw = DEFAULT_FILTER.shape[1]
    n = n + 2 + (fw - 1) // 2 + (fw - 2) // 2 - 2 - (fw - 1)
    return -(-n // 2)


class DiscriminatorBlock(nn.Module):
    """resnet-architecture block: (fromrgb) -> skip (1x1, down 2) +
    conv0 (3x3) -> conv1 (3x3, down 2), both branches at gain sqrt(0.5)."""

    def __init__(self, tmp_channels: int, out_channels: int,
                 first: bool = False, img_channels: int = 3):
        super().__init__()
        self.first = first
        if first:
            self.fromrgb = EqualConv2d(img_channels, tmp_channels, 1,
                                       activation="lrelu")
        self.skip = EqualConv2d(tmp_channels, out_channels, 1, bias=False,
                                down=2)
        self.conv0 = EqualConv2d(tmp_channels, tmp_channels, 3,
                                 activation="lrelu")
        self.conv1 = EqualConv2d(tmp_channels, out_channels, 3,
                                 activation="lrelu", down=2)

    def forward(self, x: Optional[torch.Tensor],
                img: torch.Tensor) -> torch.Tensor:
        if self.first:
            y = self.fromrgb(img)
            x = y if x is None else x + y
        gain = float(np.sqrt(0.5))
        skip = self.skip(x, gain=gain)
        x = self.conv1(self.conv0(x), gain=gain)
        return skip + x


def minibatch_stddev(x: torch.Tensor, group_size: Optional[int] = 1,
                     num_channels: int = 1) -> torch.Tensor:
    """Append the per-group feature stddev as ``num_channels`` channels.
    x: (N, C, H, W)."""
    N, C, H, W = x.shape
    G = min(group_size or N, N)
    F = num_channels
    y = x.reshape(G, -1, F, C // F, H, W)
    y = y - y.mean(dim=0)
    y = torch.sqrt((y * y).mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4))                       # (n, F)
    y = y.reshape(-1, F, 1, 1).repeat(G, 1, H, W)
    return torch.cat([x, y], dim=1)


class Discriminator(nn.Module):
    """Unconditional StyleGAN2 discriminator of img_resolution x
    img_resolution images (resnet blocks from ``img_resolution`` down to
    8, then the minibatch-stddev / conv / fc / out epilogue).  A
    resolution that is not a power of two still gives
    ``int(log2(img_resolution)) - 2`` blocks and a final map that is not
    4x4.  forward: (N, C, R, R) -> (N, 1) logits."""

    def __init__(self, img_resolution: int = 512, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512,
                 mbstd_group_size: Optional[int] = 1):
        super().__init__()
        log2 = int(np.log2(img_resolution))
        self.resolutions = [2 ** i for i in range(log2, 2, -1)]
        ch = {res: min(channel_base // res, channel_max)
              for res in self.resolutions + [4]}
        for i, res in enumerate(self.resolutions):
            setattr(self, f"b{res}", DiscriminatorBlock(
                ch[res], ch[res // 2], first=(i == 0),
                img_channels=img_channels))
        self.in_size = (img_resolution, img_resolution)
        n = img_resolution
        for _ in self.resolutions:
            n = _down2(n)
        self.mbstd_group_size = mbstd_group_size
        mb = 1 if mbstd_group_size else 0
        self.conv = EqualConv2d(ch[4] + mb, ch[4], 3, activation="lrelu")
        self.fc = EqualDense(ch[4] * n * n, ch[4], activation="lrelu")
        self.out = EqualDense(ch[4], 1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        if tuple(img.shape[2:]) != self.in_size:
            raise ValueError(f"Discriminator built for {self.in_size} "
                             f"images got {tuple(img.shape[2:])}")
        x = None
        for res in self.resolutions:
            x = getattr(self, f"b{res}")(x, img)
        if self.mbstd_group_size:
            x = minibatch_stddev(x, self.mbstd_group_size)
        x = self.conv(x)
        # (h, w, c) order, as the JAX module flattens its NHWC map
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(self.fc(x))


class DualDiscriminator(nn.Module):
    """Discriminates the image concatenated with the raw render resized to
    it (antialiased bilinear, square).  forward(image, image_raw) takes
    NHWC images, as the generator returns them; (N, 1) logits.  A
    non-square image raises ``ValueError`` (the JAX module fails on it at
    the concat)."""

    def __init__(self, img_resolution: int = 512, channel_base: int = 32768,
                 channel_max: int = 512):
        super().__init__()
        self.img_resolution = img_resolution
        self.disc = Discriminator(img_resolution, img_channels=6,
                                  channel_base=channel_base,
                                  channel_max=channel_max)

    def forward(self, image: torch.Tensor,
                image_raw: torch.Tensor) -> torch.Tensor:
        if image.shape[1] != image.shape[2]:
            raise ValueError(f"DualDiscriminator needs square images; got "
                             f"image of shape {tuple(image.shape)} (NHWC)")
        raw_up = resize_bilinear(image_raw, image.shape[1], antialias=True)
        pair = torch.cat([image, raw_up], dim=-1)
        return self.disc(pair.permute(0, 3, 1, 2))
