"""ResNet-18 image encoders (torch counterpart of
``sherf_tpu/features/resnet.py``).

Public layout is the JAX package's NHWC; the convolution stack runs NCHW.
``feature_only=True`` builds just the stem and layer1 — the
``encoder_2d_feature`` role, whose flax parameters hold nothing else.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.features.layers import Conv2d, FrozenBatchNorm


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, channels, 3, stride, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(channels, dtype=dtype)
        self.conv2 = Conv2d(channels, channels, 3, 1, 1, dtype=dtype)
        self.bn2 = FrozenBatchNorm(channels, dtype=dtype)
        self.has_down = stride != 1 or cin != channels
        if self.has_down:
            self.down_conv = Conv2d(cin, channels, 1, stride, 0, dtype=dtype)
            self.down_bn = FrozenBatchNorm(channels, dtype=dtype)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.has_down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class ResNet18(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32,
                 feature_only: bool = False,
                 stage_sizes=(2, 2, 2, 2), channels=(64, 128, 256, 512)):
        super().__init__()
        self.dtype = dtype
        self.feature_only = feature_only
        self.conv1 = Conv2d(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype=dtype)
        self.blocks = []
        cin = 64
        for i, (n_blocks, ch) in enumerate(zip(stage_sizes, channels)):
            if feature_only and i > 0:
                break
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                name = f"layer{i + 1}_{b}"
                self.add_module(name, BasicBlock(cin, ch, stride, dtype))
                self.blocks.append(name)
                cin = ch

    def forward(self, x: torch.Tensor, extract_feature: bool = False):
        """x (B, H, W, 3).  extract_feature=False -> (B, 512) embedding;
        True -> (B, H/2, W/2, 64) map (maxpool skipped, stop after layer1)."""
        if extract_feature != self.feature_only:
            raise ValueError("build ResNet18(feature_only=True) for "
                             "extract_feature=True, and only for it")
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        if not extract_feature:
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        if extract_feature:
            return x.permute(0, 2, 3, 1)
        return x.mean(dim=(2, 3))
