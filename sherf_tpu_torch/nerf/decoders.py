"""NeRF decoders (torch counterpart of ``sherf_tpu/nerf/decoders.py``): the
production ``NeRFDecoder``, an 8x128 MLP with a skip at layer 4 and a
view-conditioned rgb branch, and ``OSGDecoder``, EG3D's two-layer softplus
head of the ``use_nerf_decoder=False`` branch."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.features.layers import Dense
from sherf_tpu_torch.features.stylegan2 import EqualDense

SIGMOID_WIDEN = 0.001


class OSGDecoder(nn.Module):
    """Mean over the planes -> EqualDense(64) -> softplus -> EqualDense(4):
    sigma and the widened sigmoid of three colours."""

    def __init__(self, n_features: int = 32, hidden_dim: int = 64,
                 out_dim: int = 3, lr_multiplier: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc0 = EqualDense(n_features, hidden_dim,
                              lr_multiplier=lr_multiplier)
        self.fc1 = EqualDense(hidden_dim, 1 + out_dim,
                              lr_multiplier=lr_multiplier)
        self.dtype = dtype

    def forward(self, sampled_features, ray_directions=None):
        """sampled_features (n_planes, N, C) -> {"rgb": (N, 3) f32,
        "sigma": (N, 1) f32}; the directions are not read."""
        x = sampled_features.float().mean(dim=0).to(self.dtype)
        x = self.fc1(F.softplus(self.fc0(x))).float()
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * SIGMOID_WIDEN) - SIGMOID_WIDEN
        return {"rgb": rgb, "sigma": x[..., 0:1]}


class NeRFDecoder(nn.Module):
    """pts branch = posenc (39) + plane-0 feature (32); view branch =
    feature (128) + viewenc (27) + plane-1 feature (32)."""

    def __init__(self, width: int = 128, n_features: int = 32,
                 pts_dim: int = 39, view_dim: int = 27, skips=(4,),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skips = tuple(skips)
        x_dim = pts_dim + n_features
        cin = x_dim
        for i in range(8):
            self.add_module(f"pts_{i}", Dense(cin, width, dtype=dtype))
            cin = width + (x_dim if i in self.skips else 0)
        self.alpha = Dense(cin, 1, dtype=dtype)
        self.feature = Dense(cin, width, dtype=dtype)
        self.views = Dense(width + view_dim + n_features, width // 2,
                           dtype=dtype)
        self.rgb = Dense(width // 2, 3, dtype=dtype)

    def forward(self, pts_enc, sampled_features, view_enc):
        """pts_enc (N, 39); sampled_features (n_planes, N, 32); view_enc
        (N, 27) -> {"rgb": (N, 3) f32, "sigma": (N, 1) f32}."""
        x = torch.cat([pts_enc.float(), sampled_features[0].float()], dim=-1)
        h = x
        for i in range(8):
            h = F.relu(getattr(self, f"pts_{i}")(h))
            if i in self.skips:
                h = torch.cat([x.to(h.dtype), h], dim=-1)
        sigma = self.alpha(h).float()
        feature = self.feature(h)
        h = torch.cat([feature, view_enc.to(feature.dtype),
                       sampled_features[1].to(feature.dtype)], dim=-1)
        h = F.relu(self.views(h))
        rgb = self.rgb(h).float()
        rgb = torch.sigmoid(rgb) * (1 + 2 * SIGMOID_WIDEN) - SIGMOID_WIDEN
        return {"rgb": rgb, "sigma": sigma}
