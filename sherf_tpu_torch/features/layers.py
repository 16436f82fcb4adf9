"""Small layers with flax's dtype semantics: parameters are stored in f32
and cast, with the input, to the layer's compute ``dtype`` at call time
(``flax.linen.Dense(dtype=...)`` and friends)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """``flax.linen.Dense``: y = x @ W^T + b in ``dtype`` (None: promote the
    input with the f32 parameters, i.e. f32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """``flax.linen.Conv`` on NCHW tensors, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class FrozenBatchNorm(nn.Module):
    """``flax.linen.BatchNorm(use_running_average=True)`` over ``dim``:
    y = (x - mean) * (scale * rsqrt(var + eps)) + bias, in ``dtype``."""

    def __init__(self, c: int, eps: float = 1e-5, dim: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps, self.dim, self.dtype = eps, dim, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.dim] = -1
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.reshape(shape)).to(self.dtype)


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm`` (eps 1e-6): statistics and output in f32."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__(c, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)
