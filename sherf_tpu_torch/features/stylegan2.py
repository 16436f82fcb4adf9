"""StyleGAN2 triplane backbone (torch counterpart of
``sherf_tpu/features/stylegan2.py``): mapping, skip-architecture synthesis
and ``StyleGAN2Backbone``, NCHW.  Modulated convs run fused (one grouped
conv with per-sample weights, the inference form) or, in training, unfused
(scale the input by the styles, one plain conv, scale by the demodulation
coefficients), as the JAX package does (``fused_modconv=not train``).  The
reference's fp16-above-res-32 policy is bf16 here, as in the JAX package.
Noise modes: "none" and "const".
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from sherf_tpu_torch.kernels.filters import (
    ACTIVATIONS, bias_act, conv2d_resample, setup_filter, upsample2d)

DEFAULT_FILTER = setup_filter([1, 3, 3, 1])


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8):
    return x * torch.rsqrt((x * x).mean(dim=dim, keepdim=True) + eps)


class EqualDense(nn.Module):
    """Equalized-lr FC layer; weight stored (out, in) at unit scale."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_features, in_features)
                                   / lr_multiplier)
        self.bias = (nn.Parameter(torch.full((out_features,), float(bias_init)))
                     if bias else None)
        self.activation = activation
        self.lr_multiplier, self.bias_init = lr_multiplier, float(bias_init)
        self.gain = float(lr_multiplier / np.sqrt(in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ (self.weight.to(x.dtype).T * self.gain)
        b = None
        if self.bias is not None:
            b = (self.bias * self.lr_multiplier).to(x.dtype)
        return bias_act(y, b, dim=-1, act=self.activation)


class EqualConv2d(nn.Module):
    """Equalized-lr conv with optional FIR up/downsampling and bias +
    activation; weight stored (out, in, k, k) at unit scale, runtime gain
    1/sqrt(in * k^2).  ``forward(x, gain)`` scales the activation's gain
    and the clamp by ``gain``.  NCHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, bias: bool = True,
                 activation: str = "linear", up: int = 1, down: int = 1,
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.weight_gain = float(1.0 / np.sqrt(in_channels * kernel_size ** 2))
        self.activation, self.up, self.down = activation, up, down
        self.padding, self.conv_clamp = kernel_size // 2, conv_clamp

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        x = conv2d_resample(x, (self.weight * self.weight_gain).to(x.dtype),
                            f=DEFAULT_FILTER, up=self.up, down=self.down,
                            padding=self.padding,
                            flip_weight=(self.up == 1))
        b = None if self.bias is None else self.bias.to(x.dtype)
        clamp = None if self.conv_clamp is None else self.conv_clamp * gain
        return bias_act(x, b, act=self.activation, clamp=clamp,
                        gain=ACTIVATIONS[self.activation]["def_gain"] * gain)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor, up: int = 1, padding: int = 0,
                     resample_filter: Optional[np.ndarray] = None,
                     demodulate: bool = True, flip_weight: bool = True,
                     noise: Optional[torch.Tensor] = None,
                     fused_modconv: bool = True) -> torch.Tensor:
    """Modulated conv.  x (B, Cin, H, W); weight (Cout, Cin, kh, kw);
    styles (B, Cin)."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    w = weight[None] * styles[:, None, :, None, None]     # (B, Cout, Cin, kh, kw)
    if demodulate:
        dcoefs = torch.rsqrt((w * w).sum(dim=(2, 3, 4)) + 1e-8)
    if not fused_modconv:
        x = x * styles[:, :, None, None].to(x.dtype)
        x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                            padding=padding, flip_weight=flip_weight)
        if demodulate:
            x = x * dcoefs[:, :, None, None].to(x.dtype)
        if noise is not None:
            x = x + noise.to(x.dtype)
        return x
    if demodulate:
        w = w * dcoefs[:, :, None, None, None]
    y = conv2d_resample(x.reshape(1, B * Cin, H, W),
                        w.reshape(B * Cout, Cin, kh, kw).to(x.dtype),
                        f=resample_filter, up=up, padding=padding, groups=B,
                        flip_weight=flip_weight)
    y = y.reshape(B, Cout, y.shape[2], y.shape[3])
    if noise is not None:
        y = y + noise.to(y.dtype)
    return y


class SynthesisLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: int = 1,
                 activation: str = "lrelu", conv_clamp: Optional[float] = 256.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.affine = EqualDense(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.register_buffer("noise_const", torch.from_numpy(
            np.random.RandomState(resolution).randn(resolution, resolution)
            .astype(np.float32)))
        self.up, self.padding = up, kernel_size // 2
        self.activation, self.conv_clamp, self.dtype = activation, conv_clamp, dtype

    def forward(self, x, w, noise_mode: str = "none",
                fused_modconv: bool = True):
        styles = self.affine(w.float())
        noise = None
        if noise_mode == "const":
            noise = (self.noise_const * self.noise_strength)[None, None]
        elif noise_mode != "none":
            raise ValueError(f"unsupported noise_mode {noise_mode!r}")
        x = modulated_conv2d(
            x.to(self.dtype), self.weight.to(self.dtype), styles.to(self.dtype),
            up=self.up, padding=self.padding, resample_filter=DEFAULT_FILTER,
            flip_weight=(self.up == 1), noise=noise,
            fused_modconv=fused_modconv)
        return bias_act(x, self.bias.to(x.dtype), act=self.activation,
                        gain=ACTIVATIONS[self.activation]["def_gain"],
                        clamp=self.conv_clamp)


class ToRGBLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: Optional[float] = 256.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.affine = EqualDense(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.weight_gain = float(1.0 / np.sqrt(in_channels * kernel_size ** 2))
        self.conv_clamp, self.dtype = conv_clamp, dtype

    def forward(self, x, w, fused_modconv: bool = True):
        styles = self.affine(w.float()) * self.weight_gain
        x = modulated_conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                             styles.to(self.dtype), demodulate=False,
                             fused_modconv=fused_modconv)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, img_channels: int, conv_clamp: float = 256.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        if in_channels == 0:
            self.const = nn.Parameter(torch.randn(out_channels, resolution,
                                                  resolution))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim,
                                        resolution, up=2,
                                        conv_clamp=conv_clamp, dtype=dtype)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim,
                                    resolution, conv_clamp=conv_clamp,
                                    dtype=dtype)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim,
                                conv_clamp=conv_clamp, dtype=dtype)

    def forward(self, x, img, ws, noise_mode: str = "none",
                fused_modconv: bool = True):
        w_iter = iter(ws.unbind(dim=1))
        if self.in_channels == 0:
            x = self.const[None].to(self.dtype).expand(ws.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x.to(self.dtype), next(w_iter), noise_mode=noise_mode,
                           fused_modconv=fused_modconv)
        x = self.conv1(x, next(w_iter), noise_mode=noise_mode,
                       fused_modconv=fused_modconv)
        if img is not None:
            img = upsample2d(img, DEFAULT_FILTER)
        y = self.torgb(x, next(w_iter), fused_modconv=fused_modconv).float()
        img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """ws (B, num_ws, w_dim) -> (B, img_channels, R, R) (NCHW)."""

    def __init__(self, w_dim: int = 512, img_resolution: int = 256,
                 img_channels: int = 96, channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 4,
                 use_bf16: bool = False):
        super().__init__()
        log2 = int(np.log2(img_resolution))
        self.block_resolutions = tuple(2 ** i for i in range(2, log2 + 1))
        channels = {res: min(channel_base // res, channel_max)
                    for res in self.block_resolutions}
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)
        self.num_ws = 0
        for res in self.block_resolutions:
            in_ch = channels[res // 2] if res > 4 else 0
            dtype = (torch.bfloat16 if (use_bf16 and res >= fp16_resolution)
                     else torch.float32)
            self.add_module(f"b{res}", SynthesisBlock(
                in_ch, channels[res], w_dim, res, img_channels, dtype=dtype))
            self.num_ws += 1 if res == 4 else 2
        self.num_ws += 1

    def forward(self, ws: torch.Tensor, noise_mode: str = "none",
                fused_modconv: bool = True):
        ws = ws.float()
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            n_conv = 1 if res == 4 else 2
            x, img = getattr(self, f"b{res}")(
                x, img, ws[:, w_idx:w_idx + n_conv + 1], noise_mode=noise_mode,
                fused_modconv=fused_modconv)
            w_idx += n_conv
        return img


class MappingNetwork(nn.Module):
    """z -> ws (B, num_ws, w_dim); the conditioning input is zeroed in SHERF
    configs, so the embed path is omitted (as in the JAX package)."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512, num_ws: int = 14,
                 num_layers: int = 2, lr_multiplier: float = 0.01):
        super().__init__()
        self.num_ws, self.num_layers = num_ws, num_layers
        for idx in range(num_layers):
            self.add_module(f"fc{idx}", EqualDense(
                z_dim if idx == 0 else w_dim, w_dim, activation="lrelu",
                lr_multiplier=lr_multiplier))
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None):
        x = normalize_2nd_moment(z.float())
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        x = x[:, None].expand(-1, self.num_ws, -1)
        if truncation_psi != 1.0:
            if truncation_cutoff is None:
                x = self.w_avg + truncation_psi * (x - self.w_avg)
            else:
                head = self.w_avg + truncation_psi * (
                    x[:, :truncation_cutoff] - self.w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


class StyleGAN2Backbone(nn.Module):
    def __init__(self, z_dim: int = 512, w_dim: int = 512,
                 img_resolution: int = 256, img_channels: int = 96,
                 mapping_layers: int = 2, channel_base: int = 32768,
                 channel_max: int = 512, use_bf16: bool = False):
        super().__init__()
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, channel_base=channel_base,
            channel_max=channel_max, use_bf16=use_bf16)
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim,
                                      num_ws=self.synthesis.num_ws,
                                      num_layers=mapping_layers)

    def forward(self, z, noise_mode: str = "none", **mapping_kwargs):
        return self.synthesis(self.mapping(z, **mapping_kwargs),
                              noise_mode=noise_mode)
