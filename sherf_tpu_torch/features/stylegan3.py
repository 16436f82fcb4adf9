"""Alias-free (StyleGAN3) synthesis, NCHW (torch counterpart of
``sherf_tpu/features/stylegan3.py``): ``modulated_conv2d``,
``design_lowpass_filter``, ``SynthesisInput``, ``SynthesisLayer``,
``SynthesisNetwork`` and ``SG3Generator`` over the port's StyleGAN2
mapping network.

Each layer's nonlinearity is ``kernels.filters.filtered_lrelu``, the JAX
package's composition of bias, FIR upsample, leaky ReLU and FIR downsample
(the separable Kaiser filters applied as their full 2D outer product, as
there).  The filters are fixed numpy arrays designed at construction, not
parameters.  Parameter and buffer names are the flax ones, so
``compat.flax_bridge.from_flax`` of the JAX variables loads strictly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.features.stylegan2 import EqualDense, MappingNetwork
from sherf_tpu_torch.kernels.filters import conv2d, filtered_lrelu


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor, demodulate: bool = True,
                     padding: int = 0,
                     input_gain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """StyleGAN3's modulated conv.  x (B, Cin, H, W); weight (Cout, Cin,
    kh, kw); styles (B, Cin).  With ``demodulate`` the weight is first
    normalised per output channel and the styles by one mean over the
    whole (B, Cin) tensor, as in the JAX package."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    if demodulate:
        weight = weight * torch.rsqrt(
            (weight * weight).mean(dim=(1, 2, 3), keepdim=True))
        styles = styles * torch.rsqrt((styles * styles).mean())
    w = weight[None] * styles[:, None, :, None, None]   # (B, Cout, Cin, kh, kw)
    if demodulate:
        dcoefs = torch.rsqrt((w * w).sum(dim=(2, 3, 4)) + 1e-8)
        w = w * dcoefs[:, :, None, None, None]
    if input_gain is not None:
        gain = torch.broadcast_to(torch.as_tensor(input_gain, dtype=w.dtype,
                                                  device=w.device), (B, Cin))
        w = w * gain[:, None, :, None, None]
    x = F.pad(x.reshape(1, B * Cin, H, W), [padding] * 4)
    y = conv2d(x, w.reshape(B * Cout, Cin, kh, kw).to(x.dtype), groups=B)
    return y.reshape(B, Cout, y.shape[2], y.shape[3])


def design_lowpass_filter(numtaps: int, cutoff: float, width: float,
                          fs: float, radial: bool = False
                          ) -> Optional[np.ndarray]:
    """Kaiser (separable, 1D) or jinc (radial, 2D) low-pass FIR design, as
    the JAX package designs it: an odd radial filter's centre tap is
    ``cutoff ** 2``.  None for the identity (``numtaps == 1``)."""
    assert numtaps >= 1
    if numtaps == 1:
        return None
    import scipy.signal
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                fs=fs)
        return np.asarray(f, dtype=np.float32)
    import scipy.special
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[r == 0] = cutoff ** 2
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    f = f / np.sum(f)
    return np.asarray(f, dtype=np.float32)


def _size2(size) -> np.ndarray:
    return np.broadcast_to(np.asarray(size), [2])


class SynthesisInput(nn.Module):
    """Fourier-feature input plane with a learned affine transform.  The
    frequencies and phases are fixed buffers drawn from
    ``np.random.RandomState(1234 + channels)``; ``transform`` is the
    user-controllable inverse transform.  forward(w (B, w_dim)) ->
    (B, channels, size[1], size[0])."""

    def __init__(self, w_dim: int, channels: int, size, sampling_rate: float,
                 bandwidth: float):
        super().__init__()
        self.w_dim, self.channels = w_dim, channels
        self.size = _size2(size)
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        rnd = np.random.RandomState(1234 + channels)
        freqs = rnd.randn(channels, 2)
        radii = np.sqrt(np.sum(freqs ** 2, axis=1, keepdims=True))
        freqs = freqs / (radii * np.exp(radii ** 2) ** 0.25) * bandwidth
        phases = rnd.rand(channels) - 0.5
        self.register_buffer("freqs", torch.from_numpy(
            freqs.astype(np.float32)))
        self.register_buffer("phases", torch.from_numpy(
            phases.astype(np.float32)))
        self.register_buffer("transform", torch.eye(3))
        self.weight = nn.Parameter(torch.randn(channels, channels))
        # identity at init: weight 0, bias [1, 0, 0, 0]
        self.affine_weight = nn.Parameter(torch.zeros(4, w_dim))
        self.affine_bias = nn.Parameter(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        sx = 0.5 * self.size[0] / sampling_rate
        sy = 0.5 * self.size[1] / sampling_rate
        gx = (np.arange(self.size[0]) + 0.5) / self.size[0] * 2 - 1
        gy = (np.arange(self.size[1]) + 0.5) / self.size[1] * 2 - 1
        self._grid = np.stack(np.meshgrid(gx * sx, gy * sy, indexing="xy"),
                              axis=-1).astype(np.float32)   # (H, W, 2)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        t = w.float() @ (self.affine_weight.T / np.sqrt(self.w_dim)) \
            + self.affine_bias
        t = t / torch.linalg.norm(t[:, :2], dim=1, keepdim=True)
        z, o = torch.zeros_like(t[:, 0]), torch.ones_like(t[:, 0])
        m_r = torch.stack([torch.stack([t[:, 0], -t[:, 1], z], -1),
                           torch.stack([t[:, 1], t[:, 0], z], -1),
                           torch.stack([z, z, o], -1)], -2)
        m_t = torch.stack([torch.stack([o, z, -t[:, 2]], -1),
                           torch.stack([z, o, -t[:, 3]], -1),
                           torch.stack([z, z, o], -1)], -2)
        transforms = m_r @ m_t @ self.transform[None]

        phases = self.phases[None] + (
            self.freqs[None] @ transforms[:, :2, 2:]).squeeze(-1)
        freqs = self.freqs[None] @ transforms[:, :2, :2]
        amplitudes = torch.clamp(
            1 - (torch.linalg.norm(freqs, dim=2) - self.bandwidth)
            / (self.sampling_rate / 2 - self.bandwidth), 0, 1)

        grid = torch.as_tensor(self._grid, device=w.device)
        x = torch.einsum("hwk,bck->bhwc", grid, freqs)
        x = x + phases[:, None, None, :]
        x = torch.sin(x * (2 * np.pi))
        x = x * amplitudes[:, None, None, :]
        x = x @ (self.weight.T / np.sqrt(self.channels))
        return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    """Alias-free layer: modulated conv -> ``filtered_lrelu`` with Kaiser
    (or, with ``use_radial_filters`` off the critically sampled layers,
    jinc) filters designed from the layer's cutoff and stopband.
    ``magnitude_ema`` is a buffer, updated only under ``update_emas``."""

    def __init__(self, w_dim: int, is_torgb: bool,
                 is_critically_sampled: bool, in_channels: int,
                 out_channels: int, in_size, out_size,
                 in_sampling_rate: float, out_sampling_rate: float,
                 in_cutoff: float, out_cutoff: float, in_half_width: float,
                 out_half_width: float, conv_kernel: int = 3,
                 filter_size: int = 6, lrelu_upsampling: int = 2,
                 use_radial_filters: bool = False,
                 conv_clamp: Optional[float] = 256.0,
                 magnitude_ema_beta: float = 0.999,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.is_torgb, self.out_channels = is_torgb, out_channels
        self.in_size, self.out_size = _size2(in_size), _size2(out_size)
        self.conv_clamp, self.magnitude_ema_beta = conv_clamp, magnitude_ema_beta
        self.dtype = dtype
        self.conv_kernel = 1 if is_torgb else conv_kernel
        tmp_rate = max(in_sampling_rate, out_sampling_rate) \
            * (1 if is_torgb else lrelu_upsampling)

        self.up_factor = int(np.rint(tmp_rate / in_sampling_rate))
        up_taps = filter_size * self.up_factor \
            if self.up_factor > 1 and not is_torgb else 1
        up_filter = design_lowpass_filter(up_taps, in_cutoff,
                                          in_half_width * 2, tmp_rate)
        self.down_factor = int(np.rint(tmp_rate / out_sampling_rate))
        down_taps = filter_size * self.down_factor \
            if self.down_factor > 1 and not is_torgb else 1
        down_filter = design_lowpass_filter(
            down_taps, out_cutoff, out_half_width * 2, tmp_rate,
            radial=use_radial_filters and not is_critically_sampled)
        # separable Kaiser filters applied as their full 2D outer product
        if up_filter is not None and up_filter.ndim == 1:
            up_filter = np.outer(up_filter, up_filter)
        if down_filter is not None and down_filter.ndim == 1:
            down_filter = np.outer(down_filter, down_filter)
        self.up_filter, self.down_filter = up_filter, down_filter

        pad_total = (self.out_size - 1) * self.down_factor + 1
        pad_total = pad_total - (self.in_size + self.conv_kernel - 1) \
            * self.up_factor
        pad_total = pad_total + up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]),
                        int(pad_hi[1])]

        self.affine = EqualDense(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(
            out_channels, in_channels, self.conv_kernel, self.conv_kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                update_emas: bool = False) -> torch.Tensor:
        if update_emas:
            with torch.no_grad():
                mag = (x.detach().float() ** 2).mean()
                self.magnitude_ema.copy_(
                    mag + (self.magnitude_ema - mag) * self.magnitude_ema_beta)
        input_gain = torch.rsqrt(self.magnitude_ema)

        styles = self.affine(w.float())
        if self.is_torgb:
            styles = styles / np.sqrt(self.weight.shape[1]
                                      * self.conv_kernel ** 2)
        x = modulated_conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                             styles.to(self.dtype),
                             demodulate=not self.is_torgb,
                             padding=self.conv_kernel - 1,
                             input_gain=input_gain)
        x = filtered_lrelu(
            x, fu=self.up_filter, fd=self.down_filter,
            b=self.bias.to(x.dtype), up=self.up_factor,
            down=self.down_factor, padding=self.padding,
            gain=1.0 if self.is_torgb else float(np.sqrt(2)),
            slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)
        assert x.shape == (w.shape[0], self.out_channels,
                           int(self.out_size[1]), int(self.out_size[0])), \
            x.shape
        return x


def _layer_specs(img_resolution: int, channel_base: int, channel_max: int,
                 num_layers: int, num_critical: int, first_cutoff: float,
                 first_stopband: float, last_stopband_rel: float,
                 margin_size: int, img_channels: int):
    """The geometric cutoff / stopband progression: per layer (and the
    input), cutoffs, half widths, sampling rates, sizes and channels."""
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(
        np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    sampling_rates = np.exp2(np.ceil(np.log2(
        np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = sampling_rates + margin_size * 2
    sizes[-2:] = img_resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    return cutoffs, half_widths, sampling_rates, sizes.astype(int), \
        channels.astype(int)


class SynthesisNetwork(nn.Module):
    """ws (B, num_layers + 2, w_dim) -> (B, img_channels, R, R); the layers
    are named ``L{idx}_{size}_{channels}`` as in the JAX package."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 num_layers: int = 14, num_critical: int = 2,
                 first_cutoff: float = 2.0, first_stopband: float = 2 ** 2.1,
                 last_stopband_rel: float = 2 ** 0.3, margin_size: int = 10,
                 output_scale: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.output_scale = num_layers, output_scale
        self.num_ws = num_layers + 2
        cutoffs, half_widths, rates, sizes, channels = _layer_specs(
            img_resolution, channel_base, channel_max, num_layers,
            num_critical, first_cutoff, first_stopband, last_stopband_rel,
            margin_size, img_channels)
        self.input = SynthesisInput(w_dim, int(channels[0]), int(sizes[0]),
                                    float(rates[0]), float(cutoffs[0]))
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            name = f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}"
            self.add_module(name, SynthesisLayer(
                w_dim=w_dim, is_torgb=idx == num_layers,
                is_critically_sampled=idx >= num_layers - num_critical,
                in_channels=int(channels[prev]),
                out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=float(rates[prev]),
                out_sampling_rate=float(rates[idx]),
                in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
                in_half_width=float(half_widths[prev]),
                out_half_width=float(half_widths[idx]), dtype=dtype))
            self.layer_names.append(name)

    def forward(self, ws: torch.Tensor, update_emas: bool = False):
        ws = ws.float()
        x = self.input(ws[:, 0])
        for idx, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, idx + 1], update_emas=update_emas)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class SG3Generator(nn.Module):
    """z (B, z_dim) -> image (B, img_channels, R, R): the port's StyleGAN2
    mapping network (2 layers) and the alias-free synthesis network."""

    def __init__(self, z_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, num_layers: int = 14,
                 channel_base: int = 32768, channel_max: int = 512,
                 mapping_layers: int = 2, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.synthesis = SynthesisNetwork(
            w_dim, img_resolution, img_channels, channel_base=channel_base,
            channel_max=channel_max, num_layers=num_layers, dtype=dtype)
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim,
                                      num_ws=self.synthesis.num_ws,
                                      num_layers=mapping_layers)
        if generator is not None:
            self.redraw_(generator)
        self.to(device)

    @torch.no_grad()
    def redraw_(self, generator: torch.Generator) -> "SG3Generator":
        """Redraw every randomly initialised parameter as the JAX package
        initialises it (the convolutions' and the input's unit-scale
        ``weight``, the FC layers' N(0, 1 / lr_multiplier)), from
        ``generator`` only; the constant biases and the input's zero
        affine keep their values."""
        for m in self.modules():
            std = None
            if isinstance(m, EqualDense):
                std = 1.0 / m.lr_multiplier
            elif isinstance(m, (SynthesisLayer, SynthesisInput)):
                std = 1.0
            if std is not None:
                val = torch.randn(tuple(m.weight.shape), generator=generator)
                m.weight.copy_(val * std)
        return self

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                update_emas: bool = False) -> torch.Tensor:
        ws = self.mapping(z, truncation_psi=truncation_psi)
        return self.synthesis(ws, update_emas=update_emas)
