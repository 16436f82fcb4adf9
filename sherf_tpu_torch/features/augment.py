"""ADA augmentation pipeline, NCHW (torch counterpart of
``sherf_tpu/features/augment.py``).

The same knobs, defaults, probability semantics and transforms as the JAX
pipe: pixel blitting (x-flip, 90-degree rotations, integer translation),
geometric (scaling, rotation before and after the anisotropic scaling,
fractional translation), colour (brightness, contrast, luma flip, hue,
saturation), the four-band image filter, additive noise and cutout.  All
geometric transforms compose into one 3x3 matrix per image, inverted in
float32 and applied by one zero-padded bilinear gather on pixel centres;
the colour transforms compose into one 4x4 matrix.

Randomness comes from a draw source with ``uniform(shape)`` and
``normal(shape)``, called in the JAX pipe's order with its shapes (the
noise image is drawn (B, H, W, C), as there).  :class:`Draws` wraps a
``torch.Generator`` on the images' device and can record what it drew;
:class:`ReplayDraws` hands back recorded draws, which is how a run is
repeated on another device or held to the JAX pipe value for value.

The ADA feedback controller is :func:`ada_adjust`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from sherf_tpu_torch.kernels.filters import conv2d


# ---------------------------------------------------------------------------
# 2D / 3D homogeneous transforms (batched over the leading axes)


def translate2d(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return torch.stack([torch.stack([o, z, tx], -1),
                        torch.stack([z, o, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def scale2d(sx, sy):
    z = torch.zeros_like(sx)
    return torch.stack([torch.stack([sx, z, z], -1),
                        torch.stack([z, sy, z], -1),
                        torch.stack([z, z, torch.ones_like(sx)], -1)], -2)


def rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def translate3d(v):
    m = torch.eye(4, dtype=v.dtype, device=v.device).expand(
        v.shape[:-1] + (4, 4)).clone()
    m[..., :3, 3] = v
    return m


def scale3d(v):
    m = torch.eye(4, dtype=v.dtype, device=v.device).expand(
        v.shape[:-1] + (4, 4)).clone()
    m[..., [0, 1, 2], [0, 1, 2]] = v
    return m


def rotate3d(axis, theta):
    """Rodrigues rotation of ``theta`` about ``axis`` (..., 3), as a 4x4."""
    v = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1.0 - c
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    rows = [
        torch.stack([vx * vx * cc + c, vx * vy * cc - vz * s,
                     vx * vz * cc + vy * s, z], -1),
        torch.stack([vy * vx * cc + vz * s, vy * vy * cc + c,
                     vy * vz * cc - vx * s, z], -1),
        torch.stack([vz * vx * cc - vy * s, vz * vy * cc + vx * s,
                     vz * vz * cc + c, z], -1),
        torch.stack([z, z, z, o], -1),
    ]
    return torch.stack(rows, -2)


def _affine_sample(img: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
    """Warp (B, C, H, W) by the inverse transforms ``g_inv`` (B, 3, 3)
    acting on centred pixel coordinates (x right, y down, origin at the
    image centre): bilinear, zero outside the image."""
    B, C, H, W = img.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    coords = torch.stack([xs - cx, ys - cy, torch.ones_like(xs)],
                         0).reshape(3, -1)
    src = g_inv @ coords                                    # (B, 3, H*W)
    sx = src[:, 0] / src[:, 2] + cx
    sy = src[:, 1] / src[:, 2] + cy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = img.reshape(B, C, H * W)

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = torch.clamp(xi, 0, W - 1).long()
        yi = torch.clamp(yi, 0, H - 1).long()
        idx = (yi * W + xi)[:, None].expand(B, C, H * W)
        return torch.gather(flat, 2, idx) * inside[:, None]

    out = (tap(x0, y0) * ((1 - fx) * (1 - fy))[:, None]
           + tap(x0 + 1, y0) * (fx * (1 - fy))[:, None]
           + tap(x0, y0 + 1) * ((1 - fx) * fy)[:, None]
           + tap(x0 + 1, y0 + 1) * (fx * fy)[:, None])
    return out.reshape(B, C, H, W)


# ---------------------------------------------------------------------------
# draw sources


class Draws:
    """Uniform [0, 1) and standard normal float32 draws from a
    ``torch.Generator`` on ``device``; with ``record`` it keeps each draw,
    in order, in ``self.record``."""

    def __init__(self, generator: torch.Generator, device=None,
                 record: bool = False):
        self.generator = generator
        self.device = torch.device(device if device is not None
                                   else generator.device)
        self.record: Optional[List[Tuple[str, torch.Tensor]]] = \
            [] if record else None

    def _keep(self, kind, t):
        if self.record is not None:
            self.record.append((kind, t))
        return t

    def uniform(self, shape) -> torch.Tensor:
        return self._keep("uniform", torch.rand(
            tuple(shape), generator=self.generator, device=self.device))

    def normal(self, shape) -> torch.Tensor:
        return self._keep("normal", torch.randn(
            tuple(shape), generator=self.generator, device=self.device))


class ReplayDraws:
    """Hands back recorded ``(kind, values)`` draws in order, on
    ``device``; a draw of another kind or shape than the recorded one
    raises."""

    def __init__(self, draws, device="cpu"):
        self._draws = list(draws)
        self._pos = 0
        self.device = torch.device(device)

    def _next(self, kind, shape):
        if self._pos >= len(self._draws):
            raise ValueError(f"draw {self._pos} ({kind} {tuple(shape)}) past "
                             f"the {len(self._draws)} recorded")
        k, v = self._draws[self._pos]
        v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        if k != kind or tuple(v.shape) != tuple(shape):
            raise ValueError(f"draw {self._pos}: asked {kind} "
                             f"{tuple(shape)}, recorded {k} {tuple(v.shape)}")
        self._pos += 1
        return v.to(device=self.device, dtype=torch.float32)

    def uniform(self, shape) -> torch.Tensor:
        return self._next("uniform", shape)

    def normal(self, shape) -> torch.Tensor:
        return self._next("normal", shape)

    @property
    def exhausted(self) -> bool:
        return self._pos == len(self._draws)


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    """Callable: ``pipe(images, p, draws=None, generator=None)`` with images
    (B, C, H, W) in [-1, 1] and p the overall ADA probability.  The draws
    come from ``draws`` if given, else from ``Draws(generator)``, a
    ``torch.Generator`` on the images' device."""

    # pixel blitting
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    # geometric
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    # color
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # image-space filtering
    imgfilter: float = 0.0
    imgfilter_bands: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    # corruptions
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5

    def __call__(self, images: torch.Tensor, p=1.0, draws=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, C, H, W = images.shape
        dev = images.device
        if draws is None:
            if generator is None:
                raise ValueError("AugmentPipe needs draws or a generator")
            draws = Draws(generator, dev)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        eye = lambda n: torch.eye(n, dtype=torch.float32, device=dev)
        ones, zeros = (torch.ones(B, device=dev), torch.zeros(B, device=dev))

        def gate(mult, value, off_value):
            """``value`` with probability mult * p per sample."""
            on = draws.uniform((B,)) < mult * p
            return torch.where(on.reshape((B,) + (1,) * (value.dim() - 1)),
                               value, off_value)

        # ---------------- geometric: compose forward G, invert once
        G = eye(3).expand(B, 3, 3)
        if self.xflip > 0:
            i = torch.floor(draws.uniform((B,)) * 2)
            i = gate(self.xflip, i, torch.zeros_like(i))
            G = scale2d(1 - 2 * i, ones) @ G
        if self.rotate90 > 0:
            i = torch.floor(draws.uniform((B,)) * 4)
            i = gate(self.rotate90, i, torch.zeros_like(i))
            G = rotate2d(-np.pi / 2 * i) @ G
        if self.xint > 0:
            t = (draws.uniform((B, 2)) * 2 - 1) * self.xint_max
            t = gate(self.xint, t, torch.zeros_like(t))
            G = translate2d(torch.round(t[:, 0] * W),
                            torch.round(t[:, 1] * H)) @ G
        if self.scale > 0:
            s = 2.0 ** (draws.normal((B,)) * self.scale_std)
            s = gate(self.scale, s, torch.ones_like(s))
            G = scale2d(s, s) @ G
        # P(pre) = P(post): the two rotations together fire with P rotate*p
        p_rot = 1 - torch.sqrt(torch.clamp(1 - self.rotate * p, 0, 1))
        if self.rotate > 0:
            G = self._rotation(draws, B, p_rot, zeros) @ G
        if self.aniso > 0:
            s = 2.0 ** (draws.normal((B,)) * self.aniso_std)
            s = gate(self.aniso, s, torch.ones_like(s))
            G = scale2d(s, 1.0 / s) @ G
        if self.rotate > 0:
            G = self._rotation(draws, B, p_rot, zeros) @ G
        if self.xfrac > 0:
            t = draws.normal((B, 2)) * self.xfrac_std
            t = gate(self.xfrac, t, torch.zeros_like(t))
            G = translate2d(t[:, 0] * W, t[:, 1] * H) @ G

        if any(v > 0 for v in (self.xflip, self.rotate90, self.xint,
                               self.scale, self.rotate, self.aniso,
                               self.xfrac)):
            images = _affine_sample(images, torch.linalg.inv(G))

        # ---------------- color: one 4x4 matrix in RGB-homogeneous space
        Cm = eye(4).expand(B, 4, 4)
        v_luma = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) / np.sqrt(3.0)
        if self.brightness > 0:
            b = draws.normal((B,)) * self.brightness_std
            b = gate(self.brightness, b, torch.zeros_like(b))
            Cm = translate3d(torch.stack([b, b, b], -1)) @ Cm
        if self.contrast > 0:
            c = 2.0 ** (draws.normal((B,)) * self.contrast_std)
            c = gate(self.contrast, c, torch.ones_like(c))
            Cm = scale3d(torch.stack([c, c, c], -1)) @ Cm
        if self.lumaflip > 0:
            i = torch.floor(draws.uniform((B,)) * 2)
            i = gate(self.lumaflip, i, torch.zeros_like(i))
            house = eye(4) - 2.0 * torch.outer(v_luma, v_luma)
            Cm = torch.where(i[:, None, None] > 0.5, house @ Cm, Cm)
        if self.hue > 0 and C > 1:
            theta = (draws.uniform((B,)) * 2 - 1) * np.pi * self.hue_max
            theta = gate(self.hue, theta, torch.zeros_like(theta))
            Cm = rotate3d(v_luma[:3].expand(B, 3), theta) @ Cm
        if self.saturation > 0 and C > 1:
            s = 2.0 ** (draws.normal((B,)) * self.saturation_std)
            s = gate(self.saturation, s, torch.ones_like(s))
            proj = torch.outer(v_luma, v_luma)
            Cm = (proj[None] + (eye(4)[None] - proj[None])
                  * s[:, None, None]) @ Cm

        if any(v > 0 for v in (self.brightness, self.contrast, self.lumaflip,
                               self.hue, self.saturation)):
            flat = images.reshape(B, C, H * W)
            if C == 3:
                out = torch.einsum("bij,bjn->bin", Cm[:, :3, :3], flat) \
                    + Cm[:, :3, 3, None]
            else:   # grayscale: the mean of the RGB rows
                m = Cm[:, :3, :].mean(1)
                out = flat * m[:, None, :1] + m[:, None, 3:4]
            images = out.reshape(B, C, H, W)

        # ---------------- image-space filtering: 4 frequency bands
        if self.imgfilter > 0:
            amps = []
            for band_mult in self.imgfilter_bands:
                t = 2.0 ** (draws.normal((B,)) * self.imgfilter_std)
                on = draws.uniform((B,)) < self.imgfilter * p * band_mult
                amps.append(torch.where(on, t, torch.ones_like(t)))
            amps = torch.stack(amps, -1)                       # (B, 4)
            # normalised so that the expected energy is kept
            amps = amps / torch.sqrt((amps ** 2).mean(-1, keepdim=True))
            images = _apply_bands(images, _freq_bands(), amps)

        # ---------------- corruptions
        if self.noise > 0:
            sigma = torch.abs(draws.normal((B,))) * self.noise_std
            on = draws.uniform((B,)) < self.noise * p
            sigma = torch.where(on, sigma, torch.zeros_like(sigma))
            noise = draws.normal((B, H, W, C)).permute(0, 3, 1, 2)
            images = images + noise * sigma[:, None, None, None]
        if self.cutout > 0:
            center = draws.uniform((B, 2))
            on = draws.uniform((B,)) < self.cutout * p
            size = torch.where(on, torch.full_like(zeros, self.cutout_size),
                               zeros)
            ys = (torch.arange(H, device=dev) + 0.5) / H
            xs = (torch.arange(W, device=dev) + 0.5) / W
            my = torch.abs(ys[None, :] - center[:, 1:2]) >= size[:, None] / 2
            mx = torch.abs(xs[None, :] - center[:, 0:1]) >= size[:, None] / 2
            mask = (my[:, :, None] | mx[:, None, :]).to(images.dtype)
            images = images * mask[:, None]
        return images

    def _rotation(self, draws, B, p_rot, zeros):
        theta = (draws.uniform((B,)) * 2 - 1) * np.pi * self.rotate_max
        on = draws.uniform((B,)) < p_rot
        return rotate2d(-torch.where(on, theta, zeros))


def _freq_bands() -> List[np.ndarray]:
    """Four 65-tap separable band filters covering [0, pi/8], [pi/8, pi/4],
    [pi/4, pi/2] and [pi/2, pi]: differences of an 8-tap binomial lowpass
    pyramid (float32, as the JAX package builds them)."""
    lo = np.array([1, 8, 28, 56, 70, 56, 28, 8, 1], np.float64)
    lo /= lo.sum()

    def upsample_filter(f, times):
        for _ in range(times):
            g = np.zeros(len(f) * 2 - 1)
            g[::2] = f
            f = np.convolve(g, [0.25, 0.5, 0.25])   # unit-DC interpolator
        return f

    # lowpass[i] cuts at pi / 2^(3-i): lowpass[0] keeps only [0, pi/8]
    lowpass = [np.array([1.0])]
    for i in range(3):
        lowpass.append(np.convolve(lowpass[-1], upsample_filter(lo, i)))
    L = [lowpass[3], lowpass[2], lowpass[1], np.array([1.0])]
    full = len(L[0])
    Lp = [np.pad(f, ((full - len(f)) // 2,) * 2) for f in L]
    bands = [Lp[0], Lp[1] - Lp[0], Lp[2] - Lp[1], Lp[3] - Lp[2]]
    return [np.asarray(b, np.float32) for b in bands]


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of the ``n + 2 pad`` samples of numpy's
    ``np.pad(..., mode="reflect")``, which reflects again (period
    2(n - 1)) where the pad exceeds the size."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _apply_bands(images: torch.Tensor, bands, amps: torch.Tensor
                 ) -> torch.Tensor:
    """Filter (B, C, H, W) with sum_i amps[:, i] * band_i (separable taps,
    numpy-reflect padding by half a filter)."""
    B, C, H, W = images.shape
    out = torch.zeros_like(images)
    x = images.reshape(B * C, 1, H, W)
    for i, f in enumerate(bands):
        k = f.shape[0]
        pad = k // 2
        xp = x[:, :, _reflect_index(H, pad, x.device)][
            :, :, :, _reflect_index(W, pad, x.device)]
        ker = torch.as_tensor(f, device=x.device, dtype=x.dtype)
        xp = conv2d(xp, ker.reshape(1, 1, 1, k))
        xp = conv2d(xp, ker.reshape(1, 1, k, 1))
        out = out + xp.reshape(B, C, H, W) * amps[:, i][:, None, None, None]
    return out


def ada_adjust(p: float, rt: float, target: float, nimg_delta: int,
               ada_kimg: float = 500.0) -> float:
    """ADA feedback controller: nudge p toward keeping E[sign(D(real))] at
    ``target``, by ``nimg_delta / (ada_kimg * 1000)`` a call."""
    adjust = np.sign(rt - target) * nimg_delta / (ada_kimg * 1000.0)
    return float(np.clip(p + adjust, 0.0, 1.0))
