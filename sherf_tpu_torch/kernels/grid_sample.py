"""Bilinear / trilinear sampling with zeros padding (torch counterpart of
``sherf_tpu/kernels/grid_sample.py``; plain torch).

Channels-last like the JAX package: an image is (H, W, C), a volume
(D, H, W, C), coordinates are normalized to [-1, 1] in (x, y[, z]) order with
x indexing the last spatial axis.  ``grid_sample_2d`` and
``grid_sample_3d`` take f32 weights and return f32 (the JAX
``grid_sample_2d`` promotes the same way).  The corner-packed, x-packed and
multi-hot variants of the JAX package are TPU gather-count tricks and are
not ported; the one place where the packed form rounds differently, the
triplane sampler's low-precision weights, is :func:`triplane_sample_2d`.
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _taps_2d(img, ix, iy):
    H, W, C = img.shape
    ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
    vals = img.reshape(H * W, C).index_select(0, flat).float()
    return vals * ok[:, None]


def _cell_2d(img, coords, align_corners: bool):
    """Each point's top-left tap (x0, y0) and its f32 fractions (wx, wy)."""
    x = _unnormalize(coords[:, 0].float(), img.shape[1], align_corners)
    y = _unnormalize(coords[:, 1].float(), img.shape[0], align_corners)
    x0f, y0f = torch.floor(x), torch.floor(y)
    return x0f.long(), y0f.long(), (x - x0f)[:, None], (y - y0f)[:, None]


def grid_sample_2d(img: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """img (H, W, C), coords (N, 2) -> (N, C) f32."""
    x0, y0, wx, wy = _cell_2d(img, coords, align_corners)
    v00 = _taps_2d(img, x0, y0)
    v01 = _taps_2d(img, x0 + 1, y0)
    v10 = _taps_2d(img, x0, y0 + 1)
    v11 = _taps_2d(img, x0 + 1, y0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def triplane_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The triplane sampler's bilinear lookup in the plane's dtype (bf16 on
    the production path): plane (H, W, C), coords (N, 2), align_corners
    False -> (N, C) in ``plane.dtype``.

    Computes what the JAX corner-packed sampler ``grid_sample_2d_packed``
    computes, in the four-tap form: the fractions ``wx``, ``wy`` are rounded
    to the plane's dtype, the four tap weights ``(1 - wx or wx) * (1 - wy or
    wy)`` are formed in that dtype, and the four-tap sum is a dot product in
    that dtype (f32 products and accumulation, one rounding at the end)."""
    dtype = plane.dtype
    x0, y0, wx, wy = _cell_2d(plane, coords, align_corners=False)
    wx, wy = wx.to(dtype), wy.to(dtype)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            w = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            term = w.float() * _taps_2d(plane, x0 + dx, y0 + dy)
            out = term if out is None else out + term
    return out.to(dtype)


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """vol (D, H, W, C), coords (N, 3) (x->W, y->H, z->D) -> (N, C)."""
    D, H, W, C = vol.shape
    x = _unnormalize(coords[:, 0].float(), W, align_corners)
    y = _unnormalize(coords[:, 1].float(), H, align_corners)
    z = _unnormalize(coords[:, 2].float(), D, align_corners)
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    wx = (x - x0f)[:, None]
    wy = (y - y0f)[:, None]
    wz = (z - z0f)[:, None]
    flatv = vol.reshape(D * H * W, C)

    def corner(ix, iy, iz):
        ok = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0)
              & (iz < D))
        f = ((torch.clamp(iz, 0, D - 1) * H + torch.clamp(iy, 0, H - 1)) * W
             + torch.clamp(ix, 0, W - 1))
        return flatv[f].float() * ok[:, None]

    c000 = corner(x0, y0, z0)
    c001 = corner(x0 + 1, y0, z0)
    c010 = corner(x0, y0 + 1, z0)
    c011 = corner(x0 + 1, y0 + 1, z0)
    c100 = corner(x0, y0, z0 + 1)
    c101 = corner(x0 + 1, y0, z0 + 1)
    c110 = corner(x0, y0 + 1, z0 + 1)
    c111 = corner(x0 + 1, y0 + 1, z0 + 1)
    f0 = ((c000 * (1 - wx) + c001 * wx) * (1 - wy)
          + (c010 * (1 - wx) + c011 * wx) * wy)
    f1 = ((c100 * (1 - wx) + c101 * wx) * (1 - wy)
          + (c110 * (1 - wx) + c111 * wx) * wy)
    return f0 * (1 - wz) + f1 * wz
