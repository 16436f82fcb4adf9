"""StyleGAN2 resampling primitives in plain torch, NCHW (counterpart of the
``bias_act`` / ``setup_filter`` / ``upfirdn2d`` / ``filter2d`` /
``upsample2d`` / ``downsample2d`` / ``conv2d_resample`` /
``filtered_lrelu`` of ``sherf_tpu/kernels/filters.py``).  Their
convolutions go through ``conv2d``, whose higher-order gradients (R1's)
are convolutions and convolution-backward calls (cuDNN's dgrad and wgrad
on the card).

Semantics follow the JAX functions (padding arithmetic, filter flipping,
gains) so that shared weights reproduce outputs; only the layout differs:
images here are (N, C, H, W) and conv weights (O, I, kh, kw).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_SQRT2 = float(np.sqrt(2))
ACTIVATIONS = {
    "linear": dict(fn=lambda x, a: x, def_alpha=0.0, def_gain=1.0),
    "lrelu": dict(fn=lambda x, a: F.leaky_relu(x, a), def_alpha=0.2,
                  def_gain=_SQRT2),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, *, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """Bias + activation + gain + clamp; ``dim`` is the channel axis."""
    spec = ACTIVATIONS[act]
    alpha = spec["def_alpha"] if alpha is None else float(alpha)
    gain = spec["def_gain"] if gain is None else float(gain)
    if b is not None:
        shape = [1] * x.dim()
        shape[dim] = b.shape[0]
        x = x + b.reshape(shape)
    x = spec["fn"](x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = torch.clamp(x, -clamp, clamp)
    return x


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0) -> np.ndarray:
    """2D FIR filter as a float32 numpy array (1D inputs are outer-producted)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1, ::-1]
    f = f * gain
    return np.ascontiguousarray(f, dtype=np.float32)


def _parse_scaling(s):
    if isinstance(s, int):
        return s, s
    return int(s[0]), int(s[1])


def _parse_padding(p):
    if isinstance(p, int):
        return p, p, p, p
    p = list(p)
    if len(p) == 2:
        return p[0], p[0], p[1], p[1]
    return tuple(p)


class _Conv(torch.autograd.Function):
    """y = conv2d(x, w) (stride 1, no padding), with the gradients below."""

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        return F.conv2d(x, w, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _ConvInput.apply(gy, w, ctx.groups, x.shape)
        if ctx.needs_input_grad[1]:
            gw = _ConvWeight.apply(gy, x, ctx.groups, w.shape)
        return gx, gw, None


class _ConvInput(torch.autograd.Function):
    """gx = the input gradient of conv2d(., w) at gy."""

    @staticmethod
    def forward(ctx, gy, w, groups, x_shape):
        ctx.save_for_backward(gy, w)
        ctx.groups = groups
        return torch.nn.grad.conv2d_input(x_shape, w, gy, groups=groups)

    @staticmethod
    def backward(ctx, ggx):
        gy, w = ctx.saved_tensors
        g_gy = g_w = None
        if ctx.needs_input_grad[0]:
            g_gy = _Conv.apply(ggx, w, ctx.groups)
        if ctx.needs_input_grad[1]:
            g_w = _ConvWeight.apply(gy, ggx, ctx.groups, w.shape)
        return g_gy, g_w, None, None


class _ConvWeight(torch.autograd.Function):
    """gw = the weight gradient of conv2d(x, .) at gy."""

    @staticmethod
    def forward(ctx, gy, x, groups, w_shape):
        ctx.save_for_backward(gy, x)
        ctx.groups = groups
        return torch.nn.grad.conv2d_weight(x, w_shape, gy, groups=groups)

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        g_gy = g_x = None
        if ctx.needs_input_grad[0]:
            g_gy = _Conv.apply(x, ggw, ctx.groups)
        if ctx.needs_input_grad[1]:
            g_x = _ConvInput.apply(gy, ggw, ctx.groups, x.shape)
        return g_gy, g_x, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w, groups=groups)`` (stride 1, no padding) whose
    gradients of every order are convolutions and the convolution
    backward's input and weight gradients (the reference's
    conv2d_gradfix).  torch's own double backward of a conv takes the
    weight term as a forward conv whose kernel is the whole gradient
    image, even for a weight that needs no gradient: R1 at 512x512 spent
    seconds in it."""
    return _Conv.apply(x, w, groups)


def upfirdn2d(x: torch.Tensor, f: Optional[np.ndarray], up=1, down=1,
              padding=0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Zero-stuff upsample -> pad/crop -> FIR (true convolution unless
    ``flip_filter``) -> downsample.  x: (N, C, H, W)."""
    N, C, H, W = x.shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    if upx > 1 or upy > 1:
        x = x.reshape(N, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(N, C, H * upy, W * upx)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    if min(px0, px1, py0, py1) < 0:
        x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0),
              max(-px0, 0): x.shape[3] - max(-px1, 0)]
    if f is not None:
        ker = np.asarray(f, dtype=np.float32)
        if not flip_filter:
            ker = ker[::-1, ::-1]
        k = torch.as_tensor(np.ascontiguousarray(ker), dtype=x.dtype,
                            device=x.device) * torch.tensor(gain, dtype=x.dtype)
        # the same filter on every channel: one single-channel conv over
        # N * C images (torch's double backward of a depthwise conv runs
        # one conv per group), through ``conv2d`` (see there)
        h, w = x.shape[2:]
        x = conv2d(x.reshape(N * C, 1, h, w), k[None, None])
        x = x.reshape(N, C, *x.shape[2:])
    elif gain != 1.0:
        x = x * torch.tensor(gain, dtype=x.dtype)
    if downy > 1 or downx > 1:
        x = x[:, :, ::downy, ::downx]
    return x


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """Same-size FIR filtering (NCHW)."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = f.shape
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """FIR upsampling (NCHW)."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = f.shape
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """FIR downsampling (NCHW)."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = f.shape
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)


def filtered_lrelu(x: torch.Tensor, fu: Optional[np.ndarray] = None,
                   fd: Optional[np.ndarray] = None,
                   b: Optional[torch.Tensor] = None, up: int = 1,
                   down: int = 1, padding=0, gain: float = _SQRT2,
                   slope: float = 0.2, clamp: Optional[float] = None,
                   flip_filter: bool = False) -> torch.Tensor:
    """StyleGAN3's bias -> FIR upsample (gain ``up ** 2``, ``padding`` =
    [px0, px1, py0, py1]) -> leaky ReLU, gain, clamp -> FIR downsample,
    composed as the JAX package composes it (no fused kernel: the JAX
    function is XLA, not Pallas).  x: (N, C, H, W); fu / fd: 2D numpy
    filters or None for the identity."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor,
                    f: Optional[np.ndarray] = None, up: int = 1, down: int = 1,
                    padding=0, groups: int = 1,
                    flip_weight: bool = True) -> torch.Tensor:
    """Conv2d with optional FIR up/downsampling, the JAX package's generic
    decomposition.  x: (N, C_in, H, W); w: (C_out, C_in // groups, kh, kw).
    flip_weight=True means correlation (torch conv2d)."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fh, fw = f.shape if f is not None else (1, 1)
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    x = upfirdn2d(x, f if up > 1 else None, up=up,
                  padding=[px0, px1, py0, py1], gain=up ** 2)
    if not flip_weight and (kh > 1 or kw > 1):
        w = w.flip([2, 3])
    x = conv2d(x, w.to(x.dtype), groups=groups)
    if down > 1:
        x = upfirdn2d(x, f, down=down)
    return x
