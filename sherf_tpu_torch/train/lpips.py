"""LPIPS perceptual distance with a VGG16 backbone (torch counterpart of
``sherf_tpu/train/lpips.py``; the reference's ``lpips`` package, loss.py:
28,160 and test_loop.py:40).

VGG16 conv features at 5 stages (relu1_2 ... relu5_3), each unit-normalised
per pixel over its channels (``+1e-10``), squared differences weighted by
learned per-channel linear weights, a spatial mean, summed over the stages.
Inputs are NHWC in [-1, 1], shifted and scaled as ``lpips.ScalingLayer``
does; 2x2 max-pools with floor.

The modules' names are the ``lpips`` package's (``scaling_layer.*``,
``net.slice<n>.<torchvision index>.*``, ``lins.<i>.model.1.weight``), so a
state dict saved from ``lpips.LPIPS(net='vgg')`` loads with
``load_state_dict``.  No weights are bundled: ``SHERF_LPIPS_WEIGHTS``
names such a file (``torch.save(lpips.LPIPS(net='vgg').state_dict(), f)``),
and without one LPIPS is absent (0 in the loss, no eval metric), as in the
JAX package.  The convolutions compute in f32 (``chip_smoke.py`` turns
TF32 off, as the f32 paths need).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

# torchvision vgg16.features: (index, out channels) of the 13 convolutions
# and the indices of the max-pools; lpips cuts it into five slices
_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
          (14, 256), (17, 512), (19, 512), (21, 512), (24, 512), (26, 512),
          (28, 512))
_POOLS = (4, 9, 16, 23)
_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))
_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None])

    def forward(self, x):
        return (x - self.shift) / self.scale


class VGG16Features(nn.Module):
    """VGG16's conv stack (NCHW) returning the 5 LPIPS feature stages."""

    def __init__(self):
        super().__init__()
        layers = {}
        cin = 3
        for idx, cout in _CONVS:
            layers[idx] = nn.Conv2d(cin, cout, 3, padding=1)
            layers[idx + 1] = nn.ReLU()
            cin = cout
        for idx in _POOLS:
            layers[idx] = nn.MaxPool2d(2, 2)
        for n, (lo, hi) in enumerate(_SLICES, start=1):
            seq = nn.Sequential()
            for idx in range(lo, hi):
                seq.add_module(str(idx), layers[idx])
            setattr(self, f"slice{n}", seq)

    def forward(self, x):
        feats = []
        for n in range(1, 6):
            x = getattr(self, f"slice{n}")(x)
            feats.append(x)
        return feats


class NetLinLayer(nn.Module):
    """lpips.NetLinLayer: a 1x1 convolution to one channel (no bias)."""

    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(chn_in, 1, 1, bias=False))


class LPIPS(nn.Module):
    """``lpips.LPIPS(net='vgg')``: (B, H, W, 3) pairs in [-1, 1] -> (B,)."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = VGG16Features()
        self.lins = nn.ModuleList(NetLinLayer(c) for c in _CHANNELS)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if min(x.shape[1:3]) < 16:
            # the fourth pool leaves the fifth stage empty: the JAX module
            # (VALID pools) averages over nothing, NaN; torch's pool raises
            return x.new_full((x.shape[0],), float("nan"), dtype=torch.float32)
        to_nchw = lambda t: t.float().permute(0, 3, 1, 2)
        fx = self.net(self.scaling_layer(to_nchw(x)))
        fy = self.net(self.scaling_layer(to_nchw(y)))
        total = 0.0
        for a, b, lin in zip(fx, fy, self.lins):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            w = lin.model[1].weight.reshape(1, -1, 1, 1)
            total = total + torch.sum((a - b) ** 2 * w, dim=1).mean(dim=(1, 2))
        return total


def load_lpips_state_dict(model: LPIPS, sd: Dict) -> LPIPS:
    """Load an ``lpips`` state dict: every backbone and linear weight must
    be there; ``scaling_layer``'s constants may be left out."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.startswith("scaling_layer.")]
    if missing or unexpected:
        raise KeyError(f"not an lpips VGG state dict: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def load_lpips_file() -> Optional[Dict]:
    """The state dict at ``$SHERF_LPIPS_WEIGHTS``, or None when no such
    file exists."""
    path = os.environ.get("SHERF_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


_LPIPS_PARAMS: Optional[Dict] = None
_TRIED = False


def lpips_params() -> Optional[Dict]:
    """The LPIPS state dict, looked up once, or None.  Only the weights
    file: the JAX package's other source, the ``lpips`` package, fetches
    VGG weights over the network, which the port never does."""
    global _LPIPS_PARAMS, _TRIED
    if not _TRIED:
        _TRIED = True
        _LPIPS_PARAMS = load_lpips_file()
    return _LPIPS_PARAMS


def lpips_available() -> bool:
    return lpips_params() is not None


def make_lpips(device="cuda") -> Optional[LPIPS]:
    """An LPIPS module on ``device`` with the found weights, frozen and in
    eval mode; None without weights."""
    sd = lpips_params()
    if sd is None:
        return None
    model = load_lpips_state_dict(LPIPS(), sd).to(device).eval()
    return model.requires_grad_(False)
