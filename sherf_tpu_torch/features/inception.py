"""InceptionV3 feature extractor for the GAN metric suite (torch counterpart
of ``sherf_tpu/features/inception.py``).

FID / KID / IS are defined by the TF ``inception-2015-12-05`` network's
"pool_3" features.  This is the torchvision ``inception_v3`` layout with
the pytorch-fid patches that restore the TF graph's semantics: the average
pools of the branches count no padding, and Mixed_7c's pool branch takes a
MAX pool.  The modules carry torchvision's names (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``, ..., ``fc``), so a torchvision / pytorch-fid
state dict (``pt_inception-2015-12-05-*.pth``) loads with
``load_state_dict`` (torchvision's auxiliary head, which FID does not use,
is left out).  BN runs in inference mode, eps 1e-3.

No weights ship with the repo and none are fetched: a state dict at
``$SHERF_INCEPTION_WEIGHTS`` (or a path given) is read, and without one
:func:`inception_extractor` returns None.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.features.superresolution import resize_bilinear

BN_EPS = 1e-3
FEATURE_DIM = 2048
# the 2015 TF graph classifies 1008 classes (pytorch-fid's fc)
NUM_CLASSES = 1008
INPUT_SIZE = 299


class BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3, running statistics) + relu."""

    def __init__(self, in_channels: int, out_channels: int, kernel=1,
                 stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_tf(x):
    """3x3 stride-1 average pool, pad 1, padding not counted."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64)
        self.branch5x5_1 = BasicConv2d(cin, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_tf(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        p17, p71 = (0, 3), (3, 0)          # (1, 7) and (7, 1) kernels
        self.branch1x1 = BasicConv2d(cin, 192)
        self.branch7x7_1 = BasicConv2d(cin, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=p17)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=p71)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=p17)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=p17)
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_tf(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """Mixed_7b pools with the TF average pool; Mixed_7c with a 3x3
    stride-1 MAX pool (pytorch-fid's FIDInceptionE_2, the 2015 graph's
    quirk)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320)
        self.branch3x3_1 = BasicConv2d(cin, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max"
                  else _avg_pool_3x3_tf(x))
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(pooled)], dim=1)


class InceptionV3(nn.Module):
    """forward: (N, H, W, 3) images in [0, 1] -> (pool3 features (N, 2048),
    logits (N, num_classes)).  Inputs not at 299x299 are resized to it
    bilinearly, antialiased when shrinking (as ``jax.image.resize``), then
    mapped to [-1, 1]."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.fc = nn.Linear(FEATURE_DIM, num_classes)

    def forward(self, x: torch.Tensor):
        x = x.float()
        if tuple(x.shape[1:3]) != (INPUT_SIZE, INPUT_SIZE):
            x = resize_bilinear(x, INPUT_SIZE, antialias=True)
        x = x.permute(0, 3, 1, 2) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a",
                     "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        feats = x.mean(dim=(2, 3))               # global average -> pool_3
        return feats, self.fc(feats)


def load_inception_state_dict(model: InceptionV3, sd: Dict) -> InceptionV3:
    """Load a torchvision / pytorch-fid state dict: every key of the model
    must be there (BN's ``num_batches_tracked`` may be left out); of the
    rest only torchvision's auxiliary head (``AuxLogits.*``) is dropped."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    unexpected = [k for k in unexpected if not k.startswith("AuxLogits.")]
    if missing or unexpected:
        raise KeyError(f"not an InceptionV3 state dict: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def load_inception_params(path: Optional[str] = None) -> Optional[Dict]:
    """The state dict at ``path`` or ``$SHERF_INCEPTION_WEIGHTS``; None when
    no such file exists."""
    path = path or os.environ.get("SHERF_INCEPTION_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def make_inception(sd: Dict, device="cuda") -> InceptionV3:
    """InceptionV3 with the state dict ``sd``, frozen, in eval mode."""
    net = InceptionV3(num_classes=int(sd["fc.bias"].shape[0]))
    net = load_inception_state_dict(net, sd).to(device).eval()
    return net.requires_grad_(False)


def inception_extractor(params: Optional[Dict] = None,
                        path: Optional[str] = None, logits: bool = False,
                        device="cuda") -> Optional[Callable]:
    """(N, H, W, 3) images in [0, 1] (numpy or a tensor) -> (N, 2048) pool3
    features as numpy (or, with ``logits``, the (N, num_classes) softmax
    probabilities for IS), computed on ``device``.  None when no weights
    exist."""
    if params is None:
        params = load_inception_params(path)
    if params is None:
        return None
    net = make_inception(params, device)

    @torch.no_grad()
    def embed(imgs):
        x = (imgs.to(device) if torch.is_tensor(imgs)
             else torch.as_tensor(np.asarray(imgs, np.float32), device=device))
        feats, lg = net(x)
        out = torch.softmax(lg, dim=-1) if logits else feats
        return out.cpu().numpy()

    return embed
