"""GAN metric suite: FID / KID / precision-recall / PPL / IS / equivariance
(the port's copy of ``sherf_tpu/eval/gan_metrics.py``, whose statistics are
numpy only; the default feature extractor runs on the device).

The reference inherits EG3D's metrics/ package (fid50k_full, kid50k_full,
pr50k3_full, ppl2_wend, eqt50k_int/eqt50k_frac/eqr50k, is50k —
metric_main.py:87-152), which downloads an Inception pickle at run time.
Here the statistics are computed in f64 numpy and the feature extractor /
classifier is pluggable (any (N,H,W,3)->(N,D) embedding; the LPIPS VGG16
tower doubles as one when its weights are present).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


class FeatureStats:
    """Running mean/cov + optional raw feature retention
    (reference metric_utils.FeatureStats:73)."""

    def __init__(self, capture_all: bool = False, max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.max_items = max_items
        self.num_items = 0
        self.raw_mean = None
        self.raw_cov = None
        self.all_features = [] if capture_all else None

    def append(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        if self.max_items is not None:
            x = x[: max(self.max_items - self.num_items, 0)]
        if x.size == 0:
            return
        if self.raw_mean is None:
            self.raw_mean = np.zeros(x.shape[1])
            self.raw_cov = np.zeros((x.shape[1], x.shape[1]))
        self.num_items += x.shape[0]
        self.raw_mean += x.sum(0)
        self.raw_cov += x.T @ x
        if self.capture_all:
            self.all_features.append(x)

    def get_mean_cov(self) -> Tuple[np.ndarray, np.ndarray]:
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def get_all(self) -> np.ndarray:
        return np.concatenate(self.all_features, 0)


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between two gaussians (frechet_inception_distance.py)."""
    import scipy.linalg

    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(sigma1 @ sigma2)
    return float(np.real(m + np.trace(sigma1 + sigma2 - s * 2)))


def kernel_distance(feat_real: np.ndarray, feat_gen: np.ndarray,
                    num_subsets: int = 100, max_subset_size: int = 1000,
                    seed: int = 0) -> float:
    """KID: polynomial-kernel MMD (kernel_inception_distance.py)."""
    rng = np.random.RandomState(seed)
    n = feat_real.shape[1]
    m = min(min(feat_real.shape[0], feat_gen.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = feat_gen[rng.choice(feat_gen.shape[0], m, replace=False)]
        y = feat_real[rng.choice(feat_real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def precision_recall(feat_real: np.ndarray, feat_gen: np.ndarray,
                     nhood_size: int = 3) -> Tuple[float, float]:
    """k-NN manifold precision/recall (precision_recall.py)."""
    def knn_radius(feats, k):
        d = np.linalg.norm(feats[:, None] - feats[None], axis=-1)
        return np.sort(d, axis=1)[:, k]

    def coverage(probe, ref, radii):
        d = np.linalg.norm(probe[:, None] - ref[None], axis=-1)
        return float(((d <= radii[None]).any(axis=1)).mean())

    precision = coverage(feat_gen, feat_real, knn_radius(feat_real, nhood_size))
    recall = coverage(feat_real, feat_gen, knn_radius(feat_gen, nhood_size))
    return precision, recall


def slerp(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Spherical interpolation (perceptual_path_length.py:23-33)."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = np.sum(a * b, axis=-1, keepdims=True)
    p = np.asarray(t) * np.arccos(np.clip(d, -1.0, 1.0))
    c = b - d * a
    c = c / np.linalg.norm(c, axis=-1, keepdims=True)
    out = a * np.cos(p) + c * np.sin(p)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def perceptual_path_length(dist: np.ndarray, epsilon: float = 1e-4) -> float:
    """PPL aggregate (perceptual_path_length.py / ppl2_wend): given LPIPS
    distances between image pairs rendered at latent offsets of ``epsilon``,
    scale by eps^-2 and report the mean with the reference's 1%/99%
    percentile clipping (lo/hi filtering of outliers)."""
    d = np.asarray(dist, np.float64) / (epsilon ** 2)
    if d.size == 0:
        return float("nan")
    lo, hi = np.percentile(d, [1, 99])
    return float(d[(d >= lo) & (d <= hi)].mean())


def inception_score(probs: np.ndarray, num_splits: int = 10
                    ) -> Tuple[float, float]:
    """IS (inception_score.py / is50k): exp(E KL(p(y|x) || p(y))) over
    ``num_splits`` disjoint splits of the (N, num_classes) probabilities.
    The classifier is pluggable; the reference hardwires Inception-v3."""
    probs = np.asarray(probs, np.float64)
    scores = []
    for part in np.array_split(probs, num_splits):
        if len(part) == 0:
            continue
        kl = part * (np.log(part + 1e-12)
                     - np.log(part.mean(0, keepdims=True) + 1e-12))
        scores.append(float(np.exp(kl.sum(1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def equivariance_psnr(img_a: np.ndarray, img_b: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> float:
    """EQ metric aggregate (equivariance.py eqt/eqr): PSNR in dB between a
    transformed render and a rendered transform, over the valid region.
    Images in [-1, 1] (the reference measures on the raw generator output
    range, equivariance.py:200+: mse scaled to that 2-unit dynamic range)."""
    a = np.asarray(img_a, np.float64)
    b = np.asarray(img_b, np.float64)
    se = (a - b) ** 2
    if mask is not None:
        m = np.asarray(mask, bool)
        if not m.any():
            return float("nan")
        mse = se[m].mean()
    else:
        mse = se.mean()
    return float(10.0 * np.log10(4.0 / max(mse, 1e-20)))


def compute_fid(real_images, gen_images, extractor: Callable) -> float:
    """extractor: (N, H, W, 3) uint8/float -> (N, D) features."""
    rs, gs = FeatureStats(), FeatureStats()
    rs.append(np.asarray(extractor(real_images)))
    gs.append(np.asarray(extractor(gen_images)))
    return frechet_distance(*rs.get_mean_cov(), *gs.get_mean_cov())


def default_extractor(device="cuda") -> Optional[Callable]:
    """Feature embedding over (N, H, W, 3) images in [-1, 1] (numpy or
    tensors), computed on ``device``, returned as numpy.

    Preference order: the reference-defined InceptionV3 pool3 features
    (``features/inception.py``) when its weights are available, else the
    last stage of the VGG16 tower of the LPIPS weights, averaged over space,
    else None."""
    import torch

    from sherf_tpu_torch.features.inception import inception_extractor
    from sherf_tpu_torch.train.lpips import make_lpips

    inc = inception_extractor(device=device)
    if inc is not None:
        return lambda imgs: inc((imgs + 1.0) / 2.0)

    lp = make_lpips(device)
    if lp is None:
        return None

    @torch.no_grad()
    def embed(imgs):
        x = torch.as_tensor(imgs, dtype=torch.float32, device=device)
        return lp.net(x.permute(0, 3, 1, 2))[-1].mean(dim=(2, 3)).cpu().numpy()

    return embed
