"""GAN metric suite over rendered vs real images (torch counterpart of
``sherf_tpu/cli/calc_metrics.py``; reference calc_metrics.py +
metrics/metric_main.py, adapted to SHERF's conditioned generator: the
metrics are computed over synthetic items rendered from their observation
images, since EG3D's z-sampling path cannot drive SHERF).

  python -m sherf_tpu_torch.cli.calc_metrics --cfg synthetic \\
      --resume runs/grid/checkpoints/snapshot-003000.pt \\
      --metrics fid kid pr is ppl eqt eqr --num_items 64 --size 128
  (add --device cpu to run on the CPU)

Features come from InceptionV3 with the state dict at
``$SHERF_INCEPTION_WEIGHTS``, else from the VGG16 tower of the LPIPS
weights at ``$SHERF_LPIPS_WEIGHTS``; PPL needs the LPIPS weights.
``--resume`` restores a port checkpoint (its EMA weights, as the eval CLI
does); without it the generator is drawn at random from seed 0.  (The JAX
CLI parses ``--resume`` but scores random weights either way.)  Renders
and features run on ``--device``; the statistics in f64 numpy.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from sherf_tpu_torch.cli.common import (
    add_model_flags, build_model, model_config_from_args, resolve_device,
    resolve_smpl)
from sherf_tpu_torch.cli.eval import load_weights
from sherf_tpu_torch.core.diag import overflow_total
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.eval import gan_metrics as gm
from sherf_tpu_torch.features.inception import inception_extractor
from sherf_tpu_torch.models.generator import random_init_
from sherf_tpu_torch.train.lpips import make_lpips


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True,
                   choices=["renderpeople", "thuman", "humman", "zju",
                            "synthetic"])
    p.add_argument("--data", default="")
    p.add_argument("--resume", default=None,
                   help="a port checkpoint; its EMA weights are scored")
    p.add_argument("--metrics", nargs="*", default=["fid", "kid"],
                   help="any of: fid kid pr ppl is eqt eqr (reference "
                        "metric_main.py registry: fid50k_full, kid50k_full, "
                        "pr50k3_full, ppl2_wend, is50k, eqt50k_int, eqr50k)")
    p.add_argument("--ppl_epsilon", type=float, default=1e-4)
    p.add_argument("--num_items", type=int, default=64)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--out", default="metrics.json")
    add_model_flags(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    extractor = gm.default_extractor(device)
    if extractor is None:
        raise SystemExit(
            "calc_metrics needs a feature extractor: set "
            "SHERF_INCEPTION_WEIGHTS (a torchvision / pytorch-fid InceptionV3 "
            "state dict) or SHERF_LPIPS_WEIGHTS (an lpips VGG state dict)")

    smpl = resolve_smpl(a.smpl_model, device)
    model, _, _ = build_model(model_config_from_args(a), smpl, device=device)
    if a.resume:
        load_weights(model, a.resume)
    else:
        random_init_(model, torch.Generator().manual_seed(0))
    model.eval()

    def batch(seed):
        return make_synthetic_batch(smpl, batch_size=1, H=a.size, W=a.size,
                                    seed=seed, device=device)

    overflow = 0

    @torch.inference_mode()
    def fwd(b):
        nonlocal overflow
        out, diag = model(b, smpl)
        overflow += int(overflow_total(diag))
        return out["image_raw"]

    # render + collect features
    reals = gm.FeatureStats(capture_all=True)
    fakes = gm.FeatureStats(capture_all=True)
    fake_images = []   # [0, 1] renders kept for the IS classifier pass
    for i in range(a.num_items):
        b = batch(i)
        fake = fwd(b) / 2 + 0.5
        fakes.append(extractor(fake * 2 - 1))
        reals.append(extractor(b.img * 2 - 1))
        if "is" in a.metrics:
            fake_images.append(fake)

    results = {}
    if "fid" in a.metrics:
        results["fid"] = gm.frechet_distance(*reals.get_mean_cov(),
                                             *fakes.get_mean_cov())
    if "kid" in a.metrics:
        results["kid"] = gm.kernel_distance(reals.get_all(), fakes.get_all())
    if "pr" in a.metrics:
        pr = gm.precision_recall(reals.get_all(), fakes.get_all())
        results["precision"], results["recall"] = pr
    if "is" in a.metrics:
        # over Inception's softmax when its weights exist; else over the
        # extractor's features through a softmax, as a stand-in
        cls = inception_extractor(logits=True, device=device)
        if cls is not None and fake_images:
            probs = np.concatenate([cls(f) for f in fake_images], axis=0)
        else:
            feats = fakes.get_all()
            e = np.exp(feats - feats.max(1, keepdims=True))
            probs = e / e.sum(1, keepdims=True)
        results["is_mean"], results["is_std"] = gm.inception_score(probs)
    if "ppl" in a.metrics:
        results["ppl"] = _ppl(model, smpl, batch, a, device)
    if "eqt" in a.metrics or "eqr" in a.metrics:
        eq = _equivariance(fwd, batch, a)
        if "eqt" in a.metrics:
            results["eqt_int_psnr"] = eq["eqt"]
        if "eqr" in a.metrics:
            results["eqr90_psnr"] = eq["eqr"]
    results["overflow"] = overflow
    print(json.dumps(results))
    with open(a.out, "w") as f:
        json.dump(results, f)
    return results


@torch.inference_mode()
def _ppl(model, smpl, batch, a, device):
    """PPL in w space with end sampling (reference ppl2_wend): move the
    mapped latent of one observation by epsilon toward a second's, render
    both on the first item's geometry, and aggregate LPIPS / eps^2.  NaN
    without LPIPS weights."""
    lpips = make_lpips(device)
    if lpips is None:
        return float("nan")
    eps = a.ppl_epsilon
    dists = []
    for i in range(min(a.num_items, 16)):
        b0, b1 = batch(2 * i), batch(2 * i + 1)
        w0 = model.mapping(b0.obs_img)
        w1 = model.mapping(b1.obs_img)
        wt1 = w0 + (w1 - w0) * eps              # lerp in w (space='w')
        img0 = model.synthesis(w0, b0, smpl)[0]["image_raw"]
        img1 = model.synthesis(wt1, b0, smpl)[0]["image_raw"]
        dists.append(float(lpips(img0, img1)[0]))
    return gm.perceptual_path_length(np.asarray(dists), epsilon=eps)


def _equivariance(fwd, batch, a):
    """Integer-translation / 90-degree-rotation equivariance of the renderer
    (reference eqt50k_int / eqr50k, adapted to SHERF's per-pixel rays:
    shifting or rotating the ray grid must shift or rotate the render,
    exactly, so no antialiasing filters are needed)."""
    H = W = a.size
    fields = ("ray_o", "ray_d", "near", "far")

    def moved(b, fn):
        """``b`` with each ray field's (H, W) grid transformed by ``fn``."""
        new = {}
        for f in fields:
            v = getattr(b, f)
            g = v.reshape((1, H, W) + tuple(v.shape[2:]))
            new[f] = fn(g).reshape(v.shape).contiguous()
        return dataclasses.replace(b, **new)

    def image(b):
        return fwd(b)[0].reshape(H, W, 3).double().cpu().numpy()

    eqt_vals, eqr_vals = [], []
    for i in range(min(a.num_items, 8)):
        b = batch(i)
        base = image(b)
        # EQ-T: shift the ray grid by (dy, dx) whole pixels
        dy, dx = H // 8, W // 8
        out = image(moved(b, lambda g: torch.roll(g, (dy, dx), dims=(1, 2))))
        ref = np.roll(base, (dy, dx), axis=(0, 1))
        mask = np.zeros((H, W, 3), bool)
        mask[dy:, dx:] = True                   # the wrapped rows excluded
        eqt_vals.append(gm.equivariance_psnr(out, ref, mask))
        # EQ-R: rotate the ray grid by 90 degrees
        out = image(moved(b, lambda g: torch.rot90(g, 1, dims=(1, 2))))
        eqr_vals.append(gm.equivariance_psnr(out, np.rot90(base, 1,
                                                           axes=(0, 1))))
    return {"eqt": float(np.mean(eqt_vals)), "eqr": float(np.mean(eqr_vals))}


if __name__ == "__main__":
    main()
