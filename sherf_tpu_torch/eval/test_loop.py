"""Evaluation protocols (torch counterpart of ``sherf_tpu/eval/test_loop.py``;
reference training/test_loop.py:87-357).

Two protocols, both per observation view and per held-out subject:
  * novel view — the observation image shows the SAME pose from a fixed
    view; every other view (subsampled by data_interval) is rendered and
    scored;
  * novel pose — the observation image is pinned to the np_pose_start pose;
    all other poses / views are rendered (animation from one image).

Metrics: PSNR over mask_at_box pixels; SSIM and, when VGG weights exist,
LPIPS on the person crop.  Writes pred / gt / input PNGs and the
reference's psnr_ / ssim_ / lpips_*.npy aggregates, with the JAX
package's names and layout:
``{protocol}/obs_view_{v}/{human}/frameNNNN_viewNNNN{,_gt,_input}.png``.

Novel-pose observation indexing: the reference sets ``obs_pose_index =
np_pose_start``, which indexes the RE-BASED pose list (test_loop.py:267):
the observation is the (np_pose_start)-th pose *after* np_pose_start.
``obs_pose_mode="reference"`` (default) reproduces that for metric parity;
``"first"`` pins the observation to relative index 0.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np

from sherf_tpu_torch.data.base import collate
from sherf_tpu_torch.eval.metrics import crop_metrics, psnr_np
from sherf_tpu_torch.eval.png import write_png


def to8b(x):
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _render_item(render_fn, item, device) -> Dict[str, np.ndarray]:
    out = render_fn(collate([item], device))
    return {k: v[0].float().cpu().numpy() for k, v in out.items()}


def _eval_one(render_fn, item, savedir: str, tag: str, device):
    out = _render_item(render_fn, item, device)
    H, W = item["img"].shape[:2]
    pred = out["image_raw"] / 2.0 + 0.5
    gt = item["img"]
    mask = item["mask_at_box"].reshape(H, W)

    os.makedirs(savedir, exist_ok=True)
    write_png(os.path.join(savedir, f"{tag}.png"), to8b(pred))
    write_png(os.path.join(savedir, f"{tag}_gt.png"), to8b(gt))
    write_png(os.path.join(savedir, f"{tag}_input.png"), to8b(item["obs_img"]))

    psnr = psnr_np(pred, gt, mask)
    # the metric crop works on mask-zeroed images (test_loop.ssim_metric)
    pm = pred * mask[..., None]
    gm = gt * mask[..., None]
    ssim, lpips = crop_metrics(pm, gm, mask, device=device)
    return psnr, ssim, lpips


def run_eval(render_fn: Callable, make_dataset: Callable, subjects: List[str],
             obs_views: List[int], savedir: str, nv_pose_start: int = 0,
             np_pose_start: int = 2, pose_interval: int = 1, pose_num: int = 5,
             data_interval: int = 2, verbose: bool = True,
             obs_pose_mode: str = "reference", device="cuda"
             ) -> Dict[str, Dict[str, float]]:
    """render_fn(batch on ``device``) -> dict of (B, ...) tensors with
    ``image_raw``; make_dataset(data_root, poses_start, poses_interval,
    poses_num) -> HumanDataset.  Returns {protocol: {psnr, ssim, lpips}}
    averages (None where a metric has no value)."""
    results = {}

    for protocol in ("novel_view", "novel_pose"):
        pose_start = nv_pose_start if protocol == "novel_view" else np_pose_start
        agg = {"psnr": [], "ssim": [], "lpips": []}
        for obs_view in obs_views:
            for data_root in subjects:
                human = os.path.basename(str(data_root).strip())
                sub_dir = os.path.join(savedir, protocol,
                                       f"obs_view_{obs_view}", human)
                ds = make_dataset(data_root, pose_start, pose_interval, pose_num)
                ds.obs_view_index = obs_view
                if protocol == "novel_pose":
                    ds.obs_pose_index = (np_pose_start
                                         if obs_pose_mode == "reference"
                                         else 0)

                sub = {"psnr": [], "ssim": [], "lpips": []}
                for k in range(len(ds)):
                    view_id = k % ds.camera_view_num
                    if protocol == "novel_view":
                        if view_id == obs_view or view_id % data_interval != 0:
                            continue
                    else:
                        pose_rel = ((k % (ds.poses_num * ds.camera_view_num))
                                    // ds.camera_view_num)
                        if pose_rel == 0 or view_id % data_interval != 0:
                            continue
                    tag = f"frame{k // ds.camera_view_num:04d}_view{view_id:04d}"
                    psnr, ssim, lpips = _eval_one(render_fn, ds[k], sub_dir,
                                                  tag, device)
                    if verbose:
                        print(f"[{protocol}] {human} obs_view={obs_view} {tag} "
                              f"PSNR={psnr:.3f} SSIM={ssim:.3f} "
                              f"LPIPS={'n/a' if lpips is None else round(lpips, 3)}")
                    sub["psnr"].append(psnr)
                    sub["ssim"].append(ssim)
                    if lpips is not None:
                        sub["lpips"].append(lpips)

                os.makedirs(sub_dir, exist_ok=True)
                for key in ("psnr", "ssim", "lpips"):
                    if sub[key]:
                        avg = float(np.mean(sub[key]))
                        np.save(os.path.join(sub_dir,
                                             f"{key}_{int(avg * 100)}.npy"),
                                np.array(avg))
                        agg[key].extend(sub[key])

        results[protocol] = {k: (float(np.mean(v)) if v else None)
                             for k, v in agg.items()}
        pdir = os.path.join(savedir, protocol)
        os.makedirs(pdir, exist_ok=True)
        for key, val in results[protocol].items():
            if val is not None:
                np.save(os.path.join(pdir, f"{key}_{int(val * 100)}.npy"),
                        np.array(agg[key]))
    return results
