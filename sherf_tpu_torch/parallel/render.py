"""Sharded rendering (torch counterpart of
``sherf_tpu/parallel/render.py``): each rank renders its (B/dm, N/rm) ray
shard, then one all-gather over the ray group and the un-interleave give
every rank of a data group the full images of its items.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from sherf_tpu_torch.core.diag import overflow_total
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.parallel.mesh import Mesh, gather_rays, mean_metrics


def make_sharded_render(model, smpl, mesh: Mesh) -> Callable:
    """Returns ``render(batch) -> {image_raw (B, H, W, 3), image_depth,
    weights_image (B, H, W), overflow}`` for this rank's shard of a batch
    (``shard_batch``), the images its data group's (B/dm items, every
    ray), ``overflow`` the largest sum of budget-overflow counters over
    every rank."""

    @torch.no_grad()
    def render(batch: SHERFBatch) -> Dict[str, torch.Tensor]:
        out, diag = model(batch, smpl, flat_output=True)
        B, H, W = batch.img.shape[:3]
        res = {"image_raw": gather_rays(mesh, out["image_raw"]).reshape(
                   B, H, W, 3),
               "image_depth": gather_rays(mesh, out["image_depth"]).reshape(
                   B, H, W),
               "weights_image": gather_rays(mesh, out["weights_image"]
                                            ).reshape(B, H, W)}
        res.update(mean_metrics(mesh, {"overflow": overflow_total(diag).to(
            res["image_raw"].device)}))
        return res

    return render
