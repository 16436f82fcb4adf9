"""Budget-overflow counters.

The renderer compacts samples into static budgets; whatever exceeds a
budget is dropped.  Where the JAX package sows each overflow count
(survivors - capacity, clamped at 0) into flax's 'diag' collection
(``sherf_tpu/nerf/renderer.py:154-165``), the port records it in a plain
dict that the renderer returns beside its outputs, one entry per leaf of
that collection:

  renderer: ray_overflow / point_overflow / exact_overflow / step_overflow /
            knn_shortlist_overflow
  encoder_3d downsamples: down0.site_overflow / down1.site_overflow /
            down2.site_overflow

A key is ``[scope.]name``: each module that sows a name owns its own leaf,
as each flax module does.  ``overflow_total`` sums the leaves and
``overflow_report`` keeps the max per name, as ``sherf_tpu/core/diag.py``
does.  A nonzero count means real body samples were dropped — recalibrate
with ``core.calibrate`` at a larger margin.
"""

from __future__ import annotations

from typing import Dict

import torch


class Diag(dict):
    """leaf key -> int32 scalar tensor; ``record`` keeps the max, like the
    reference's ``reduce_fn=jnp.maximum``."""

    def record(self, name: str, excess: torch.Tensor) -> None:
        v = torch.clamp(excess, min=0).max().to(torch.int32)
        if name in self:
            v = torch.maximum(self[name], v)
        self[name] = v


def overflow_report(diag: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """{leaf name: max count over the modules that record it} (host ints)."""
    out: Dict[str, int] = {}
    for key, v in diag.items():
        name = key.rsplit(".", 1)[-1]
        out[name] = max(out.get(name, 0), int(v))
    return out


def overflow_total(diag: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of every leaf as an f32 scalar tensor (for metrics dicts; no host
    sync).  Zero for an empty dict."""
    if not diag:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([v.to(torch.float32).sum() for v in diag.values()]).sum()
