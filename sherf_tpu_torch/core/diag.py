"""Budget-overflow counters.

The renderer compacts samples into static budgets; whatever exceeds a
budget is dropped.  Where the JAX package sows each overflow count
(survivors - capacity, clamped at 0) into flax's 'diag' collection
(``sherf_tpu/nerf/renderer.py:154-165``), the port records it in a plain
dict that the renderer returns beside its outputs:

  renderer: ray_overflow / point_overflow / exact_overflow / step_overflow
  encoder_3d downsamples: site_overflow

A nonzero count means real body samples were dropped — recalibrate with
``core.calibrate`` at a larger margin.
"""

from __future__ import annotations

from typing import Dict

import torch


class Diag(dict):
    """name -> int32 scalar tensor; ``record`` keeps the max, like the
    reference's ``reduce_fn=jnp.maximum``."""

    def record(self, name: str, excess: torch.Tensor) -> None:
        v = torch.clamp(excess, min=0).max().to(torch.int32)
        if name in self:
            v = torch.maximum(self[name], v)
        self[name] = v


def overflow_report(diag: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """{name: host int}."""
    return {k: int(v) for k, v in diag.items()}


def overflow_total(diag: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Total overflow as an f32 scalar tensor (for metrics dicts; no host
    sync).  Zero for an empty dict."""
    if not diag:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([v.to(torch.float32).sum() for v in diag.values()]).sum()
