"""Value types shared across the port (the torch counterparts of
``sherf_tpu/core/types.py``).

Plain dataclasses of tensors.  Layouts are the JAX package's: images NHWC
in [0, 1], rays flattened H*W, leading batch dim B.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def _map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """Apply ``fn`` to every tensor field of a (nested) dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = fn(v)
        elif dataclasses.is_dataclass(v):
            v = _map_tensors(v, fn)
        out[f.name] = v
    return type(obj)(**out)


class _TensorTree:
    def to(self, device):
        """A copy with every tensor moved to ``device``."""
        return _map_tensors(self, lambda t: t.to(device))

    @classmethod
    def from_numpy(cls, obj):
        """Build from any object with the same field names holding array-likes
        (numpy arrays or a JAX pytree after ``jax.device_get``)."""
        out = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            ftype = _NESTED.get(f.name)
            if ftype is not None:
                out[f.name] = ftype.from_numpy(v)
            else:
                out[f.name] = torch.from_numpy(np.array(v))
        return cls(**out)


@dataclasses.dataclass
class SMPLPose(_TensorTree):
    """Per-frame SMPL parameters."""

    poses: torch.Tensor   # (..., 72) axis-angle, root first
    shapes: torch.Tensor  # (..., 10) betas
    R: torch.Tensor       # (..., 3, 3) global rotation
    Th: torch.Tensor      # (..., 3) global translation


@dataclasses.dataclass
class Camera(_TensorTree):
    """Pinhole camera: world -> pixel via K [R|T]."""

    K: torch.Tensor  # (..., 3, 3)
    R: torch.Tensor  # (..., 3, 3)
    T: torch.Tensor  # (..., 3, 1)


@dataclasses.dataclass
class Rays(_TensorTree):
    """A bundle of rays with AABB entry/exit distances."""

    origins: torch.Tensor     # (..., N, 3)
    directions: torch.Tensor  # (..., N, 3) not normalized
    near: torch.Tensor        # (..., N)
    far: torch.Tensor         # (..., N)
    mask_at_box: torch.Tensor  # (..., N) bool


@dataclasses.dataclass
class SHERFBatch(_TensorTree):
    """One device batch (field for field ``sherf_tpu.core.types.SHERFBatch``)."""

    t_pose: SMPLPose
    t_vertices: torch.Tensor   # (B, 6890, 3)
    t_bounds: torch.Tensor     # (B, 2, 3)

    pose: SMPLPose
    vertices: torch.Tensor     # (B, 6890, 3) posed world vertices
    img: torch.Tensor          # (B, H, W, 3)
    ray_o: torch.Tensor        # (B, N, 3)
    ray_d: torch.Tensor        # (B, N, 3)
    near: torch.Tensor         # (B, N)
    far: torch.Tensor          # (B, N)
    mask_at_box: torch.Tensor  # (B, N) bool
    bkgd_msk: torch.Tensor     # (B, N)

    obs_pose: SMPLPose
    obs_vertices: torch.Tensor  # (B, 6890, 3)
    obs_img: torch.Tensor       # (B, Ho, Wo, 3)
    obs_K: torch.Tensor         # (B, 3, 3)
    obs_R: torch.Tensor         # (B, 3, 3)
    obs_T: torch.Tensor         # (B, 3, 1)


_NESTED = {"t_pose": SMPLPose, "pose": SMPLPose, "obs_pose": SMPLPose}
