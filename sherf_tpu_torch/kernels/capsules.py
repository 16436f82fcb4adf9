"""Body-proximity prune by per-bone capsules (torch counterpart of
``sherf_tpu/kernels/capsules.py``; plain torch, as the JAX package's is
plain XLA).  ``RenderConfig.prune_mode="capsule"`` uses it in place of the
voxel occupancy prune.

Each of the 24 bones is a capsule around its posed parent -> joint segment.
Every vertex belongs to its largest-blend-weight bone, and a bone's radius
is the farthest distance of its vertices from the segment plus the prune
radius: a point within the radius of any vertex lies in that vertex's
bone's capsule, so the mask is a superset of the exact vertex-distance
test, which the renderer re-applies to the survivors.
"""

from __future__ import annotations

import torch

from sherf_tpu_torch.smpl.model import N_JOINTS, SMPLModel


def _point_segment_d2(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Squared distance of points p (..., 3) to the segment [a, b] (3,)."""
    ab = b - a
    denom = torch.clamp((ab * ab).sum(), min=1e-12)
    t = torch.clamp(((p - a) * ab).sum(-1) / denom, 0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    return (d * d).sum(-1)


def capsule_radii(verts: torch.Tensor, joints: torch.Tensor,
                  smpl: SMPLModel, margin: float) -> torch.Tensor:
    """verts (6890, 3), joints (24, 3), posed in one frame -> (24,) radii:
    each bone's farthest assigned vertex plus ``margin``; -1 for a bone
    with no vertex (its capsule then holds no point)."""
    parents = torch.as_tensor(smpl.parents, device=joints.device)
    assign = torch.argmax(smpl.weights, dim=-1)               # (6890,)
    a = joints[parents]
    av, bv = a[assign], joints[assign]
    ab = bv - av
    denom = torch.clamp((ab * ab).sum(-1), min=1e-12)
    t = torch.clamp(((verts - av) * ab).sum(-1) / denom, 0.0, 1.0)
    d = torch.linalg.norm(verts - (av + t[:, None] * ab), dim=-1)
    r = torch.zeros(N_JOINTS, dtype=verts.dtype, device=verts.device)
    r = r.scatter_reduce(0, assign, d, reduce="amax")
    has = torch.zeros(N_JOINTS, dtype=torch.bool, device=verts.device)
    has[assign] = True
    return torch.where(has, r + margin, torch.full_like(r, -1.0))


def capsule_mask(pts: torch.Tensor, joints: torch.Tensor,
                 radii: torch.Tensor, parents) -> torch.Tensor:
    """pts (N, 3) -> (N,) bool: inside any bone's capsule."""
    hit = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for j in range(N_JOINTS):
        d2 = _point_segment_d2(pts, joints[parents[j]], joints[j])
        # signed square: a negative radius (no vertex) never matches
        hit = hit | (d2 <= radii[j] * torch.abs(radii[j]))
    return hit


def prune_mask(pts: torch.Tensor, verts: torch.Tensor, joints: torch.Tensor,
               smpl: SMPLModel, radius: float) -> torch.Tensor:
    """pts (N, 3), verts (6890, 3), joints (24, 3), all in one frame ->
    (N,) bool, True wherever a point may lie within ``radius`` of a
    vertex."""
    radii = capsule_radii(verts, joints, smpl, radius)
    return capsule_mask(pts, joints, radii, smpl.parents)
