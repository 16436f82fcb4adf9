"""Camera rays, AABB intersection, projection and mesh normals (torch
counterpart of ``sherf_tpu/geometry/rays.py``; the ``_np`` twins are host
numpy copies for the data pipeline)."""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Rays


def get_rays(H: int, W: int, K, R, T):
    """World-space rays through every pixel.  K: (3,3); R: (3,3), T: (3,1)
    world->cam.  Returns (rays_o, rays_d) each (H, W, 3), directions not
    normalized."""
    T = T.reshape(3)
    rays_o = -R.T @ T
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=K.device),
        torch.arange(H, dtype=torch.float32, device=K.device), indexing="xy")
    xy1 = torch.stack([i, j, torch.ones_like(i)], dim=-1)
    pixel_camera = xy1 @ torch.linalg.inv(K).T
    pixel_world = (pixel_camera - T) @ R
    rays_d = pixel_world - rays_o
    return rays_o.expand(rays_d.shape), rays_d


def get_rays_np(H: int, W: int, K, R, T):
    """Host numpy twin of :func:`get_rays`."""
    T = np.reshape(T, (3,))
    rays_o = -R.T @ T
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=-1)
    pixel_camera = xy1 @ np.linalg.inv(K).T.astype(np.float32)
    pixel_world = (pixel_camera - T) @ R
    rays_d = (pixel_world - rays_o).astype(np.float32)
    rays_o = np.broadcast_to(rays_o.astype(np.float32), rays_d.shape)
    return rays_o, rays_d


# ---------------------------------------------------------------------------
# AABB near/far


def near_far_aabb(bounds, ray_o, ray_d, margin: float = 0.01):
    """Slab-method ray/AABB intersection; misses get (near, far) = (0, 1).
    bounds: (2, 3); ray_o, ray_d: (..., 3).  Returns (near, far, mask)."""
    lo = bounds[0] - margin
    hi = bounds[1] + margin
    d = torch.where(ray_d == 0.0, torch.full_like(ray_d, 1e-8), ray_d)
    t0 = (lo - ray_o) / d
    t1 = (hi - ray_o) / d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    mask = tmax > tmin
    near = torch.minimum(tmin.abs(), tmax.abs())
    far = torch.maximum(tmin.abs(), tmax.abs())
    near = torch.where(mask, near, torch.zeros_like(near))
    far = torch.where(mask, far, torch.ones_like(far))
    return near.float(), far.float(), mask


def near_far_aabb_np(bounds, ray_o, ray_d, margin: float = 0.01):
    """Host numpy twin of :func:`near_far_aabb`."""
    lo = bounds[0] - margin
    hi = bounds[1] + margin
    d = np.where(ray_d == 0.0, 1e-8, ray_d)
    t0 = (lo - ray_o) / d
    t1 = (hi - ray_o) / d
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    mask = tmax > tmin
    near = np.where(mask, np.minimum(np.abs(tmin), np.abs(tmax)), 0.0)
    far = np.where(mask, np.maximum(np.abs(tmin), np.abs(tmax)), 1.0)
    return near.astype(np.float32), far.astype(np.float32), mask


# ---------------------------------------------------------------------------
# Projection & normals


def project_points(pts, K, R, T, eps: float = 1e-5):
    """World points (N, 3) -> (pixel xy (N, 2), camera xyz (N, 3)).
    Float32 products: the port leaves ``torch.backends.cuda.matmul.allow_tf32``
    at its default, False."""
    cam = pts @ R.T + T.reshape(1, 3)
    pix = cam @ K.T
    xy = pix[..., :2] / (pix[..., 2:3] + eps)
    return xy, cam


def vertex_normals(verts, faces, eps: float = 1e-8):
    """Face normals scatter-added to their corners, renormalized.
    verts: (V, 3); faces: (F, 3) int.  Returns (V, 3)."""
    tris = verts[faces]
    n = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=eps)
    out = torch.zeros_like(verts)
    for k in range(3):
        out.index_add_(0, faces[:, k], n)
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True),
                             min=eps)


def backface_mask(verts, faces, K, R, T):
    """True for vertices facing the camera (normal . view_dir < 0)."""
    _, cam = project_points(verts, K, R, T)
    n_cam = vertex_normals(verts, faces) @ R.T
    return (n_cam * cam).sum(dim=-1) < 0
