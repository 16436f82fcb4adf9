"""Camera pose samplers (the port's copy of ``sherf_tpu/geometry/cameras.py``,
reference camera_utils.py:22-148).

Look-at / uniform pose sampling plus cam2world and FOV -> intrinsics
helpers.  NumPy on the host; the samplers draw from the caller's
``np.random.RandomState``, in the JAX package's order, so a seed gives the
same poses in both packages.
"""

from __future__ import annotations

import numpy as np


def normalize(v, eps=1e-8):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


def create_cam2world_matrix(forward: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """OpenCV-style cam2world from a forward vector + origin
    (camera_utils.py:118-137)."""
    forward = normalize(forward)
    up = np.broadcast_to(np.array([0, 1, 0], np.float32), forward.shape)
    right = normalize(np.cross(up, forward))
    up = normalize(np.cross(forward, right))
    rot = np.stack([right, up, forward], axis=-1)
    m = np.tile(np.eye(4, dtype=np.float32), forward.shape[:-1] + (1, 1))
    m[..., :3, :3] = rot
    m[..., :3, 3] = origin
    return m


def look_at_pose(horizontal_mean, vertical_mean, lookat_position,
                 radius: float = 1.0, horizontal_stddev: float = 0.0,
                 vertical_stddev: float = 0.0, batch_size: int = 1, *,
                 rng: np.random.RandomState) -> np.ndarray:
    """LookAtPoseSampler.sample (camera_utils.py:58-85): spherical camera
    position looking at a pivot.  Returns (B, 4, 4) cam2world."""
    h = rng.randn(batch_size) * horizontal_stddev + horizontal_mean
    v = rng.randn(batch_size) * vertical_stddev + vertical_mean
    v = np.clip(v, 1e-5, np.pi - 1e-5)

    theta = h
    phi = v / np.pi
    phi = np.arccos(1 - 2 * phi)

    origin = np.stack([
        radius * np.sin(phi) * np.cos(np.pi - theta),
        radius * np.cos(phi),
        radius * np.sin(phi) * np.sin(np.pi - theta),
    ], axis=-1).astype(np.float32)
    lookat = np.broadcast_to(np.asarray(lookat_position, np.float32),
                             origin.shape)
    return create_cam2world_matrix(normalize(lookat - origin), origin)


def uniform_pose(h_mean, v_mean, h_stddev=0.0, v_stddev=0.0, radius=1.0,
                 batch_size=1, *, rng: np.random.RandomState) -> np.ndarray:
    """UniformCameraPoseSampler.sample (camera_utils.py:88-115).  The
    look-at step's own (zero-spread) draws come from a RandomState(0), as
    in the JAX package."""
    h = (rng.rand(batch_size) * 2 - 1) * h_stddev + h_mean
    v = (rng.rand(batch_size) * 2 - 1) * v_stddev + v_mean
    return look_at_pose(h, v, np.zeros(3), radius=radius, batch_size=batch_size,
                        rng=np.random.RandomState(0))


def fov_to_intrinsics(fov_degrees: float, H: int = 1, W: int = 1) -> np.ndarray:
    """FOV_to_intrinsics (camera_utils.py:140-148), normalized or pixel units."""
    focal = 1.0 / (2.0 * np.tan(np.radians(fov_degrees) / 2.0))
    return np.array([[focal * W, 0, 0.5 * W],
                     [0, focal * H, 0.5 * H],
                     [0, 0, 1]], np.float32)


def cam2world_to_KRT(c2w: np.ndarray):
    """cam2world (4,4) -> world->cam (R, T) as the datasets use."""
    R = c2w[:3, :3].T
    T = (-R @ c2w[:3, 3]).reshape(3, 1)
    return R.astype(np.float32), T.astype(np.float32)
