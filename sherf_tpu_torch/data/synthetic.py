"""Synthetic SHERF batches (torch counterpart of ``make_synthetic_batch`` and
``synthetic_camera`` in ``sherf_tpu/data/synthetic.py``).

Host numpy with the JAX package's random draws in the same order; SMPL runs
through the port's own torch forward on the CPU.  The same seed gives the
same batch as the JAX version, up to float32 rounding of the SMPL forward.
"""

from __future__ import annotations

import numpy as np
import torch

from sherf_tpu_torch.core.types import SHERFBatch, SMPLPose
from sherf_tpu_torch.geometry.rays import get_rays_np, near_far_aabb_np
from sherf_tpu_torch.smpl.lbs import big_pose_params, smpl_forward
from sherf_tpu_torch.smpl.model import SMPLModel


def synthetic_camera(H: int, W: int, rng: np.random.RandomState,
                     distance: float = 3.0):
    """A camera at ``distance`` meters looking at the origin from a random
    direction (mild elevation)."""
    theta = rng.uniform(0, 2 * np.pi)
    phi = rng.uniform(-0.3, 0.3)
    cam_pos = distance * np.array([
        np.cos(phi) * np.sin(theta), np.sin(phi), np.cos(phi) * np.cos(theta),
    ], dtype=np.float32)
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.array([0, 1, 0], dtype=np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd]).astype(np.float32)  # world -> cam
    T = (-R @ cam_pos).reshape(3, 1).astype(np.float32)
    f = 0.9 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)
    return K, R, T


def _splat_image(H, W, K, R, T, verts, rng, phase=None):
    """Cheap observation 'photo': vertices splatted with smooth colors.

    ``phase``: optional (3,) color phase.  When given, the appearance is a
    deterministic function of (vertex position, phase) — the SAME body
    renders the SAME colors from every camera, which is what makes a
    multi-view/multi-subject task consistent (an identity the model can
    learn to read off the observation image)."""
    img = np.zeros((H, W, 3), np.float32)
    cam = verts @ R.T + T[:, 0]
    pix = cam @ K.T
    xy = (pix[:, :2] / np.maximum(pix[:, 2:], 1e-5)).astype(np.int32)
    ok = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
    if phase is None:
        phase = rng.rand(3)
    colors = 0.5 + 0.5 * np.sin(verts * 7.0 + phase)
    img[xy[ok, 1], xy[ok, 0]] = colors[ok].astype(np.float32)
    return img


def _host_verts(smpl_cpu: SMPLModel, poses, shapes) -> np.ndarray:
    with torch.no_grad():
        v, _ = smpl_forward(smpl_cpu, torch.from_numpy(np.asarray(poses)),
                            torch.from_numpy(np.asarray(shapes)))
    return v.numpy()


def make_synthetic_batch(smpl: SMPLModel, batch_size: int = 1, H: int = 32,
                         W: int = 32, seed: int = 0, pose_scale: float = 0.25,
                         device="cuda") -> SHERFBatch:
    """A fully consistent batch: random poses, look-at cameras, rays with
    body-AABB near/far and vertex-splat images, on ``device``."""
    rng = np.random.RandomState(seed)
    smpl_cpu = smpl.to("cpu")
    bp = big_pose_params()
    t_verts = _host_verts(smpl_cpu, bp["poses"], bp["shapes"])
    t_min = t_verts.min(0) - 0.05
    t_max = t_verts.max(0) + 0.05
    t_min[2] -= 0.1
    t_max[2] += 0.1
    t_bounds = np.stack([t_min, t_max])

    items = []
    for b in range(batch_size):
        pose = (rng.randn(72) * pose_scale).astype(np.float32)
        pose[:3] = 0
        shape = (rng.randn(10) * 0.3).astype(np.float32)
        R_g = np.eye(3, dtype=np.float32)
        Th = rng.randn(3).astype(np.float32) * 0.05

        v_smpl = _host_verts(smpl_cpu, pose, shape)
        verts = v_smpl @ np.linalg.inv(R_g) + Th

        wb = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
        K, Rc, Tc = synthetic_camera(H, W, rng)
        ray_o, ray_d = get_rays_np(H, W, K, Rc, Tc)
        ray_o = ray_o.reshape(-1, 3)
        ray_d = ray_d.reshape(-1, 3)
        near, far, mask = near_far_aabb_np(wb, ray_o, ray_d)

        oK, oR, oT = synthetic_camera(H, W, rng)
        obs_img = _splat_image(H, W, oK, oR, oT, verts, rng)
        tgt_img = _splat_image(H, W, K, Rc, Tc, verts, rng)
        items.append(dict(
            pose=pose, shape=shape, R=R_g, Th=Th, verts=verts,
            ray_o=ray_o, ray_d=ray_d, near=near, far=far, mask=mask,
            img=tgt_img, obs_img=obs_img, oK=oK, oR=oR, oT=oT,
        ))

    st = lambda k: torch.from_numpy(np.stack([it[k] for it in items]))
    rep = lambda a: torch.from_numpy(np.repeat(np.asarray(a)[None], batch_size,
                                               axis=0))
    t_pose = SMPLPose(poses=rep(bp["poses"]), shapes=rep(bp["shapes"]),
                      R=rep(bp["R"]), Th=rep(bp["Th"]))
    pose = SMPLPose(poses=st("pose"), shapes=st("shape"), R=st("R"),
                    Th=st("Th"))
    mask = st("mask")
    batch = SHERFBatch(
        t_pose=t_pose,
        t_vertices=rep(t_verts.astype(np.float32)),
        t_bounds=rep(t_bounds.astype(np.float32)),
        pose=pose,
        vertices=st("verts"),
        img=st("img"),
        ray_o=st("ray_o"), ray_d=st("ray_d"),
        near=st("near"), far=st("far"),
        mask_at_box=mask,
        bkgd_msk=mask.float(),
        obs_pose=pose,
        obs_vertices=st("verts"),
        obs_img=st("obs_img"),
        obs_K=st("oK"), obs_R=st("oR"), obs_T=st("oT"),
    )
    return batch.to(device)
