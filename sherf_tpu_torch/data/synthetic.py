"""Synthetic SHERF data (torch counterpart of ``sherf_tpu/data/synthetic.py``):
``make_synthetic_batch``, the on-the-fly ``SyntheticDataset`` and the
grid-indexed ``SyntheticHumanDataset`` rig, with no files on disk.

Host numpy with the JAX package's random draws in the same order; SMPL runs
through the port's own torch forward on the CPU (``base.host_smpl_verts``).
The same seed gives the same items as the JAX version, up to float32
rounding of the SMPL forward.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sherf_tpu_torch.core.types import SHERFBatch, SMPLPose
from sherf_tpu_torch.data.base import (HumanDataset, canonical_bounds,
                                       host_smpl_verts)
from sherf_tpu_torch.geometry.rays import get_rays_np, near_far_aabb_np
from sherf_tpu_torch.smpl.lbs import big_pose_params
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


def make_synthetic_batch(smpl: SMPLModel, batch_size: int = 1, H: int = 32,
                         W: int = 32, seed: int = 0, pose_scale: float = 0.25,
                         device="cuda") -> SHERFBatch:
    """A fully consistent batch: random poses, look-at cameras, rays with
    body-AABB near/far and vertex-splat images, on ``device``."""
    rng = np.random.RandomState(seed)
    bp = big_pose_params()
    t_verts = host_smpl_verts(smpl, bp["poses"], bp["shapes"])[0]
    t_bounds = canonical_bounds(t_verts)

    items = []
    for b in range(batch_size):
        pose = (rng.randn(72) * pose_scale).astype(np.float32)
        pose[:3] = 0
        shape = (rng.randn(10) * 0.3).astype(np.float32)
        R_g = np.eye(3, dtype=np.float32)
        Th = rng.randn(3).astype(np.float32) * 0.05

        v_smpl = host_smpl_verts(smpl, pose, shape)[0]
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


class SyntheticDataset:
    """On-the-fly synthetic dataset with the standard item schema, so that
    ``PrefetchLoader`` + ``collate`` (``DataConfig(name="synthetic")``) run
    with no files on disk.  Item ``i`` is deterministic in (seed, i).

    ``subjects``: when set, item ``i`` belongs to subject ``subject_offset
    + i % subjects``, a deterministic identity (SMPL shape, appearance
    phase) shared by every item of that subject (the reference trains
    across many subjects, RenderPeople_dataset.py:151-175); pose and
    cameras still vary per item.  A held-out subject is any id outside
    [subject_offset, subject_offset + subjects).
    """

    camera_view_num = 4

    def __init__(self, smpl: SMPLModel, H: int = 64, W: int = 64,
                 poses_num: int = 20, size: int = 64, seed: int = 0,
                 pose_scale: float = 0.25,
                 subjects: Optional[int] = None, subject_offset: int = 0):
        self.smpl = smpl
        self.H, self.W = H, W
        self.poses_num = poses_num
        self.size = size
        self.seed = seed
        self.pose_scale = pose_scale
        self.subjects = subjects
        self.subject_offset = subject_offset
        self._subj_cache = {}

        bp = big_pose_params()
        self._t_verts = host_smpl_verts(smpl, bp["poses"], bp["shapes"])[0]
        self._t_bounds = canonical_bounds(self._t_verts)
        self._t_params = dict(poses=bp["poses"], shapes=bp["shapes"],
                              R=bp["R"], Th=bp["Th"])

    def __len__(self):
        return self.size

    @staticmethod
    def subject_identity(sid: int):
        """Deterministic identity of global subject ``sid``: (SMPL shape,
        appearance phase).  Depends on the subject id only."""
        srng = np.random.RandomState(7919 * (sid + 13))
        shape = (srng.randn(10) * 0.3).astype(np.float32)
        phase = srng.rand(3)
        return shape, phase

    def subject_canonical(self, sid: int):
        """The subject's canonical body (see ``_subject_canonical``)."""
        return _subject_canonical(self.smpl, sid, self._subj_cache)

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        H, W = self.H, self.W
        pose = (rng.randn(72) * self.pose_scale).astype(np.float32)
        pose[:3] = 0
        phase = None
        t_vertices, t_bounds, t_params = (self._t_verts, self._t_bounds,
                                          self._t_params)
        if self.subjects is not None:
            # the identity depends on the subject id only (not the seed), so
            # a held-out split built with another seed or offset indexes the
            # same global subject space
            sid = self.subject_offset + i % self.subjects
            shape, phase = self.subject_identity(sid)
            t_vertices, t_bounds, t_params = self.subject_canonical(sid)
        else:
            shape = (rng.randn(10) * 0.3).astype(np.float32)
        R_g = np.eye(3, dtype=np.float32)
        Th = rng.randn(3).astype(np.float32) * 0.05
        params = dict(poses=pose, shapes=shape, R=R_g, Th=Th)

        v_smpl = host_smpl_verts(self.smpl, pose, shape)[0]
        verts = (v_smpl @ np.linalg.inv(R_g) + Th).astype(np.float32)

        wb = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
        K, Rc, Tc = synthetic_camera(H, W, rng)
        ray_o, ray_d = get_rays_np(H, W, K, Rc, Tc)
        ray_o = ray_o.reshape(-1, 3)
        ray_d = ray_d.reshape(-1, 3)
        near, far, mask = near_far_aabb_np(wb, ray_o, ray_d)

        oK, oR, oT = synthetic_camera(H, W, rng)
        obs_img = _splat_image(H, W, oK, oR, oT, verts, rng, phase=phase)
        tgt_img = _splat_image(H, W, K, Rc, Tc, verts, rng, phase=phase)

        return dict(
            img=tgt_img.astype(np.float32),
            ray_o=ray_o, ray_d=ray_d, near=near, far=far,
            mask_at_box=mask,
            bkgd_msk=mask.astype(np.float32).reshape(-1),
            params=params, vertices=verts,
            obs_img=obs_img.astype(np.float32),
            obs_K=oK.astype(np.float32), obs_R=oR.astype(np.float32),
            obs_T=oT.reshape(3, 1).astype(np.float32),
            obs_params=params, obs_vertices=verts,
            t_params=t_params, t_vertices=t_vertices,
            t_world_bounds=t_bounds,
        )


def _subject_canonical(smpl: SMPLModel, sid: int, cache: dict):
    """Global subject ``sid``'s canonical body: the big-pose SMPL forward
    with the subject's shape (RenderPeople_dataset.py prepare_input).
    Returns (t_vertices (6890, 3), t_bounds (2, 3), t_params dict), kept in
    ``cache`` by subject id."""
    if sid not in cache:
        shape, _ = SyntheticDataset.subject_identity(sid)
        bp = big_pose_params()
        tv = host_smpl_verts(smpl, bp["poses"], shape)[0]
        t_params = dict(poses=bp["poses"], shapes=shape, R=bp["R"],
                        Th=bp["Th"])
        cache[sid] = (tv, canonical_bounds(tv), t_params)
    return cache[sid]


def fixed_ring_camera(H: int, W: int, view: int, n_views: int,
                      distance: float = 3.0):
    """Camera ``view`` of an ``n_views`` azimuth ring (mild deterministic
    elevation) looking at the origin: the synthetic stand-in for a capture
    rig's fixed cameras (e.g. THuman's 24 views, THuman_dataset.py:156)."""
    theta = 2.0 * np.pi * view / n_views
    phi = 0.25 * np.sin(3.0 * theta + 0.5)
    cam_pos = distance * np.array([
        np.cos(phi) * np.sin(theta), np.sin(phi), np.cos(phi) * np.cos(theta),
    ], dtype=np.float32)
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.array([0, 1, 0], dtype=np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd]).astype(np.float32)
    T = (-R @ cam_pos).reshape(3, 1).astype(np.float32)
    f = 0.9 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)
    return K, R, T


class SyntheticHumanDataset(HumanDataset):
    """Grid-indexed synthetic rig with the file-backed loaders' index
    semantics: item k decomposes as (instance, pose, view), cameras are a
    fixed ring of 6, poses are deterministic per (subject, global pose id).
    The eval protocols and the training pipeline drive it as they drive
    RenderPeople / THuman / HuMMan / ZJU, with no files on disk.

    Subject identity is :meth:`SyntheticDataset.subject_identity`.
    ``data_root`` is ``"subject<id>"``; with ``multi_person=True`` instance
    i is subject base + i (the reference's humans_list role,
    RenderPeople_dataset.py:151-175).  ``resolution`` is the rig's native
    resolution; ``image_scaling`` maps it to the render resolution.
    """

    camera_view_num = 6
    default_obs_view = 0

    def __init__(self, data_root: str = "subject0", smpl: SMPLModel = None,
                 resolution: int = 512, pose_scale: float = 0.25, **kw):
        super().__init__(data_root, smpl, **kw)
        self.H = self.W = int(round(resolution * self.image_scaling))
        self.pose_scale = pose_scale
        name = os.path.basename(str(data_root).strip().rstrip("/"))
        digits = "".join(c for c in name if c.isdigit())
        self.subject_base = int(digits) if digits else 0
        self._subj_cache = {}

    def _subject(self, sid: int):
        """(t_vertices, t_bounds, t_params, shape, phase) of subject sid;
        cached (the loaders' per-subject canonical SMPL forward, e.g.
        THuman_dataset.py:225-257)."""
        shape, phase = SyntheticDataset.subject_identity(sid)
        return (*_subject_canonical(self.smpl, sid, self._subj_cache), shape,
                phase)

    def _pose_params(self, sid: int, pose_idx: int):
        """Deterministic pose of (subject, relative pose index); the global
        pose id applies poses_start / poses_interval like the loaders' frame
        indexing (THuman_dataset.py:271-274)."""
        pid = self.poses_start + pose_idx * self.poses_interval
        rng = np.random.RandomState(131071 * (sid + 3) + 31 * pid + 5)
        pose = (rng.randn(72) * self.pose_scale).astype(np.float32)
        pose[:3] = 0
        Th = (rng.randn(3) * 0.05).astype(np.float32)
        return pose, np.eye(3, dtype=np.float32), Th

    def _frame(self, sid: int, pose_idx: int, view: int):
        """One (pose, view) frame of a subject: posed world verts, ring
        camera, splat image, params."""
        tv, tb, t_params, shape, phase = self._subject(sid)
        pose, R_g, Th = self._pose_params(sid, pose_idx)
        v_smpl = host_smpl_verts(self.smpl, pose, shape)[0]
        verts = (v_smpl @ np.linalg.inv(R_g) + Th).astype(np.float32)
        K, Rc, Tc = fixed_ring_camera(self.H, self.W, view,
                                      self.camera_view_num)
        img = _splat_image(self.H, self.W, K, Rc, Tc, verts,
                           np.random.RandomState(0), phase=phase)
        params = dict(poses=pose, shapes=shape, R=R_g, Th=Th)
        return verts, K, Rc, Tc, img, params, tv, tb, t_params

    def __getitem__(self, k):
        instance, pose_idx, view = self._decompose(k)
        sid = self.subject_base + instance
        (verts, K, Rc, Tc, img, params, tv, tb, t_params) = self._frame(
            sid, pose_idx, view)

        wb = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
        ray_o, ray_d = get_rays_np(self.H, self.W, K, Rc, Tc)
        ray_o = ray_o.reshape(-1, 3)
        ray_d = ray_d.reshape(-1, 3)
        near, far, mask = near_far_aabb_np(wb, ray_o, ray_d)

        obs_pose_idx = (int(self.obs_pose_index)
                        if self.obs_pose_index is not None else pose_idx)
        (overts, oK, oR, oT, obs_img, oparams, _, _, _) = self._frame(
            sid, obs_pose_idx, self._obs_view())

        return dict(
            img=img.astype(np.float32),
            ray_o=ray_o, ray_d=ray_d, near=near, far=far,
            mask_at_box=mask,
            bkgd_msk=mask.astype(np.float32).reshape(-1),
            params=params, vertices=verts,
            obs_img=obs_img.astype(np.float32),
            obs_K=oK.astype(np.float32), obs_R=oR.astype(np.float32),
            obs_T=oT.reshape(3, 1).astype(np.float32),
            obs_params=oparams, obs_vertices=overts,
            t_params=t_params, t_vertices=tv,
            t_world_bounds=tb,
        )

    def subject_bodies(self):
        """Canonical (big-pose) vertices of every served subject, which
        ``training_loop`` sizes the voxel grid and sparse caps over."""
        n = self.num_instance if self.multi_person else 1
        return [self._subject(self.subject_base + i)[0] for i in range(n)]
