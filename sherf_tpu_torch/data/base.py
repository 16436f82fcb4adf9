"""Host-side dataset machinery (torch counterpart of the parts of
``sherf_tpu/data/base.py`` that the synthetic rigs use).

Items are dicts of numpy arrays built on the host; ``collate`` stacks them
into a :class:`SHERFBatch` on the caller's device.  The SMPL forward of the
data pipeline runs on CPU tensors of a CPU copy of the model
(``SMPLModel.host``), never on the card, so loader threads issue no CUDA
work.

Not ported yet (they need cv2's resize and ``fillPoly`` semantics, and the
file-backed loaders that call them): ``get_bound_2d_mask``,
``sample_rays_for_image`` and ``make_item``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sherf_tpu_torch.core.types import SHERFBatch, SMPLPose
from sherf_tpu_torch.smpl.lbs import big_pose_params, smpl_forward
from sherf_tpu_torch.smpl.model import SMPLModel


def host_smpl_verts(smpl: SMPLModel, poses, shapes):
    """SMPL forward of one pose on the CPU: (vertices (6890, 3), joints
    (24, 3)) as float32 numpy."""
    with torch.no_grad():
        v, j = smpl_forward(smpl.host(),
                            torch.from_numpy(np.asarray(poses, np.float32)),
                            torch.from_numpy(np.asarray(shapes, np.float32)))
    return v.numpy(), j.numpy()


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    """(reference THuman_dataset.get_bound_corners:28-41)"""
    mn, mx = bounds[0], bounds[1]
    return np.array([[mn[0], mn[1], mn[2]], [mn[0], mn[1], mx[2]],
                     [mn[0], mx[1], mn[2]], [mn[0], mx[1], mx[2]],
                     [mx[0], mn[1], mn[2]], [mx[0], mn[1], mx[2]],
                     [mx[0], mx[1], mn[2]], [mx[0], mx[1], mx[2]]])


def canonical_bounds(t_vertices: np.ndarray) -> np.ndarray:
    """(2, 3) box of the canonical body: 5 cm margin, 10 cm more in z."""
    mn = t_vertices.min(0) - 0.05
    mx = t_vertices.max(0) + 0.05
    mn[2] -= 0.1
    mx[2] += 0.1
    return np.stack([mn, mx]).astype(np.float32)


def _pose_from_params(params: Dict) -> Dict:
    return dict(
        poses=np.asarray(params["poses"], np.float32).reshape(72),
        shapes=np.asarray(params["shapes"], np.float32).reshape(-1)[:10],
        R=np.asarray(params["R"], np.float32).reshape(3, 3),
        Th=np.asarray(params["Th"], np.float32).reshape(3),
    )


def collate(items: Sequence[Dict], device="cuda") -> SHERFBatch:
    """Stack per-item dicts into a batch on ``device`` (NHWC images)."""
    def stack(key):
        return torch.from_numpy(np.stack([it[key] for it in items]))

    def stack_pose(key):
        ps = [_pose_from_params(it[key]) for it in items]
        return SMPLPose(**{f: torch.from_numpy(np.stack([p[f] for p in ps]))
                           for f in ("poses", "shapes", "R", "Th")})

    return SHERFBatch(
        t_pose=stack_pose("t_params"),
        t_vertices=stack("t_vertices"),
        t_bounds=stack("t_world_bounds"),
        pose=stack_pose("params"),
        vertices=stack("vertices"),
        img=stack("img"),
        ray_o=stack("ray_o"), ray_d=stack("ray_d"),
        near=stack("near"), far=stack("far"),
        mask_at_box=stack("mask_at_box"),
        bkgd_msk=stack("bkgd_msk"),
        obs_pose=stack_pose("obs_params"),
        obs_vertices=stack("obs_vertices"),
        obs_img=stack("obs_img"),
        obs_K=stack("obs_K"), obs_R=stack("obs_R"), obs_T=stack("obs_T"),
    ).to(device)


class HumanDataset:
    """Base class: index -> (instance, pose, view) decomposition and the
    canonical big-pose setup shared by the loaders.  ``sample_obs_view``
    draws from ``np.random.RandomState(seed)``, as the JAX loader does."""

    camera_view_num: int = 1

    def __init__(self, data_root: str, smpl: SMPLModel, split: str = "train",
                 multi_person: bool = True, num_instance: int = 1,
                 poses_start: int = 0, poses_interval: int = 1,
                 poses_num: int = 20, image_scaling: float = 1.0,
                 white_back: bool = False, sample_obs_view: bool = False,
                 fix_obs_view: bool = True, seed: int = 0):
        self.data_root = data_root
        self.smpl = smpl
        self.split = split
        self.multi_person = multi_person
        self.num_instance = num_instance
        self.poses_start = poses_start
        self.poses_interval = poses_interval
        self.poses_num = poses_num
        self.image_scaling = image_scaling
        self.white_back = white_back
        self.sample_obs_view = sample_obs_view
        self.fix_obs_view = fix_obs_view
        self.rng = np.random.RandomState(seed)

        # the eval protocols pin these (test_loop.py obs_pose_index /
        # obs_view_index)
        self.obs_pose_index: Optional[int] = None
        self.obs_view_index: Optional[int] = None

        self.big_pose = big_pose_params()
        t_vertices, _ = host_smpl_verts(smpl, self.big_pose["poses"],
                                        self.big_pose["shapes"])
        self.t_vertices = t_vertices.astype(np.float32)
        self.t_world_bounds = canonical_bounds(self.t_vertices)

    # -- shared index arithmetic (e.g. THuman_dataset.py:271-274)
    def _decompose(self, index):
        per_inst = self.poses_num * self.camera_view_num
        instance = index // per_inst if self.multi_person else 0
        pose = (index % per_inst) // self.camera_view_num
        view = index % self.camera_view_num
        return instance, pose, view

    def _obs_view(self) -> int:
        if self.obs_view_index is not None:
            return int(self.obs_view_index)
        if self.split == "train" and self.sample_obs_view:
            return int(self.rng.randint(self.camera_view_num))
        return self.default_obs_view

    def __len__(self):
        return self.num_instance * self.poses_num * self.camera_view_num
