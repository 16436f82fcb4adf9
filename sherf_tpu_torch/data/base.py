"""Host-side dataset machinery (torch counterpart of
``sherf_tpu/data/base.py``): the per-item pipeline the four file-backed
loaders share (read -> resize -> bound mask -> rays -> AABB near/far,
e.g. reference THuman_dataset.py:104-144) and the collation into a
:class:`SHERFBatch`.

Items are dicts of numpy arrays built on the host; ``collate`` stacks them
into a :class:`SHERFBatch` on the caller's device.  The SMPL forward of the
data pipeline runs on CPU tensors of a CPU copy of the model
(``SMPLModel.host``), never on the card, so loader threads issue no CUDA
work.  Images are decoded and resized by the port's own numpy code
(``data/jpeg.py``, ``data/png_read.py``, ``data/imgproc.py``): the machines
the port runs on have no imaging package.  Rays come from the native
host-ops library (``sherf_tpu_torch/native``) whenever it builds, else from
numpy (``get_rays_np``, ``near_far_aabb_np``), as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sherf_tpu_torch import native
from sherf_tpu_torch.core.types import SHERFBatch, SMPLPose
from sherf_tpu_torch.data.bmp import decode_bmp
from sherf_tpu_torch.data.imgproc import fill_poly, resize_area, resize_nearest
from sherf_tpu_torch.data.jpeg import decode_jpeg
from sherf_tpu_torch.data.png_read import decode_png
from sherf_tpu_torch.geometry.rays import get_rays_np, near_far_aabb_np
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


def get_bound_2d_mask(bounds, K, pose, H, W) -> np.ndarray:
    """Projected-3D-box raster mask (THuman_dataset.py:54-65): the six
    faces of the box's projection filled as ``cv2.fillPoly`` fills them."""
    corners = get_bound_corners(bounds)
    xyz = corners @ pose[:, :3].T + pose[:, 3:].T
    xy = xyz @ K.T
    xy = np.round(xy[:, :2] / xy[:, 2:]).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in ([0, 1, 3, 2, 0], [4, 5, 7, 6, 4], [0, 1, 5, 4, 0],
                 [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1]):
        fill_poly(mask, xy[face])
    return mask


def decode_image(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A JPEG, BMP or PNG file's bytes as ``imageio.v2.imread`` returns
    them (by their content, not the file's name)."""
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, path)
    if data[:2] == b"BM":
        return decode_bmp(data, path)
    return decode_png(data, path)


def read_image(path: str) -> np.ndarray:
    """A JPEG, BMP or PNG file as ``imageio.v2.imread`` returns it."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def read_view(img_path: str, msk_path: str, white_back: bool):
    """A view's RGB in [0, 1] (float32, first three channels) and its mask
    (float32 0 / 1, first channel), the background set to 0 (1 with
    ``white_back``), as each JAX loader's ``_load_view`` reads them."""
    img = np.asarray(read_image(img_path), np.float32)
    if img.ndim == 3:
        img = img[..., :3]
    img = img / 255.0
    msk = np.asarray(read_image(msk_path))
    msk = (msk != 0).astype(np.float32)
    if msk.ndim == 3:
        msk = msk[..., 0]
    img = img.copy()
    img[msk == 0] = 1.0 if white_back else 0.0
    return img, msk


def scale_view(img, msk, K, image_scaling: float):
    """Resize a view by ``image_scaling`` (area for the image, nearest for
    the mask, ``int`` sizes) and scale K's first two rows to match."""
    if image_scaling == 1.0:
        return img, msk, K
    H, W = img.shape[:2]
    H, W = int(H * image_scaling), int(W * image_scaling)
    img = resize_area(img, (W, H))
    msk = resize_nearest(msk, (W, H))
    K = K.copy()
    K[:2] = K[:2] * image_scaling
    return img, msk, K


def sample_rays_for_image(img, msk, K, R, T, bounds,
                          white_back: bool = False):
    """The shared sample_ray_*_batch pipeline on a view that its loader has
    already scaled.  Returns
    (img, ray_o, ray_d, near, far, mask_at_box, bkgd_msk)."""
    H, W = img.shape[:2]
    pose = np.concatenate([R, T.reshape(3, 1)], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)

    msk = msk * bound_mask
    img = img.copy()
    img[bound_mask != 1] = 1.0 if white_back else 0.0

    rays = native.prepare_rays_native(H, W, K, R, T, bounds)
    if rays is not None:
        ray_o, ray_d, near, far, mask_at_box = rays
    else:
        ray_o, ray_d = get_rays_np(H, W, K, R, T)
        ray_o = ray_o.reshape(-1, 3).astype(np.float32)
        ray_d = ray_d.reshape(-1, 3).astype(np.float32)
        near, far, mask_at_box = near_far_aabb_np(bounds, ray_o, ray_d)
    return img, ray_o, ray_d, near, far, mask_at_box, msk


def make_item(*, img, msk, K, R, T, world_bounds, params, vertices,
              obs_img, obs_K, obs_R, obs_T, obs_params, obs_vertices,
              t_params, t_vertices, t_world_bounds,
              white_back: bool = False) -> Dict:
    """Assemble one training / eval item (numpy, HWC images)."""
    img, ray_o, ray_d, near, far, mask_at_box, bkgd = sample_rays_for_image(
        img, msk, K, R, T, world_bounds, white_back)
    return dict(
        img=img.astype(np.float32),
        ray_o=ray_o, ray_d=ray_d, near=near, far=far,
        mask_at_box=mask_at_box,
        bkgd_msk=(bkgd != 0).astype(np.float32).reshape(-1),
        params=params, vertices=vertices.astype(np.float32),
        obs_img=obs_img.astype(np.float32),
        obs_K=obs_K.astype(np.float32), obs_R=obs_R.astype(np.float32),
        obs_T=obs_T.reshape(3, 1).astype(np.float32),
        obs_params=obs_params, obs_vertices=obs_vertices.astype(np.float32),
        t_params=t_params, t_vertices=t_vertices.astype(np.float32),
        t_world_bounds=t_world_bounds.astype(np.float32),
    )


def subject_roots(data_root: str, multi_person: bool, num_instance: int):
    """The subject directories a loader serves: with ``multi_person`` the
    first ``num_instance`` names of ``../human_list.txt``, else
    ``data_root`` alone."""
    if not multi_person:
        return [data_root]
    humans_root = os.path.dirname(data_root)
    with open(os.path.join(humans_root, "human_list.txt")) as f:
        names = [x.strip() for x in f.readlines()[:num_instance]]
    return [os.path.join(humans_root, n) for n in names]


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
