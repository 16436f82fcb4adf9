"""HuMMan dataset pipeline (torch counterpart of
``sherf_tpu/data/humman.py``; reference training/HuMMan_dataset.py).

Layout per subject (mobile capture, 10 kinect views, native 1920x1080;
the shipped configs render at 1/3 scale, 640x360):
  cameras.json                          — {kinect_color_%03d: {K, R, T}}
  kinect_color/kinect_%03d/%06d.png     — RGB
  kinect_mask/kinect_%03d/%06d.png      — masks
  smpl_params/%06d.npz                  — betas, body_pose, global_orient, transl
Quirks kept: the global orientation goes into R (not poses[:3]); Th is
corrected by the pelvis shift (HuMMan_dataset.py:227-234).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from sherf_tpu_torch.data.base import (HumanDataset, host_smpl_verts,
                                       make_item, read_view, scale_view,
                                       subject_roots)
from sherf_tpu_torch.data.imgproc import rodrigues
from sherf_tpu_torch.smpl.model import SMPLModel


class HuMManDataset(HumanDataset):
    camera_view_num = 10
    default_obs_view = 0

    def __init__(self, data_root: str, smpl: SMPLModel, **kw):
        kw.setdefault("image_scaling", 1.0 / 3.0)
        super().__init__(data_root, smpl, **kw)
        self.subjects = subject_roots(data_root, self.multi_person,
                                      self.num_instance)
        self.cams_all = []
        for r in self.subjects:
            with open(os.path.join(r, "cameras.json")) as f:
                self.cams_all.append(json.load(f))

    def _load_view(self, root, cams, pose_index, view_index):
        img, msk = read_view(
            os.path.join(root, "kinect_color", f"kinect_{view_index:03d}",
                         f"{pose_index:06d}.png"),
            os.path.join(root, "kinect_mask", f"kinect_{view_index:03d}",
                         f"{pose_index:06d}.png"), self.white_back)
        c = cams[f"kinect_color_{view_index:03d}"]
        K = np.array(c["K"], np.float32)
        R = np.array(c["R"], np.float32)
        T = np.array(c["T"], np.float32).reshape(3, 1)
        img, msk, K = scale_view(img, msk, K, self.image_scaling)
        return img, msk, K, R, T

    def _load_smpl(self, root, pose_index):
        raw = np.load(os.path.join(root, "smpl_params",
                                   f"{pose_index:06d}.npz"))
        poses = np.zeros(72, np.float32)
        poses[3:] = np.asarray(raw["body_pose"], np.float32).reshape(69)
        R = rodrigues(np.asarray(raw["global_orient"], np.float64))
        params = dict(
            poses=poses,
            shapes=np.asarray(raw["betas"], np.float32).reshape(-1)[:10],
            R=R.astype(np.float32),
            Th=np.asarray(raw["transl"], np.float32).reshape(3),
        )
        xyz, joints = host_smpl_verts(self.smpl, params["poses"],
                                      params["shapes"])
        # pelvis-shift correction of Th (HuMMan_dataset.py:227-234)
        pelvis_shift = joints[:1] - joints[:1] @ params["R"].T
        params["Th"] = (params["Th"] + pelvis_shift.reshape(3)
                        ).astype(np.float32)
        verts = (xyz @ params["R"].T + params["Th"]).astype(np.float32)
        bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
        return bounds, verts, params

    def __getitem__(self, index) -> Dict:
        inst, pose_rel, view_index = self._decompose(index)
        pose_index = pose_rel * self.poses_interval + self.poses_start
        root, cams = self.subjects[inst], self.cams_all[inst]

        img, msk, K, R, T = self._load_view(root, cams, pose_index, view_index)
        world_bounds, vertices, params = self._load_smpl(root, pose_index)

        obs_pose = (int(self.obs_pose_index) if self.obs_pose_index is not None
                    else pose_index)
        obs_img, _, oK, oR, oT = self._load_view(root, cams, obs_pose,
                                                 self._obs_view())
        _, obs_vertices, obs_params = self._load_smpl(root, obs_pose)

        return make_item(
            img=img, msk=msk, K=K, R=R, T=T, world_bounds=world_bounds,
            params=params, vertices=vertices,
            obs_img=obs_img, obs_K=oK, obs_R=oR, obs_T=oT,
            obs_params=obs_params, obs_vertices=obs_vertices,
            t_params=self.big_pose, t_vertices=self.t_vertices,
            t_world_bounds=self.t_world_bounds, white_back=self.white_back)
