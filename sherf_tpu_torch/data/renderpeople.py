"""RenderPeople dataset pipeline (torch counterpart of
``sherf_tpu/data/renderpeople.py``; reference
training/RenderPeople_dataset.py).

Layout per subject:
  cameras.json                         — {camera%04d: {K, R, T}} x36 views
  img/camera%04d/%04d.jpg              — RGB
  mask/camera%04d/%04d.png             — masks
  outputs_re_fitting/refit_smpl_2nd.npz — {'smpl': {betas, global_orient,
                                           body_pose, transl}} per pose
Vertices come from the host SMPL forward (prepare_input,
RenderPeople_dataset.py:206-220); global R is identity and Th = transl.
Quirk kept: the big-pose params carry R = ones((3, 3))
(RenderPeople_dataset.py:226), which the warps never read.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from sherf_tpu_torch.data.base import (HumanDataset, host_smpl_verts,
                                       make_item, read_view, scale_view,
                                       subject_roots)
from sherf_tpu_torch.smpl.model import SMPLModel


class RenderPeopleDataset(HumanDataset):
    camera_view_num = 36
    default_obs_view = 0  # fix_obs_view (RenderPeople_dataset.py:311-312)

    def __init__(self, data_root: str, smpl: SMPLModel, **kw):
        super().__init__(data_root, smpl, **kw)
        self.big_pose = dict(self.big_pose)
        self.big_pose["R"] = np.ones((3, 3), np.float32)
        self.subjects = subject_roots(data_root, self.multi_person,
                                      self.num_instance)
        self.cams_all = []
        for r in self.subjects:
            with open(os.path.join(r, "cameras.json")) as f:
                self.cams_all.append(json.load(f))

    def _load_view(self, root, cams, pose_index, view_index):
        img, msk = read_view(
            os.path.join(root, "img", f"camera{view_index:04d}",
                         f"{pose_index:04d}.jpg"),
            os.path.join(root, "mask", f"camera{view_index:04d}",
                         f"{pose_index:04d}.png"), self.white_back)
        c = cams[f"camera{view_index:04d}"]
        K = np.array(c["K"], np.float32)
        R = np.array(c["R"], np.float32)
        T = np.array(c["T"], np.float32).reshape(3, 1)
        img, msk, K = scale_view(img, msk, K, self.image_scaling)
        return img, msk, K, R, T

    def _smpl_params(self, root, pose_index) -> Dict:
        path = os.path.join(root, "outputs_re_fitting", "refit_smpl_2nd.npz")
        raw = dict(np.load(path, allow_pickle=True))["smpl"].item()
        poses = np.zeros(72, np.float32)
        poses[:3] = np.asarray(raw["global_orient"][pose_index],
                               np.float32).reshape(3)
        poses[3:] = np.asarray(raw["body_pose"][pose_index],
                               np.float32).reshape(69)
        return dict(
            poses=poses,
            shapes=np.asarray(raw["betas"], np.float32).reshape(-1)[:10],
            R=np.eye(3, dtype=np.float32),
            Th=np.asarray(raw["transl"][pose_index], np.float32).reshape(3),
        )

    def _load_smpl(self, root, pose_index):
        params = self._smpl_params(root, pose_index)
        xyz = host_smpl_verts(self.smpl, params["poses"], params["shapes"])[0]
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
