"""THuman dataset pipeline (torch counterpart of
``sherf_tpu/data/thuman.py``; reference training/THuman_dataset.py).

Layout per subject directory:
  annots.npy                     — dict(cams={K,D,R,T}, ims=[{ims:[...]}, ...])
  <ims paths>                    — RGB jpgs, 24 views
  mask_cihp/<ims paths>.png      — person masks
  new_vertices/{i}.npy           — posed world vertices (6890, 3)
  new_params_neutral/{i}.npy     — dict(poses, shapes, R, Th)
Multi-person roots come from ../human_list.txt (first 90 = train split).
Each view is undistorted with its camera's D before scaling.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from sherf_tpu_torch.data.base import (HumanDataset, make_item, read_view,
                                       scale_view, subject_roots)
from sherf_tpu_torch.data.imgproc import undistort
from sherf_tpu_torch.smpl.model import SMPLModel


def _load_annots(subject_root: str):
    ann = np.load(os.path.join(subject_root, "annots.npy"),
                  allow_pickle=True).item()
    return ann["cams"], ann["ims"]


def load_frame_smpl(root: str, params_dir: str, frame_id: int):
    """(bounds, vertices, raw params dict) of a frame stored as
    ``new_vertices/{i}.npy`` and ``<params_dir>/{i}.npy``."""
    verts = np.load(os.path.join(root, "new_vertices", f"{frame_id}.npy")
                    ).astype(np.float32)
    raw = np.load(os.path.join(root, params_dir, f"{frame_id}.npy"),
                  allow_pickle=True).item()
    bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
    return bounds, verts, raw


class THumanDataset(HumanDataset):
    camera_view_num = 24
    default_obs_view = 12  # fix_obs_view (THuman_dataset.py:339-340)

    def __init__(self, data_root: str, smpl: SMPLModel, **kw):
        super().__init__(data_root, smpl, **kw)
        self.subjects = subject_roots(data_root, self.multi_person,
                                      self.num_instance)
        self.cams_all, self.ims_all = [], []
        for root in self.subjects:
            cams, ims = _load_annots(root)
            sel = ims[self.poses_start:
                      self.poses_start + self.poses_num * self.poses_interval]
            sel = sel[:: self.poses_interval]
            self.cams_all.append(cams)
            self.ims_all.append(np.array([
                np.array(d["ims"])[: self.camera_view_num] for d in sel]))

    def _load_view(self, root, cams, ims, pose_index, view_index):
        name = ims[pose_index][view_index].replace("\\", "/")
        img, msk = read_view(
            os.path.join(root, name),
            os.path.join(root, "mask_cihp", name.replace("jpg", "png")),
            self.white_back)
        K = np.array(cams["K"][view_index], np.float64)
        D = np.array(cams["D"][view_index], np.float64)
        R = np.array(cams["R"][view_index], np.float32)
        T = np.array(cams["T"][view_index], np.float32)
        img = undistort(img, K, D)
        msk = undistort(msk, K, D)
        img, msk, K = scale_view(img, msk, K, self.image_scaling)
        frame_id = int(os.path.basename(name)[:-4])
        return img, msk, K.astype(np.float32), R, T, frame_id

    def _load_smpl(self, root, frame_id):
        bounds, verts, raw = load_frame_smpl(root, "new_params_neutral",
                                             frame_id)
        params = dict(
            poses=np.asarray(raw["poses"], np.float32).reshape(72),
            shapes=np.asarray(raw["shapes"], np.float32).reshape(-1)[:10],
            R=np.asarray(raw["R"], np.float32).reshape(3, 3),
            Th=np.asarray(raw["Th"], np.float32).reshape(3),
        )
        return bounds, verts, params

    def __getitem__(self, index) -> Dict:
        inst, pose_index, view_index = self._decompose(index)
        root = self.subjects[inst]
        cams, ims = self.cams_all[inst], self.ims_all[inst]
        if pose_index >= len(ims):
            pose_index = int(self.rng.randint(len(ims)))

        img, msk, K, R, T, fid = self._load_view(root, cams, ims,
                                                 pose_index, view_index)
        world_bounds, vertices, params = self._load_smpl(root, fid)

        obs_pose = (int(self.obs_pose_index) if self.obs_pose_index is not None
                    else pose_index)
        obs_img, _, oK, oR, oT, ofid = self._load_view(
            root, cams, ims, obs_pose, self._obs_view())
        _, obs_vertices, obs_params = self._load_smpl(root, ofid)

        return make_item(
            img=img, msk=msk, K=K, R=R, T=T, world_bounds=world_bounds,
            params=params, vertices=vertices,
            obs_img=obs_img, obs_K=oK, obs_R=oR, obs_T=oT,
            obs_params=obs_params, obs_vertices=obs_vertices,
            t_params=self.big_pose, t_vertices=self.t_vertices,
            t_world_bounds=self.t_world_bounds, white_back=self.white_back)
