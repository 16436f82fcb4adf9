"""ZJU-MoCap (Neural Body) dataset pipeline (torch counterpart of
``sherf_tpu/data/zju.py``; reference training/NeuBody_dataset.py).

Layout per subject (CoreView_XXX, 20+ views at 1024x1024; the shipped
configs use image_scaling 0.5, 512x512):
  annots.npy                — dict(cams={K,D,R,T}, ims=[{ims: [...]}, ...])
  mask_cihp/<im>.png        — person masks
  new_vertices/{i}.npy      — posed world vertices
  new_params/{i}.npy        — dict(poses, shapes, Rh, Th); R = Rodrigues(Rh)
Quirks kept: the CoreView_313/315 file-name remap (NeuBody_dataset.py:
198-200), T in millimetres (divided by 1000), the training subjects fixed
to 386/387/390/392/393/394 (:209-212), observation view 10 when not
sampling (:451).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from sherf_tpu_torch.data.base import (HumanDataset, make_item, read_view,
                                       scale_view)
from sherf_tpu_torch.data.imgproc import rodrigues
from sherf_tpu_torch.data.thuman import load_frame_smpl
from sherf_tpu_torch.smpl.model import SMPLModel

TRAIN_SUBJECTS = ["CoreView_386", "CoreView_387", "CoreView_390",
                  "CoreView_392", "CoreView_393", "CoreView_394"]


class ZJUMoCapDataset(HumanDataset):
    camera_view_num = 20
    default_obs_view = 10  # NeuBody_dataset.py:451

    def __init__(self, data_root: str, smpl: SMPLModel, **kw):
        kw.setdefault("image_scaling", 0.5)
        super().__init__(data_root, smpl, **kw)
        humans_root = os.path.dirname(data_root)
        if self.multi_person:
            self.subjects = [os.path.join(humans_root, n)
                             for n in TRAIN_SUBJECTS]
        else:
            self.subjects = [data_root]

        self.cams_all, self.ims_all, self.cam_inds_all = [], [], []
        for root in self.subjects:
            ann = np.load(os.path.join(root, "annots.npy"),
                          allow_pickle=True).item()
            sel = ann["ims"][self.poses_start:
                             self.poses_start
                             + self.poses_num * self.poses_interval]
            sel = sel[:: self.poses_interval]
            view_ids = list(range(self.camera_view_num))
            ims = np.array([np.array(d["ims"])[view_ids] for d in sel])
            cam_inds = np.array([np.arange(len(d["ims"]))[view_ids]
                                 for d in sel])
            if "CoreView_313" in root or "CoreView_315" in root:
                for i in range(ims.shape[0]):
                    ims[i] = [x.split("/")[0] + "/"
                              + x.split("/")[1].split("_")[4] + ".jpg"
                              for x in ims[i]]
            self.cams_all.append(ann["cams"])
            self.ims_all.append(ims)
            self.cam_inds_all.append(cam_inds)

    def _load_view(self, root, cams, ims, cam_inds, pose_index, view_index):
        name = ims[pose_index][view_index].replace("\\", "/")
        img, msk = read_view(os.path.join(root, name),
                             os.path.join(root, "mask_cihp", name)[:-4]
                             + ".png", self.white_back)
        ci = cam_inds[pose_index][view_index]
        K = np.array(cams["K"][ci], np.float32)
        R = np.array(cams["R"][ci], np.float32)
        T = (np.array(cams["T"][ci], np.float32) / 1000.0).reshape(3, 1)
        img, msk, K = scale_view(img, msk, K, self.image_scaling)
        frame_id = int(os.path.basename(name)[:-4])
        return img, msk, K, R, T, frame_id

    def _load_smpl(self, root, frame_id):
        bounds, verts, raw = load_frame_smpl(root, "new_params", frame_id)
        R = rodrigues(np.asarray(raw["Rh"], np.float64).reshape(3))
        params = dict(
            poses=np.asarray(raw["poses"], np.float32).reshape(72),
            shapes=np.asarray(raw["shapes"], np.float32).reshape(-1)[:10],
            R=R.astype(np.float32),
            Th=np.asarray(raw["Th"], np.float32).reshape(3),
        )
        return bounds, verts, params

    def __getitem__(self, index) -> Dict:
        inst, pose_index, view_index = self._decompose(index)
        root = self.subjects[inst]
        cams, ims = self.cams_all[inst], self.ims_all[inst]
        cam_inds = self.cam_inds_all[inst]
        if pose_index >= len(ims):
            pose_index = int(self.rng.randint(len(ims)))

        img, msk, K, R, T, fid = self._load_view(root, cams, ims, cam_inds,
                                                 pose_index, view_index)
        world_bounds, vertices, params = self._load_smpl(root, fid)

        obs_pose = (int(self.obs_pose_index) if self.obs_pose_index is not None
                    else pose_index)
        obs_img, _, oK, oR, oT, ofid = self._load_view(
            root, cams, ims, cam_inds, obs_pose, self._obs_view())
        _, obs_vertices, obs_params = self._load_smpl(root, ofid)

        return make_item(
            img=img, msk=msk, K=K, R=R, T=T, world_bounds=world_bounds,
            params=params, vertices=vertices,
            obs_img=obs_img, obs_K=oK, obs_R=oR, obs_T=oT,
            obs_params=obs_params, obs_vertices=obs_vertices,
            t_params=self.big_pose, t_vertices=self.t_vertices,
            t_world_bounds=self.t_world_bounds, white_back=self.white_back)
