"""SMPL model constants (torch counterpart of ``sherf_tpu/smpl/model.py``).

``load_smpl`` reads the standard SMPL pickle; ``synthetic_smpl`` builds the
arrays in numpy with exactly the JAX package's random draws, so the same
seed gives the same model in both packages.
"""

from __future__ import annotations

import dataclasses
import pickle
import threading

import numpy as np
import torch

N_VERTS = 6890
N_JOINTS = 24
N_POSEDIRS = 207  # 23 joints x 9 rotation-matrix residuals
N_SHAPES = 10
N_FACES = 13776

# Standard SMPL kinematic tree (parent of each of the 24 joints).
SMPL_PARENTS = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)


@dataclasses.dataclass
class SMPLModel:
    v_template: torch.Tensor   # (6890, 3)
    shapedirs: torch.Tensor    # (6890, 3, 10)
    posedirs: torch.Tensor     # (6890, 3, 207)
    J_regressor: torch.Tensor  # (24, 6890)
    weights: torch.Tensor      # (6890, 24) LBS blend weights
    faces: torch.Tensor        # (13776, 3) int64
    parents: tuple = tuple(SMPL_PARENTS.tolist())

    def to(self, device) -> "SMPLModel":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})

    def host(self) -> "SMPLModel":
        """This model on the CPU, for the host data pipeline: the model
        itself when it is there, else a copy made once and kept on this
        object (so it lives and dies with it: no cache keyed by ``id``)."""
        if self.v_template.device.type == "cpu":
            return self
        with _HOST_COPY_LOCK:
            copy = self.__dict__.get("_host_copy")
            if copy is None:
                copy = self.__dict__["_host_copy"] = self.to("cpu")
        return copy

    @staticmethod
    def from_arrays(v_template, shapedirs, posedirs, J_regressor, weights,
                    faces) -> "SMPLModel":
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())
        return SMPLModel(
            v_template=f32(v_template), shapedirs=f32(shapedirs),
            posedirs=f32(posedirs), J_regressor=f32(J_regressor),
            weights=f32(weights),
            faces=torch.from_numpy(np.asarray(faces).astype(np.int64)))


_HOST_COPY_LOCK = threading.Lock()


def _dense(x) -> np.ndarray:
    if hasattr(x, "todense"):
        x = x.todense()
    elif hasattr(x, "toarray"):
        x = x.toarray()
    return np.asarray(x)


def load_smpl(path: str, device="cuda") -> SMPLModel:
    """Load a SMPL .pkl (chumpy-free fields only, latin1 encoded; scipy
    sparse fields are densified) onto ``device``.  The pickle must come
    from a trusted source: unpickling runs code."""
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin1")
    kintree = np.asarray(_dense(raw["kintree_table"])).astype(np.int64)
    # kintree_table[1] holds the joint ids; remap the parents through it
    # (reference smpl_numpy.py:34-35)
    id_to_col = {int(kintree[1, i]): i for i in range(kintree.shape[1])}
    parents = np.zeros(N_JOINTS, dtype=np.int32)
    for i in range(1, kintree.shape[1]):
        parents[i] = id_to_col[int(kintree[0, i])]
    model = SMPLModel.from_arrays(
        _dense(raw["v_template"]), _dense(raw["shapedirs"])[..., :N_SHAPES],
        _dense(raw["posedirs"]), _dense(raw["J_regressor"]),
        _dense(raw["weights"]), _dense(raw["f"]))
    return dataclasses.replace(model, parents=tuple(int(p) for p in parents)
                               ).to(device)


def synthetic_smpl(seed: int = 0, n_verts: int = N_VERTS,
                   device="cuda") -> SMPLModel:
    """Deterministic fake SMPL with the real kinematic tree.

    Vertices form a rough humanoid point cloud around the joints so that LBS
    warps, KNN pruning and voxelization behave like the real asset.
    """
    rng = np.random.RandomState(seed)

    # Joint rest positions: a rough humanoid skeleton (meters, y-up).
    joints = np.array([
        [0.00, 0.00, 0.00],    # 0 pelvis
        [0.07, -0.07, 0.00],   # 1 L hip
        [-0.07, -0.07, 0.00],  # 2 R hip
        [0.00, 0.12, 0.00],    # 3 spine1
        [0.10, -0.45, 0.00],   # 4 L knee
        [-0.10, -0.45, 0.00],  # 5 R knee
        [0.00, 0.25, 0.00],    # 6 spine2
        [0.09, -0.85, -0.02],  # 7 L ankle
        [-0.09, -0.85, -0.02], # 8 R ankle
        [0.00, 0.32, 0.00],    # 9 spine3
        [0.11, -0.92, 0.10],   # 10 L foot
        [-0.11, -0.92, 0.10],  # 11 R foot
        [0.00, 0.45, 0.00],    # 12 neck
        [0.08, 0.40, 0.00],    # 13 L collar
        [-0.08, 0.40, 0.00],   # 14 R collar
        [0.00, 0.55, 0.03],    # 15 head
        [0.18, 0.42, 0.00],    # 16 L shoulder
        [-0.18, 0.42, 0.00],   # 17 R shoulder
        [0.42, 0.40, 0.00],    # 18 L elbow
        [-0.42, 0.40, 0.00],   # 19 R elbow
        [0.66, 0.40, 0.00],    # 20 L wrist
        [-0.66, 0.40, 0.00],   # 21 R wrist
        [0.74, 0.40, 0.00],    # 22 L hand
        [-0.74, 0.40, 0.00],   # 23 R hand
    ], dtype=np.float32)

    # Vertices: sample around bones (segments joint->parent) with small radius.
    per = n_verts // N_JOINTS
    pts, wts = [], []
    for j in range(N_JOINTS):
        cnt = per if j < N_JOINTS - 1 else n_verts - per * (N_JOINTS - 1)
        p = SMPL_PARENTS[j]
        t = rng.rand(cnt, 1).astype(np.float32)
        base = joints[j] * t + joints[p] * (1 - t)
        pts.append(base + rng.randn(cnt, 3).astype(np.float32) * 0.04)
        w = np.zeros((cnt, N_JOINTS), dtype=np.float32)
        w[:, j] = t[:, 0]
        w[:, p] += 1 - t[:, 0]
        wts.append(w)
    v_template = np.concatenate(pts, 0)
    weights = np.concatenate(wts, 0)
    weights = weights / weights.sum(-1, keepdims=True)

    # J_regressor: joints regress exactly to the rest joints via the nearest
    # few vertices (rows sum to 1).
    J_regressor = np.zeros((N_JOINTS, n_verts), dtype=np.float32)
    for j in range(N_JOINTS):
        d = np.linalg.norm(v_template - joints[j], axis=1)
        idx = np.argsort(d)[:8]
        w = np.exp(-d[idx] * 20)
        J_regressor[j, idx] = w / w.sum()

    shapedirs = (rng.randn(n_verts, 3, N_SHAPES) * 0.01).astype(np.float32)
    posedirs = (rng.randn(n_verts, 3, N_POSEDIRS) * 0.002).astype(np.float32)
    faces = rng.randint(0, n_verts, size=(N_FACES, 3)).astype(np.int32)

    return SMPLModel.from_arrays(v_template, shapedirs, posedirs,
                                 J_regressor, weights, faces).to(device)
