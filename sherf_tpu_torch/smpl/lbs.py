"""SMPL linear blend skinning (torch counterpart of ``sherf_tpu/smpl/lbs.py``).

Single-sample functions in float32; the 24-step FK chain is a Python loop
of 4x4 products, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sherf_tpu_torch.smpl.model import N_JOINTS, SMPLModel


def rodrigues(r: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3); the angle is
    ``norm(r + eps)`` so that zero rotations are safe."""
    r = r + eps
    angle = torch.linalg.norm(r, dim=-1, keepdim=True)
    axis = r / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(*r.shape[:-1], 3, 3)
    ident = torch.eye(3, dtype=r.dtype, device=r.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def _fk_chain(rot_mats: torch.Tensor, joints: torch.Tensor, parents):
    parents = np.asarray(parents)
    rel = joints.clone()
    rel[1:] = joints[1:] - joints[torch.as_tensor(parents[1:]).long()]
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(N_JOINTS, 1, 4)
    local = torch.cat([torch.cat([rot_mats, rel[:, :, None]], dim=-1),
                       bottom], dim=-2)
    chain = [local[0]]
    for i in range(1, N_JOINTS):
        chain.append(chain[int(parents[i])] @ local[i])
    return torch.stack(chain, dim=0)


def rigid_transforms(rot_mats: torch.Tensor, joints: torch.Tensor,
                     parents) -> torch.Tensor:
    """(24, 3, 3) rotations + (24, 3) rest joints -> A (24, 4, 4) acting on
    rest-space points."""
    fk = _fk_chain(rot_mats, joints, parents)
    joints_h = torch.cat([joints, joints.new_zeros(N_JOINTS, 1)], dim=-1)
    posed = torch.einsum("jab,jb->ja", fk, joints_h)
    A = fk.clone()
    A[..., 3] = fk[..., 3] - posed
    return A


def pose_offsets_table(model: SMPLModel, poses: torch.Tensor) -> torch.Tensor:
    """Per-vertex pose blendshape offsets (6890, 3) from (72,) axis-angle."""
    R = rodrigues(poses.reshape(N_JOINTS, 3))
    feat = (R[1:] - torch.eye(3, dtype=R.dtype, device=R.device)).reshape(-1)
    return torch.einsum("vcp,p->vc", model.posedirs, feat)


def shape_offsets_table(model: SMPLModel, shapes: torch.Tensor) -> torch.Tensor:
    """Per-vertex shape blendshape offsets (6890, 3) from (10,) betas."""
    return torch.einsum("vcs,s->vc", model.shapedirs, shapes)


def smpl_forward(model: SMPLModel, poses: torch.Tensor, shapes: torch.Tensor):
    """(72,) pose + (10,) betas -> verts (6890, 3), posed joints (24, 3)."""
    v_shaped = model.v_template + shape_offsets_table(model, shapes)
    J = model.J_regressor @ v_shaped
    R = rodrigues(poses.reshape(N_JOINTS, 3))
    v_posed = v_shaped + torch.einsum(
        "vcp,p->vc", model.posedirs,
        (R[1:] - torch.eye(3, dtype=R.dtype, device=R.device)).reshape(-1))
    A = rigid_transforms(R, J, model.parents)
    T = torch.einsum("vj,jab->vab", model.weights, A)
    verts = torch.einsum("vab,vb->va", T[:, :3, :3], v_posed) + T[:, :3, 3]
    joints = _fk_chain(R, J, model.parents)[:, :3, 3]
    return verts, joints


def transform_params(model: SMPLModel, poses: torch.Tensor,
                     shapes: torch.Tensor):
    """LBS bone transforms for a posed body: (A (24, 4, 4), joints (24, 3))."""
    v_shaped = model.v_template + shape_offsets_table(model, shapes)
    joints = model.J_regressor @ v_shaped
    A = rigid_transforms(rodrigues(poses.reshape(N_JOINTS, 3)), joints,
                         model.parents)
    return A, joints


def big_pose_params() -> dict:
    """Canonical 'big pose': legs spread 45deg, knees bent 30deg.  Numpy."""
    poses = np.zeros((72,), dtype=np.float32)
    poses[5] = 45 / 180 * np.pi
    poses[8] = -45 / 180 * np.pi
    poses[23] = -30 / 180 * np.pi
    poses[26] = 30 / 180 * np.pi
    return dict(
        poses=poses,
        shapes=np.zeros((10,), dtype=np.float32),
        R=np.eye(3, dtype=np.float32),
        Th=np.zeros((3,), dtype=np.float32),
    )
