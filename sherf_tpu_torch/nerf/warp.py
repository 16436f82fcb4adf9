"""SMPL-driven space warps between observation / target / canonical poses
(torch counterpart of ``sherf_tpu/nerf/warp.py``).

The per-frame bone transforms and blendshape tables are built once into a
:class:`PoseContext`; the warps take the nearest-vertex payload gathered by
the fused KNN.  Everything is float32.  The blends ``bw @ A`` are float32
matrix products: the port relies on ``torch.backends.cuda.matmul.allow_tf32``
being False (PyTorch's default), as the JAX package forces full-f32
matmuls around these functions (``warp.py:40``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sherf_tpu_torch.core.types import SMPLPose
from sherf_tpu_torch.smpl.lbs import (
    pose_offsets_table, shape_offsets_table, transform_params)
from sherf_tpu_torch.smpl.model import SMPLModel


@dataclasses.dataclass
class PoseContext:
    """Everything pose-dependent the warps need, computed once per frame."""

    A: torch.Tensor              # (24, 4, 4) bone transforms (rest -> posed)
    R: torch.Tensor              # (3, 3) global rotation
    Th: torch.Tensor             # (3,) global translation
    pose_offsets: torch.Tensor   # (6890, 3)
    shape_offsets: torch.Tensor  # (6890, 3)
    joints: torch.Tensor         # (24, 3) posed joints (SMPL frame)


def make_pose_context(smpl: SMPLModel, pose: SMPLPose) -> PoseContext:
    """Single-sample context (pose fields without a batch dim)."""
    poses = pose.poses.reshape(-1)
    shapes = pose.shapes.reshape(-1)
    A, rest_joints = transform_params(smpl, poses, shapes)
    posed_joints = torch.einsum("jab,jb->ja", A[:, :3, :3], rest_joints) \
        + A[:, :3, 3]
    return PoseContext(
        A=A, R=pose.R.reshape(3, 3), Th=pose.Th.reshape(3),
        pose_offsets=pose_offsets_table(smpl, poses),
        shape_offsets=shape_offsets_table(smpl, shapes),
        joints=posed_joints)


def batch_pose_contexts(smpl: SMPLModel, pose: SMPLPose):
    """One :class:`PoseContext` per batch item of a batched ``SMPLPose``."""
    return [make_pose_context(smpl, SMPLPose(pose.poses[b], pose.shapes[b],
                                             pose.R[b], pose.Th[b]))
            for b in range(pose.poses.shape[0])]


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def target2c_tables(smpl: SMPLModel, ctx_pose: PoseContext,
                    ctx_big: PoseContext) -> torch.Tensor:
    """Per-vertex payload (6890, 33) for :func:`deform_target2c_from_tables`:
    [blend weights (24) | pose_off (3) | shape_off (3) | big_pose_off (3)]."""
    return torch.cat([smpl.weights, ctx_pose.pose_offsets,
                      ctx_pose.shape_offsets, ctx_big.pose_offsets], dim=-1)


def c2source_tables(smpl: SMPLModel, ctx_src: PoseContext,
                    ctx_big: PoseContext) -> torch.Tensor:
    """Payload for :func:`deform_c2source_from_tables`:
    [blend weights (24) | big_pose_off (3) | src_shape_off (3) | src_pose_off (3)]."""
    return torch.cat([smpl.weights, ctx_big.pose_offsets,
                      ctx_src.shape_offsets, ctx_src.pose_offsets], dim=-1)


# Per-point 3x3 math on (N,) columns, in the JAX package's operation order.

def _mat_cols(A_pt: torch.Tensor):
    R = [A_pt[:, 4 * a + b] for a in range(3) for b in range(3)]
    t = [A_pt[:, 4 * a + 3] for a in range(3)]
    return R, t


def _inv3_cols(r):
    a, b, c, d, e, f, g, h, i = r
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    return [A / det, B / det, C / det, D / det, E / det,
            F / det, G / det, H / det, I / det]


def _mv_cols(R, v):
    return [R[3 * a + 0] * v[0] + R[3 * a + 1] * v[1] + R[3 * a + 2] * v[2]
            for a in range(3)]


def deform_target2c_from_tables(ctx_pose: PoseContext, ctx_big: PoseContext,
                                payload: torch.Tensor, q_pts: torch.Tensor,
                                q_dirs: Optional[torch.Tensor] = None):
    """Posed (SMPL frame) -> canonical big-pose warp given the nearest-vertex
    payload (N, 33).  Returns can (N, 3) [, dirs (N, 3)]."""
    bw = payload[:, :24]
    R, t = _mat_cols(bw @ ctx_pose.A.reshape(24, 16))
    Ri = _inv3_cols(R)
    can = _mv_cols(Ri, [q_pts[:, a] - t[a] for a in range(3)])
    if q_dirs is not None:
        dirs = _mv_cols(Ri, [q_dirs[:, a] for a in range(3)])
    can = [can[a] - payload[:, 24 + a] - payload[:, 27 + a]
           + payload[:, 30 + a] for a in range(3)]
    Rb, tb = _mat_cols(bw @ ctx_big.A.reshape(24, 16))
    can = [v + tb[a] for a, v in enumerate(_mv_cols(Rb, can))]
    if q_dirs is not None:
        return torch.stack(can, dim=-1), torch.stack(_mv_cols(Rb, dirs), dim=-1)
    return torch.stack(can, dim=-1)


def deform_target2c(smpl: SMPLModel, ctx_pose: PoseContext,
                    ctx_big: PoseContext, vid: torch.Tensor,
                    q_pts: torch.Tensor, q_dirs: Optional[torch.Tensor] = None):
    """As :func:`deform_target2c_from_tables`, gathering the payload by
    nearest-vertex ids ``vid`` (N,)."""
    payload = target2c_tables(smpl, ctx_pose, ctx_big)[vid]
    return deform_target2c_from_tables(ctx_pose, ctx_big, payload, q_pts,
                                       q_dirs)


def deform_c2source_from_tables(ctx_src: PoseContext, ctx_big: PoseContext,
                                payload: torch.Tensor, q_pts: torch.Tensor,
                                weights_correction: Optional[
                                    torch.Tensor] = None):
    """Canonical big-pose -> source pose given the payload (N, 33), the
    blend weights nudged by ``0.2 * weights_correction`` (N, 24) if given.
    Returns (smpl_src (N, 3), world_src (N, 3), bw (N, 24))."""
    bw = payload[:, :24]
    big_off = payload[:, 24:27]
    shape_off = payload[:, 27:30]
    pose_off = payload[:, 30:33]
    if weights_correction is not None:
        bw = bw + 0.2 * weights_correction
    bw = bw / bw.sum(dim=-1, keepdim=True)

    Rb, tb = _mat_cols(bw @ ctx_big.A.reshape(24, 16))
    q = _mv_cols(_inv3_cols(Rb), [q_pts[:, a] - tb[a] for a in range(3)])
    q = [q[a] - big_off[:, a] + shape_off[:, a] + pose_off[:, a]
         for a in range(3)]
    Rs, ts = _mat_cols(bw @ ctx_src.A.reshape(24, 16))
    sm = [v + ts[a] for a, v in enumerate(_mv_cols(Rs, q))]
    Rinv = _inv3(ctx_src.R)
    world = [sm[0] * Rinv[0, a] + sm[1] * Rinv[1, a] + sm[2] * Rinv[2, a]
             + ctx_src.Th[a] for a in range(3)]
    return torch.stack(sm, dim=-1), torch.stack(world, dim=-1), bw


def deform_c2source(smpl: SMPLModel, ctx_src: PoseContext,
                    ctx_big: PoseContext, vid: torch.Tensor,
                    q_pts: torch.Tensor,
                    weights_correction: Optional[torch.Tensor] = None):
    """As :func:`deform_c2source_from_tables`, gathering the payload by the
    ids ``vid`` (N,) of the points' nearest canonical vertices."""
    payload = c2source_tables(smpl, ctx_src, ctx_big)[vid]
    return deform_c2source_from_tables(ctx_src, ctx_big, payload, q_pts,
                                       weights_correction)
