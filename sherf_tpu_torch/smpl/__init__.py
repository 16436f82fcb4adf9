from sherf_tpu_torch.smpl.model import (SMPLModel, load_smpl, synthetic_smpl,
                                        N_VERTS, N_JOINTS)
from sherf_tpu_torch.smpl.lbs import (
    rodrigues, rigid_transforms, smpl_forward, transform_params,
    big_pose_params, pose_offsets_table, shape_offsets_table,
)

__all__ = [
    "SMPLModel", "load_smpl", "synthetic_smpl", "N_VERTS", "N_JOINTS",
    "rodrigues", "rigid_transforms", "smpl_forward", "transform_params",
    "big_pose_params", "pose_offsets_table", "shape_offsets_table",
]
