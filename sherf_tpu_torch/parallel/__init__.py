from sherf_tpu_torch.parallel.mesh import (
    Mesh, auto_mesh, interleave_rays, make_mesh, shard_batch,
    uninterleave_rays)
from sherf_tpu_torch.parallel.render import make_sharded_render

__all__ = ["Mesh", "auto_mesh", "interleave_rays", "make_mesh", "shard_batch",
           "uninterleave_rays", "make_sharded_render"]
