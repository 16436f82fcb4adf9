from sherf_tpu_torch.data.base import HumanDataset, collate, host_smpl_verts
from sherf_tpu_torch.data.sampler import InfiniteSampler, PrefetchLoader
from sherf_tpu_torch.data.synthetic import (
    SyntheticDataset, SyntheticHumanDataset, fixed_ring_camera,
    make_synthetic_batch, synthetic_camera)


def _not_ported(name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"the {name!r} loader is not ported yet: it decodes JPG / PNG and "
            f"resizes and rasterises through cv2 (ROADMAP Queue A, the "
            f"file-backed loaders)")
    return make


# dataset name -> constructor (data_root, smpl, **loader options); the
# file-backed loaders raise until they are ported
DATASETS = {
    "synthetic": SyntheticDataset,
    "synthetic_grid": SyntheticHumanDataset,
    **{name: _not_ported(name)
       for name in ("renderpeople", "thuman", "humman", "zju")},
}

__all__ = [
    "DATASETS", "HumanDataset", "InfiniteSampler", "PrefetchLoader",
    "SyntheticDataset", "SyntheticHumanDataset", "collate",
    "fixed_ring_camera", "host_smpl_verts", "make_synthetic_batch",
    "synthetic_camera",
]
