from sherf_tpu_torch.data.base import (
    HumanDataset, collate, get_bound_2d_mask, host_smpl_verts,
    sample_rays_for_image)
from sherf_tpu_torch.data.humman import HuMManDataset
from sherf_tpu_torch.data.renderpeople import RenderPeopleDataset
from sherf_tpu_torch.data.sampler import InfiniteSampler, PrefetchLoader
from sherf_tpu_torch.data.synthetic import (
    SyntheticDataset, SyntheticHumanDataset, fixed_ring_camera,
    make_synthetic_batch, synthetic_camera)
from sherf_tpu_torch.data.thuman import THumanDataset
from sherf_tpu_torch.data.zju import ZJUMoCapDataset

# dataset name -> constructor (data_root, smpl, **loader options)
DATASETS = {
    "synthetic": SyntheticDataset,
    "synthetic_grid": SyntheticHumanDataset,
    "thuman": THumanDataset,
    "renderpeople": RenderPeopleDataset,
    "humman": HuMManDataset,
    "zju": ZJUMoCapDataset,
}

__all__ = [
    "DATASETS", "HuMManDataset", "HumanDataset", "InfiniteSampler",
    "PrefetchLoader", "RenderPeopleDataset", "SyntheticDataset",
    "SyntheticHumanDataset", "THumanDataset", "ZJUMoCapDataset", "collate",
    "fixed_ring_camera", "get_bound_2d_mask", "host_smpl_verts",
    "make_synthetic_batch", "sample_rays_for_image", "synthetic_camera",
]
