"""Configuration dataclasses (a copy of ``sherf_tpu/core/config.py``, which
imports no JAX, so that configs written by either package load in both).

The reference drives everything through click flags -> nested EasyDicts ->
``construct_class_by_name`` string registries (reference ``train.py:129-209``,
``dnnlib/util.py:303``).  We replace that with typed dataclasses that
serialize to/from JSON, plus a small name registry for datasets.

All fields that shape compiled programs (resolutions, sample counts,
capacities) are static Python ints so that jitted functions specialize on
them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple


def _asdict(obj) -> dict:
    return dataclasses.asdict(obj)


# Fallback sparse-conv site capacities: a typical adult SMPL body at 5 mm
# voxels with ~15% margin (see ModelConfig.sparse_caps).
DEFAULT_SPARSE_CAPS: Tuple[int, int, int] = (22528, 14336, 4352)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Volume rendering options (reference ``train.py:328-351`` rendering_kwargs)."""

    depth_resolution: int = 48          # stratified samples per ray
    depth_resolution_importance: int = 0  # importance samples (0 in all shipped configs)
    clamp_mode: str = "relu"            # density clamp: 'relu' | 'softplus'
    white_back: bool = False
    density_noise: float = 1.0          # train-time sigma noise; forced 0 at eval
    box_warp: float = 1.0               # unused by the SHERF path (bounds come from data)
    disparity_space_sampling: bool = False
    # KNN prune: samples farther than sqrt(threshold_sq) from the SMPL surface
    # are masked out with density -80 (reference renderer.py:315-321,368).
    prune_threshold_sq: float = 0.05 ** 2
    # Static capacity (fraction of total samples) kept after pruning.  The
    # reference uses dynamic boolean indexing; on TPU we compact to a fixed
    # budget.  1.0 == no compaction (compute everything, mask the output).
    point_capacity_frac: float = 1.0
    # Ray chunk size for lax.map chunking of the per-point pipeline.
    ray_chunk: int = 65536
    # Conservative prune stage feeding the compaction: 'voxel' (dilated
    # occupancy grid, ~3-4% selectivity), 'capsule' (pure compute, but the
    # per-bone radii over-cover badly — measured 97% of AABB-hitting
    # samples pass, which overflows any useful point budget).  Both are
    # strict supersets of the exact vertex-distance test, which is always
    # re-applied on the compacted survivors.
    prune_mode: str = "voxel"
    # Voxel-prune depth stride: test every prune_stride-th sample per ray
    # (plus the last) against a grid dilated by prune_step_margin extra
    # meters, then OR-spread flags to +-1 neighbors — a strict superset of
    # the per-sample test whenever the per-ray depth step <= the margin.
    # Default 3, A/B'd both ways on chip (r4): stride 1 tests every sample
    # at the tight ball (survivors 358k -> 221k, exact-KNN -5.2 ms) but
    # pays 3x the grid gathers (+6.1 ms, they are per-row-latency bound) —
    # net ~+1 ms worse at the production shape.  The stride's margin is
    # scene-fitted by calibrate_budgets and guarded by the step_overflow
    # diag; coarse grids (D < 24) always test every sample.
    prune_stride: int = 3
    prune_step_margin: float = 0.06
    # Second-stage static budget (fraction of total samples) applied AFTER
    # the exact 5cm test: exact failures composite as empty space either
    # way, so dropping them before the feature banks halves the per-point
    # work.  1.0 disables the second compaction.  Only active when
    # point_capacity_frac < 1.
    exact_capacity_frac: float = 1.0
    # Static budget of AABB-hitting rays, as a fraction of the total ray
    # count (1.0 = no ray compaction).  Exact as long as the budget covers
    # every ray whose mask_at_box is set; overflow rays render background.
    ray_capacity_frac: float = 1.0
    # Fine-pass (importance) survivor budget as a fraction of
    # N_rays * depth_resolution_importance; None = reuse
    # point_capacity_frac.  Only consulted when the hierarchical pass is
    # on AND point_capacity_frac < 1 (budgeted mode); the parity-mode
    # importance path stays full-compute dense.
    importance_capacity_frac: Optional[float] = None
    # Per-tile cluster-shortlist toggle for the exact-KNN kernels
    # (budgeted mode, TPU backends only): nonzero routes compacted-query
    # KNNs through the dynamic-count Morton-cluster kernel
    # (knn_pallas.nn_1_shortlist_pallas).  DEFAULT 0 (full scan): the
    # r4 A/B measured the cluster-visiting kernel at 258 ms/frame vs 120
    # for the straight-line full scan — like the branch-and-bound variant
    # before it, per-visit overhead (dynamic slices + scalar reads +
    # loop control) dwarfs the column savings at V=6890.  The kernel
    # stays exact-pinned by tests for larger vertex sets.
    knn_shortlist: int = 0

    def to_json(self) -> str:
        return json.dumps(_asdict(self))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SHERF generator hyper-parameters (reference ``train.py:238`` G_kwargs
    + ``triplane.py:31-71``)."""

    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    # hierarchical feature bank toggles (reference train.py:197-209 flags)
    use_1d_feature: bool = True
    use_2d_feature: bool = True
    use_3d_feature: bool = True
    use_trans: bool = True
    use_nerf_decoder: bool = True
    use_sr_module: bool = False
    img_resolution: int = 512           # SR output resolution
    img_channels: int = 3
    # triplane backbone
    backbone_resolution: int = 256
    n_planes: int = 3
    plane_channels: int = 32
    channel_base: int = 32768
    channel_max: int = 512
    mapping_layers: int = 2
    # sparse 3D conv feature volume
    voxel_size: float = 0.005
    sparse_conv_layers: int = 4
    # static site capacities of the three downsample stages.  None = use
    # DEFAULT_SPARSE_CAPS, which cover a typical adult SMPL body at 5 mm
    # voxels (measured ~19.2k / 12.3k / 3.6k occupied sites); fit them to
    # the served subjects with core.calibrate.calibrate_sparse_caps — an
    # undersized cap silently truncates body features, an oversized one
    # pays for empty gathers.  build_model auto-calibrates ONLY when this
    # is None; an explicitly configured value is never overwritten.
    sparse_caps: Optional[Tuple[int, int, int]] = None
    # compute dtype for the conv/matmul hot paths ('float32' | 'bfloat16')
    compute_dtype: str = "float32"
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)

    @property
    def resolved_sparse_caps(self) -> Tuple[int, int, int]:
        return (tuple(self.sparse_caps) if self.sparse_caps is not None
                else DEFAULT_SPARSE_CAPS)

    def to_json(self) -> str:
        return json.dumps(_asdict(self))

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        d = json.loads(s)
        d["render"] = RenderConfig(**d.get("render", {}))
        return ModelConfig(**d)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection + host pipeline options (reference train.py:246-268)."""

    name: str = "synthetic"             # renderpeople | thuman | humman | zju | synthetic
    data_root: str = ""
    split: str = "train"
    multi_person: bool = True
    num_instance: int = 1
    poses_start: int = 0
    poses_interval: int = 1
    poses_num: int = 20
    image_scaling: float = 1.0
    white_back: bool = False
    sample_obs_view: bool = False
    fix_obs_view: bool = True
    resolution: int = 512
    num_workers: int = 3


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference train_*.sh + training_loop.py:243-256)."""

    total_kimg: int = 800
    batch_size: int = 4
    lr: float = 2.5e-3
    betas: Tuple[float, float] = (0.0, 0.99)
    eps: float = 1e-8
    # StepLR: x0.5 every (20000 // batch) steps (training_loop.py:254)
    lr_decay_images: int = 20000
    lr_decay_factor: float = 0.5
    ema_kimg: float = 10.0
    # loss weights (reference loss.py:165)
    w_img: float = 100.0
    w_acc: float = 10.0
    w_ssim: float = 1.0
    w_lpips: float = 1.0
    recons_loss: bool = True
    # adversarial phases (reference training_loop.py:243-256 constructs
    # Dmain/Dreg with lazy R1 every run; the shipped SHERF objective zeroes
    # the GAN terms — loss.py:162-165 — so adv_weight defaults to 0, which
    # skips building the discriminator entirely)
    adv_weight: float = 0.0
    d_lr: float = 2e-3                 # D Adam lr before mb_ratio (train.py:284)
    r1_gamma: float = 10.0             # R1 weight (loss.py:337)
    d_reg_interval: int = 16           # lazy-R1 cadence (training_loop.py:143)
    seed: int = 0
    kimg_per_tick: int = 1
    # console/stats cadence in images (reference prints every 100 imgs,
    # training_loop.py:418-448); tests shrink it so abort_fn polls sooner
    report_imgs: int = 100
    snapshot_ticks: int = 1
    outdir: str = "runs"
    resume: Optional[str] = None
    # device mesh: (data, rays); ray axis shards rendering within a sample
    mesh_shape: Tuple[int, int] = (1, 1)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Eval protocol options (reference test_loop.py:87-151)."""

    dataset: str = "zju"
    data_root: str = ""
    obs_views: Tuple[int, ...] = (4, 10, 16)
    nv_pose_start: int = 0
    np_pose_start: int = 2
    pose_interval: int = 1
    pose_num: int = 5
    neural_rendering_resolution: int = 512
    use_sr_module: bool = False
    white_back: bool = False
    outdir: str = "eval_out"


# Per-dataset eval defaults — the reference's exact launch values from the
# four test(...) calls at training_loop.py:321-327 (verified by reading them):
#   RenderPeople: obs [0,16,31], nv_pose_start=0, np_pose_start=2, interval=2, num=5
#   THuman:       obs [4,12,20], nv_pose_start=0, np_pose_start=0, interval=2, num=5
#   HuMMan:       obs [0,4,8],   nv_pose_start=0, np_pose_start=0, interval=6, num=17
#   zju_mocap:    obs [4,10,16], nv_pose_start=0, np_pose_start=0, interval=20, num=25
EVAL_DEFAULTS = {
    "renderpeople": dict(obs_views=(0, 16, 31), nv_pose_start=0, np_pose_start=2,
                         pose_interval=2, pose_num=5),
    "thuman": dict(obs_views=(4, 12, 20), nv_pose_start=0, np_pose_start=0,
                   pose_interval=2, pose_num=5),
    "humman": dict(obs_views=(0, 4, 8), nv_pose_start=0, np_pose_start=0,
                   pose_interval=6, pose_num=17),
    "zju": dict(obs_views=(4, 10, 16), nv_pose_start=0, np_pose_start=0,
                pose_interval=20, pose_num=25),
    # on-disk-free synthetic rig (data/synthetic.py SyntheticHumanDataset):
    # the lifecycle/generalization artifact protocol — 6-view ring, obs
    # view 0, 4 poses per protocol
    "synthetic_grid": dict(obs_views=(0,), nv_pose_start=0, np_pose_start=0,
                           pose_interval=1, pose_num=4),
}

# The reference's hardcoded eval subject lists (test_loop.py:112-151).
# RenderPeople/THuman use human_list.txt ranges instead (test_loop.py:102-111).
EVAL_SUBJECTS = {
    "synthetic_grid": ("subject100",),
    "humman": (
        "p000455_a000986", "p000456_a000396", "p000465_a000048",
        "p000465_a000701", "p000474_a000048", "p000477_a000396",
        "p000482_a000793", "p000491_a005730", "p000503_a000064",
        "p000503_a000224", "p000532_a005711", "p000538_a000978",
        "p000538_a000986", "p000542_a000048", "p000545_a000064",
        "p000547_a000011", "p000547_a000145", "p000557_a000793",
        "p000582_a000048", "p100050_a001425", "p100056_a000049",
        "p100074_a000048",
    ),
    "zju": ("CoreView_377", "CoreView_313", "CoreView_315"),
}


def save_config(path: str, **configs: Any) -> None:
    out = {k: _asdict(v) if dataclasses.is_dataclass(v) else v for k, v in configs.items()}
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
