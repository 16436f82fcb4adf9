"""Shared CLI plumbing (torch counterpart of ``sherf_tpu/cli/common.py``):
SMPL asset resolution, model flags, and model / config construction.

Every entry point takes ``--device`` (default ``cuda``); the CPU is used
only when ``--device cpu`` is passed, and a missing GPU is an error, not a
fallback.  Every entry point resolves its device through
:func:`resolve_device`, which also turns TF32 off: the f32 convolutions and
matmuls run in full f32, as the JAX package computes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple

import torch

from sherf_tpu_torch.core.calibrate import (calibrate_budgets,
                                            calibrate_sparse_caps)
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig
from sherf_tpu_torch.data.base import host_smpl_verts
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator
from sherf_tpu_torch.smpl.lbs import big_pose_params
from sherf_tpu_torch.smpl.model import load_smpl, synthetic_smpl


def resolve_device(name: str) -> torch.device:
    """The ``--device`` flag as a device; ``cuda`` without a GPU raises.
    Turns TF32 off for cuDNN convolutions and CUDA matmuls (PyTorch's
    default lets cuDNN use it), and cuBLAS's reduced-precision reductions
    of bf16 matmuls (PyTorch's default lets a split-K GEMM sum its partial
    products in bf16; the JAX package's bf16 dots sum in f32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    return dev


def resolve_smpl(path: Optional[str], device="cuda"):
    """Load the SMPL pickle if given, else the standard asset location, else
    fall back to the synthetic body model (datasets then won't align, but
    every code path runs)."""
    candidates = [path] if path else []
    candidates += ["assets/SMPL_NEUTRAL.pkl",
                   os.path.expanduser("~/assets/SMPL_NEUTRAL.pkl")]
    for c in candidates:
        if c and os.path.exists(c):
            return load_smpl(c, device=device)
    print("WARNING: SMPL asset not found; using the synthetic body model")
    return synthetic_smpl(0, device=device)


def add_model_flags(p: argparse.ArgumentParser):
    b = lambda s: s.lower() in ("1", "true", "yes")
    p.add_argument("--use_1d_feature", type=b, default=True)
    p.add_argument("--use_2d_feature", type=b, default=True)
    p.add_argument("--use_3d_feature", type=b, default=True)
    p.add_argument("--use_trans", type=b, default=True)
    p.add_argument("--use_nerf_decoder", type=b, default=True)
    p.add_argument("--use_sr_module", type=b, default=False)
    p.add_argument("--white_back", type=b, default=False)
    p.add_argument("--neural_rendering_resolution_initial", type=int, default=512)
    p.add_argument("--depth_resolution", type=int, default=48)
    p.add_argument("--point_capacity_frac", type=float, default=1.0 / 8.0)
    p.add_argument("--calibrate_budgets", type=b, default=False,
                   help="fit the static prune budgets to measured survivor "
                        "counts of representative batches (core/calibrate.py)")
    p.add_argument("--calibrate_margin", type=float, default=1.3)
    p.add_argument("--smpl_model", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when 'cpu' is passed")


def model_config_from_args(a) -> ModelConfig:
    return ModelConfig(
        use_1d_feature=a.use_1d_feature,
        use_2d_feature=a.use_2d_feature,
        use_3d_feature=a.use_3d_feature,
        use_trans=a.use_trans,
        use_nerf_decoder=a.use_nerf_decoder,
        use_sr_module=a.use_sr_module,
        img_resolution=a.neural_rendering_resolution_initial,
        render=RenderConfig(
            depth_resolution=a.depth_resolution,
            point_capacity_frac=a.point_capacity_frac,
            white_back=a.white_back,
        ),
    )


def calibrated_config(cfg: ModelConfig, batches, margin: float = 1.3
                      ) -> ModelConfig:
    """cfg with its render budgets fitted to ``batches`` (a list or a
    re-iterable, see ``calibrate_budgets``).  Parameters do not depend on
    the budgets, so a model rebuilt with the fitted config loads existing
    checkpoints unchanged."""
    fitted, worst = calibrate_budgets(batches, cfg, margin=margin)
    print(f"calibrated budgets: rays {worst['rays']} -> "
          f"frac {fitted.ray_capacity_frac:.4f}, "
          f"voxel {worst['voxel']} -> {fitted.point_capacity_frac:.4f}, "
          f"exact ~{worst['exact']} -> {fitted.exact_capacity_frac:.4f}")
    return dataclasses.replace(cfg, render=fitted)


# headroom of the sparse-conv site capacities over the default body, for
# the served subjects' shapes (the renderer's overflow counters re-check
# occupancy at run time)
CAPS_MARGIN = 1.3


def build_model(cfg: ModelConfig, smpl, device="cuda"
                ) -> Tuple[SHERFGenerator, tuple, ModelConfig]:
    """The generator on ``device``.  Returns (model, out_sh, cfg); the
    returned cfg is the one the model was built with.

    The canonical grid covers the default-shape body in its big pose.
    Sparse-conv site capacities are calibrated only when cfg.sparse_caps is
    None: over that body, with ``CAPS_MARGIN`` headroom."""
    bp = big_pose_params()
    t_verts = host_smpl_verts(smpl, bp["poses"], bp["shapes"])[0]
    _, out_sh = prepare_voxel_volume(t_verts, voxel_size=cfg.voxel_size)
    if cfg.sparse_caps is None:
        cfg = dataclasses.replace(cfg, sparse_caps=calibrate_sparse_caps(
            [t_verts], cfg.voxel_size, margin=CAPS_MARGIN))
    return SHERFGenerator(cfg, out_sh=out_sh, device=device), out_sh, cfg


def render_cli_config(depth_resolution: int, white_back: bool = False
                      ) -> ModelConfig:
    """The model of the render entry points (gen_videos, gen_samples,
    render_demo, the visualizer), as the JAX CLIs build it: the default
    widths, budgeted with ``point_capacity_frac`` 0.25 and no calibration,
    no density noise."""
    return ModelConfig(render=RenderConfig(
        depth_resolution=depth_resolution, point_capacity_frac=0.25,
        density_noise=0.0, white_back=white_back))


def generator_weights(model, resume: Optional[str]):
    """``--resume``: a port checkpoint's EMA weights (as the eval CLI
    loads them); without it, the JAX modules' initializers drawn by
    ``init_weights_`` from seed 0 (the JAX CLIs' ``PRNGKey(0)`` init)."""
    if resume:
        from sherf_tpu_torch.cli.eval import load_weights
        load_weights(model, resume)
    else:
        from sherf_tpu_torch.models.generator import init_weights_
        init_weights_(model, torch.Generator().manual_seed(0))
    return model
