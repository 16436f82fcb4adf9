"""SHERFGenerator (torch counterpart of ``sherf_tpu/models/generator.py``):
two ResNet18 encoders, a StyleGAN2 triplane backbone conditioned on the
observation image, a sparse canonical feature volume built from
pixel-aligned observation-vertex features, the volumetric renderer and,
with ``use_sr_module``, EG3D's super-resolution head on ``image_raw``.

``forward(batch, smpl)`` returns ``(out, diag)``: the image dict of the JAX
generator and the renderer's budget-overflow counters.  The forward records
autograd's graph like any module: serving callers wrap it in
``torch.inference_mode()`` or ``torch.no_grad()``.  ``train=True`` is the
training forward (the backbone's unfused modulated convs, density noise
from the caller's ``torch.Generator``).  ``query_canonical(batch, smpl,
pts)`` evaluates the radiance field at canonical points (shape export,
the visualizer's cross-section).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from sherf_tpu_torch.core.config import ModelConfig
from sherf_tpu_torch.core.diag import Diag
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.features.encoding import positional_encoding
from sherf_tpu_torch.features.layers import (Conv2d, Dense, FrozenBatchNorm,
                                             LayerNorm)
from sherf_tpu_torch.features.resnet import ResNet18
from sherf_tpu_torch.features.sparseconv import (
    MaskedBatchNorm, SparseDown, SparseStage, voxelize_coords)
from sherf_tpu_torch.features.stylegan2 import (
    EqualConv2d, EqualDense, StyleGAN2Backbone, SynthesisBlock, SynthesisLayer,
    ToRGBLayer)
from sherf_tpu_torch.features.superresolution import SuperresolutionHybrid
from sherf_tpu_torch.geometry.rays import backface_mask, project_points
from sherf_tpu_torch.kernels.grid_sample import grid_sample_2d
from sherf_tpu_torch.nerf.decoders import OSGDecoder
from sherf_tpu_torch.nerf.renderer import SHERFRenderer
from sherf_tpu_torch.nerf.warp import (
    batch_pose_contexts, deform_target2c)
from sherf_tpu_torch.smpl.model import SMPLModel


class SHERFGenerator(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 out_sh: Tuple[int, int, int] = (128, 352, 416),
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        use_bf16 = cfg.compute_dtype == "bfloat16"
        enc_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.encoder_2d = ResNet18(dtype=enc_dtype)
        self.encoder_2d_feature = ResNet18(dtype=enc_dtype, feature_only=True)
        self.backbone = StyleGAN2Backbone(
            z_dim=cfg.z_dim, w_dim=cfg.w_dim,
            img_resolution=cfg.backbone_resolution,
            img_channels=cfg.n_planes * cfg.plane_channels,
            mapping_layers=cfg.mapping_layers, channel_base=cfg.channel_base,
            channel_max=cfg.channel_max, use_bf16=use_bf16)
        # obs vertex features 64 + 32 -> 32
        self.conv1d_projection = Dense(96, cfg.plane_channels)
        self.renderer = SHERFRenderer(cfg, out_sh)
        if cfg.use_sr_module:
            # fed the 3-channel image_raw twice, as the JAX package wires it
            self.superresolution = SuperresolutionHybrid(
                img_resolution=cfg.img_resolution, channels=3,
                w_dim=cfg.w_dim)
        self.to(device)

    # ------------------------------------------------------------------
    def mapping(self, obs_img: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None) -> torch.Tensor:
        """obs_img (B, H, W, 3) -> ws (B, num_ws, w_dim); z is the ResNet18
        embedding of the observation image."""
        z = self.encoder_2d(obs_img)
        return self.backbone.mapping(z, truncation_psi=truncation_psi,
                                     truncation_cutoff=truncation_cutoff)

    # ------------------------------------------------------------------
    def _observation_volume(self, batch: SHERFBatch, obs_feat: torch.Tensor,
                            smpl: SMPLModel, min_dhw: torch.Tensor,
                            ctx_obs, ctx_big):
        """Pixel-aligned vertex features -> canonical sparse volume:
        (feats (B, 6890, 32), coords (B, 6890, 3) int32)."""
        H, W = batch.obs_img.shape[1:3]
        wh = torch.tensor([W, H], dtype=torch.float32, device=obs_feat.device)
        feats, coords = [], []
        for b in range(batch.obs_img.shape[0]):
            v = batch.obs_vertices[b]
            K, R, T = batch.obs_K[b], batch.obs_R[b], batch.obs_T[b]
            uv, _ = project_points(v, K, R, T)
            vis = backface_mask(v, smpl.faces, K, R, T)
            uv_n = 2.0 * uv / wh - 1.0
            vert_feat = grid_sample_2d(obs_feat[b], uv_n, align_corners=True)
            vert_rgb = grid_sample_2d(batch.obs_img[b], uv_n, align_corners=True)
            rgb_enc = positional_encoding(vert_rgb, 5)[..., :32]
            f = self.conv1d_projection(torch.cat([vert_feat, rgb_enc], dim=-1))
            feats.append(f * vis[:, None])
            # observation verts -> SMPL frame -> canonical big pose; the
            # nearest vertex of each vertex is itself
            smpl_obs = (v - ctx_obs[b].Th) @ ctx_obs[b].R
            vid = torch.arange(v.shape[0], device=v.device)
            warped = deform_target2c(smpl, ctx_obs[b], ctx_big[b], vid, smpl_obs)
            coords.append(voxelize_coords(warped, min_dhw[b],
                                          self.cfg.voxel_size))
        return torch.stack(feats), torch.stack(coords)

    # ------------------------------------------------------------------
    def _banks(self, ws: torch.Tensor, batch: SHERFBatch, smpl: SMPLModel,
               noise_mode: str, fused_modconv: bool):
        """What the renderer's feature lookups read: (planes (B, 3, Hp, Wp,
        C) or None without the 1D bank, obs_feat, ctx_big, ctx_obs, min_dhw,
        vol_feats, vol_coords; both None without the 3D bank)."""
        cfg = self.cfg
        B = batch.obs_img.shape[0]
        planes = None
        if cfg.use_1d_feature:
            planes = self.backbone.synthesis(ws, noise_mode=noise_mode,
                                             fused_modconv=fused_modconv)
            Hp, Wp = planes.shape[2:]                                # NCHW
            planes = planes.permute(0, 2, 3, 1).reshape(
                B, Hp, Wp, cfg.n_planes, cfg.plane_channels
            ).permute(0, 3, 1, 2, 4)
        obs_feat = self.encoder_2d_feature(batch.obs_img, extract_feature=True)
        ctx_big = batch_pose_contexts(smpl, batch.t_pose)
        ctx_obs = batch_pose_contexts(smpl, batch.obs_pose)
        min_dhw = (batch.t_vertices.amin(dim=1) - 0.05)[:, [2, 1, 0]]
        vol_feats = vol_coords = None
        if cfg.use_3d_feature:
            vol_feats, vol_coords = self._observation_volume(
                batch, obs_feat, smpl, min_dhw, ctx_obs, ctx_big)
        return planes, obs_feat, ctx_big, ctx_obs, min_dhw, vol_feats, \
            vol_coords

    # ------------------------------------------------------------------
    def synthesis(self, ws: torch.Tensor, batch: SHERFBatch, smpl: SMPLModel,
                  noise_mode: str = "none", train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  flat_output: bool = False):
        """``flat_output``: per-ray outputs, (B, N, 3) / (B, N), for the
        sharded callers, whose batch holds a ray shard of each image rather
        than an image rectangle (no SR head)."""
        cfg = self.cfg
        if flat_output and cfg.use_sr_module:
            raise ValueError("flat_output is incompatible with the SR module")
        B = batch.obs_img.shape[0]
        planes, obs_feat, ctx_big, ctx_obs, min_dhw, vol_feats, vol_coords = \
            self._banks(ws, batch, smpl, noise_mode, fused_modconv=not train)
        ctx_target = batch_pose_contexts(smpl, batch.pose)
        rgb, depth, acc, diag = self.renderer(
            planes, batch.obs_img, obs_feat, vol_feats, vol_coords, min_dhw,
            batch.ray_o, batch.ray_d, batch.near, batch.far, ctx_target,
            ctx_big, ctx_obs, batch.vertices, batch.t_vertices,
            batch.t_bounds, batch.obs_K, batch.obs_R, batch.obs_T, smpl,
            ray_mask=batch.mask_at_box, train=train, generator=generator)
        if flat_output:
            return {"image_raw": rgb, "image_depth": depth,
                    "weights_image": acc, "image": rgb}, diag
        H, W = batch.img.shape[1:3]
        out = {"image_raw": rgb.reshape(B, H, W, 3),
               "image_depth": depth.reshape(B, H, W),
               "weights_image": acc.reshape(B, H, W)}
        if cfg.use_sr_module:
            # the loss and the eval metrics read image_raw, as in the JAX
            # package: the head gets no reconstruction gradient
            out["image"] = self.superresolution(
                out["image_raw"], out["image_raw"], ws, noise_mode=noise_mode,
                fused_modconv=not train)
        else:
            out["image"] = out["image_raw"]
        return out, diag

    # ------------------------------------------------------------------
    def query_canonical(self, batch: SHERFBatch, smpl: SMPLModel,
                        pts: torch.Tensor, dirs: Optional[torch.Tensor] = None):
        """The radiance field at canonical (big-pose) points, the
        shape-export path (JAX ``SHERFGenerator.query_canonical``).

        pts: (B, M, 3).  Returns ({"rgb": (B, M, 3), "sigma": (B, M, 1)},
        diag): the decoder's outputs and the overflow counters of the
        lookups (the sparse-conv site caps; the shortlist counter when
        ``render.knn_shortlist`` > 0 in budgeted mode)."""
        planes, obs_feat, ctx_big, ctx_obs, min_dhw, vol_feats, vol_coords = \
            self._banks(self.mapping(batch.obs_img), batch, smpl, "none",
                        fused_modconv=True)
        if dirs is None:
            dirs = torch.zeros_like(pts)
        diag = Diag()
        outs = []
        for b in range(pts.shape[0]):
            pick = lambda t: None if t is None else t[b]
            bank = self.renderer._bank((
                pick(planes), batch.obs_img[b], obs_feat[b], pick(vol_feats),
                pick(vol_coords), min_dhw[b], ctx_obs[b], ctx_big[b],
                batch.t_vertices[b], batch.t_bounds[b], batch.obs_K[b],
                batch.obs_R[b], batch.obs_T[b], smpl, diag))
            outs.append(self.renderer.decode_points(*bank[:6], pts[b],
                                                    dirs[b], *bank[6:]))
        return {k: torch.stack([o[k] for o in outs]) for k in ("rgb", "sigma")
                }, diag

    # ------------------------------------------------------------------
    def forward(self, batch: SHERFBatch, smpl: SMPLModel,
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                noise_mode: str = "none", train: bool = False,
                generator: Optional[torch.Generator] = None,
                flat_output: bool = False):
        ws = self.mapping(batch.obs_img, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, batch, smpl, noise_mode=noise_mode,
                              train=train, generator=generator,
                              flat_output=flat_output)


# flax's ``truncated_normal`` cuts a unit normal at +-2, whose spread is
# then this share of 1: lecun_normal divides its std by it
TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, std: float, generator: torch.Generator):
    """flax's ``variance_scaling(..., "truncated_normal")`` draw: a unit
    normal cut at +-2 by the inverse CDF (as ``jax.random.truncated_normal``),
    times ``std / TRUNC_STD``, so the spread after the cut is ``std``."""
    lo = math.erf(-2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator).mul_(-2.0 * lo).add_(lo)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(std / TRUNC_STD)


def _jax_init(mod: nn.Module, leaf: str, shape, generator: torch.Generator):
    """The value flax's ``model.init`` gives the leaf ``leaf`` of ``mod``'s
    counterpart, drawn from ``generator`` (see :func:`init_weights_`)."""
    normal = lambda std: torch.randn(shape, generator=generator).mul_(std)
    if isinstance(mod, (Dense, Conv2d)):
        if leaf == "weight":        # (out, in[, kh, kw]): fan-in in[*kh*kw]
            return _truncated_normal(shape, math.sqrt(
                1.0 / int(np.prod(shape[1:]))), generator)
        if leaf == "bias":
            return torch.zeros(shape)
    elif isinstance(mod, (FrozenBatchNorm, LayerNorm, MaskedBatchNorm)):
        if leaf in ("weight", "bias"):
            return torch.full(shape, 1.0 if leaf == "weight" else 0.0)
    elif isinstance(mod, (SparseStage, SparseDown)):
        if leaf.startswith("conv"):  # (3, 3, 3, Ci, Co): fan-in 27 * Ci
            return normal(math.sqrt(1.0 / int(np.prod(shape[:-1]))))
    elif isinstance(mod, EqualDense):
        if leaf == "weight":
            return normal(1.0 / mod.lr_multiplier)
        if leaf == "bias":
            return torch.full(shape, mod.bias_init)
    elif isinstance(mod, (EqualConv2d, SynthesisLayer, ToRGBLayer)):
        if leaf == "weight":
            return normal(1.0)
        if leaf in ("bias", "noise_strength"):
            return torch.zeros(shape)
    elif isinstance(mod, SynthesisBlock) and leaf == "const":
        return normal(1.0)
    raise TypeError(f"no JAX initializer known for parameter {leaf!r} of a "
                    f"{type(mod).__name__}")


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of ``model`` (a ``SHERFGenerator`` in any
    branch of ``ModelConfig``, or one of its parts) from the initializer of
    its counterpart in the JAX package, as flax's ``model.init`` does:

      * ``nn.Dense`` / ``nn.Conv`` kernels (``features/resnet.py:36-64``,
        ``features/transformer.py:31-67``, ``nerf/decoders.py:65-79``,
        ``nerf/renderer.py:138-145``, ``models/generator.py:54``):
        lecun_normal, a normal cut at +-2 sigma with spread
        sqrt(1 / fan_in), fan_in = in for a Dense, in x kh x kw for a Conv;
        their biases zeros;
      * ``nn.BatchNorm`` (``features/resnet.py:33-35, 66-67``),
        ``nn.LayerNorm`` (``features/transformer.py:85-87``) and
        ``MaskedBatchNorm`` (``features/sparseconv.py:779-780``): scale
        ones, bias zeros;
      * sparse convs (``features/sparseconv.py:823, 836, 860``):
        ``variance_scaling(1, "fan_in", "normal")``, an untruncated normal
        of std sqrt(1 / (27 x Ci));
      * StyleGAN2 ``FullyConnected`` (``EqualDense``,
        ``features/stylegan2.py:52, 58``): weight normal(1 /
        lr_multiplier), bias ``bias_init``, each layer's own: the mapping
        network's lr_multiplier 0.01 (``:324``, std 100), the affines'
        bias_init 1 (``:155, 204``), the OSG decoder's lr_multiplier 1
        (``nerf/decoders.py:25, 32-36``);
      * StyleGAN2 conv weights and ``const`` normal(1), their biases and
        ``noise_strength`` zeros (``features/stylegan2.py:79, 89, 156,
        159, 163, 206, 209, 237``), in the backbone and the SR head
        (``features/superresolution.py:44-56``).

    The draws come from ``generator`` only, on the CPU, and are then copied
    to the parameters' device and dtype.  Buffers keep their values, which
    are those of JAX's non-param collections at init: running means 0 and
    variances 1 (``sparseconv.py:781-782``, flax's ``BatchNorm``), the
    noise buffers ``RandomState(resolution)``'s (``stylegan2.py:166-170``),
    ``w_avg`` 0 (``stylegan2.py:336``).  A parameter of a module the JAX
    package does not have raises ``TypeError``."""
    for _, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            p.copy_(_jax_init(mod, leaf, tuple(p.shape), generator))
    return model


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every float parameter of ``model`` from N(0, 1 / fan_in)
    (N(0, 1) for the unit-scale weights and scalars of StyleGAN2's layers:
    the backbone, the SR head, the OSG decoder), using only ``generator``.
    Buffers (running statistics, noise) keep their values.

    This is not the JAX package's init (that is :func:`init_weights_`):
    norm scales and biases come from N(0, 0.01) and the mapping network's
    weights from N(0, 1).  Tests and card checks that want random weights
    which render a body take it, with the decoder's density bias raised."""
    unit = tuple(f"{n}." if n else "" for n, m in model.named_modules()
                 if isinstance(m, (StyleGAN2Backbone, SuperresolutionHybrid,
                                   OSGDecoder)))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(p.shape)
        if leaf == "bias" or p.dim() <= 1:
            val = torch.randn(shape, generator=generator) * 0.1
            if name.endswith("affine.bias"):
                val = val + 1.0
        elif name.startswith(unit):
            val = torch.randn(shape, generator=generator)
        else:
            fan_in = int(np.prod(shape[1:])) if p.dim() > 1 else shape[0]
            if p.dim() == 5:  # sparse conv (3, 3, 3, Ci, Co)
                fan_in = int(np.prod(shape[:4]))
            val = torch.randn(shape, generator=generator) / np.sqrt(fan_in)
        p.copy_(val.to(p.dtype))
    return model
