"""Sparse 3D feature volume over the canonical SMPL body (torch counterpart of
``sherf_tpu/features/sparseconv.py``).

Features live on a static-capacity site list; an int32 dense index grid
(site id + 1, 0 = empty) gives O(1) neighbour lookup.  Submanifold conv =
27 neighbour gathers + one matmul at the occupied sites; strided conv
(kernel 3, stride 2, pad 1) = candidate parent sites, deduplicated and
compacted to a static cap (``kernels.compaction.compact_mask``), then the
3x3x3 stride-2 window per output site; readout = trilinear interpolation
through the index grid, as a ``weighted_gather`` whose table gradient is the
``weighted_accumulate`` kernel.  The convolutions' backward is autograd's
(the JAX package's custom VJPs, ``sparseconv.py:217-272``, are plain XLA).
BatchNorm runs on its running statistics in training too, as the JAX
package does (``bn_train = False``).

Duplicate coordinates: the JAX package resolves them with ``.at[].set``, the
LAST writer winning (``sparseconv.py:107, 366``).  Here every such write
goes through ``scatter_reduce(..., "amax")`` over the writers' ascending
positions, which picks the same winner deterministically on the CPU and on
CUDA (where ``index_put_`` / ``scatter_`` with duplicates are not).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.core.diag import Diag
from sherf_tpu_torch.kernels.compaction import compact_mask
from sherf_tpu_torch.kernels.segment_accum import weighted_gather

VOXEL_SIZE = 0.005  # meters


def prepare_voxel_volume(t_vertices: np.ndarray, pad: float = 0.05,
                         voxel_size: float = VOXEL_SIZE):
    """Static volume geometry from the canonical vertices: (min_dhw (3,),
    out_sh (3,) ints rounded up to multiples of 32 via ``(x | 31) + 1``)."""
    t_vertices = np.asarray(t_vertices)
    min_xyz = t_vertices.min(0) - pad
    max_xyz = t_vertices.max(0) + pad
    min_dhw = min_xyz[[2, 1, 0]]
    max_dhw = max_xyz[[2, 1, 0]]
    out_sh = np.ceil((max_dhw - min_dhw) / voxel_size).astype(np.int32)
    out_sh = (out_sh | 31) + 1
    return min_dhw.astype(np.float32), tuple(int(s) for s in out_sh)


def voxelize_coords(xyz: torch.Tensor, min_dhw, voxel_size: float = VOXEL_SIZE):
    """World points -> integer dhw voxel coords (round half to even)."""
    dhw = xyz[..., [2, 1, 0]]
    return torch.round((dhw - min_dhw) / voxel_size).to(torch.int32)


def world_to_voxel_f(xyz: torch.Tensor, min_dhw, voxel_size: float = VOXEL_SIZE):
    """World points -> float dhw voxel coords."""
    return (xyz[..., [2, 1, 0]] - min_dhw) / voxel_size


def _flat(c: torch.Tensor, shape) -> torch.Tensor:
    return (c[..., 0].long() * shape[1] + c[..., 1]) * shape[2] + c[..., 2]


def _inbounds(c: torch.Tensor, shape) -> torch.Tensor:
    return ((c[..., 0] >= 0) & (c[..., 0] < shape[0]) & (c[..., 1] >= 0)
            & (c[..., 1] < shape[1]) & (c[..., 2] >= 0) & (c[..., 2] < shape[2]))


def build_index_grid(coords: torch.Tensor, valid: torch.Tensor,
                     shape: Tuple[int, int, int]) -> torch.Tensor:
    """Flat int32 grid of (site index + 1), 0 = empty.  Duplicate coords:
    the highest site index wins (the JAX package's last writer)."""
    size = shape[0] * shape[1] * shape[2]
    ok = valid & _inbounds(coords, shape)
    flat = torch.where(ok, _flat(coords, shape), torch.full_like(ok, size,
                                                                 dtype=torch.long))
    ids = torch.arange(1, coords.shape[0] + 1, dtype=torch.int32,
                       device=coords.device)
    grid = torch.zeros((size + 1,), dtype=torch.int32, device=coords.device)
    grid.scatter_reduce_(0, flat, ids, "amax")
    return grid[:size]


_OFFSETS = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                                indexing="ij"), -1).reshape(27, 3) - 1


def neighbor_ids(grid: torch.Tensor, shape, base_coords: torch.Tensor):
    """(S, 27) padded site ids (0 = empty / out of bounds) of the 3x3x3
    neighbourhood of each base coord."""
    off = torch.as_tensor(_OFFSETS, dtype=base_coords.dtype,
                          device=base_coords.device)
    nbr = base_coords[:, None, :] + off[None]
    ok = _inbounds(nbr, shape)
    flat = torch.clamp(_flat(nbr, shape), 0, grid.shape[0] - 1)
    return grid[flat] * ok


def conv3d_by_ids(feats: torch.Tensor, nbr: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """out[s] = sum_k W[k] . feats[nbr[s, k] - 1] (id 0 reads a zero row).
    feats (S_in, Ci); nbr (S_out, 27); weight (3, 3, 3, Ci, Co)."""
    ci, co = weight.shape[-2], weight.shape[-1]
    fp = torch.cat([feats.new_zeros(1, ci), feats], dim=0)
    # index_select: its backward is one index_add_ (advanced indexing's
    # accumulating index_put_ is far slower, on the CPU above all)
    rows = fp.index_select(0, nbr.reshape(-1).long()).reshape(
        nbr.shape[0], -1)                                        # (S, 27*Ci)
    return rows @ weight.reshape(-1, co).to(feats.dtype)


def subm_conv3d(feats, coords, grid, shape, weight):
    """Submanifold conv: out[s] = sum_k W[k] . in[coord_s + k]."""
    return conv3d_by_ids(feats, neighbor_ids(grid, shape, coords), weight)


def stride_conv3d(feats, grid_in, shape_in, out_coords, weight):
    """Strided conv (kernel 3, stride 2, pad 1): out[o] = sum_k W[k] .
    in[2*o + k - 1]."""
    return conv3d_by_ids(feats, neighbor_ids(grid_in, shape_in, 2 * out_coords),
                         weight)


def downsample_sites(coords_in: torch.Tensor, valid_in: torch.Tensor,
                     shape_in, cap: int):
    """Site set of SparseConv3d(stride 2, pad 1): every output voxel whose
    stride-2 window touches an occupied input voxel, compacted to ``cap``
    sites in ascending flat order.  Returns (coords (cap, 3) int32,
    valid (cap,), shape_out, overflow)."""
    shape_out = tuple((s - 1) // 2 + 1 for s in shape_in)
    size_out = shape_out[0] * shape_out[1] * shape_out[2]
    dev = coords_in.device
    cands = []
    for sel in range(8):
        delta = torch.tensor([sel >> a & 1 for a in range(3)], dtype=torch.int32,
                             device=dev)
        p = torch.div(coords_in + delta, 2, rounding_mode="floor")
        ok = valid_in & _inbounds(p, shape_out)
        cands.append(torch.where(ok, _flat(p, shape_out),
                                 torch.full_like(ok, size_out, dtype=torch.long)))
    cand = torch.cat(cands)
    M = cand.shape[0]
    pos = torch.arange(M, dtype=torch.long, device=dev)
    # one representative per voxel: the last candidate writing it
    scratch = torch.full((size_out + 1,), -1, dtype=torch.long, device=dev)
    scratch.scatter_reduce_(0, cand, pos, "amax")
    winner = (scratch[torch.clamp(cand, 0, size_out - 1)] == pos) \
        & (cand < size_out)
    n_occ = winner.sum()
    slot, new_valid = compact_mask(winner, cap)
    idx, _ = torch.sort(torch.where(new_valid,
                                    cand[torch.clamp(slot.long(), max=M - 1)],
                                    torch.full_like(new_valid, size_out,
                                                    dtype=torch.long)))
    new_valid = idx < size_out
    idx = torch.where(new_valid, idx, torch.zeros_like(idx))
    d = idx // (shape_out[1] * shape_out[2])
    h = (idx // shape_out[2]) % shape_out[1]
    w = idx % shape_out[2]
    new_coords = torch.stack([d, h, w], -1).to(torch.int32)
    overflow = torch.clamp(n_occ - cap, min=0)
    return new_coords, new_valid, shape_out, overflow


_CORNERS8 = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                     -1).reshape(8, 3)


def trilinear_corners(grid: torch.Tensor, shape, pos: torch.Tensor):
    """The 8 corner taps of a trilinear readout at float dhw voxel positions
    (N, 3): (ids (N, 8) int32, w (N, 8) f32).  ids index the padded site
    table (site + 1; 0 = the zero row, for an empty or out-of-bounds
    corner); w is the f32 product of the per-axis weights (z * y) * x, zero
    for an out-of-bounds corner.  Corner k is ``_CORNERS8[k]``.  Inside the
    volume the taps equal the JAX corner-packed readout's
    (``trilinear_site_sample_packed``); at its edges both put the same weight
    on every real site."""
    p0f = torch.floor(pos)
    frac = pos - p0f
    p0 = p0f.long()
    o = torch.as_tensor(_CORNERS8, device=pos.device)
    corner = p0[:, None, :] + o[None]                         # (N, 8, 3)
    ok = _inbounds(corner, shape)
    ids = grid[torch.clamp(_flat(corner, shape), 0, grid.shape[0] - 1)] * ok
    w = torch.where(o[None] == 1, frac[:, None, :], 1.0 - frac[:, None, :])
    w = w[..., 0] * w[..., 1] * w[..., 2]
    return ids.to(torch.int32), torch.where(ok, w, torch.zeros_like(w))


def trilinear_site_sample(feats: torch.Tensor, grid: torch.Tensor, shape,
                          pos: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of the sparse volume at float dhw voxel
    positions (N, 3); empty or out-of-bounds corners read zero.  f32 weights
    and accumulation (the JAX readout's precision).  Returns (N, C) f32.

    One readout for serving and training: ``weighted_gather`` over the
    zero-padded site table, whose backward accumulates the table gradient
    with the ``weighted_accumulate`` kernel (the JAX package's train-mode
    readout, ``sparseconv.py:584-639``; its eval-mode pair-packed form is a
    TPU gather-count trick with the same forward)."""
    ids, w = trilinear_corners(grid, shape, pos)
    fp = torch.cat([feats.new_zeros(1, feats.shape[-1]), feats], dim=0)
    return weighted_gather(fp, ids, w, w_grad=False)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over sites in eval mode (running statistics, eps 1e-3);
    parameter names follow the flax module (scale -> weight)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var
                                                          + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class SparseStage(nn.Module):
    """n_convs x (SubMConv3d + BN + ReLU) sharing one neighbour table."""

    def __init__(self, cin: int, out_channels: int, n_convs: int):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            c = cin if i == 0 else out_channels
            self.register_parameter(f"conv{i}", nn.Parameter(
                torch.randn(3, 3, 3, c, out_channels) / np.sqrt(27 * c)))
            self.add_module(f"bn{i}", MaskedBatchNorm(out_channels))

    def forward(self, feats, coords, grid, shape, valid):
        nbr = neighbor_ids(grid, shape, coords)
        vm = valid[:, None].to(feats.dtype)
        for i in range(self.n_convs):
            feats = conv3d_by_ids(feats, nbr, getattr(self, f"conv{i}"))
            feats = F.relu(getattr(self, f"bn{i}")(feats)) * vm
        return feats


class SparseDown(nn.Module):
    """SparseConv3d(stride 2) + BN + ReLU."""

    def __init__(self, cin: int, out_channels: int, cap: int, name: str):
        super().__init__()
        self.cap = cap
        self.overflow_key = f"{name}.site_overflow"
        self.conv = nn.Parameter(torch.randn(3, 3, 3, cin, out_channels)
                                 / np.sqrt(27 * cin))
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, feats, coords, grid, shape, valid, diag: Diag):
        new_coords, new_valid, new_shape, overflow = downsample_sites(
            coords, valid, shape, self.cap)
        diag.record(self.overflow_key, overflow)
        out = stride_conv3d(feats, grid, shape, new_coords, self.conv)
        out = F.relu(self.bn(out)) * new_valid[:, None].to(out.dtype)
        new_grid = build_index_grid(new_coords, new_valid, new_shape)
        return out, new_coords, new_grid, new_shape, new_valid


STAGE_CHANNELS = (32, 64, 96)


def readout_channels(num_layers: int) -> int:
    """Channels of the multi-scale readout (192 for num_layers = 4)."""
    return sum(STAGE_CHANNELS[:num_layers - 1])


class SparseConvNet(nn.Module):
    """Multi-scale sparse feature volume with trilinear readout
    (num_layers = 4 emits 32 + 64 + 96 = 192 channels)."""

    def __init__(self, num_layers: int = 4,
                 out_sh: Tuple[int, int, int] = (128, 352, 416),
                 caps: Tuple[int, int, int] = (8192, 8192, 8192),
                 in_channels: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.out_sh, self.dtype = num_layers, tuple(out_sh), dtype
        self.conv0 = SparseStage(in_channels, 32, 2)
        self.down0 = SparseDown(32, 32, caps[0], "down0")
        if num_layers > 1:
            self.conv1 = SparseStage(32, 32, 2)
            self.down1 = SparseDown(32, 64, caps[1], "down1")
        if num_layers > 2:
            self.conv2 = SparseStage(64, 64, 3)
            self.down2 = SparseDown(64, 96, caps[2], "down2")
        if num_layers > 3:
            self.conv3 = SparseStage(96, 96, 3)

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                query_dhw: torch.Tensor, diag: Diag,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats (S, Cin) per-site features, coords (S, 3) int dhw at full
        res, query_dhw (N, 3) float full-res voxel coords -> (N, C_out) f32."""
        if valid is None:
            valid = torch.ones(feats.shape[0], dtype=torch.bool,
                               device=feats.device)
        feats = feats.to(self.dtype)
        shape = self.out_sh
        grid = build_index_grid(coords, valid, shape)
        feats = self.conv0(feats, coords, grid, shape, valid)
        feats, coords, grid, shape, valid = self.down0(
            feats, coords, grid, shape, valid, diag)
        full = torch.as_tensor(np.asarray(self.out_sh, np.float32),
                               device=feats.device)
        outs = []

        def readout(f, g, s):
            scale = (torch.as_tensor(np.asarray(s, np.float32),
                                     device=f.device) - 1.0) / full
            return trilinear_site_sample(f, g, s, query_dhw * scale)

        if self.num_layers > 1:
            feats = self.conv1(feats, coords, grid, shape, valid)
            outs.append(readout(feats, grid, shape))
            feats, coords, grid, shape, valid = self.down1(
                feats, coords, grid, shape, valid, diag)
        if self.num_layers > 2:
            feats = self.conv2(feats, coords, grid, shape, valid)
            outs.append(readout(feats, grid, shape))
            feats, coords, grid, shape, valid = self.down2(
                feats, coords, grid, shape, valid, diag)
        if self.num_layers > 3:
            feats = self.conv3(feats, coords, grid, shape, valid)
            outs.append(readout(feats, grid, shape))
        return torch.cat(outs, dim=-1)
