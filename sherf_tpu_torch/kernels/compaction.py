"""Stream compaction: mask -> positions of the first ``cap`` survivors.

Port of the Pallas kernel ``compact_mask`` (``sherf_tpu/kernels/
compaction.py:107``), whose output equals the renderer's XLA
``_compact_indices`` (``sherf_tpu/nerf/renderer.py:96``): idx (cap,) int32
holds the positions of the first ``cap`` True entries in ascending order and
the sentinel N in the tail; valid = idx < N is a prefix.  Stability is
load-bearing: the segmented ray march needs ascending ray-major order.

CUDA tensors go to the three-pass kernel in ``csrc/compaction.cu``; CPU
tensors to :func:`compact_mask_plain`.  Its integer outputs carry no
gradient: the wrapper runs outside autograd.
"""

from __future__ import annotations

import torch

from sherf_tpu_torch.kernels import _cuda


def compact_mask_plain(mask: torch.Tensor, cap: int):
    """``_compact_indices``: cumsum ranks, then a scatter of positions into
    their slots.  Slots below ``cap`` are written at most once; every
    overflow lands in the extra slot ``cap``, which is cut off."""
    n = mask.shape[0]
    m = mask.to(torch.bool)
    pos = torch.cumsum(m, dim=0) - 1
    slot = torch.where(m & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.full((cap + 1,), n, dtype=torch.int32, device=mask.device)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=mask.device))
    idx = idx[:cap]
    return idx, idx < n


def compact_mask_cuda(mask: torch.Tensor, cap: int):
    """CUDA kernel; counts its launch (none for cap == 0 or n == 0)."""
    dev = mask.device
    _cuda.require(mask, "mask", torch.bool, (None,), dev)
    n = mask.shape[0]
    if n >= 2 ** 31 - 1:
        raise ValueError("compact_mask: n must fit an int32 index")
    idx = torch.empty((cap,), dtype=torch.int32, device=dev)
    valid = torch.empty((cap,), dtype=torch.bool, device=dev)
    if cap == 0:
        return idx, valid
    if n == 0:
        return idx.fill_(0), valid.fill_(False)
    lib = _cuda.library()
    nblk = -(-n // lib.sherf_compact_tile())
    scratch = torch.empty((2 * nblk + 1,), dtype=torch.int32, device=dev)
    _cuda.check(lib.sherf_compact_mask(
        mask.data_ptr(), n, cap, idx.data_ptr(), valid.data_ptr(),
        scratch.data_ptr(), scratch[nblk:].data_ptr(),
        scratch[2 * nblk:].data_ptr(), _cuda.stream_of(mask)), "compact_mask")
    _cuda.LAUNCHES["compact_mask"] += 1
    return idx, valid


@torch.no_grad()
def compact_mask(mask: torch.Tensor, cap: int):
    """mask (N,) bool -> (idx (cap,) int32, valid (cap,) bool)."""
    if mask.dim() != 1:
        raise ValueError(f"mask: shape {tuple(mask.shape)}, expected (N,)")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if mask.is_cuda:
        return compact_mask_cuda(mask.to(torch.bool).contiguous(), int(cap))
    return compact_mask_plain(mask, int(cap))
