"""Weighted K-tap table gather and its table-gradient kernel.

``weighted_gather(table, ids, w)`` computes ``out[n] = sum_k w[n,k] *
table[ids[n,k]]``, the interpolation form of the sparse-volume readout
(torch counterpart of ``sherf_tpu/kernels/segment_accum.py:158-209``).
Its table adjoint,

    d_table[s] = sum over (n, k) with ids[n,k] == s of w[n,k] * g[n],

is :func:`weighted_accumulate`, the port of the Pallas kernel
``weighted_accumulate`` (``segment_accum.py:93``, ``pallas_call`` at
``:131``), with the declared precision of its fallback
``_scatter_accumulate`` (``:141-154``): duplicate ids inside a row first sum
their f32 weights and the first occurrence carries the sum; weights and grad
rows then round to bf16; products and accumulation are f32; ids outside
[0, n_rows) are dropped.

CUDA tensors go to the kernel in ``csrc/segment_accum.cu`` (a warp per
run of rows, a lane per channel, sums carried in registers while a tap's
id repeats, then reduced into the table;
:func:`weighted_accumulate_tiling` reports how a call is split), for every
table size: the JAX package picks between its
Pallas kernel and the scatter by table size (``n_rows <= 32768`` on a TPU,
``:177``), a tuning choice between two implementations of one function,
and the port has one kernel.  CPU tensors go to
:func:`weighted_accumulate_plain`.  Row 0 is computed exactly (the Pallas
kernel's tile skip leaves out id 0; its callers discard that row).
"""

from __future__ import annotations

import ctypes

import torch

from sherf_tpu_torch.kernels import _cuda

PLAIN_CHUNK = 65536  # rows per step of the plain version


def _check(ids, w, g, n_rows):
    if ids.dim() != 2 or w.shape != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and w {tuple(w.shape)} must "
                         f"both be (N, K)")
    if g.dim() != 2 or g.shape[0] != ids.shape[0]:
        raise ValueError(f"g: shape {tuple(g.shape)}, expected "
                         f"({ids.shape[0]}, C)")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f"ids: integer dtype expected, got {ids.dtype}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if not (ids.device == w.device == g.device):
        raise ValueError("ids, w and g must be on one device")


def _dedup_weights(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, K) f32: for each id's first occurrence in its row, the sum of the
    row's weights with that id; zero for later occurrences."""
    K = ids.shape[1]
    same = ids[:, :, None] == ids[:, None, :]                    # (N, K, K)
    # summed in ascending j, as the kernel sums: with three or more equal
    # ids another order can round the f32 sum, and then its bf16
    # rounding, differently
    w = w.float()
    wsum = torch.zeros_like(w)
    for j in range(K):
        wsum = wsum + torch.where(same[:, :, j], w[:, j:j + 1],
                                  torch.zeros_like(wsum))
    earlier = torch.ones(K, K, dtype=torch.bool, device=ids.device).tril(-1)
    first = ~(same & earlier).any(dim=-1)
    return torch.where(first, wsum, torch.zeros_like(wsum))


def weighted_accumulate_plain(ids: torch.Tensor, w: torch.Tensor,
                              g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``_scatter_accumulate``: (n_rows, C) f32, summed with ``index_add_``
    (row-major over (n, k))."""
    C = g.shape[-1]
    out = torch.zeros((n_rows + 1, C), dtype=torch.float32, device=g.device)
    for s in range(0, ids.shape[0], PLAIN_CHUNK):
        idc = ids[s:s + PLAIN_CHUNK].long()
        wq = _dedup_weights(idc, w[s:s + PLAIN_CHUNK]).to(torch.bfloat16).float()
        gq = g[s:s + PLAIN_CHUNK].to(torch.bfloat16).float()
        slot = torch.where((idc >= 0) & (idc < n_rows), idc,
                           torch.full_like(idc, n_rows))
        upd = wq[:, :, None] * gq[:, None, :]                    # (n, K, C)
        out.index_add_(0, slot.reshape(-1), upd.reshape(-1, C))
    return out[:n_rows]


def weighted_accumulate_cuda(ids: torch.Tensor, w: torch.Tensor,
                             g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """CUDA kernel: ids (N, K) int32, w (N, K) f32, g (N, C) f32, all
    contiguous -> (n_rows, C) f32; the kernel rounds w and g to bf16.  Counts its launch (none when there is
    nothing to add)."""
    dev = ids.device
    _cuda.require(ids, "ids", torch.int32, (None, None), dev)
    n, k = ids.shape
    _cuda.require(w, "w", torch.float32, (n, k), dev)
    _cuda.require(g, "g", torch.float32, (n, None), dev)
    c = g.shape[1]
    lib = _cuda.library()
    if k > lib.sherf_wa_max_taps():
        raise ValueError(f"weighted_accumulate: {k} taps per row exceed the "
                         f"kernel's {lib.sherf_wa_max_taps()}")
    if max(n * k, n * c, n_rows * c) >= 2 ** 31:
        raise ValueError("weighted_accumulate: sizes must fit int32 offsets")
    out = torch.zeros((n_rows, c), dtype=torch.float32, device=dev)
    if n and k and c and n_rows:
        _cuda.check(lib.sherf_weighted_accumulate(
            ids.data_ptr(), w.data_ptr(), g.data_ptr(), n, k, c, n_rows,
            out.data_ptr(), _cuda.stream_of(ids)), "weighted_accumulate")
        _cuda.LAUNCHES["weighted_accumulate"] += 1
    return out


def weighted_accumulate_tiling(n: int, k: int, c: int) -> dict:
    """How the CUDA kernel splits a call of ``n`` rows, ``k`` taps and ``c``
    channels on the current device (16-byte aligned tensors): rows per
    warp, warps, blocks, passes over the rows (96 channels each) and
    whether it loads a row's taps as vectors (K = 8)."""
    out = (ctypes.c_int * 5)()
    if _cuda.library().sherf_wa_tiling(n, k, c, ctypes.addressof(out)):
        raise RuntimeError("weighted_accumulate_tiling: no CUDA device")
    return dict(zip(("rows_per_warp", "warps", "blocks", "passes",
                     "vector_taps"), out))


def weighted_accumulate(ids: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """ids (N, K) int, w (N, K), g (N, C) -> (n_rows, C) f32 table
    gradient (see the module docstring for the precision)."""
    _check(ids, w, g, n_rows)
    if ids.is_cuda:
        return weighted_accumulate_cuda(
            ids.to(torch.int32).contiguous(), w.to(torch.float32).contiguous(),
            g.to(torch.float32).contiguous(), int(n_rows))
    return weighted_accumulate_plain(ids, w, g, int(n_rows))


class _WeightedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, w, w_grad):
        rows = table[ids.reshape(-1).long()].reshape(*ids.shape,
                                                      table.shape[-1])
        ctx.n_rows, ctx.table_dtype, ctx.w_grad = (table.shape[0], table.dtype,
                                                   w_grad)
        ctx.save_for_backward(table if w_grad else None, ids, w)
        return (rows.to(w.dtype) * w[..., None]).sum(dim=-2)

    @staticmethod
    def backward(ctx, g):
        table, ids, w = ctx.saved_tensors
        K, C = ids.shape[-1], g.shape[-1]
        d_table = weighted_accumulate(ids.reshape(-1, K), w.reshape(-1, K),
                                      g.reshape(-1, C), ctx.n_rows)
        if ctx.w_grad:
            # the weights' gradient re-gathers the rows
            rows = table[ids.reshape(-1).long()].reshape(*ids.shape, C)
            d_w = torch.einsum("...c,...kc->...k", g, rows.to(g.dtype))
            d_w = d_w.to(w.dtype)
        else:
            # declared zero: the caller promises the weights' gradient is
            # never consumed (they derive from query positions, pure data)
            d_w = torch.zeros_like(w)
        return d_table.to(ctx.table_dtype), None, d_w, None


def weighted_gather(table: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                    w_grad: bool = True) -> torch.Tensor:
    """sum_k w[..., k] * table[ids[..., k]], in w's dtype.

    table (S, C); ids, w (..., K) with ids in [0, S).  The table gradient
    is :func:`weighted_accumulate` cast to the table's dtype; ids get none;
    ``w_grad=False`` declares the weights' gradient dead (zeros)."""
    return _WeightedGather.apply(table, ids, w, bool(w_grad))
