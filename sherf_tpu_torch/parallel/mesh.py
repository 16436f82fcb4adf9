"""The (data, rays) mesh over torch ranks (torch counterpart of
``sherf_tpu/parallel/mesh.py``).

JAX runs one program over a mesh of devices; the port runs one process
per device, so a JAX device becomes a rank and the mesh becomes the world
split two ways: rank = data index * rm + ray index.  The ``dm`` data
groups each hold B/dm items of the batch (data parallelism); the ``rm``
ranks of a data group each hold every rm-th ray of those items (the ray
dimension is the natural sequence-parallel axis of volume rendering: rays
are independent until the image-space loss).  Rays are dealt round-robin
(ray i to ray index i % rm, :func:`interleave_rays`), so every shard sees
an even spatial slice of the image and the per-shard static point budgets
(fractions of the local ray count) stay balanced.

The collectives the sharded steps need are here: the ray all-gather (with
the adjoint of each rank taking its own slice back), the fused gradient
all-reduce, metric means and maxima.  Under the gloo backend, which has
no CUDA all-gather, every collective on a CUDA tensor is staged through
the host; under NCCL the tensors stay on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from sherf_tpu_torch.core.types import SHERFBatch, _map_tensors

# the per-ray fields of a SHERFBatch (axis 1 is the ray axis)
RAY_FIELDS = ("ray_o", "ray_d", "near", "far", "mask_at_box", "bkgd_msk")


@dataclasses.dataclass
class Mesh:
    """``data`` x ``rays`` ranks; this process is ``rank``.  ``ray_group``
    is the process group of this rank's data group (None: the whole world,
    or no collective needed); ``backend`` is the process group's (None in
    one process)."""

    data: int
    rays: int
    rank: int = 0
    backend: Optional[str] = None
    ray_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "rays": self.rays}

    @property
    def size(self) -> int:
        return self.data * self.rays

    @property
    def data_index(self) -> int:
        return self.rank // self.rays

    @property
    def ray_index(self) -> int:
        return self.rank % self.rays


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The (data, rays) mesh over every rank of the process group (one
    rank without one); ``shape`` defaults to all ranks on ``data``.  Unlike
    a JAX mesh it must cover the world: a rank outside it would have no
    work.  Creates the ray groups' process groups (every rank takes part,
    in the same order)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dm, rm = shape if shape is not None else (world, 1)
    if dm * rm != world:
        raise ValueError(f"mesh {(dm, rm)} does not cover the {world} ranks")
    mesh = Mesh(dm, rm, rank, dist.get_backend() if world > 1 else None)
    if 1 < rm < world:
        for d in range(dm):
            group = dist.new_group(ranks=[d * rm + r for r in range(rm)])
            if d == mesh.data_index:
                mesh.ray_group = group
    return mesh


def auto_mesh_shape(batch_size: int, n_rays: int, n: int) -> Tuple[int, int]:
    """JAX ``auto_mesh``'s choice for ``n`` devices: the largest (data,
    rays) whose axes divide the batch and ray counts, preferring data."""
    best = (1, 1)
    for dm in range(1, n + 1):
        if batch_size % dm:
            continue
        rm = n // dm
        while rm > 1 and n_rays % rm:
            rm -= 1
        if dm * rm > best[0] * best[1] or (
                dm * rm == best[0] * best[1] and dm > best[0]):
            best = (dm, rm)
    return best


def auto_mesh(batch_size: int, n_rays: int) -> Mesh:
    """:func:`make_mesh` at :func:`auto_mesh_shape` over the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(auto_mesh_shape(batch_size, n_rays, world))


# ---------------------------------------------------------------------------
# ray interleaving (round-robin over the ray axis of the mesh)


def _interleave(x: torch.Tensor, rm: int) -> torch.Tensor:
    """(B, N, ...) -> same shape; element [b, k*(N//rm) + j] = x[b, j*rm + k],
    so a contiguous split into rm blocks gives ray i to block i % rm."""
    B, N = x.shape[:2]
    if N % rm:
        raise ValueError(f"{N} rays do not split over {rm} ray shards")
    return x.reshape(B, N // rm, rm, *x.shape[2:]).transpose(1, 2).reshape(
        x.shape)


def uninterleave_rays(x: torch.Tensor, rm: int) -> torch.Tensor:
    """Inverse of the interleave: also puts a shard-major concatenation of
    the rm ray shards back into ray order."""
    if rm == 1:
        return x
    B, N = x.shape[:2]
    return x.reshape(B, rm, N // rm, *x.shape[2:]).transpose(1, 2).reshape(
        x.shape)


def interleave_rays(batch: SHERFBatch, rm: int) -> SHERFBatch:
    if rm == 1:
        return batch
    return dataclasses.replace(batch, **{
        f: _interleave(getattr(batch, f), rm) for f in RAY_FIELDS})


def ray_shard(batch: SHERFBatch, mesh: Mesh) -> SHERFBatch:
    """This rank's rays of every item: block ``ray_index`` of the
    interleaved ray axis (rays ray_index, ray_index + rm, ...)."""
    rm, r = mesh.rays, mesh.ray_index
    if rm == 1:
        return batch
    n = batch.ray_o.shape[1] // rm
    inter = interleave_rays(batch, rm)
    return dataclasses.replace(inter, **{
        f: getattr(inter, f)[:, r * n:(r + 1) * n].contiguous()
        for f in RAY_FIELDS})


def data_shard(batch: SHERFBatch, mesh: Mesh) -> SHERFBatch:
    """This rank's data group's items of a global batch."""
    B = batch.img.shape[0]
    if B % mesh.data:
        raise ValueError(f"batch {B} does not split over {mesh.data} data "
                         f"groups")
    n = B // mesh.data
    lo = mesh.data_index * n
    if mesh.data == 1:
        return batch
    return _map_tensors(batch, lambda t: t[lo:lo + n])


def shard_batch(batch: SHERFBatch, mesh: Mesh) -> SHERFBatch:
    """This rank's (B/dm, N/rm) part of a global batch, the rays in
    round-robin order (JAX ``shard_batch(batch, mesh, interleave=True)``,
    whose device shard this is)."""
    return ray_shard(data_shard(batch, mesh), mesh)


# ---------------------------------------------------------------------------
# collectives


def _comm_device(mesh: Mesh, t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: the host under gloo, the card
    under NCCL."""
    if mesh.backend != "nccl":
        return torch.device("cpu")
    return t.device if t.is_cuda else torch.device(
        "cuda", torch.cuda.current_device())


def all_reduce_(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM,
                group=None) -> torch.Tensor:
    """In place over ``group`` (the world by default); a no-op in one
    process."""
    if mesh.size == 1:
        return t
    dev = _comm_device(mesh, t)
    if dev == t.device:
        dist.all_reduce(t, op=op, group=group)
        return t
    h = t.to(dev)
    dist.all_reduce(h, op=op, group=group)
    return t.copy_(h)


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    if mesh.size == 1:
        return t
    dev = _comm_device(mesh, t)
    if dev == t.device:
        dist.broadcast(t, src)
        return t
    h = t.to(dev)
    dist.broadcast(h, src)
    return t.copy_(h)


def _gather_rays(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    dev = _comm_device(mesh, x)
    local = x.detach().to(dev).contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.rays)]
    dist.all_gather(parts, local, group=mesh.ray_group)
    return uninterleave_rays(torch.cat(parts, dim=1), mesh.rays).to(x.device)


class _GatherRays(torch.autograd.Function):
    """All-gather over the ray group, in ray order.  Every rank of the
    group computes the same loss on the gathered images, so the adjoint
    takes this rank's own slice of its cotangent (no reduction)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_rays(mesh, x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = g.shape[1] // mesh.rays
        r = mesh.ray_index
        return _interleave(g, mesh.rays)[:, r * n:(r + 1) * n].contiguous(), \
            None


def gather_rays(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(B, N/rm, ...) ray shards -> (B, N, ...) in ray order on every rank of
    the ray group; differentiable."""
    if mesh.rays == 1:
        return x
    return _GatherRays.apply(x, mesh)


def reduce_gradients_(mesh: Mesh, params: Iterable[torch.nn.Parameter],
                      scale: float) -> None:
    """Sum every parameter's ``.grad`` over the world and multiply by
    ``scale``, in ONE all-reduce per gradient dtype.  A parameter without a
    gradient here but with one on another rank takes zeros; one without on
    every rank keeps None (as the single-process step leaves it)."""
    params = list(params)
    if mesh.size == 1:
        return
    dev = params[0].device
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.int32,
                       device=dev)
    all_reduce_(mesh, has, op=dist.ReduceOp.MAX)
    grads = []
    for p, h in zip(params, has.tolist()):
        if h and p.grad is None:
            p.grad = torch.zeros_like(p)
        if h:
            grads.append(p.grad)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        all_reduce_(mesh, flat)
        flat.mul_(scale)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def mean_metrics(mesh: Mesh, metrics: Dict[str, torch.Tensor],
                 max_keys: Tuple[str, ...] = ("overflow",)
                 ) -> Dict[str, torch.Tensor]:
    """Each scalar metric averaged over the world (the values are equal
    along the ray axis, so this is the mean over data groups), those in
    ``max_keys`` maximized instead: two all-reduces."""
    if mesh.size == 1:
        return metrics
    keys = sorted(metrics)
    dev = metrics[keys[0]].device
    mean = [k for k in keys if k not in max_keys]
    top = [k for k in keys if k in max_keys]
    out = {}
    for names, op in ((mean, dist.ReduceOp.SUM), (top, dist.ReduceOp.MAX)):
        if not names:
            continue
        v = torch.stack([metrics[k].detach().reshape(()).to(dev, torch.float64)
                         for k in names])
        all_reduce_(mesh, v, op=op)
        if op == dist.ReduceOp.SUM:
            v = v / mesh.size
        for k, x in zip(names, v):
            out[k] = x.to(metrics[k].dtype)
    return out


def shard_generator(seed: int, mesh: Mesh, device) -> torch.Generator:
    """This rank's generator for the density noise: seeded from ``seed``
    and the rank's (data, ray) index, so the shards draw different noise
    (the JAX step folds data index * 4096 + ray index into its key).  Rank
    (0, 0), and so a one-rank mesh, draws from ``seed`` itself."""
    return torch.Generator(device=device).manual_seed(
        seed + 1_000_003 * (mesh.data_index * 4096 + mesh.ray_index))
