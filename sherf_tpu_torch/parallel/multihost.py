"""Multi-process scaffolding (torch counterpart of
``sherf_tpu/parallel/multihost.py``): one process per device.

JAX runs one process per host and places its collectives itself; torch
runs one process (rank) per device and needs a process group:

  * :func:`maybe_initialize_distributed` (JAX's ``jax.distributed``
    initialization): the process group from explicit arguments or the
    ``SHERF_COORDINATOR`` / ``SHERF_NUM_PROCESSES`` / ``SHERF_PROCESS_ID``
    environment; ``(0, 1)`` and no process group without a coordinator.
    The backend is NCCL when every rank on this host owns a GPU of its
    own, gloo otherwise (two ranks on one GPU: NCCL refuses them); the
    choice is printed (:func:`choose_backend`).
  * :func:`rank_device`: rank r runs on ``cuda:(local rank % device
    count)``, or on the CPU when that is what the caller asked for.
  * data: the ranks of one data group load the same items
    (``InfiniteSampler(rank=data index, num_replicas=dm)``) and each takes
    its ray shard (:func:`host_local_batch_to_global`); nothing is
    assembled across processes.
  * :func:`replicate_from_host0`: rank 0's parameters, buffers, EMA and
    optimizer state broadcast to every rank (the reference's rank-0 param
    broadcast; needed after a resume).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.parallel.mesh import Mesh, broadcast_, ray_shard

# seconds a collective waits for a peer before the process group fails
TIMEOUT_S = 1800


def local_rank(rank: int) -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK``
    when a launcher sets it, else the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def choose_backend(device: torch.device, world: int) -> str:
    """NCCL when each rank of this host owns a GPU, gloo otherwise (more
    ranks on this host than GPUs: NCCL refuses two ranks on one GPU).

    The ranks of this host are ``LOCAL_WORLD_SIZE`` (torchrun and
    ``parallel/launch.run_local`` set it).  Without it a world of no more
    ranks than this host's GPUs is taken as one host; a larger world on
    CUDA raises, since it is as likely several hosts, each rank with a GPU
    of its own (NCCL), as more ranks here than GPUs (gloo, every
    collective through host memory)."""
    if device.type != "cuda":
        return "gloo"
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None:
        if world <= torch.cuda.device_count():
            return "nccl"
        raise ValueError(
            f"a world of {world} CUDA ranks and {torch.cuda.device_count()} "
            f"GPUs here: set LOCAL_WORLD_SIZE to the ranks on this host, "
            f"which decides the backend (NCCL when each owns a GPU)")
    return "nccl" if int(local) <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device="cuda") -> Tuple[int, int]:
    """Initialize the process group when multi-process information is
    present; returns (rank, world size).

    Sources, in order: explicit arguments; the ``SHERF_COORDINATOR`` /
    ``SHERF_NUM_PROCESSES`` / ``SHERF_PROCESS_ID`` environment variables.
    ``coordinator`` is ``host:port`` (a TCP store on rank 0's host) or an
    ``init_method`` URL such as ``file:///shared/path``.  A coordinator
    without the world size and this process's rank raises.  ``device`` is
    the kind of device the ranks compute on (it decides the backend)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("SHERF_COORDINATOR")
    if num_processes is None and os.environ.get("SHERF_NUM_PROCESSES"):
        num_processes = int(os.environ["SHERF_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SHERF_PROCESS_ID"):
        process_id = int(os.environ["SHERF_PROCESS_ID"])
    if coordinator is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the world size and this "
                         "process's rank: --num_processes and --process_id "
                         "(or SHERF_NUM_PROCESSES / SHERF_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of "
                         f"{num_processes}")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = choose_backend(torch.device(device), num_processes)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    print(f"process group: rank {process_id} of {num_processes}, backend "
          f"{backend}", flush=True)
    return process_id, num_processes


def rank_device(device) -> torch.device:
    """A CUDA device becomes ``cuda:(local rank % device count)`` (and the
    current device); any other is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = torch.device("cuda", local_rank(rank) % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def global_batch_size(per_rank_batch: int, mesh: Mesh) -> int:
    """The global batch when each rank's data group holds
    ``per_rank_batch`` items (JAX: per-host batch x process count)."""
    return per_rank_batch * mesh.data


def coordination_barrier(name: str) -> None:
    """Block until every rank reaches this point (JAX's coordination
    service barrier); a no-op in one process.  ``name`` is for the
    caller's reading: torch's barrier takes none."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def host_local_batch_to_global(batch: SHERFBatch, mesh: Mesh) -> SHERFBatch:
    """This rank's ray shard of its data group's items (JAX assembles a
    global array from each host's items; here each rank keeps only what it
    computes on, so nothing is assembled)."""
    return ray_shard(batch, mesh)


@torch.no_grad()
def replicate_from_host0(mesh: Mesh, *states) -> None:
    """Broadcast rank 0's values into every rank's, in place: each state's
    model parameters and buffers, its EMA and its optimizer state (a
    ``TrainState``), or a module's parameters and buffers.  The ranks must
    hold the same structure (the same model and optimizer)."""
    if mesh.size == 1:
        return
    for st in states:
        model = getattr(st, "model", st)
        tensors = list(model.parameters()) + list(model.buffers())
        tensors += [st.ema[k] for k in sorted(getattr(st, "ema", {}) or {})]
        opt = getattr(st, "opt", None)
        if opt is not None:
            for group in opt.param_groups:
                for p in group["params"]:
                    s = opt.state.get(p, {})
                    tensors += [s[k] for k in sorted(s)
                                if isinstance(s[k], torch.Tensor)]
        for t in tensors:
            broadcast_(mesh, t)
        if hasattr(st, "step"):
            step = torch.tensor([st.step], dtype=torch.int64)
            broadcast_(mesh, step)
            st.step = int(step)
