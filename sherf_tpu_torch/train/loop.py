"""Training orchestration (torch counterpart of ``sherf_tpu/train/loop.py``).

Same order as the JAX loop: build the dataset pipeline (or take the
caller's ``batch_source``), size the canonical volume over every served
subject, calibrate the budgets when asked, build the model and the train
state, run the steps, accumulate metrics on the device and flush their
means every report interval, snapshot with a sample grid rendered by the
EMA weights.  With ``tcfg.adv_weight > 0`` each step runs the adversarial
phases (``train/gan.py``): Gmain, then Dmain, then Dreg on the steps that
are a multiple of ``d_reg_interval`` (step 0 included), with a
``DualDiscriminator`` at the batches' image size, drawn from ``tcfg.seed +
1``; snapshots hold G only, as in the JAX loop, so a resumed GAN run starts
a fresh D.  Unlike the JAX loop, the metrics of a final partial report
interval are flushed before the last snapshot, so no step's metrics are
lost, and each metric is averaged over the steps that produced it (the JAX
loop keeps only the metrics of every step of an interval, which drops
``r1_penalty`` from any interval longer than one step).

In a process group of more than one rank (``parallel/multihost.py``) the
loop runs the sharded steps over a (data, rays) mesh of the ranks:
``tcfg.mesh_shape`` when it covers the world and divides the batch and the
rays, else ``auto_mesh``'s choice.  The ranks of a data group load the
same items (an ``InfiniteSampler`` over the data groups) and each takes
its ray shard; a caller's ``batch_source`` returns the global batch on
every rank, and each rank takes its shard of it.  The budgets calibrated
on rank 0 and its weights (after a resume too) are broadcast; rank 0
alone writes the options, stats, snapshots and sample grids.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from sherf_tpu_torch.core.calibrate import (calibrate_budgets,
                                            calibrate_sparse_caps)
from sherf_tpu_torch.core.config import DataConfig, ModelConfig, TrainConfig
from sherf_tpu_torch.data import DATASETS, collate
from sherf_tpu_torch.data.base import host_smpl_verts
from sherf_tpu_torch.data.sampler import InfiniteSampler, PrefetchLoader
from sherf_tpu_torch.eval.png import write_png
from sherf_tpu_torch.eval.test_loop import to8b
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
from sherf_tpu_torch.parallel.mesh import (all_reduce_, make_mesh,
                                           shard_batch, shard_generator)
from sherf_tpu_torch.parallel.multihost import (coordination_barrier,
                                                host_local_batch_to_global,
                                                replicate_from_host0)
from sherf_tpu_torch.smpl.lbs import big_pose_params
from sherf_tpu_torch.smpl.model import SMPLModel
from sherf_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from sherf_tpu_torch.train.lpips import make_lpips
from sherf_tpu_torch.train.stats import StatsCollector
from sherf_tpu_torch.train.step import (make_sharded_train_step,
                                        make_train_step)
from sherf_tpu_torch.train.train_state import TrainState, create_train_state


def build_dataset(dcfg: DataConfig, smpl: SMPLModel):
    if dcfg.name == "synthetic":
        return DATASETS["synthetic"](smpl, H=dcfg.resolution, W=dcfg.resolution,
                                     poses_num=dcfg.poses_num)
    return DATASETS[dcfg.name](
        dcfg.data_root, smpl, split=dcfg.split,
        multi_person=dcfg.multi_person, num_instance=dcfg.num_instance,
        poses_start=dcfg.poses_start, poses_interval=dcfg.poses_interval,
        poses_num=dcfg.poses_num, image_scaling=dcfg.image_scaling,
        white_back=dcfg.white_back, sample_obs_view=dcfg.sample_obs_view,
        fix_obs_view=dcfg.fix_obs_view)


@torch.no_grad()
def _save_sample_grid(state: TrainState, smpl, batch, path: str):
    """Per-snapshot sample render (reference save_image_grid,
    training_loop.py:104,563-579): a [pred | gt | obs] row per batch item,
    rendered with the EMA weights."""
    out, _ = torch.func.functional_call(state.model, state.ema, (batch, smpl),
                                        strict=False)
    pred = out["image_raw"].float().cpu().numpy() / 2.0 + 0.5
    rows = [np.concatenate([p, g, o], axis=1) for p, g, o in
            zip(pred, batch.img.cpu().numpy(), batch.obs_img.cpu().numpy())]
    write_png(path, to8b(np.concatenate(rows, axis=0)))


def training_loop(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                  smpl: SMPLModel, batch_source: Optional[Callable] = None,
                  calibrate: Optional[float] = None, device="cuda",
                  progress_fn: Optional[Callable] = None,
                  abort_fn: Optional[Callable] = None):
    """Train for ``tcfg.total_kimg`` thousand images; returns the state.

    batch_source: optional () -> SHERFBatch on ``device``; without it the
    batches come from ``build_dataset(dcfg, smpl)`` through a
    ``PrefetchLoader`` over an ``InfiniteSampler`` seeded by ``tcfg.seed``.
    calibrate: optional margin; when set, the static prune budgets are
    fitted to the survivor counts of 12 batches before the model is built.
    The model's weights are drawn from ``torch.Generator().manual_seed(
    tcfg.seed)``; ``tcfg.resume`` restores a checkpoint over them.
    progress_fn: optional (step, means) called after every report with the
    reported means.  abort_fn: optional () -> bool polled after every
    report; True (on any rank) stops training after a final snapshot."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    run_dir = tcfg.outdir
    if rank == 0:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "training_options.json"), "w") as f:
            json.dump({"model": cfg.to_json(), "train": str(tcfg),
                       "data": str(dcfg)}, f, indent=2)
    hooks = dict(progress_fn=progress_fn, abort_fn=abort_fn)
    if batch_source is not None:
        return _train(cfg, tcfg, smpl, batch_source, [], calibrate, device,
                      global_batches=True, **hooks)
    dataset = build_dataset(dcfg, smpl)
    mesh_shape = ((1, 1) if world == 1 else
                  _choose_mesh_shape(tcfg, world, _rays_of(dataset)))
    dm, rm = mesh_shape
    # the ranks of one data group load the same items
    loader = PrefetchLoader(dataset, tcfg.batch_size // dm,
                            functools.partial(collate, device=device),
                            InfiniteSampler(len(dataset), rank=rank // rm,
                                            num_replicas=dm, seed=tcfg.seed),
                            num_workers=dcfg.num_workers)
    try:
        bodies = (list(dataset.subject_bodies())
                  if hasattr(dataset, "subject_bodies") else [])
        return _train(cfg, tcfg, smpl, lambda: next(loader), bodies,
                      calibrate, device, global_batches=False,
                      mesh_shape=mesh_shape, **hooks)
    finally:
        loader.close()


def _rays_of(dataset) -> int:
    """Rays of one item (each item is an image's every pixel)."""
    return int(np.asarray(dataset[0]["ray_o"]).shape[0])


def _choose_mesh_shape(tcfg: TrainConfig, world: int, n_rays: int):
    """``tcfg.mesh_shape`` when it covers the world and divides the batch
    and the rays (as the JAX loop keeps a mesh that fits), else
    ``auto_mesh_shape``'s choice, which must cover the world."""
    from sherf_tpu_torch.parallel.mesh import auto_mesh_shape

    dm, rm = tcfg.mesh_shape
    if not (dm * rm == world and tcfg.batch_size % dm == 0
            and n_rays % rm == 0):
        dm, rm = auto_mesh_shape(tcfg.batch_size, n_rays, world)
    if dm * rm != world:
        raise ValueError(f"no (data, rays) mesh over {world} ranks divides "
                         f"batch {tcfg.batch_size} and {n_rays} rays")
    return dm, rm


def _train(cfg, tcfg, smpl, batch_source, subject_bodies, calibrate, device,
           global_batches, mesh_shape=None, progress_fn=None, abort_fn=None):
    """``global_batches``: ``batch_source`` gives the global batch (each
    rank takes its shard), else this rank's data group's items (each rank
    takes its ray shard)."""
    run_dir = tcfg.outdir
    # the canonical volume must cover every served subject's canonical
    # body, not just the default-shape one (a larger subject's sites would
    # fall off the grid edge)
    bp = big_pose_params()
    bodies = [host_smpl_verts(smpl, bp["poses"], bp["shapes"])[0]]
    bodies += subject_bodies
    shapes = [prepare_voxel_volume(b, voxel_size=cfg.voxel_size)[1]
              for b in bodies]
    out_sh = tuple(int(max(s[k] for s in shapes)) for k in range(3))
    if cfg.sparse_caps is None and len(bodies) > 1:
        cfg = dataclasses.replace(cfg, sparse_caps=calibrate_sparse_caps(
            bodies, cfg.voxel_size))

    example = batch_source()     # as the JAX loop, which inits on it
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shape is None:
        mesh_shape = _choose_mesh_shape(tcfg, world, example.ray_o.shape[1])
    mesh = make_mesh(mesh_shape)
    rank = mesh.rank
    if world > 1:
        print(f"mesh: {mesh.shape} over {world} ranks (rank {rank}, data "
              f"{mesh.data_index}, rays {mesh.ray_index}; backend "
              f"{mesh.backend})", flush=True)
    if calibrate is not None:
        # a spread of batches: budgets fitted to one pose or subject
        # truncate harder draws; the overflow counters stay the guard
        cal = [example] + [batch_source() for _ in range(11)]
        fitted, worst = calibrate_budgets(cal, cfg, margin=calibrate)
        if world > 1:                   # every rank takes rank 0's budgets
            box = [(fitted, worst)]
            dist.broadcast_object_list(box, src=0)
            fitted, worst = box[0]
        print(f"calibrated budgets (margin {calibrate}): {worst}")
        cfg = dataclasses.replace(cfg, render=fitted)
        del cal
    img_res = example.img.shape[1]      # the D's size (square images only)
    del example
    model = SHERFGenerator(cfg, out_sh=out_sh, device=device)
    random_init_(model, torch.Generator().manual_seed(tcfg.seed))
    state = create_train_state(model, tcfg)
    if tcfg.resume:
        restore_checkpoint(tcfg.resume, state)
        print(f"resumed from {tcfg.resume} at step {state.step}")
    replicate_from_host0(mesh, state)
    shard = ((lambda b: shard_batch(b, mesh)) if global_batches else
             (lambda b: host_local_batch_to_global(b, mesh)))

    # LPIPS joins the loss when weights exist (SHERF_LPIPS_WEIGHTS), as in
    # the JAX loop; without them its term is 0
    lpips_fn = make_lpips(device)
    gan = tcfg.adv_weight > 0
    if gan:
        from sherf_tpu_torch.features.discriminator import DualDiscriminator
        from sherf_tpu_torch.train.gan import (create_d_train_state,
                                               make_sharded_gan_steps)

        d_state = create_d_train_state(
            DualDiscriminator(img_resolution=img_res).to(device), tcfg,
            generator=torch.Generator().manual_seed(tcfg.seed + 1))
        replicate_from_host0(mesh, d_state)
        step_fn, d_main_step, d_reg_step = make_sharded_gan_steps(
            model, smpl, tcfg, mesh, lpips_fn=lpips_fn)
        # the D phase's re-render draws its density noise from a generator
        # of its own (the JAX loop folds 2 into the step's key)
        d_gen = shard_generator(tcfg.seed + 2, mesh, device)
    elif mesh.size == 1:
        # the one-process seam: callers replace the loop's make_train_step
        # to count or stop its steps; it is the sharded body on one rank
        step_fn = make_train_step(model, smpl, tcfg, lpips_fn=lpips_fn)
    else:
        step_fn = make_sharded_train_step(model, smpl, tcfg, mesh,
                                          lpips_fn=lpips_fn)
    # rank 0 writes the stats; the others keep theirs in memory
    stats = StatsCollector(run_dir if rank == 0 else None)
    total_steps = int(tcfg.total_kimg * 1000) // tcfg.batch_size
    report_every = max(tcfg.report_imgs // tcfg.batch_size, 1)
    snapshot_every = max(tcfg.kimg_per_tick * tcfg.snapshot_ticks * 1000
                         // tcfg.batch_size, 1)
    gen = shard_generator(tcfg.seed, mesh, device)
    t_tick = time.time()
    aborted = False
    # device-side metric sums since the last flush, and each one's count
    acc, acc_n = {}, {}

    def flush_metrics(step):
        nonlocal acc, acc_n
        if acc:
            stats.report({k: v / acc_n[k] for k, v in acc.items()},
                         prefix="Loss/")
        acc, acc_n = {}, {}
        stats.report_resources()
        return stats.flush(step)

    for step in range(state.step, total_steps):
        t0 = time.time()
        batch = shard(batch_source())
        t1 = time.time()
        if gan:
            metrics = step_fn(state, d_state, batch, gen)
            metrics.update(d_main_step(d_state, state, batch, d_gen))
            if step % tcfg.d_reg_interval == 0:     # lazy R1
                metrics.update(d_reg_step(d_state, batch))
        else:
            metrics = step_fn(state, batch, gen)
        for k, v in metrics.items():
            acc[k] = acc[k] + v if k in acc else v
            acc_n[k] = acc_n.get(k, 0) + 1
        stats.report({"data_fetch": t1 - t0, "step_dispatch": time.time() - t1},
                     prefix="Timing/")
        last = step + 1 == total_steps
        if (step + 1) % report_every == 0:
            means = flush_metrics(step + 1)
            imgs = (step + 1) * tcfg.batch_size
            sec_kimg = ((time.time() - t_tick)
                        / max(report_every * tcfg.batch_size, 1) * 1000)
            t_tick = time.time()
            line = " ".join(f"{k.split('/')[-1]} {v:.4f}"
                            for k, v in means.items() if k.startswith("Loss/"))
            if rank == 0:
                print(f"kimg {imgs / 1000:.2f} sec/kimg {sec_kimg:.1f} "
                      f"{line}")
            if progress_fn is not None:
                progress_fn(step + 1, means)
            aborted = _any_rank(mesh, abort_fn is not None and bool(
                abort_fn()))
        if (step + 1) % snapshot_every == 0 or last or aborted:
            if (last or aborted) and acc:
                flush_metrics(step + 1)       # the final partial interval
            t_snap = time.time()
            # every rank draws the grid's batch, so the ranks' loaders stay
            # in step; rank 0 writes the snapshot and renders the grid
            grid_batch = batch_source()
            if rank == 0:
                path = save_checkpoint(os.path.join(run_dir, "checkpoints"),
                                       state)
                print(f"snapshot -> {path}")
                try:
                    _save_sample_grid(state, smpl, grid_batch, os.path.join(
                        run_dir, f"fakes{step + 1:06d}.png"))
                except Exception:  # noqa: BLE001 — a failed grid must not stop training
                    traceback.print_exc()
                    print("sample-grid render failed")
            del grid_batch
            stats.report({"snapshot": time.time() - t_snap}, prefix="Timing/")
        if aborted:
            print("abort_fn requested stop; exiting training loop")
            break
    if stats.pending:
        stats.flush(state.step)
    stats.close()
    coordination_barrier("training_loop_end")
    return state


def _any_rank(mesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    all_reduce_(mesh, t, op=dist.ReduceOp.MAX)
    return bool(t.item())
