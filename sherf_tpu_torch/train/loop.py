"""Training orchestration (torch counterpart of ``sherf_tpu/train/loop.py``).

Same order as the JAX loop: calibrate the budgets when asked, build the
model and the train state, run the steps, accumulate metrics on the device
and flush their means every report interval, snapshot.  Batches come from
the caller's ``batch_source``; the dataset loaders are not ported yet.
Unlike the JAX loop, the metrics of a final partial report interval are
flushed before the last snapshot, so no step's metrics are lost.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import torch

from sherf_tpu_torch.core.calibrate import calibrate_budgets
from sherf_tpu_torch.core.config import DataConfig, ModelConfig, TrainConfig
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
from sherf_tpu_torch.smpl.lbs import big_pose_params, smpl_forward
from sherf_tpu_torch.smpl.model import SMPLModel
from sherf_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from sherf_tpu_torch.train.stats import StatsCollector
from sherf_tpu_torch.train.step import make_train_step
from sherf_tpu_torch.train.train_state import create_train_state


def training_loop(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                  smpl: SMPLModel, batch_source: Optional[Callable] = None,
                  calibrate: Optional[float] = None, device="cuda"):
    """Train for ``tcfg.total_kimg`` thousand images; returns the state.

    batch_source: () -> SHERFBatch on ``device`` (required).
    calibrate: optional margin; when set, the static prune budgets are
    fitted to the survivor counts of 12 batches before the model is built.
    The model's weights are drawn from ``torch.Generator().manual_seed(
    tcfg.seed)``; ``tcfg.resume`` restores a checkpoint over them."""
    if batch_source is None:
        raise NotImplementedError(
            "training_loop needs a batch_source: the dataset loaders are not "
            "ported yet (ROADMAP A6)")
    run_dir = tcfg.outdir
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump({"model": cfg.to_json(), "train": str(tcfg),
                   "data": str(dcfg)}, f, indent=2)

    # the canonical volume covers the default-shape body in its big pose
    bp = big_pose_params()
    sdev = smpl.v_template.device
    with torch.no_grad():
        t_verts = smpl_forward(smpl, torch.from_numpy(bp["poses"]).to(sdev),
                               torch.from_numpy(bp["shapes"]).to(sdev))[0]
    _, out_sh = prepare_voxel_volume(t_verts.cpu().numpy(),
                                     voxel_size=cfg.voxel_size)

    example = batch_source()
    if calibrate is not None:
        cal = [example] + [batch_source() for _ in range(11)]
        fitted, worst = calibrate_budgets(cal, cfg, margin=calibrate)
        print(f"calibrated budgets (margin {calibrate}): {worst}")
        cfg = dataclasses.replace(cfg, render=fitted)
    model = SHERFGenerator(cfg, out_sh=out_sh, device=device)
    random_init_(model, torch.Generator().manual_seed(tcfg.seed))
    state = create_train_state(model, tcfg)
    if tcfg.resume:
        restore_checkpoint(tcfg.resume, state)
        print(f"resumed from {tcfg.resume} at step {state.step}")

    step_fn = make_train_step(model, smpl, tcfg)
    stats = StatsCollector(run_dir)
    total_steps = int(tcfg.total_kimg * 1000) // tcfg.batch_size
    report_every = max(tcfg.report_imgs // tcfg.batch_size, 1)
    snapshot_every = max(tcfg.kimg_per_tick * tcfg.snapshot_ticks * 1000
                         // tcfg.batch_size, 1)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    t_tick = time.time()
    acc, acc_count = None, 0    # device-side metric sums since the last flush

    def flush_metrics(step):
        nonlocal acc, acc_count
        if acc_count:
            stats.report({k: v / acc_count for k, v in acc.items()},
                         prefix="Loss/")
        acc, acc_count = None, 0
        stats.report_resources()
        return stats.flush(step)

    for step in range(state.step, total_steps):
        t0 = time.time()
        batch = batch_source()
        t1 = time.time()
        metrics = step_fn(state, batch, gen)
        acc = (dict(metrics) if acc is None
               else {k: acc[k] + metrics[k] for k in acc})
        acc_count += 1
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
            print(f"kimg {imgs / 1000:.2f} sec/kimg {sec_kimg:.1f} {line}")
        if (step + 1) % snapshot_every == 0 or last:
            if last and acc_count:
                flush_metrics(step + 1)       # the final partial interval
            t_snap = time.time()
            path = save_checkpoint(os.path.join(run_dir, "checkpoints"), state)
            print(f"snapshot -> {path}")
            stats.report({"snapshot": time.time() - t_snap}, prefix="Timing/")
    if stats.pending:
        stats.flush(state.step)
    stats.close()
    return state
