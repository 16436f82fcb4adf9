"""Train a SHERF model (torch counterpart of ``sherf_tpu/cli/train.py``;
reference train.py + train_*.sh), in one process on one device or in one
process per device over a (data, rays) mesh.

Examples:
  python -m sherf_tpu_torch.cli.train --outdir runs/syn --cfg synthetic --kimg 1
  python -m sherf_tpu_torch.cli.train --outdir runs/grid --cfg synthetic_grid \\
      --batch 1 --kimg 3 --calibrate_budgets true --calibrate_margin 1.5
  python -m sherf_tpu_torch.cli.train --outdir runs/gan --cfg synthetic_grid \\
      --batch 1 --kimg 3 --adv_weight 0.1 --d_reg_interval 16
  (add --device cpu to run on the CPU)

Multi-process: start one process per rank with the same flags and its own
``--process_id`` (or ``SHERF_COORDINATOR`` / ``SHERF_NUM_PROCESSES`` /
``SHERF_PROCESS_ID``):
  python -m sherf_tpu_torch.cli.train --outdir runs/mp --cfg synthetic_grid \
      --batch 2 --mesh 2,1 --coordinator localhost:29500 --num_processes 2 \
      --process_id 0        # and --process_id 1 in a second process
Rank r takes ``cuda:(local rank % device count)``; the backend is NCCL when
every rank of a host owns a GPU, gloo otherwise; ``LOCAL_WORLD_SIZE`` (the
ranks of this host) is needed when the world has more ranks than this host
has GPUs (``parallel/multihost.choose_backend``).
"""

from __future__ import annotations

import argparse

import torch

from sherf_tpu_torch.cli.common import (
    add_model_flags, model_config_from_args, resolve_device, resolve_smpl)
from sherf_tpu_torch.core.config import DataConfig, TrainConfig
from sherf_tpu_torch.parallel.multihost import (maybe_initialize_distributed,
                                                rank_device)


# shipped dataset schedules (reference train.py:246-268)
DATA_DEFAULTS = {
    "renderpeople": dict(num_instance=450, poses_start=0, poses_interval=2,
                         poses_num=10),
    "thuman": dict(num_instance=90, poses_start=0, poses_interval=1,
                   poses_num=20),
    "humman": dict(num_instance=317, poses_start=0, poses_interval=6,
                   poses_num=17, image_scaling=1 / 3),
    "zju": dict(num_instance=6, poses_start=0, poses_interval=5,
                poses_num=100, image_scaling=0.5),
    "synthetic": dict(num_instance=1, poses_num=8),
    # the multi-subject grid rig (data/synthetic.py SyntheticHumanDataset,
    # native 512 scaled by --neural_rendering_resolution_initial, 6 fixed
    # views): the production dataset pipeline and eval protocols with no
    # files on disk (train subjects 0..N-1; held-out subjects from 100)
    "synthetic_grid": dict(num_instance=24, poses_num=8),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--outdir", required=True)
    p.add_argument("--cfg", default="synthetic", choices=sorted(DATA_DEFAULTS))
    p.add_argument("--data", default="")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--kimg", type=int, default=800)
    p.add_argument("--glr", type=float, default=2.5e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--snap", type=int, default=1)
    p.add_argument("--workers", type=int, default=3)
    p.add_argument("--num_instance", type=int, default=0,
                   help="override the cfg's subject count (0 = cfg default)")
    p.add_argument("--sample_obs_view", type=lambda s: s.lower() == "true",
                   default=False)
    p.add_argument("--fix_obs_view", type=lambda s: s.lower() == "true",
                   default=True)
    p.add_argument("--mesh", type=str, default=None,
                   help="rank mesh as 'data,rays', e.g. '2,2' over 4 ranks")
    p.add_argument("--adv_weight", type=float, default=0.0,
                   help="adversarial G-loss weight; >0 builds the dual "
                   "discriminator and runs Dmain + lazy-R1 Dreg phases "
                   "(0 in all shipped SHERF configs)")
    p.add_argument("--dlr", type=float, default=2e-3)
    p.add_argument("--gamma", type=float, default=10.0,
                   help="R1 gamma (reference train.py --gamma)")
    p.add_argument("--d_reg_interval", type=int, default=16)
    p.add_argument("--coordinator", default=None,
                   help="multi-process: the process group's address "
                   "'host:port' (rank 0's host) or an init URL such as "
                   "'file:///shared/rendezvous' (or set SHERF_COORDINATOR)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    add_model_flags(p)
    a = p.parse_args(argv)

    mesh_shape = tuple(int(x) for x in a.mesh.split(",")) if a.mesh else (1, 1)
    device = resolve_device(a.device)
    # the process group before any other device work
    proc, n_proc = maybe_initialize_distributed(
        a.coordinator, a.num_processes, a.process_id, device=device)
    device = rank_device(device)
    if n_proc > 1:
        print(f"multi-process: rank {proc} of {n_proc} on {device}")

    cfg = model_config_from_args(a)
    dd = dict(DATA_DEFAULTS[a.cfg])
    if a.num_instance:
        dd["num_instance"] = a.num_instance
    scaling = dd.pop("image_scaling", a.neural_rendering_resolution_initial / 512)
    dcfg = DataConfig(name=a.cfg, data_root=a.data, split="train",
                      image_scaling=scaling, white_back=a.white_back,
                      sample_obs_view=a.sample_obs_view,
                      fix_obs_view=a.fix_obs_view, num_workers=a.workers, **dd)
    tcfg = TrainConfig(total_kimg=a.kimg, batch_size=a.batch, lr=a.glr,
                       seed=a.seed, outdir=a.outdir, resume=a.resume,
                       snapshot_ticks=a.snap, mesh_shape=mesh_shape,
                       adv_weight=a.adv_weight, d_lr=a.dlr, r1_gamma=a.gamma,
                       d_reg_interval=a.d_reg_interval)

    smpl = resolve_smpl(a.smpl_model, device)

    batch_source = None
    if a.cfg == "synthetic":
        from sherf_tpu_torch.data import make_synthetic_batch

        counter = [0]

        def batch_source():
            counter[0] += 1
            return make_synthetic_batch(smpl, batch_size=a.batch, H=64, W=64,
                                        seed=counter[0] % 16, device=device)

    from sherf_tpu_torch.train.loop import training_loop

    try:
        training_loop(cfg, tcfg, dcfg, smpl, batch_source=batch_source,
                      calibrate=(a.calibrate_margin if a.calibrate_budgets
                                 else None), device=device)
    finally:
        if n_proc > 1:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
