"""What each rank of the multi-process CPU tests of
``tests/test_torch_parallel.py`` runs (a module of its own: spawned ranks
import it, and it imports torch and the port only).  Each function is
``fn(rank, world, *args)`` for ``sherf_tpu_torch.parallel.launch
.run_local``; it joins the process group through a ``file://`` store and
writes its results with ``torch.save`` under the test's directory."""

import dataclasses
import os

import torch

from sherf_tpu_torch.core.calibrate import calibrate_budgets
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig, TrainConfig
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.features.discriminator import DualDiscriminator
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
from sherf_tpu_torch import smpl as t_smpl

H = W = 16
DEPTH = 8
MODEL_KW = dict(backbone_resolution=32, channel_base=1024, channel_max=32,
                voxel_size=0.02, sparse_conv_layers=2)
D_KW = dict(img_resolution=16, channel_max=32)
# eps 1e-3 (as the JAX package's sharded GAN test): Adam's g / (sqrt(v) +
# eps) flips sign under reduction-order noise for near-zero gradients
TRAIN_KW = dict(lr=1e-3, adv_weight=0.1, d_reg_interval=2, eps=1e-3)
# the per-shard budgets hold half the rays' survivors of a 16-wide image:
# a margin over the even / odd column split
MARGIN = 1.5


def scene(batch_size):
    """(smpl, batch, cfg, out_sh): the synthetic scene at 16x16 rays x 4
    samples with budgets calibrated on the whole batch."""
    smpl = t_smpl.synthetic_smpl(0, device="cpu")
    bp = t_smpl.big_pose_params()
    tv = t_smpl.smpl_forward(smpl, torch.from_numpy(bp["poses"]),
                             torch.from_numpy(bp["shapes"]))[0].numpy()
    _, out_sh = prepare_voxel_volume(tv, voxel_size=MODEL_KW["voxel_size"])
    batch = make_synthetic_batch(smpl, batch_size=batch_size, H=H, W=W,
                                 seed=0, device="cpu")
    cfg = ModelConfig(**MODEL_KW, render=RenderConfig(depth_resolution=DEPTH,
                                                      density_noise=0.0))
    fitted, _ = calibrate_budgets([batch], cfg, margin=MARGIN, round_to=128)
    assert fitted.point_capacity_frac < 1 and fitted.ray_capacity_frac < 1
    return smpl, batch, dataclasses.replace(cfg, render=fitted), out_sh


# raised on the decoder's density bias so that random weights draw an
# opaque body (as tests/test_torch_e2e.py does)
DENSITY_BIAS = 5.0


def model_of(cfg, out_sh):
    m = SHERFGenerator(cfg, out_sh=out_sh, device="cpu")
    random_init_(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.renderer.decoder.alpha.bias += DENSITY_BIAS
    return m


def disc():
    return DualDiscriminator(**D_KW)


def _join(rank, world, init_file):
    from sherf_tpu_torch.parallel.multihost import maybe_initialize_distributed

    torch.set_num_threads(1)
    return maybe_initialize_distributed("file://" + init_file, world, rank,
                                        device="cpu")


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def sharded_round(rank, world, init_file, shape, out_dir):
    """On this rank's shard: a sharded render, one sharded train step (and
    the same step through ``make_phase_fns``) and one sharded GAN round
    (Gmain, Dmain, Dreg), each from fresh weights."""
    import torch.distributed as dist

    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.parallel import make_mesh, make_sharded_render
    from sherf_tpu_torch.parallel.mesh import shard_batch, shard_generator
    from sherf_tpu_torch.train import create_train_state
    from sherf_tpu_torch.train.gan import (create_d_train_state,
                                           make_sharded_gan_steps)
    from sherf_tpu_torch.train.step import (make_phase_fns,
                                            make_sharded_train_step)

    _join(rank, world, init_file)
    dm = shape[0]
    smpl, batch, cfg, out_sh = scene(batch_size=dm)
    mesh = make_mesh(shape)
    local = shard_batch(batch, mesh)
    tcfg = TrainConfig(batch_size=dm, **TRAIN_KW)
    res = {"mesh": (mesh.data, mesh.rays, mesh.data_index, mesh.ray_index),
           "backend": mesh.backend, "local_rays": local.ray_o.shape[1]}

    model = model_of(cfg, out_sh).eval()
    res["render"] = {k: v.clone() for k, v in
                     make_sharded_render(model, smpl, mesh)(local).items()}

    model = model_of(cfg, out_sh)
    state = create_train_state(model, tcfg)
    step = make_sharded_train_step(model, smpl, tcfg, mesh)
    res["train"] = step(state, local, shard_generator(0, mesh, "cpu"))
    res["train_params"] = _params(model)
    res["launches"] = dict(_cuda.LAUNCHES)

    # the same step through make_phase_fns on the mesh, phase by phase
    model = model_of(cfg, out_sh)
    state = create_train_state(model, tcfg)
    grad_fn, opt_fn, ema_fn = make_phase_fns(model, smpl, tcfg, mesh=mesh)
    res["phases"] = grad_fn(state, local, shard_generator(0, mesh, "cpu"))
    opt_fn(state)
    ema_fn(state)
    res["phases_params"] = _params(model)

    model = model_of(cfg, out_sh)
    g_state = create_train_state(model, tcfg)
    d_state = create_d_train_state(disc(), tcfg,
                                   generator=torch.Generator().manual_seed(1))
    g_step, d_main, d_reg = make_sharded_gan_steps(model, smpl, tcfg, mesh)
    gen = shard_generator(0, mesh, "cpu")
    res["gan_g"] = g_step(g_state, d_state, local, gen)
    res["gan_d"] = d_main(d_state, g_state, local, gen)
    res["gan_r"] = d_reg(d_state, local)
    res["gan_g_params"] = _params(model)
    res["gan_d_params"] = _params(d_state.model)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def env_join(rank, world, init_file, out_dir):
    """Join through the SHERF_* environment alone, then all-reduce."""
    import torch.distributed as dist

    from sherf_tpu_torch.parallel.multihost import maybe_initialize_distributed

    os.environ.update(SHERF_COORDINATOR="file://" + init_file,
                      SHERF_NUM_PROCESSES=str(world),
                      SHERF_PROCESS_ID=str(rank))
    got = maybe_initialize_distributed(device="cpu")
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    torch.save({"got": got, "backend": dist.get_backend(), "sum": float(t)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def train_cli(rank, world, init_file, flags, out_dir):
    """``cli/train.main`` with ``flags`` (the dataset, batch and mesh) at
    the test's small widths (set through ``model_config_from_args``), cut
    to 2 steps."""
    import hashlib

    from sherf_tpu_torch.cli import train as train_cli_mod
    from sherf_tpu_torch.train import loop as t_loop

    torch.set_num_threads(1)
    build = train_cli_mod.model_config_from_args
    train_cli_mod.model_config_from_args = lambda a: dataclasses.replace(
        build(a), **MODEL_KW)
    run = t_loop.training_loop
    seen = {}

    def short(cfg, tcfg, *args, **kwargs):
        seen["tcfg"] = tcfg
        state = run(cfg, dataclasses.replace(
            tcfg, total_kimg=2 * tcfg.batch_size / 1000, report_imgs=1),
            *args, **kwargs)
        seen["state"] = state
        return state
    t_loop.training_loop = short
    if rank == 1:       # rank 1 takes the process group from the environment
        os.environ.update(SHERF_COORDINATOR="file://" + init_file,
                          SHERF_NUM_PROCESSES=str(world),
                          SHERF_PROCESS_ID=str(rank))
        group = []
    else:
        group = ["--coordinator", "file://" + init_file, "--num_processes",
                 str(world), "--process_id", str(rank)]
    train_cli_mod.main(["--outdir", os.path.join(out_dir, "run"), "--kimg",
                        "1", "--depth_resolution", "4",
                        "--point_capacity_frac", "0.5", "--device", "cpu",
                        "--workers", "1"] + list(flags) + group)
    def digest(model):
        h = hashlib.sha256()
        for k, v in sorted(model.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    state = seen["state"]
    res = {"step": state.step, "digest": digest(state.model)}
    if rank == 0:       # the snapshot restores into a fresh state
        from sherf_tpu_torch.train import create_train_state
        from sherf_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                      restore_checkpoint)

        fresh = create_train_state(SHERFGenerator(
            state.model.cfg, out_sh=state.model.renderer.out_sh,
            device="cpu"), seen["tcfg"])
        restore_checkpoint(latest_checkpoint(os.path.join(
            out_dir, "run", "checkpoints")), fresh)
        res["restored"] = {"step": fresh.step, "digest": digest(fresh.model),
                           "ema_equal": all(torch.equal(fresh.ema[k], v)
                                            for k, v in state.ema.items())}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
