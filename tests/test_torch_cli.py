"""The port's CLIs against the JAX package's, on the CPU: the same argv
through both ``main``s with the work they hand off replaced by a recorder
(``training_loop`` in the train CLI; the model build, the weight restore
and ``run_eval`` in the eval CLI, all imported where ``main`` reaches
them).  What each main assembles must be equal field by field.  The port's
CLIs also take ``--device`` (default ``cuda``), which the JAX CLIs do not
have: here it is ``cpu``.  Without it, on a machine with no GPU, they stop
instead of falling back to the CPU.
"""

import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sherf_tpu.cli.common as j_common
import sherf_tpu.eval.test_loop as j_test_loop
import sherf_tpu.train.checkpoint as j_checkpoint
import sherf_tpu.train.loop as j_loop
from sherf_tpu.cli import eval as j_eval_cli
from sherf_tpu.cli import train as j_train_cli
import sherf_tpu_torch.eval.test_loop as t_test_loop
import sherf_tpu_torch.train.loop as t_loop
from sherf_tpu_torch.cli import calc_metrics as t_calc_cli
from sherf_tpu_torch.cli import eval as t_eval_cli
from sherf_tpu_torch.cli import train as t_train_cli

LIFECYCLE = ["--cfg", "synthetic_grid", "--batch", "1", "--kimg", "3",
             "--glr", "1e-3", "--neural_rendering_resolution_initial", "256",
             "--calibrate_budgets", "true", "--calibrate_margin", "1.5",
             "--snap", "100", "--workers", "3"]


def _record(calls, key):
    def fn(*args, **kwargs):
        calls[key] = (args, kwargs)
    return fn


def _same_config(t, j):
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("argv", [
    LIFECYCLE,
    ["--cfg", "synthetic_grid", "--data", "subject5", "--num_instance", "3",
     "--sample_obs_view", "true", "--white_back", "true", "--seed", "7",
     "--use_trans", "false", "--point_capacity_frac", "0.25"],
    ["--cfg", "humman", "--data", "/data/p000455_a000986", "--batch", "2",
     "--resume", "runs/x/snapshot-000100.pt", "--depth_resolution", "64"],
    ["--cfg", "synthetic", "--kimg", "1"],
], ids=["lifecycle", "flags", "humman", "synthetic"])
def test_train_cli_passes_the_configs_jax_does(monkeypatch, tmp_path, argv):
    calls = {}
    monkeypatch.setattr(j_loop, "training_loop", _record(calls, "jax"))
    monkeypatch.setattr(t_loop, "training_loop", _record(calls, "torch"))
    argv = ["--outdir", str(tmp_path)] + argv
    j_train_cli.main(argv)
    t_train_cli.main(argv + ["--device", "cpu"])
    (j_args, j_kw), (t_args, t_kw) = calls["jax"], calls["torch"]
    for t, j in zip(t_args[:3], j_args[:3]):        # model, train, data
        _same_config(t, j)
    assert t_kw["calibrate"] == j_kw["calibrate"]
    assert (t_kw["batch_source"] is None) == (j_kw["batch_source"] is None)
    assert t_kw["device"] == torch.device("cpu")
    assert t_args[3].v_template.device.type == "cpu"


@pytest.mark.parametrize("extra", [["--mesh", "2,1"], ["--num_processes", "2"],
                                   ["--coordinator", "localhost:1234"]])
def test_train_cli_rejects_what_is_not_ported(monkeypatch, tmp_path, extra):
    """The distribution flags are ported (the runs over two processes are
    in tests/test_torch_parallel.py).  In one process: ``--mesh`` reaches
    the TrainConfig as in the JAX CLI; ``--num_processes`` without a
    coordinator is one process, as in JAX; a coordinator without the world
    size is refused before any connection is tried."""
    calls = {}
    monkeypatch.setattr(j_loop, "training_loop", _record(calls, "jax"))
    monkeypatch.setattr(t_loop, "training_loop", _record(calls, "torch"))
    for var in ("SHERF_COORDINATOR", "SHERF_NUM_PROCESSES",
                "SHERF_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--outdir", str(tmp_path)] + extra
    if extra[0] == "--coordinator":
        with pytest.raises(ValueError, match="--num_processes"):
            t_train_cli.main(argv + ["--device", "cpu"])
        assert "torch" not in calls
        return
    j_train_cli.main(argv)
    t_train_cli.main(argv + ["--device", "cpu"])
    _same_config(calls["torch"][0][1], calls["jax"][0][1])
    assert not torch.distributed.is_initialized()


class _StubFlaxModel:
    def init(self, rng, batch, smpl):
        return {"params": {"w": jnp.zeros((1,))}}


@pytest.mark.parametrize("argv", [
    ["--data", "subject100", "--neural_rendering_resolution_initial", "32"],
    ["--data", "subject7", "--subjects", "subject100", "subject101",
     "--obs_pose_mode", "first", "--white_back", "true",
     "--neural_rendering_resolution_initial", "64"],
], ids=["default_subjects", "explicit_subjects"])
def test_eval_cli_assembles_what_jax_does(monkeypatch, tmp_path, argv):
    calls = {}
    monkeypatch.setattr(j_common, "build_model",
                        lambda cfg, smpl: (_StubFlaxModel(), (32, 32, 32), cfg))
    monkeypatch.setattr(j_checkpoint, "restore_checkpoint",
                        lambda path, state: state)
    monkeypatch.setattr(j_test_loop, "run_eval", _record(calls, "jax"))
    stub = torch.nn.Linear(1, 1)
    monkeypatch.setattr(t_eval_cli, "build_model",
                        lambda cfg, smpl, device: (stub, (32, 32, 32), cfg))
    monkeypatch.setattr(t_eval_cli, "load_weights",
                        _record(calls, "torch_weights"))
    monkeypatch.setattr(t_test_loop, "run_eval", _record(calls, "torch"))
    argv = ["--cfg", "synthetic_grid", "--resume", "snap",
            "--outdir", str(tmp_path)] + argv
    j_eval_cli.main(argv)
    t_eval_cli.main(argv + ["--device", "cpu"])

    (j_args, j_kw), (t_args, t_kw) = calls["jax"], calls["torch"]
    assert t_args[2:] == j_args[2:]           # subjects, obs views, outdir
    assert t_kw.pop("device") == torch.device("cpu")
    assert t_kw == j_kw                       # protocol and pose range
    assert calls["torch_weights"] == ((stub, "snap"), {"use_ema": True})
    for subject in t_args[2]:
        td = t_args[1](subject, 0, 1, 4)
        jd = j_args[1](subject, 0, 1, 4)
        for attr in ("H", "W", "image_scaling", "split", "multi_person",
                     "num_instance", "poses_start", "poses_interval",
                     "poses_num", "white_back", "sample_obs_view",
                     "fix_obs_view", "subject_base", "camera_view_num"):
            assert getattr(td, attr) == getattr(jd, attr), attr
        np.testing.assert_allclose(td.t_vertices, jd.t_vertices, atol=2e-5)


def test_eval_cli_rejects_a_loader_that_is_not_ported():
    """Every loader is ported: a file-backed one whose subject directory is
    missing stops at its first read, before the checkpoint is read."""
    with pytest.raises(FileNotFoundError, match="/data/thuman/s0"):
        t_eval_cli.main(["--cfg", "thuman", "--data", "/data/thuman/s0",
                         "--resume", "snap", "--device", "cpu"])


@pytest.mark.parametrize("main,argv", [
    (t_train_cli.main, ["--outdir", "unused"]),
    (t_eval_cli.main, ["--cfg", "synthetic_grid", "--data", "subject100",
                       "--resume", "snap"]),
    (t_calc_cli.main, ["--cfg", "synthetic"]),
], ids=["train", "eval", "calc_metrics"])
def test_clis_default_to_cuda_and_never_fall_back(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(argv)


@pytest.fixture
def _few_torch_threads():
    """Two intra-op threads while the real run trains and renders (as
    ``tests/test_torch_train.py``): the suite runs several test processes
    on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def test_osg_decoder_and_sr_head_train_snapshot_eval(monkeypatch, tmp_path,
                                                     _few_torch_threads):
    """``--use_nerf_decoder false --use_sr_module true`` end to end: the
    flags reach the same ModelConfig as in the JAX CLI, then the port's
    train CLI trains 2 steps on the synthetic_grid rig (128x128 rays, the
    SR head's smallest output, x 4 samples) and snapshots, and the eval
    CLI restores the snapshot into a model with the OSG decoder and the SR
    head and scores two poses of subject100.  Both CLIs build the test's
    small widths (backbone 32, narrow channels, 2 cm voxels) and the run
    is cut to 2 steps and two poses: what is held is the CLIs' handling of
    the two branches, not the model's size."""
    flags = ["--cfg", "synthetic_grid",
             "--neural_rendering_resolution_initial", "128",
             "--depth_resolution", "4",
             "--use_nerf_decoder", "false", "--use_sr_module", "true"]
    calls = {}
    monkeypatch.setattr(j_loop, "training_loop", _record(calls, "jax"))
    j_train_cli.main(["--outdir", str(tmp_path / "j"), "--num_instance", "2"]
                     + flags)
    cfg_j = calls["jax"][0][0]
    assert not cfg_j.use_nerf_decoder and cfg_j.use_sr_module
    assert cfg_j.img_resolution == 128

    small = dict(backbone_resolution=32, channel_base=1024, channel_max=32,
                 voxel_size=0.02, sparse_conv_layers=2)
    for cli in (t_train_cli, t_eval_cli):
        build = cli.model_config_from_args
        monkeypatch.setattr(cli, "model_config_from_args",
                            lambda a, build=build: dataclasses.replace(
                                build(a), **small))
    train = t_loop.training_loop

    def short(cfg, tcfg, *args, **kwargs):
        _same_config(dataclasses.replace(cfg_j, **small), cfg)
        return train(cfg, dataclasses.replace(tcfg, total_kimg=0.002,
                                              report_imgs=1), *args, **kwargs)
    monkeypatch.setattr(t_loop, "training_loop", short)
    run = tmp_path / "run"
    t_train_cli.main(["--outdir", str(run), "--batch", "1", "--workers", "1",
                      "--num_instance", "2", "--device", "cpu"] + flags)
    from sherf_tpu_torch.train.checkpoint import latest_checkpoint
    snap = latest_checkpoint(str(run / "checkpoints"))
    state = torch.load(snap, map_location="cpu", weights_only=False)
    keys = set(state["ema"])
    assert "renderer.decoder.fc0.weight" in keys
    assert any(k.startswith("superresolution.block1.") for k in keys)

    grid = dict(t_eval_cli.EVAL_DEFAULTS["synthetic_grid"], pose_num=2)
    monkeypatch.setitem(t_eval_cli.EVAL_DEFAULTS, "synthetic_grid", grid)
    res = t_eval_cli.main(["--data", "subject100", "--resume", snap,
                           "--outdir", str(tmp_path / "eval"),
                           "--device", "cpu"] + flags)
    for protocol in ("novel_view", "novel_pose"):
        assert np.isfinite(res[protocol]["psnr"])
        assert np.isfinite(res[protocol]["ssim"])
