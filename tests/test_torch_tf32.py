"""Every CLI of the port runs its f32 convolutions and matmuls in full
f32: with both TF32 switches first set on (PyTorch's cuDNN default), each
CLI's ``main`` turns them off when it resolves its device.  The run is
stopped right after the device is resolved (``resolve_device`` wrapped to
raise once it has returned), so nothing else runs."""

import importlib

import pytest
import torch

CLIS = {
    "train": ["--outdir", "unused"],
    "eval": ["--cfg", "synthetic_grid", "--data", "subject100", "--resume",
             "snap"],
    "calc_metrics": ["--cfg", "synthetic"],
    "gen_videos": [],
    "gen_samples": [],
    "render_demo": [],
    "debug_project": [],
    "visualizer": [],
}


class _Resolved(Exception):
    pass


@pytest.fixture
def tf32_on():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        flags


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_turns_tf32_off(name, tf32_on, monkeypatch):
    cli = importlib.import_module(f"sherf_tpu_torch.cli.{name}")
    real = cli.resolve_device

    def resolve_then_stop(*args, **kwargs):
        real(*args, **kwargs)
        raise _Resolved
    monkeypatch.setattr(cli, "resolve_device", resolve_then_stop)
    with pytest.raises(_Resolved):
        cli.main(CLIS[name] + ["--device", "cpu"])
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
