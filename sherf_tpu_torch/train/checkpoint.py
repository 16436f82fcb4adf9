"""Checkpoints (torch counterpart of ``sherf_tpu/train/checkpoint.py``,
which uses orbax): ``torch.save`` of the model's state dict (parameters
and buffers), the EMA, the optimizer state and the step; restored with
``torch.load(weights_only=True)`` into an existing state of the same
model.  The learning rate follows from the step (the schedule is a pure
function of it).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sherf_tpu_torch.train.train_state import TrainState


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: Optional[int] = None) -> str:
    """Write ``snapshot-<step>.pt`` (``step`` defaults to the state's; the
    file holds the state's own step either way, as the JAX package's
    names the directory by ``step`` and stores ``state.step``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step = state.step if step is None else int(step)
    path = os.path.join(os.path.abspath(ckpt_dir), f"snapshot-{step:06d}.pt")
    torch.save({"step": state.step,
                "model": state.model.state_dict(),
                "ema": state.ema,
                "optimizer": state.opt.state_dict()}, path)
    return path


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load ``path`` into ``state`` (in place) and return it."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ck["model"], strict=True)
    if set(ck["ema"]) != set(state.ema):
        raise ValueError("checkpoint EMA does not match the model's parameters")
    with torch.no_grad():
        for k, v in ck["ema"].items():
            state.ema[k].copy_(v)
    state.opt.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    snaps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("snapshot-"))
    return os.path.join(ckpt_dir, snaps[-1]) if snaps else None
