"""Optimizer, EMA and learning-rate schedule (torch counterpart of
``sherf_tpu/train/train_state.py``).

The reference recipe: Adam with betas (0, 0.99) and eps 1e-8, a StepLR
that halves the rate every ``lr_decay_images // batch_size`` steps, NaN
gradients zeroed before the update, and an EMA of the parameters with
``ema_kimg`` = 10.  The EMA averages parameters only: buffers (batch-norm
statistics, noise, ``w_avg``) are not averaged, as the JAX package keeps
them in ``extra_vars``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable

import torch
import torch.nn as nn

from sherf_tpu_torch.core.config import TrainConfig


def step_lr_schedule(base_lr: float, decay_images: int, batch_size: int,
                     factor: float = 0.5) -> Callable[[int], float]:
    """step -> lr * factor^(step // max(decay_images // batch_size, 1))."""
    interval = max(decay_images // batch_size, 1)

    def schedule(step: int) -> float:
        return base_lr * (factor ** (step // interval))

    return schedule


@dataclasses.dataclass
class TrainState:
    """``step`` counts the optimizer steps taken; ``ema`` maps each
    parameter name of ``model`` to its moving average."""

    model: nn.Module
    ema: Dict[str, torch.Tensor]
    opt: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self) -> None:
        """zero-nans -> Adam -> scaled by the rate at the pre-increment
        step (optax ``scale_by_schedule`` reads the count before it adds
        one); the gradients are the parameters' ``.grad``."""
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad = zero_nans(p.grad)
        lr = self.schedule(self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1


def zero_nans(g: torch.Tensor) -> torch.Tensor:
    """NaN -> 0; +-inf stay (``optax.zero_nans``)."""
    return torch.where(torch.isnan(g), torch.zeros_like(g), g)


def create_train_state(model: nn.Module, tcfg: TrainConfig) -> TrainState:
    schedule = step_lr_schedule(tcfg.lr, tcfg.lr_decay_images,
                                tcfg.batch_size, tcfg.lr_decay_factor)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=tuple(tcfg.betas), eps=tcfg.eps)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model=model, ema=ema, opt=opt, schedule=schedule)


def ema_beta(batch_size: int, ema_kimg: float) -> float:
    """0.5 ** (batch / (ema_kimg * 1000))."""
    return 0.5 ** (batch_size / max(ema_kimg * 1000.0, 1e-8))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               params: Iterable, beta: float) -> None:
    """In place: e <- p + (e - p) * beta for each (name, parameter)."""
    for name, p in params:
        e = ema[name]
        e.copy_(p + (e - p) * beta)
