"""The training step (torch counterpart of ``sherf_tpu/train/step.py``
``make_train_step``): forward in train mode, loss, backward, zero-nans +
Adam + step LR, then the EMA.  The sharded step and the split phase
functions are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from sherf_tpu_torch.core.config import TrainConfig
from sherf_tpu_torch.core.diag import overflow_total
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.smpl.model import SMPLModel
from sherf_tpu_torch.train.loss import reconstruction_loss
from sherf_tpu_torch.train.train_state import TrainState, ema_beta, ema_update


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all the tensors together (f32)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def make_train_step(model, smpl: SMPLModel, tcfg: TrainConfig,
                    lpips_fn: Optional[Callable] = None) -> Callable:
    """Returns ``step(state, batch, generator) -> metrics``.

    ``generator`` (a ``torch.Generator`` on the model's device) draws the
    density noise.  Metrics are tensors on the device (no host sync): the
    loss dict of :func:`reconstruction_loss`, ``grad_norm`` (the global L2
    norm of the raw gradients, before NaNs are zeroed) and ``overflow``
    (the sum of the renderer's budget-overflow counters)."""
    beta = ema_beta(tcfg.batch_size, tcfg.ema_kimg)

    def step(state: TrainState, batch: SHERFBatch,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        state.opt.zero_grad(set_to_none=True)
        out, diag = model(batch, smpl, noise_mode="none", train=True,
                          generator=generator)
        loss, metrics = reconstruction_loss(out, batch, tcfg,
                                            lpips_fn=lpips_fn)
        metrics["overflow"] = overflow_total(diag).to(loss.device)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = global_norm(grads)
        state.apply_gradients()
        ema_update(state.ema, model.named_parameters(), beta)
        return {k: v.detach() for k, v in metrics.items()}

    return step
