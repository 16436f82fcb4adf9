"""The one-process counterpart of a sharded phase, against which the
sharded steps are checked: each data group's items go through the
one-process phase (``train/step.py`` ``make_train_step``, ``train/gan.py``
``make_gan_train_step``) from a copy of the same state, and the state then
takes one optimizer step on the mean of their gradients.  With one data
group it is the one-process phase itself.  The ray shards need no
counterpart: the one-process phase renders every ray.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Sequence

import torch

from sherf_tpu_torch.core.types import SHERFBatch, _map_tensors
from sherf_tpu_torch.train.step import global_norm


def split_items(batch: SHERFBatch, groups: int) -> List[SHERFBatch]:
    B = batch.img.shape[0]
    n = B // groups
    return [_map_tensors(batch, lambda t, lo=lo: t[lo:lo + n])
            for lo in range(0, B, n)]


def _snapshot(state):
    return copy.deepcopy((state.model.state_dict(), state.opt.state_dict(),
                          state.ema, state.step))


def _restore(state, snap) -> None:
    model_sd, opt_sd, ema, step = copy.deepcopy(snap)
    state.model.load_state_dict(model_sd)
    state.opt.load_state_dict(opt_sd)
    with torch.no_grad():
        for k, v in ema.items():
            state.ema[k].copy_(v)
    state.step = step


def data_parallel_phase(phase: Callable, state, batches: Sequence[SHERFBatch],
                        args_before=(), args_after=(),
                        step: Callable = None) -> Dict[str, torch.Tensor]:
    """Run ``phase(state, *args_before, batch, *args_after)`` on each batch,
    each from ``state`` as it was before (restored in between), then
    ``step(state)`` (the phase's own optimizer step and EMA) with each
    parameter's ``.grad`` the mean of the batches' gradients.  Returns the
    metrics averaged over the batches (``overflow``: their maximum;
    ``grad_norm``: the norm of the mean gradient, as the sharded steps
    report it)."""
    if len(batches) == 1:
        return phase(state, *args_before, batches[0], *args_after)
    before = _snapshot(state)
    grads, metrics = [], []
    for b in batches:
        metrics.append(phase(state, *args_before, b, *args_after))
        grads.append([None if p.grad is None else p.grad.clone()
                      for p in state.model.parameters()])
        _restore(state, before)
    state.opt.zero_grad(set_to_none=True)
    for i, p in enumerate(state.model.parameters()):
        gs = [g[i] for g in grads if g[i] is not None]
        if gs:
            p.grad = torch.stack(gs).sum(0) / len(grads)
    out = {k: (torch.stack([m[k] for m in metrics]).amax(0) if k == "overflow"
               else torch.stack([m[k] for m in metrics]).mean(0))
           for k in metrics[0]}
    if "grad_norm" in out:          # the norm of the mean gradient
        out["grad_norm"] = global_norm(
            [p.grad for p in state.model.parameters() if p.grad is not None])
    step(state)
    return out
