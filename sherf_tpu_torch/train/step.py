"""The training step (torch counterpart of ``sherf_tpu/train/step.py``):
forward in train mode, loss, backward, zero-nans + Adam + step LR, then
the EMA.  One body serves every mesh: :func:`make_sharded_train_step` over
a (data, rays) mesh of ranks, :func:`make_train_step` the same on one rank
(where the collectives are no-ops), and :func:`make_phase_fns` the step
split into its phases.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from sherf_tpu_torch.core.config import TrainConfig
from sherf_tpu_torch.core.diag import overflow_total
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.parallel.mesh import (Mesh, gather_rays, mean_metrics,
                                           reduce_gradients_)
from sherf_tpu_torch.smpl.model import SMPLModel
from sherf_tpu_torch.train.loss import reconstruction_loss
from sherf_tpu_torch.train.train_state import TrainState, ema_beta, ema_update


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all the tensors together (f32)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def _grads(model):
    return [p.grad for p in model.parameters() if p.grad is not None]


def render_images(model, smpl: SMPLModel, mesh: Mesh, batch: SHERFBatch,
                  **kwargs):
    """``model(batch, smpl, **kwargs)`` on this rank's shard -> (outputs as
    full images, the batch they go with, diag).  With one ray shard these
    are the model's outputs and the batch.  With more, the model renders
    its rays flat (no SR head: ``image`` is ``image_raw``) and the images,
    and the batch's per-ray masks, are all-gathered over the ray group:
    every rank of the group then holds what the image-space loss and D
    read."""
    if mesh.rays == 1:
        out, diag = model(batch, smpl, **kwargs)
        return out, batch, diag
    out, diag = model(batch, smpl, flat_output=True, **kwargs)
    B, H, W = batch.img.shape[:3]
    img = gather_rays(mesh, out["image_raw"]).reshape(B, H, W, 3)
    full = {"image_raw": img, "image": img,
            "weights_image": gather_rays(mesh, out["weights_image"]).reshape(
                B, H, W)}
    batch_full = dataclasses.replace(
        batch, mask_at_box=gather_rays(mesh, batch.mask_at_box),
        bkgd_msk=gather_rays(mesh, batch.bkgd_msk))
    return full, batch_full, diag


def _make_local_grads(model, smpl: SMPLModel, tcfg: TrainConfig, mesh,
                      lpips_fn: Optional[Callable] = None) -> Callable:
    """The loss and gradient body of the step and of ``make_phase_fns``:
    ``local_grads(batch, generator) -> metrics`` on this rank's shard
    (``shard_batch``), leaving the reduced gradients in ``.grad``.

    The local forward renders the shard's rays; a ray all-gather gives the
    image-space loss full images (every rank of a ray group computes the
    same loss, and the gather's adjoint hands each its own rays'
    cotangent); one fused all-reduce over the world sums the gradients,
    divided by dm (a sum over the ray shards, a mean over the data groups'
    losses).  ``overflow`` is the maximum over every rank, the other
    metrics the mean over the data groups.  ``generator`` is this rank's
    own (``shard_generator``): the density noise differs by shard.  On a
    one-rank mesh the collectives are no-ops: this is the one-process
    step's body."""
    def local_grads(batch: SHERFBatch, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        out, batch, diag = render_images(model, smpl, mesh, batch,
                                         noise_mode="none", train=True,
                                         generator=generator)
        loss, metrics = reconstruction_loss(out, batch, tcfg,
                                            lpips_fn=lpips_fn)
        metrics["overflow"] = overflow_total(diag).to(loss.device)
        loss.backward()
        reduce_gradients_(mesh, model.parameters(), 1.0 / mesh.data)
        return mean_metrics(mesh, {k: v.detach() for k, v in metrics.items()})

    return local_grads


def make_sharded_train_step(model, smpl: SMPLModel, tcfg: TrainConfig, mesh,
                            lpips_fn: Optional[Callable] = None) -> Callable:
    """The train step over a (data, rays) mesh of ranks: ``step(state,
    batch, generator) -> metrics`` with ``batch`` this rank's shard
    (``shard_batch`` of the global batch, or ``host_local_batch_to_global``
    of its data group's items) and ``generator`` this rank's.  Each rank
    renders only its (B/dm, N/rm) shard; after the gradient all-reduce the
    gradients, the update and the metrics are the same on every rank, and
    equal to the one-process step's on the same items up to reduction
    order (a mean of the data groups' losses).

    Metrics are tensors on the device (no host sync): the loss dict of
    :func:`reconstruction_loss`, ``grad_norm`` (the global L2 norm of the
    raw gradients, before NaNs are zeroed) and ``overflow`` (the sum of the
    renderer's budget-overflow counters)."""
    beta = ema_beta(tcfg.batch_size, tcfg.ema_kimg)
    local_grads = _make_local_grads(model, smpl, tcfg, mesh, lpips_fn)

    def step(state: TrainState, batch: SHERFBatch,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        state.opt.zero_grad(set_to_none=True)
        metrics = local_grads(batch, generator)
        metrics["grad_norm"] = global_norm(_grads(model))
        state.apply_gradients()
        ema_update(state.ema, model.named_parameters(), beta)
        return metrics

    return step


def make_train_step(model, smpl: SMPLModel, tcfg: TrainConfig,
                    lpips_fn: Optional[Callable] = None) -> Callable:
    """Returns ``step(state, batch, generator) -> metrics`` in one process:
    :func:`make_sharded_train_step` on a one-rank mesh.  ``generator`` (a
    ``torch.Generator`` on the model's device) draws the density noise."""
    return make_sharded_train_step(model, smpl, tcfg, Mesh(1, 1), lpips_fn)


def make_phase_fns(model, smpl: SMPLModel, tcfg: TrainConfig,
                   lpips_fn: Optional[Callable] = None, mesh=None):
    """The train step split into its phases, for timing each: (grad_fn,
    opt_fn, ema_fn), which composed are the step's update.

      grad_fn(state, batch, generator) -> metrics (gradients in ``.grad``)
      opt_fn(state)   zero-nans + Adam + the rate at the step
      ema_fn(state)   the EMA update

    grad_fn is the step's body on ``mesh`` (one rank by default), its
    collectives included."""
    beta = ema_beta(tcfg.batch_size, tcfg.ema_kimg)
    local_grads = _make_local_grads(model, smpl, tcfg, mesh or Mesh(1, 1),
                                    lpips_fn)

    def grad_fn(state, batch, generator):
        state.opt.zero_grad(set_to_none=True)
        return local_grads(batch, generator)

    def opt_fn(state):
        state.apply_gradients()

    def ema_fn(state):
        ema_update(state.ema, model.named_parameters(), beta)

    return grad_fn, opt_fn, ema_fn
