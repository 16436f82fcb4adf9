"""Adversarial training phases (torch counterpart of
``sherf_tpu/train/gan.py``): the non-saturating softplus losses, lazy R1
regularization and the three phases of a GAN step, Gmain, Dmain and Dreg
(reference loss.py:150-165, 292-346; training_loop.py:243-256), sharded
over a (data, rays) mesh of ranks (``make_sharded_gan_steps``) or in one
process (``make_gan_train_step``, the same phases on a one-rank mesh).

D inputs are in [-1, 1]: the generator's ``image`` / ``image_raw`` already
are; real images are ``batch.img * 2 - 1``, passed as both inputs.  The D
optimizer is the port's ``TrainState`` with no EMA and a constant rate:
one Adam state that Dmain and Dreg both step, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.core.config import TrainConfig
from sherf_tpu_torch.core.diag import overflow_total
from sherf_tpu_torch.parallel.mesh import Mesh, mean_metrics, reduce_gradients_
from sherf_tpu_torch.train.loss import reconstruction_loss
from sherf_tpu_torch.train.step import global_norm, render_images
from sherf_tpu_torch.train.train_state import TrainState, ema_beta, ema_update

# the D phases' optimizer state: the G state's type, without an EMA
DTrainState = TrainState


def g_adversarial_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """softplus(-D(fake)), the non-saturating G loss."""
    return F.softplus(-fake_logits).mean()


def d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """softplus(D(fake)) + softplus(-D(real))."""
    return F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()


def r1_penalty(d_model: nn.Module, image: torch.Tensor,
               image_raw: torch.Tensor) -> torch.Tensor:
    """R1 on real images: the mean over items of |dD/d image|^2, with a
    graph that reaches D's parameters.  Only ``image`` is differentiated:
    the raw input enters as a tensor of its own that requires no grad, so
    passing the same values as both inputs counts the image path alone."""
    image = image.detach().requires_grad_(True)
    logits = d_model(image, image_raw.detach())
    (grad,) = torch.autograd.grad(logits.sum(), image, create_graph=True)
    return (grad * grad).sum(dim=(1, 2, 3)).mean()


def make_gan_losses(d_model: nn.Module):
    """Returns (g_term, d_term) over generator outputs and real images:

    g_term(gen_out) -> the adversarial G term;
    d_term(gen_out, real_image, real_raw, r1_gamma, do_r1) -> (loss,
    metrics), the fake inputs detached."""
    def g_term(gen_out):
        return g_adversarial_loss(d_model(gen_out["image"],
                                          gen_out["image_raw"]))

    def d_term(gen_out, real_image, real_raw, r1_gamma: float = 10.0,
               do_r1: bool = False):
        fake = d_model(gen_out["image"].detach(), gen_out["image_raw"].detach())
        real = d_model(real_image, real_raw)
        loss = d_loss(real, fake)
        metrics = {"d_loss": loss.detach(),
                   "scores_fake": fake.detach().mean(),
                   "scores_real": real.detach().mean()}
        if do_r1:
            r1 = r1_penalty(d_model, real_image, real_raw)
            loss = loss + r1 * (r1_gamma / 2.0)
            metrics["r1_penalty"] = r1.detach()
        return loss, metrics

    return g_term, d_term


@torch.no_grad()
def init_discriminator_(d_model: nn.Module,
                        generator: torch.Generator) -> nn.Module:
    """Redraw D's weights from N(0, 1) with ``generator`` and zero its
    biases: the JAX module's init distribution (unit-scale equalized-lr
    weights, zero biases)."""
    for name, p in d_model.named_parameters():
        if name.endswith("weight"):
            p.copy_(torch.randn(tuple(p.shape), generator=generator))
        else:
            p.zero_()
    return d_model


def _d_state(d_model, lr, betas, eps, generator):
    if generator is not None:
        init_discriminator_(d_model, generator)
    opt = torch.optim.Adam(d_model.parameters(), lr=lr, betas=tuple(betas),
                           eps=eps)
    return DTrainState(model=d_model, ema={}, opt=opt,
                       schedule=lambda step: lr)


def create_d_state(d_model: nn.Module, lr: float = 2e-3,
                   betas: Tuple[float, float] = (0.0, 0.99),
                   generator: Optional[torch.Generator] = None) -> DTrainState:
    """D with zero-nans + Adam(betas, eps 1e-8) at a constant ``lr``."""
    return _d_state(d_model, lr, betas, 1e-8, generator)


def create_d_train_state(d_model: nn.Module, tcfg: TrainConfig,
                         generator: Optional[torch.Generator] = None
                         ) -> DTrainState:
    """The lazy-regularization optimizer: zero-nans, Adam with betas **
    mb_ratio and ``tcfg.eps``, rate ``tcfg.d_lr * mb_ratio``, where
    mb_ratio = I / (I + 1) for I = ``tcfg.d_reg_interval``.  With a
    ``generator``, D's weights are drawn from it first."""
    mb_ratio = tcfg.d_reg_interval / (tcfg.d_reg_interval + 1)
    betas = tuple(b ** mb_ratio for b in tcfg.betas)
    return _d_state(d_model, tcfg.d_lr * mb_ratio, betas, tcfg.eps, generator)


def _step_d(d_state: DTrainState) -> None:
    """Adam step of D on its parameters' ``.grad``.  A parameter the phase's
    loss does not reach (R1 does not reach ``out.bias``) steps with a zero
    gradient, as optax steps every leaf: its moments decay and every
    parameter shares one step count for the bias correction."""
    for p in d_state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    d_state.apply_gradients()


def make_sharded_gan_steps(model, smpl, tcfg: TrainConfig, mesh: Mesh,
                           lpips_fn: Optional[Callable] = None):
    """Returns (g_step, d_main_step, d_reg_step) over a (data, rays) mesh
    of ranks, each stepping its state in place and returning its metrics
    (tensors on the device); ``batch`` is this rank's shard
    (``shard_batch``) and each ``generator`` this rank's own:

      g_step(g_state, d_state, batch, generator): reconstruction loss +
        adv_weight * softplus(-D(fake)), Adam, EMA; ``generator`` draws the
        density noise.  D's parameters take no gradient.  Metrics: the
        loss dict with ``loss`` the total, ``g_adv``, ``overflow`` and
        ``grad_norm`` (as the train step).
      d_main_step(d_state, g_state, batch, generator): G re-rendered in
        train mode without a graph (``generator``: its density noise),
        then softplus(D(fake)) + softplus(-D(real)).  Metrics ``d_loss``,
        ``scores_fake``, ``scores_real``.
      d_reg_step(d_state, batch): lazy R1 on the real images, its loss
        scaled by gain = ``d_reg_interval``.  Metric ``r1_penalty``.  The
        caller runs it every ``d_reg_interval`` steps.

    Each D phase starts from cleared gradients, so nothing of another
    phase reaches its Adam step.  G renders the rank's ray shard and the
    images are all-gathered over the ray group (``train/step.py``
    ``render_images``), so D always sees full images and every rank of a
    ray group computes the same D terms.  Gmain: the G gradients summed
    over the world and divided by dm, as the train step's; Dmain and Dreg:
    the D gradients averaged over the world (equal along the rays, a mean
    over the data groups).  Metrics are averaged over the world,
    ``overflow`` maximized.  On a one-rank mesh the collectives are
    no-ops."""
    beta = ema_beta(tcfg.batch_size, tcfg.ema_kimg)

    def g_step(g_state: TrainState, d_state: DTrainState, batch,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
        d_model = d_state.model
        g_state.opt.zero_grad(set_to_none=True)
        out, batch, diag = render_images(model, smpl, mesh, batch,
                                         noise_mode="none", train=True,
                                         generator=generator)
        loss, metrics = reconstruction_loss(out, batch, tcfg,
                                            lpips_fn=lpips_fn)
        d_model.requires_grad_(False)
        try:
            adv = g_adversarial_loss(d_model(out["image"], out["image_raw"]))
        finally:
            d_model.requires_grad_(True)
        total = loss + tcfg.adv_weight * adv
        metrics.update(g_adv=adv, loss=total,
                       overflow=overflow_total(diag).to(total.device))
        total.backward()
        reduce_gradients_(mesh, model.parameters(), 1.0 / mesh.data)
        metrics = mean_metrics(mesh, {k: v.detach()
                                      for k, v in metrics.items()})
        metrics["grad_norm"] = global_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        g_state.apply_gradients()
        ema_update(g_state.ema, model.named_parameters(), beta)
        return metrics

    def d_main_step(d_state: DTrainState, g_state: TrainState, batch,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            gen_out, _, _ = render_images(model, smpl, mesh, batch,
                                          noise_mode="none", train=True,
                                          generator=generator)
        real = batch.img * 2.0 - 1.0
        d_state.opt.zero_grad(set_to_none=True)
        loss, metrics = make_gan_losses(d_state.model)[1](
            gen_out, real, real, r1_gamma=tcfg.r1_gamma, do_r1=False)
        loss.backward()
        reduce_gradients_(mesh, d_state.model.parameters(), 1.0 / mesh.size)
        _step_d(d_state)
        return mean_metrics(mesh, metrics)

    def d_reg_step(d_state: DTrainState, batch) -> Dict[str, torch.Tensor]:
        real = batch.img * 2.0 - 1.0
        d_state.opt.zero_grad(set_to_none=True)
        r1 = r1_penalty(d_state.model, real, real)
        (r1 * (tcfg.r1_gamma / 2.0) * float(tcfg.d_reg_interval)).backward()
        reduce_gradients_(mesh, d_state.model.parameters(), 1.0 / mesh.size)
        _step_d(d_state)
        return mean_metrics(mesh, {"r1_penalty": r1.detach()})

    return g_step, d_main_step, d_reg_step


def make_gan_train_step(model, smpl, tcfg: TrainConfig,
                        lpips_fn: Optional[Callable] = None):
    """:func:`make_sharded_gan_steps` in one process (a one-rank mesh)."""
    return make_sharded_gan_steps(model, smpl, tcfg, Mesh(1, 1), lpips_fn)
