"""Training convergence on the synthetic scene (torch counterpart of the
JAX package's ``tools/train_convergence.py``).

Overfits one synthetic batch for a few hundred steps at a production-like
configuration (bf16, budgeted, calibrated at margin 1.3) from the JAX
modules' initial weights (``init_weights_``, seed ``seed``, 0 by default)
and records the masked-PSNR curve of the non-EMA weights: the evidence
that the gradients through the compactions, the structured adjoints and
the bf16 banks train.

  python -m sherf_tpu_torch.tools.train_convergence [steps] [H] [D]

runs on the card; ``main(..., device="cpu")`` runs on the CPU (use a small
H and D there).  Progress goes to stderr; the last stdout line is one JSON
object with the JAX tool's keys: steps, H, D, psnr_curve, start_psnr,
end_psnr, final_loss, ms_per_step (the loop's wall time, evaluations
included, over the steps).  ``main`` returns the same dict with one more
key, ``max_overflow`` (the largest budget-overflow count of any step); it
raises if any step's loss is not finite.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from sherf_tpu_torch.cli.common import resolve_device
from sherf_tpu_torch.core.calibrate import calibrate_budgets
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig, TrainConfig
from sherf_tpu_torch.data.base import host_smpl_verts
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.eval.metrics import psnr_np
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator, init_weights_
from sherf_tpu_torch.smpl import big_pose_params, synthetic_smpl
from sherf_tpu_torch.train import create_train_state, make_train_step


@torch.no_grad()
def masked_psnr(model, smpl, batch) -> float:
    """Masked PSNR (``psnr_np``) of item 0's ``image_raw`` (eval-mode
    forward of the model's current weights) against its target."""
    H, W = batch.img.shape[1:3]
    out, _ = model(batch, smpl)
    pred = out["image_raw"][0].float().cpu().numpy() / 2.0 + 0.5
    gt = batch.img[0].float().cpu().numpy()
    mask = batch.mask_at_box[0].reshape(H, W).cpu().numpy().astype(bool)
    return psnr_np(pred, gt, mask)


class LossWatch:
    """Every step's loss finiteness and overflow, kept on the device (no
    host sync a step) and read at the evaluations."""

    def __init__(self, device):
        self.finite = torch.ones((), dtype=torch.bool, device=device)
        self.overflow = torch.zeros((), dtype=torch.int64, device=device)

    def update(self, metrics):
        self.finite &= torch.isfinite(metrics["loss"]).all()
        self.overflow = torch.maximum(self.overflow,
                                      metrics["overflow"].to(torch.int64))

    def check(self, step: int) -> int:
        """Raises if a loss up to ``step`` was not finite; returns the
        largest overflow so far."""
        if not bool(self.finite):
            raise FloatingPointError(f"loss diverged (non-finite at or "
                                     f"before step {step})")
        return int(self.overflow)


def main(steps=300, H=256, D=48, lr=2.5e-3, eval_every=25, device="cuda",
         seed=0):
    dev = resolve_device(device)
    smpl = synthetic_smpl(0, device=dev)
    bp = big_pose_params()
    t_verts = host_smpl_verts(smpl, bp["poses"], bp["shapes"])[0]
    _, out_sh = prepare_voxel_volume(t_verts)
    cfg = ModelConfig(compute_dtype="bfloat16", render=RenderConfig(
        depth_resolution=D, point_capacity_frac=1 / 16,
        ray_capacity_frac=0.375, exact_capacity_frac=1 / 48,
        density_noise=0.0))
    batch = make_synthetic_batch(smpl, batch_size=1, H=H, W=H, seed=0,
                                 device=dev)
    fitted, worst = calibrate_budgets([batch], cfg, margin=1.3)
    print(f"budgets: {worst}", file=sys.stderr)
    cfg = dataclasses.replace(cfg, render=fitted)
    tcfg = TrainConfig(batch_size=1, lr=lr)

    t0 = time.perf_counter()
    model = SHERFGenerator(cfg, out_sh=out_sh, device=dev)
    init_weights_(model, torch.Generator().manual_seed(seed))
    state = create_train_state(model, tcfg)
    step = make_train_step(model, smpl, tcfg)
    curve = [(0, masked_psnr(model, smpl, batch))]
    print(f"build+init: {time.perf_counter() - t0:.1f}s; start PSNR "
          f"{curve[0][1]:.2f}", file=sys.stderr)

    gen = torch.Generator(dev).manual_seed(7)
    watch = LossWatch(dev)
    t0 = time.perf_counter()
    losses, max_overflow = [], 0
    for i in range(1, steps + 1):
        metrics = step(state, batch, gen)
        watch.update(metrics)
        if i % eval_every == 0 or i == steps:
            loss = float(metrics["loss"])
            max_overflow = watch.check(i)
            losses.append(loss)
            p = masked_psnr(model, smpl, batch)
            curve.append((i, p))
            print(f"step {i}: loss {loss:.4f} psnr {p:.2f} "
                  f"({(time.perf_counter() - t0) / i * 1e3:.0f} ms/step)",
                  file=sys.stderr)

    res = {
        "steps": steps, "H": H, "D": D,
        "psnr_curve": [[int(s), round(p, 2)] for s, p in curve],
        "start_psnr": round(curve[0][1], 2),
        "end_psnr": round(curve[-1][1], 2),
        "final_loss": losses[-1] if losses else None,
        "ms_per_step": round((time.perf_counter() - t0) / steps * 1e3, 1),
    }
    print(json.dumps(res), flush=True)
    return {**res, "max_overflow": max_overflow}


if __name__ == "__main__":
    main(*[int(x) for x in sys.argv[1:]])
