"""Generalization training (torch counterpart of the JAX package's
``tools/train_generalization.py``).

SHERF's claim is one-image generalizable human NeRF: trained across many
subjects, it renders a subject it never saw from a single observation
image.  This tool trains on ``subjects`` synthetic subjects
(``SyntheticDataset`` multi-person mode: a deterministic shape and
appearance per subject, a random pose and cameras per item) from the JAX
modules' initial weights (``init_weights_``, seed 0) and tracks the
masked PSNR of the non-EMA weights on a held-out subject under held-out
views (another subject id and another seed), and on seen subjects: a gain
on the held-out subject can only come from reading identity off the
observation image.

  python -m sherf_tpu_torch.tools.train_generalization [steps] [H] [D] ...

runs on the card (the positional arguments are ``main``'s, in order);
``main(..., device="cpu")`` runs on the CPU (use a small H and D there).
Progress goes to stderr; the last stdout line is one JSON object with the
JAX tool's keys: steps, H, D, subjects, heldout_sid, held_curve,
seen_curve, held_gain_db, max_overflow (the largest budget-overflow count
of any step), ms_per_step (the loop's wall time, evaluations included,
over the steps).  ``main`` returns the same dict.

The budgets are the JAX tool's (margin 1.5 over 8 training and the
held-out batches) with one more batch in the calibration: the training
item of the widest sample spacing, so that the fitted prune step margin
covers every item the run trains on.  Each training item is built in the
loop, as the JAX tool builds it (its time is in ``ms_per_step``); the
search for the widest one builds them once more before the loop and keeps
only their spacing.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from sherf_tpu_torch.core.calibrate import (calibrate_budgets,
                                            calibrate_sparse_caps)
from sherf_tpu_torch.core.config import ModelConfig, RenderConfig, TrainConfig
from sherf_tpu_torch.data.base import collate
from sherf_tpu_torch.data.synthetic import SyntheticDataset
from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
from sherf_tpu_torch.models.generator import SHERFGenerator, init_weights_
from sherf_tpu_torch.smpl import synthetic_smpl
from sherf_tpu_torch.cli.common import resolve_device
from sherf_tpu_torch.tools.train_convergence import LossWatch, masked_psnr
from sherf_tpu_torch.train import create_train_state, make_train_step


def main(steps=500, H=128, D=48, subjects=6, lr=2.5e-3, eval_every=50,
         heldout_sid=100, n_eval=4, device="cuda"):
    dev = resolve_device(device)
    smpl = synthetic_smpl(0, device=dev)
    train_ds = SyntheticDataset(smpl, H=H, W=H, size=1 << 30, seed=1,
                                subjects=subjects)
    # held-out subject, held-out views: another global subject id and
    # another camera / pose stream (seed)
    held_ds = SyntheticDataset(smpl, H=H, W=H, size=n_eval, seed=2,
                               subjects=1, subject_offset=heldout_sid)

    # the static voxel geometry covers every subject, train and held-out
    sids = list(range(subjects)) + [heldout_sid]
    t_verts_all = [train_ds.subject_canonical(s)[0] for s in sids]
    out_sh = tuple(int(max(prepare_voxel_volume(tv)[1][k]
                           for tv in t_verts_all)) for k in range(3))
    sparse_caps = calibrate_sparse_caps(t_verts_all, 0.005)
    print(f"out_sh {out_sh} sparse_caps {sparse_caps}", file=sys.stderr)

    cfg = ModelConfig(compute_dtype="bfloat16", sparse_caps=sparse_caps,
                      render=RenderConfig(depth_resolution=D,
                                          point_capacity_frac=1 / 16,
                                          ray_capacity_frac=0.5,
                                          exact_capacity_frac=1 / 32,
                                          density_noise=0.0))
    # the budgets cover the worst pose and view drawn in training:
    # calibrated over a spread of batches of both splits, extra margin.
    # The spread also takes the training item of the widest sample
    # spacing: ``calibrate_budgets`` fits the prune's step margin to the
    # largest spacing it sees, with no margin, and the spread's alone
    # leaves 24 of the 800 items of BASELINE's recipe stepping up to 4 mm
    # past it (step_overflow).  Training items are never the seen-eval
    # items: they start at n_eval + 1.
    first = n_eval + 1
    spacing = [float((it["far"] - it["near"]).max())
               for it in map(train_ds.__getitem__, range(first, first + steps))]
    widest = train_ds[first + int(np.argmax(spacing))]
    cal_batches = [collate([train_ds[i]], dev) for i in range(0, 24, 3)]
    cal_batches += [collate([widest], dev)]
    held_batches = [collate([held_ds[i]], dev) for i in range(n_eval)]
    fitted, worst = calibrate_budgets(cal_batches + held_batches, cfg,
                                      margin=1.5)
    print(f"budgets: {worst}", file=sys.stderr)
    cfg = dataclasses.replace(cfg, render=fitted)
    tcfg = TrainConfig(batch_size=1, lr=lr)
    del cal_batches

    t0 = time.perf_counter()
    model = SHERFGenerator(cfg, out_sh=out_sh, device=dev)
    init_weights_(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, tcfg)
    step = make_train_step(model, smpl, tcfg)
    seen_batches = [collate([train_ds[i]], dev) for i in range(0, 4)]

    def eval_psnr(batches):
        return float(np.mean([masked_psnr(model, smpl, b) for b in batches]))

    held_curve = [(0, eval_psnr(held_batches))]
    seen_curve = [(0, eval_psnr(seen_batches))]
    print(f"build+init: {time.perf_counter() - t0:.1f}s; start held-out "
          f"PSNR {held_curve[0][1]:.2f}", file=sys.stderr)

    gen = torch.Generator(dev).manual_seed(7)
    watch = LossWatch(dev)
    t0 = time.perf_counter()
    max_overflow = 0
    for i in range(1, steps + 1):
        metrics = step(state, collate([train_ds[first + i - 1]], dev), gen)
        watch.update(metrics)
        if i % eval_every == 0 or i == steps:
            loss = float(metrics["loss"])
            max_overflow = watch.check(i)
            hp, sp = eval_psnr(held_batches), eval_psnr(seen_batches)
            held_curve.append((i, hp))
            seen_curve.append((i, sp))
            print(f"step {i}: loss {loss:.4f} held-out {hp:.2f} dB "
                  f"seen {sp:.2f} dB overflow {max_overflow} "
                  f"({(time.perf_counter() - t0) / i * 1e3:.0f} ms/step)",
                  file=sys.stderr)

    res = {
        "steps": steps, "H": H, "D": D, "subjects": subjects,
        "heldout_sid": heldout_sid,
        "held_curve": [[int(s), round(p, 2)] for s, p in held_curve],
        "seen_curve": [[int(s), round(p, 2)] for s, p in seen_curve],
        "held_gain_db": round(held_curve[-1][1] - held_curve[0][1], 2),
        "max_overflow": max_overflow,
        "ms_per_step": round((time.perf_counter() - t0) / steps * 1e3, 1),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(*[int(x) for x in sys.argv[1:]])
