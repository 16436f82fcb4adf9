"""Evaluate a trained model: the novel-view and novel-pose protocols with
PSNR / SSIM (torch counterpart of ``sherf_tpu/cli/eval.py``; reference
eval_*.sh -> train.py --test_flag True -> test_loop.test).

  python -m sherf_tpu_torch.cli.eval --cfg synthetic_grid --data subject100 \\
      --subjects subject100 --resume runs/grid/checkpoints/snapshot-003000.pt \\
      --calibrate_budgets true --calibrate_margin 1.5
  (add --device cpu to run on the CPU)

Restores a checkpoint written by the port (``train/checkpoint.py``) and
renders with its EMA weights unless ``--use_ema false``.  An eval whose
budgets overflow raises: a truncated render would poison the metrics.
"""

from __future__ import annotations

import argparse
import os

import torch

from sherf_tpu_torch.cli.common import (
    add_model_flags, build_model, calibrated_config, model_config_from_args,
    resolve_device, resolve_smpl)
from sherf_tpu_torch.core.config import EVAL_DEFAULTS, EVAL_SUBJECTS, TrainConfig
from sherf_tpu_torch.core.diag import overflow_report
from sherf_tpu_torch.data import DATASETS, collate
from sherf_tpu_torch.train.checkpoint import restore_checkpoint
from sherf_tpu_torch.train.train_state import create_train_state


class _Reiterable:
    """An iterable whose every pass calls ``make_iter`` anew."""

    def __init__(self, make_iter):
        self.make_iter = make_iter

    def __iter__(self):
        return self.make_iter()


def calibration_sweep(make_dataset, subjects, proto, device,
                      view_stride: int = 2):
    """The budget calibration batches: every pose of the protocol range of
    each eval subject, at every view the protocols render (every
    ``view_stride``-th).  Budgets fitted to one frame, or to the
    observation views only, overflowed at eval time; so did the JAX CLI's
    sweep of every ``max(2, views // 6)``-th view on a 36-view RenderPeople
    subject: the fitted step margin bounds only the swept views' sample
    spacing.  A re-iterable: each pass builds and collates one batch at a
    time, so the sweep never holds more than one batch."""
    def batches():
        for root in subjects:
            ds = make_dataset(root, proto["np_pose_start"],
                              proto["pose_interval"], proto["pose_num"])
            for pose in range(proto["pose_num"]):
                for v in range(0, ds.camera_view_num, view_stride):
                    idx = pose * ds.camera_view_num + int(v)
                    if idx < len(ds):
                        yield collate([ds[idx]], device)
    return _Reiterable(batches)


def load_weights(model, path: str, use_ema: bool = True):
    """Restore a port checkpoint into ``model``; with ``use_ema`` its
    parameters become the checkpoint's EMA."""
    state = restore_checkpoint(path, create_train_state(model, TrainConfig()))
    if use_ema:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state.ema[name])
    return state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True,
                   choices=["renderpeople", "thuman", "humman", "zju",
                            "synthetic_grid"])
    p.add_argument("--data", required=True,
                   help="a subject dir; siblings + human_list.txt define the "
                   "split (synthetic_grid: 'subject<id>', no files needed)")
    p.add_argument("--resume", required=True, help="checkpoint path")
    p.add_argument("--outdir", default="eval_out")
    p.add_argument("--subjects", nargs="*", default=None,
                   help="override eval subject dirs")
    p.add_argument("--use_ema", type=lambda s: s.lower() == "true", default=True)
    p.add_argument("--obs_pose_mode", choices=["reference", "first"],
                   default="reference",
                   help="novel-pose observation indexing: 'reference' "
                   "replicates test_loop.py:267's re-based obs_pose_index "
                   "quirk for metric parity; 'first' pins the observation "
                   "to the np_pose_start pose itself")
    add_model_flags(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    proto = EVAL_DEFAULTS[a.cfg]
    scaling = (1 / 3 if a.cfg == "humman"
               else a.neural_rendering_resolution_initial /
               (1024 if a.cfg == "zju" else 512))
    smpl = resolve_smpl(a.smpl_model, device)

    def make_dataset(root, poses_start, poses_interval, poses_num):
        return DATASETS[a.cfg](root, smpl, split="test", multi_person=False,
                               num_instance=1, poses_start=poses_start,
                               poses_interval=poses_interval,
                               poses_num=poses_num, image_scaling=scaling,
                               white_back=a.white_back, sample_obs_view=False,
                               fix_obs_view=True)

    # a loader whose files are missing raises here, before the checkpoint
    # is read
    probe = make_dataset(a.data, proto["nv_pose_start"],
                         proto["pose_interval"], 1)

    # eval subjects (test_loop.py:102-151), or an explicit list
    humans_root = os.path.dirname(a.data)
    if a.subjects:
        subjects = a.subjects
    else:
        ranges = {"renderpeople": (450, 480), "thuman": (90, 100)}
        if a.cfg in ranges:
            lo, hi = ranges[a.cfg]
            with open(os.path.join(humans_root, "human_list.txt")) as f:
                subjects = [os.path.join(humans_root, x.strip())
                            for x in f.readlines()[lo:hi]]
        else:
            # the reference's hardcoded lists (test_loop.py:112-151)
            subjects = [os.path.join(humans_root, n)
                        for n in EVAL_SUBJECTS[a.cfg]]

    cfg = model_config_from_args(a)
    data_interval = 1 if a.cfg == "humman" else 2
    if a.calibrate_budgets:
        batches = (calibration_sweep(make_dataset, subjects, proto, device,
                                     view_stride=data_interval)
                   if subjects else [collate([probe[0]], device)])
        cfg = calibrated_config(cfg, batches, margin=a.calibrate_margin)
    model, _, cfg = build_model(cfg, smpl, device=device)
    load_weights(model, a.resume, use_ema=a.use_ema)
    model.eval()

    @torch.inference_mode()
    def fwd(batch):
        out, diag = model(batch, smpl)
        # fail loud if a static budget truncated body samples: a silently
        # corrupted render would poison the metric tables
        overflow = overflow_report(diag)
        if any(v > 0 for v in overflow.values()):
            raise RuntimeError(
                f"capacity budget overflow during eval: {overflow}; re-run "
                "with --calibrate_budgets / --calibrate_margin or larger "
                "capacity fracs")
        return out

    from sherf_tpu_torch.eval.test_loop import run_eval

    results = run_eval(
        fwd, make_dataset, subjects, list(proto["obs_views"]), a.outdir,
        nv_pose_start=proto["nv_pose_start"],
        np_pose_start=proto["np_pose_start"],
        pose_interval=proto["pose_interval"], pose_num=proto["pose_num"],
        data_interval=data_interval,
        obs_pose_mode=a.obs_pose_mode, device=device)
    print(results)
    return results


if __name__ == "__main__":
    main()
