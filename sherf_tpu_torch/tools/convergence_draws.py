"""``train_convergence`` at its defaults over several initial draws: how
often the recipe's density head collapses (every density clamped to 0, the
loss frozen, PSNR at the background's) on this device.

  python -m sherf_tpu_torch.tools.convergence_draws [--lr LR] [seed ...]

runs ``train_convergence.main(lr=LR, seed=seed)`` (default lr: the tool's
2.5e-3) once per seed given (default ``0 0 1 2 3 4 5``: a seed twice shows
the run-to-run spread of one draw, which nondeterministic CUDA atomics
give), the initial weights drawn by ``init_weights_`` from that seed; one
JSON line a run (start, end and peak masked PSNR, the curve, seconds),
then the tool's own lines.  Card only (``device`` as in the tool).
"""

from __future__ import annotations

import argparse
import json
import time

from sherf_tpu_torch.tools import train_convergence


def main(seeds=(0, 0, 1, 2, 3, 4, 5), lr=2.5e-3, device="cuda"):
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = train_convergence.main(lr=lr, device=device, seed=seed)
        curve = res["psnr_curve"]
        out.append({"seed": seed, "lr": lr, "start": res["start_psnr"],
                    "end": res["end_psnr"],
                    "peak": max(p for _, p in curve), "curve": curve,
                    "seconds": round(time.perf_counter() - t0, 1)})
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, default=2.5e-3)
    p.add_argument("seeds", type=int, nargs="*", default=[0, 0, 1, 2, 3, 4, 5])
    a = p.parse_args()
    main(a.seeds, a.lr)
