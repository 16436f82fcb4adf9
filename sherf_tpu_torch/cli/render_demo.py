"""Render one synthetic frame end to end and write a PNG of rgb | depth |
acc: the quickest way to see the whole stack run (torch counterpart of
``sherf_tpu/cli/render_demo.py``).

  python -m sherf_tpu_torch.cli.render_demo --out demo.png --size 512
  (add --device cpu to run on the CPU)

``--resume`` renders a port checkpoint's EMA weights; without it the
weights are drawn from seed 0.  The budget-overflow counters are
printed with the frame.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sherf_tpu_torch.cli.common import (
    build_model, generator_weights, render_cli_config, resolve_device,
    resolve_smpl)
from sherf_tpu_torch.core.diag import overflow_report
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.eval.png import write_png


def demo_panel(out) -> np.ndarray:
    """The generator's outputs for item 0 -> the (H, 3W, 3) uint8 panel
    rgb | depth (min-max normalised) | acc."""
    img = out["image_raw"][0].float().cpu().numpy() / 2.0 + 0.5
    depth = out["image_depth"][0].float().cpu().numpy()
    acc = out["weights_image"][0].float().cpu().numpy()
    dn = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-6)
    panel = np.concatenate([
        np.clip(img, 0, 1),
        np.repeat(dn[..., None], 3, -1),
        np.repeat(np.clip(acc, 0, 1)[..., None], 3, -1),
    ], axis=1)
    return (panel * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="demo.png")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--resume", default=None,
                   help="a port checkpoint (else random weights)")
    p.add_argument("--smpl_model", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when 'cpu' is passed")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    smpl = resolve_smpl(a.smpl_model, device)
    model, _, _ = build_model(render_cli_config(a.depth), smpl, device=device)
    generator_weights(model, a.resume).eval()
    batch = make_synthetic_batch(smpl, batch_size=1, H=a.size, W=a.size,
                                 seed=0, device=device)

    t0 = time.perf_counter()
    with torch.inference_mode():
        out, diag = model(batch, smpl)
    panel = demo_panel(out)
    overflow = overflow_report(diag)
    acc = out["weights_image"][0]
    print(f"rendered {a.size}x{a.size} in {time.perf_counter() - t0:.1f}s; "
          f"acc range [{float(acc.min()):.3f}, {float(acc.max()):.3f}]; "
          f"overflow {overflow}")
    write_png(a.out, panel)
    print(f"wrote {a.out} (rgb | depth | acc)")
    return {"panel": panel, "overflow": overflow}


if __name__ == "__main__":
    main()
