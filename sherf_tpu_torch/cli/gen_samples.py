"""Render still samples and, with ``--shapes``, export the canonical shape
(torch counterpart of ``sherf_tpu/cli/gen_samples.py``): the canonical
density field sampled on a grid over the canonical bounds (a ``.mrc``
volume) and its iso-surface mesh (a ``.ply``, ``geometry/shape.py``).

  python -m sherf_tpu_torch.cli.gen_samples --outdir samples --seeds 0 1 \\
      --size 512 --depth 48 --shapes --shape_res 128 [--resume snapshot.pt]
  (add --device cpu to run on the CPU)

Each frame's and each grid chunk's budget-overflow counters are printed;
as in the JAX CLI, an overflow does not stop the run.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from sherf_tpu_torch.cli.common import (
    build_model, generator_weights, render_cli_config, resolve_device,
    resolve_smpl)
from sherf_tpu_torch.cli.gen_videos import to_frame
from sherf_tpu_torch.core.diag import overflow_report
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.eval.png import write_png
from sherf_tpu_torch.geometry.shape import convert_sdf_samples_to_ply, write_mrc


def sample_density_grid(model, batch, smpl, res: int, chunk: int = 65536):
    """The canonical density on a res^3 grid over item 0's canonical bounds
    (``query_canonical`` on chunks of ``chunk`` points, the last one
    zero-padded).  Returns ((res, res, res) float32 sigma, [overflow report
    of each chunk])."""
    lo = batch.t_bounds[0, 0].cpu().numpy()
    hi = batch.t_bounds[0, 1].cpu().numpy()
    axes = [np.linspace(lo[i], hi[i], res, dtype=np.float32) for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pad = (-len(grid)) % chunk
    grid_p = torch.from_numpy(np.pad(grid, ((0, pad), (0, 0))))
    dev = batch.t_bounds.device
    sigma, overflow = [], []
    for c in grid_p.reshape(-1, chunk, 3):
        with torch.inference_mode():
            out, diag = model.query_canonical(batch, smpl, c[None].to(dev))
        sigma.append(out["sigma"][0, :, 0].float().cpu().numpy())
        overflow.append(overflow_report(diag))
    return (np.concatenate(sigma)[:len(grid)].reshape(res, res, res),
            overflow)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--outdir", default="samples")
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--shapes", action="store_true",
                   help="also export the canonical density field")
    p.add_argument("--shape_res", type=int, default=64)
    p.add_argument("--shape_level", type=float, default=10.0,
                   help="density iso-level for the extracted mesh")
    p.add_argument("--resume", default=None,
                   help="a port checkpoint (else random weights)")
    p.add_argument("--smpl_model", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when 'cpu' is passed")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    os.makedirs(a.outdir, exist_ok=True)
    smpl = resolve_smpl(a.smpl_model, device)
    model, _, _ = build_model(render_cli_config(a.depth), smpl, device=device)
    generator_weights(model, a.resume).eval()

    result = {}
    for seed in a.seeds:
        batch = make_synthetic_batch(smpl, batch_size=1, H=a.size, W=a.size,
                                     seed=seed, device=device)
        with torch.inference_mode():
            out, diag = model(batch, smpl)
        out_png = os.path.join(a.outdir, f"seed{seed:04d}.png")
        write_png(out_png, to_frame(out["image_raw"][0]))
        res = {"overflow": overflow_report(diag)}
        print(f"wrote {out_png} overflow {res['overflow']}")

        if a.shapes:
            t0 = time.perf_counter()
            sigma, res["chunk_overflow"] = sample_density_grid(
                model, batch, smpl, a.shape_res)
            for i, ov in enumerate(res["chunk_overflow"]):
                print(f"chunk {i + 1}/{len(res['chunk_overflow'])} "
                      f"overflow {ov}")
            res["grid_s"] = time.perf_counter() - t0
            lo = batch.t_bounds[0, 0].cpu().numpy()
            hi = batch.t_bounds[0, 1].cpu().numpy()
            voxel = float((hi - lo).max()) / (a.shape_res - 1)
            write_mrc(os.path.join(a.outdir, f"seed{seed:04d}.mrc"), sigma,
                      voxel_size=voxel)
            t0 = time.perf_counter()
            convert_sdf_samples_to_ply(
                sigma, lo, voxel,
                os.path.join(a.outdir, f"seed{seed:04d}.ply"),
                level=a.shape_level)
            res["mesh_s"] = time.perf_counter() - t0
            print("wrote canonical density .mrc + iso-surface .ply")
        result[seed] = res
    return result


if __name__ == "__main__":
    main()
