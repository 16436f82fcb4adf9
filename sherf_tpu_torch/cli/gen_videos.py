"""Free-viewpoint orbit video around a SHERF subject (torch counterpart of
``sherf_tpu/cli/gen_videos.py``): fix the observation image, orbit the
target camera around the body, render each frame.

  python -m sherf_tpu_torch.cli.gen_videos --out orbit.gif --frames 30 \\
      --size 512 --depth 48 [--resume snapshot-NNNNNN.pt]
  (add --device cpu to run on the CPU)

Frames are written as an animated GIF (``eval/gif.py``).  The port has no
mp4 writer: for any other extension it writes ``<stem>.gif`` and says
"mp4 writer unavailable", which is the JAX CLI's fallback when imageio
cannot write mp4.  Each frame's budget-overflow counters are printed; as
in the JAX CLI, an overflow does not stop the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from sherf_tpu_torch.cli.common import (
    build_model, generator_weights, render_cli_config, resolve_device,
    resolve_smpl)
from sherf_tpu_torch.core.diag import overflow_report
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.eval.gif import write_gif
from sherf_tpu_torch.geometry.rays import get_rays_np, near_far_aabb_np


def _orbit_camera(H, W, theta, distance=3.0, height=0.0, focal_scale=0.9):
    """World -> camera K, R, T of a camera on a horizontal circle around
    the origin, looking at it."""
    cam_pos = np.array([distance * np.sin(theta), height,
                        distance * np.cos(theta)], np.float32)
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.array([0, 1, 0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd]).astype(np.float32)
    T = (-R @ cam_pos).reshape(3, 1).astype(np.float32)
    f = focal_scale * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return K, R, T


def orbit_batch(base, i: int, frames: int, size: int):
    """``base`` with the rays of orbit frame ``i`` of ``frames``: near / far
    from the posed body's box; the other fields (mask_at_box too) stay the
    base camera's, as in the JAX CLI."""
    verts = base.vertices[0].cpu().numpy()
    wb = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
    K, R, T = _orbit_camera(size, size, 2 * np.pi * i / frames)
    ro, rd = get_rays_np(size, size, K, R, T)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    near, far, _ = near_far_aabb_np(wb, ro, rd)
    dev = base.ray_o.device
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))[None].to(dev)
    return dataclasses.replace(base, ray_o=t(ro), ray_d=t(rd), near=t(near),
                               far=t(far))


def to_frame(image_raw) -> np.ndarray:
    """(H, W, 3) image_raw in [-1, 1] -> uint8, as the JAX CLI writes it."""
    img = image_raw.float().cpu().numpy() / 2 + 0.5
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="orbit.mp4")
    p.add_argument("--frames", type=int, default=30)
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
    base = make_synthetic_batch(smpl, batch_size=1, H=a.size, W=a.size,
                                seed=0, device=device)

    frames, overflow = [], []
    for i in range(a.frames):
        batch = orbit_batch(base, i, a.frames, a.size)
        with torch.inference_mode():
            out, diag = model(batch, smpl)
        frames.append(to_frame(out["image_raw"][0]))
        overflow.append(overflow_report(diag))
        print(f"frame {i + 1}/{a.frames} overflow {overflow[-1]}")

    path = a.out
    if os.path.splitext(a.out)[1].lower() != ".gif":
        path = os.path.splitext(a.out)[0] + ".gif"
    write_gif(path, frames, fps=10)
    if path != a.out:
        print(f"mp4 writer unavailable; wrote {path}")
    else:
        print(f"wrote {path}")
    return {"path": path, "frames": frames, "overflow": overflow}


if __name__ == "__main__":
    main()
