"""Debug: project the SMPL vertices onto the observation image to check the
camera / SMPL alignment (torch counterpart of
``sherf_tpu/cli/debug_project.py``; the reference's render_hfz.py
pattern).  Each vertex that lands in the frame paints its pixel red.

  python -m sherf_tpu_torch.cli.debug_project --out proj.png            (synthetic)
  python -m sherf_tpu_torch.cli.debug_project --cfg humman \\
      --data /data/humman/p000455_a000986 --index 0 --out proj.png
  (add --device cpu to run on the CPU)

The synthetic item's body is posed on ``--device``; a loader item's on the
host, as the loaders do.  The projection itself is host numpy.
"""

from __future__ import annotations

import argparse

import numpy as np

from sherf_tpu_torch.cli.common import resolve_device, resolve_smpl
from sherf_tpu_torch.eval.png import write_png


def project_vertices(img, verts, K, R, T):
    """``img`` (H, W, 3) float with every vertex that projects into it
    painted red, as uint8; and the number of those vertices."""
    img = np.array(img)
    cam = verts @ R.T + T.reshape(3)
    pix = cam @ K.T
    xy = (pix[:, :2] / np.maximum(pix[:, 2:], 1e-5)).astype(int)
    H, W = img.shape[:2]
    ok = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
    img[xy[ok, 1], xy[ok, 0]] = np.array([1.0, 0.0, 0.0])
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), int(ok.sum())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", default=None,
                   choices=[None, "renderpeople", "thuman", "humman", "zju"])
    p.add_argument("--data", default=None, help="subject dir (else synthetic)")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", default="debug_projection.png")
    p.add_argument("--smpl_model", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when 'cpu' is passed")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    smpl = resolve_smpl(a.smpl_model, device)

    if a.data and a.cfg:
        from sherf_tpu_torch.data import DATASETS

        ds = DATASETS[a.cfg](a.data, smpl, split="test", multi_person=False,
                             num_instance=1, poses_num=1)
        item = ds[a.index]
        img = item["obs_img"]
        verts, K, R, T = (np.asarray(item[k]) for k in (
            "obs_vertices", "obs_K", "obs_R", "obs_T"))
    else:
        from sherf_tpu_torch.data.synthetic import make_synthetic_batch

        batch = make_synthetic_batch(smpl, batch_size=1, H=256, W=256, seed=0,
                                     device=device)
        img, verts, K, R, T = (t[0].cpu().numpy() for t in (
            batch.obs_img, batch.obs_vertices, batch.obs_K, batch.obs_R,
            batch.obs_T))

    out, n_in = project_vertices(img, verts, K, R, T)
    write_png(a.out, out)
    print(f"projected {n_in}/{len(verts)} vertices in frame -> {a.out}")
    return {"image": out, "in_frame": n_in}


if __name__ == "__main__":
    main()
