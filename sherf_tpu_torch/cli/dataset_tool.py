"""Pack an image folder into a training zip (torch counterpart of
``sherf_tpu/cli/dataset_tool.py``; reference dataset_tool.py).

Input: a directory tree (or zip) of PNG / JPEG / BMP images, optionally
with a ``dataset.json`` labels manifest.  Output: a flat zip of PNGs named
``imgNNNNNNNN.png`` plus ``dataset.json``, the format
``sherf_tpu_torch.data.image_folder.ImageFolderDataset`` reads.

  python -m sherf_tpu_torch.cli.dataset_tool --source photos/ \\
      --dest data.zip --resolution 256x256 --transform center-crop

Transforms as in the JAX tool: ``--resolution WxH`` with ``--transform
{copy,center-crop,center-crop-wide}``.  Images are resized with the port's
area resize (``cv2.INTER_AREA``'s arithmetic, rounded as cv2 rounds uint8;
shrinking only) and written by the port's PNG writer, so the zip's bytes
differ from the JAX tool's while its names, labels and pixels match.
"""

from __future__ import annotations

import argparse
import json
import os
import zipfile

import numpy as np

from sherf_tpu_torch.data.imgproc import resize_area
from sherf_tpu_torch.eval.png import png_bytes


def resize_area_u8(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for a uint8
    (H, W, C) image shrunk to ``size = (width, height)``: the area average
    in float, rounded half to even as cv2 rounds, but half up at an exact
    2x2 shrink, where cv2 takes ``(a + b + c + d + 2) >> 2``.  A one-channel
    image keeps its channel axis (cv2 drops it)."""
    if size[0] > img.shape[1] or size[1] > img.shape[0]:
        raise ValueError(f"a {img.shape[1]}x{img.shape[0]} crop cannot be "
                         f"resized to {size[0]}x{size[1]}: the area resize "
                         f"only shrinks")
    out = resize_area(img.astype(np.float32), size)
    if img.shape[0] == 2 * out.shape[0] and img.shape[1] == 2 * out.shape[1]:
        out = np.floor(out + 0.5)
    else:
        out = np.rint(out)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        out.shape[:2] + img.shape[2:])


def transform_image(img: np.ndarray, transform: str, width: int,
                    height: int) -> np.ndarray:
    if transform == "copy":
        return img
    h, w = img.shape[:2]
    if transform == "center-crop":
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        return resize_area_u8(img[y0:y0 + s, x0:x0 + s], (width, height))
    if transform == "center-crop-wide":
        # crop to the target aspect ratio, then resize
        target_ar = width / height
        if w / h > target_ar:
            nw = int(round(h * target_ar))
            x0 = (w - nw) // 2
            img = img[:, x0:x0 + nw]
        else:
            nh = int(round(w / target_ar))
            y0 = (h - nh) // 2
            img = img[y0:y0 + nh]
        return resize_area_u8(img, (width, height))
    raise ValueError(f"unknown transform {transform!r}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True, help="input dir or zip")
    p.add_argument("--dest", required=True, help="output .zip")
    p.add_argument("--resolution", default=None,
                   help="WxH, e.g. 512x512 (default: keep)")
    p.add_argument("--transform", default="center-crop",
                   choices=["copy", "center-crop", "center-crop-wide"])
    p.add_argument("--max_images", type=int, default=None)
    a = p.parse_args(argv)

    from sherf_tpu_torch.data.image_folder import ImageFolderDataset

    src = ImageFolderDataset(a.source, use_labels=True)
    width = height = None
    if a.resolution:
        width, height = (int(x) for x in a.resolution.lower().split("x"))

    n = len(src) if a.max_images is None else min(len(src), a.max_images)
    labels = []
    os.makedirs(os.path.dirname(os.path.abspath(a.dest)), exist_ok=True)
    try:
        with zipfile.ZipFile(a.dest, "w", zipfile.ZIP_STORED) as zf:
            for i in range(n):
                img, label = src[i]
                if width is not None:
                    img = transform_image(img, a.transform, width, height)
                name = f"img{i:08d}.png"
                zf.writestr(name, png_bytes(img))
                if label.size:
                    labels.append([name, label.tolist()])
            zf.writestr("dataset.json", json.dumps({"labels": labels or None}))
    finally:
        src.close()
    print(f"wrote {n} images -> {a.dest}")


if __name__ == "__main__":
    main()
