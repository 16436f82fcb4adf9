"""Pack an image folder into a training zip (torch counterpart of
``sherf_tpu/cli/dataset_tool.py``; reference dataset_tool.py).

Input: a directory tree (or zip) of PNG / JPEG / BMP images, optionally
with a ``dataset.json`` labels manifest.  Output: a flat zip of PNGs named
``imgNNNNNNNN.png`` plus ``dataset.json``, the format
``sherf_tpu_torch.data.image_folder.ImageFolderDataset`` reads.

  python -m sherf_tpu_torch.cli.dataset_tool --source photos/ \\
      --dest data.zip --resolution 256x256 --transform center-crop

Transforms as in the JAX tool: ``--resolution WxH`` with ``--transform
{copy,center-crop,center-crop-wide}``.  Images are resized as
``cv2.resize(..., interpolation=cv2.INTER_AREA)`` resizes uint8 images (the
port's area resize when both axes shrink, cv2's fixed-point linear pass
with area coefficients when either grows) and written by the port's PNG
writer, so the zip's bytes differ from the JAX tool's while its names,
labels and pixels match.
"""

from __future__ import annotations

import argparse
import json
import os
import zipfile

import numpy as np

from sherf_tpu_torch.data.imgproc import resize_area
from sherf_tpu_torch.eval.png import png_bytes


_COEF_SCALE = 2048      # cv2's INTER_RESIZE_COEF_SCALE (11 fraction bits)


def _area_linear_coeffs(n: int, m: int):
    """cv2's linear-resize taps for ``n`` source samples -> ``m`` in area
    mode: source index ``s`` of each output, its two weights as cv2's
    fixed-point shorts, and the first output whose right tap would fall
    off the source (from there on the sample is copied)."""
    inv = m / n
    d = np.arange(m)
    s = np.floor(d * (1.0 / inv)).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    off = s + 1 >= n
    edge = int(np.argmax(off)) if off.any() else m
    f[s >= n - 1] = 0
    s = np.minimum(s, n - 1)
    w = np.stack([(np.float32(1) - f) * np.float32(_COEF_SCALE),
                  f * np.float32(_COEF_SCALE)], -1)
    return s, np.rint(w).astype(np.int64), edge


def _enlarge_area_u8(img: np.ndarray, size) -> np.ndarray:
    """What ``cv2.INTER_AREA`` does to a uint8 image when either axis
    grows: a linear resize whose taps are the area-mode coefficients of
    ``_area_linear_coeffs``.  The horizontal pass is exact integer
    arithmetic; the vertical pass rounds as cv2's vector code does:
    ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16)``, then ``+2 >> 2``."""
    h, w = img.shape[:2]
    W, H = size
    src = img.reshape(h, w, -1).astype(np.int64)
    sx, ax, edge = _area_linear_coeffs(w, W)
    sy, by, _ = _area_linear_coeffs(h, H)
    rows = (src[:, sx] * ax[None, :, 0, None]
            + src[:, np.minimum(sx + 1, w - 1)] * ax[None, :, 1, None])
    rows[:, edge:] = src[:, sx[edge:]] * _COEF_SCALE
    r0, r1 = rows[sy], rows[np.minimum(sy + 1, h - 1)]
    b0, b1 = by[:, 0, None, None], by[:, 1, None, None]
    out = (((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8).reshape(
        (H, W) + img.shape[2:])


def resize_area_u8(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for a uint8
    (H, W, C) image resized to ``size = (width, height)``.  Shrinking both
    axes: the area average in float, rounded half to even as cv2 rounds,
    but half up at an exact 2x2 shrink, where cv2 takes ``(a + b + c + d +
    2) >> 2``.  Growing either axis: :func:`_enlarge_area_u8`.  A
    one-channel image keeps its channel axis (cv2 drops it)."""
    if size[0] > img.shape[1] or size[1] > img.shape[0]:
        return _enlarge_area_u8(img, size)
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
