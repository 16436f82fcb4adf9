#!/usr/bin/env python3
"""Write the JPEG fixtures under tests/fixtures/jpeg/ and, beside each,
PIL's decode of it: as a PNG (``<name>.decoded.png``), or for the
1024x1024 one (ZJU-MoCap's native size, kept for its decode time) as the
SHA-256 of its bytes (``<name>.decoded.sha256``), to keep the fixtures
small.

The port's JPEG decoder (``sherf_tpu_torch/data/jpeg.py``) must reproduce
each stored decode bit for bit; ``chip_smoke.py`` checks that on machines
with no imaging package, ``tests/test_torch_image_io.py`` here.  Needs PIL
and cv2; run from the repository root:

    python tests/fixtures/make_jpeg_fixtures.py
"""

import hashlib
import os

import cv2
import numpy as np
from PIL import Image

OUT = os.path.join("tests", "fixtures", "jpeg")


def person(h, w, seed):
    """A figure on a black background: a shaded, textured ellipse body and
    head, as a loader's masked photo looks."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    body = ((xx - w / 2) / (w * 0.17)) ** 2 + ((yy - h * 0.6) / (h * 0.33)) ** 2
    head = ((xx - w / 2) / (w * 0.08)) ** 2 + ((yy - h * 0.19) / (h * 0.09)) ** 2
    inside = (body < 1) | (head < 1)
    shade = 0.55 + 0.45 * np.cos(xx / w * 7 + yy / h * 3)
    img = np.stack([200 * shade, 150 * shade + 40 * np.sin(yy / 9),
                    120 * shade + 30 * np.cos(xx / 5)], -1)
    img += rng.randn(h, w, 3) * 6
    img = np.clip(img, 0, 255) * inside[..., None]
    return img.astype(np.uint8)


def main():
    os.makedirs(OUT, exist_ok=True)
    cases = {
        "person_512_420.jpg": lambda p: Image.fromarray(person(512, 512, 0))
        .save(p, "JPEG", quality=90, subsampling=2),
        "person_1024_420.jpg": lambda p: Image.fromarray(
            person(1024, 1024, 5)).save(p, "JPEG", quality=85, subsampling=2),
        "person_37x53_422.jpg": lambda p: Image.fromarray(person(37, 53, 1))
        .save(p, "JPEG", quality=75, subsampling=1),
        "person_45x31_444_q50.jpg": lambda p: Image.fromarray(
            person(45, 31, 2)).save(p, "JPEG", quality=50, subsampling=0),
        "gray_40x30.jpg": lambda p: Image.fromarray(person(40, 30, 3)[..., 0])
        .save(p, "JPEG", quality=95),
        "restart_70x50_cv2.jpg": lambda p: cv2.imwrite(
            p, person(70, 50, 4)[..., ::-1],
            [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    }
    for name, write in cases.items():
        path = os.path.join(OUT, name)
        write(path)
        decoded = np.asarray(Image.open(path))
        if decoded.shape[0] > 512:
            with open(path[:-4] + ".decoded.sha256", "w") as f:
                f.write(hashlib.sha256(decoded.tobytes()).hexdigest() + "\n")
        else:
            Image.fromarray(decoded).save(path[:-4] + ".decoded.png",
                                          optimize=True)
        print(name, os.path.getsize(path))


if __name__ == "__main__":
    main()
