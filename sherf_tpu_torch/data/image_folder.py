"""The generic image-folder / zip dataset, EG3D's ``--cfg`` fallback
(torch counterpart of ``sherf_tpu/data/image_folder.py``; reference
``training/dataset.py`` ImageFolderDataset).  Reads a directory tree or a
``.zip`` written by ``sherf_tpu_torch.cli.dataset_tool``; labels come from
a ``dataset.json`` holding ``{"labels": [[fname, label], ...]}``.

Images are decoded by the port's own readers (``data/jpeg.py``,
``data/png_read.py``, ``data/bmp.py``: no imaging package) and returned
(H, W, C) uint8 with C <= 3, as the JAX dataset returns them.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Optional, Tuple

import numpy as np

from sherf_tpu_torch.data.base import decode_image

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


class ImageFolderDataset:
    def __init__(self, path: str, resolution: Optional[int] = None,
                 use_labels: bool = False, max_size: Optional[int] = None,
                 xflip: bool = False, random_seed: int = 0):
        self.path = path
        self.use_labels = use_labels
        self._zip = None
        if os.path.isdir(path):
            self._files = sorted(
                os.path.relpath(os.path.join(r, f), path).replace(os.sep, "/")
                for r, _, fs in os.walk(path) for f in fs
                if f.lower().endswith(_IMG_EXTS))
        elif path.lower().endswith(".zip"):
            self._zip = zipfile.ZipFile(path)
            self._files = sorted(n for n in self._zip.namelist()
                                 if n.lower().endswith(_IMG_EXTS))
        else:
            raise IOError(f"{path}: not a directory or zip")
        if not self._files:
            raise IOError(f"{path}: no image files found")

        self._labels = None
        if use_labels:
            raw = self._read("dataset.json")
            if raw is not None:
                table = dict(json.loads(raw.decode())["labels"] or [])
                self._labels = [table.get(f, 0) for f in self._files]

        self._raw_idx = np.arange(len(self._files), dtype=np.int64)
        if max_size is not None and len(self._raw_idx) > max_size:
            rng = np.random.RandomState(random_seed)
            self._raw_idx = np.sort(rng.choice(self._raw_idx, max_size,
                                               replace=False))
        self._xflip = np.zeros(len(self._raw_idx), np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate(
                [self._xflip, np.ones_like(self._xflip)])

        img = self._load_image(0)
        # non-square images are allowed (the reference asserts square)
        self.resolution = resolution or img.shape[0]
        self.image_shape = (self.resolution, self.resolution, img.shape[2])

    def close(self) -> None:
        if self._zip is not None:
            self._zip.close()
            self._zip = None

    def _read(self, fname: str) -> Optional[bytes]:
        if self._zip is not None:
            try:
                return self._zip.read(fname)
            except KeyError:
                return None
        p = os.path.join(self.path, fname)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def _load_image(self, raw_idx: int) -> np.ndarray:
        name = self._files[raw_idx]
        img = decode_image(self._read(name), os.path.join(self.path, name))
        if img.ndim == 2:
            img = img[:, :, None]
        return img[:, :, :3]

    @property
    def label_dim(self) -> int:
        if self._labels is None:
            return 0
        arr = np.asarray(self._labels)
        return int(arr.max() + 1) if arr.ndim == 1 else arr.shape[1]

    def __len__(self) -> int:
        return len(self._raw_idx)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(image (H, W, C) uint8, label float32: one-hot for a scalar
        label, the vector as given otherwise, empty without labels)."""
        raw = int(self._raw_idx[idx])
        img = self._load_image(raw)
        if self._xflip[idx]:
            img = img[:, ::-1]
        label = np.zeros(max(self.label_dim, 0), np.float32)
        if self._labels is not None:
            lab = self._labels[raw]
            if np.isscalar(lab):
                label = np.zeros(self.label_dim, np.float32)
                label[int(lab)] = 1.0
            else:
                label = np.asarray(lab, np.float32)
        return np.ascontiguousarray(img), label
