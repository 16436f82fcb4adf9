"""A PNG writer of the port's own: 8-bit RGB or gray through the standard
library's ``zlib`` and ``struct`` (the machines the port runs on need no
imaging package)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as the bytes of an 8-bit RGB PNG, or an
    (H, W) / (H, W, 1) uint8 one as an 8-bit gray PNG (no filtering)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    gray = img.ndim == 2
    if img.dtype != np.uint8 or not (gray or (img.ndim == 3
                                              and img.shape[2] == 3)):
        raise ValueError(f"a PNG is made from (H, W, 3) or (H, W) uint8, got "
                         f"{img.shape} {img.dtype}")
    H, W = img.shape[:2]
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          np.ascontiguousarray(img).reshape(H, -1)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, 0 if gray else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (no filtering)."""
    data = png_bytes(rgb)
    with open(path, "wb") as f:
        f.write(data)
