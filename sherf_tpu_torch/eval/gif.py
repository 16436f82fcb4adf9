"""An animated-GIF writer of the port's own (GIF89a, LZW, standard library
and numpy only: the machines the port runs on have no imaging package).

Every frame is mapped onto one fixed 256-entry palette of 8 x 8 x 4 levels
(red, green, blue; "3-3-2"): level ``i`` of a channel with ``n`` levels is
``round(i * 255 / (n - 1))`` and a value takes its nearest level.  The
quantisation bound, over all 256 input values: |error| <= 18 in red and
green (levels 0, 36, 73, 109, 146, 182, 219, 255) and <= 42 in blue (0, 85,
170, 255).  ``quantize`` gives the frame a viewer decodes from the file.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

LEVELS = (8, 8, 4)
# the largest |value - decoded value| per channel (see above)
QUANT_BOUND = (18, 18, 42)


def _levels(n: int) -> np.ndarray:
    return np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8)


def palette() -> np.ndarray:
    """(256, 3) uint8: entry r * 32 + g * 4 + b."""
    r, g, b = (_levels(n) for n in LEVELS)
    return np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)


def palette_indices(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8 palette entries (nearest level per
    channel)."""
    v = np.asarray(rgb, np.int32)
    idx = [(v[..., c] * (n - 1) * 2 + 255) // 510 for c, n in enumerate(LEVELS)]
    return (idx[0] * 32 + idx[1] * 4 + idx[2]).astype(np.uint8)


def quantize(rgb: np.ndarray) -> np.ndarray:
    """The frame as a GIF written by ``write_gif`` decodes: (H, W, 3)
    uint8."""
    return palette()[palette_indices(rgb)]


def _lzw(indices: bytes, min_size: int = 8) -> bytes:
    """GIF LZW of a stream of palette entries, as packed bytes (LSB first).
    The table is cleared when it is full (4096 codes)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def fresh():
        return {bytes([i]): i for i in range(clear)}, min_size + 1, eoi + 1

    table, size, nxt = fresh()
    emit(clear, size)
    w = b""
    for c in indices:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w], size)
        table[wc] = nxt
        nxt += 1
        if nxt == 4096:
            emit(clear, size)
            table, size, nxt = fresh()
        elif nxt > (1 << size):
            size += 1
        w = bytes([c])
    if w:
        emit(table[w], size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def gif_bytes(frames: Sequence[np.ndarray], fps: float = 10.0) -> bytes:
    """(H, W, 3) uint8 frames of one size -> an endlessly looping GIF89a."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    H, W = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (H, W, 3):
            raise ValueError(f"GIF frames are ({H}, {W}, 3) uint8, got "
                             f"{f.shape} {f.dtype}")
    delay = int(round(100.0 / fps))          # hundredths of a second
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0),
           palette().tobytes(),
           # NETSCAPE2.0 application extension: loop forever
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        # graphic control extension: disposal 1 (keep), the delay
        out.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0))
        out.append(b"\x08" + _sub_blocks(_lzw(palette_indices(f).tobytes())))
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 10.0
              ) -> None:
    data = gif_bytes(frames, fps)
    with open(path, "wb") as f:
        f.write(data)
