"""A PNG reader through the standard library's ``zlib``, returning what
``imageio.v2.imread`` (PIL) returns for the same file:

  * 8-bit gray (H, W), gray + alpha (H, W, 2), RGB (H, W, 3) and RGBA
    (H, W, 4) as uint8;
  * palette images expanded to RGB (H, W, 3) through ``PLTE``, with or
    without ``tRNS`` (imageio drops the alpha), at 1, 2, 4 or 8 bits;
  * 16-bit gray as uint16; 16-bit RGB and RGBA as uint8 holding each
    sample's high byte (PIL keeps 8 bits for those); 16-bit gray + alpha
    as such an RGBA (H, W, 4), the gray in R, G and B;
  * 1-bit gray as bool; 2- and 4-bit gray scaled to 0..255 as uint8.

Filter types 0-4, non-interlaced and interlaced (Adam7: each of the seven
passes unfiltered as an image of its own, then scattered into place).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples a pixel
# Adam7 passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: np.ndarray, H: int, row_bytes: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the per-scanline filters: (H, 1 + row_bytes) -> (H, row_bytes).
    Rows of types 0-2 go one row at a time; a file with any Average or
    Paeth row is undone along anti-diagonals of its pixels, all rows at
    once (a pixel needs only its left, upper and upper-left neighbours)."""
    ftype = raw[:, 0].astype(np.int64)
    data = raw[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"{path}: bad PNG filter type {int(ftype.max())}")
    if not ftype.any():
        return data
    if (ftype <= 2).all():
        out = np.empty_like(data)
        prev = np.zeros(row_bytes, np.uint8)
        for y in range(H):
            row = data[y]
            if ftype[y] == 1:
                row = (np.cumsum(row.reshape(-1, bpp), axis=0,
                                 dtype=np.int64) & 255).astype(np.uint8
                                                               ).reshape(-1)
            elif ftype[y] == 2:
                row = row + prev
            out[y] = row
            prev = out[y]
        return out
    W = row_bytes // bpp
    # skewed layout: S[2 + x + y, 1 + y] is pixel (y, x), so the pixels of
    # anti-diagonal t = x + y are one contiguous slice S[2 + t], their left
    # neighbours S[1 + t], the upper ones S[1 + t] one row up, and the
    # upper-left ones S[t] one row up; the zero rows and columns are the
    # image's zero border
    d = data.reshape(H, W, bpp).astype(np.int32)
    S = np.zeros((H + W + 1, H + 1, bpp), np.int32)
    ys, xs = np.mgrid[0:H, 0:W]
    D = np.zeros_like(S)
    D[2 + xs + ys, 1 + ys] = d
    f = ftype[:, None]
    for t in range(H + W - 1):
        y0, y1 = max(0, t - W + 1), min(H - 1, t) + 1
        a = S[1 + t, 1 + y0:1 + y1]
        b = S[1 + t, y0:y1]
        c = S[t, y0:y1]
        ft = f[y0:y1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, paeth, 0))))
        S[2 + t, 1 + y0:1 + y1] = (D[2 + t, 1 + y0:1 + y1] + pred) & 255
    return S[2 + xs + ys, 1 + ys].astype(np.uint8).reshape(H, row_bytes)


def _samples(rows: np.ndarray, H: int, W: int, spp: int,
             depth: int) -> np.ndarray:
    """Unfiltered rows (H, row_bytes) -> samples (H, W, spp): uint16 at 16
    bits, else uint8 (sub-byte samples unpacked, not yet scaled)."""
    if depth == 16:
        s = rows[:, :W * spp * 2].reshape(H, W, spp, 2).astype(np.uint16)
        return (s[..., 0] << 8) | s[..., 1]
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(H, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        vals = (bits * weights).sum(axis=2)[:, :W * spp].astype(np.uint8)
    else:
        vals = rows[:, :W * spp]
    return vals.reshape(H, W, spp)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> the array ``imageio.v2.imread`` returns (see above)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    plte = None
    hdr = None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    if ctype not in _SAMPLES or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits "
                         f"is not supported")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace} is not "
                         f"supported")
    spp = _SAMPLES[ctype]
    bpp = max(1, spp * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    dims = [(-(-(H - y0) // dy), -(-(W - x0) // dx))
            for x0, y0, dx, dy in passes]
    sizes = [h * ((w * spp * depth + 7) // 8 + 1) if h and w else 0
             for h, w in dims]
    if raw.size < sum(sizes):
        kind = "interlaced (Adam7) " if interlace else ""
        raise ValueError(f"{path}: {kind}PNG image data too short")
    vals = np.empty((H, W, spp), np.uint16 if depth == 16 else np.uint8)
    start = 0
    for (x0, y0, dx, dy), (h, w), size in zip(passes, dims, sizes):
        if not size:
            continue
        row_bytes = (w * spp * depth + 7) // 8
        rows = _unfilter(raw[start:start + size].reshape(h, row_bytes + 1),
                         h, row_bytes, bpp, path)
        start += size
        vals[y0::dy, x0::dx] = _samples(rows, h, w, spp, depth)

    if depth == 16:
        if ctype == 0:
            return vals[..., 0]
        hi = (vals >> 8).astype(np.uint8)
        if ctype == 4:      # PIL reads 16-bit gray + alpha as RGBA
            return hi[..., [0, 0, 0, 1]]
        return hi
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        return pal[vals[..., 0]]
    if ctype == 0:
        g = vals[..., 0]
        if depth == 1:
            return g.astype(bool)
        return (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return np.ascontiguousarray(vals)
