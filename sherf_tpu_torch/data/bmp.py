"""A BMP reader of the port's own, returning what ``imageio.v2.imread``
(PIL) returns for the files it accepts: uncompressed 24-bit and 32-bit
bitmaps (``BI_RGB``, and ``BI_BITFIELDS`` with byte-aligned 8-bit masks)
as (H, W, 3) uint8 RGB; the fourth byte of a 32-bit pixel is dropped, as
PIL drops it.  Rows stored bottom-up (positive height) or top-down
(negative height).  Any other BMP (palette, 16-bit, RLE, JPEG / PNG
payloads) raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

_BI_RGB, _BI_BITFIELDS = 0, 3
# the channel masks a 32-bit file must carry under BI_BITFIELDS
_BYTE_MASKS = {0x000000FF: 0, 0x0000FF00: 1, 0x00FF0000: 2, 0xFF000000: 3}


def decode_bmp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    header = struct.unpack_from("<I", data, 14)[0]
    if header < 40:
        raise ValueError(f"{path}: BMP core header ({header} bytes) is not "
                         f"supported")
    width, height, planes, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    if planes != 1 or bpp not in (24, 32) or width <= 0 or height == 0:
        raise ValueError(f"{path}: {bpp}-bit BMP ({width}x{height}) is not "
                         f"supported; only uncompressed 24- and 32-bit")
    if comp == _BI_BITFIELDS and bpp == 32:
        # the masks follow a 40-byte header, or sit inside a V4 / V5 one
        masks = struct.unpack_from("<III", data, 14 + 40)
        if any(m not in _BYTE_MASKS for m in masks):
            raise ValueError(f"{path}: BMP bit fields {masks} are not "
                             f"supported")
        order = [_BYTE_MASKS[m] for m in masks]
    elif comp == _BI_RGB:
        order = [2, 1, 0]                   # stored B, G, R
    else:
        raise ValueError(f"{path}: compressed BMP (type {comp}) is not "
                         f"supported; only uncompressed 24- and 32-bit")
    H, W, nb = abs(height), width, bpp // 8
    stride = (W * nb + 3) // 4 * 4
    if offset + stride * H > len(data):
        raise ValueError(f"{path}: truncated BMP")
    rows = np.frombuffer(data, np.uint8, stride * H, offset).reshape(H, stride)
    px = rows[:, :W * nb].reshape(H, W, nb)
    if height > 0:                          # bottom-up
        px = px[::-1]
    return np.ascontiguousarray(px[:, :, order])
