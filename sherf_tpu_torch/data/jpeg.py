"""A baseline-sequential JPEG decoder in numpy whose output is bit-equal to
libjpeg-turbo's default decode (what PIL, and so ``imageio.v2.imread``,
return).  The machines the port runs on have no imaging package.

What it reproduces of libjpeg-turbo's defaults:

  * the ``JDCT_ISLOW`` integer IDCT (``jidctint.c``: ``CONST_BITS`` 13,
    ``PASS1_BITS`` 2) and its range-limit table, indexed by the output
    masked to 10 bits;
  * fancy upsampling (``jdsample.c``): the triangle filters of h2v1 and
    h2v2 (``+8 >> 4`` / ``+7 >> 4``), with the edge rows and columns
    replicated (plain replication for a plane 2 samples wide or less);
  * table-driven YCbCr -> RGB (``jdcolor.c``: ``SCALEBITS`` 16,
    ``ONE_HALF`` rounding).

Supported: 8-bit Huffman-coded sequential (SOF0 / SOF1) and progressive
(SOF2) files, gray or YCbCr, chroma at 4:4:4, 4:2:2 or 4:2:0, restart
markers, interleaved and non-interleaved scans in any component order.  A
progressive file's scans (DC first and refinement, AC first with
end-of-band runs, AC refinement; ``jdphuff.c``) leave the same
coefficients a baseline file holds, which then take the same IDCT.  A
progressive file that leaves any of the first ten zigzag coefficients of
a component short of its last bit would get libjpeg's block smoothing and
raises instead.  Arithmetic-coded, lossless, hierarchical, 12-bit, RGB- or
CMYK-coded files and other samplings (4:1:1, 4:4:0) raise ``ValueError``
naming the file.

Dequantisation, the IDCT, upsampling and colour conversion run over all
blocks at once; only the Huffman decode is a Python loop.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

# natural-order index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC1: None, 0xC0: None, 0xC2: None,
              0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xC9: "arithmetic-coded",
              0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded",
              0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical",
              0xCF: "arithmetic-coded hierarchical"}


# libjpeg-turbo's SAVED_COEFS: block smoothing looks at zigzag 0..9
_SMOOTHED_COEFS = 10


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coef = None          # (blocks_y, blocks_x, 64) int32, zigzag
        # progressive: the Al of the last scan of each coefficient, -1 if
        # none (libjpeg's coef_bits)
        self.coef_bits = [-1] * 64


def _huffman_lut(counts, symbols) -> List[int]:
    """16-bit lookahead table: entry (code length << 8 | symbol) for every
    16-bit window that starts with a code; 0 where no code starts."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("bad Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data: bytes, start: int):
    """The entropy-coded data of a scan from ``start``: a list of segments
    split at restart markers, each with its 0xFF00 stuffing removed, and
    the offset of the marker that ends the scan."""
    segs = []
    pos = start
    seg_start = start
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            raise ValueError("entropy-coded data runs past the end")
        m = data[j + 1]
        if m == 0x00 or m == 0xFF:
            pos = j + 1 if m == 0xFF else j + 2
            continue
        segs.append(data[seg_start:j].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            pos = seg_start = j + 2
            continue
        return segs, j


def _words(seg: bytes) -> List[int]:
    """32-bit big-endian window starting at every byte of ``seg`` (zero
    bits past its end, as libjpeg inserts at a marker)."""
    b = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.int64)
    w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    return w.tolist()


def _decode_scan(segs, order, mcu_blocks, restart, dc_luts, ac_luts,
                 n_slots, path):
    """Huffman-decode a scan.  ``order``: per block in coding order, its
    (slot, flat coefficient offset); ``mcu_blocks`` blocks an MCU.  Returns
    flat (offsets, values) of the nonzero coefficients."""
    offs: List[int] = []
    vals: List[int] = []
    add_off, add_val = offs.append, vals.append
    n_blocks = len(order)
    per_seg = restart * mcu_blocks if restart else n_blocks
    b0 = 0
    for seg in segs:
        if b0 >= n_blocks:
            break
        w = _words(seg)
        limit = len(seg) * 8 + 16
        pred = [0] * n_slots
        pos = 0
        for slot, base in order[b0:b0 + per_seg]:
            dc_lut, ac_lut = dc_luts[slot], ac_luts[slot]
            e = dc_lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise ValueError(f"{path}: bad Huffman code")
            pos += e >> 8
            s = e & 0xFF
            if s:
                v = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pos += s
                pred[slot] += v
            if pred[slot]:
                add_off(base)
                add_val(pred[slot])
            k = 1
            while k < 64:
                e = ac_lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(f"{path}: bad Huffman code")
                pos += e >> 8
                rs = e & 0xFF
                s = rs & 15
                if not s:
                    if rs == 0xF0:
                        k += 16
                        continue
                    break
                k += rs >> 4
                v = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pos += s
                if k < 64:
                    add_off(base + k)
                    add_val(v)
                k += 1
            if pos > limit:
                raise ValueError(f"{path}: entropy-coded data too short")
        b0 += per_seg
    if b0 < n_blocks:
        raise ValueError(f"{path}: scan ends after {b0} of {n_blocks} blocks")
    return offs, vals


def _huff(lut, w, pos, path):
    e = lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if not e:
        raise ValueError(f"{path}: bad Huffman code")
    return pos + (e >> 8), e & 0xFF


def _bits(w, pos, n):
    return (w[pos >> 3] >> (32 - (pos & 7) - n)) & ((1 << n) - 1)


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_progressive_scan(segs, order, mcu_blocks, restart, coef, luts,
                             n_slots, ss, se, ah, al, path):
    """Decode one progressive scan (``jdphuff.c``) into ``coef``, a flat
    list of the scan's components' zigzag coefficients, in place.
    ``order`` / ``mcu_blocks`` / ``restart`` as :func:`_decode_scan`;
    ``luts`` per slot: the DC table for a DC first scan, the AC table for
    an AC scan, unused for a DC refinement."""
    n_blocks = len(order)
    per_seg = restart * mcu_blocks if restart else n_blocks
    p1, m1 = 1 << al, -(1 << al)
    b0 = 0
    for seg in segs:
        if b0 >= n_blocks:
            break
        w = _words(seg)
        limit = len(seg) * 8 + 16
        pred = [0] * n_slots
        eobrun = 0
        pos = 0
        for slot, base in order[b0:b0 + per_seg]:
            if ss == 0 and ah == 0:             # DC first
                pos, s = _huff(luts[slot], w, pos, path)
                if s:
                    pred[slot] += _extend(_bits(w, pos, s), s)
                    pos += s
                coef[base] = pred[slot] << al
            elif ss == 0:                       # DC refinement
                if _bits(w, pos, 1):
                    coef[base] |= p1
                pos += 1
            elif ah == 0:                       # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                lut = luts[slot]
                k = ss
                while k <= se:
                    pos, rs = _huff(lut, w, pos, path)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        if k > se:
                            raise ValueError(f"{path}: bad AC run")
                        coef[base + k] = _extend(_bits(w, pos, s), s) << al
                        pos += s
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += _bits(w, pos, r)
                            pos += r
                        eobrun -= 1
                        break
                    k += 1
            else:                               # AC refinement
                lut = luts[slot]
                k = ss
                if not eobrun:
                    while k <= se:
                        pos, rs = _huff(lut, w, pos, path)
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if _bits(w, pos, 1) else m1
                            pos += 1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += _bits(w, pos, r)
                                pos += r
                            break
                        # past r zero coefficients (appending a correction
                        # bit to each nonzero one) to the new coefficient
                        while k <= se:
                            c = coef[base + k]
                            if c:
                                if _bits(w, pos, 1) and not c & p1:
                                    coef[base + k] = c + (p1 if c >= 0 else m1)
                                pos += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            if k > se:
                                raise ValueError(f"{path}: bad AC run")
                            coef[base + k] = s
                        k += 1
                if eobrun:
                    # the rest of the band: correction bits only
                    while k <= se:
                        c = coef[base + k]
                        if c:
                            if _bits(w, pos, 1) and not c & p1:
                                coef[base + k] = c + (p1 if c >= 0 else m1)
                            pos += 1
                        k += 1
                    eobrun -= 1
            if pos > limit:
                raise ValueError(f"{path}: entropy-coded data too short")
        b0 += per_seg
    if b0 < n_blocks:
        raise ValueError(f"{path}: scan ends after {b0} of {n_blocks} blocks")


# ---------------------------------------------------------------------------
# jidctint.c


def _fix(x):
    return int(x * (1 << 13) + 0.5)


F0_298, F0_390, F0_541, F0_765 = (_fix(0.298631336), _fix(0.390180644),
                                  _fix(0.541196100), _fix(0.765366865))
F0_899, F1_175, F1_501, F1_847 = (_fix(0.899976223), _fix(1.175875602),
                                  _fix(1.501321110), _fix(1.847759065))
F1_961, F2_053, F2_562, F3_072 = (_fix(1.961570560), _fix(2.053119869),
                                  _fix(2.562915447), _fix(3.072711026))


def _idct_1d(d0, d1, d2, d3, d4, d5, d6, d7):
    """One pass of jpeg_idct_islow before its descale: the 8 outputs, each
    scaled up by 2**13 (the inputs' scale kept)."""
    z1 = (d2 + d6) * F0_541
    tmp2 = z1 + d6 * (-F1_847)
    tmp3 = z1 + d2 * F0_765
    tmp0 = (d0 + d4) << 13
    tmp1 = (d0 - d4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = d7, d5, d3, d1
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1_175
    t0 = t0 * F0_298
    t1 = t1 * F2_053
    t2 = t2 * F3_072
    t3 = t3 * F1_501
    z1 = z1 * (-F0_899)
    z2 = z2 * (-F2_562)
    z3 = z3 * (-F1_961) + z5
    z4 = z4 * (-F0_390) + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _range_limit() -> np.ndarray:
    """libjpeg's IDCT range-limit table, indexed by (output & 1023)."""
    x = np.arange(1024)
    out = np.zeros(1024, np.uint8)
    out[:128] = x[:128] + 128
    out[128:512] = 255
    out[896:] = x[896:] - 896
    return out


_RANGE_LIMIT = _range_limit()


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients (natural order, [row, col]) ->
    (N, 8, 8) uint8 samples, as ``jpeg_idct_islow``."""
    c = coef.astype(np.int64)
    # pass 1: columns, descaled by CONST_BITS - PASS1_BITS
    cols = _idct_1d(*(c[:, k, :] for k in range(8)))
    ws = np.stack([(t + (1 << 10)) >> 11 for t in cols], axis=1)
    # pass 2: rows, descaled by CONST_BITS + PASS1_BITS + 3
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)))
    out = np.stack([(t + (1 << 17)) >> 18 for t in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


# ---------------------------------------------------------------------------
# jdsample.c, jdcolor.c


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample on (rows, w) int arrays (w > 2)."""
    x = x.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample on an (h, w) int array (w > 2)."""
    x = x.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, near in ((0, up), (1, down)):
        col = 3 * x + near
        left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * col + left + 8) >> 4
        out[r::2, 1::2] = (3 * col + right + 7) >> 4
    return out


def _upsample(plane: np.ndarray, hr: int, vr: int, path: str) -> np.ndarray:
    """The component plane (its downsampled size) upsampled by (hr, vr) as
    libjpeg-turbo's decompressor does with fancy upsampling on."""
    if (hr, vr) == (1, 1):
        return plane
    if (hr, vr) not in ((2, 1), (2, 2)):
        raise ValueError(f"{path}: chroma sampling {hr}x{vr} is not "
                         f"supported (4:4:4, 4:2:2 and 4:2:0 only)")
    if plane.shape[1] <= 2:
        return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)
    return _fancy_h2(plane) if vr == 1 else _fancy_h2v2(plane)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on uint8-valued planes -> (H, W, 3)."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 (H, W) or (H, W, 3), as PIL decodes them."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, list] = {}
    ac_tabs: Dict[int, list] = {}
    comps: List[_Component] = []
    restart = 0
    H = W = 0
    progressive = False
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: bad marker at {pos}")
        m = data[pos + 1]
        if m == 0xD9:
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        seg_len = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + seg_len]
        nxt = pos + 2 + seg_len
        if m in _SOF_NAMES:
            kind = _SOF_NAMES[m]
            if kind is not None:
                raise ValueError(f"{path}: {kind} JPEG is not supported "
                                 f"(baseline sequential only)")
            progressive = m == 0xC2
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG is not supported "
                                 f"(8-bit only)")
            if H == 0:
                raise ValueError(f"{path}: DNL-sized JPEG is not supported")
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        elif m == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq:
                    tab = np.frombuffer(seg[p + 1:p + 129], ">u2")
                    p += 129
                else:
                    tab = np.frombuffer(seg[p + 1:p + 65], np.uint8)
                    p += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = tab
                qt[tq] = q
        elif m == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                nsym = sum(counts)
                syms = list(seg[p + 17:p + 17 + nsym])
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(counts, syms)
                p += 17 + nsym
        elif m == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12 \
                and seg[11] == 0:
            raise ValueError(f"{path}: RGB- or CMYK-coded JPEG is not "
                             f"supported (YCbCr only)")
        elif m == 0xDA:
            if not comps:
                raise ValueError(f"{path}: scan before frame header")
            ns = seg[0]
            ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
            spec = (ss, se, a >> 4, a & 15) if progressive else None
            # the tables a scan reads: both (sequential), DC (a progressive
            # DC first scan), AC (a progressive AC scan), none (DC refine)
            need_dc = not progressive or (ss == 0 and a >> 4 == 0)
            need_ac = not progressive or ss > 0
            scomps = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                comp = next(c for c in comps if c.id == cid)
                if (need_dc and (t >> 4) not in dc_tabs) or (
                        need_ac and (t & 15) not in ac_tabs):
                    raise ValueError(f"{path}: missing Huffman table")
                scomps.append((comp, dc_tabs.get(t >> 4),
                               ac_tabs.get(t & 15)))
            pos = _read_scan(data, nxt, comps, scomps, restart, H, W, path,
                             spec)
            continue
        pos = nxt

    if len(comps) not in (1, 3):
        raise ValueError(f"{path}: {len(comps)}-component JPEG is not "
                         f"supported")
    if progressive and all(c.coef_bits[0] >= 0 for c in comps) and any(
            any(c.coef_bits[1:_SMOOTHED_COEFS]) for c in comps):
        raise ValueError(f"{path}: progressive JPEG whose scans leave low "
                         f"AC coefficients unrefined (libjpeg's block "
                         f"smoothing) is not supported")
    planes = _planes(comps, qt, H, W, path)
    if len(comps) == 1:
        return planes[0]
    return ycc_to_rgb(*planes)


def _ceil(a, b):
    return -(-a // b)


def _geometry(comps, H, W):
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    return hmax, vmax, _ceil(W, 8 * hmax), _ceil(H, 8 * vmax)


def _read_scan(data, start, comps, scomps, restart, H, W, path,
               spec=None):
    """Decode the scan at ``start`` into its components' ``coef``; ``spec``
    is a progressive scan's (Ss, Se, Ah, Al), None for a sequential one.
    Returns the offset of the marker after the scan."""
    hmax, vmax, mcux, mcuy = _geometry(comps, H, W)
    for c in comps:
        if c.coef is None:
            c.coef = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int32)
    slots = {id(c): i for i, (c, _, _) in enumerate(scomps)}
    bases = []
    base = 0
    for c, _, _ in scomps:
        bases.append(base)
        base += c.coef.size
    order = []
    if len(scomps) == 1:
        # non-interleaved: the component's own blocks, raster order
        c = scomps[0][0]
        bw = _ceil(_ceil(W * c.h, hmax), 8)
        bh = _ceil(_ceil(H * c.v, vmax), 8)
        row = c.coef.shape[1]
        for by in range(bh):
            order += [(0, (by * row + bx) * 64) for bx in range(bw)]
        mcu_blocks = 1
    else:
        mcu_blocks = sum(c.h * c.v for c, _, _ in scomps)
        for my in range(mcuy):
            for mx in range(mcux):
                for s, (c, _, _) in enumerate(scomps):
                    row = c.coef.shape[1]
                    for v in range(c.v):
                        for h in range(c.h):
                            order.append((s, bases[s] + (
                                (my * c.v + v) * row + mx * c.h + h) * 64))
    segs, end = _segments(data, start)
    flat = np.concatenate([c.coef.reshape(-1) for c, _, _ in scomps])
    if spec is None:
        offs, vals = _decode_scan(segs, order, mcu_blocks, restart,
                                  [t for _, t, _ in scomps],
                                  [t for _, _, t in scomps], len(scomps),
                                  path)
        if offs:
            flat[np.asarray(offs, np.int64)] = np.asarray(vals, np.int64)
    else:
        ss, se, ah, al = spec
        if ss > se or se > 63 or (ss == 0 and se != 0) or (
                ss > 0 and len(scomps) != 1):
            raise ValueError(f"{path}: bad progressive scan {spec}")
        coef = flat.tolist()
        _decode_progressive_scan(
            segs, order, mcu_blocks, restart, coef,
            [ac if ss else dc for _, dc, ac in scomps], len(scomps),
            ss, se, ah, al, path)
        flat = np.asarray(coef, np.int32)
        for c, _, _ in scomps:
            c.coef_bits[ss:se + 1] = [al] * (se - ss + 1)
    for s, (c, _, _) in enumerate(scomps):
        c.coef = flat[bases[s]:bases[s] + c.coef.size].reshape(c.coef.shape)
    return end


def _planes(comps, qt, H, W, path) -> List[np.ndarray]:
    hmax, vmax, _, _ = _geometry(comps, H, W)
    out = []
    for c in comps:
        if c.coef is None:
            raise ValueError(f"{path}: component {c.id} has no scan")
        if c.tq not in qt:
            raise ValueError(f"{path}: missing quantisation table {c.tq}")
        by, bx = c.coef.shape[:2]
        nat = np.zeros((by * bx, 64), np.int64)
        nat[:, ZIGZAG] = c.coef.reshape(-1, 64)
        blocks = idct_islow((nat * qt[c.tq]).reshape(-1, 8, 8))
        plane = blocks.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(
            by * 8, bx * 8)
        cw = _ceil(W * c.h, hmax)
        ch = _ceil(H * c.v, vmax)
        if hmax % c.h or vmax % c.v:
            raise ValueError(f"{path}: sampling factors {c.h}x{c.v} of "
                             f"{hmax}x{vmax} are not supported")
        plane = _upsample(plane[:ch, :cw], hmax // c.h, vmax // c.v, path)
        out.append(np.ascontiguousarray(plane[:H, :W]))
    return out
