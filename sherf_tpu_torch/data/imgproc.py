"""The five OpenCV calls of the JAX package's loaders, in numpy, each held to
cv2 by ``tests/test_torch_image_io.py`` (the machines the port runs on
have no imaging package):

  * ``resize_area`` — ``cv2.resize(..., INTER_AREA)``.  At integer scales
    (the loaders' 1/2 and 1/3) it sums each cell in cv2's order (row
    major, four terms at a time) in float32 and scales by ``1 / area``:
    bit-equal for images of 3 channels.  Other scales use cv2's area
    weights in float64 (within 1e-6 of cv2's float32 sums);
  * ``resize_nearest`` — ``cv2.resize(..., INTER_NEAREST)``:
    ``src = min(floor(dst * (1 / (dst_size / src_size))), src_size - 1)``;
  * ``fill_poly`` — ``cv2.fillPoly`` with 8-connected edges: each edge's
    Bresenham line (``cv2.line``'s pixels, clipped as ``clipLine``
    clips), then the scanline fill of OpenCV's ``FillEdgeCollection``,
    with the edge slopes, span ends and clipped edges of OpenCV 5 (found
    by holding it to cv2 5.0: slopes floored in 32 fractional bits, where
    16 drift a pixel off cv2's over a few hundred rows; a span's right
    end excluded where it falls on a pixel boundary; an edge that leaves
    the image follows its clipped segment and, in the rows beyond that
    segment, the border it left by).  Bit-equal, inside the image and
    partly off it;
  * ``undistort`` — ``cv2.undistort``: ``initUndistortRectifyMap`` in the
    stripes cv2 computes it in, coordinates quantised to 1/32 pixel, then
    a bilinear ``remap`` with cv2's float weights and a constant-0 border;
  * ``rodrigues`` — ``cv2.Rodrigues`` of a rotation vector.
"""

from __future__ import annotations

import math

import numpy as np

EDGE_SHIFT = 32
INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS


# ---------------------------------------------------------------------------
# resize


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of cv2's ``computeResizeAreaTab``."""
    scale = ssize / dsize
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        w[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for a float32
    (H, W) or (H, W, C) image shrunk to ``size = (width, height)``."""
    W, H = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    img = np.asarray(img, np.float32)
    sx, sy = 1.0 / (W / sw), 1.0 / (H / sh)
    ix, iy = int(np.rint(sx)), int(np.rint(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps and ix >= 1 and iy >= 1:
        x = img[:H * iy, :W * ix].reshape(H, iy, W, ix, *img.shape[2:])
        cells = [x[:, i, :, j] for i in range(iy) for j in range(ix)]
        total = np.zeros_like(cells[0])
        k = 0
        while k + 4 <= len(cells):
            total = total + (((cells[k] + cells[k + 1]) + cells[k + 2])
                             + cells[k + 3])
            k += 4
        for c in cells[k:]:
            total = total + c
        return total * np.float32(1.0 / len(cells))
    if sx < 1 or sy < 1:
        raise ValueError("resize_area only shrinks")
    wy, wx = _area_weights(sh, H), _area_weights(sw, W)
    out = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(wx, out, axes=(1, 1)), 0, 1)
    return out.astype(np.float32)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``,
    ``size = (width, height)``."""
    W, H = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    fx, fy = 1.0 / (W / sw), 1.0 / (H / sh)
    xs = np.minimum(np.floor(np.arange(W) * fx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(H) * fy).astype(np.int64), sh - 1)
    return img[ys[:, None], xs[None, :]]


# ---------------------------------------------------------------------------
# fillPoly


def clip_line(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` on a w x h image: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    code = lambda x, y: ((x < 0) + (x > right) * 2 + (y < 0) * 4
                         + (y > bottom) * 8)
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line_pixels(w: int, h: int, x1, y1, x2, y2):
    """The pixels ``cv2.line(img, p1, p2, color, 1, cv2.LINE_8)`` sets
    (OpenCV's ``LineIterator``, left to right): (xs, ys) int arrays."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    if major == 0:
        return np.array([x1], np.int64), np.array([y1], np.int64)
    n = major + 1
    # the minor coordinate advances at step k when the error term before
    # it is negative: err_k = major - 2 minor (k + 1) + 2 major m_k, so
    # the minor offset after k steps is ceil((2 minor k - major) / 2 major)
    # clamped at 0, the Bresenham recurrence in closed form
    k = np.arange(n, dtype=np.int64)
    m = np.maximum(0, -((major - 2 * minor * k) // (2 * major)))
    if vert:
        return x1 + m, y1 + sy * k
    return x1 + k, y1 + sy * m


def _poly_edges(img, pts):
    """OpenCV's ``CollectPolyEdges`` (shift 0, 8-connected): draws each
    edge's line into ``img`` and returns the non-horizontal edges as
    [y0, y1, x, dx, cy0, cy1, x_above, x_below], x and dx in fixed point
    with ``EDGE_SHIFT`` fractional bits.  An edge that leaves the image
    takes the slope and x of its clipped segment (``clipLine``'s integer
    endpoints); where that segment spans rows cy0..cy1, the edge's rows
    above cy0 sit at ``x_above`` and its rows below cy1 at ``x_below``: 0
    where the edge's end on that side lies left of the image, the image's
    width where it lies right of it, None (the segment's line) where it
    lies above or below the image."""
    h, w = img.shape
    half = 1 << (EDGE_SHIFT - 1)
    side = lambda tx: (0 if tx < 0 else w << EDGE_SHIFT if tx >= w
                       else None)
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        xs, ys = line_pixels(w, h, x0, y0, x1, y1)
        img[ys, xs] = 1
        if y0 != y1:
            c0x, c0y, c1x, c1y = x0, y0, x1, y1
            rows = None
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h
                    and 0 <= y1 < h):
                inside, c0x, c0y, c1x, c1y = clip_line(w, h, x0, y0, x1, y1)
                if c0y == c1y:
                    c0y, c1y = y0, y1
                elif inside:
                    rows = (c0y, c1y)
            dx = ((c1x - c0x) << EDGE_SHIFT) // (c1y - c0y)
            # [row, x, clipped x, clipped row] of the upper end, the lower
            (ya, xa, cxa, cya), (yb, xb, _, cyb) = sorted(
                [(y0, x0, c0x, c0y), (y1, x1, c1x, c1y)])
            x = (cxa << EDGE_SHIFT) + half + (ya - cya) * dx
            if rows is None:
                edges.append([ya, yb, x, dx, ya, yb, None, None])
            else:
                edges.append([ya, yb, x, dx, cya, cyb, side(xa), side(xb)])
        x0, y0 = x1, y1
    return edges


def _fill_edges(img, edges):
    """OpenCV's ``FillEdgeCollection`` (non-antialiased): every row's
    active edges sorted by x and filled pairwise, a span from its left
    edge's pixel to the pixel before its right edge's."""
    h, w = img.shape
    if len(edges) < 2:
        return
    for y in range(max(min(e[0] for e in edges), 0),
                   min(max(e[1] for e in edges), h)):
        xs = []
        for y0, y1, x, dx, cy0, cy1, x_above, x_below in edges:
            if not y0 <= y < y1:
                continue
            if y < cy0 and x_above is not None:
                xs.append(x_above)
            elif y > cy1 and x_below is not None:
                xs.append(x_below)
            else:
                xs.append(x + (y - y0) * dx)
        xs.sort()
        for a, b in zip(xs[0::2], xs[1::2]):
            x1, x2 = a >> EDGE_SHIFT, (b - 1) >> EDGE_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = 1


def fill_poly(img: np.ndarray, pts) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], 1)`` on a 2D uint8 mask, in place;
    ``pts``: (n, 2) integer (x, y) vertices."""
    _fill_edges(img, _poly_edges(img, [(int(x), int(y)) for x, y in pts]))
    return img


# ---------------------------------------------------------------------------
# undistort


def _inv3(m):
    """cv2.invert of a 3x3 double matrix (its closed form for n == 3)."""
    m = [[float(v) for v in row] for row in m]
    d = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
         - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
         + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    d = 1.0 / d
    return [(m[1][1] * m[2][2] - m[1][2] * m[2][1]) * d,
            (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * d,
            (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * d,
            (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * d,
            (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * d,
            (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * d,
            (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * d,
            (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * d,
            (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * d]


def undistort_map(K, D, H: int, W: int):
    """``cv2.undistort``'s source coordinates in 1/32 pixel: (H, W) int64
    arrays of x * 32 and y * 32, computed as ``initUndistortRectifyMap``
    with the camera matrix as the new one, over cv2's row stripes."""
    K = np.asarray(K, np.float64)
    d = np.zeros(14)
    dd = np.asarray(D, np.float64).reshape(-1)
    d[:dd.size] = dd
    k1, k2, p1, p2, k3, k4, k5, k6 = d[:8]
    s1, s2, s3, s4 = d[8:12]
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    stripe = min(max(1, (1 << 12) // max(W, 1)), H)
    mx = np.empty((H, W), np.int64)
    my = np.empty((H, W), np.int64)
    for y in range(0, H, stripe):
        n = min(stripe, H - y)
        ar = K.copy()
        ar[1, 2] = K[1, 2] - y
        ir = _inv3(ar)
        i = np.arange(n, dtype=np.float64)[:, None]
        # the row's start, then += ir[0] per column (sequential sums)
        xs = np.cumsum(np.concatenate(
            [i * ir[1] + ir[2], np.full((n, W - 1), ir[0])], axis=1), axis=1)
        ys = np.cumsum(np.concatenate(
            [i * ir[4] + ir[5], np.full((n, W - 1), ir[3])], axis=1), axis=1)
        ws = np.cumsum(np.concatenate(
            [i * ir[7] + ir[8], np.full((n, W - 1), ir[6])], axis=1), axis=1)
        w = 1.0 / ws
        x, yy = xs * w, ys * w
        x2, y2 = x * x, yy * yy
        r2 = x2 + y2
        _2xy = 2 * x * yy
        kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (
            1 + ((k6 * r2 + k5) * r2 + k4) * r2)
        xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2) + s1 * r2 + s2 * r2 * r2
        yd = yy * kr + p1 * (r2 + 2 * y2) + p2 * _2xy + s3 * r2 + s4 * r2 * r2
        mx[y:y + n] = np.rint((fx * xd + u0) * INTER_TAB_SIZE)
        my[y:y + n] = np.rint((fy * yd + v0) * INTER_TAB_SIZE)
    return mx, my


def undistort(img: np.ndarray, K, D) -> np.ndarray:
    """``cv2.undistort(img, K, D)`` for a float32 (H, W) or (H, W, C)
    image: bilinear, constant-0 border."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    mx, my = undistort_map(K, D, H, W)
    x0, y0 = mx >> INTER_BITS, my >> INTER_BITS
    ax = (mx & (INTER_TAB_SIZE - 1)).astype(np.float32) * np.float32(
        1.0 / INTER_TAB_SIZE)
    ay = (my & (INTER_TAB_SIZE - 1)).astype(np.float32) * np.float32(
        1.0 / INTER_TAB_SIZE)
    one = np.float32(1)
    wts = [(one - ay) * (one - ax), (one - ay) * ax, ay * (one - ax), ay * ax]
    chan = img.shape[2:]
    total = None
    for (oy, ox), wt in zip(((0, 0), (0, 1), (1, 0), (1, 1)), wts):
        ys, xs = y0 + oy, x0 + ox
        ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        px = img[np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)]
        px = np.where(ok.reshape(ok.shape + (1,) * len(chan)), px,
                      np.float32(0))
        term = px * wt.reshape(wt.shape + (1,) * len(chan))
        total = term if total is None else total + term
    return total.astype(np.float32)


# ---------------------------------------------------------------------------


def rodrigues(rvec) -> np.ndarray:
    """``cv2.Rodrigues(rvec)[0]``: the (3, 3) float64 rotation matrix of a
    rotation vector."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = math.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    c1 = 1.0 - c
    x, y, z = r * (1.0 / theta)
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z],
                    [x * z, y * z, z * z]])
    r_x = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return c * np.eye(3) + c1 * rrt + s * r_x
