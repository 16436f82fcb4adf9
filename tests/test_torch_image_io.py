"""The port's image readers and cv2 replacements against the libraries they
replace (PIL through imageio, cv2), on the CPU:

  * ``data/jpeg.py``: bit-equal to ``imageio.v2.imread`` on JPEGs written
    here by PIL (quality 50 / 75 / 95, 4:4:4 / 4:2:2 / 4:2:0, odd sizes,
    grayscale) and by ``cv2.imwrite`` with a restart interval, and on the
    committed fixtures (``tests/fixtures/jpeg``, written by
    ``tests/fixtures/make_jpeg_fixtures.py``) against their stored decodes;
    progressive files written by PIL (4:2:0, 4:4:4, 4:2:2, grayscale, with
    ``optimize``, with restart markers) and by cv2 bit-equal to imageio; a
    4:1:1 file (baseline or progressive) and a progressive file cut before
    its refinement scans (libjpeg would smooth its blocks) raise
    ``ValueError`` naming the file;
  * ``data/png_read.py``: equal to imageio (values, dtype, shape) on gray,
    gray + alpha (8- and 16-bit), RGB, RGBA, palette (8- and 4-bit, with
    ``tRNS``), 1-bit and 16-bit files; Adam7-interlaced files written here
    with ``zlib`` (colour types 0 / 2 / 3 / 4 / 6 at every depth the reader
    takes, filter types 0-4, 1x1, 3x5 and 9x7: passes left empty) equal to
    imageio and to the non-interlaced file of the same pixels; an
    interlaced file whose data is short raises naming the file;
  * ``data/imgproc.py``: ``resize_area`` bit-equal to ``cv2.INTER_AREA`` at
    1/2 and 1/3 on 3-channel images, within 1e-6 at 0.75 (measured
    1.2e-7: cv2 sums the area weights in float32, the port in float64);
    ``resize_nearest`` bit-equal; ``fill_poly`` through
    ``get_bound_2d_mask`` on 200 seeded projected boxes (more than 50 of
    them partly off the image): bit-equal to the JAX package's cv2 mask;
    ``fill_poly`` bit-equal to ``cv2.fillPoly`` on 3,000 seeded 3- to
    5-gons whose vertices run up to half the image past each border;
    ``undistort`` bit-equal to
    ``cv2.undistort`` on THuman-like K, D for a float image and a float
    mask; ``rodrigues`` bit-equal to ``cv2.Rodrigues``.
"""

import glob
import hashlib
import io
import os
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from sherf_tpu.data.base import get_bound_2d_mask as j_bound_mask
from sherf_tpu_torch.data import imgproc
from sherf_tpu_torch.data.base import get_bound_2d_mask, read_image
from sherf_tpu_torch.data.jpeg import decode_jpeg
from sherf_tpu_torch.data.png_read import decode_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "jpeg")


def _photo(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    ph = rng.rand(3, 3) * 8
    img = np.stack([np.sin(ph[c, 0] * xx + ph[c, 1] * yy + ph[c, 2])
                    for c in range(3)], -1) * 100 + 128
    img += rng.randn(h, w, 3) * 15
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _imread(data):
    return imageio.imread(io.BytesIO(data))


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("hw", [(37, 53), (64, 48), (17, 9)])
def test_jpeg_bit_equal_to_pil(quality, subsampling, hw):
    data = _pil_jpeg(_photo(*hw, seed=quality + subsampling),
                     quality=quality, subsampling=subsampling)
    ref = _imread(data)
    got = decode_jpeg(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_jpeg_grayscale_optimized_and_restart_markers():
    img = _photo(41, 29, 1)
    for data in (_pil_jpeg(img[..., 1], quality=80),
                 _pil_jpeg(img, quality=85, optimize=True),
                 cv2.imencode(".jpg", img[..., ::-1], [
                     cv2.IMWRITE_JPEG_QUALITY, 90,
                     cv2.IMWRITE_JPEG_RST_INTERVAL, 3])[1].tobytes()):
        np.testing.assert_array_equal(decode_jpeg(data), _imread(data))


def test_jpeg_fixtures_match_their_stored_decodes():
    names = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert len(names) == 6
    for path in names:
        got = read_image(path)
        if os.path.exists(path[:-4] + ".decoded.png"):
            ref = read_image(path[:-4] + ".decoded.png")
            np.testing.assert_array_equal(got, ref, err_msg=path)
        else:
            with open(path[:-4] + ".decoded.sha256") as f:
                assert hashlib.sha256(got.tobytes()).hexdigest() == \
                    f.read().strip(), path
        np.testing.assert_array_equal(got, imageio.imread(path), err_msg=path)


def _cv2_jpeg(img, *params):
    return cv2.imencode(".jpg", img[..., ::-1], list(params))[1].tobytes()


PROGRESSIVE = {
    "420": dict(subsampling=2),
    "444": dict(subsampling=0, quality=95),
    "422": dict(subsampling=1, quality=60),
    "gray": dict(gray=True),
    "optimize": dict(subsampling=2, optimize=True),
    "restart_blocks": dict(subsampling=2, restart_marker_blocks=3),
    "restart_rows_gray": dict(gray=True, optimize=True,
                              restart_marker_rows=1),
}


@pytest.mark.parametrize("kind", sorted(PROGRESSIVE) + ["cv2_restart"])
def test_jpeg_progressive_equal_to_imageio(kind):
    """DC first / refinement scans, AC first scans with end-of-band runs,
    AC refinement; interleaved DC scans and one-component AC scans."""
    for hw in ((37, 53), (8, 8), (1, 1)):
        img = _photo(*hw, seed=hw[0])
        if kind == "cv2_restart":
            data = _cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                             cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
        else:
            kw = dict(PROGRESSIVE[kind])
            data = _pil_jpeg(img[..., 0] if kw.pop("gray", False) else img,
                             progressive=True, **kw)
        assert b"\xff\xc2" in data
        ref = _imread(data)
        got = decode_jpeg(data, kind)
        assert got.dtype == ref.dtype and got.shape == ref.shape, hw
        np.testing.assert_array_equal(got, ref, err_msg=str(hw))


def test_jpeg_progressive_raises_naming_the_file(tmp_path):
    """What the decoder still refuses: 4:1:1 chroma (baseline and
    progressive), and a progressive file whose last scans are cut (libjpeg
    smooths such blocks; PIL decodes it, the port does not)."""
    img = _photo(16, 32, 0)
    files = {
        "prog411.jpg": _cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "base411.jpg": _cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)}
    full = _pil_jpeg(img, progressive=True)
    cut = full[:full.rindex(b"\xff\xda")] + b"\xff\xd9"
    assert _imread(cut).shape == img.shape
    files["cut.jpg"] = cut
    for name, data in files.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        match = "cut.jpg.*smoothing" if name == "cut.jpg" else \
            name + ".*sampling"
        with pytest.raises(ValueError, match=match):
            read_image(path)


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filtered(rows, bpp):
    """Each row (bytes) behind the filter type ``row index % 5`` (None,
    Sub, Up, Average, Paeth) applied to it."""
    out, prev = [], np.zeros(len(rows[0]), np.int64)
    for i, r in enumerate(rows):
        a = np.frombuffer(r, np.uint8).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), a[:-bpp]])[:len(a)]
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(a)]
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        ft = i % 5
        pred = (0, left, prev, (left + prev) // 2, paeth)[ft]
        out.append(bytes([ft]) + ((a - pred) & 255).astype(np.uint8).tobytes())
        prev = a
    return b"".join(out)


def _adam7_png(samples, depth, ctype, interlace=1, plte=None):
    """A PNG of integer samples (H, W) or (H, W, spp), written here: rows
    packed at ``depth`` bits, filtered, Adam7-interlaced if asked."""
    samples = samples.reshape(samples.shape[:2] + (-1,))
    H, W, spp = samples.shape
    bpp = max(1, spp * depth // 8)

    def rows(s):
        h, w = s.shape[:2]
        flat = s.reshape(h, w * spp)
        if depth == 16:
            return [r.astype(">u2").tobytes() for r in flat]
        bits = np.unpackbits(flat.astype(np.uint8)[..., None], axis=2)
        return [np.packbits(r[:, 8 - depth:].reshape(-1)).tobytes()
                for r in bits]

    subs = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in (
        (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
        (1, 0, 2, 2), (0, 1, 1, 2))] if interlace else [samples])
    raw = b"".join(_filtered(rows(s), bpp) for s in subs if s.size)
    data = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _png_chunk(b"PLTE", plte.tobytes())
    return (data + _png_chunk(b"IDAT", zlib.compress(raw))
            + _png_chunk(b"IEND", b""))


def _pil_png(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _png_cases():
    rng = np.random.RandomState(0)
    a = np.concatenate([_photo(33, 47, 3),
                        (rng.rand(33, 47, 1) * 255).astype(np.uint8)], -1)
    rgb = Image.fromarray(a[..., :3])
    pal = rgb.convert("P", palette=Image.ADAPTIVE, colors=100)
    pal16 = rgb.convert("P", palette=Image.ADAPTIVE, colors=16)
    return {
        "gray": _pil_png(Image.fromarray(a[..., 0])),
        "gray_alpha": _pil_png(Image.fromarray(a[..., :2], "LA")),
        "gray_alpha16": _adam7_png(
            (a[..., :2].astype(np.uint16) * 257)[:9, :7], 16, 4,
            interlace=0),
        "rgb": _pil_png(rgb),
        "rgb_optimized": _pil_png(rgb, optimize=True),
        "rgba": _pil_png(Image.fromarray(a)),
        "palette": _pil_png(pal),
        "palette_trns": _pil_png(pal, transparency=5),
        "palette_4bit": _pil_png(pal16, bits=4),
        "bilevel": _pil_png(Image.fromarray(a[..., 0] > 128)),
        "gray16": _pil_png(Image.fromarray(
            a[..., 0].astype(np.uint16) * 257 + a[..., 1])),
        "rgb16_cv2": cv2.imencode(".png", (rng.rand(9, 7, 3) * 65535
                                           ).astype(np.uint16))[1].tobytes(),
    }


@pytest.mark.parametrize("kind", sorted(_png_cases()))
def test_png_equal_to_imageio(kind):
    data = _png_cases()[kind]
    ref = _imread(data)
    got = decode_png(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_png_interlaced_raises_naming_the_file():
    """A 4x4 8-bit gray Adam7 file holds 23 bytes of image data, filter
    bytes included: passes 1, 4, 5, 6, 7 of 2, 2, 3, 6 and 10 bytes (passes
    2 and 3 are empty at this size); 22 are too few."""
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    head = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)))
    tail = chunk(b"IEND", b"")
    ok = head + chunk(b"IDAT", zlib.compress(b"\0" * 23)) + tail
    np.testing.assert_array_equal(decode_png(ok), np.zeros((4, 4), np.uint8))
    short = head + chunk(b"IDAT", zlib.compress(b"\0" * 22)) + tail
    with pytest.raises(ValueError, match="mask.png.*interlaced.*too short"):
        decode_png(short, "mask.png")


@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
    (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_adam7_equal_to_imageio(ctype, depth):
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(ctype * 17 + depth)
    for h, w in ((1, 1), (3, 5), (9, 7)):
        s = rng.randint(0, 1 << depth, (h, w, spp))
        plte = (rng.randint(0, 256, (1 << depth, 3)).astype(np.uint8)
                if ctype == 3 else None)
        data = _adam7_png(s, depth, ctype, 1, plte)
        ref = _imread(data)
        got = decode_png(data)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (h, w)
        np.testing.assert_array_equal(got, ref, err_msg=str((h, w)))
        np.testing.assert_array_equal(
            got, decode_png(_adam7_png(s, depth, ctype, 0, plte)))


@pytest.mark.parametrize("shape,scale", [
    ((64, 96, 3), 0.5), ((72, 96, 3), 1 / 3), ((60, 81, 3), 1 / 3),
    ((64, 64, 3), 0.75)], ids=["half", "third", "third_odd", "0.75"])
def test_resize_area_and_nearest_match_cv2(shape, scale):
    rng = np.random.RandomState(1)
    img = rng.rand(*shape).astype(np.float32)
    msk = (rng.rand(*shape[:2]) > 0.5).astype(np.float32)
    size = (int(shape[1] * scale), int(shape[0] * scale))
    ref = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    got = imgproc.resize_area(img, size)
    assert got.dtype == np.float32 and got.shape == ref.shape
    if scale == 0.75:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        imgproc.resize_nearest(msk, size),
        cv2.resize(msk, size, interpolation=cv2.INTER_NEAREST))


def test_bound_masks_match_cv2_on_200_boxes():
    rng = np.random.RandomState(0)
    partly_off = 0
    for t in range(200):
        H, W = [(512, 512), (360, 640), (48, 48), (170, 170)][t % 4]
        c = rng.randn(3) * 0.3
        half = np.abs(rng.randn(3)) * 0.4 + 0.2
        bounds = np.stack([c - half, c + half])
        th = rng.uniform(0, 2 * np.pi)
        cp = rng.uniform(1.5, 4) * np.array(
            [np.sin(th), rng.uniform(-.3, .3), np.cos(th)])
        fwd = -cp / np.linalg.norm(cp)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        pose = np.concatenate([R, (-R @ cp)[:, None]], 1)
        f = rng.uniform(0.6, 1.6) * max(H, W)
        K = np.array([[f, 0, W / 2 + rng.randn() * 20],
                      [0, f, H / 2 + rng.randn() * 20], [0, 0, 1]])
        ref = j_bound_mask(bounds, K, pose, H, W)
        got = get_bound_2d_mask(bounds, K, pose, H, W)
        corners = imgproc_corners(bounds, K, pose)
        off = ((corners < 0) | (corners >= [W, H])).any()
        partly_off += bool(off)
        np.testing.assert_array_equal(got, ref, err_msg=str(t))
    assert partly_off > 50


def test_fill_poly_matches_cv2_on_3000_random_polygons():
    rng = np.random.RandomState(0)
    clipped = 0
    for t in range(3000):
        H, W = [(48, 48), (30, 40), (64, 50)][t % 3]
        n = rng.randint(3, 6)
        pts = np.stack([rng.randint(-W // 2, W + W // 2, n),
                        rng.randint(-H // 2, H + H // 2, n)], 1)
        ref = np.zeros((H, W), np.uint8)
        cv2.fillPoly(ref, [pts.astype(np.int32)], 1)
        got = imgproc.fill_poly(np.zeros((H, W), np.uint8), pts)
        np.testing.assert_array_equal(got, ref, err_msg=f"{t}: {pts.tolist()}")
        clipped += bool(((pts < 0) | (pts >= [W, H])).any())
    assert clipped > 2000


def imgproc_corners(bounds, K, pose):
    from sherf_tpu_torch.data.base import get_bound_corners
    xyz = get_bound_corners(bounds) @ pose[:, :3].T + pose[:, 3:].T
    xy = xyz @ K.T
    return np.round(xy[:, :2] / xy[:, 2:]).astype(int)


@pytest.mark.parametrize("hw", [(48, 48), (75, 100)])
def test_undistort_matches_cv2(hw):
    rng = np.random.RandomState(hw[1])
    H, W = hw
    K = np.array([[W * 1.1 + rng.randn() * 5, 0, W / 2 + rng.randn() * 3],
                  [0, W * 1.1 + rng.randn() * 5, H / 2 + rng.randn() * 3],
                  [0, 0, 1]])
    D = np.array([rng.randn() * 0.1, rng.randn() * 0.05, rng.randn() * 1e-3,
                  rng.randn() * 1e-3, rng.randn() * 0.01])
    img = rng.rand(H, W, 3).astype(np.float32)
    msk = (rng.rand(H, W) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(imgproc.undistort(img, K, D),
                                  cv2.undistort(img, K, D))
    np.testing.assert_array_equal(imgproc.undistort(msk, K, D),
                                  cv2.undistort(msk, K, D))


def test_rodrigues_matches_cv2():
    rng = np.random.RandomState(0)
    for scale in (0.0, 1e-9, 1e-3, 0.5, 3.0):
        for _ in range(20):
            v = rng.randn(3) * scale
            np.testing.assert_array_equal(imgproc.rodrigues(v),
                                          cv2.Rodrigues(v)[0])
