"""The port's image-folder dataset and dataset tool
(``sherf_tpu_torch/data/image_folder.py``, ``cli/dataset_tool.py``)
against the JAX package's, on the CPU, on trees and zips the tests write
with PIL.

  * ``ImageFolderDataset`` items (PNG RGB / RGBA / gray, baseline JPEG,
    24- and 32-bit BMP, in sub-folders; ``dataset.json`` labels; xflip;
    max_size) from a tree and from a zip: equal to JAX's, pixel for pixel
    and label for label.  The port decodes with its own readers; JAX with
    imageio.
  * ``dataset_tool`` for each transform at an integer shrink, at a
    non-integer one and enlarging (3x / 2x, and a non-integer factor): the
    zip's member names and ``dataset.json`` equal to JAX's, and its decoded
    pixels bit-equal to JAX's (cv2 ``INTER_AREA``) at integer shrinks and
    when enlarging, within 1 level (one uint8 step) at a non-integer
    shrink.  The zips' bytes are not compared: the two PNG encoders differ.
  * ``transform_image`` enlarging (2x, 3x, 2.5x, and one axis shrunk while
    the other grows, both ways), RGB and RGBA: bit-equal to JAX's (cv2's
    fixed-point linear pass with area coefficients).
  * A progressive JPEG's items equal to JAX's; what the port does not read
    raises ``ValueError`` naming the file: palette BMP.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from sherf_tpu.cli import dataset_tool as j_tool
from sherf_tpu.data.image_folder import ImageFolderDataset as JDataset
from sherf_tpu_torch.cli import dataset_tool as t_tool
from sherf_tpu_torch.data.bmp import decode_bmp
from sherf_tpu_torch.data.image_folder import ImageFolderDataset as TDataset
from sherf_tpu_torch.eval.png import png_bytes

LSB = 1     # one uint8 step: the most a non-integer shrink may differ


def _photo(h, w, rng):
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin((c + 2) * xx + (3 - c) * yy) for c in range(3)],
                   -1) * 100 + 128 + rng.randn(h, w, 3) * 15
    return np.clip(img, 0, 255).astype(np.uint8)


FILES = [  # name, PIL mode, format, size (h, w)
    ("a/p0.png", "RGB", "PNG", (40, 40)),
    ("a/p1.png", "RGBA", "PNG", (40, 40)),
    ("b/q0.jpg", "RGB", "JPEG", (40, 40)),
    ("b/q1.bmp", "RGB", "BMP", (40, 40)),
    ("c/r0.bmp", "RGBA", "BMP", (40, 40)),
    ("c/r1.jpeg", "RGB", "JPEG", (40, 40)),
    ("r2.png", "RGB", "PNG", (40, 40)),
]


def _write_tree(root, files, rng, labels=True):
    for name, mode, fmt, (h, w) in files:
        img = _photo(h, w, rng)
        if mode == "RGBA":
            img = np.concatenate([img, rng.randint(0, 256, (h, w, 1)).astype(
                np.uint8)], -1)
        if mode == "L":
            img = img[..., 0]
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(img, mode).save(
            path, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    if labels:
        table = [[name, i % 3] for i, (name, *_) in enumerate(files)]
        with open(os.path.join(root, "dataset.json"), "w") as f:
            json.dump({"labels": table}, f)


def _zip_tree(root, dest):
    with zipfile.ZipFile(dest, "w") as zf:
        for r, _, fs in os.walk(root):
            for f in fs:
                p = os.path.join(r, f)
                zf.write(p, os.path.relpath(p, root).replace(os.sep, "/"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder")
    _write_tree(str(root / "tree"), FILES, np.random.RandomState(0))
    _zip_tree(str(root / "tree"), str(root / "tree.zip"))
    return root


def _assert_same_items(jd, td):
    assert len(jd) == len(td)
    assert jd.image_shape == td.image_shape and jd.label_dim == td.label_dim
    for k in range(len(jd)):
        (ji, jl), (ti, tl) = jd[k], td[k]
        assert ti.dtype == ji.dtype and ti.shape == ji.shape, k
        np.testing.assert_array_equal(ti, ji, err_msg=str(k))
        assert tl.dtype == jl.dtype
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("kind", ["tree", "tree.zip"])
@pytest.mark.parametrize("kw", [
    {}, {"use_labels": True}, {"use_labels": True, "xflip": True},
    {"max_size": 4, "random_seed": 3}, {"resolution": 32, "xflip": True}],
    ids=["plain", "labels", "labels_xflip", "max_size", "resolution"])
def test_items_match_jax(tree, kind, kw):
    path = str(tree / kind)
    jd, td = JDataset(path, **kw), TDataset(path, **kw)
    try:
        assert td._files == jd._files
        _assert_same_items(jd, td)
    finally:
        td.close()


def test_gray_png_items_match_jax(tmp_path):
    files = [("g0.png", "L", "PNG", (24, 30)), ("g1.png", "L", "PNG", (24, 30))]
    _write_tree(str(tmp_path), files, np.random.RandomState(1), labels=False)
    _assert_same_items(JDataset(str(tmp_path)), TDataset(str(tmp_path)))
    assert TDataset(str(tmp_path))[0][0].shape == (24, 30, 1)


def test_bmp_reader_matches_pil(tmp_path):
    """24- and 32-bit, bottom-up and top-down rows, widths with row padding;
    the 32-bit BITFIELDS form a V5 header carries."""
    rng = np.random.RandomState(2)
    for h, w in ((5, 7), (9, 13), (16, 16)):
        for mode in ("RGB", "RGBA"):
            img = rng.randint(0, 256, (h, w, len(mode))).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img, mode).save(buf, "BMP")
            data = buf.getvalue()
            np.testing.assert_array_equal(decode_bmp(data), img[..., :3])
            # the same pixels stored top-down: negative height, rows flipped
            off = int.from_bytes(data[10:14], "little")
            stride = (w * len(mode) + 3) // 4 * 4
            rows = np.frombuffer(data[off:], np.uint8).reshape(h, stride)
            flipped = bytearray(data[:off]) + rows[::-1].tobytes()
            flipped[22:26] = (-h).to_bytes(4, "little", signed=True)
            np.testing.assert_array_equal(decode_bmp(bytes(flipped)),
                                          img[..., :3])
    # BITFIELDS with a V5 header (what GIMP writes for 32-bit with alpha)
    img = rng.randint(0, 256, (6, 5, 4)).astype(np.uint8)
    hdr = bytearray(124)
    hdr[0:4] = (124).to_bytes(4, "little")
    hdr[4:8] = (5).to_bytes(4, "little")
    hdr[8:12] = (6).to_bytes(4, "little", signed=True)
    hdr[12:14] = (1).to_bytes(2, "little")
    hdr[14:16] = (32).to_bytes(2, "little")
    hdr[16:20] = (3).to_bytes(4, "little")
    for i, m in enumerate((0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)):
        hdr[40 + 4 * i:44 + 4 * i] = m.to_bytes(4, "little")
    px = img[::-1][..., [2, 1, 0, 3]].tobytes()
    data = b"BM" + (14 + 124 + len(px)).to_bytes(4, "little") + bytes(4) + \
        (14 + 124).to_bytes(4, "little") + bytes(hdr) + px
    np.testing.assert_array_equal(decode_bmp(data), img[..., :3])
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img[..., :3])


def test_unsupported_files_raise_naming_the_file(tmp_path):
    rng = np.random.RandomState(3)
    Image.fromarray(_photo(16, 16, rng)[..., 0], "L").save(
        tmp_path / "pal.bmp", "BMP")
    with pytest.raises(ValueError, match="pal.bmp"):
        TDataset(str(tmp_path))


def test_progressive_jpeg_items_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    Image.fromarray(_photo(16, 16, rng)).save(tmp_path / "prog.jpg", "JPEG",
                                              progressive=True)
    Image.fromarray(_photo(16, 16, rng)).save(tmp_path / "prog2.jpg", "JPEG",
                                              progressive=True, quality=60,
                                              subsampling=0)
    Image.fromarray(_photo(16, 16, rng)).save(tmp_path / "p.png", "PNG")
    jd, td = JDataset(str(tmp_path)), TDataset(str(tmp_path))
    try:
        assert td._files == jd._files == ["p.png", "prog.jpg", "prog2.jpg"]
        _assert_same_items(jd, td)
    finally:
        td.close()


@pytest.mark.parametrize("transform,size,hw", [
    ("center-crop", (80, 80), (40, 40)),          # 2x
    ("center-crop", (120, 120), (40, 52)),        # 3x
    ("center-crop", (100, 100), (40, 40)),        # 2.5x
    ("center-crop", (60, 20), (40, 40)),          # x grows, y shrinks
    ("center-crop", (24, 70), (44, 40)),          # x shrinks, y grows
    ("center-crop-wide", (90, 50), (40, 60)),     # crop 60x33 -> 90x50
], ids=["2x", "3x", "2.5x", "grow_x_shrink_y", "shrink_x_grow_y", "wide"])
def test_transform_image_enlarges_like_jax(transform, size, hw,
                                           record_property):
    rng = np.random.RandomState(sum(size))
    worst = 0
    for img in (_photo(*hw, rng), rng.randint(0, 256, hw + (4,)).astype(
            np.uint8)):
        want = j_tool.transform_image(img, transform, *size)
        got = t_tool.transform_image(img, transform, *size)
        assert got.dtype == np.uint8 and got.shape == want.shape == (
            size[1], size[0], img.shape[2])
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
    record_property("max_level_diff", worst)
    assert worst == 0


def test_png_writer_round_trips_through_pil():
    rng = np.random.RandomState(4)
    for img in (rng.randint(0, 256, (7, 9, 3)), rng.randint(0, 256, (7, 9)),
                rng.randint(0, 256, (7, 9, 1))):
        img = img.astype(np.uint8)
        back = np.asarray(Image.open(io.BytesIO(png_bytes(img))))
        np.testing.assert_array_equal(back, img.reshape(back.shape))


def _tool_zip(tool, src, dest, resolution, transform, max_images=None):
    argv = ["--source", src, "--dest", dest, "--transform", transform]
    if resolution:
        argv += ["--resolution", resolution]
    if max_images:
        argv += ["--max_images", str(max_images)]
    tool.main(argv)
    with zipfile.ZipFile(dest) as zf:
        names = zf.namelist()
        manifest = json.loads(zf.read("dataset.json"))
        pixels = {n: np.asarray(Image.open(io.BytesIO(zf.read(n))))
                  for n in names if n.endswith(".png")}
    return names, manifest, pixels


@pytest.fixture(scope="module")
def wide_tree(tmp_path_factory):
    """Landscape and portrait photos: both crop branches are taken."""
    root = tmp_path_factory.mktemp("wide")
    files = [("w0.png", "RGB", "PNG", (64, 96)), ("w1.jpg", "RGB", "JPEG",
                                                  (96, 64)),
             ("w2.bmp", "RGB", "BMP", (64, 128)), ("w3.png", "RGBA", "PNG",
                                                   (128, 96))]
    _write_tree(str(root), files, np.random.RandomState(5))
    return root


@pytest.mark.parametrize("transform,resolution,exact", [
    ("copy", None, True),
    ("center-crop", "32x32", True),       # 64 -> 32 and 96 -> 32
    ("center-crop", "24x24", False),      # 64 -> 24
    ("center-crop-wide", "32x16", True),  # 64x32 crops -> 32x16
    ("center-crop-wide", "40x30", False),
    ("center-crop", "192x192", True),     # 64 -> 192 and 96 -> 192
    ("center-crop-wide", "160x120", True),  # 85x64, 64x48 ... crops grow
])
def test_dataset_tool_matches_jax(wide_tree, tmp_path, transform, resolution,
                                  exact, record_property):
    jn, jm, jp = _tool_zip(j_tool, str(wide_tree), str(tmp_path / "j.zip"),
                           resolution, transform)
    tn, tm, tp = _tool_zip(t_tool, str(wide_tree), str(tmp_path / "t.zip"),
                           resolution, transform)
    assert tn == jn and tm == jm
    assert tm["labels"] and len(tp) == 4
    worst = 0
    for name in jn:
        if not name.endswith(".png"):
            continue
        a, b = tp[name].astype(int), jp[name].astype(int)
        assert a.shape == b.shape, name
        worst = max(worst, int(np.abs(a - b).max()))
    record_property("max_level_diff", worst)
    assert worst == 0 if exact else worst <= LSB
    # the port's zip reads back through the port's dataset
    td = TDataset(str(tmp_path / "t.zip"), use_labels=True)
    try:
        for k in range(len(td)):
            img, label = td[k]
            np.testing.assert_array_equal(img, tp[f"img{k:08d}.png"][..., :3])
            assert label.shape == (3,) and label.sum() == 1
    finally:
        td.close()


def test_dataset_tool_max_images_and_zip_source(tree, tmp_path):
    jn, jm, jp = _tool_zip(j_tool, str(tree / "tree.zip"),
                           str(tmp_path / "j.zip"), "20x20", "center-crop", 3)
    tn, tm, tp = _tool_zip(t_tool, str(tree / "tree.zip"),
                           str(tmp_path / "t.zip"), "20x20", "center-crop", 3)
    assert tn == jn and tm == jm and len(tp) == 3
    for name in tp:
        np.testing.assert_array_equal(tp[name], jp[name])
