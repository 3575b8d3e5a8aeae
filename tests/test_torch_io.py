"""Port parity: image I/O (utils/png.py), the Blender loader and writer,
load_images with half_res, and MetricsWriter.

The port reads and writes PNG with zlib and numpy; OpenCV, which the JAX
package uses, is imported here only, as the reference: the reader bitwise
against cv2.imread on files cv2.imwrite writes (its default row filter and
adaptive ones) and on files with every row filter, the writer
round-tripped through cv2.imread; then the port's Blender export loaded by
both packages' loaders, load_images (alpha, white background, the half_res
halving) against the JAX load_images, and the metrics CSV written by both
writers.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest

from nerfpp_tpu.data import blender as JB
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.utils.metrics import MetricsWriter as JaxMetricsWriter
from nerfpp_tpu_torch.data import blender as TB
from nerfpp_tpu_torch.data import dataset as TD
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils.metrics import MetricsWriter
from nerfpp_tpu_torch.utils.png import png_shape, read_png, write_png


def _image(h, w, c, seed):
    """Smooth gradients, a sharp edge and noise: libpng's adaptive
    filtering picks several row filters on it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3 + 40 * k) % 256 for k in range(c)], -1)
    base[h // 3:, w // 2:] = rng.randint(0, 256, (h - h // 3, w - w // 2, c))
    return base.astype(np.uint8)


def _filters_of(path):
    """The row filter bytes of a PNG written as one IDAT stream."""
    h, w, c = png_shape(path)
    data = path.read_bytes()
    idat = b""
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, 1 + w * c)[:, 0]


def _write_filtered(path, img, kinds):
    """A PNG whose row r is filtered with kinds[r] (0 none, 1 Sub, 2 Up,
    3 Average, 4 Paeth), computed from the original pixels."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, c = img.shape
    pad = np.zeros((h + 1, w + 1, c), np.int16)
    pad[1:, 1:] = img
    a, b, cc = pad[1:, :-1], pad[:-1, 1:], pad[:-1, :-1]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(a), a, b, (a + b) >> 1, paeth]
    rows = b"".join(
        bytes([k]) + ((img[r].astype(np.int16) - preds[k][r]) & 0xFF)
        .astype(np.uint8).tobytes() for r, k in enumerate(kinds))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    ctype = {1: 0, 3: 2, 4: 6}[c]
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows))
                     + chunk(b"IEND", b""))


def _cv2_rgb(img):
    """RGB(A) -> the BGR(A) order cv2 reads and writes."""
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[-1]]]


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_reader_matches_cv2_on_cv2_files(tmp_path, channels, adaptive):
    # cv2's default row filter (Sub), and libpng's adaptive choice per row
    img = _image(29, 31, channels, channels)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / "a.png"
    flags = ([cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]
             if adaptive else [])
    assert cv2.imwrite(str(path), _cv2_rgb(img), flags)
    if adaptive:
        assert len(set(_filters_of(path).tolist())) > 2  # mixed row filters
    got = read_png(path)
    np.testing.assert_array_equal(
        got, _cv2_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)))
    assert png_shape(path) == (29, 31, channels)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_reader_undoes_every_row_filter(tmp_path, kind, channels):
    img = _image(23, 17, channels, 7)
    kinds = (np.random.RandomState(3).randint(0, 5, 23) if kind == "mixed"
             else [kind] * 23)
    path = tmp_path / "f.png"
    _write_filtered(path, img, kinds)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(_cv2_rgb(ref), want)
    np.testing.assert_array_equal(read_png(path), want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_writer_round_trips_through_cv2(tmp_path, channels):
    img = _image(20, 24, channels, 11)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / "w.png"
    write_png(path, img)
    np.testing.assert_array_equal(
        _cv2_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_reader_refuses_what_it_does_not_read(tmp_path):
    # every PNG kind is read (tests/test_torch_png_kinds.py); an unknown
    # critical chunk is a kind the reader cannot take, and raises
    # NotImplementedError naming the file and the chunk
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), np.zeros((4, 4, 3), np.uint16))
    assert read_png(deep).dtype == np.uint16
    data = deep.read_bytes()
    crit = struct.pack(">I", 2) + b"ABCD\0\0" + struct.pack(
        ">I", zlib.crc32(b"ABCD\0\0") & 0xFFFFFFFF)
    odd = tmp_path / "odd.png"
    odd.write_bytes(data[:33] + crit + data[33:])
    with pytest.raises(NotImplementedError, match="odd.png.*ABCD"):
        read_png(odd)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="bad.png: not a PNG"):
        read_png(bad)
    with pytest.raises(FileNotFoundError):
        read_png(tmp_path / "missing.png")
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "x.png", np.zeros((2, 2, 3), np.float32))


def _scene(channels=3):
    sc = make_synthetic_scene(n_train=3, n_val=1, n_test=2, image_hw=24,
                              n_samples=16, white_bkgr=False, device="cpu")
    if channels == 4:
        # an alpha that varies over the image, so compositing matters
        alpha = np.linspace(0.0, 1.0, 24 * 24, dtype=np.float32)
        alpha = np.broadcast_to(alpha.reshape(1, 24, 24, 1),
                                sc.images.shape[:3] + (1,))
        sc.images = np.concatenate([sc.images, alpha], -1)
    return sc


@pytest.mark.parametrize("half_res", [False, True])
def test_blender_export_loads_as_in_jax(tmp_path, half_res):
    sc = _scene()
    TB.export_blender_scene(sc, tmp_path / "port")
    kw = dict(half_res=half_res, testskip=False)
    ts = TB.load_blender_data(tmp_path / "port", **kw)
    js = JB.load_blender_data(tmp_path / "port", **kw)
    assert ts.splits_idx == js.splits_idx == [3, 1, 2]
    for tv, jv in zip(ts.views, js.views):
        assert (tv.id, tv.h, tv.w, tv.image_path) == (jv.id, jv.h, jv.w,
                                                      jv.image_path)
        assert tv.focal == pytest.approx(jv.focal, rel=1e-12)
        assert (tv.near, tv.far) == (jv.near, jv.far)
        np.testing.assert_array_equal(tv.pose, jv.pose)
        np.testing.assert_allclose(tv.k, jv.k, rtol=1e-6)
    # the corner rays in f32 in both packages
    np.testing.assert_allclose(ts.bounding_box, js.bounding_box, rtol=1e-5,
                               atol=1e-5)
    assert (ts.views[0].h, ts.views[0].w) == ((12, 12) if half_res
                                              else (24, 24))
    # the JAX exporter writes the same pixels
    JB.export_blender_scene(sc, tmp_path / "jax")
    for split, n in (("train", 3), ("val", 1), ("test", 2)):
        for j in range(n):
            rel = f"{split}/r_{j}.png"
            np.testing.assert_array_equal(read_png(tmp_path / "port" / rel),
                                          read_png(tmp_path / "jax" / rel))
    assert len(TB.load_blender_data(tmp_path / "port").views) == 4  # testskip


@pytest.mark.parametrize("white_bkgr", [False, True])
@pytest.mark.parametrize("half_res", [False, True])
def test_load_images_match_jax(tmp_path, white_bkgr, half_res):
    # RGBA frames: alpha dropped, or composited onto white; half_res is
    # cv2's INTER_LINEAR at exactly 1/2 in the JAX package, the rounded 2x2
    # mean here: within 1/255 (the same 8-bit value, or its neighbour)
    TB.export_blender_scene(_scene(channels=4), tmp_path)
    ts = TB.load_blender_data(tmp_path, half_res=half_res,
                              white_bkgr=white_bkgr)
    js = JB.load_blender_data(tmp_path, half_res=half_res,
                              white_bkgr=white_bkgr)
    idx = list(range(len(ts.views)))
    got = TD.load_images(ts, idx, device="cpu")
    want = JD.load_images(js, idx)
    assert got.shape == want.shape == (len(idx),) + ((12, 12, 3) if half_res
                                                      else (24, 24, 3))
    assert got.dtype == np.float32
    tol = 1.0 / 255 + 1e-6 if half_res else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if half_res:
        assert np.mean(np.abs(got - want) < 1e-6) > 0.9


def test_export_refuses_mixed_intrinsics(tmp_path):
    sc = _scene()
    sc.views[1].k = sc.views[1].k * np.float32(1.5)
    with pytest.raises(ValueError, match="mixes intrinsics"):
        TB.export_blender_scene(sc, tmp_path)


def test_metrics_writer_matches_jax(tmp_path):
    rows = [(5, {"loss": 0.5, "psnr": 10.25}),
            (10, {"loss": 0.25, "psnr": 12.5, "mse": 0.125}),  # widens
            (15, {"loss": 0.125})]
    for cls, sub in ((MetricsWriter, "port"), (JaxMetricsWriter, "jax")):
        w = cls(tmp_path / sub)
        for step, m in rows[:2]:
            w.write_scalars(step, m)
        cls(tmp_path / sub).write_scalars(*rows[2])            # resumed
    assert ((tmp_path / "port" / "metrics.csv").read_text()
            == (tmp_path / "jax" / "metrics.csv").read_text())
    img = np.random.RandomState(0).uniform(-0.2, 1.2, (8, 10, 3))
    MetricsWriter(tmp_path / "port").write_image(7, "val_rgb", img)
    JaxMetricsWriter(tmp_path / "jax").write_image(7, "val_rgb", img)
    name = "images/val_rgb_00000007.png"
    np.testing.assert_array_equal(read_png(tmp_path / "port" / name),
                                  read_png(tmp_path / "jax" / name))
