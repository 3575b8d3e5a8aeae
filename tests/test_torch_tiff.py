"""TIFF in the port (utils/tiff.py, csrc/tiff_codec.cpp) against OpenCV's
libtiff on the CPU: ``read_tiff`` must return what ``cv2.imread(path,
IMREAD_UNCHANGED)`` returns (RGB(A) order, uint16 at 16 bits), and the
port's writes must read back in cv2 to the same pixels.

- cv2's own files (LZW, predictor 2, one strip) at 8 and 16 bits, gray,
  RGB and RGBA;
- hand-built variants (tests/torch_image_common.py ``make_tiff``):
  little- and big-endian, strips of several rows and tiles, planar, none,
  Deflate (8 and 32946) and PackBits, predictor 2 (ignored by libtiff
  without LZW or Deflate), MinIsWhite (inverted at 8 bits only), RGBA with
  ExtraSamples 0, 1 or 2 (premultiplied at 8 bits when unassociated), and
  8-bit palettes of 8- and 16-bit entries;
- LZW both ways, past a full code table;
- refusals naming the file and the kind: BigTIFF, JPEG-in-TIFF, float
  and 32-bit samples, CMYK, subsampled YCbCr, gray with alpha, 16-bit
  planar RGB;
- the committed TIFF fixtures under tests/data/image.
"""
import itertools
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import tiff as T
from nerfpp_tpu_torch.utils.image import image_format, read_image, write_image
from tests.torch_image_common import (FIXTURES, cv2_read, fixture_files,
                                      make_tiff)

torch.set_num_threads(1)


def check(path, data):
    path.write_bytes(data)
    want = cv2_read(path)
    got = T.read_tiff(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    return got


def test_opencvs_own_files(tmp_path):
    rng = np.random.RandomState(0)
    for dtype, c, (h, w) in itertools.product(
            (np.uint8, np.uint16), (1, 3, 4), ((1, 1), (7, 5), (61, 90))):
        img = rng.randint(0, np.iinfo(dtype).max + 1, (h, w, c)).astype(dtype)
        img = img[..., 0] if c == 1 else img
        path = tmp_path / "cv.tif"
        assert cv2.imwrite(str(path), img[..., [2, 1, 0, 3][:c]]
                           if c > 1 else img)
        np.testing.assert_array_equal(check(path, path.read_bytes()), img)
        assert image_format(path) == "tiff"


LAYOUTS = {"strip": {}, "strips of 4": {"rows_per_strip": 4},
           "tiles": {"tile": (16, 16)}}


@pytest.mark.parametrize("dtype,spp", [(np.uint8, 1), (np.uint8, 3),
                                       (np.uint8, 4), (np.uint16, 1),
                                       (np.uint16, 3), (np.uint16, 4)])
def test_variants_read_as_opencv_reads_them(dtype, spp, tmp_path):
    rng = np.random.RandomState(spp + 8 * (dtype == np.uint16))
    photometrics = (1, 0) if spp == 1 else (2,)
    extras = (None, (0,), (1,), (2,)) if spp == 4 else (None,)
    planars = (1,) if dtype == np.uint16 and spp > 1 else (1, 2)
    for bo, comp, pred, planar, layout, photo, extra in itertools.product(
            "<>", (1, 8, 32946, 32773), (1, 2), planars, LAYOUTS,
            photometrics, extras):
        h, w = rng.randint(1, 30, 2)
        img = rng.randint(0, np.iinfo(dtype).max + 1,
                          (h, w, spp)).astype(dtype)
        check(tmp_path / "v.tif", make_tiff(
            img, bo, comp, pred, planar, photometric=photo, extra=extra,
            **LAYOUTS[layout]))


def test_palettes_and_the_marks_of_opencvs_two_paths(tmp_path):
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 256, (13, 9, 1)).astype(np.uint8)
    for cmap in (rng.randint(0, 65536, (3, 256)), rng.randint(0, 256,
                                                               (3, 256))):
        got = check(tmp_path / "p.tif", make_tiff(
            idx, photometric=3, colormap=cmap.astype(np.uint16)))
        scale = 8 if cmap.max() >= 256 else 0
        np.testing.assert_array_equal(got, (cmap.T >> scale)[idx[..., 0]])
    g8 = rng.randint(0, 256, (5, 6, 1)).astype(np.uint8)
    g16 = g8.astype(np.uint16) * 257
    np.testing.assert_array_equal(check(tmp_path / "w8.tif", make_tiff(
        g8, photometric=0)), 255 - g8[..., 0])          # inverted
    np.testing.assert_array_equal(check(tmp_path / "w16.tif", make_tiff(
        g16, photometric=0)), g16[..., 0])              # as stored
    rgba = rng.randint(0, 256, (5, 6, 4)).astype(np.uint8)
    got = check(tmp_path / "u.tif", make_tiff(rgba, extra=(2,)))
    a = rgba[..., 3:].astype(np.int64)
    np.testing.assert_array_equal(got[..., :3],
                                  (rgba[..., :3] * a + 127) // 255)


def test_writes_read_back_in_opencv_and_the_port(tmp_path):
    rng = np.random.RandomState(4)
    for dtype, c, (h, w) in itertools.product(
            (np.uint8, np.uint16), (1, 3, 4), ((1, 1), (9, 5), (120, 160))):
        img = rng.randint(0, 64, (h, w, c)).cumsum(1).astype(dtype)
        img = img[..., 0] if c == 1 else img
        for name in ("a.tif", "a.tiff"):
            write_image(tmp_path / name, torch.from_numpy(img), "cpu")
            np.testing.assert_array_equal(cv2_read(tmp_path / name), img)
            back = read_image(tmp_path / name, "cpu")
            assert back.dtype == (torch.uint8 if dtype == np.uint8
                                  else torch.uint16)
            np.testing.assert_array_equal(back.numpy(), img)
    _, tags = T._ifd("a.tif", (tmp_path / "a.tif").read_bytes())
    assert tags[T.COMPRESSION] == (5,) and tags[T.PREDICTOR] == (2,)
    assert tags[T.ROWS_PER_STRIP] == (120,) and len(tags[T.STRIP_OFFSETS]) == 1


def test_lzw_round_trips_past_a_full_table():
    rng = np.random.RandomState(5)
    for data in (rng.randint(0, 256, 100_000).astype(np.uint8).tobytes(),
                 bytes(70_000), rng.randint(0, 3, 200_000).astype(
                     np.uint8).tobytes(), b"", b"\x07"):
        enc = T.lzw_encode(data)
        assert T.lzw_decode(enc, len(data)) == data
        assert T.lzw_decode(enc, len(data) // 2) == data[:len(data) // 2]
    assert T.packbits_decode(bytes([2, 1, 2, 3, 0xFE, 9, 0x80]), 10) == bytes(
        [1, 2, 3, 9, 9, 9])


def test_still_unread_kinds_raise_naming_the_file(tmp_path):
    img8 = np.zeros((4, 4, 3), np.uint8)
    cases = {
        "big.tif": (b"II+\x00\x08\x00\x00\x00" + bytes(16), "BigTIFF"),
        "jpeg.tif": (make_tiff(img8, extra_tags=[]).replace(
            b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
            b"\x03\x01\x03\x00\x01\x00\x00\x00\x07\x00"), "JPEG-in-TIFF"),
        "float.tif": (make_tiff(img8, extra_tags=[(339, 3, [3, 3, 3])]),
                      "float samples"),
        "deep.tif": (make_tiff(np.zeros((4, 4, 1), np.uint8), extra_tags=[
            ]).replace(b"\x02\x01\x03\x00\x01\x00\x00\x00\x08\x00",
                       b"\x02\x01\x03\x00\x01\x00\x00\x00\x20\x00"),
                     "32-bit samples"),
        "cmyk.tif": (make_tiff(np.zeros((4, 4, 4), np.uint8),
                               photometric=5), "CMYK"),
        "ycc.tif": (make_tiff(img8, photometric=6,
                              extra_tags=[(530, 3, [2, 2])]), "YCbCr"),
        "ga.tif": (make_tiff(np.zeros((4, 4, 2), np.uint8), photometric=1,
                             extra=(2,)), "gray with alpha"),
        "planar16.tif": (make_tiff(np.zeros((4, 4, 3), np.uint16), planar=2),
                         "16-bit planar")}
    for name, (data, kind) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(NotImplementedError, match=f"{name}.*{kind}"):
            read_image(tmp_path / name, "cpu")
    with pytest.raises(ValueError, match="uint8 or uint16"):
        T.write_tiff(tmp_path / "f.tif", np.zeros((2, 2), np.float32))


def test_committed_fixtures_match_opencv_and_the_port():
    for name, data in fixture_files().items():
        if not name.endswith(".tif"):
            continue
        assert (FIXTURES / name).read_bytes() == data, name
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(FIXTURES / name), want)
        got = T.read_tiff(FIXTURES / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
