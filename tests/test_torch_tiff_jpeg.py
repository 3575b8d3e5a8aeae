"""JPEG-in-TIFF (compression 7) in the port (utils/tiff.py through
utils/jpeg.py) against ``cv2.imread(path, IMREAD_UNCHANGED)`` on the CPU,
bit for bit (dtype, shape, values; RGB order), on noise images at sizes
that are not multiples of 8 or 16:

- OpenCV's own files (``cv2.imwrite(..., [IMWRITE_TIFF_COMPRESSION, 7])``:
  photometric RGB, JPEGTables, an abbreviated stream in the strip);
- hand-built files (tests/torch_image_common.py ``make_tiff``) of
  cv2.imencode's streams: photometric YCbCr at 4:2:0, 4:2:2 and 4:4:4,
  gray (MinIsBlack and MinIsWhite) and RGB, one whole stream a strip or
  tile, or abbreviated streams primed by JPEGTables, strips of rows that
  are not a multiple of the MCU height, tiles cut by the edges, both byte
  orders and BigTIFF;
- the photometric, not the stream's markers, decides the colour
  conversion (a JFIF stream under photometric RGB comes back unconverted);
- the host and device parts apart, and the tables of JPEGTables replaced
  by a stream's own;
- malformed kinds and the kinds cv2.imread returns None for raise,
  naming the file (planar RGB and YCbCr 1x1 JPEG-in-TIFF, read since
  TIFF was closed, are in tests/test_torch_tiff_rare.py).
"""
import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg as J
from nerfpp_tpu_torch.utils import tiff as T
from nerfpp_tpu_torch.utils.image import read_image
from tests.torch_image_common import (boxes_of, cv2_read, make_tiff,
                                      split_jpeg)

torch.set_num_threads(1)

SAMPLING = {(2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            (1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def encode(img, sampling=(2, 2), quality=90):
    """cv2.imencode(".jpg") of an RGB or gray image."""
    if img.ndim == 3:
        img = np.ascontiguousarray(img[..., ::-1])
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         SAMPLING[sampling]])
    assert ok
    return buf.tobytes()


def jpeg_tiff(img, sampling=(2, 2), photometric=6, abbreviated=False,
              bo="<", version=42, **layout):
    """A compression-7 TIFF of ``img`` (RGB [h, w, 3] or gray [h, w]): each
    strip or tile (zero-padded to its box) a cv2.imencode stream, whole or
    split into JPEGTables and abbreviated streams."""
    h, w = img.shape[:2]
    chunks = []
    for y, x, rows, cols in boxes_of(h, w, **layout):
        box = np.zeros((rows, cols) + img.shape[2:], np.uint8)
        part = img[y:y + rows, x:x + cols]
        box[:part.shape[0], :part.shape[1]] = part
        chunks.append(encode(box, sampling))
    tags = []
    if photometric == 6:
        tags.append((530, 3, list(sampling)))
    if abbreviated:
        split = [split_jpeg(c) for c in chunks]
        tables = {t for t, _ in split}
        assert len(tables) == 1
        tags.append((347, 7, tables.pop()))
        chunks = [s for _, s in split]
    samples = img if img.ndim == 3 else img[..., None]
    return make_tiff(samples, bo, 7, photometric=photometric, chunks=chunks,
                     extra_tags=tags, version=version, **layout)


def check(path, data):
    path.write_bytes(data)
    want = cv2_read(path)
    assert want is not None, path
    got = T.read_tiff(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(path, "cpu").numpy(), want)
    return got


def noise(rng, h, w, c=3):
    return rng.randint(0, 256, (h, w, c) if c > 1 else (h, w)).astype(
        np.uint8)


def test_opencvs_own_compression_7_files(tmp_path):
    rng = np.random.RandomState(0)
    for (h, w), c in (((1, 1), 3), ((7, 5), 3), ((37, 45), 3),
                      ((23, 61), 1), ((40, 33), 1)):
        img = noise(rng, h, w, c)
        path = tmp_path / "cv.tif"
        assert cv2.imwrite(str(path), img[..., ::-1] if c == 3 else img,
                           [cv2.IMWRITE_TIFF_COMPRESSION, 7])
        _, tags = T._ifd(path, path.read_bytes())
        assert tags[T.COMPRESSION] == (7,) and T.JPEG_TABLES in tags
        assert tags[T.PHOTOMETRIC] == ((2,) if c == 3 else (1,))
        got = check(path, path.read_bytes())
        assert got.shape == img.shape


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 1)])
def test_ycbcr_streams_in_strips_and_tiles(sampling, tmp_path):
    rng = np.random.RandomState(sum(sampling))
    for (h, w), layout, bo in (((48, 32), {}, "<"),
                               ((37, 29), {"rows_per_strip": 16}, ">"),
                               ((37, 29), {"rows_per_strip": 12}, "<"),
                               ((45, 37), {"rows_per_strip": 8}, ">"),
                               ((37, 45), {"tile": (16, 16)}, "<"),
                               ((21, 50), {"tile": (32, 16)}, ">")):
        img = noise(rng, h, w)
        got = check(tmp_path / "y.tif", jpeg_tiff(img, sampling, bo=bo,
                                                  **layout))
        if not layout:                  # one stream: cv2.imdecode's pixels
            want = cv2.imdecode(np.frombuffer(encode(img, sampling),
                                              np.uint8), cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(got, want[..., ::-1])


def test_abbreviated_streams_primed_by_jpeg_tables(tmp_path):
    rng = np.random.RandomState(3)
    for c, sampling, photo, layout, version in (
            (3, (2, 2), 6, {"rows_per_strip": 16}, 42),
            (3, (2, 1), 6, {"tile": (16, 16)}, 43),
            (3, (1, 1), 2, {"rows_per_strip": 8}, 42),
            (1, (2, 2), 1, {"tile": (16, 32)}, 42),
            (1, (2, 2), 0, {"rows_per_strip": 24}, 43)):
        img = noise(rng, 35, 27, c)
        whole = check(tmp_path / "whole.tif", jpeg_tiff(
            img, sampling, photo, version=version, **layout))
        short = check(tmp_path / "short.tif", jpeg_tiff(
            img, sampling, photo, abbreviated=True, version=version,
            **layout))
        np.testing.assert_array_equal(short, whole)


def test_gray_streams_and_min_is_white(tmp_path):
    rng = np.random.RandomState(4)
    for (h, w), layout in (((5, 3), {}), ((37, 29), {"rows_per_strip": 16}),
                           ((37, 45), {"tile": (16, 16)})):
        img = noise(rng, h, w, 1)
        black = check(tmp_path / "g.tif", jpeg_tiff(img, photometric=1,
                                                    **layout))
        white = check(tmp_path / "w.tif", jpeg_tiff(img, photometric=0,
                                                    **layout))
        np.testing.assert_array_equal(white, 255 - black)
        assert black.shape == (h, w)


def test_the_photometric_decides_the_colour_conversion(tmp_path):
    rng = np.random.RandomState(5)
    img = noise(rng, 29, 37)
    ycc = check(tmp_path / "ycc.tif", jpeg_tiff(img, (1, 1), 6,
                                                rows_per_strip=16))
    raw = check(tmp_path / "rgb.tif", jpeg_tiff(img, (1, 1), 2,
                                                rows_per_strip=16))
    # a JFIF (YCbCr) stream under photometric RGB: its samples as they are
    frames = [J.decode_coefficients(encode(img[y:y + 16], (1, 1)))
              for y in range(0, 29, 16)]
    for f in frames:
        f.colour = "rgb"
    want = np.concatenate([J.frame_pixels(f, "cpu").numpy()
                           for f in frames])
    np.testing.assert_array_equal(raw, want)
    assert not np.array_equal(raw, ycc)
    path = tmp_path / "sub.tif"              # libtiff wants 1x1 under RGB
    path.write_bytes(jpeg_tiff(img, (2, 2), 2))
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match="sub.tif.*sampling factors"):
        read_image(path, "cpu")


def test_host_and_device_parts_and_table_replacement(tmp_path):
    rng = np.random.RandomState(6)
    img = noise(rng, 40, 52)
    path = tmp_path / "t.tif"
    path.write_bytes(jpeg_tiff(img, (2, 2), abbreviated=True, tile=(32, 16)))
    dec = T.decode_tiff(path)
    assert dec.stage == "jpeg" and len(dec.frames) == 6
    np.testing.assert_array_equal(T.tiff_pixels(dec, "cpu").numpy(),
                                  cv2_read(path))
    # a stream's own DQT and DHT replace JPEGTables' (libjpeg's order)
    a, b = encode(img, quality=90), encode(img, quality=40)
    tables_a, _ = split_jpeg(a)
    frame = J.decode_coefficients(b, "b", tables=tables_a)
    np.testing.assert_array_equal(J.frame_pixels(frame, "cpu").numpy(),
                                  J.frame_pixels(J.decode_coefficients(b),
                                                 "cpu").numpy())
    with pytest.raises(ValueError, match="t.tif.*tables without an EOI"):
        J.decode_coefficients(split_jpeg(b)[1], "t.tif",
                              tables=tables_a[:-2])


def test_unread_and_malformed_jpeg_tiffs_raise_naming_the_file(tmp_path):
    rng = np.random.RandomState(7)
    img = noise(rng, 16, 16)
    planar = jpeg_tiff(img, (1, 1), 2)
    cases = {"planar.tif": (make_tiff(img, comp=7, planar=2, photometric=6,
                                      chunks=[encode(img[..., k])
                                              for k in range(3)]),
                            ValueError, "planar YCbCr JPEG-in-TIFF "
                            "subsampled 2x2"),
             "ojpeg.tif": (planar.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00"
                                          b"\x07", b"\x03\x01\x03\x00\x01"
                                          b"\x00\x00\x00\x06"),
                           ValueError, "old-style JPEG"),
             "gray3.tif": (make_tiff(img[..., :1], comp=7,
                                     chunks=[encode(img)]), ValueError,
                           "3 components in a 16x16 box of 1 samples")}
    for name, (data, kind, what) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(kind, match=f"{name}.*{what}"):
            read_image(tmp_path / name, "cpu")
