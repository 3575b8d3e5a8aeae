"""CIE L*a*b* TIFFs (photometric 8) in the port (utils/tiff.py: the host
unpacks the samples, ``lab_rgb`` converts them on the device) against
``cv2.imread(path, IMREAD_UNCHANGED)`` on the CPU, bit for bit: OpenCV
reads them through libtiff's RGBA reader (tif_getimage.c
initCIELabConversion, tif_color.c TIFFCIELab16ToXYZ and TIFFXYZToRGB with
display_sRGB), [H, W, 3] uint8 whatever the depth:

- 8- and 16-bit samples, uncompressed, LZW with predictor 2, Deflate and
  PackBits, strips and tiles cut by the edges, both byte orders;
- every 8-bit L and a* against a spread of b*, and 16-bit samples across
  the range (the float32 steps in libtiff's order, the table index
  truncated, RINT and the clamps);
- the WhitePoint: libtiff's D50 default, D65, others, and a y of 0, which
  libtiff refuses (ValueError, as cv2 returns None);
- Pillow's LAB files; signed samples (int8, as OpenCV returns them) and
  orientations;
- the kinds cv2 returns None for (1, 2 or 4 samples, extra samples,
  planar, other depths, ICC and ITU L*a*b*) raise ValueError;
- ``lab_rgb`` against an independent numpy float32 transcription of
  libtiff's arithmetic.
"""
import io

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import tiff as T
from nerfpp_tpu_torch.utils.image import read_image
from tests.torch_image_common import cv2_read, make_tiff

torch.set_num_threads(1)

LAYOUTS = ({}, {"rows_per_strip": 5}, {"tile": (16, 16)})


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


def reference(lab, bits, white=None):
    """libtiff's putcontig8bitCIELab8 / 16 in numpy float32, written from
    tif_color.c independently of the port: uint8 [..., 3]."""
    f = np.float32
    if white is None:
        s = f(96.425) + f(100.0) + f(82.468)
        white = (f(96.425) / s, f(100.0) / s)
    wx, wy = f(white[0]), f(white[1])
    x0, y0, z0 = wx / wy * f(100), f(100), (f(1) - wx - wy) / wy * f(100)
    if bits == 8:
        el = lab[..., 0].astype(np.int64) * 257
        a = lab[..., 1].astype(np.uint8).view(np.int8).astype(np.int64) * 256
        b = lab[..., 2].astype(np.uint8).view(np.int8).astype(np.int64) * 256
    else:
        el = lab[..., 0].astype(np.int64)
        a = lab[..., 1].astype(np.uint16).view(np.int16).astype(np.int64)
        b = lab[..., 2].astype(np.uint16).view(np.int16).astype(np.int64)
    big_l = el.astype(f) * f(100) / f(65535)
    y_lo = big_l * y0 / f(903.292)
    cby = np.where(big_l < f(8.856), f(7.787) * (y_lo / y0) + f(16) / f(116),
                   (big_l + f(16)) / f(116)).astype(f)
    y = np.where(big_l < f(8.856), y_lo, y0 * cby * cby * cby).astype(f)

    def comp(t, w):
        return np.where(t < f(0.2069), w * (t - f(0.13793)) / f(7.787),
                        w * t * t * t).astype(f)
    x = comp((a.astype(f) / f(256) / f(500) + cby).astype(f), x0)
    z = comp((cby - b.astype(f) / f(256) / f(200)).astype(f), z0)
    table = np.array([np.float32(255) * np.float32(
        (i / 1500) ** (1.0 / float(f(2.4)))) for i in range(1501)])
    out = []
    for m in T.SRGB_MATRIX:
        v = (m[0] * x + m[1] * y).astype(f) + (m[2] * z).astype(f)
        v = np.clip(v.astype(f), f(1), f(100))
        i = np.minimum(((v - f(1)) / (f(99) / f(1500))).astype(np.int64), 1500)
        out.append(np.minimum(np.floor(table[i].astype(np.float64) + 0.5),
                              255))
    return np.stack(out, -1).astype(np.uint8)


@pytest.mark.parametrize("bits,comp,predictor", [(8, 1, 1), (8, 5, 2),
                                                 (16, 8, 2), (16, 32773, 1)])
def test_lab_in_strips_and_tiles(tmp_path, bits, comp, predictor):
    rng = np.random.RandomState(bits + comp)
    dtype = np.uint8 if bits == 8 else np.uint16
    for i, layout in enumerate(LAYOUTS):
        h, w = rng.randint(1, 40, 2)
        lab = rng.randint(0, 1 << bits, (h, w, 3)).astype(dtype)
        got = check(tmp_path / "lab.tif", make_tiff(
            lab, "<>"[i % 2], comp, predictor, photometric=8, **layout))
        np.testing.assert_array_equal(got, reference(lab, bits))


def test_every_8_bit_l_and_a_and_16_bit_samples(tmp_path):
    el, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for b in (0, 1, 37, 127, 128, 200, 255):
        lab = np.stack([el, a, np.full_like(el, b)], -1).astype(np.uint8)
        got = check(tmp_path / "grid.tif", make_tiff(lab, comp=8,
                                                     photometric=8))
        np.testing.assert_array_equal(got, reference(lab, 8))
    rng = np.random.RandomState(3)
    lab = rng.randint(0, 65536, (256, 256, 3)).astype(np.uint16)
    lab[0, :, 0] = np.arange(0, 65536, 256)          # dark L: the linear part
    check(tmp_path / "lab16.tif", make_tiff(lab, comp=8, photometric=8))


def test_white_points(tmp_path):
    rng = np.random.RandomState(4)
    lab = rng.randint(0, 256, (9, 17, 3)).astype(np.uint8)
    for num in ([3127, 10000, 3290, 10000], [1, 3, 1, 3],
                [34567, 100000, 35850, 100000], [7, 10, 2, 10]):
        got = check(tmp_path / "wp.tif", make_tiff(
            lab, photometric=8, extra_tags=[(318, 5, num)]))
        wp = (np.float32(num[0]) / np.float32(num[1]),
              np.float32(num[2]) / np.float32(num[3]))
        np.testing.assert_array_equal(got, reference(lab, 8, wp))
    (tmp_path / "y0.tif").write_bytes(make_tiff(
        lab, photometric=8, extra_tags=[(318, 5, [1, 3, 0, 1])]))
    assert cv2.imread(str(tmp_path / "y0.tif"), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match="y0.tif.*WhitePoint"):
        read_image(tmp_path / "y0.tif", "cpu")


def test_pillow_lab_signed_samples_and_orientations(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(5)
    for h, w in ((1, 1), (13, 30), (40, 7)):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                        "LAB").save(buf, "TIFF")
        check(tmp_path / "pil.tif", buf.getvalue())
    lab = rng.randint(0, 256, (21, 37, 3)).astype(np.uint8)
    for bits, dtype in ((8, np.int8), (16, np.int16)):
        signed = check(tmp_path / "s.tif", make_tiff(
            (lab.astype(dtype) * (1 if bits == 8 else 257)), photometric=8,
            sample_format=2, tile=(16, 16)))
        assert signed.dtype == np.int8
    base = check(tmp_path / "o1.tif", make_tiff(lab, photometric=8,
                                                tile=(16, 16)))
    for o in (2, 3, 4):
        got = check(tmp_path / "o.tif", make_tiff(
            lab, photometric=8, tile=(16, 16), orientation=o))
        assert got.shape == base.shape


def test_kinds_cv2_returns_none_for_raise_value_error(tmp_path):
    u8 = np.zeros((4, 5, 3), np.uint8)
    cases = {"lab1.tif": make_tiff(u8[..., :1], photometric=8),
             "lab2.tif": make_tiff(u8[..., :2], photometric=8),
             "lab4.tif": make_tiff(np.zeros((4, 5, 4), np.uint8),
                                   photometric=8, extra=(2,)),
             "labx.tif": make_tiff(u8, photometric=8, extra=(0,)),
             "planar.tif": make_tiff(u8, photometric=8, planar=2),
             "lab32.tif": make_tiff(u8.astype(np.uint32), photometric=8),
             "lab12.tif": make_tiff(u8.astype(np.uint16), photometric=8,
                                    bits=12),
             "icc.tif": make_tiff(u8, photometric=9),
             "itu.tif": make_tiff(u8, photometric=10)}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=f"{name}.*cv2.imread returns"):
            read_image(tmp_path / name, "cpu")


def test_lab_rgb_is_libtiffs_arithmetic():
    rng = np.random.RandomState(6)
    lab8 = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    white = T.lab_white(0.3127, 0.329)
    got = T.lab_rgb(torch.from_numpy(lab8.view(np.int8)), white).numpy()
    np.testing.assert_array_equal(got, reference(
        lab8, 8, (np.float32(0.3127), np.float32(0.329))))
    lab16 = rng.randint(0, 65536, (64, 64, 3)).astype(np.uint16)
    got = T.lab_rgb(torch.from_numpy(lab16.view(np.int16)), T.lab_white(
        *(np.float32(v) / (np.float32(96.425) + np.float32(100.0)
                           + np.float32(82.468)) for v in (96.425, 100.0))))
    np.testing.assert_array_equal(got.numpy(), reference(lab16, 16))
