"""Signed, 32-bit and float TIFF in the port (utils/tiff.py) and the
resampling of such images (utils/image.py) against OpenCV on the CPU.

- ``read_tiff`` returns what ``cv2.imread(path, IMREAD_UNCHANGED)`` returns
  for int8, int16, int32, uint32, float32 and float64 samples (RGB(A)
  order): both byte orders, none / LZW / Deflate / PackBits, predictor 2
  and, on floats, the floating-point predictor 3, chunky and (at 8 bits)
  planar, MinIsBlack and MinIsWhite (int8 inverted, as 8-bit images are),
  strips and tiles, built with tests/torch_image_common.py ``make_tiff``;
- ``write_tiff`` of every such dtype reads back to the same pixels in cv2
  and in the port;
- ``undistort`` of float32, float64 and int16 images is cv2.undistort's bit
  for bit, ``resize_stored`` of int16 cv2.resize's bit for bit and of
  float32 / float64 within 1e-6 of the image's largest magnitude; int8,
  int32 and uint32 are refused by both;
- a half-float TIFF (cv2 returns None) and the kinds still unread raise,
  naming the file.
"""
import itertools

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import image as I
from nerfpp_tpu_torch.utils import tiff as T
from tests.torch_image_common import cv2_read, hdr_image, make_tiff

torch.set_num_threads(1)

DTYPES = ["i1", "i2", "i4", "u4", "f4", "f8"]


def sample(rng, dtype, shape):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.randn(*shape) * np.exp(rng.randn(*shape) * 3)).astype(dt)
    info = np.iinfo(dt)
    return rng.randint(info.min, info.max + 1, shape, np.int64).astype(dt)


@pytest.mark.parametrize("dtype", DTYPES)
def test_samples_read_as_opencv_reads_them(dtype, tmp_path):
    rng = np.random.RandomState(DTYPES.index(dtype))
    floating = dtype[0] == "f"
    checked = 0
    for spp, bo, comp, pred, planar, layout in itertools.product(
            (1, 3, 4), "<>", (1, 5, 8, 32773), (1, 2, 3), (1, 2),
            ("strips", "tiles")):
        if pred == 3 and not floating or pred > 1 and comp in (1, 32773):
            continue
        if planar == 2 and (spp == 1 or dtype != "i1"):
            continue             # deeper planar RGB(A) is refused (below)
        for photo in ((1, 0) if spp == 1 else (2,)):
            h, w = rng.randint(1, 30, 2)
            img = sample(rng, dtype, (h, w, spp))
            path = tmp_path / "v.tif"
            path.write_bytes(make_tiff(
                img, bo, comp, pred, planar, photometric=photo,
                extra=(2,) if spp == 4 and rng.rand() < 0.5 else None,
                **({"tile": (16, 16)} if layout == "tiles"
                   else {"rows_per_strip": 4})))
            want = cv2_read(path)
            got = T.read_tiff(path)
            assert got.dtype == want.dtype == img.dtype
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            checked += 1
    assert checked >= 40


def test_writes_read_back_in_opencv_and_the_port(tmp_path):
    rng = np.random.RandomState(6)
    for dtype in ["u1", "u2"] + DTYPES:
        for c, (h, w) in itertools.product((1, 3, 4), ((1, 1), (9, 5),
                                                        (40, 33))):
            img = sample(rng, dtype, (h, w, c))
            img = img[..., 0] if c == 1 else img
            I.write_image(tmp_path / "a.tif", torch.from_numpy(img), "cpu")
            want = cv2_read(tmp_path / "a.tif")
            assert want.dtype == img.dtype
            np.testing.assert_array_equal(want, img)
            np.testing.assert_array_equal(
                I.read_image(tmp_path / "a.tif", "cpu").numpy(), img)
    _, tags = T._ifd("a.tif", (tmp_path / "a.tif").read_bytes())
    assert tags[T.SAMPLE_FORMAT] == (3,) * 4 and tags[T.COMPRESSION] == (1,)


def test_float_and_int16_resampling_is_opencvs(tmp_path):
    rng = np.random.RandomState(7)
    for dtype, c, (h, w) in itertools.product(
            ("f4", "f8", "i2"), (1, 3), ((24, 26), (37, 29))):
        img = (sample(rng, dtype, (h, w, c)) if dtype == "i2"
               else hdr_image(h, w, h + c).astype(dtype)[..., :c])
        img = img[..., 0] if c == 1 else img
        k = np.array([[1.1 * w, 0, w / 2 + 0.3], [0, 1.1 * w, h / 2 - 0.7],
                      [0, 0, 1]])
        d = (0.1, -0.05, 0.01, 0.005)
        nk = I.optimal_new_camera_matrix(k, d, (w, h), 0.0, "cpu")
        got = I.undistort(torch.from_numpy(img), k, d, nk).numpy()
        want = cv2.undistort(img, k, np.array(d), None, nk)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for oh, ow in ((h // 2, w // 2), (h + 7, w - 5), (2 * h + 1, 3 * w)):
            got = I.resize_stored(torch.from_numpy(img), (oh, ow)).numpy()
            want = cv2.resize(img, (ow, oh))
            assert got.dtype == want.dtype and got.shape == want.shape
            if dtype == "i2":
                np.testing.assert_array_equal(got, want)
            else:               # the documented float resize tolerance
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=1e-6 * np.abs(img).max())
    for dtype in ("i1", "i4", "u4"):
        img = sample(rng, dtype, (8, 8, 3))
        with pytest.raises(cv2.error):
            cv2.undistort(img, np.eye(3), np.zeros(4))
        with pytest.raises(cv2.error):
            cv2.resize(img, (4, 4))
        with pytest.raises(TypeError, match="cv2.undistort refuses"):
            I.undistort(torch.from_numpy(img), np.eye(3), np.zeros(4),
                        np.eye(3))
        with pytest.raises(TypeError, match="cv2.resize refuses"):
            I.resize_stored(torch.from_numpy(img), (4, 4))


def test_unread_kinds_raise_naming_the_file(tmp_path):
    half = make_tiff(np.zeros((4, 4, 3), np.float16))
    (tmp_path / "half.tif").write_bytes(half)
    assert cv2.imread(str(tmp_path / "half.tif"), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match=r"half\.tif.*half-float"):
        I.read_image(tmp_path / "half.tif", "cpu")
    cases = {"complex.tif": (make_tiff(np.zeros((4, 4, 1), np.float32),
                                       sample_format=6), ValueError,
                             "complex float samples"),
             "planar.tif": (make_tiff(np.zeros((4, 4, 3), np.float32),
                                      planar=2), NotImplementedError,
                            "32-bit planar"),
             "pred3.tif": (make_tiff(np.zeros((4, 4, 1), np.int16), comp=8,
                                     extra_tags=[(317, 3, [3])]), ValueError,
                           "signed samples with predictor 3")}
    for name, (data, error, kind) in cases.items():
        (tmp_path / name).write_bytes(data)
        if error is ValueError:                 # cv2.imread returns None
            assert cv2.imread(str(tmp_path / name),
                              cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(error, match=f"{name}.*{kind}"):
            I.read_image(tmp_path / name, "cpu")
    # 64-bit integers are read since TIFF was closed
    i64 = make_tiff(np.arange(16, dtype=np.int64).reshape(4, 4, 1) - 8)
    (tmp_path / "i64.tif").write_bytes(i64)
    np.testing.assert_array_equal(I.read_image(tmp_path / "i64.tif",
                                               "cpu").numpy(),
                                  cv2.imread(str(tmp_path / "i64.tif"),
                                             cv2.IMREAD_UNCHANGED))
