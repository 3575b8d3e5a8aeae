"""Port parity: OpenCV's resampling in PyTorch (utils/image.py) against cv2
5.0.0 on the CPU: the 8- and 16-bit resizes and the new camera matrices
and undistorted images bit for bit, the float resize within 1e-6; and the
COLMAP loader's .txt model as the JAX test writes it, and its SfM
shell-out without a colmap binary.
"""
import itertools
import shutil

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu.data import colmap as JC
from nerfpp_tpu_torch.data import colmap as PC
from nerfpp_tpu_torch.utils import image as I
from tests.torch_colmap_common import RESIZES, _same_reconstruction

torch.set_num_threads(1)


def test_txt_model_as_the_jax_test_writes_it(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 64 48 60.0 61.0 32.0 24.0\n")
    (tmp_path / "images.txt").write_text(
        "# comment\n1 1 0 0 0 0.5 0.5 0.5 1 img.png\n"
        "1.0 2.0 15 3.0 4.0 -1\n")
    (tmp_path / "points3D.txt").write_text(
        "# comment\n15 1.0 2.0 3.0 128 128 128 0.5\n")
    _same_reconstruction(PC.read_model(tmp_path), JC.read_model(tmp_path))


def test_without_a_colmap_binary_sfm_raises(tmp_path):
    if shutil.which("colmap") is not None:
        pytest.skip("a colmap binary is installed")
    with pytest.raises(RuntimeError, match="colmap binary not found"):
        PC.run_colmap_reconstruction(tmp_path, tmp_path / "ws")


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_resize_u8_matches_opencv(channels):
    # odd sizes up and down, gray, RGB and RGBA, and the exact halving;
    # equal to cv2.resize's INTER_LINEAR bit for bit
    rng = np.random.RandomState(channels)
    for (h, w), (oh, ow) in RESIZES:
        shape = (h, w) if channels == 0 else (h, w, channels)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got = I.resize_linear_u8(torch.from_numpy(img), (oh, ow)).numpy()
        np.testing.assert_array_equal(got, cv2.resize(img, (ow, oh)),
                                      f"{(h, w)} -> {(oh, ow)}")
    # ratios whose source coordinate, rounded to f32 as OpenCV rounds it,
    # crosses a pixel or moves a weight (an 800x800 view to 801x803 and to
    # 4,000x3,000 among them)
    for (h, w), (oh, ow) in (((42, 39), (155, 42)), ((58, 36), (147, 178)),
                             ((32, 52), (127, 191)), ((57, 27), (151, 4)),
                             ((800, 800), (801, 803))):
        shape = (h, w) if channels == 0 else (h, w, channels)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got = I.resize_linear_u8(torch.from_numpy(img), (oh, ow)).numpy()
        np.testing.assert_array_equal(got, cv2.resize(img, (ow, oh)),
                                      f"{(h, w)} -> {(oh, ow)}")


# sources one pixel wide or high, and the exact halving
RESIZES_16 = RESIZES + [((1, 9), (4, 17)), ((13, 1), (6, 3)),
                        ((1, 1), (3, 5)), ((6, 8), (3, 4))]


@pytest.mark.parametrize("dtype", [np.uint16, np.int16])
def test_resize_16_bit_matches_opencv(dtype):
    # full-range values, 1 to 5 channels: OpenCV's IPP HAL (with its int16
    # edges) and its own code for what the HAL does not take, bit for bit
    rng = np.random.RandomState(16 + (dtype == np.int16))
    info = np.iinfo(dtype)
    for ((h, w), (oh, ow)), c in itertools.product(RESIZES_16, range(6)):
        shape = (h, w) if c == 0 else (h, w, c)
        img = rng.randint(info.min, info.max + 1, shape,
                          np.int64).astype(dtype)
        got = I.resize_linear_u16(torch.from_numpy(img), (oh, ow)).numpy()
        want = cv2.resize(img, (ow, oh))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.reshape(want.shape), want,
                                      f"{shape} -> {(oh, ow)}")
    # a y coordinate whole only in the exact ratio (37.5 * 33 / 45 - 0.5 =
    # 27): among 40 seeded images a rounding tie there shows the ratio the
    # HAL computes with
    for seed in range(40):
        img = np.random.RandomState(seed).randint(
            info.min, info.max + 1, (33, 11, 3), np.int64).astype(dtype)
        np.testing.assert_array_equal(
            I.resize_linear_u16(torch.from_numpy(img), (45, 40)).numpy(),
            cv2.resize(img, (40, 45)), f"seed {seed}")


def test_resize_float_matches_opencv():
    rng = np.random.RandomState(5)
    for (h, w), (oh, ow) in RESIZES:
        img = rng.rand(h, w, 3).astype(np.float32)
        got = I.resize_linear(torch.from_numpy(img), (oh, ow)).numpy()
        assert np.abs(got - cv2.resize(img, (ow, oh))).max() <= 1e-6


@pytest.mark.parametrize("d", [(0.01, -0.002, 0.0, 0.0),
                               (-0.05, 0.02, 0.002, 0.001),
                               (0.1, 0.05, 0.01, -0.02, 0.01),
                               (0.1, 0.05, 0.01, -0.02, 0.01, 0.02, 0.01,
                                0.003)])
def test_camera_matrix_and_undistort_match_opencv(d):
    # 4, 5 and 8 coefficients; alpha 0 and 1; gray, RGB and RGBA images
    rng = np.random.RandomState(len(d))
    d = np.asarray(d, np.float64)
    for (w, h), c in (((64, 48), 3), ((37, 29), 0), ((50, 40), 4)):
        k = np.array([[1.1 * w, 0, w / 2 + 0.3], [0, 1.11 * w, h / 2 - 0.7],
                      [0, 0, 1]])
        for alpha in (0.0, 1.0):
            want, _ = cv2.getOptimalNewCameraMatrix(k, d, (w, h), alpha,
                                                    (w, h))
            got = I.optimal_new_camera_matrix(k, d, (w, h), alpha, "cpu")
            np.testing.assert_array_equal(got, want)
        img = rng.randint(0, 256, (h, w) if c == 0 else (h, w, c)).astype(
            np.uint8)
        out = I.undistort(torch.from_numpy(img), k, d, got).numpy()
        np.testing.assert_array_equal(out, cv2.undistort(img, k, d, None,
                                                         got))
