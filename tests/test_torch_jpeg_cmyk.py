"""4-component JPEG (CMYK and YCCK) in the port (utils/jpeg.py) against
OpenCV on the CPU, bit for bit: libjpeg decides the colour space (an Adobe
APP14 marker of transform 0, or none, means CMYK; any other transform
YCCK, which jdcolor.c's ycck_cmyk_convert makes CMYK), and cv2 returns 3
channels, OpenCV's icvCvt_CMYK2BGR_8u_C4C3R of Adobe's inverted values.

- Pillow's CMYK files, baseline and progressive, at 1x1, 13x11 and
  37x45 and qualities 50 and 95;
- CMYK and YCCK files of scripts/jpeg_kinds.py at four samplings, each
  Huffman, arithmetic-coded and arithmetic-coded progressive, under every
  Adobe transform and none;
- every (C, K) pair through cv2's conversion, from a lossless CMYK file
  (whose samples arrive exact);
- the committed fixtures of every new kind (tests/data/jpeg_kinds) still
  read by cv2 and the port as their .npy.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg as J
from scripts import jpeg_kinds as K
from tests.torch_image_common import pattern
from tests.torch_jpeg_kinds_common import (FIXTURES, SIZES, cv2_read,
                                           fixture_files, pillow_cmyk,
                                           port_read)

torch.set_num_threads(1)

SAMPLINGS = {"1x1": [(1, 1)] * 4,
             "2x2 Y and K": [(2, 2), (1, 1), (1, 1), (2, 2)],
             "2x1 Y": [(2, 1), (1, 1), (1, 1), (1, 1)],
             "1x2 each but C": [(1, 1), (1, 2), (1, 2), (1, 2)]}


def same(data, tmp_path, label, name="view.jpg"):
    want = cv2_read(data, tmp_path, name)
    assert want is not None and want.shape[-1] == 3, label
    got = port_read(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)
    return got


@pytest.mark.parametrize("progressive", [False, True])
def test_pillow_cmyk_reads_as_cv2(progressive, tmp_path):
    for seed, (h, w) in enumerate(SIZES):
        for quality in (50, 95):
            data = pillow_cmyk(pattern(h, w, 4, seed), progressive,
                               quality=quality)
            assert b"Adobe" in data[:64]
            same(data, tmp_path, f"{h}x{w} q{quality}")


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_cmyk_and_ycck_read_as_cv2(sampling, tmp_path):
    img = torch.from_numpy(pattern(37, 45, 3, 7))
    cmyk = K.cmyk_planes(img)
    cmyk[3] = torch.from_numpy(pattern(37, 45, 1, 8))     # a real K plane
    ycck = K.ycck_planes(cmyk)
    samp = SAMPLINGS[sampling]
    for planes, transforms in ((cmyk, (0, None)), (ycck, (2, 1, 7))):
        plan = K.planes_plan(planes, samp)
        for t in transforms:
            app = b"" if t is None else K.adobe(t)
            for coding, data in (
                    ("Huffman", K.huffman_bytes(plan, app=app)),
                    ("arithmetic", K.arith_bytes(plan, restart=2, app=app)),
                    ("progressive", K.arith_bytes(plan, progressive=True,
                                                  app=app))):
                same(data, tmp_path, f"transform {t} {coding}")
            frame = J.decode_coefficients(data)
            assert frame.colour == ("cmyk" if t in (0, None) else "ycck")


def test_every_c_and_k_through_cv2s_conversion(tmp_path):
    # a lossless CMYK file carries its samples exactly: all 256 x 256
    # (C, K) pairs, M and Y their mirror images
    c, k = np.meshgrid(np.arange(256), np.arange(256))
    planes = [c, 255 - c, k, k]
    data = K.lossless_bytes(planes, app=K.adobe(0))
    got = same(data, tmp_path, "lossless CMYK")
    want = J.cmyk_to_rgb(*(torch.from_numpy(p.astype(np.int64))
                           for p in planes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_committed_fixtures_read_as_cv2_and_the_port(tmp_path):
    files = fixture_files()
    assert sorted(p.name for p in FIXTURES.glob("*.jpg")) == sorted(files)
    for name, data in files.items():
        stored = (FIXTURES / name).read_bytes()
        if "pillow" not in name:          # the test writers' own bytes
            assert stored == data, name
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(stored, tmp_path), want,
                                      err_msg=name)
        np.testing.assert_array_equal(
            J.read_jpeg(FIXTURES / name, "cpu").numpy(), want, err_msg=name)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 16384
