"""Radiance HDR in the port (utils/hdr.py, csrc/image_rle.cpp) against
OpenCV on the CPU: ``read_image`` must return what ``cv2.imread(path,
IMREAD_UNCHANGED)`` returns (float32, RGB order) or, where cv2 returns
None, raise ValueError naming the file; ``write_image`` must write
cv2.imwrite's bytes.

- flat files (widths below 8), new-style run-length scanlines with random
  run and literal splits, run-length files that turn flat part way, zero
  exponents, old-style run quadruples (read as pixels, as cv2 reads them);
- header variants: extra lines before and after the FORMAT line, a FORMAT
  line after the first empty line, other orientations, size lines with
  signs and without spaces, lines longer than fgets' buffer;
- the writes of .hdr and .pic (run-length and flat, gray repeated to RGB,
  black pixels, exponents from 2^-100 to 2^100);
- the committed fixtures under tests/data/image.
"""
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import hdr as H
from nerfpp_tpu_torch.utils.image import image_format, read_image, write_image
from tests.torch_image_common import (FIXTURES, cv2_read, fixture_files,
                                      hdr_image, make_hdr)

torch.set_num_threads(1)

FORMAT = b"FORMAT=32-bit_rle_rgbe\n"


def agree(path, data):
    """The port reads the file as cv2 does, or both refuse it; True when
    both read it."""
    path.write_bytes(data)
    want = cv2_read(path)
    if want is None:
        with pytest.raises(ValueError, match=path.name):
            read_image(path, "cpu")
        return False
    got = read_image(path, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return True


def test_flat_and_run_length_pixels_read_as_opencv_reads_them(tmp_path):
    rng = np.random.RandomState(1)
    read = 0
    for trial in range(120):
        w, h = rng.randint(1, 60), rng.randint(1, 8)
        rgbe = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        if trial % 2:
            rgbe[:, :w // 2] = rgbe[:, :1]              # runs
        rgbe[..., 3][rng.rand(h, w) < 0.1] = 0
        if trial % 7 == 0:
            rgbe[:, 0] = (1, 1, 1, 5)                   # an old-style run
        mode = trial % 3
        data = make_hdr(rgbe, rng if mode else None,
                        flat_from=rng.randint(h) if mode == 2 else None)
        if trial % 11 == 10:
            data = data[:-1]
        read += agree(tmp_path / "v.hdr", data)
    assert read >= 100
    assert image_format(tmp_path / "v.hdr") == "hdr"


def test_headers_read_as_opencv_reads_them(tmp_path):
    rgbe = np.random.RandomState(2).randint(0, 256, (3, 5, 4)).astype(
        np.uint8)
    size = b"-Y 3 +X 5\n"
    for head in (b"#?RGBE\n" + FORMAT + b"\n" + size,
                 b"#?RADIANCE\nEXPOSURE=2\nGAMMA=1\n" + FORMAT + b"\n" + size,
                 b"#?RADIANCE\n" + FORMAT + b"EXPOSURE=2\n\n" + size,
                 b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n" + FORMAT + b"\n"
                 + size,
                 b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n" + size,
                 b"#?RADIANCE\nSOFTWARE=x\n\n" + FORMAT + b"\n" + size,
                 b"#?RADIANCE\n" + FORMAT + b"\n\n" + size,
                 b"#?RADIANCE\n" + FORMAT + b"\r\n" + size,
                 b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n" + size,
                 b"#?RADIANCE\n" + FORMAT + b"\n+Y 3 +X 5\n",
                 b"#?RADIANCE\n" + FORMAT + b"\n+X 5 -Y 3\n",
                 b"#?RADIANCE\n" + FORMAT + b"\n-Y3+X5\n",
                 b"#?RADIANCE\n" + FORMAT + b"\n-Y +3 +X 005 junk\n",
                 b"#?RADIANCE\n" + FORMAT + b"\n  -Y 3 +X 5\n",
                 b"#?RADIANCE\n" + FORMAT + b"\n-Y 0 +X 5\n",
                 b"#?RADIANCE\n" + FORMAT + b"\n-Y 3 +X 5\r\n",
                 b"#?RADIANCE\n" + b"X" * 126 + b"\n" + FORMAT + b"\n" + size,
                 b"#?RADIANCE\n" + b"X" * 127 + b"\n" + FORMAT + b"\n" + size,
                 b"#?RADIANCE\n" + b"X" * 300 + b"\n" + FORMAT + b"\n" + size):
        agree(tmp_path / "h.hdr", make_hdr(rgbe, header=head))


def test_writes_are_opencvs_bytes(tmp_path):
    rng = np.random.RandomState(3)
    for h, w, c in ((1, 1, 3), (3, 7, 3), (4, 8, 3), (5, 40, 1), (9, 300, 3),
                    (2, 129, 3)):
        img = hdr_image(h, w, h * w)[..., :c]
        img[0, 0] = 0
        img[-1, -1] = 2.0 ** rng.randint(-100, 100)
        img = img[..., 0] if c == 1 else img
        for ext in (".hdr", ".pic"):
            ours, theirs = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
            write_image(ours, torch.from_numpy(img), "cpu")
            assert cv2.imwrite(str(theirs), img if c == 1 else img[..., ::-1])
            assert ours.read_bytes() == theirs.read_bytes(), (h, w, c, ext)
            np.testing.assert_array_equal(read_image(ours, "cpu").numpy(),
                                          cv2_read(theirs))
    with pytest.raises(ValueError, match="float32"):
        H.write_hdr(tmp_path / "u.hdr", np.zeros((2, 2, 3), np.uint8))


def test_what_opencv_cannot_read_raises_naming_the_file(tmp_path):
    rgbe = np.zeros((2, 9, 4), np.uint8)
    good = make_hdr(rgbe, np.random.RandomState(4))
    head = len(b"#?RADIANCE\n" + FORMAT + b"\n-Y 2 +X 9\n")
    cases = {"noformat.hdr": b"#?RADIANCE\n\n-Y 2 +X 9\n" + bytes(72),
             "nosize.hdr": b"#?RADIANCE\n" + FORMAT + b"\n\n" + bytes(72),
             "width.hdr": good[:head] + b"\x02\x02\x00\x08" + good[head + 4:],
             "count.hdr": good[:head + 4] + b"\x80\x00" + good[head + 6:],
             "short.hdr": good[:-1]}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=rf"{name}.*cv2\.imread returns "
                           "no image"):
            read_image(tmp_path / name, "cpu")


def test_committed_fixtures_match_opencv_and_the_port():
    names = [n for n in fixture_files() if n.endswith(".hdr")]
    assert len(names) == 2
    for name in names:
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(FIXTURES / name), want)
        got = H.read_hdr(FIXTURES / name, "cpu").numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the device's conversion is exact: each value is m * 2^(e - 136)
    rgbe = np.arange(256 * 4, dtype=np.int64).reshape(256, 4) % 256
    rgbe[:, 3] = np.arange(256)
    want = np.ldexp(rgbe[:, :3].astype(np.float64),
                    (rgbe[:, 3:] - 136)) * (rgbe[:, 3:] > 0)
    got = torch.from_numpy(rgbe[:, :3]).float() * torch.from_numpy(
        H.rgbe_scale())[rgbe[:, 3]][:, None]
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
