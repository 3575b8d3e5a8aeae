"""PBM, PGM, PPM, PAM and PFM in the port (utils/pxm.py) against OpenCV on
the CPU: ``read_image`` must return what ``cv2.imread(path,
IMREAD_UNCHANGED)`` returns (RGB(A) order) or, where cv2 returns None,
raise ValueError naming the file; ``write_image`` must write cv2.imwrite's
bytes.

- P1-P6 with random white space and comments between the header's
  numbers, every kind of maxval (1, 7, 100, 255, 256, 1000, 65535),
  ASCII samples past maxval, binary 16-bit samples;
- PAM with and without each TUPLTYPE, MAXVAL 1 (cv2's bit rows), 16 bits,
  comments; cv2 cannot read back its own 4-channel PAM;
- PFM of 1 and 3 channels, both byte orders, scales other than 1 and
  header variants;
- the writes of .pbm, .pgm, .ppm, .pnm, .pam and .pfm;
- the committed fixtures under tests/data/image.
"""
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import pxm as P
from nerfpp_tpu_torch.utils.image import image_format, read_image, write_image
from tests.torch_image_common import (FIXTURES, cv2_read, fixture_files,
                                      hdr_image, make_pam, make_pfm)

torch.set_num_threads(1)

SEPARATORS = (b" ", b"\n", b"\t", b"  ", b"\r\n", b"\n# a comment\n",
              b" #x y\n")


def agree(path, data):
    """The port reads the file as cv2 does, or both refuse it; True when
    both read it."""
    path.write_bytes(data)
    try:
        want = cv2_read(path)
    except cv2.error:                   # cv2 raises on a size of 0 or less
        want = None
    if want is None:
        with pytest.raises(ValueError, match=path.name):
            read_image(path, "cpu")
        return False
    got = read_image(path, "cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    return True


@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5, 6])
def test_pbm_pgm_ppm_read_as_opencv_reads_them(kind, tmp_path):
    rng = np.random.RandomState(kind)
    ch = 3 if kind in (3, 6) else 1
    read = 0
    for trial in range(40):
        w, h = rng.randint(1, 20, 2)
        maxval = 1 if kind in (1, 4) else (1, 7, 100, 255, 256, 1000,
                                           65535)[trial % 7]

        def sep():
            return SEPARATORS[rng.randint(len(SEPARATORS))]

        head = b"P%d" % kind + sep() + b"%d" % w + sep() + b"%d" % h
        if kind not in (1, 4):
            head += sep() + b"%d" % maxval
        head += (b"\n", b" ", b"\t")[rng.randint(3)]
        if kind == 1:
            body = b"".join(rng.choice([b"", b" "]) + b"%d" % v
                            for v in rng.randint(0, 2, h * w)) + b"\n"
        elif kind == 4:
            body = np.packbits(rng.randint(0, 2, (h, w)).astype(np.uint8),
                               axis=1).tobytes()
        elif kind in (2, 3):
            body = b" ".join(b"%d" % v for v in rng.randint(
                0, maxval + maxval // 3 + 2, h * w * ch)) + b"\n"
        else:
            n = h * w * ch
            body = (rng.randint(0, 65536, n).astype(">u2").tobytes()
                    if maxval > 255 else
                    rng.randint(0, 256, n).astype(np.uint8).tobytes())
        if trial % 10 == 9:
            body = body[:-1]
        read += agree(tmp_path / "v.pgm", head + body)
    assert read >= 30
    assert image_format(tmp_path / "v.pgm") == "pxm"


def test_pam_reads_as_opencv_reads_it(tmp_path):
    rng = np.random.RandomState(7)
    read = 0
    for trial in range(150):
        w, h = rng.randint(1, 15, 2)
        tupltype = (None, "GRAYSCALE", "RGB", "RGB_ALPHA", "GRAYSCALE_ALPHA",
                    "BLACKANDWHITE")[trial % 6]
        depth = {"GRAYSCALE": 1, "RGB": 3, "RGB_ALPHA": 4,
                 "GRAYSCALE_ALPHA": 2, "BLACKANDWHITE": 1}.get(
                     tupltype, (1, 3, 4)[rng.randint(3)])
        maxval = (1, 5, 255, 1000, 65535)[rng.randint(5)]
        read += agree(tmp_path / "v.pam", make_pam(
            rng.randint(0, maxval + 1, (h, w, depth)), maxval, tupltype,
            "# a comment\n" if trial % 4 == 0 else ""))
    assert read >= 80
    assert image_format(tmp_path / "v.pam") == "pam"


def test_pfm_reads_as_opencv_reads_it(tmp_path):
    rng = np.random.RandomState(8)
    for trial in range(60):
        h, w = rng.randint(1, 15, 2)
        img = hdr_image(h, w, trial) * np.float32(rng.randn())
        if trial % 2:
            img = img[..., 1]
        img[0, 0] = (-0.0, np.nan, np.inf, 1e-42)[trial % 4]
        scale = (-1.0, 1.0, -2.0, 0.37, -350.0, 1e-3)[trial % 6]
        assert agree(tmp_path / "v.pfm", make_pfm(img, scale))
    img = hdr_image(3, 4, 1)
    for header in (b"PF\n4\n3\n-1\n", b"PF\n4 3 -1 ", b"PF\n+4 3\n-1x\n",
                   b"PF\n4.5 3\n-1\t", b"PF\n4 3\n-1\r\n", b"PF\r\n4 3\n-1\n",
                   b"PF\n4  3\n-1\n", b"PF\n4 3\nabc\n", b"PF\n4 3\n0\n"):
        agree(tmp_path / "h.pfm", make_pfm(img, header=header))
    assert image_format(tmp_path / "h.pfm") == "pfm"


def test_writes_are_opencvs_bytes(tmp_path):
    rng = np.random.RandomState(9)
    cases = [(".pbm", np.uint8, 1), (".pgm", np.uint8, 1),
             (".pgm", np.uint16, 1), (".ppm", np.uint8, 3),
             (".ppm", np.uint16, 3), (".pnm", np.uint8, 1),
             (".pnm", np.uint16, 3), (".pam", np.uint8, 1),
             (".pam", np.uint8, 3), (".pam", np.uint16, 1),
             (".pam", np.uint8, 4), (".pfm", np.float32, 1),
             (".pfm", np.float32, 3)]
    for ext, dtype, c in cases:
        for h, w in ((1, 1), (5, 9), (16, 13)):
            if dtype == np.float32:
                img = hdr_image(h, w, c)[..., :c]
            else:
                img = rng.randint(0, np.iinfo(dtype).max + 1,
                                  (h, w, c)).astype(dtype)
                img[rng.rand(h, w) < 0.3] = 0
            img = img[..., 0] if c == 1 else img
            ours, theirs = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
            write_image(ours, torch.from_numpy(img), "cpu")
            assert cv2.imwrite(str(theirs), img if c == 1 else
                               img[..., [2, 1, 0, 3][:c]])
            assert ours.read_bytes() == theirs.read_bytes(), (ext, dtype, c)
            if ext == ".pam" and (c == 4 or dtype == np.uint16):
                continue            # cv2 does not read these back (below)
            back = read_image(ours, "cpu").numpy()
            np.testing.assert_array_equal(
                back, (img != 0) * np.uint8(255) if ext == ".pbm" else img)
    for ext, img in ((".pgm", np.zeros((2, 2, 3), np.uint8)),
                     (".ppm", np.zeros((2, 2), np.uint8)),
                     (".pfm", np.zeros((2, 2), np.float64))):
        with pytest.raises(ValueError, match=rf"x\{ext}"):
            write_image(tmp_path / f"x{ext}", img, "cpu")


def test_what_opencv_cannot_read_raises_naming_the_file(tmp_path):
    rng = np.random.RandomState(10)
    for name, img in (("rgba.pam", rng.randint(0, 256, (3, 4, 4))),
                      ("deep.pam", rng.randint(0, 65536, (3, 4)))):
        img = img.astype(np.uint8 if name == "rgba.pam" else np.uint16)
        assert cv2.imwrite(str(tmp_path / name), img)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=rf"{name}.*without a TUPLTYPE"):
            read_image(tmp_path / name, "cpu")
    cases = {"short.pgm": b"P5\n3 2\n255\n\x01\x02\x03\x04\x05",
             "ended.pgm": b"P2\n3 1\n100\n1 2 3",
             "comment.pgm": b"P5 #c\n3#x\n 2\n255#\n" + bytes(6),
             "huge.pgm": b"P2\n1 1\n70000\n5\n",
             "type.pam": make_pam(np.zeros((1, 1, 1)), 255, "FOO"),
             "zero.pfm": make_pfm(np.zeros((2, 2), np.float32), 0.0)}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=rf"{name}.*cv2\.imread returns "
                           "no image"):
            read_image(tmp_path / name, "cpu")


def test_committed_fixtures_match_opencv_and_the_port():
    names = [n for n in fixture_files()
             if Path(n).suffix in (".pbm", ".pgm", ".ppm", ".pam", ".pfm")]
    assert len(names) == 7
    for name in names:
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(FIXTURES / name), want)
        got = read_image(FIXTURES / name, "cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert P.read_pfm(FIXTURES / "pfm_gray_7x4.pfm").dtype == np.float32
