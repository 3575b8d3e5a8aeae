"""BMP in the port (utils/bmp.py, csrc/image_rle.cpp) against OpenCV on the
CPU: ``read_image`` must return what ``cv2.imread(path, IMREAD_UNCHANGED)``
returns (RGB(A) order), and ``write_image`` must write cv2.imwrite's
bytes.

- every header (OS/2, INFO, V4, V5) at 1, 4, 8, 16, 24 and 32 bits, colour
  and gray palettes of every length, BITFIELDS masks, top-down files,
  built with tests/torch_image_common.py ``make_bmp``;
- random RLE8 and RLE4 streams (runs, literals, end-of-line, deltas, an
  early end-of-bitmap), and cut or random ones, which cv2 and the port
  both refuse;
- gray, RGB and RGBA written as cv2 writes .bmp and .dib;
- refusals naming the file;
- the committed BMP fixtures under tests/data/image.
"""
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import bmp as B
from nerfpp_tpu_torch.utils.image import image_format, read_image, write_image
from tests.torch_image_common import (FIXTURES, bmp_rle, bmp_rows, cv2_read,
                                      fixture_files, make_bmp)

torch.set_num_threads(1)

MASKS = ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF00, 0xFF0000,
                                                0xFF000000, 0xFF),
         (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), (0xF00, 0xF0, 0xF, 0))


def agree(path, data):
    """The port reads the file as cv2 does, or both refuse it; True when
    both read it."""
    path.write_bytes(data)
    want = cv2_read(path)
    if want is None:
        with pytest.raises(ValueError, match=path.name):
            read_image(path, "cpu")
        return False
    got = read_image(path, "cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    return True


@pytest.mark.parametrize("header", [12, 40, 108, 124])
def test_every_depth_reads_as_opencv_reads_it(header, tmp_path):
    rng = np.random.RandomState(header)
    read = 0
    for bpp in (1, 4, 8, 16, 24, 32):
        if header == 12 and bpp == 16:
            continue
        for trial in range(6):
            w, h = rng.randint(1, 30, 2)
            comp, masks, pal, clrused = 0, None, None, 0
            if bpp in (16, 32) and header != 12 and trial % 2:
                comp = 3
                masks = MASKS[rng.randint(2) if bpp == 16
                              else rng.randint(2, len(MASKS))]
            if bpp <= 8:
                n = 1 << bpp if header == 12 or trial < 3 else rng.randint(
                    1, (1 << bpp) + 1)
                pal = rng.randint(0, 256, (n, 3))
                if trial % 2:
                    pal[:] = pal[:, :1]                # a gray palette
                clrused = 0 if header == 12 or trial == 0 else n
            samples = (rng.randint(0, 1 << bpp, (h, w)) if bpp <= 8 else
                       rng.randint(0, 65536, (h, w)) if bpp == 16 else
                       rng.randint(0, 256, (h, w, bpp // 8)))
            top_down = header != 12 and trial == 5
            rows = bmp_rows(samples[::-1] if top_down else samples, bpp)
            read += agree(tmp_path / "v.bmp", make_bmp(
                w, h, bpp, rows, header, comp, pal, clrused, masks,
                top_down))
    assert read >= 20
    assert image_format(tmp_path / "v.bmp") == "bmp"


@pytest.mark.parametrize("bits", [8, 4])
def test_rle_streams_read_as_opencv_reads_them(bits, tmp_path):
    rng = np.random.RandomState(bits)
    read = 0
    for trial in range(120):
        w, h = rng.randint(1, 40, 2)
        pal = rng.randint(0, 256, (1 << bits, 3))
        if trial % 3 == 0:
            pal[:] = pal[:, :1]
        ops = (None, ("run", "eol"), ("literal", "eol"),
               ("run", "delta", "eol"))[trial % 4]
        stream = bmp_rle(w, h, bits, rng, ops)
        if trial % 10 == 9:
            stream = stream[:rng.randint(len(stream))]
        if trial % 10 == 8:
            stream = rng.randint(0, 256, rng.randint(0, 300)).astype(
                np.uint8).tobytes()
        read += agree(tmp_path / "r.bmp", make_bmp(
            w, h, bits, stream, comp=1 if bits == 8 else 2, palette=pal,
            clrused=len(pal), top_down=trial % 5 == 0))
    assert read >= 30


def test_writes_are_opencvs_bytes(tmp_path):
    rng = np.random.RandomState(3)
    for c, (h, w) in ((1, (1, 1)), (1, (7, 5)), (3, (9, 6)), (3, (4, 13)),
                      (4, (5, 7)), (4, (30, 31))):
        img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        img = img[..., 0] if c == 1 else img
        for ext in (".bmp", ".dib"):
            ours, theirs = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
            write_image(ours, torch.from_numpy(img), "cpu")
            assert cv2.imwrite(str(theirs), img if c == 1 else
                               img[..., [2, 1, 0, 3][:c]])
            assert ours.read_bytes() == theirs.read_bytes(), (c, h, w, ext)
            np.testing.assert_array_equal(read_image(ours, "cpu").numpy(),
                                          img)
    with pytest.raises(ValueError, match="uint8"):
        B.write_bmp(tmp_path / "d.bmp", np.zeros((2, 2), np.uint16))


def test_refusals_name_the_file(tmp_path):
    rows = bmp_rows(np.zeros((4, 4, 3), np.uint8), 24)
    cases = {"jpeg.bmp": make_bmp(4, 4, 24, rows, comp=4),
             "deep2.bmp": make_bmp(4, 4, 2, bmp_rows(np.zeros((4, 4)), 1),
                                   palette=[(0, 0, 0)] * 4),
             "v5_555.bmp": make_bmp(4, 4, 16, bmp_rows(np.zeros((4, 4)), 16),
                                    header=124, comp=3, masks=MASKS[0]),
             "short.bmp": make_bmp(4, 4, 24, rows[:-1]),
             "rle_past.bmp": make_bmp(4, 2, 8, bytes([5, 1, 0, 1]), comp=1,
                                      palette=[(1, 2, 3)] * 256)}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=rf"{name}.*cv2\.imread returns "
                           "no image"):
            read_image(tmp_path / name, "cpu")


def test_committed_fixtures_match_opencv_and_the_port():
    names = [n for n in fixture_files() if n.endswith(".bmp")]
    assert len(names) == 6
    for name in names:
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(FIXTURES / name), want)
        got = B.read_bmp(FIXTURES / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
