"""Every PNG kind in the port's reader (utils/png.py) against OpenCV's
libpng on the CPU: the files are built here with zlib and struct
(tests/torch_image_common.py ``make_png``, each row with a random one of
the five filters), and ``read_png`` must return what ``cv2.imread(path,
IMREAD_UNCHANGED)`` returns (RGB(A) order): the channel count, the dtype
(uint16 for 16-bit files) and the expansion of low bit depths.

- colour types 0, 2, 3, 4 and 6 at every legal depth, odd sizes, with and
  without Adam7 interlacing;
- tRNS: ignored for gray, a key colour for RGB (alpha 0 or the maximum),
  per-entry alpha for palettes (entries past the chunk opaque);
- ``png_shape`` from the chunks before the image data;
- 16-bit writes (gray, RGB, RGBA) read back by cv2 to the same pixels;
- refusals: an unknown critical chunk raises NotImplementedError naming
  the file and the chunk, malformed headers ValueError;
- the committed PNG fixtures under tests/data/image.
"""
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils.image import read_image, write_image
from nerfpp_tpu_torch.utils.png import png_shape, read_png, write_png
from tests.torch_image_common import (FIXTURES, cv2_read, fixture_files,
                                      make_png)

torch.set_num_threads(1)

DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SIZES = [(1, 1), (3, 5), (9, 17), (13, 4), (8, 8)]


def check(path, data):
    path.write_bytes(data)
    want = cv2_read(path)
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    assert png_shape(path) == (*want.shape[:2],
                               1 if want.ndim == 2 else want.shape[2])
    return got


@pytest.mark.parametrize("ctype", sorted(DEPTHS))
def test_every_depth_and_interlace_reads_as_opencv(ctype, tmp_path):
    rng = np.random.RandomState(ctype)
    n = 0
    for depth in DEPTHS[ctype]:
        for h, w in SIZES:
            for interlace in (0, 1):
                n += 1
                top = min(1 << depth, 7) if ctype == 3 else 1 << depth
                s = rng.randint(0, top, (h, w, CHANNELS[ctype]))
                plte = rng.randint(0, 256, (top, 3)) if ctype == 3 else None
                got = check(tmp_path / "k.png",
                            make_png(s, ctype, depth, plte, None, interlace,
                                     n))
                assert got.dtype == (np.uint16 if depth == 16 else np.uint8)


def test_trns_as_opencv_applies_it(tmp_path):
    rng = np.random.RandomState(1)
    for depth in (1, 2, 4, 8, 16):                    # gray: ignored
        s = rng.randint(0, 1 << depth, (5, 6, 1))
        got = check(tmp_path / "g.png", make_png(
            s, 0, depth, trns=struct.pack(">H", int(s[0, 0, 0]))))
        assert got.ndim == 2
    for depth in (8, 16):                             # RGB: a key colour
        s = rng.randint(0, 1 << depth, (5, 6, 3))
        s[2, 3] = s[0, 0]
        for interlace in (0, 1):
            got = check(tmp_path / "c.png", make_png(
                s, 2, depth, trns=struct.pack(">3H", *s[0, 0]),
                interlace=interlace))
            assert got.shape == (5, 6, 4)
            assert got[0, 0, 3] == 0 and got[2, 3, 3] == 0
            assert got[..., 3].max() == (1 << depth) - 1
    for depth in (1, 2, 4, 8):                        # palette: per entry
        top = 1 << depth
        s = rng.randint(0, top, (7, 9, 1))
        for n_alpha in (1, top // 2 or 1, top):
            got = check(tmp_path / "p.png", make_png(
                s, 3, depth, rng.randint(0, 256, (top, 3)),
                bytes(rng.randint(0, 256, n_alpha).astype(np.uint8))))
            assert got.shape == (7, 9, 4)


def test_sixteen_bit_writes_read_back_in_opencv(tmp_path):
    rng = np.random.RandomState(2)
    for c in (1, 3, 4):
        img = rng.randint(0, 65536, (11, 7, c)).astype(np.uint16)
        img = img[..., 0] if c == 1 else img
        path = tmp_path / f"w{c}.png"
        write_png(path, img)
        np.testing.assert_array_equal(cv2_read(path), img)
        np.testing.assert_array_equal(read_png(path), img)
        # write_image and read_image keep the 16 bits (a tensor both ways)
        write_image(tmp_path / f"i{c}.png", torch.from_numpy(img), "cpu")
        back = read_image(tmp_path / f"i{c}.png", "cpu")
        assert back.dtype == torch.uint16
        np.testing.assert_array_equal(back.numpy(), img)
        np.testing.assert_array_equal(cv2_read(tmp_path / f"i{c}.png"), img)


def test_refusals_name_the_file_and_the_kind(tmp_path):
    s = np.zeros((2, 2, 3), np.uint8)
    data = make_png(s, 2, 8)
    odd = data[:33] + struct.pack(">I", 0) + b"QUUX" + struct.pack(
        ">I", zlib.crc32(b"QUUX") & 0xFFFFFFFF) + data[33:]
    (tmp_path / "odd.png").write_bytes(odd)
    assert cv2.imread(str(tmp_path / "odd.png"), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(NotImplementedError, match=r"odd\.png.*QUUX"):
        read_image(tmp_path / "odd.png", "cpu")
    bad = bytearray(data)
    bad[24] = 3                                       # bit depth 3
    bad[29:33] = struct.pack(">I", zlib.crc32(bytes(bad[12:29])) & 0xFFFFFFFF)
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match=r"bad\.png.*bit depth 3"):
        read_png(tmp_path / "bad.png")
    with pytest.raises(ValueError, match="uint8 or uint16"):
        write_png(tmp_path / "f.png", np.zeros((2, 2), np.float32))


def test_committed_fixtures_match_opencv_and_the_port():
    for name, data in fixture_files().items():
        if not name.endswith(".png"):
            continue
        assert (FIXTURES / name).read_bytes() == data, name
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(FIXTURES / name), want)
        got = read_png(FIXTURES / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
