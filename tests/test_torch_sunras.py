"""Sun raster in the port (utils/sunras.py) against OpenCV on the CPU:
``read_image`` must return what ``cv2.imread(path, IMREAD_UNCHANGED)``
returns (RGB order) or, where cv2 returns None, raise ValueError naming the
file; ``write_image`` must write cv2.imwrite's bytes.

- 1, 8, 24 and 32 bits, types 0-5 (cv2 5.0 reads types 0 and 1 only, so
  byte-encoded files are refused by both), colour maps of every length,
  gray maps, no map (cv2 reads such 1- and 8-bit files as zeros);
- the writes of .ras and .sr (gray, RGB, RGBA; the padding byte of an
  odd-length last row, which cv2 takes from past its image's end, is left
  out of the comparison);
- the committed fixtures under tests/data/image.
"""
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import sunras as S
from nerfpp_tpu_torch.utils.image import image_format, read_image, write_image
from tests.torch_image_common import (FIXTURES, cv2_read, fixture_files,
                                      make_sunras, sunras_rows)

torch.set_num_threads(1)


def test_depths_maps_and_types_read_as_opencv_reads_them(tmp_path):
    rng = np.random.RandomState(1)
    read = 0
    for trial in range(300):
        w, h = rng.randint(1, 20, 2)
        bpp = (1, 8, 24, 32)[trial % 4]
        typ = (0, 1, 1, 1, 2, 3, 4, 5)[rng.randint(8)]
        cmap = None
        if bpp <= 8 and rng.rand() < 0.6:
            cmap = rng.randint(0, 256, (3, rng.randint(1, (1 << bpp) + 2)))
            if rng.rand() < 0.4:
                cmap[:] = cmap[:1]
        samples = (rng.randint(0, 1 << bpp, (h, w)) if bpp <= 8
                   else rng.randint(0, 256, (h, w, bpp // 8)))
        rows = sunras_rows(samples, bpp)
        if trial % 20 == 19:
            rows = rows[:-1]
        path = tmp_path / "v.ras"
        path.write_bytes(make_sunras(w, h, bpp, rows, typ, cmap))
        want = cv2_read(path)
        if want is None:
            with pytest.raises(ValueError, match=r"v\.ras"):
                read_image(path, "cpu")
            continue
        got = read_image(path, "cpu").numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        read += 1
    assert read >= 120
    assert image_format(tmp_path / "v.ras") == "sunras"


def test_writes_are_opencvs_bytes(tmp_path):
    rng = np.random.RandomState(2)
    for c, (h, w) in ((1, (1, 1)), (1, (4, 6)), (1, (5, 7)), (3, (9, 6)),
                      (3, (4, 13)), (4, (5, 7))):
        img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        img = img[..., 0] if c == 1 else img
        for ext in (".ras", ".sr"):
            ours, theirs = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
            write_image(ours, torch.from_numpy(img), "cpu")
            assert cv2.imwrite(str(theirs), img if c == 1 else
                               img[..., [2, 1, 0, 3][:c]])
            cut = (w * c) % 2          # the last row's padding, see above
            a, b = ours.read_bytes(), theirs.read_bytes()
            assert len(a) == len(b) and a[:len(a) - cut] == b[:len(b) - cut]
            np.testing.assert_array_equal(read_image(ours, "cpu").numpy(),
                                          cv2_read(theirs))
    with pytest.raises(ValueError, match="uint8"):
        S.write_sunras(tmp_path / "d.ras", np.zeros((2, 2), np.uint16))


def test_what_opencv_cannot_read_raises_naming_the_file(tmp_path):
    rows = sunras_rows(np.zeros((3, 4), np.uint8), 8)
    cases = {"rle.ras": make_sunras(4, 3, 8, rows, typ=2),
             "rgb.ras": make_sunras(4, 3, 24, rows * 3, typ=3),
             "map.ras": make_sunras(4, 3, 1, rows, cmap=np.zeros((3, 3))),
             "deep.ras": make_sunras(4, 3, 16, rows * 2),
             "short.ras": make_sunras(4, 3, 8, rows[:-1])}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=rf"{name}.*cv2\.imread returns "
                           "no image"):
            read_image(tmp_path / name, "cpu")


def test_committed_fixtures_match_opencv_and_the_port():
    names = [n for n in fixture_files() if n.endswith(".ras")]
    assert len(names) == 3
    for name in names:
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(FIXTURES / name), want)
        got = S.read_sunras(FIXTURES / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
