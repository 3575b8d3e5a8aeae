"""utils/jpeg2000.py against OpenCV on the CPU for the codestream options
cv2.imwrite never writes: Pillow's JPEG 2000 files (Pillow 12.1's
OpenJPEG) read by the port as cv2.imread(IMREAD_UNCHANGED) reads them
(OpenCV 5.0.0's OpenJPEG 2.5.3), bit for bit, in RGB(A) order:

- irreversible 9/7 with and without the ICT, lossless and at rates;
- tiles (odd sizes too, so that tiles and resolutions start at odd
  coordinates), each of the five progression orders, precincts, several
  rate and dB layers, code-block sizes, 1 to 6 resolutions;
- ``cinema2k-24`` at the size Pillow requires (2048x1080: CPRL, tile-parts
  per component, TLM, 9/7);
- PLT and COM markers, raw codestreams, and Pillow's YCbCr mode (an sYCC
  ``colr``, which cv2 turns to BGR with its YUV conversion);
- every kind in one file at once, and random combinations of them.
"""
import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg2000 as J
from nerfpp_tpu_torch.utils.image import read_image
from tests.torch_image_common import pattern, pillow_jp2, to_rgb

torch.set_num_threads(1)


def check(tmp_path, img, mode=None, **options):
    """The port's pixels of Pillow's file equal cv2's."""
    data = pillow_jp2(img, mode, **options)
    path = tmp_path / "pil.jp2"
    path.write_bytes(data)
    want = to_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    assert want is not None, options
    got = read_image(path, "cpu").numpy()
    assert got.dtype == want.dtype, options
    np.testing.assert_array_equal(got, want, err_msg=str(options))
    return data, got


def gray16(h, w, seed):
    noise = np.random.RandomState(seed).randint(0, 257, (h, w))
    return (pattern(h, w, 1, seed).astype(np.uint32) * 257 + noise).clip(
        0, 65535).astype(np.uint16)


@pytest.mark.parametrize("mct", [1, 0])
def test_irreversible_97_with_and_without_the_ict(mct, tmp_path):
    for seed, (h, w) in enumerate(((37, 45), (64, 64), (19, 70))):
        img = pattern(h, w, 3, seed)
        for layers in (None, [8], [30, 10, 3]):
            opts = dict(irreversible=True, mct=mct)
            if layers:
                opts.update(quality_mode="rates", quality_layers=layers)
            data, _ = check(tmp_path, img, **opts)
            cod = data.index(b"\xff\x52")
            assert data[cod + 8] == mct and data[cod + 13] == 0
    check(tmp_path, pattern(40, 33, 1, 5), irreversible=True)


def test_tiles_at_odd_origins(tmp_path):
    img = pattern(75, 83, 3, 6)
    for tile in ((32, 32), (33, 33), (17, 40), (64, 21)):
        for irreversible in (False, True):
            check(tmp_path, img, tile_size=tile, irreversible=irreversible,
                  num_resolutions=3)
    check(tmp_path, gray16(50, 45, 7), tile_size=(19, 23))


def test_each_progression_order(tmp_path):
    img = pattern(61, 53, 3, 8)
    for order in J.PROGRESSIONS:
        for precincts in (None, (16, 16), (32, 64)):
            opts = dict(progression=order, quality_mode="rates",
                        quality_layers=[20, 6, 2], num_resolutions=4)
            if precincts:
                opts["precinct_size"] = precincts
            data, _ = check(tmp_path, img, **opts)
            cod = data.index(b"\xff\x52")
            assert data[cod + 5] == J.PROGRESSIONS.index(order)


def test_precincts_and_code_block_sizes(tmp_path):
    img = pattern(70, 66, 3, 9)
    # code-blocks larger than a precinct are cut to it (Pillow's OpenJPEG
    # refuses 4 x 4 blocks in 8 x 8 precincts)
    for precincts in ((8, 8), (16, 32), (128, 128)):
        for block in ((4, 4), (8, 32), (16, 16), (64, 64)):
            if precincts == (8, 8) and block == (4, 4):
                continue
            check(tmp_path, img, precinct_size=precincts,
                  codeblock_size=block, num_resolutions=4)
    check(tmp_path, gray16(47, 52, 10), codeblock_size=(4, 64),
          progression="RPCL", precinct_size=(32, 32))


def test_rate_and_db_layers(tmp_path):
    img = pattern(58, 49, 3, 11)
    for mode, layers in (("rates", [40]), ("rates", [40, 15, 5, 2]),
                         ("dB", [25]), ("dB", [22, 30, 38, 46])):
        for irreversible in (False, True):
            check(tmp_path, img, quality_mode=mode, quality_layers=layers,
                  irreversible=irreversible)
    check(tmp_path, gray16(41, 36, 12), quality_mode="dB",
          quality_layers=[40, 60, 80])


def test_one_to_six_resolutions(tmp_path):
    img = pattern(64, 80, 3, 13)
    for n in range(1, 7):
        check(tmp_path, img, num_resolutions=n)
        check(tmp_path, img, num_resolutions=n, irreversible=True,
              quality_mode="rates", quality_layers=[10])


def test_cinema_2k(tmp_path):
    flat = np.full((1080, 2048, 3), 90, np.uint8)
    flat[400:464, 1000:1064] = pattern(64, 64, 3, 14)
    data, got = check(tmp_path, flat, cinema_mode="cinema2k-24")
    assert b"\xff\x55" in data[:400]                       # TLM
    cod = data.index(b"\xff\x52")
    assert data[cod + 5] == 4 and data[cod + 13] == 0      # CPRL, 9/7
    assert got.shape == (1080, 2048, 3)


def test_plt_com_codestream_and_ycbcr(tmp_path):
    img = pattern(45, 38, 3, 15)
    data, _ = check(tmp_path, img, plt=True, comment="a comment",
                    quality_mode="rates", quality_layers=[12, 3])
    assert b"\xff\x58" in data and b"a comment" in data      # PLT, COM
    data, _ = check(tmp_path, img, no_jp2=True, irreversible=True)
    assert data.startswith(J.J2K_SIGNATURE)
    for irreversible in (False, True):
        data, got = check(tmp_path, img, "YCbCr", irreversible=irreversible,
                          progression="CPRL")
        assert b"colr\x01\x00\x00\x00\x00\x00\x12" in data      # sYCC
    check(tmp_path, pattern(33, 35, 4, 16), tile_size=(16, 16))   # RGBA


def test_everything_in_one_file_and_random_combinations(tmp_path):
    check(tmp_path, pattern(77, 91, 3, 17), irreversible=True,
          tile_size=(40, 36), progression="PCRL", precinct_size=(16, 16),
          codeblock_size=(8, 8), num_resolutions=3, quality_mode="rates",
          quality_layers=[25, 8, 3], plt=True, comment="all", no_jp2=True)
    rng = np.random.RandomState(18)
    for i in range(12):
        h, w = rng.randint(20, 90, 2)
        mode = ("L", "RGB", "RGBA", "I;16", "YCbCr")[i % 5]
        c = {"L": 1, "I;16": 1, "RGBA": 4}.get(mode, 3)
        img = gray16(h, w, i) if mode == "I;16" else pattern(h, w, c, i)
        n = int(rng.randint(1, 6))
        while n > 1 and min(h, w) < 1 << (n - 1):
            n -= 1
        opts = dict(num_resolutions=n,
                    progression=J.PROGRESSIONS[rng.randint(5)],
                    irreversible=bool(rng.rand() < 0.5))
        if rng.rand() < 0.5:
            opts["tile_size"] = tuple(int(v) for v in rng.randint(16, 64, 2))
        if rng.rand() < 0.5:
            opts["precinct_size"] = (int(2 ** rng.randint(4, 7)),) * 2
        if rng.rand() < 0.5:
            opts["quality_mode"] = "rates"
            opts["quality_layers"] = sorted(rng.uniform(2, 30, 3),
                                            reverse=True)
        check(tmp_path, img, None if mode in ("L", "I;16", "RGB", "RGBA")
              else mode, **opts)
