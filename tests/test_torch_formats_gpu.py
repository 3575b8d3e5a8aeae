"""The uncompressed, run-length and float image formats on the card against
the CPU and the committed cv2 fixtures (marker ``cuda``: skipped without a
card; the card's machine has no OpenCV, so this file imports none, and
``--noconftest`` runs it without JAX):

    python -m pytest --noconftest tests/test_torch_formats_gpu.py -q

- every committed BMP, PBM / PGM / PPM / PAM / PFM, Radiance HDR, Sun
  raster and signed or float TIFF fixture (tests/data/image) decoded on the
  card to cv2's pixels (its .npy) and the CPU's;
- the undistortion and resize of float32, float64 and int16 images on the
  card bit for bit the CPU's;
- each format written from an image on the card with the CPU's bytes;
- every committed WebP fixture (tests/data/image/webp_*: lossy, lossy with
  alpha, lossless, VP8X with ICCP and EXIF) decoded on the card to cv2's
  pixels and the CPU's, the 800x800 lossy timing file
  (tests/data/webp) and random YUV
  planes of odd and even sizes through the card's upsampling and colour
  conversion bitwise the CPU's, and a lossless WebP written from the card
  with the CPU's bytes;
- every committed animated and transparent WebP (tests/data/webp:
  anim_*, transparent_*) decoded on the card to cv2's pixels, each
  transparent one written again from the card (libwebp's rewrite under
  alpha 0) and read back as them, and the 800x800 masked view's 4,000 x
  3,000 upscale, resized on the card, rewritten to the digest of cv2's
  pixels;
- every committed TIFF kind fixture (tests/data/image/tiff_*: BigTIFF,
  JPEG-in-TIFF, YCbCr, CMYK, gray with alpha, 1- to 14-bit samples,
  orientations; CCITT RLE, RLEW, Group 3 and Group 4, CIE L*a*b* of 8 and
  16 bits, uint64 and int64, YCbCr 4x4, planar and palette JPEG-in-TIFF,
  LogL, LogLuv, ThunderScan)
  decoded on the card to cv2's pixels and the CPU's, and its host part
  decoded once for both, and random CIE L*a*b* samples of 8 and 16 bits
  through the card's ``lab_rgb`` bitwise the CPU's;
- every committed JPEG 2000 fixture (tests/data/image/jp2_*: cv2's and
  Pillow's, 5/3 and 9/7, tiles, precincts, layers, YCbCr, 16 bits, raw
  codestreams) decoded on the card to cv2's pixels and the CPU's, and
  .jp2 files written from the card with the CPU's bytes;
- every committed GIF fixture (tests/data/image/gif*: cv2's, Pillow's and
  scripts/gif_kinds.py's) decoded on the card to cv2's pixels and the
  CPU's, and each committed writer input (gifw_*.input.npy) encoded from
  the card to cv2.imwrite's committed bytes.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import image as I

pytestmark = pytest.mark.cuda

FIXTURES = Path(__file__).resolve().parent / "data" / "image"
NEW_KINDS = (".bmp", ".pbm", ".pgm", ".ppm", ".pam", ".pfm", ".hdr", ".ras")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_fixtures_on_the_card_are_the_cpus_and_opencvs(cuda):
    files = sorted(f for f in FIXTURES.iterdir() if f.suffix in NEW_KINDS
                   or (f.suffix == ".tif" and f.stem.startswith(
                       ("tif_float", "tif_int"))))
    assert len(files) == 23
    for f in files:
        card = I.read_image(f, cuda)
        assert card.device.type == cuda.type
        want = np.load(f.with_suffix(".npy"))
        got = card.cpu().numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
        np.testing.assert_array_equal(got, I.read_image(f, "cpu").numpy())


def test_float_and_int16_resampling_on_the_card_is_the_cpus(cuda):
    rng = np.random.RandomState(2)
    for dtype, (h, w), c in ((np.float32, (48, 64), 3),
                             (np.float64, (29, 37), 1),
                             (np.int16, (40, 50), 3)):
        x = rng.randn(h, w, c) * np.exp(rng.randn(h, w, c) * 3)
        img = torch.from_numpy((x * 3000).astype(dtype) if dtype == np.int16
                               else x.astype(dtype))
        k = np.array([[1.1 * w, 0, w / 2 + 0.3], [0, 1.11 * w, h / 2 - 0.7],
                      [0, 0, 1]])
        d = (0.01, -0.002, 0.001, -0.001)
        nk = I.optimal_new_camera_matrix(k, d, (w, h), 0.0, "cpu")
        card = I.undistort(img.to(cuda), k, d, nk).cpu()
        assert card.dtype == img.dtype
        assert torch.equal(card, I.undistort(img, k, d, nk))
        for oh, ow in ((h // 2, w // 2), (h + 7, w - 5), (2 * h + 1, 3 * w)):
            assert torch.equal(I.resize_stored(img.to(cuda), (oh, ow)).cpu(),
                               I.resize_stored(img, (oh, ow)))


def test_writes_from_the_card_are_the_cpus(cuda, tmp_path):
    rng = np.random.RandomState(3)
    u8 = torch.from_numpy(rng.randint(0, 256, (9, 13, 3)).astype(np.uint8))
    u16 = torch.from_numpy(rng.randint(0, 65536, (9, 13, 3)).astype(
        np.uint16))
    f32 = torch.from_numpy((rng.rand(9, 13, 3) * 40).astype(np.float32))
    for ext, img in ((".bmp", u8), (".ppm", u16), (".pgm", u8[..., 0]),
                     (".pbm", u8[..., 0]), (".pam", u8), (".ras", u8),
                     (".pfm", f32), (".hdr", f32), (".tif", f32),
                     (".webp", u8)):
        I.write_image(tmp_path / f"card{ext}", img.to(cuda), cuda)
        I.write_image(tmp_path / f"cpu{ext}", img, "cpu")
        assert (tmp_path / f"card{ext}").read_bytes() == (
            tmp_path / f"cpu{ext}").read_bytes(), ext


def test_webp_on_the_card_is_the_cpus_and_opencvs(cuda):
    from nerfpp_tpu_torch.utils import webp as W
    files = sorted(FIXTURES.glob("webp_*.webp"))
    assert len(files) == 7
    timing = FIXTURES.parent / "webp" / "timing_800x800.webp"
    for f in files + [timing]:
        card = I.read_image(f, cuda)
        assert card.device.type == cuda.type and card.dtype == torch.uint8
        got = card.cpu().numpy()
        np.testing.assert_array_equal(got, I.read_image(f, "cpu").numpy(),
                                      err_msg=f.name)
        if f != timing:
            np.testing.assert_array_equal(got, np.load(f.with_suffix(".npy")),
                                          err_msg=f.name)
    rng = np.random.RandomState(4)
    for h, w in ((1, 1), (2, 3), (7, 8), (33, 65), (480, 641)):
        y = torch.from_numpy(rng.randint(0, 256, (h, w)).astype(np.uint8))
        u, v = (torch.from_numpy(rng.randint(
            0, 256, ((h + 1) // 2, (w + 1) // 2)).astype(np.uint8))
            for _ in range(2))
        assert torch.equal(W.yuv_to_rgb(y.to(cuda), u.to(cuda), v.to(cuda))
                           .cpu(), W.yuv_to_rgb(y, u, v)), (h, w)


def test_animated_and_transparent_webp_on_the_card_are_opencvs(cuda,
                                                                tmp_path):
    import hashlib

    from nerfpp_tpu_torch.utils import webp as W
    webp = FIXTURES.parent / "webp"
    anims = sorted(webp.glob("anim_*.webp"))
    holed = sorted(webp.glob("transparent_*.webp"))
    assert len(anims) == 7 and len(holed) == 7
    for f in anims + holed:
        card = I.read_image(f, cuda)
        assert card.device.type == cuda.type and card.dtype == torch.uint8
        npy = f.with_suffix(".npy")
        want = np.load(npy) if npy.exists() else I.read_image(f, "cpu")\
            .numpy()
        np.testing.assert_array_equal(card.cpu().numpy(), want,
                                      err_msg=f.name)
        if f in holed:
            # written again from the card through libwebp's rewrite under
            # alpha 0: cv2's pixels back
            I.write_image(tmp_path / f.name, card, cuda)
            np.testing.assert_array_equal(
                I.read_image(tmp_path / f.name, cuda).cpu().numpy(), want,
                err_msg=f.name)
    view = I.read_image(webp / "transparent_view_800x800.webp", cuda)
    big = W.argb_image(I.resize_linear_u8(view, (3000, 4000)))
    assert W.transparent_rewrite(big) == "predictor"
    assert hashlib.sha256(big.tobytes()).hexdigest() == (
        webp / "transparent_4000x3000.sha256").read_text().strip()


def test_tiff_kinds_on_the_card_are_the_cpus_and_opencvs(cuda):
    from nerfpp_tpu_torch.utils import tiff as T
    files = sorted(FIXTURES.glob("tiff_*.tif"))
    assert len(files) == 33
    for f in files:
        dec = T.decode_tiff(f)
        card = T.tiff_pixels(dec, cuda)
        assert card.device.type == cuda.type
        got = card.cpu().numpy()
        want = np.load(f.with_suffix(".npy"))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
        np.testing.assert_array_equal(got, T.tiff_pixels(dec, "cpu").numpy(),
                                      err_msg=f.name)
        np.testing.assert_array_equal(I.read_image(f, cuda).cpu().numpy(),
                                      want, err_msg=f.name)


def test_lab_pixels_on_the_card_are_the_cpus(cuda):
    from nerfpp_tpu_torch.utils import tiff as T
    rng = np.random.RandomState(21)
    for dtype in (np.int8, np.int16):
        info = np.iinfo(dtype)
        lab = torch.from_numpy(rng.randint(info.min, info.max + 1,
                                           (1000, 1000, 3)).astype(dtype))
        for white in (T.lab_white(0.3127, 0.329),
                      T.lab_white(0.34567, 0.3585)):
            card = T.lab_rgb(lab.to(cuda), white)
            assert card.device.type == cuda.type
            assert torch.equal(card.cpu(), T.lab_rgb(lab, white))


def test_jpeg2000_on_the_card_is_the_cpus_and_opencvs(cuda, tmp_path):
    from nerfpp_tpu_torch.utils import jpeg2000 as J
    files = sorted(FIXTURES.glob("jp2_*.jp2")) + sorted(FIXTURES.glob(
        "jp2_*.j2k"))
    assert len(files) == 9
    for f in files:
        dec = J.decode_jpeg2000(f)
        card = J.jpeg2000_pixels(dec, cuda)
        assert card.device.type == cuda.type
        got = card.cpu().numpy()
        want = np.load(f.with_suffix(".npy"))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
        np.testing.assert_array_equal(
            got, J.jpeg2000_pixels(dec, "cpu").numpy(), err_msg=f.name)
    rng = np.random.RandomState(5)
    for shape, dtype in (((40, 52, 3), np.uint8), ((33, 45), np.uint16),
                         ((64, 32, 4), np.uint8)):
        img = torch.from_numpy(rng.randint(0, np.iinfo(dtype).max + 1, shape)
                               .astype(dtype))
        assert J.encode_jpeg2000(img.to(cuda), cuda) == J.encode_jpeg2000(
            img, "cpu"), shape


def test_gif_on_the_card_is_the_cpus_and_opencvs(cuda, tmp_path):
    from nerfpp_tpu_torch.utils import gif as G
    files = sorted(FIXTURES.glob("gif*.gif"))
    assert len(files) == 11
    for f in files:
        dec = G.decode_gif(f)
        card = G.gif_pixels(dec, cuda)
        assert card.device.type == cuda.type
        got = card.cpu().numpy()
        want = np.load(f.with_suffix(".npy"))
        np.testing.assert_array_equal(got, want, err_msg=f.name)
        np.testing.assert_array_equal(
            got, G.gif_pixels(dec, "cpu").numpy(), err_msg=f.name)
    inputs = sorted(FIXTURES.glob("gifw_*.input.npy"))
    assert len(inputs) == 4
    for f in inputs:
        img = torch.from_numpy(np.load(f))
        want = (FIXTURES / f.name.replace(".input.npy", ".gif")).read_bytes()
        assert G.encode_gif(img.to(cuda), cuda) == want, f.name
        I.write_image(tmp_path / "card.gif", img.to(cuda), cuda)
        assert (tmp_path / "card.gif").read_bytes() == want, f.name
