"""The port's JPEG codec (utils/jpeg.py, csrc/jpeg_entropy.cpp) against
OpenCV's libjpeg-turbo on the CPU, bit for bit.

- Decoding: files that ``cv2.imencode`` writes here, gray and every
  sampling OpenCV writes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), sizes that
  are not multiples of 8 or 16 (down to 1x1), quality 50, 95 and 100, with
  and without restart intervals, and a file with APP1 and COM segments;
  ``read_jpeg`` must return ``cv2.imread(IMREAD_UNCHANGED)``'s pixels (RGB
  order) exactly.
- Encoding: ``encode_jpeg`` at its defaults must be ``cv2.imencode(".jpg")``
  byte for byte on RGB and gray images of odd sizes (header included).
- Refusals: arithmetic-coded, lossless, 12-bit and 4-component files, and
  BMP, name the file; a missing g++ raises. (Progressive files are read:
  tests/test_torch_jpeg_progressive.py.)
- The committed fixtures under tests/data/jpeg (made by ``make_fixtures``
  below with OpenCV 5.0.0's libjpeg-turbo 3.1.2; run this file as a script
  to write them again) still match the installed cv2, and the port reads
  and writes them; chip_smoke.py holds the card against them.
"""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch import native
from nerfpp_tpu_torch.utils import jpeg as J
from nerfpp_tpu_torch.utils.image import image_format, read_image, write_image

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(37, 53), (1, 1), (16, 16), (5, 9), (2, 31)]


def pattern(h, w, c, seed=0):
    """A smooth image with noise, uint8 [h, w, c] (c = 1: [h, w])."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(xx / 7.0 + k) * np.cos(yy / 5.0 - k)
                    + rng.randn(h, w) * 20 for k in range(c)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def cv2_file(img_rgb, params=()):
    """cv2.imencode(".jpg") of an RGB or gray image, and cv2's decode of it
    in RGB order."""
    bgr = img_rgb[..., ::-1] if img_rgb.ndim == 3 else img_rgb
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(bgr), list(params))
    assert ok
    data = buf.tobytes()
    got = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    return data, (got[..., ::-1] if got.ndim == 3 else got)


def decode(data):
    return J.frame_pixels(J.decode_coefficients(data, "test.jpg"),
                          "cpu").numpy()


@pytest.mark.parametrize("sampling", ["gray", *SAMPLING])
def test_decoder_matches_opencv(sampling):
    # every size, quality 50 / 95 / 100, without and with restarts every 3
    # MCUs: cv2's pixels exactly
    for seed, (h, w) in enumerate(SIZES):
        for quality in (50, 95, 100):
            for rst in (0, 3):
                params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                if sampling != "gray":
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               SAMPLING[sampling]]
                img = pattern(h, w, 1 if sampling == "gray" else 3, seed)
                data, want = cv2_file(img, params)
                got = decode(data)
                assert got.dtype == np.uint8 and got.shape == want.shape
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{h}x{w} q{quality} rst {rst}")


def test_decoder_skips_app1_and_com_segments(tmp_path):
    # an EXIF-like APP1 (orientation ignored, as IMREAD_UNCHANGED does) and
    # a COM segment between SOI and the frame; read through read_image
    data, want = cv2_file(pattern(21, 34, 3))
    exif = b"Exif\0\0MM\0*\0\0\0\x08\0\x01\x01\x12\0\x03\0\0\0\x01\0\x06\0\0"
    extra = (b"\xff\xe1" + struct.pack(">H", len(exif) + 2) + exif
             + b"\xff\xfe" + struct.pack(">H", 7) + b"hello")
    path = tmp_path / "exif.jpg"
    path.write_bytes(data[:2] + extra + data[2:])
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1], want)
    assert image_format(path) == "jpeg"
    got = read_image(path, "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("channels", [3, 1])
def test_encoder_matches_opencv(channels, tmp_path):
    # quality 95 (the default), 50 and 100; the whole file byte for byte
    for seed, (h, w) in enumerate(SIZES + [(33, 17), (64, 48)]):
        img = pattern(h, w, channels, seed)
        for quality in (95, 50, 100):
            want, _ = cv2_file(img, [cv2.IMWRITE_JPEG_QUALITY, quality])
            got = J.encode_jpeg(img, quality, device="cpu")
            assert got == want, (h, w, quality)
    # write_image goes by the extension, as cv2.imwrite does
    write_image(tmp_path / "a.jpg", torch.from_numpy(img), "cpu")
    assert (tmp_path / "a.jpg").read_bytes() == cv2_file(img)[0]
    write_image(tmp_path / "a.png", img, "cpu")
    np.testing.assert_array_equal(read_image(tmp_path / "a.png", "cpu")
                                  .numpy(), img)
    with pytest.raises(NotImplementedError, match=r"a\.bmp.*\.bmp"):
        write_image(tmp_path / "a.bmp", img, "cpu")


def _header_only(sof: bytes) -> bytes:
    return b"\xff\xd8" + sof + b"\xff\xd9"


def test_unread_files_raise_naming_the_file(tmp_path):
    img = pattern(24, 24, 3)
    cases = {"lossless.jpg": (_header_only(b"\xff\xc3\x00\x11\x08\x00\x08"
                                           b"\x00\x08\x03"
                                           + b"\x01\x11\x00" * 3),
                              "lossless"),
             "cmyk.jpg": (_header_only(b"\xff\xc0\x00\x14\x08\x00\x08\x00"
                                       b"\x08\x04" + b"\x01\x11\x00" * 4),
                          "CMYK"),
             "deep.jpg": (_header_only(b"\xff\xc1\x00\x11\x0c\x00\x08\x00"
                                       b"\x08\x03" + b"\x01\x11\x00" * 3),
                          "12-bit"),
             "arith.jpg": (_header_only(b"\xff\xc9\x00\x11\x08\x00\x08\x00"
                                        b"\x08\x03" + b"\x01\x11\x00" * 3),
                           "arithmetic")}
    for name, (data, kind) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(NotImplementedError, match=f"{name}.*{kind}"):
            read_image(tmp_path / name, "cpu")
    assert cv2.imwrite(str(tmp_path / "view.bmp"), img)
    with pytest.raises(NotImplementedError, match=r"view\.bmp.*BMP"):
        read_image(tmp_path / "view.bmp", "cpu")
    (tmp_path / "junk.jpg").write_bytes(b"not an image")
    with pytest.raises(NotImplementedError, match=r"junk\.jpg.*unknown"):
        read_image(tmp_path / "junk.jpg", "cpu")
    # a baseline scan header with zeros where 0, 63, 0 belongs is read, as
    # libjpeg reads it (with a warning)
    data, want = cv2_file(img)
    sos = data.index(b"\xff\xda")
    at = sos + 5 + 2 * data[sos + 4]
    zeroed = data[:at] + b"\0\0\0" + data[at + 3:]
    np.testing.assert_array_equal(decode(zeroed), want)
    # a truncated scan of a readable file is data, not a format: ValueError
    (tmp_path / "cut.jpg").write_bytes(data[:200])
    with pytest.raises(ValueError, match=r"cut\.jpg"):
        J.read_jpeg(tmp_path / "cut.jpg", "cpu")


def test_missing_compiler_raises(tmp_path, monkeypatch):
    # the entropy coder has no Python fallback: without g++ the build
    # raises, naming it
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found.*jpeg_entropy"):
        native.build_library(J.SOURCE, J.CXX_FLAGS, build_dir=tmp_path)
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------------------- fixtures

def fixture_specs():
    """{name: (RGB or gray image, cv2.imencode parameters)} of the
    committed decode fixtures."""
    return {"yuv420_21x27": (pattern(21, 27, 3, 1),
                             [cv2.IMWRITE_JPEG_QUALITY, 90]),
            "yuv422_rst_16x24": (pattern(16, 24, 3, 2),
                                 [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                                  cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
            "gray_13x11": (pattern(13, 11, 1, 3), []),
            "q100_12x12": (pattern(12, 12, 3, 4),
                           [cv2.IMWRITE_JPEG_QUALITY, 100])}


def encode_source():
    """The image of the committed encode fixture (source.npy, RGB)."""
    return pattern(19, 23, 3, 5)


def make_fixtures(out=FIXTURES):
    """Write <name>.jpg and <name>.npy (cv2.imread's pixels in RGB order)
    of each spec, and source.npy with source.jpg, its cv2.imencode bytes
    at the defaults."""
    out.mkdir(parents=True, exist_ok=True)
    for name, (img, params) in fixture_specs().items():
        data, pixels = cv2_file(img, params)
        (out / f"{name}.jpg").write_bytes(data)
        np.save(out / f"{name}.npy", pixels)
    np.save(out / "source.npy", encode_source())
    (out / "source.jpg").write_bytes(cv2_file(encode_source())[0])


def test_committed_fixtures_match_opencv_and_the_port():
    for name, (img, params) in fixture_specs().items():
        data, pixels = cv2_file(img, params)
        assert (FIXTURES / f"{name}.jpg").read_bytes() == data, name
        want = np.load(FIXTURES / f"{name}.npy")
        np.testing.assert_array_equal(pixels, want)
        np.testing.assert_array_equal(
            J.read_jpeg(FIXTURES / f"{name}.jpg", "cpu").numpy(), want)
    src = np.load(FIXTURES / "source.npy")
    np.testing.assert_array_equal(src, encode_source())
    want = (FIXTURES / "source.jpg").read_bytes()
    assert cv2_file(src)[0] == want
    assert J.encode_jpeg(src, device="cpu") == want
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 16384


if __name__ == "__main__":
    make_fixtures()
