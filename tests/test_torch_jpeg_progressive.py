"""Progressive JPEG in the port (utils/jpeg.py, csrc/jpeg_entropy.cpp)
against OpenCV's libjpeg-turbo on the CPU, bit for bit.

- Decoding: files that ``cv2.imencode(..., [IMWRITE_JPEG_PROGRESSIVE, 1])``
  writes here (jpeg_simple_progression: 10 scans for colour, 6 for gray,
  each with its own optimised Huffman tables), in gray, 4:2:0, 4:2:2 and
  4:4:4, at sizes that are not multiples of 8 or 16, quality 50, 95 and
  100, with and without ``IMWRITE_JPEG_RST_INTERVAL``; and the same files
  cut after each scan with EOI appended, which cv2 decodes with libjpeg's
  block smoothing (the first nine AC coefficients estimated from a 5x5
  window of DC values where their bits are missing; the DC too when no AC
  data came). ``read_jpeg`` must return ``cv2.imdecode``'s pixels exactly.
- Files cut anywhere, baseline and progressive, with and without restart
  intervals and an EOI: ``cv2.imread`` (libjpeg's stdio source reads EOI
  markers past the end) reads them, and the port must return its pixels
  (the MCUs after the data left as they are, missing restart markers
  resynchronised, the rows after the data of a cut scan smoothed with the
  coef_bits from before it, a segment cut short read on into EOI bytes).
- Blocks of coefficients and quantisers far beyond what valid data reach:
  the inverse DCT must give cv2's pixels, libjpeg-turbo's SIMD arithmetic
  (16-bit lanes, saturation).
- Encoding: ``encode_jpeg(progressive=True)`` must be cv2's bytes.
- A 12-bit progressive file, which cv2.imread returns no image for, raises
  ValueError naming the file and the kind; a progressive CMYK file
  (Pillow's) and an arithmetic-coded progressive one read as cv2 reads
  them.
- The committed fixtures under tests/data/image (tests/torch_image_common.py
  ``make_fixtures``, OpenCV 5.0.0's libjpeg-turbo 3.1.2) still match cv2
  and the port.
"""
import io
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg as J
from nerfpp_tpu_torch.utils.image import read_image, write_image
from tests.torch_image_common import (FIXTURES, cut_scans, fixture_files,
                                      pattern, prog_source)

torch.set_num_threads(1)

SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(37, 53), (1, 1), (5, 9), (23, 41)]


def encode(img, params):
    """cv2.imencode(".jpg") of an RGB or gray image, progressive."""
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(bgr),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *params])
    assert ok
    return buf.tobytes()


def cv2_decode(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


def decode(data):
    return J.frame_pixels(J.decode_coefficients(data, "t.jpg"), "cpu").numpy()


@pytest.mark.parametrize("sampling", ["gray", *SAMPLING])
def test_decoder_matches_opencv_whole_and_cut(sampling):
    # every size, quality 50 / 95 / 100, without and with restarts every 3
    # MCUs; the whole file and the file cut after each of its scans
    scans = 6 if sampling == "gray" else 10
    for seed, (h, w) in enumerate(SIZES):
        for quality in (50, 95, 100):
            for rst in (0, 3):
                params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                if sampling != "gray":
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               SAMPLING[sampling]]
                data = encode(pattern(h, w, 1 if sampling == "gray" else 3,
                                      seed), params)
                for k in range(1, scans + 1):
                    part = cut_scans(data, k) if k < scans else data
                    want = cv2_decode(part)
                    got = decode(part)
                    assert got.dtype == np.uint8 and got.shape == want.shape
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{h}x{w} q{quality} rst {rst} "
                        f"scans {k}")


def test_cut_files_read_as_cv2_imread_reads_them(tmp_path):
    from tests.torch_jpeg_kinds_common import cv2_read
    for sampling in ("gray", "4:2:0", "4:4:4"):
        for rst in (0, 1, 2, 5):
            for progressive in (False, True):
                params = [cv2.IMWRITE_JPEG_QUALITY, 90,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                          cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
                if sampling != "gray":
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               SAMPLING[sampling]]
                img = pattern(37, 45, 1 if sampling == "gray" else 3, 3)
                ok, buf = cv2.imencode(".jpg", img, params)
                for frac in (0.2, 0.35, 0.5, 0.65, 0.8, 0.95):
                    for tail in (b"", b"\xff\xd9"):
                        cut = buf.tobytes()[:int(buf.size * frac)] + tail
                        want = cv2_read(cut, tmp_path)
                        label = (f"{sampling} restart {rst} progressive "
                                 f"{progressive} cut at {frac} {tail}")
                        if want is None:
                            with pytest.raises(ValueError):
                                decode(cut)
                            continue
                        np.testing.assert_array_equal(decode(cut), want,
                                                      err_msg=label)


def test_idct_of_out_of_range_blocks_is_libjpeg_turbos(tmp_path):
    # baseline files of random blocks, up to 1,023 a coefficient, dense or
    # sparse (rows 1-7 all zero take the SIMD code's shortcut), quantisers
    # up to 255: sums leave 16 bits where libjpeg-turbo keeps them in 16
    from scripts import jpeg_kinds as K
    from tests.torch_jpeg_kinds_common import cv2_read
    rng = np.random.RandomState(0)
    for trial in range(48):
        amp = (5, 50, 200, 1023)[trial % 4]
        blocks = np.zeros((4, 4, 64), np.int16)
        dense = rng.rand(4, 4, 64) < (0.1, 0.5, 1.0)[trial % 3]
        blocks[dense] = rng.randint(-amp, amp + 1, dense.sum())
        blocks[..., 0] = rng.randint(-1000, 1000, (4, 4))
        quant = rng.randint(1, (1, 16, 100, 255)[trial // 4 % 4] + 1, 64)
        plan = K.Plan(32, 32, [K.Component(1, 1, 1, 0, blocks)], {0: quant})
        data = K.huffman_bytes(plan, app=b"")
        np.testing.assert_array_equal(decode(data), cv2_read(data, tmp_path),
                                      err_msg=f"trial {trial}")


def test_block_smoothing_runs_where_libjpeg_runs_it():
    # a whole file: every coefficient bit sent, no smoothing; cut after 5, 7
    # or 9 scans: smoothing, and without it the pixels are not cv2's
    data = encode(pattern(41, 37, 3, 4), [])
    frame = J.decode_coefficients(data)
    assert frame.progressive and not frame.smooth
    assert (frame.coef_bits == 0).all()
    for k in (1, 5, 7, 9):
        part = cut_scans(data, k)
        frame = J.decode_coefficients(part)
        assert frame.smooth, k
        want = cv2_decode(part)
        np.testing.assert_array_equal(J.frame_pixels(frame, "cpu").numpy(),
                                      want)
        frame.smooth = False
        assert not np.array_equal(J.frame_pixels(frame, "cpu").numpy(),
                                  want), k
    # after the first scan no AC coefficient has data: the DC is
    # interpolated too
    assert (J.decode_coefficients(cut_scans(data, 1)).coef_bits[:, 1:]
            == -1).all()


@pytest.mark.parametrize("channels", [3, 1])
def test_encoder_matches_opencv(channels, tmp_path):
    # quality 95 (the default), 50, 100 and 10; the whole file byte for byte
    for seed, (h, w) in enumerate(SIZES + [(16, 16), (33, 17), (64, 48)]):
        img = pattern(h, w, channels, seed)
        for quality in (95, 50, 100, 10):
            want = encode(img, [cv2.IMWRITE_JPEG_QUALITY, quality])
            got = J.encode_jpeg(img, quality, device="cpu", progressive=True)
            assert got == want, (h, w, quality)
    # written progressive, read back through read_image as cv2 reads it
    path = tmp_path / "p.jpg"
    J.write_jpeg(path, torch.from_numpy(img), device="cpu", progressive=True)
    np.testing.assert_array_equal(read_image(path, "cpu").numpy(),
                                  cv2_decode(path.read_bytes()))
    # write_image writes baseline JPEG, as cv2.imwrite does by default
    write_image(tmp_path / "b.jpg", img, "cpu")
    assert (tmp_path / "b.jpg").read_bytes()[:2] == b"\xff\xd8"
    assert b"\xff\xc2" not in (tmp_path / "b.jpg").read_bytes()[:600]
    assert J.decode_coefficients((tmp_path / "b.jpg").read_bytes()
                                 ).progressive is False


def _sof2(precision, comps):
    seg = bytes([precision, 0, 8, 0, 8, comps]) + b"\x01\x11\x00" * comps
    return (b"\xff\xd8\xff\xc2" + (len(seg) + 2).to_bytes(2, "big") + seg
            + b"\xff\xd9")


def test_still_unread_progressive_kinds_raise(tmp_path):
    # cv2.imread returns no image for a 12-bit file: ValueError naming it;
    # it reads progressive CMYK (Pillow's) and arithmetic-coded progressive
    # files (kind None): their pixels
    from PIL import Image
    from scripts import jpeg_kinds as K
    img = pattern(19, 21, 3, 2)
    buf = io.BytesIO()
    Image.fromarray(pattern(19, 21, 4, 3), "CMYK").save(buf, "JPEG",
                                                        progressive=True)
    cases = {"deep.jpg": (_sof2(12, 3), "12-bit"),
             "cmyk.jpg": (buf.getvalue(), None),
             "arith.jpg": (K.arith_bytes(K.plan_of(encode(img, [])),
                                         progressive=True), None)}
    for name, (data, kind) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if kind is None:
            np.testing.assert_array_equal(read_image(path, "cpu").numpy(),
                                          want[..., ::-1])
            continue
        assert want is None
        with pytest.raises(ValueError, match=f"{name}.*{kind}"):
            read_image(path, "cpu")
    # a scan whose progression is not legal is malformed data
    data = encode(pattern(16, 16, 3), [])
    sos = data.index(b"\xff\xda")
    n = data[sos + 4]
    at = sos + 5 + 2 * n + 1                        # Se of the first scan
    bad = data[:at] + b"\x05" + data[at + 1:]
    with pytest.raises(ValueError, match="bad progression"):
        J.decode_coefficients(bad, "bad.jpg")


def test_committed_fixtures_match_opencv_and_the_port():
    files = fixture_files()
    for name, data in files.items():
        if not name.startswith("prog_"):
            continue
        assert (FIXTURES / name).read_bytes() == data, name
        if name == "prog_source.jpg":
            continue
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_decode(data), want)
        np.testing.assert_array_equal(
            J.read_jpeg(FIXTURES / name, "cpu").numpy(), want)
    src = np.load(FIXTURES / "prog_source.npy")
    np.testing.assert_array_equal(src, prog_source())
    assert J.encode_jpeg(src, device="cpu", progressive=True) == files[
        "prog_source.jpg"]
