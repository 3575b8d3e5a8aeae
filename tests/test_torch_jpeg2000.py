"""utils/jpeg2000.py against OpenCV on the CPU: the JPEG 2000 files that
cv2.imwrite writes (OpenCV 5.0.0's OpenJPEG 2.5.3) read by the port as
cv2.imread(IMREAD_UNCHANGED) reads them, bit for bit, in RGB(A) order:

- gray, RGB and RGBA at 8 and 16 bits, at cv2's default rate (lossy 5/3),
  lossless (IMWRITE_JPEG2000_COMPRESSION_X1000 = 1000) and two other
  rates, at 32x32, 33x40 and non-square sizes;
- the JP2 file's codestream cut out as a raw .j2k reads the same;
- the committed fixtures (tests/data/image/jp2_*, cv2's and Pillow's)
  still match the installed cv2 and the port;
- the kinds the port does not read raise NotImplementedError naming the
  file and the kind; the files cv2.imread returns None for raise
  ValueError naming the file;
- files with random bytes of their packets overwritten read as cv2 reads
  them, or raise ValueError where cv2 returns None (a broken header can
  announce more than 109 passes, which OpenJPEG splits into segments).
"""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg2000 as J
from nerfpp_tpu_torch.utils.image import image_format, read_image
from tests.torch_image_common import (FIXTURES, codestream, cv2_jp2, cv2_read,
                                      fixture_files, pattern, pillow_jp2,
                                      to_rgb)

torch.set_num_threads(1)

SIZES = ((32, 32), (33, 40), (57, 34))
RATES = (None, 1000, 500, 100)      # IMWRITE_JPEG2000_COMPRESSION_X1000


def image(kind, h, w, seed):
    """A test image of ``kind`` (gray / rgb / rgba, 8 or 16 bits)."""
    c = {"gray": 1, "rgb": 3, "rgba": 4}[kind.rstrip("0123456789")]
    img = pattern(h, w, c, seed)
    if kind.endswith("16"):
        noise = np.random.RandomState(seed).randint(0, 257, img.shape)
        img = (img.astype(np.uint32) * 257 + noise).clip(0, 65535)
        img = img.astype(np.uint16)
    return img


def cv2_order(img):
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


def decoded(data: bytes):
    return to_rgb(cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_UNCHANGED))


def port(tmp_path, data: bytes, name="f.jp2"):
    path = tmp_path / name
    path.write_bytes(data)
    return read_image(path, "cpu").numpy()


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16",
                                  "rgb16"])
def test_cv2_files_read_as_opencv(kind, tmp_path):
    for seed, (h, w) in enumerate(SIZES):
        img = image(kind, h, w, seed)
        for rate in RATES:
            params = [] if rate is None else [
                cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, rate]
            data = cv2_jp2(cv2_order(img), params)
            want = decoded(data)
            got = port(tmp_path, data)
            assert got.dtype == want.dtype == img.dtype, (kind, h, w, rate)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} "
                                          f"rate {rate}")
            if rate == 1000:
                np.testing.assert_array_equal(got, img)


def test_codestream_cut_out_reads_as_its_jp2(tmp_path):
    for kind in ("rgb8", "gray16", "rgba8"):
        data = cv2_jp2(cv2_order(image(kind, 40, 33, 7)))
        stream = codestream(data)
        assert stream.startswith(J.J2K_SIGNATURE)
        (tmp_path / "a.j2k").write_bytes(stream)
        assert image_format(tmp_path / "a.j2k") == "jpeg2000"
        got = read_image(tmp_path / "a.j2k", "cpu").numpy()
        np.testing.assert_array_equal(got, port(tmp_path, data))
        np.testing.assert_array_equal(got, decoded(stream))


def test_committed_fixtures_match_opencv_and_the_port():
    files = {n: d for n, d in fixture_files().items()
             if n.startswith("jp2_")}
    assert len(files) == 9
    assert sum((FIXTURES / n).stat().st_size
               + (FIXTURES / f"{Path(n).stem}.npy").stat().st_size
               for n in files) < 100_000
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(FIXTURES / name), want)
        got = read_image(FIXTURES / name, "cpu").numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# ----------------------------------------------------- crafted codestreams

def segments(stream: bytes):
    """(offset, marker, segment end) of the main header's marker segments
    up to the first SOT."""
    pos, out = 2, []
    while True:
        code, ln = struct.unpack_from(">HH", stream, pos)
        if code == 0xFF90:
            return out, pos
        out.append((pos, code, pos + 2 + ln))
        pos += 2 + ln


def with_main_marker(stream: bytes, code: int, body: bytes) -> bytes:
    """The codestream with one more marker segment before its first
    SOT."""
    _, sot = segments(stream)
    seg = struct.pack(">HH", code, 2 + len(body)) + body
    return stream[:sot] + seg + stream[sot:]


def patched(stream: bytes, code: int, offset: int, value: bytes) -> bytes:
    """The codestream with ``value`` over the bytes at ``offset`` of the
    body of its main header's ``code`` segment."""
    segs, _ = segments(stream)
    pos = next(p for p, c, _ in segs if c == code) + 4 + offset
    return stream[:pos] + value + stream[pos + len(value):]


def jp2(stream: bytes, extra: bytes = b"", nc: int = 3) -> bytes:
    """A JP2 file around a codestream, ``extra`` boxes in its jp2h."""
    ihdr = struct.pack(">I4sIIHBBBB", 22, b"ihdr", 32, 32, nc, 7, 7, 0, 0)
    colr = struct.pack(">I4sBBBI", 15, b"colr", 1, 0, 0, 16)
    jp2h = ihdr + colr + extra
    return (J.JP2_SIGNATURE + struct.pack(">I4s4sI4s", 20, b"ftyp", b"jp2 ",
                                          0, b"jp2 ")
            + struct.pack(">I4s", 8 + len(jp2h), b"jp2h") + jp2h
            + struct.pack(">I4s", 8 + len(stream), b"jp2c") + stream)


def test_unread_kinds_raise_naming_the_file_and_the_kind(tmp_path):
    stream = codestream(cv2_jp2(cv2_order(image("rgb8", 32, 32, 9))))
    _, sot = segments(stream)
    tile_part = stream[sot:]
    psot = struct.unpack_from(">I", tile_part, 6)[0]
    ppt = struct.pack(">HHB", 0xFF61, 3, 0)
    with_ppt = stream[:sot] + tile_part[:6] + struct.pack(
        ">I", psot + len(ppt)) + tile_part[10:12] + ppt + tile_part[12:]
    pclr = struct.pack(">I4sHBB", 12, b"pclr", 2, 1, 7) + b"\x00\x01"
    cases = {
        "code-block style 0x01 \\(bypass\\)": patched(stream, 0xFF52, 8,
                                                       b"\x01"),
        "code-block style 0x28 \\(vertical causal, segmentation symbols\\)":
            patched(stream, 0xFF52, 8, b"\x28"),
        "code-block style 0x40 \\(high throughput\\)": patched(
            stream, 0xFF52, 8, b"\x40"),
        "a region of interest \\(RGN\\)": with_main_marker(
            stream, 0xFF5E, b"\x00\x00\x03"),
        "a progression order change \\(POC\\)": with_main_marker(
            stream, 0xFF5F, b"\x00\x00\x00\x01\x06\x01"),
        "packed packet headers \\(PPM\\)": with_main_marker(
            stream, 0xFF60, b"\x00"),
        "packed packet headers \\(PPT\\)": with_ppt,
        "sub-sampled components": patched(stream, 0xFF51, 40, b"\x02"),
        "12/12/12-bit samples \\(the port reads 8 and 16 bits\\)": patched(
            stream, 0xFF51, 36, b"\x0b\x01\x01" * 3),
        "the Part 2 multi-component transform 2": patched(stream, 0xFF52, 4,
                                                          b"\x02"),
        "a palette \\(pclr / cmap\\)": jp2(stream, pclr),
    }
    for kind, data in cases.items():
        path = tmp_path / "refused.jp2"
        path.write_bytes(data)
        with pytest.raises(NotImplementedError,
                           match=rf"refused\.jp2: a JPEG 2000 file with "
                           rf"{kind}, which the port does not read"):
            read_image(path, "cpu")


def test_files_opencv_returns_none_for_raise_value_error(tmp_path):
    rgb = pattern(40, 40, 3, 10)
    gray = pattern(40, 40, 1, 11)
    data = cv2_jp2(rgb[..., ::-1])
    stream = codestream(data)
    cases = {
        "two components": pillow_jp2(np.dstack([gray, gray]), "LA"),
        "signed": pillow_jp2(rgb, signed=True),
        "an offset": pillow_jp2(rgb, offset=(3, 5), tile_size=(64, 64)),
        "no EOC": data[:-2],
        "no EOC j2k": stream[:-2],
        "garbage": J.JP2_SIGNATURE + b"\x00" * 40,
        "a jp2c before jp2h": J.JP2_SIGNATURE + data[len(data)
                                                     - len(stream) - 8:],
    }
    for cut in (20, 60, 100, 150, len(data) // 2, len(data) - 3):
        cases[f"cut at {cut}"] = data[:cut]
    for cut in (30, len(stream) // 3, len(stream) - 5):
        cases[f"j2k cut at {cut}"] = stream[:cut]
    for name, blob in cases.items():
        path = tmp_path / "broken.jp2"
        path.write_bytes(blob)
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, name
        with pytest.raises(ValueError, match=r"broken\.jp2: .*cv2\.imread "
                           "returns no image for it"):
            read_image(path, "cpu")


def test_corrupted_packets_read_as_opencv(tmp_path):
    path = tmp_path / "corrupt.jp2"
    # three bytes that make a packet header announce 152 passes for one
    # code-block: OpenJPEG reads them as two segments of 109 and 43
    data = bytearray(cv2_jp2(pattern(40, 40, 3, 6)[..., ::-1]))
    sod = data.find(b"\xff\x93") + 2
    for offset, value in ((42, 242), (321, 119), (532, 208)):
        data[sod + offset] = value
    path.write_bytes(bytes(data))
    np.testing.assert_array_equal(read_image(path, "cpu").numpy(),
                                  cv2_read(path))
    rng = np.random.RandomState(12)
    for i in range(60):
        if i % 2:
            data = pillow_jp2(pattern(45, 38, 3, i), irreversible=i % 3 > 0,
                              quality_mode="rates", quality_layers=[20, 5],
                              progression=J.PROGRESSIONS[i % 5])
        else:
            data = cv2_jp2(pattern(40, 40, 3, i)[..., ::-1])
        data = bytearray(data)
        sod = data.find(b"\xff\x93") + 2
        for _ in range(rng.randint(1, 4)):
            data[rng.randint(sod, len(data) - 2)] = rng.randint(256)
        path.write_bytes(bytes(data))
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if want is None:
            with pytest.raises(ValueError, match=r"corrupt\.jp2"):
                read_image(path, "cpu")
        else:
            np.testing.assert_array_equal(read_image(path, "cpu").numpy(),
                                          to_rgb(want), err_msg=str(i))
