"""Lossless JPEG (SOF3, Huffman) in the port (utils/jpeg.py,
csrc/jpeg_entropy.cpp: jdlhuff.c, jddiffct.c and jdlossls.c) against
OpenCV's libjpeg-turbo on the CPU, bit for bit. The files are written by
scripts/jpeg_kinds.py; cv2 and the port must both return the samples
written (shifted down and up again by the point transform):

- predictors 1-7, point transforms 0, 1 and 3, restart intervals of one
  and two MCU rows, gray and RGB, at 1x1, 13x11 and 37x45;
- precisions 2-8 (cv2 returns the samples as they are, in uint8);
- sampling 4:2:0 and 4:2:2 (upsampled by replication), interleaved or a
  scan a component, with restarts; four components (CMYK);
- the colour space (ids 1, 2, 3 and unknown ids read as RGB; YCbCr under
  a JFIF or Adobe marker, and YCCK, not read by cv2);
- files cut short (the MCU rows past the data from a reset predictor);
- the kinds cv2.imread returns no image for, JPEG and TIFF: ValueError
  naming the file.
"""
import struct

import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg as J
from nerfpp_tpu_torch.utils import tiff as T
from scripts import jpeg_kinds as K
from tests.torch_image_common import pattern
from tests.torch_jpeg_kinds_common import (SIZES, cv2_read, huffman_file,
                                           port_read)

torch.set_num_threads(1)


def same(data, want, tmp_path, label):
    got = cv2_read(data, tmp_path)
    assert got is not None, label
    np.testing.assert_array_equal(got, want, err_msg=f"cv2: {label}")
    port = port_read(data)
    assert port.dtype == np.uint8 and port.shape == want.shape, label
    np.testing.assert_array_equal(port, want, err_msg=f"port: {label}")


@pytest.mark.parametrize("psv", range(1, 8))
def test_predictors_read_as_cv2(psv, tmp_path):
    for seed, (h, w) in enumerate(SIZES):
        img = pattern(h, w, 3, seed)
        for pt in (0, 1, 3):
            want = (img >> pt) << pt
            for rows in (0, 1, 2):
                same(K.lossless_bytes([img[..., 0]], psv=psv, pt=pt,
                                      restart=rows * w), want[..., 0],
                     tmp_path, f"gray {h}x{w} Pt {pt} rows {rows}")
            same(K.lossless_bytes([img[..., c] for c in range(3)], psv=psv,
                                  pt=pt, restart=w), want, tmp_path,
                 f"RGB {h}x{w} Pt {pt}")


def test_precisions_2_to_8(tmp_path):
    img = pattern(37, 45, 1, 9)
    for precision in range(2, 9):
        x = img >> (8 - precision)
        for pt in (0, precision - 1):
            same(K.lossless_bytes([x], precision=precision, psv=4, pt=pt),
                 (x >> pt) << pt, tmp_path, f"{precision} bits, Pt {pt}")


def test_sampling_scans_and_components(tmp_path):
    img = pattern(37, 45, 3, 10)
    for name, samp, sub in (("4:2:0", [(2, 2), (1, 1), (1, 1)], (2, 2)),
                            ("4:2:2", [(2, 1), (1, 1), (1, 1)], (1, 2))):
        planes = [img[..., 0], img[::sub[0], ::sub[1], 1],
                  img[::sub[0], ::sub[1], 2]]
        want = np.stack([planes[0]] + [
            np.repeat(np.repeat(p, sub[0], 0), sub[1], 1)[:37, :45]
            for p in planes[1:]], -1)
        for interleave, restart in ((True, 0), (True, 23), (False, 0)):
            same(K.lossless_bytes(planes, samp, psv=6, restart=restart,
                                  interleave=interleave, ids=(82, 71, 66)),
                 want, tmp_path, f"{name} interleave {interleave}")
    # a scan a component with restarts, and four components (Adobe CMYK)
    same(K.lossless_bytes([img[..., c] for c in range(3)], interleave=False,
                          restart=90), img, tmp_path, "three scans")
    k = pattern(37, 45, 1, 11)
    cmyk = [img[..., 0], img[..., 1], img[..., 2], k]
    want = J.cmyk_to_rgb(*(torch.from_numpy(p.astype(np.int64))
                           for p in cmyk)).numpy()
    same(K.lossless_bytes(cmyk, app=K.adobe(0)), want, tmp_path, "CMYK")


def test_colour_space_is_libjpegs(tmp_path):
    img = pattern(13, 11, 3, 12)
    planes = [img[..., c] for c in range(3)]
    for ids, app in (((1, 2, 3), b""), ((5, 6, 7), b""), ((1, 2, 3),
                                                           K.adobe(0))):
        same(K.lossless_bytes(planes, ids=ids, app=app), img, tmp_path,
             f"ids {ids}")
    same(K.lossless_bytes([img[..., 0]], app=K.JFIF), img[..., 0], tmp_path,
         "gray under JFIF")
    ycck = [p.numpy() for p in K.ycck_planes(K.cmyk_planes(
        torch.from_numpy(img)))]
    for name, data in (("jfif.jpg", K.lossless_bytes(planes, app=K.JFIF)),
                       ("adobe1.jpg", K.lossless_bytes(planes,
                                                       app=K.adobe(1))),
                       ("ycck.jpg", K.lossless_bytes(ycck, app=K.adobe(2)))):
        assert cv2_read(data, tmp_path, name) is None, name
        with pytest.raises(ValueError, match=f"{name}.*lossless JPEG in Y"):
            J.read_jpeg(tmp_path / name, "cpu")


def test_cut_files_read_as_cv2_reads_them(tmp_path):
    img = pattern(37, 45, 3, 13)
    planes = [img[..., c] for c in range(3)]
    for restart in (0, 4 * 45):
        whole = K.lossless_bytes(planes, psv=5, restart=restart,
                                 ids=(82, 71, 66))
        for frac in (0.3, 0.6, 0.9):
            for tail in (b"", b"\xff\xd9"):
                cut = whole[:int(len(whole) * frac)] + tail
                np.testing.assert_array_equal(
                    port_read(cut), cv2_read(cut, tmp_path),
                    err_msg=f"restart {restart} cut at {frac} {tail}")


def _sof(data, marker=None, precision=None):
    at = next(data.index(bytes([0xFF, m])) for m in (0xC0, 0xC1, 0xC3, 0xC9)
              if bytes([0xFF, m]) in data)
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def _sos(data, index, value):
    at = data.index(b"\xff\xda")
    at += 5 + 2 * data[at + 4] + index
    return data[:at] + bytes([value]) + data[at + 1:]


def test_kinds_cv2_reads_no_image_of_raise_naming_the_file(tmp_path):
    base, _ = huffman_file("4:2:0", 21, 19, 14)
    img = pattern(21, 19, 3, 14)
    lossless = K.lossless_bytes([img[..., 0]])
    cases = {
        "deep12.jpg": (_sof(lossless, precision=12), "12-bit lossless"),
        "deep16.jpg": (_sof(lossless, precision=16), "16-bit lossless"),
        "sof1_12.jpg": (_sof(base, 0xC1, 12), "12-bit JPEG"),
        "ss0.jpg": (_sos(lossless, 0, 0), "predictor 0"),
        "se5.jpg": (_sos(lossless, 1, 5), "Se 5"),
        "al8.jpg": (_sos(lossless, 2, 8), "point transform 8"),
        "restart.jpg": (K.lossless_bytes([img[..., 0]], restart=10),
                        "restart interval 10"),
        "two.jpg": (K.lossless_bytes([img[..., 0], img[..., 1]]),
                    "2 components"),
        "five.jpg": (b"\xff\xd8\xff\xc0\x00\x17\x08\x00\x08\x00\x08\x05"
                     + b"\x01\x11\x00" * 5 + b"\xff\xd9", "5 components"),
        "dnl.jpg": (base[:base.index(b"\xff\xc0") + 5] + b"\0\0"
                    + base[base.index(b"\xff\xc0") + 7:], "DNL"),
        "third.jpg": (K.huffman_bytes(K.planes_plan(
            [img[..., c] for c in range(3)], [(3, 1), (2, 1), (1, 1)])),
            "fractional"),
        "second_soi.jpg": (base[:2] + b"\xff\xd8" + base[2:], "second SOI")}
    for m, kind in ((0xC5, "SOF5"), (0xC6, "SOF6"), (0xC7, "SOF7"),
                    (0xC8, "SOF8"), (0xCB, "SOF11"), (0xCD, "SOF13"),
                    (0xCE, "SOF14"), (0xCF, "SOF15")):
        cases[f"sof{m - 0xC0}.jpg"] = (_sof(base, m), kind)
    for m in (0xDE, 0xDF, 0xF0, 0xFD, 0x02, 0x4F, 0xBF):
        cases[f"marker_{m:02x}.jpg"] = (base[:2] + bytes([0xFF, m, 0, 4, 0, 0])
                                        + base[2:], f"0x{m:02X}")
    for name, (data, kind) in cases.items():
        assert cv2_read(data, tmp_path, name) is None, name
        with pytest.raises(ValueError, match=f"{name}: .*{kind}.*no image"):
            J.read_jpeg(tmp_path / name, "cpu")
    # TIFF compressions whose codec OpenCV's libtiff leaves out: LZMA and
    # Zstandard (Pillow's), WebP and LERC (the tag set by hand); JPEG 2000
    # in TIFF, which libtiff has no codec for, cv2 reads as zeros, and so
    # does the port
    from PIL import Image
    raw = tmp_path / "raw.tif"
    Image.fromarray(img).save(raw)
    for comp, code in (("tiff_lzma", 34925), ("tiff_zstd", 50000)):
        path = tmp_path / f"{comp}.tif"
        Image.fromarray(img).save(path, compression=comp.split("_")[1])
        assert cv2_read(path.read_bytes(), tmp_path, path.name) is None
        with pytest.raises(ValueError, match=f"{path.name}.*no image"):
            T.decode_tiff(path)
    data = bytearray(raw.read_bytes())
    (ifd,) = struct.unpack("<I", data[4:8])
    entry = next(ifd + 2 + 12 * i for i in range(data[ifd])
                 if struct.unpack("<H", data[ifd + 2 + 12 * i:
                                             ifd + 4 + 12 * i])[0] == 259)
    for code, kind in ((50001, "WebP"), (34887, "LERC"),
                       (34712, "JPEG 2000")):
        data[entry + 8:entry + 10] = struct.pack("<H", code)
        path = tmp_path / f"c{code}.tif"
        path.write_bytes(bytes(data))
        cv = cv2_read(bytes(data), tmp_path, path.name)
        if code == 34712:
            assert cv is not None and not cv.any()
            got = T.read_tiff(path)
            assert got.dtype == cv.dtype and got.shape == cv.shape
            assert not got.any()
            continue
        assert cv is None
        with pytest.raises(ValueError, match=f"{path.name}: .*{kind}"):
            T.decode_tiff(path)
