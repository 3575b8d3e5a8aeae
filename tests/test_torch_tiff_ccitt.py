"""CCITT fax TIFFs in the port (utils/tiff.py, csrc/tiff_codec.cpp
``tiff_fax_decode``) against ``cv2.imread(path, IMREAD_UNCHANGED)`` on the
CPU, bit for bit ([H, W] uint8 of 0 and 255, MinIsWhite and MinIsBlack
through libtiff's BWmap):

- Pillow's libtiff files: Modified Huffman (compression 2), Group 3
  one-dimensional, two-dimensional (T4Options bit 0) with and without
  fill bits (bit 2), Group 4, in strips, FillOrder 1 and 2, both
  photometrics, widths past 2,560 (extended make-up codes);
- scripts/fax_kinds.py's files: word-aligned RLEW (compression 32771) at
  even and odd strip offsets, and Group 3 and Group 4 tiles cut by the
  edges;
- cut and corrupt strips (libtiff's decoder keeps the rows before the
  fault and repairs the row at hand; a Group 3 strip whose data ends in
  zeros after an EOL is decoded again from its start without EOLs, and so
  are the image's later strips), an uncompressed-mode extension and EOLs
  where rows are due, each read as cv2 reads it;
- fax compressions of other than 1-bit samples raise ValueError, as cv2
  returns None.
"""
import struct

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import tiff as T
from nerfpp_tpu_torch.utils.image import read_image
from scripts.fax_kinds import EOL, encode_g3, encode_g4, encode_rle, mh_row
from tests.torch_image_common import (cv2_read, fax_image, fax_tiff,
                                      make_tiff, pillow_fax)

torch.set_num_threads(1)

PILLOW = {"rle": ("tiff_ccitt", {}), "g3": ("group3", {}),
          "g3_2d": ("group3", {"292": 1}),
          "g3_2d_fill": ("group3", {"292": 5}), "g4": ("group4", {})}


def check(path, data):
    """The port's read of ``data`` is cv2's, on the CPU and through
    read_image; returns it."""
    path.write_bytes(data)
    want = cv2_read(path)
    assert want is not None, path
    got = T.read_tiff(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(path, "cpu").numpy(), want)
    return got


@pytest.mark.parametrize("kind", sorted(PILLOW))
def test_pillow_fax_files_read_as_opencv_reads_them(tmp_path, kind):
    compression, options = PILLOW[kind]
    rng = np.random.RandomState(sorted(PILLOW).index(kind))
    for h, w, extra in ((1, 1, {}), (23, 2700, {"278": 7}),
                        (17, 37, {"266": 2}), (9, 300, {"262": 0}),
                        (30, 64, {"266": 2, "262": 0, "278": 4})):
        bits = fax_image(rng, h, w, 0.5)
        got = check(tmp_path / "f.tif", pillow_fax(
            bits, compression, **options, **extra))
        np.testing.assert_array_equal(got, bits * 255)


def test_rlew_rows_align_to_the_files_words(tmp_path):
    rng = np.random.RandomState(10)
    for w in (5, 16, 33, 77):
        bits = fax_image(rng, 9, w)
        data = fax_tiff(bits, 32771, lambda b: encode_rle(b, word=True),
                        photometric=0)
        check(tmp_path / "w.tif", data)
        # the strip one byte later: libtiff aligns to the file's words
        check(tmp_path / "odd.tif", shifted(make_tiff(
            bits[..., None], comp=32771, bits=1, photometric=0,
            chunks=[b"\0" + encode_rle(bits, word=True)])))


def shifted(data):
    """The TIFF with its one strip's offset one byte on and its byte count
    one less (the strip written after a pad byte)."""
    out = bytearray(data)
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd:ifd + 2])
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag = struct.unpack("<H", data[e:e + 2])[0]
        if tag in (273, 279):
            (v,) = struct.unpack("<I", data[e + 8:e + 12])
            out[e + 8:e + 12] = struct.pack("<I", v + (1 if tag == 273
                                                         else -1))
    return bytes(out)


def test_fax_tiles_cut_by_the_edges(tmp_path):
    rng = np.random.RandomState(11)
    for comp, encode, extra in ((4, encode_g4, {}),
                                (3, lambda b: encode_g3(b, k=3),
                                 {"extra_tags": [(292, 4, [1])]}),
                                (2, encode_rle, {"fill_order": 2})):
        bits = fax_image(rng, 37, 45, 0.5)
        got = check(tmp_path / "t.tif", fax_tiff(
            bits, comp, encode, tile=(16, 16), photometric=0, **extra))
        np.testing.assert_array_equal(got, (1 - bits) * 255)


@pytest.mark.parametrize("kind", ["g3", "g3_2d", "g4"])
def test_cut_and_corrupt_strips_read_as_opencv_reads_them(tmp_path, kind):
    compression, options = PILLOW[kind]
    rng = np.random.RandomState(12)
    data = pillow_fax(fax_image(rng, 40, 200, 0.6), compression, **options)
    _, tags = T._ifd("f.tif", data)
    at, n = tags[273][0], tags[279][0]
    for cut in (n // 3, n // 2, n - 3, 2):
        check(tmp_path / "cut.tif", data[:at + cut] + bytes(n - cut)
              + data[at + n:])
    for k in range(6):                      # a flipped bit or a zero byte
        pos = at + rng.randint(n)
        flip = bytearray(data)
        flip[pos] ^= 1 << rng.randint(8) if k % 2 else flip[pos]
        check(tmp_path / "bad.tif", bytes(flip))
    # the first of several strips cut: libtiff decodes Group 3 without EOLs
    # from then on, in that strip (again from its start) and the next ones
    data = pillow_fax(fax_image(rng, 40, 200, 0.6), compression,
                      **options, **{"278": 9})
    _, tags = T._ifd("f.tif", data)
    at, n = tags[273][0], tags[279][0]
    for cut in (n // 2, n - 1):
        check(tmp_path / "strips.tif", data[:at + cut] + bytes(n - cut)
              + data[at + n:])


def test_uncompressed_mode_and_stray_eols_read_as_opencv_reads_them(
        tmp_path):
    rng = np.random.RandomState(13)
    bits = fax_image(rng, 6, 40, 0.3)
    rows = [mh_row(r) for r in bits]

    def g3(body):
        s = "".join(body)
        s += "0" * (-len(s) % 8)
        return make_tiff(bits[..., None], comp=3, bits=1, photometric=0,
                         chunks=[int(s, 2).to_bytes(len(s) // 8, "big")],
                         extra_tags=[(292, 4, [3])])
    # a two-dimensional row that switches to uncompressed mode (0000001
    # 111), which libtiff does not decode, then rows as usual
    body = [EOL + "1" + rows[0], EOL + "0" + "0000001111" + "0101" * 9]
    body += [EOL + "1" + r for r in rows[2:]]
    check(tmp_path / "unc.tif", g3(body))
    # an EOL in the middle of a row, a row missing its EOL, garbage first
    body = ["1011", EOL + "1" + rows[0], EOL + "1" + rows[1][:9] + EOL + "1"
            + rows[2], "1" + rows[3]] + [EOL + "1" + r for r in rows[4:]]
    check(tmp_path / "eol.tif", g3(body))
    # Group 4 ended early by its EOFB, and one with a code no table holds
    g4 = encode_g4(bits[:3]) + bytes(4)
    check(tmp_path / "eofb.tif", make_tiff(
        bits[..., None], comp=4, bits=1, photometric=0, chunks=[g4]))
    check(tmp_path / "junk.tif", make_tiff(
        bits[..., None], comp=4, bits=1, chunks=[bytes([0, 0, 0x3F]) * 9]))


def test_fax_of_other_depths_raises_value_error(tmp_path):
    for comp in (2, 3, 4, 32771):
        for dtype, bits in ((np.uint8, None), (np.uint8, 4),
                            (np.uint16, None)):
            path = tmp_path / f"fax{comp}.tif"
            path.write_bytes(make_tiff(np.zeros((4, 8, 1), dtype), comp=comp,
                                       bits=bits, chunks=[bytes(64)]))
            assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
            with pytest.raises(ValueError, match=f"fax{comp}.tif.*fax "
                               "codec takes 1 bit"):
                read_image(path, "cpu")
