"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive) in the port
(utils/jpeg.py, csrc/jpeg_entropy.cpp: jdarith.c's decoder) against
OpenCV's libjpeg-turbo on the CPU, bit for bit.

The files are cv2's own Huffman files at every sampling OpenCV writes,
their quantised blocks arithmetic-coded again by scripts/jpeg_kinds.py
(jcarith.c's coder): entropy coding is lossless, so cv2 must decode each
to the pixels of the Huffman file, and the port to cv2's pixels, at sizes
1x1, 13x11 and 37x45, with restart intervals of 1 and 3 MCUs and with
non-default DAC conditioning (L, U and Kx of both tables). Then files cut
short (cv2.imread reads what is there, zeros past the end), progressive
files cut after each scan (libjpeg's block smoothing), the DAC checks
and the kinds cv2 returns no image for, and the port's copy of T.81
Table D.2 against the one in the libjpeg-turbo that Pillow carries
(skipped without Pillow).
"""
import ctypes
import glob
import os

import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg as J
from scripts import jpeg_kinds as K
from tests.torch_image_common import cut_scans
from tests.torch_jpeg_kinds_common import (DAC, SAMPLING, SIZES, cv2_read,
                                           huffman_file, port_read)

torch.set_num_threads(1)


def check(data, want, tmp_path, label):
    """cv2 and the port both read ``data`` as ``want``."""
    got = cv2_read(data, tmp_path)
    assert got is not None, label
    np.testing.assert_array_equal(got, want, err_msg=f"cv2: {label}")
    port = port_read(data)
    assert port.dtype == np.uint8 and port.shape == want.shape, label
    np.testing.assert_array_equal(port, want, err_msg=f"port: {label}")


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_sequential_decodes_as_the_huffman_file(sampling, tmp_path):
    for seed, (h, w) in enumerate(SIZES):
        data, want = huffman_file(sampling, h, w, seed)
        plan = K.plan_of(data)
        for restart in (0, 1, 3):
            for dac in (None, DAC):
                check(K.arith_bytes(plan, restart=restart, dac=dac), want,
                      tmp_path, f"{h}x{w} restart {restart} DAC {dac}")
    # SOF9 under table numbers above 3 (arithmetic tables go to 15) and
    # with DHT segments it does not read
    dht = b"".join(K.segment(0xC4, bytes([(tc << 4) | t])
                             + J.STD_HUFFMAN[(tc, t)])
                   for t in (0, 1) for tc in (0, 1))
    n = 1 if sampling == "gray" else 3
    check(K.arith_bytes(plan, tables=[15, 5, 9][:n], app=K.JFIF + dht),
          want, tmp_path, "tables 15, 5, 9")


@pytest.mark.parametrize("sampling", ["gray", "4:2:0"])
def test_progressive_decodes_as_the_huffman_file(sampling, tmp_path):
    for seed, (h, w) in enumerate(SIZES):
        data, want = huffman_file(sampling, h, w, seed)
        plan = K.plan_of(data)
        for restart, dac in ((0, None), (1, DAC), (3, None)):
            check(K.arith_bytes(plan, progressive=True, restart=restart,
                                dac=dac), want, tmp_path,
                  f"{h}x{w} restart {restart} DAC {dac}")
    data, want = huffman_file("4:2:2", 13, 11, 3)
    check(K.arith_bytes(K.plan_of(data), progressive=True), want, tmp_path,
          "4:2:2")
    data, want = huffman_file("4:4:4", 13, 11, 4)
    check(K.arith_bytes(K.plan_of(data), progressive=True), want, tmp_path,
          "4:4:4")


def test_cut_files_read_as_cv2_reads_them(tmp_path):
    # cut mid-scan, with and without an EOI: cv2.imread reads zeros past
    # the end (the restart markers it misses resynchronised); a progressive
    # file cut after each scan takes libjpeg's block smoothing
    data, _ = huffman_file("4:2:0", 37, 45, 5)
    plan = K.plan_of(data)
    files = {"sequential": K.arith_bytes(plan),
             "restarts": K.arith_bytes(plan, restart=2),
             "progressive": K.arith_bytes(plan, progressive=True)}
    for label, whole in files.items():
        for frac in (0.3, 0.6, 0.9):
            cut = whole[:int(len(whole) * frac)]
            for tail in (b"", b"\xff\xd9"):
                want = cv2_read(cut + tail, tmp_path)
                np.testing.assert_array_equal(
                    port_read(cut + tail), want,
                    err_msg=f"{label} cut at {frac} {tail}")
    prog = files["progressive"]
    for k in range(1, 10):
        cut = cut_scans(prog, k)
        want = cv2_read(cut, tmp_path)
        np.testing.assert_array_equal(port_read(cut), want,
                                      err_msg=f"after scan {k}")
    assert J.decode_coefficients(cut_scans(prog, 1)).smooth


def test_unreadable_kinds_raise_naming_the_file(tmp_path):
    data, want = huffman_file("4:2:0", 21, 19, 6)
    arith = K.arith_bytes(K.plan_of(data))
    sof = arith.index(b"\xff\xc9")
    cases = {
        # DAC for table index 40, DC conditioning L 5 above U 2
        "dac_index.jpg": (arith[:sof] + b"\xff\xcc\x00\x04\x28\x01"
                          + arith[sof:], "table index 40"),
        "dac_bounds.jpg": (arith[:sof] + b"\xff\xcc\x00\x04\x00\x25"
                           + arith[sof:], "L 5 above U 2"),
        # lossless arithmetic (SOF11) and a 12-bit arithmetic file
        "sof11.jpg": (arith[:sof + 1] + b"\xcb" + arith[sof + 2:], "SOF11"),
        "deep.jpg": (arith[:sof + 4] + b"\x0c" + arith[sof + 5:], "12-bit")}
    for name, (bad, kind) in cases.items():
        assert cv2_read(bad, tmp_path, name) is None, name
        with pytest.raises(ValueError, match=f"{name}.*{kind}.*no image"):
            J.read_jpeg(tmp_path / name, "cpu")
    # the DAC defaults (L 0, U 1, Kx 5) written out change nothing
    explicit = K.arith_bytes(K.plan_of(data), dac={
        ("dc", 0): (0, 1), ("ac", 0): 5, ("dc", 1): (0, 1), ("ac", 1): 5})
    assert b"\xff\xcc" in explicit and b"\xff\xcc" not in arith
    np.testing.assert_array_equal(port_read(explicit), want)
    np.testing.assert_array_equal(port_read(arith), want)


def test_state_table_is_t81_table_d2():
    # the port's own copy, packed as libjpeg packs jpeg_aritab (Qe << 16 |
    # Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS), against the
    # libjpeg-turbo that Pillow carries
    out = np.zeros(114 * 4, np.int32)
    J.entropy_library().jpeg_arith_states(J._ptr(out, ctypes.c_int32))
    qe, nlps, nmps, switch = out.reshape(114, 4).T.astype(np.int64)
    packed = (qe << 16) | (nmps << 8) | (switch << 7) | nlps
    assert qe[0] == 0x5A1D and (nlps[113], nmps[113]) == (113, 113)
    assert (qe > 0).all() and nlps.max() <= 113 and nmps.max() <= 113
    pil = pytest.importorskip("PIL")
    libs = glob.glob(os.path.join(os.path.dirname(pil.__file__), os.pardir,
                                  "pillow.libs", "libjpeg-*.so*"))
    if not libs:
        pytest.skip("Pillow carries no libjpeg here")
    ref = (ctypes.c_long * 114).in_dll(ctypes.CDLL(libs[0]), "jpeg_aritab")
    np.testing.assert_array_equal(packed, np.asarray(list(ref)))
