"""JPEG reading and writing, exact to libjpeg-turbo (no image library).

The JAX package reads and writes views through OpenCV, whose JPEG codec is
libjpeg-turbo; the machine with the card has neither OpenCV nor Pillow, so
the port carries this codec. It follows libjpeg-turbo step by step, so that
``read_jpeg`` returns ``cv2.imread(path, IMREAD_UNCHANGED)``'s pixels (in RGB
order) and ``write_jpeg`` writes ``cv2.imwrite``'s bytes
(tests/test_torch_jpeg.py and tests/test_torch_jpeg_progressive.py hold
both to cv2 bit for bit).

Entropy coding is sequential and runs on the host, in C++
(``csrc/jpeg_entropy.cpp``, built with g++ at first use by
``native.build_library``; a missing compiler raises). The pixel stages are
integer arithmetic in PyTorch on the given device, vectorised over all
blocks, so the card's results are the CPU's bit for bit:

- reading: the markers (SOI; SOF0, SOF1 and SOF2 (progressive), SOF9 and
  SOF10 (arithmetic-coded sequential and progressive) at 8 bits, SOF3
  (lossless) at 2-8 bits; DHT, DAC and DQT, also between scans; DQT with
  8- and 16-bit entries; DRI, SOS; APPn and COM skipped, so EXIF
  orientation is ignored as IMREAD_UNCHANGED ignores it), each scan's
  blocks decoded on the host (a progressive file's scans, jdphuff.c's DC
  first and refinement, AC first with EOB runs and AC refinement with its
  correction bits, restarts in any scan, into one coefficient buffer a
  component; an arithmetic-coded scan through jdarith.c's QM decoder, its
  DC bins conditioned by the DAC values, or libjpeg's defaults L 0, U 1
  and Kx 5; a lossless scan's differences undone on the host with
  predictors 1-7 and put out shifted by the point transform; a file cut
  short read on into EOI markers, as cv2.imread's stdio source supplies
  them, its MCUs after the data left as they are and missing restart
  markers resynchronised as libjpeg does), then for a
  progressive file libjpeg's block smoothing where it runs
  (``smooth_blocks``: jdcoefct.c's decompress_smooth_data in its
  libjpeg-turbo 2.1 form, when some of the first nine AC coefficients
  are still short of bits: a file cut after some of its scans, never a
  whole file of jpeg_simple_progression; the rows after the data of a
  scan cut short take the coef_bits before it), dequantisation, the ISLOW
  inverse DCT of jidctint.c as libjpeg-turbo's SIMD code runs it (13-bit
  constants, 2 pass bits, DESCALE rounding, 16-bit lanes where it keeps
  them, the result saturated), fancy
  upsampling of jdsample.c (h2v1, h1v2 and h2v2 with their 1/2 and 8/7
  biases, the last real sample row and column repeated at the edges; any
  other integral ratio, and h2v1 or h2v2 of a component at most 2 samples
  wide, by replication), and the integer YCbCr -> RGB tables of jdcolor.c
  (16 scale bits). The colour space is libjpeg's choice: a JFIF marker
  means YCbCr, an Adobe marker's transform 0 RGB and 1 YCbCr, otherwise
  the component ids (1, 2, 3: YCbCr; 'R', 'G', 'B': RGB; a lossless file
  RGB whatever its ids). One component stays gray. Four are CMYK (no
  Adobe marker or transform 0) or YCCK (another transform), which
  jdcolor.c's ycck_cmyk_convert makes CMYK; cv2 then turns CMYK into 3
  channels (OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on Adobe's inverted
  values). A lossless file's samples are upsampled by replication (no
  fancy upsampling without a DCT) and converted by no table.
- writing: ``cv2.imwrite(".jpg")`` at its defaults: quality 95, 4:2:0
  YCbCr for colour and one component for gray, baseline, the standard
  Huffman tables, no optimisation, no restarts. jccolor.c's RGB -> YCbCr,
  the edge samples repeated out to the blocks, h2v2_downsample (biases 1
  and 2 in turn), the ISLOW forward DCT of jfdctint.c, libjpeg-turbo's
  quantisation by reciprocal multiplication, the quality scaling of
  jpeg_set_quality (clamped to 1-255), the dummy blocks of jccoefct.c at
  the right and bottom edges of an MCU, and the markers as libjpeg writes
  them: JFIF 1.01 APP0, one DQT per table, SOF0, one DHT per table, SOS.
  With ``progressive``, ``cv2.imwrite(path, img,
  [IMWRITE_JPEG_PROGRESSIVE, 1])``: SOF2 and jpeg_simple_progression's
  scans (10 for colour, 6 for gray), each coded by jcphuff.c with its own
  optimal tables (jchuff.c's jpeg_gen_optimal_table over a gathering
  pass), a DHT segment before each scan that codes with one. Only
  scripts/colmap_export.py and chip_smoke.py write progressive files.

Every file is either read as cv2.imread reads it or raises ValueError
naming the file: the kinds libjpeg-turbo refuses through the 8-bit
interface that OpenCV calls, for which cv2.imread returns None (12-bit
and 9-16-bit lossless files; hierarchical files, SOF5-7 and SOF13-15, DHP
and EXP; arithmetic-coded lossless files, SOF11; JPGn and RESn markers, a
second SOI; a size left to a DNL marker; 2 or more than 4 components;
fractional sampling ratios; a lossless file in YCbCr or YCCK; a lossless
restart interval that is not whole MCU rows; bad DAC values), and
malformed data.
"""
from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import native, resolve_device

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "jpeg_entropy.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

# natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU T.81 Annex K.1 quantisation tables, natural order
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_QUANT = np.full(64, 99)
CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3 Huffman tables: 16 code counts, then the symbols;
# {(class, id)}, class 0 DC and 1 AC, id 0 luminance and 1 chrominance
STD_HUFFMAN = {k: bytes.fromhex(v) for k, v in {
    (0, 0): "00010501010101010100000000000000000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d01020300041105122131410613516107"
            "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
            "292a3435363738393a434445464748494a535455565758595a63646566676869"
            "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
            "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
            "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (0, 1): "00030101010101010101010000000000000102030405060708090a0b",
    (1, 1): "0002010204040304070504040001027700010203110405213106124151076171"
            "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
            "2728292a35363738393a434445464748494a535455565758595a636465666768"
            "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
            "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
            "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"}.items()}

# start-of-frame markers that libjpeg-turbo refuses (cv2.imread returns no
# image), by kind
SOF_KINDS = {0xC5: "a hierarchical (differential sequential)",
             0xC6: "a hierarchical (differential progressive)",
             0xC7: "a hierarchical (differential lossless)",
             0xC8: "a JPG extension",
             0xCB: "an arithmetic-coded lossless",
             0xCD: "an arithmetic-coded hierarchical (differential "
                   "sequential)",
             0xCE: "an arithmetic-coded hierarchical (differential "
                   "progressive)",
             0xCF: "an arithmetic-coded hierarchical (differential "
                   "lossless)"}
# the start-of-frame markers read: DCT Huffman (baseline, extended,
# progressive), lossless Huffman, DCT arithmetic (extended, progressive)
SOF_READ = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
# what a file reads as past its end: EOI markers, enough for any segment
EOF_FILL = b"\xff\xd9" * 32768
# DAC defaults (set at SOI): L 0 and U 1 of each DC table, Kx 5 of each AC
# table, 16 tables each
DAC_DEFAULTS = np.array([0] * 16 + [1] * 16 + [5] * 16, np.uint8)
# block smoothing (jdcoefct.c): coef_bits kept for the DC and the first 9 AC
# coefficients in zigzag order, at these natural positions
SAVED_COEFS = 10
SMOOTH_POS = ZIGZAG[:SAVED_COEFS]
ENTROPY_ERRORS = {-1: "an invalid Huffman table", -2: "a bad Huffman code",
                  -4: "a bad scan header", -5: "no room for the scan",
                  -6: "a coefficient out of range"}

_lib = None


def entropy_library() -> ctypes.CDLL:
    """The entropy coder, built with g++ on first use (raises without
    it)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX_FLAGS)))
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.jpeg_decode_scan.restype = ctypes.c_int64
        lib.jpeg_decode_scan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i32p, i32p,
            i32p, u8p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.jpeg_encode_scan.restype = ctypes.c_int64
        lib.jpeg_encode_scan.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, i32p,
            ctypes.c_int32, i32p, u8p, u8p, u8p, ctypes.c_int64]
        i32 = ctypes.c_int32
        lib.jpeg_decode_progressive_scan.restype = ctypes.c_int64
        lib.jpeg_decode_progressive_scan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i32, i32p, i32p, i32p, u8p,
            u8p, i32, i32, i32, i32, i32, i32, i32, i32, i32p,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.jpeg_decode_arith_scan.restype = ctypes.c_int64
        lib.jpeg_decode_arith_scan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i32, i32p, i32p, i32p, u8p,
            i32, i32, i32, i32, i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.jpeg_decode_lossless_scan.restype = ctypes.c_int64
        lib.jpeg_decode_lossless_scan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i32, i32p, i32p, i32p, u8p,
            u8p, i32, i32, i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.jpeg_arith_states.restype = None
        lib.jpeg_arith_states.argtypes = [i32p]
        lib.jpeg_encode_progressive_scan.restype = ctypes.c_int64
        lib.jpeg_encode_progressive_scan.argtypes = [
            i32, i32p, i32p, i32p, i32, i32, i32, i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_void_p), u8p, u8p, u8p, ctypes.c_int64]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _huffman_arrays(tables: Dict[Tuple[int, int], bytes]):
    """{(class, id): counts + symbols} -> counts [8, 16] and symbols
    [8, 256], slot 4 * class + id."""
    counts = np.zeros((8, 16), np.uint8)
    symbols = np.zeros((8, 256), np.uint8)
    for (tc, th), spec in tables.items():
        counts[4 * tc + th] = np.frombuffer(spec[:16], np.uint8)
        syms = np.frombuffer(spec[16:], np.uint8)
        symbols[4 * tc + th, :len(syms)] = syms
    return counts, symbols


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------------------ reading

@dataclass
class Component:
    id: int
    h: int
    v: int
    tq: int
    quant: Optional[np.ndarray] = None     # natural order, latched at its
    coefs: Optional[np.ndarray] = None     # first scan; int16 [R, C, 64]
    samples: Optional[np.ndarray] = None   # lossless: uint8 [rows, cols]


@dataclass
class Frame:
    """A decoded file before its pixel stages: the size, the components
    with their quantised blocks (a lossless file: their samples), the
    colour space ("gray", "ycc", "rgb", "cmyk", "ycck"), and for a
    progressive file each component's coef_bits (libjpeg's: the point
    transform Al of the last scan of each of the first 10 zigzag
    coefficients, -1 before any scan), its prev_bits (coef_bits before the
    last scan of the component, 0 before the file's first scan), the last
    iMCU row of the last scan begun before its data ran out (libjpeg
    smooths the rows after it with prev_bits) and whether block smoothing
    runs.
    ``arithmetic``: arithmetic-coded, with ``conditioning`` its DAC values
    (L, U of DC tables 0-15, Kx of AC tables 0-15); ``lossless``: SOF3 at
    ``precision`` bits."""
    height: int
    width: int
    components: List[Component]
    colour: str = "ycc"
    scans: int = 0
    progressive: bool = False
    coef_bits: Optional[np.ndarray] = None    # int [n_comp, SAVED_COEFS]
    prev_bits: Optional[np.ndarray] = None    # int [n_comp, SAVED_COEFS]
    last_good: int = 1 << 30
    smooth: bool = False
    arithmetic: bool = False
    lossless: bool = False
    precision: int = 8
    conditioning: Optional[np.ndarray] = None


def _no_image(name, kind: str):
    """A file that libjpeg-turbo refuses: cv2.imread returns None."""
    raise ValueError(f"{name}: {kind}; cv2.imread returns no image for it")


def _frame_header(name, marker: int, seg: bytes) -> Frame:
    if len(seg) < 6:
        raise ValueError(f"{name}: truncated SOF{marker - 0xC0} segment")
    precision, height, width, n = struct.unpack(">BHHB", seg[:6])
    lossless = marker == 0xC3
    if precision != 8 and not (lossless and 2 <= precision <= 8):
        # libjpeg-turbo reads 12-bit files, and lossless files of 9-16
        # bits, only through its 12- and 16-bit interfaces, which OpenCV
        # does not call; lossless samples of 2-7 bits come back as they are
        _no_image(name, f"a {precision}-bit {'lossless ' * lossless}JPEG")
    if n not in (1, 3, 4):
        _no_image(name, f"a JPEG of {n} components (libjpeg converts 1, 3 "
                  "and 4 to BGR)")
    if height == 0 or width == 0:
        _no_image(name, "a JPEG whose size is set by a DNL marker")
    if len(seg) < 6 + 3 * n:
        raise ValueError(f"{name}: truncated SOF{marker - 0xC0} segment")
    comps = []
    for i in range(n):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4 and tq <= 3):
            raise ValueError(f"{name}: bad component {cid} (sampling {h}x{v},"
                             f" table {tq})")
        comps.append(Component(cid, h, v, tq))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    if any(hmax % c.h or vmax % c.v for c in comps):
        _no_image(name, f"fractional sampling ratios "
                  f"{[(c.h, c.v) for c in comps]}")
    progressive = marker in (0xC2, 0xCA)
    bits = np.full((n, SAVED_COEFS), -1, np.int64) if progressive else None
    return Frame(height, width, comps, progressive=progressive,
                 coef_bits=bits, prev_bits=None if bits is None else
                 np.zeros_like(bits), arithmetic=marker in (0xC9, 0xCA),
                 lossless=lossless, precision=precision)


def _arith_segment(name, seg: bytes, cond: np.ndarray) -> None:
    """A DAC segment into ``cond`` (L [16], U [16], Kx [16]), as jdmarker.c
    reads it."""
    if len(seg) % 2:
        _no_image(name, "a DAC segment of odd length")
    for index, val in zip(seg[::2], seg[1::2]):
        if index >= 32:
            _no_image(name, f"a DAC entry for table index {index}")
        if index >= 16:
            cond[32 + index - 16] = val
        elif (val & 15) > (val >> 4):
            _no_image(name, f"DC conditioning L {val & 15} above U "
                      f"{val >> 4}")
        else:
            cond[index], cond[16 + index] = val & 15, val >> 4


def _huffman_segment(name, seg: bytes, tables: dict) -> None:
    pos = 0
    while pos < len(seg):
        tc, th = seg[pos] >> 4, seg[pos] & 15
        counts = seg[pos + 1:pos + 17]
        total = sum(counts)
        if tc > 1 or th > 3 or len(counts) < 16 or total > 256 or (
                pos + 17 + total > len(seg)):
            raise ValueError(f"{name}: bad DHT segment")
        tables[(tc, th)] = seg[pos + 1:pos + 17 + total]
        pos += 17 + total


def _quant_segment(name, seg: bytes, tables: dict) -> None:
    pos = 0
    while pos < len(seg):
        pq, tq = seg[pos] >> 4, seg[pos] & 15
        width = 2 if pq else 1
        raw = seg[pos + 1:pos + 1 + 64 * width]
        if pq > 1 or tq > 3 or len(raw) < 64 * width:
            raise ValueError(f"{name}: bad DQT segment")
        vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int64)
        table = np.zeros(64, np.int64)
        table[ZIGZAG] = vals
        tables[tq] = table
        pos += 1 + 64 * width


def _scan(name, data: np.ndarray, pos: int, seg: bytes, frame: Frame,
          quant: dict, huffman: dict, restart: int) -> int:
    """Decode the scan whose SOS segment is ``seg`` and whose data starts
    at ``pos``; returns where reading stopped."""
    n = seg[0]
    if not 1 <= n <= 4 or len(seg) < 4 + 2 * n:
        raise ValueError(f"{name}: bad SOS segment")
    ss, se, a = seg[1 + 2 * n:4 + 2 * n]
    ah, al = a >> 4, a & 15
    # a sequential scan's Ss, Se, Ah and Al are not read: libjpeg only warns
    # when they are not 0, 63, 0, 0 (some baseline files hold zeros there)
    if frame.progressive and (
            (se != 0 if ss == 0 else (ss > se or se > 63 or n != 1))
            or (ah and al != ah - 1) or al > 13):
        raise ValueError(f"{name}: bad progression: a scan of {n} "
                         f"component(s), band {ss}-{se}, approximation "
                         f"{ah}/{al}")
    if frame.lossless and not (1 <= ss <= 7 and se == 0 and ah == 0
                               and al < frame.precision):
        _no_image(name, f"a lossless scan of predictor {ss}, Se {se}, Ah "
                  f"{ah}, point transform {al}")
    # the Huffman tables a scan reads: both (sequential), DC (DC first,
    # lossless), AC (AC); an arithmetic scan reads none
    needs = (() if frame.arithmetic else (0,) if frame.lossless else
             (0, 1) if not frame.progressive else
             () if ss == 0 and ah else (0,) if ss == 0 else (1,))
    by_id = {c.id: c for c in frame.components}
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    unit = 1 if frame.lossless else 8          # samples a block across
    mcus = (_ceil_div(frame.height, unit * vmax),
            _ceil_div(frame.width, unit * hmax))
    comps, tables = [], []
    for i in range(n):
        cid, t = seg[1 + 2 * i:3 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{name}: scan of unknown component {cid}")
        c = by_id[cid]
        for key in [((0, t >> 4), (1, t & 15))[k] for k in needs]:
            if key not in huffman:
                raise ValueError(f"{name}: scan uses undefined Huffman "
                                 f"table {key}")
        if frame.lossless:
            if c.samples is None:
                c.samples = np.zeros(
                    (_ceil_div(frame.height * c.v, vmax),
                     _ceil_div(frame.width * c.h, hmax)), np.uint8)
        elif c.quant is None:
            if c.tq not in quant:
                raise ValueError(f"{name}: undefined quantisation table "
                                 f"{c.tq}")
            c.quant = quant[c.tq].copy()
            c.coefs = np.zeros((mcus[0] * c.v, mcus[1] * c.h, 64), np.int16)
        comps.append(c)
        tables.append((t >> 4, t & 15))
    if n == 1:                    # one block an MCU over the real blocks
        c = comps[0]
        hv = [(1, 1)]
        mcus = (_ceil_div(_ceil_div(frame.height * c.v, vmax), unit),
                _ceil_div(_ceil_div(frame.width * c.h, hmax), unit))
    else:
        hv = [(c.h, c.v) for c in comps]
    lib = entropy_library()
    hv = np.asarray(hv, np.int32)
    tab = np.asarray(tables, np.int32)
    if frame.lossless:
        if restart % mcus[1]:
            _no_image(name, f"a lossless scan whose restart interval "
                      f"{restart} is not a whole number of MCU rows of "
                      f"{mcus[1]}")
        counts, symbols = _huffman_arrays(huffman)
        size = np.asarray([(*c.samples.shape, c.v) for c in comps], np.int32)
        dc = np.ascontiguousarray(tab[:, 0])
        ptrs = (ctypes.c_void_p * n)(*[c.samples.ctypes.data for c in comps])
        end = lib.jpeg_decode_lossless_scan(
            _ptr(data, ctypes.c_uint8), data.size, pos, n,
            _ptr(hv, ctypes.c_int32), _ptr(size, ctypes.c_int32),
            _ptr(dc, ctypes.c_int32), _ptr(counts, ctypes.c_uint8),
            _ptr(symbols, ctypes.c_uint8), mcus[1], mcus[0], restart, ss,
            al, frame.precision, ptrs)
    else:
        grid = np.asarray([c.coefs.shape[:2] for c in comps], np.int32)
        ptrs = (ctypes.c_void_p * n)(*[c.coefs.ctypes.data for c in comps])
        head = (_ptr(data, ctypes.c_uint8), data.size, pos, n,
                _ptr(hv, ctypes.c_int32), _ptr(grid, ctypes.c_int32),
                _ptr(tab, ctypes.c_int32))
        if frame.progressive:          # jdphuff.c's / jdarith.c's start_pass
            for c in comps:            # bookkeeping
                i = frame.components.index(c)
                frame.prev_bits[i, 1:] = (frame.coef_bits[i, 1:]
                                          if frame.scans else 0)
                hi = min(se, SAVED_COEFS - 1)
                if ss <= hi:
                    frame.coef_bits[i, ss:hi + 1] = al
        if frame.arithmetic:
            end = lib.jpeg_decode_arith_scan(
                *head, _ptr(frame.conditioning, ctypes.c_uint8), mcus[1],
                mcus[0], restart, int(frame.progressive), ss, se, ah, al,
                ptrs)
        else:
            counts, symbols = _huffman_arrays(huffman)
            args = head + (_ptr(counts, ctypes.c_uint8),
                           _ptr(symbols, ctypes.c_uint8), mcus[1], mcus[0],
                           restart)
            if frame.progressive:
                good = np.zeros(1, np.int32)
                end = lib.jpeg_decode_progressive_scan(
                    *args, ss, se, ah, al, 1 if n > 1 else comps[0].v,
                    _ptr(good, ctypes.c_int32), ptrs)
                frame.last_good = int(good[0])
            else:
                end = lib.jpeg_decode_scan(*args, ptrs)
    if end < 0:
        raise ValueError(f"{name}: scan {frame.scans + 1} has "
                         f"{ENTROPY_ERRORS.get(end, f'error {end}')}")
    frame.scans += 1
    return int(end)


def _table_segments(name, tables: bytes, quant: dict, huffman: dict) -> None:
    """The DQT and DHT segments of an abbreviated table-specification
    stream (SOI, tables, EOI; a JPEG-in-TIFF's JPEGTables), as libjpeg
    reads one ahead of the image streams that use its tables."""
    if tables[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: JPEG tables without an SOI marker")
    pos = 2
    while pos + 2 <= len(tables) and tables[pos] == 0xFF:
        marker = tables[pos + 1]
        if marker == 0xD9:
            return
        (length,) = struct.unpack(">H", tables[pos + 2:pos + 4].rjust(2))
        seg = tables[pos + 4:pos + 2 + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError(f"{name}: truncated JPEG tables")
        if marker == 0xC4:
            _huffman_segment(name, seg, huffman)
        elif marker == 0xDB:
            _quant_segment(name, seg, quant)
        pos += 2 + length
    raise ValueError(f"{name}: JPEG tables without an EOI marker")


def decode_coefficients(data: bytes, name="<bytes>",
                        tables: Optional[bytes] = None) -> Frame:
    """The host part of decoding: the markers, and every scan's blocks
    through the C++ entropy decoder. ``name`` goes into the errors;
    ``tables``, an abbreviated table-specification stream, gives the
    quantisation and Huffman tables that the stream's own DQT and DHT
    segments may then replace."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    # past its end a file reads as EOI markers, as jpeg_stdio_src (which
    # cv2.imread reads through) supplies them: a segment cut short takes
    # them as its bytes, a scan as the marker that ends it
    data = bytes(data) + EOF_FILL
    buf = np.frombuffer(data, np.uint8)
    n = len(data)
    frame, quant, huffman, restart = None, {}, {}, 0
    if tables:
        _table_segments(name, tables, quant, huffman)
    jfif, adobe = False, None
    conditioning = DAC_DEFAULTS.copy()
    pos = 2
    while True:
        while pos < n and data[pos] != 0xFF:       # garbage, as libjpeg
            pos += 1
        while pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 >= n:
            break                                   # no EOI: stop, as libjpeg
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if marker == 0xD8:
            _no_image(name, "a second SOI marker")
        if marker in (0x00, 0x01) or 0xD0 <= marker <= 0xD7:
            continue               # FF 00 is data; TEM and RSTn: no length
        if not (0xC0 <= marker <= 0xFE and marker not in (0xDE, 0xDF)
                and not 0xF0 <= marker <= 0xFD):
            _no_image(name, f"a marker 0x{marker:02X} (DHP, EXP, JPGn and "
                      "RESn are libjpeg's errors)")
        if pos + 2 > n:
            raise ValueError(f"{name}: truncated marker 0x{marker:02X}")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError(f"{name}: truncated marker 0x{marker:02X}")
        pos += length
        if marker in SOF_READ:
            if frame is not None:
                raise ValueError(f"{name}: a second SOF marker")
            frame = _frame_header(name, marker, seg)
            frame.conditioning = conditioning
        elif marker in SOF_KINDS:
            _no_image(name, f"{SOF_KINDS[marker]} JPEG "
                      f"(SOF{marker - 0xC0})")
        elif marker == 0xCC:
            _arith_segment(name, seg, conditioning)
        elif marker == 0xC4:
            _huffman_segment(name, seg, huffman)
        elif marker == 0xDB:
            _quant_segment(name, seg, quant)
        elif marker == 0xDD:
            if len(seg) < 2:
                raise ValueError(f"{name}: bad DRI segment")
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: SOS before SOF")
            pos = _scan(name, buf, pos, seg, frame, quant, huffman, restart)
        elif marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]
    if frame is None or frame.scans == 0:
        raise ValueError(f"{name}: no frame or no scan")
    missing = [c.id for c in frame.components
               if (c.samples if frame.lossless else c.coefs) is None]
    if missing:
        raise ValueError(f"{name}: no scan holds component(s) {missing}")
    frame.colour = _colour_space(frame, jfif, adobe)
    if frame.lossless and frame.colour in ("ycc", "ycck"):
        _no_image(name, f"a lossless JPEG in {frame.colour.upper()} "
                  "(libjpeg converts no colours of a lossless file)")
    frame.smooth = frame.progressive and _smoothing_ok(frame)
    return frame


def _colour_space(frame: Frame, jfif: bool, adobe: Optional[int]) -> str:
    """libjpeg-turbo's jpeg_color_space (jdapimin.c's
    default_decompress_parms): one component gray; three YCbCr under a JFIF
    marker, RGB or YCbCr by an Adobe marker's transform (0: RGB), else by
    the component ids (1, 2, 3: YCbCr, or RGB in a lossless file; 'R',
    'G', 'B': RGB; others YCbCr, or RGB in a lossless file); four CMYK,
    or YCCK under an Adobe marker of a transform other than 0."""
    n = len(frame.components)
    if n == 1:
        return "gray"
    if n == 4:
        return "cmyk" if adobe is None or adobe == 0 else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    ids = tuple(c.id for c in frame.components)
    if ids == (82, 71, 66) or frame.lossless:
        return "rgb"
    return "ycc"


def _smoothing_ok(frame: Frame) -> bool:
    """jdcoefct.c's smoothing_ok once every scan is read: each
    component's DC and first nine AC quantisers non-zero, its DC at least
    partly known, and some of the first nine AC coefficients of some
    component still short of bits."""
    for c, bits in zip(frame.components, frame.coef_bits):
        if not np.all(c.quant[SMOOTH_POS]) or bits[0] < 0:
            return False
    return bool(np.any(frame.coef_bits[:, 1:] != 0))


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _int16(x: torch.Tensor) -> torch.Tensor:
    """x modulo 2^16 as a signed 16-bit value (a 16-bit SIMD lane)."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_pass(x: torch.Tensor, shift: int) -> torch.Tensor:
    """One pass of jidctint.c's jpeg_idct_islow along the last dim, as
    libjpeg-turbo's SIMD version computes it: the products exact in 32
    bits, the sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1 in 16-bit
    lanes, the result descaled and saturated to 16 bits."""
    x0, x1, x2, x3, x4, x5, x6, x7 = x.unbind(-1)
    z1 = (x2 + x6) * 4433                         # FIX_0_541196100
    tmp2 = z1 + x6 * -15137                       # FIX_1_847759065
    tmp3 = z1 + x2 * 6270                         # FIX_0_765366865
    tmp0 = _int16(x0 + x4) << 13
    tmp1 = _int16(x0 - x4) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z1, z2 = x7 + x1, x5 + x3
    z3, z4 = _int16(x7 + x3), _int16(x5 + x1)
    z5 = (z3 + z4) * 9633                         # FIX_1_175875602
    z1 = z1 * -7373                               # FIX_0_899976223
    z2 = z2 * -20995                              # FIX_2_562915447
    z3 = z3 * -16069 + z5                         # FIX_1_961570560
    z4 = z4 * -3196 + z5                          # FIX_0_390180644
    o7 = x7 * 2446 + z1 + z3                      # FIX_0_298631336
    o5 = x5 * 16819 + z2 + z4                     # FIX_2_053119869
    o3 = x3 * 25172 + z2 + z3                     # FIX_3_072711026
    o1 = x1 * 12299 + z1 + z4                     # FIX_1_501321110
    out = torch.stack([t10 + o1, t11 + o3, t12 + o5, t13 + o7,
                       t13 - o7, t12 - o5, t11 - o3, t10 - o1], -1)
    return _descale(out, shift).clamp(-32768, 32767)


def idct_islow(blocks: torch.Tensor) -> torch.Tensor:
    """Dequantised int64 blocks [..., 8, 8] (natural order) -> samples
    [..., 8, 8] in 0-255 (int64), as libjpeg-turbo's SIMD
    jsimd_idct_islow computes them (cv2.imread runs it): the dequantised
    values kept in 16 bits; a block whose rows 1-7 are all zero takes its
    first pass as row 0 << 2 in 16 bits; the result saturated, not
    range-limited through jidctint.c's table (the two part only where the
    sums leave the range valid data reach)."""
    x = _int16(blocks)
    ws = _idct_pass(x.transpose(-1, -2), 13 - 2)
    flat = (x[..., 1:, :] == 0).all(-1).all(-1)[..., None, None]
    ws = torch.where(flat, _int16(x[..., :1, :].transpose(-1, -2) << 2), ws)
    out = _idct_pass(ws.transpose(-1, -2), 13 + 2 + 3)
    return (out + 128).clamp(0, 255)


def _neighbours(x: torch.Tensor, dim: int):
    """x's previous and next entries along ``dim``, the edge repeated."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    return prev, nxt


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    out = torch.stack([a, b], dim + 1)
    shape = list(a.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def _fancy(x: torch.Tensor, dim: int) -> torch.Tensor:
    """h2v1 (dim 1) or h1v2 (dim 0) fancy upsampling: 3/4 of the nearer
    sample and 1/4 of the further, biases 1 and 2."""
    prev, nxt = _neighbours(x, dim)
    return _interleave((3 * x + prev + 1) >> 2, (3 * x + nxt + 2) >> 2, dim)


def _fancy_h2v2(x: torch.Tensor) -> torch.Tensor:
    """h2v2 fancy upsampling: column sums 3 * nearer + further row, then
    3 * this + neighbouring sum, biases 8 and 7."""
    up, down = _neighbours(x, 0)
    rows = []
    for cs in (3 * x + up, 3 * x + down):
        left, right = _neighbours(cs, 1)
        rows.append(_interleave((3 * cs + left + 8) >> 4,
                                (3 * cs + right + 7) >> 4, 1))
    return _interleave(rows[0], rows[1], 0)


def upsample(x: torch.Tensor, h_expand: int, v_expand: int,
             fancy: bool = True) -> torch.Tensor:
    """A component's real samples [dh, dw] to the full grid, as jdsample.c
    picks the method (``fancy`` False, as for a lossless file: replication
    only)."""
    if (h_expand, v_expand) == (1, 1):
        return x
    if not fancy:
        return x.repeat_interleave(v_expand, 0).repeat_interleave(h_expand,
                                                                  1)
    if (h_expand, v_expand) == (2, 1) and x.shape[1] > 2:
        return _fancy(x, 1)
    if (h_expand, v_expand) == (1, 2):
        return _fancy(x, 0)
    if (h_expand, v_expand) == (2, 2) and x.shape[1] > 2:
        return _fancy_h2v2(x)
    return x.repeat_interleave(v_expand, 0).repeat_interleave(h_expand, 1)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
               ) -> torch.Tensor:
    """jdcolor.c's ycc_rgb_convert on int64 planes -> [..., 3] in 0-255."""
    xb, xr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_fix(1.40200) * xr + half) >> 16)
    g = y + ((-_fix(0.34414) * xb - _fix(0.71414) * xr + half) >> 16)
    b = y + ((_fix(1.77200) * xb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255)


def cmyk_to_rgb(c: torch.Tensor, m: torch.Tensor, y: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on int64 planes as libjpeg
    returns them (Adobe's inverted values) -> [..., 3] RGB: each of C, M, Y
    becomes k - ((255 - x) * k >> 8)."""
    return torch.stack([k - (((255 - x) * k) >> 8) for x in (c, m, y)], -1)


def _estimate(num: torch.Tensor, q: int, al: int) -> torch.Tensor:
    """A coefficient estimate from ``num``: |num| / (q * 256) rounded, at
    most (1 << al) - 1 when al > 0, with num's sign."""
    mag = ((q << 7) + num.abs()) // (q << 8)
    if al > 0:
        mag = mag.clamp(max=(1 << al) - 1)
    return torch.where(num >= 0, mag, -mag)


def smooth_blocks(coefs: torch.Tensor, quant: np.ndarray, bits, hib: int,
                  wib: int, v: int, imcu_rows: int) -> torch.Tensor:
    """jdcoefct.c's decompress_smooth_data (libjpeg-turbo 2.1 and later)
    on one component's quantised blocks, its whole block grid of int64
    [R, C, 64] in natural order: the [hib, wib, 64] real blocks that the IDCT
    sees. Each block looks at the DC values of a 5x5 window of blocks
    (columns clamped at the edges; rows as libjpeg finds them, from the
    position of the block row in its iMCU row of ``v`` block rows, which in
    the last iMCU row counts only the real rows). Of the first nine AC
    coefficients, each one whose ``bits`` (coef_bits) is not 0 and whose
    value is 0 takes an estimate from the window; when no AC coefficient
    has been sent at all (bits[1:10] all -1), the DC is interpolated too and
    the estimates follow a Gaussian-like kernel."""
    dev = coefs.device
    r = np.arange(hib)
    m, br = r // v, r % v
    b = np.where(m < imcu_rows - 1, v, (hib % v) or v)
    ibr, ibrs = m * b + br, b * imcu_rows
    prev = np.where(ibr > 0, r - 1, r)
    nxt = np.where(ibr < ibrs - 1, r + 1, r)
    rows = np.stack([np.where(ibr > 1, r - 2, prev), prev, r, nxt,
                     np.where(ibr < ibrs - 2, r + 2, nxt)])  # [5, hib]
    cols = np.clip(np.arange(wib)[None] + np.arange(-2, 3)[:, None], 0,
                   wib - 1)                                  # [5, wib]
    dc = coefs[..., 0]
    win = dc[torch.as_tensor(rows, device=dev)][
        :, :, torch.as_tensor(cols, device=dev)]            # [5, hib, 5, wib]

    def d(k):                                   # libjpeg's DC01 ... DC25
        return win[(k - 1) // 5, :, (k - 1) % 5]

    q = [int(quant[i]) for i in SMOOTH_POS]
    out = coefs[:hib, :wib].clone()
    change_dc = bool(np.all(np.asarray(bits[1:SAVED_COEFS]) == -1))
    if change_dc:
        nums = [
            -d(1) - d(2) + d(4) + d(5) - 3 * d(6) + 13 * d(7) - 13 * d(9)
            + 3 * d(10) - 3 * d(11) + 38 * d(12) - 38 * d(14) + 3 * d(15)
            - 3 * d(16) + 13 * d(17) - 13 * d(19) + 3 * d(20) - d(21)
            - d(22) + d(24) + d(25),
            -d(1) - 3 * d(2) - 3 * d(3) - 3 * d(4) - d(5) - d(6) + 13 * d(7)
            + 38 * d(8) + 13 * d(9) - d(10) + d(16) - 13 * d(17) - 38 * d(18)
            - 13 * d(19) + d(20) + d(21) + 3 * d(22) + 3 * d(23) + 3 * d(24)
            + d(25),
            d(3) + 2 * d(7) + 7 * d(8) + 2 * d(9) - 5 * d(12) - 14 * d(13)
            - 5 * d(14) + 2 * d(17) + 7 * d(18) + 2 * d(19) + d(23),
            -d(1) + d(5) + 9 * d(7) - 9 * d(9) - 9 * d(17) + 9 * d(19)
            + d(21) - d(25),
            2 * d(7) - 5 * d(8) + 2 * d(9) + d(11) + 7 * d(12) - 14 * d(13)
            + 7 * d(14) + d(15) + 2 * d(17) - 5 * d(18) + 2 * d(19),
            d(7) - d(9) + 2 * d(12) - 2 * d(14) + d(17) - d(19),
            d(7) - 3 * d(8) + d(9) - d(17) + 3 * d(18) - d(19),
            d(7) - d(9) - 3 * d(12) + 3 * d(14) + d(17) - d(19),
            d(7) + 2 * d(8) + d(9) - d(17) - 2 * d(18) - d(19)]
    else:
        nums = [
            -7 * d(11) + 50 * d(12) - 50 * d(14) + 7 * d(15),
            -7 * d(3) + 50 * d(8) - 50 * d(18) + 7 * d(23),
            -d(3) + 13 * d(8) - 24 * d(13) + 13 * d(18) - d(23),
            d(10) + d(16) - 10 * d(17) + 10 * d(19) - d(2) - d(20) + d(22)
            - d(24) + d(4) - d(6) + 10 * d(7) - 10 * d(9),
            -d(11) + 13 * d(12) - 24 * d(13) + 13 * d(14) - d(15)]
    for i, num in enumerate(nums, 1):
        al = int(bits[i])
        if al == 0:
            continue
        pos = int(SMOOTH_POS[i])
        cur = out[..., pos]
        out[..., pos] = torch.where(cur == 0, _estimate(q[0] * num, q[i], al),
                                    cur)
    if change_dc:
        num = q[0] * (
            -2 * d(1) - 6 * d(2) - 8 * d(3) - 6 * d(4) - 2 * d(5) - 6 * d(6)
            + 6 * d(7) + 42 * d(8) + 6 * d(9) - 6 * d(10) - 8 * d(11)
            + 42 * d(12) + 152 * d(13) + 42 * d(14) - 8 * d(15) - 6 * d(16)
            + 6 * d(17) + 42 * d(18) + 6 * d(19) - 6 * d(20) - 2 * d(21)
            - 6 * d(22) - 8 * d(23) - 6 * d(24) - 2 * d(25))
        out[..., 0] = _estimate(num, q[0], 0)
    return out


def frame_pixels(frame: Frame, device) -> torch.Tensor:
    """The device part of decoding: uint8 [H, W] (gray) or [H, W, 3] (RGB)
    on ``device``."""
    dev = resolve_device(device)
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    planes = []
    imcu_rows = _ceil_div(frame.height, 8 * vmax)
    for i, c in enumerate(frame.components):
        if frame.lossless:
            plane = torch.from_numpy(c.samples).to(dev).to(torch.int64)
            plane = upsample(plane, hmax // c.h, vmax // c.v, fancy=False)
            planes.append(plane[:frame.height, :frame.width])
            continue
        coefs = torch.from_numpy(c.coefs).to(dev).to(torch.int64)
        if frame.smooth:
            hib = _ceil_div(_ceil_div(frame.height * c.v, vmax), 8)
            wib = _ceil_div(_ceil_div(frame.width * c.h, hmax), 8)
            smoothed = smooth_blocks(coefs, c.quant, frame.coef_bits[i], hib,
                                     wib, c.v, imcu_rows)
            if frame.last_good < imcu_rows - 1:
                # jdcoefct.c: the iMCU rows after the last good one take
                # the coef_bits from before the last scan (-1 after one)
                prev = frame.coef_bits[i].copy()
                prev[1:] = frame.prev_bits[i, 1:] if frame.scans > 1 else -1
                late = torch.arange(hib, device=dev) // c.v > frame.last_good
                smoothed = torch.where(
                    late[:, None, None],
                    smooth_blocks(coefs, c.quant, prev, hib, wib, c.v,
                                  imcu_rows), smoothed)
            coefs = smoothed
        rows, cols = coefs.shape[:2]
        quant = torch.from_numpy(c.quant).to(dev)
        samples = idct_islow((coefs * quant).view(rows, cols, 8, 8))
        plane = samples.permute(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        plane = plane[:_ceil_div(frame.height * c.v, vmax),
                      :_ceil_div(frame.width * c.h, hmax)]
        plane = upsample(plane, hmax // c.h, vmax // c.v)
        planes.append(plane[:frame.height, :frame.width])
    if frame.colour == "gray":
        out = planes[0]
    elif frame.colour == "rgb":
        out = torch.stack(planes, -1)
    elif frame.colour == "ycc":
        out = ycc_to_rgb(*planes)
    elif frame.colour == "cmyk":
        out = cmyk_to_rgb(*planes)
    else:                                  # jdcolor.c's ycck_cmyk_convert
        out = cmyk_to_rgb(*(255 - ycc_to_rgb(*planes[:3])).unbind(-1),
                          planes[3])
    return out.to(torch.uint8)


def read_jpeg(path, device="cuda") -> torch.Tensor:
    """Decode a baseline JPEG file to uint8 [H, W] (gray) or [H, W, 3]
    (RGB) on ``device``: cv2.imread(path, IMREAD_UNCHANGED)'s pixels."""
    dev = resolve_device(device)
    return frame_pixels(decode_coefficients(Path(path).read_bytes(), path),
                        dev)


# ------------------------------------------------------------------ writing

def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jpeg_set_quality's scaling of a base table, clamped to 1-255
    (baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def rgb_to_ycc(rgb: torch.Tensor) -> torch.Tensor:
    """jccolor.c's rgb_ycc_convert on int64 [..., 3] -> [..., 3]."""
    r, g, b = rgb.unbind(-1)
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + offset + half - 1) >> 16
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + offset + half - 1) >> 16
    return torch.stack([y, cb, cr], -1)


def _pad_edges(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[h, w] -> [rows, cols], the last row and column repeated."""
    h, w = x.shape
    ri = torch.arange(rows, device=x.device).clamp(max=h - 1)
    ci = torch.arange(cols, device=x.device).clamp(max=w - 1)
    return x[ri][:, ci]


def h2v2_downsample(x: torch.Tensor) -> torch.Tensor:
    """jcsample.c's h2v2_downsample of [2h, 2w]: each 2x2 sum plus a bias
    of 1, 2, 1, 2, ... along the row, shifted right by 2."""
    h, w = x.shape[0] // 2, x.shape[1] // 2
    s = x.view(h, 2, w, 2).sum((1, 3))
    bias = 1 + (torch.arange(w, device=x.device) & 1)
    return (s + bias) >> 2


def _fdct_pass(d: torch.Tensor, first: bool) -> torch.Tensor:
    """One pass of jfdctint.c's jpeg_fdct_islow along the last dim: rows
    (``first``, scaled by 2^2) or columns (the 2^2 removed)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d.unbind(-1)
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first:
        out0, out4, n = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2, 13 - 2
    else:
        out0, out4 = _descale(tmp10 + tmp11, 2), _descale(tmp10 - tmp11, 2)
        n = 13 + 2
    z1 = (tmp12 + tmp13) * 4433
    out2 = _descale(z1 + tmp13 * 6270, n)
    out6 = _descale(z1 + tmp12 * -15137, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    z1 = z1 * -7373
    z2 = z2 * -20995
    z3 = z3 * -16069 + z5
    z4 = z4 * -3196 + z5
    out7 = _descale(tmp4 * 2446 + z1 + z3, n)
    out5 = _descale(tmp5 * 16819 + z2 + z4, n)
    out3 = _descale(tmp6 * 25172 + z2 + z3, n)
    out1 = _descale(tmp7 * 12299 + z1 + z4, n)
    return torch.stack([out0, out1, out2, out3, out4, out5, out6, out7], -1)


def fdct_islow(samples: torch.Tensor) -> torch.Tensor:
    """Samples [..., 8, 8] (int64, 0-255) -> DCT coefficients scaled by 8,
    as jpeg_fdct_islow computes them after centring."""
    ws = _fdct_pass(samples - 128, True)
    return _fdct_pass(ws.transpose(-1, -2), False).transpose(-1, -2)


def _reciprocals(table: np.ndarray):
    """libjpeg-turbo's compute_reciprocal for each divisor (8 x the
    quantisation value): (reciprocal, correction, shift)."""
    recip, corr, shift = (np.zeros(64, np.int64) for _ in range(3))
    for i, q in enumerate(table):
        d = int(q) * 8
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:                   # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip, corr, shift


def quantize(coefs: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """[..., 64] DCT coefficients (scaled by 8) -> quantised int16, as
    libjpeg-turbo's quantize rounds them."""
    recip, corr, shift = (torch.from_numpy(a).to(coefs.device)
                          for a in _reciprocals(table))
    mag = ((coefs.abs() + corr) * recip) >> shift
    return torch.where(coefs < 0, -mag, mag).to(torch.int16)


def _blocks(plane: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """[8R, 8C] samples -> quantised blocks [R, C, 64] (natural order)."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    b = plane.view(rows, 8, cols, 8).permute(0, 2, 1, 3)
    return quantize(fdct_islow(b).reshape(rows, cols, 64), table)


def _with_dummies(b: torch.Tensor, rows: int, cols: int, h: int
                  ) -> torch.Tensor:
    """Blocks [R, C, 64] -> [rows, cols, 64] with jccoefct.c's dummy
    blocks: no AC, the DC of the block before it in the MCU (at the right,
    the row's last real block; below, the last block of the MCU's last
    real row)."""
    r, c = b.shape[:2]
    if cols > c:
        pad = torch.zeros(r, cols - c, 64, dtype=b.dtype, device=b.device)
        pad[..., 0] = b[:, c - 1:c, 0]
        b = torch.cat([b, pad], 1)
    if rows > r:
        pad = torch.zeros(rows - r, cols, 64, dtype=b.dtype, device=b.device)
        last = torch.arange(cols, device=b.device) // h * h + h - 1
        pad[..., 0] = b[r - 1, last, 0]
        b = torch.cat([b, pad], 0)
    return b


@dataclass
class Encoded:
    """What the device stages hand to the entropy coder: the blocks in scan
    order, each block's component, each component's block grid (dummy
    blocks included) with its count of real blocks down and across, and
    the header's contents."""
    height: int
    width: int
    blocks: torch.Tensor          # int16 [n, 64], natural order
    block_comp: torch.Tensor      # int32 [n]
    sampling: List[Tuple[int, int]]
    tables: List[np.ndarray]      # quantisation tables, natural order
    grids: List[torch.Tensor]     # int16 [R, C, 64] per component
    real: List[Tuple[int, int]]


def jpeg_blocks(img, quality: int = 95, device="cuda") -> Encoded:
    """The device part of encoding a uint8 [H, W], [H, W, 1] or [H, W, 3]
    (RGB) image: colour conversion, edge expansion, 4:2:0 downsampling,
    forward DCT, quantisation and the MCU order."""
    dev = resolve_device(device)
    x = img if torch.is_tensor(img) else torch.from_numpy(
        np.ascontiguousarray(img))
    if x.dtype != torch.uint8:
        raise ValueError(f"JPEG writing takes uint8, not {x.dtype}")
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if not (x.ndim == 2 or (x.ndim == 3 and x.shape[-1] == 3)) or (
            min(x.shape[:2]) < 1 or max(x.shape[:2]) > 65535):
        raise ValueError(f"image shape {tuple(x.shape)} is not [H, W] or "
                         "[H, W, 1 | 3] with sides of 1 to 65535")
    x = x.to(dev).to(torch.int64)
    height, width = x.shape[:2]
    luma = quality_table(LUMA_QUANT, quality)
    if x.ndim == 2:
        plane = _pad_edges(x, 8 * _ceil_div(height, 8),
                           8 * _ceil_div(width, 8))
        grid = _blocks(plane, luma)
        blocks = grid.reshape(-1, 64)
        comp = torch.zeros(blocks.shape[0], dtype=torch.int32)
        return Encoded(height, width, blocks, comp, [(1, 1)], [luma], [grid],
                       [tuple(grid.shape[:2])])
    chroma = quality_table(CHROMA_QUANT, quality)
    ycc = rgb_to_ycc(x)
    my, mx = _ceil_div(height, 16), _ceil_div(width, 16)
    y = _blocks(_pad_edges(ycc[..., 0], 8 * _ceil_div(height, 8),
                           8 * _ceil_div(width, 8)), luma)
    real = [tuple(y.shape[:2])]
    y = _with_dummies(y, 2 * my, 2 * mx, 2)
    grids = [y]
    parts = [y.view(my, 2, mx, 2, 64).permute(0, 2, 1, 3, 4)
             .reshape(my, mx, 4, 64)]
    for ch in (1, 2):
        src = _pad_edges(ycc[..., ch], 2 * _ceil_div(height, 2), 16 * mx)
        sub = _pad_edges(h2v2_downsample(src), 8 * my, 8 * mx)
        grids.append(_blocks(sub, chroma))
        real.append((my, mx))
        parts.append(grids[-1].view(my, mx, 1, 64))
    blocks = torch.cat(parts, 2).reshape(-1, 64)
    comp = torch.tensor([0, 0, 0, 0, 1, 2], dtype=torch.int32).repeat(my * mx)
    return Encoded(height, width, blocks, comp, [(2, 2), (1, 1), (1, 1)],
                   [luma, chroma], grids, real)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


# jcparam.c's jpeg_simple_progression: (components, Ss, Se, Ah, Al)
PROGRESSION_YCC = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                   ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                   ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                   ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                   ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))
PROGRESSION_GRAY = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))


def _progressive_scans(enc: Encoded, tabs: List[int]) -> List[bytes]:
    """Each scan of jpeg_simple_progression as libjpeg writes it: the DHT
    segments of the tables it codes with (optimised for the scan, each
    table once), its SOS segment and its entropy-coded data."""
    grids = [np.ascontiguousarray(g.cpu().numpy()) for g in enc.grids]
    hmax = max(h for h, _ in enc.sampling)
    vmax = max(v for _, v in enc.sampling)
    frame_mcus = (_ceil_div(enc.height, 8 * vmax),
                  _ceil_div(enc.width, 8 * hmax))
    script = PROGRESSION_YCC if len(grids) == 3 else PROGRESSION_GRAY
    lib = entropy_library()
    out = []
    for comps, ss, se, ah, al in script:
        n = len(comps)
        if n == 1:
            hv, mcus = [(1, 1)], enc.real[comps[0]]
        else:
            hv, mcus = [enc.sampling[c] for c in comps], frame_mcus
        grid = np.asarray([grids[c].shape[:2] for c in comps], np.int32)
        tab = np.asarray([tabs[c] for c in comps], np.int32)
        ptrs = (ctypes.c_void_p * n)(*[grids[c].ctypes.data for c in comps])
        counts = np.zeros((4, 16), np.uint8)
        symbols = np.zeros((4, 256), np.uint8)
        cap = sum(int(np.prod(grids[c].shape[:2])) for c in comps) * 512 + 64
        data = np.empty(cap, np.uint8)
        size = lib.jpeg_encode_progressive_scan(
            n, _ptr(np.asarray(hv, np.int32), ctypes.c_int32),
            _ptr(grid, ctypes.c_int32), _ptr(tab, ctypes.c_int32), mcus[1],
            mcus[0], 0, ss, se, ah, al, ptrs, _ptr(counts, ctypes.c_uint8),
            _ptr(symbols, ctypes.c_uint8), _ptr(data, ctypes.c_uint8), cap)
        if size < 0:
            raise ValueError(f"JPEG encoding failed: "
                             f"{ENTROPY_ERRORS.get(size, f'error {size}')}")
        head, sos = [], bytes([n])
        for c in comps:
            t = tabs[c]
            if not (ss == 0 and ah) and t not in head:
                head.append(t)
            td, ta = (t if ah == 0 else 0, 0) if ss == 0 else (0, t)
            sos += bytes([c + 1, (td << 4) | ta])
        tc = 0 if ss == 0 else 1
        segs = [_segment(0xC4, bytes([(tc << 4) | t]) + counts[t].tobytes()
                         + symbols[t, :int(counts[t].sum())].tobytes())
                for t in head]
        segs.append(_segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])))
        out.append(b"".join(segs) + data[:size].tobytes())
    return out


def encode_file(enc: Encoded, progressive: bool = False) -> bytes:
    """The host part of encoding: the entropy-coded scan (or, with
    ``progressive``, the scans) and the markers libjpeg writes around
    it."""
    n_comp = len(enc.sampling)
    tabs = [0] + [1] * (n_comp - 1)                 # quantisation and Huffman
    head = [b"\xff\xd8",
            _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    head += [_segment(0xDB, bytes([t]) + t_vals[ZIGZAG].astype(
        np.uint8).tobytes()) for t, t_vals in enumerate(enc.tables)]
    sof = struct.pack(">BHHB", 8, enc.height, enc.width, n_comp)
    sos = bytes([n_comp])
    for i, ((h, v), t) in enumerate(zip(enc.sampling, tabs)):
        sof += bytes([i + 1, (h << 4) | v, t])
        sos += bytes([i + 1, (t << 4) | t])
    if progressive:
        head.append(_segment(0xC2, sof))
        return b"".join(head + _progressive_scans(enc, tabs)) + b"\xff\xd9"
    blocks = np.ascontiguousarray(enc.blocks.cpu().numpy())
    comp = np.ascontiguousarray(enc.block_comp.cpu().numpy())
    comp_tables = np.asarray([(t, t) for t in tabs], np.int32)
    counts, symbols = _huffman_arrays(STD_HUFFMAN)
    n_blocks = blocks.shape[0]
    # at most 27 bits a coefficient (a 16-bit code and 11 value bits), every
    # byte stuffed: under 512 bytes a block
    cap = n_blocks * 512 + 64
    out = np.empty(cap, np.uint8)
    size = entropy_library().jpeg_encode_scan(
        _ptr(blocks, ctypes.c_int16), n_blocks, _ptr(comp, ctypes.c_int32),
        n_comp, _ptr(comp_tables, ctypes.c_int32),
        _ptr(counts, ctypes.c_uint8), _ptr(symbols, ctypes.c_uint8),
        _ptr(out, ctypes.c_uint8), cap)
    if size < 0:
        raise ValueError(f"JPEG encoding failed: "
                         f"{ENTROPY_ERRORS.get(size, f'error {size}')}")
    head.append(_segment(0xC0, sof))
    for t in sorted(set(tabs)):
        for tc in (0, 1):
            head.append(_segment(0xC4, bytes([(tc << 4) | t])
                                 + STD_HUFFMAN[(tc, t)]))
    head.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    return b"".join(head) + out[:size].tobytes() + b"\xff\xd9"


def encode_jpeg(img, quality: int = 95, device="cuda",
                progressive: bool = False) -> bytes:
    """A uint8 [H, W], [H, W, 1] or [H, W, 3] (RGB) image as JPEG bytes:
    cv2.imencode(".jpg") of it (in BGR) at ``quality`` (95 is OpenCV's
    default), with ``progressive`` cv2.imencode(".jpg", img,
    [IMWRITE_JPEG_PROGRESSIVE, 1]): jpeg_simple_progression's scans, each
    with its own optimised Huffman tables."""
    return encode_file(jpeg_blocks(img, quality, device), progressive)


def write_jpeg(path, img, quality: int = 95, device="cuda",
               progressive: bool = False) -> None:
    """Write ``encode_jpeg(img, quality, device, progressive)`` to
    ``path``. Only scripts/colmap_export.py and chip_smoke.py write
    progressive files (to make progressive captures where no OpenCV is
    installed); the loaders and the CLI write baseline JPEG, as the JAX
    package's cv2.imwrite(".jpg") does at its defaults."""
    Path(path).write_bytes(encode_jpeg(img, quality, device, progressive))
