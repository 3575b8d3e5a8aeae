"""TIFF reading and writing, as OpenCV's libtiff reads and writes them (no
image library).

The JAX package reads every view with ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes undistorted views with ``cv2.imwrite``; a
RAW converter's, scanner's or photogrammetry tool's export is often a
TIFF of 16 or fewer bits, JPEG-compressed, fax-coded, YCbCr, CMYK or CIE
L*a*b*. The machine with the card has no OpenCV, so the port carries this
codec: the compression passes are host C++ (``csrc/tiff_codec.cpp``: LZW
both ways, PackBits, and libtiff's CCITT fax, ThunderScan and SGILog
decoders, built with g++ at first use by ``native.build_library``; JPEG
strips and tiles through utils/jpeg.py's entropy decoder), Deflate is
zlib's, the directory, the predictor and the sample layout are numpy, and
the pixel stages of JPEG, YCbCr, CMYK, L*a*b* and LogL images run on the
device. tests/test_torch_tiff*.py hold both directions to cv2.

- ``decode_tiff`` (host) and ``tiff_pixels`` (device) return, and
  ``read_tiff`` returns as numpy, what cv2.imread(IMREAD_UNCHANGED)
  returns, in RGB(A) order, for the first image of a classic TIFF or a
  BigTIFF (8-byte offsets; LONG8, SLONG8 and IFD8 fields), little- or
  big-endian: strips or tiles, PlanarConfiguration 1 (chunky) or 2
  (planar), compression none (1), CCITT RLE (2), RLEW (32771), Group 3
  (3; one- or two-dimensional by T4Options bit 0, fill bits or not) and
  Group 4 (4), LZW (5; old-style LSB-first LZW too), JPEG (7), Deflate
  (8, 32946), PackBits (32773), ThunderScan (32809) or SGILog (34676),
  FillOrder 2 (each stored byte's bits reversed, except in JPEG data),
  horizontal predictor 2 (which libtiff applies to LZW and Deflate only;
  with other compressions the tag is ignored, and so the differences come
  back as they are) and, on float samples, the floating-point predictor 3
  (byte planes, most significant first, each row differenced byte by
  byte); samples of 8, 16, 32 or 64 bits unsigned (SampleFormat 1), 8,
  16, 32 or 64 bits signed (2) and 32 or 64 bits float (3), returned as
  uint8, uint16, uint32, uint64, int8, int16, int32, int64, float32 or
  float64. OpenCV reads 8-bit images through libtiff's RGBA interface
  (tif_getimage.c) and deeper ones raw, and each path leaves its mark,
  kept here:

  - gray (MinIsBlack or MinIsWhite), RGB, RGB with a fourth (extra)
    sample, palette: 8-bit MinIsWhite is inverted and deeper MinIsWhite
    is not; an 8-bit fourth sample marked unassociated alpha (ExtraSamples
    2) premultiplies the colour, (v * a + 127) // 255, and any other
    fourth sample is kept as alpha beside the colour as stored; signed
    8-bit samples take the same path as unsigned bytes and are then read
    as int8; a palette of 16-bit entries is scaled by >> 8 unless every
    entry is below 256, and an 8-bit palette of more than one sample
    indexes by the first; 32- and 64-bit palettes and single-sample RGB
    deeper than 8 bits come back as gray, and gray of 3 or 4 32- or
    64-bit samples as those samples;
  - gray with extra samples (alpha): the gray as stored, [H, W] (8-bit
    MinIsWhite inverted; 16 bits come back as uint8, the high byte); in
    planar files the gray is not inverted, 16 bits come back as (v +
    128) // 257, and an unassociated alpha premultiplies it; in a chunky
    tile cut by the right edge libtiff steps each row by (tile width - cut
    width) bytes where samples are meant, and the reader steps as it does
    (8-bit palettes of more than one sample too);
  - 1-bit bilevel (any compression, CCITT fax included): uint8 0 / 255
    (MinIsWhite inverted); a 1-bit palette comes back gray (OpenCV's BGR
    -> gray weights, 14 bits), a 4-bit palette as RGB; signed 1- and
    4-bit samples as int8;
  - CCITT fax: libtiff's decoder (tif_fax3.c) and its repairs of cut and
    corrupt data: the rows before a fault kept and the row at hand cut or
    padded, a Group 3 strip whose data ends in zeros after an EOL decoded
    again from its start without EOLs (libtiff 4.5's FAXMODE_NOEOL, kept
    for the image's later strips), a Group 4 strip ended at an EOL, RLEW
    rows aligned to the file's 16-bit words;
  - 10-, 12- and 14-bit samples (gray, RGB, RGBA): uint16, each sample
    << (16 - bits), MinIsWhite as stored; signed ones int16, saturated;
  - CMYK (Separated, InkSet 1, 8 bits): RGBA, R = (255 - K)(255 - C) //
    255 and so on, alpha 255;
  - YCbCr, 8 bits: each data unit of hs x vs luma samples and a Cb and a
    Cr spread over its pixels (subsampling 1x1, 1x2, 2x1, 2x2, 4x1, 4x2
    and 4x4; default 2x2), then tif_color.c's integer tables
    (TIFFYCbCrToRGBInit, in its float32 arithmetic) from
    YCbCrCoefficients and ReferenceBlackWhite (RATIONAL; libtiff's
    defaults when absent); a strip read as its rows rounded up to vs times
    TIFFScanlineSize, which truncates a row of 4x4 units to a quarter (the
    bytes left out 0), a 4x4 tile cut by the right edge stepped as
    putcontig8bitYCbCr44tile steps it, and the horizontal predictor run
    over rows of TIFFScanlineSize (strips) or TIFFTileRowSize (tiles)
    bytes, or not at all where those do not divide;
  - CIE L*a*b* (photometric 8; 3 chunky samples of 8 or 16 bits): uint8
    RGB through initCIELabConversion (tif_color.c's TIFFCIELab16ToXYZ and
    TIFFXYZToRGB, display_sRGB, the WhitePoint or D50), converted on the
    device in libtiff's float32 steps, bit for bit;
  - LogL (photometric 32844, SGILog, one 8- or 16-bit integer sample):
    uint8 gray through tif_luv.c's L16toGry (a 65,536-entry table looked
    up on the device); LogLuv (32845, SGILog, 3 samples of any depth):
    float32 RGB, libtiff's LogLuv32toXYZ in double (tables, then float64
    products on the device) and OpenCV's float XYZ -> BGR as its baseline
    SIMD loop evaluates it (each row's first W // 4 * 4 pixels one way,
    the rest another), after the orientation; ThunderScan 4-bit palettes
    as libtiff 4.7 decodes them, a row short of data keeping its whole
    bytes;
  - JPEG (compression 7) in strips or tiles, gray, palette, RGB or YCbCr
    at any subsampling of its stream: each strip or tile a whole JPEG
    stream or an abbreviated one primed by JPEGTables (cv2.imwrite's and
    libtiff's own), decoded as libjpeg decodes it under libtiff's RGBA
    interface (utils/jpeg.py: the IDCT, fancy upsampling and, for chunky
    photometric YCbCr alone, the YCbCr -> RGB conversion; the
    photometric, not the stream's markers, decides it); in planar files
    one single-component stream a plane, YCbCr ones then through the
    tables;
  - a compression libtiff has no codec for: samples of 0 (libtiff fails
    each strip after zeroing its buffer, and the RGBA reader keeps it);
  - a strip or tile that decodes short (data cut off or corrupt: LZW,
    Deflate, PackBits): what decoded, then zeros, and no predictor on it
    (libtiff's codec fails on it, and the RGBA reader keeps its zeroed
    buffer; at a Deflate fault OpenCV's zlib may have written a few bytes
    more than Python's, ROADMAP.md queue 2); uncompressed byte counts
    re-estimated as libtiff does (one strip whose count is 0, short or
    past the file's end; more than 2 chunky strips or tiles whose first
    two counts differ) and read on from the file, an uncompressed strip
    otherwise short all zeros;
  - Orientation 2, 3 and 4: mirrored left-right, turned 180 degrees,
    mirrored top-bottom; 8-bit images mirror each tile left-right in its
    place, as OpenCV's reading of libtiff's tiles does.

- ``write_tiff`` writes as cv2.imwrite(".tif") does: little-endian, one
  strip, integer samples LZW with predictor 2, float samples uncompressed
  with no predictor, SampleFormat 1, 2 or 3, no ExtraSamples for a fourth
  channel; uint8, uint16, uint32, int8, int16, int32, float32 or float64
  gray, RGB or RGBA, and uint64 or int64 as int32 of their low 32 bits,
  as OpenCV 5 writes them. The pixels read back equal in cv2 and in
  ``read_tiff``; the bytes are not libtiff's.

What cv2.imread returns None for raises ValueError naming the file: the
compressions OpenCV's libtiff is built without (old-style JPEG 6, JBIG,
PixarLog, LZMA, Zstandard, WebP, LERC) and NeXT (2-bit samples), fax and
ThunderScan data of other depths than their codecs take, SGILog without
LogL / LogLuv and LogL / LogLuv without SGILog, LogL under SGILog24 or of
32 bits, float or more than one sample, LogLuv of other than 3 samples or
cut short, any photometric
interpretation but MinIsWhite, MinIsBlack, RGB, palette, CMYK, YCbCr,
CIE L*a*b*, LogL and LogLuv (ICC and ITU L*a*b*, transparency masks, CFA,
linear raw, none at all), samples of other depths than 1, 2, 4, 8, 10,
12, 14, 16, 32 and 64 bits, of differing depths, void, complex, 8-bit or
half float, predictors libtiff refuses (other than 1-3, 2 below 8 bits,
3 on integers), 16-bit CMYK and CMYK of other than 4 samples or of
another ink set, 2- and 4-bit gray, 2-bit and 10-16-bit palettes,
planar palettes of more than one sample, 1-bit colour, 10-14-bit gray
with one extra sample or with a predictor, gray with one alpha of 32-bit
or float samples, RGB of 2 samples or of one of 8 bits, more than 4
samples, 16-bit YCbCr, YCbCr subsampled other than as above or planar
and subsampled, CIE L*a*b* of other than 3 chunky samples of 8 or 16 bits
or of a WhitePoint y of 0, JPEG-in-TIFF of other than 8 bits or of CMYK,
L*a*b* or alpha, Orientation 5-8, uncompressed 8-bit tiles of FillOrder
2, uncompressed strips libtiff sizes past the file's end or tiles short
of their size, and a compression libtiff has no codec for or a chunk
that decodes short in an image OpenCV reads raw; so do malformed files.
Still refused with NotImplementedError naming the file and the kind
(ROADMAP.md queue 2): LogLuv under SGILog24, tiled ThunderScan, planar
images deeper than 8 bits of more than one sample (OpenCV's raw path reads
the first plane as interleaved samples and leaves the rest of its buffer
as it found it), and 10- to 16-bit gray of 3 or 4 samples (OpenCV folds
them through its colour weights).
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import native, resolve_device
from nerfpp_tpu_torch.utils import jpeg as J

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tiff_codec.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

# baseline and extension tags read here
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, ORIENTATION, SAMPLES = 266, 273, 274, 277
ROWS_PER_STRIP, STRIP_BYTES, PLANAR, T4_OPTIONS = 278, 279, 284, 292
PREDICTOR, WHITE_POINT, COLORMAP, TILE_WIDTH = 317, 318, 320, 322
TILE_LENGTH, TILE_OFFSETS, TILE_BYTES, INK_SET = 323, 324, 325, 332
EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 338, 339, 347
YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING_TAG = 529, 530
REFERENCE_BLACK_WHITE = 532

NONE, CCITT_RLE, CCITT_G3, CCITT_G4, LZW, JPEG, DEFLATE = 1, 2, 3, 4, 5, 7, 8
NEXT, CCITT_RLEW, PACKBITS, THUNDERSCAN = 32766, 32771, 32773, 32809
DEFLATE_OLD, SGILOG, SGILOG24 = 32946, 34676, 34677
# the compressions libtiff has a codec for (tif_codec.c), by name
COMPRESSIONS = {NONE: "uncompressed", CCITT_RLE: "CCITT RLE",
                CCITT_G3: "CCITT Group 3 fax", CCITT_G4: "CCITT Group 4 fax",
                LZW: "LZW", 6: "old-style JPEG", JPEG: "JPEG-in-TIFF",
                DEFLATE: "Deflate", NEXT: "NeXT", CCITT_RLEW: "CCITT RLEW",
                PACKBITS: "PackBits", THUNDERSCAN: "ThunderScan",
                32909: "PixarLog", DEFLATE_OLD: "Deflate", 34661: "ISO JBIG",
                SGILOG: "SGILog", SGILOG24: "SGILog24", 34925: "LZMA",
                50000: "Zstandard", 50001: "WebP-in-TIFF", 34887: "LERC"}
# the codecs OpenCV's libtiff is built without ("... compression support is
# not configured": cv2.imread returns None)
UNCONFIGURED = (6, 32909, 34661, 34925, 50000, 50001, 34887)
# CCITT compression -> tiff_fax_decode's kind (Group 3 two-dimensional: 3)
FAX = {CCITT_RLE: 0, CCITT_RLEW: 1, CCITT_G3: 2, CCITT_G4: 4}
# the codecs libtiff runs its horizontal and floating-point predictors in
PREDICTED = (LZW, DEFLATE, DEFLATE_OLD)
# a compression libtiff has no codec for: its strips decode to zeros ("strip
# decoding is not implemented"), which libtiff's RGBA reader keeps
ZEROS = -1
# the photometric interpretations libtiff's RGBA reader or OpenCV's raw path
# takes: MinIsWhite, MinIsBlack, RGB, palette, separated (CMYK), YCbCr, CIE
# L*a*b*, LogL and LogLuv
PHOTOMETRICS = (0, 1, 2, 3, 5, 6, 8, 32844, 32845)
PHOTOMETRIC_NAMES = {4: "transparency mask", 9: "ICC L*a*b*",
                     10: "ITU L*a*b*", 32803: "CFA", 32844: "LogL",
                     32845: "LogLuv", 34892: "linear raw"}
# the sample depths OpenCV reads
DEPTHS = (1, 2, 4, 8, 10, 12, 14, 16, 32, 64)
# field type -> (struct code, size); 13 IFD, 16-18 BigTIFF's LONG8, SLONG8
# and IFD8; RATIONAL and SRATIONAL: a pair of these codes a value
FIELD = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
         7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 11: ("f", 4), 12: ("d", 8),
         13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
RATIONALS = {5: "I", 10: "i"}
HALF = 1 << 15
# each byte with its bits in the other order (FillOrder 2)
REVERSED_BITS = np.packbits(np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1)[:, ::-1], axis=1)[:, 0]
# YCbCr subsamplings libtiff's RGBA reader spreads as the data units say
YCBCR_SUBSAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
# (SampleFormat, bits) -> the dtype cv2.imread returns
SAMPLE_TYPES = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (1, 64): "u8",
                (2, 8): "i1", (2, 16): "i2", (2, 32): "i4", (2, 64): "i8",
                (3, 32): "f4", (3, 64): "f8"}
SAMPLE_FORMATS = {1: "unsigned", 2: "signed", 3: "float", 4: "void",
                  5: "complex signed", 6: "complex float"}
ERRORS = {-2: "no room for the output"}
# libtiff's display_sRGB (tif_getimage.c): the XYZ -> RGB luminance matrix,
# each gun's light for the reference white and for black, its gamma
SRGB_MATRIX = np.array([[3.2410, -1.5374, -0.4986],
                        [-0.9692, 1.8760, 0.0416],
                        [0.0556, -0.2040, 1.0570]], np.float32)
SRGB_WHITE_Y, SRGB_BLACK_Y, SRGB_GAMMA = 100.0, 1.0, 2.4
LAB_TABLE_RANGE = 1500                     # CIELABTORGB_TABLE_RANGE
# libtiff's default WhitePoint (TIFFVGetFieldDefaulted): CIE D50's X, Y, Z
D50 = (96.4250, 100.0, 82.4680)
# OpenCV's XYZ2sRGB_D65 (float32), the R, G and B rows
XYZ_TO_SRGB = np.array([[3.240479, -1.53715, -0.498535],
                        [-0.969256, 1.875991, 0.041556],
                        [0.055648, -0.204043, 1.057311]], np.float32)

_lib = None


def codec_library() -> ctypes.CDLL:
    """The LZW / PackBits / CCITT fax / ThunderScan / SGILog pass, built
    with g++ on first use (raises without it)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX_FLAGS)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for fn in (lib.tiff_lzw_decode, lib.tiff_lzw_encode,
                   lib.tiff_packbits_decode):
            fn.restype = ctypes.c_int64
            fn.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.tiff_fax_decode.restype = ctypes.c_int64
        lib.tiff_fax_decode.argtypes = [u8p, ctypes.c_int64, u8p] + [
            ctypes.c_int64] * 4
        lib.tiff_thunder_decode.restype = ctypes.c_int64
        lib.tiff_thunder_decode.argtypes = [u8p, ctypes.c_int64, u8p] + [
            ctypes.c_int64] * 2
        lib.tiff_sgilog_decode.restype = ctypes.c_int64
        lib.tiff_sgilog_decode.argtypes = [
            u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)] + [
                ctypes.c_int64] * 3
        _lib = lib
    return _lib


def _call(fn, data: bytes, cap: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(cap, 1), np.uint8)
    n = fn(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError(ERRORS.get(n, f"error {n}"))
    return out[:n].tobytes()


def lzw_decode(data: bytes, size: int) -> bytes:
    """TIFF LZW data, or the old-style LZW of libtiff 4.0 and earlier ->
    at most ``size`` bytes: fewer where the data ends or a code is bad
    (what libtiff's decoder writes before it fails)."""
    return _call(codec_library().tiff_lzw_decode, data, size)


def lzw_encode(data: bytes) -> bytes:
    """Bytes -> TIFF LZW data (at most 12 bits a code, so under 1.5 x the
    input plus the Clear and EOI codes)."""
    return _call(codec_library().tiff_lzw_encode, data,
                 len(data) * 3 // 2 + 16)


def packbits_decode(data: bytes, size: int) -> bytes:
    """PackBits data -> at most ``size`` bytes."""
    return _call(codec_library().tiff_packbits_decode, data, size)


def fax_decode(data: bytes, rows: int, width: int, kind: int,
               odd_base: bool = False,
               no_eol: bool = False) -> Tuple[bytes, bool]:
    """CCITT fax data (most significant bit first) -> ``rows`` rows of
    ``width`` 1-bit pixels, each row padded to a byte (0 white, 1 black, as
    coded; a cut or corrupt strip as libtiff's decoder leaves it, which
    libtiff's RGBA reader keeps), and the Group 3 EOL mode for the image's
    next strip. ``kind``: 0 Modified Huffman (compression 2), 1 the same
    word-aligned (32771; ``odd_base``: the data starts at an odd file
    offset), 2 Group 3 one-dimensional, 3 Group 3 two-dimensional, 4 Group
    4; ``no_eol``: Group 3 decoded without EOLs, as libtiff does for the
    rest of an image once a strip's data ends in zeros after an EOL's 11
    (csrc/tiff_codec.cpp)."""
    src = np.frombuffer(data, np.uint8)
    size = rows * ((width + 7) // 8)
    out = np.zeros(max(size, 1), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    r = codec_library().tiff_fax_decode(
        src.ctypes.data_as(u8p), src.size, out.ctypes.data_as(u8p), rows,
        width, kind, int(odd_base) | 2 * int(no_eol))
    return out[:size].tobytes(), bool(r)


def thunder_decode(data: bytes, rows: int, width: int) -> bytes:
    """ThunderScan data -> ``rows`` rows of ``width`` 4-bit pixels, each row
    padded to a byte; the row libtiff's decoder fails on and the rest 0,
    as libtiff's RGBA reader keeps them."""
    src = np.frombuffer(data, np.uint8)
    size = rows * ((width + 1) // 2)
    out = np.zeros(max(size, 1), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    codec_library().tiff_thunder_decode(src.ctypes.data_as(u8p), src.size,
                                        out.ctypes.data_as(u8p), rows, width)
    return out[:size].tobytes()


def sgilog_decode(data: bytes, rows: int, width: int,
                  planes: int) -> Tuple[np.ndarray, int]:
    """SGILog data -> uint32 [rows, width] words of ``planes`` bytes (2:
    LogL, 4: LogLuv), the row libtiff's decoder fails on and the rest 0,
    and the rows decoded whole."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((rows, width), np.uint32)
    done = codec_library().tiff_sgilog_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), rows, width,
        planes)
    return out, done


# ------------------------------------------------------------------ reading

def _ifd(path, data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order and the fields of the first IFD of a classic TIFF or
    a BigTIFF: integers as they are, RATIONAL and SRATIONAL as floats
    (libtiff's float numerator / float denominator, 0 over 0), ASCII as
    (bytes,)."""
    head = data[:4]
    if head[:2] == b"II":
        bo = "<"
    elif head[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    (version,) = struct.unpack(bo + "H", head[2:4]) if len(head) == 4 else (0,)
    big = version == 43
    if big:
        if len(data) < 16 or struct.unpack(bo + "HH", data[4:8]) != (8, 0):
            raise ValueError(f"{path}: not a BigTIFF header")
        (off,) = struct.unpack(bo + "Q", data[8:16])
        word, entry = "Q", 20
    elif version == 42 and len(data) >= 8:
        (off,) = struct.unpack(bo + "I", data[4:8])
        word, entry = "I", 12
    else:
        raise ValueError(f"{path}: not a TIFF file")
    n_code = "Q" if big else "H"
    size = struct.calcsize(n_code)
    if off + size > len(data):
        raise ValueError(f"{path}: the first IFD lies past the end")
    (n,) = struct.unpack(bo + n_code, data[off:off + size])
    base = off + size
    if base + entry * n > len(data):
        raise ValueError(f"{path}: truncated IFD")
    inline = struct.calcsize(word)
    tags = {}
    for i in range(n):
        e = data[base + entry * i:base + entry * (i + 1)]
        tag, typ = struct.unpack(bo + "HH", e[:4])
        (count,) = struct.unpack(bo + word, e[4:4 + inline])
        if typ in RATIONALS:
            code, nbytes = RATIONALS[typ] * 2 * count, 8 * count
        elif typ in FIELD:
            code, nbytes = f"{count}{FIELD[typ][0]}", FIELD[typ][1] * count
        else:
            continue                              # a type no tag here uses
        if nbytes <= inline:
            raw = e[4 + inline:4 + inline + nbytes]
        else:
            (at,) = struct.unpack(bo + word, e[4 + inline:4 + 2 * inline])
            raw = data[at:at + nbytes]
            if len(raw) != nbytes:
                raise ValueError(f"{path}: field {tag} lies past the end")
        if typ == 2:
            tags[tag] = (raw,)
        elif typ in RATIONALS:
            v = struct.unpack(bo + code, raw)
            tags[tag] = tuple(float(np.float32(a) / np.float32(b)) if b
                              else 0.0 for a, b in zip(v[0::2], v[1::2]))
        else:
            tags[tag] = struct.unpack(bo + code, raw)
    return bo, tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def _refuse(path, kind: str):
    raise NotImplementedError(f"{path}: {kind} is not read; the port reads "
                              "what cv2.imread reads of classic and BigTIFF "
                              "(utils/tiff.py), uncompressed, LZW, Deflate, "
                              "PackBits, JPEG or CCITT (RLE, RLEW, Group 3, "
                              "Group 4)")


def _no_image(path, kind: str):
    raise ValueError(f"{path}: {kind}; cv2.imread returns no image for it")


def _decompress(path, comp: int, data: bytes, size: int,
                short: list) -> bytes:
    """A strip's or tile's ``size`` bytes. Where the data decodes short
    (cut off or corrupt), what libtiff's decoder leaves in its zeroed
    buffer: what was decoded, zeros after (an uncompressed chunk: nothing,
    as DumpModeDecode copies nothing), the decoded size appended to
    ``short``."""
    if comp == ZEROS:
        return bytes(size)
    if comp == NONE:
        out = data[:size]
    elif comp == LZW:
        out = lzw_decode(data, size)
    elif comp in (DEFLATE, DEFLATE_OLD):
        try:
            out = zlib.decompressobj().decompress(data, size)
        except zlib.error:
            out = _inflate_kept(data, size)
    else:
        out = packbits_decode(data, size)
    if len(out) < size:
        short.append(len(out))
        out = bytes(size) if comp == NONE else out + bytes(size - len(out))
    return out


def _inflate_kept(data: bytes, size: int) -> bytes:
    """The bytes zlib inflates from corrupt Deflate data before the fault,
    as libtiff's ZIPDecode leaves them: the longest output bound that
    inflates without the error (bisected; inflate stops when its output is
    full, before it decodes further)."""
    lo, hi = 0, size
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            zlib.decompressobj().decompress(data, mid)
            lo = mid
        except zlib.error:
            hi = mid - 1
    return zlib.decompressobj().decompress(data, lo) if lo else b""


@dataclass
class Layout:
    """Where the first image's strips or tiles lie: each chunk's (y, x,
    rows, cols) box (tiles at their full size, a last strip cut to the
    image), its bytes as stored, planes in turn (PlanarConfiguration 2),
    and each one's file offset."""
    boxes: List[Tuple[int, int, int, int]]
    chunks: List[bytes]
    tile_width: int
    starts: List[int]
    # the decoded sizes of chunks that decode short (``_decompress``)
    short: List[int] = field(default_factory=list)

    def fax(self, kind: int) -> None:
        """Each chunk's CCITT data decoded (``fax_decode``) in place of it:
        1-bit rows as an uncompressed chunk holds them, the chunks in
        libtiff's order (Group 3's EOL mode carried from one to the
        next)."""
        n, no_eol, chunks = len(self.boxes), False, []
        for i, c in enumerate(self.chunks):
            _, _, rows, cols = self.boxes[i % n]
            raw, no_eol = fax_decode(c, rows, cols, kind,
                                     self.starts[i] % 2 == 1, no_eol)
            chunks.append(raw)
        self.chunks = chunks

    def thunder(self) -> None:
        """Each chunk's ThunderScan data decoded in place of it: 4-bit
        rows as an uncompressed chunk holds them."""
        n = len(self.boxes)
        self.chunks = [thunder_decode(c, self.boxes[i % n][2],
                                      self.boxes[i % n][3])
                       for i, c in enumerate(self.chunks)]


def _layout(path, data: bytes, tags, h: int, w: int, planes: int,
            reverse: bool) -> Layout:
    if TILE_OFFSETS in tags:
        tw, th = _one(tags, TILE_WIDTH), _one(tags, TILE_LENGTH)
        if not tw or not th:
            raise ValueError(f"{path}: no tile size")
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_BYTES)
        boxes = [(ty, tx, th, tw) for ty in range(0, h, th)
                 for tx in range(0, w, tw)]
    else:
        tw = w
        rps = min(_one(tags, ROWS_PER_STRIP, h) or h, h)
        offsets, counts = tags.get(STRIP_OFFSETS), tags.get(STRIP_BYTES)
        if offsets is None:
            raise ValueError(f"{path}: no strip offsets")
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    if len(offsets) < planes * len(boxes):
        raise ValueError(f"{path}: {len(offsets)} strips or tiles, "
                         f"{planes * len(boxes)} expected")
    chunks, starts = [], []
    for i in range(planes * len(boxes)):
        start = offsets[i]
        starts.append(start)
        end = start + counts[i] if counts is not None else len(data)
        chunk = data[start:end]
        if reverse:                       # FillOrder 2: libtiff's bit flip
            chunk = REVERSED_BITS[np.frombuffer(chunk, np.uint8)].tobytes()
        chunks.append(chunk)
    return Layout(boxes, chunks, tw, starts)


def _unpack(chunk: bytes, rows: int, n: int, bits: int) -> np.ndarray:
    """Rows of ``n`` samples of ``bits`` bits (most significant first, each
    row padded to a byte) -> uint8 or uint16 [rows, n]."""
    b = np.frombuffer(chunk, np.uint8, rows * (-(-n * bits // 8)))
    b = np.unpackbits(b.reshape(rows, -1), axis=1)[:, :n * bits]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    v = b.reshape(rows, n, bits).astype(np.uint16) @ weights
    return v.astype(np.uint8 if bits <= 8 else np.uint16)


def _chunk_samples(path, chunk: bytes, comp: int, pred: int, bits: int,
                   rows: int, cols: int, per: int, bo: str,
                   short: list) -> np.ndarray:
    """One strip or tile decompressed and its predictor undone: unsigned
    samples [rows, cols, per] in the host's order (uint8 or uint16 below 8
    bits and at 10-14 bits, the samples' own width otherwise)."""
    if bits not in (8, 16, 32, 64):
        row = -(-cols * per * bits // 8)
        raw = _decompress(path, comp, chunk, rows * row, short)
        return _unpack(raw, rows, cols * per, bits).reshape(rows, cols, per)
    item = bits // 8
    dtype = np.dtype(f"{bo}u{item}")
    before = len(short)
    raw = _decompress(path, comp, chunk, rows * cols * per * item, short)
    # libtiff runs no predictor on a chunk its codec failed on
    pred = pred if len(short) == before else 1
    if pred == 3 and comp in PREDICTED:
        return _float_predictor(raw, rows, cols, per, item)
    a = np.frombuffer(raw, dtype, rows * cols * per).reshape(rows, cols, per)
    native = dtype.newbyteorder("=")
    if pred == 2 and comp in PREDICTED:
        return np.cumsum(a.astype(native), axis=1, dtype=native)
    return a.astype(native)


def _samples(path, lay: Layout, comp: int, pred: int, bits: int, spp: int,
             planar: int, bo: str, h: int, w: int) -> np.ndarray:
    """Every chunk's samples (``_chunk_samples``) in place: [h, w, spp]."""
    planes = 1 if planar == 1 else spp
    per = spp if planar == 1 else 1               # samples in a chunk
    out = None
    n_box = len(lay.boxes)
    for i, chunk in enumerate(lay.chunks):
        p, j = divmod(i, n_box)
        y, x, rows, cols = lay.boxes[j]
        a = _chunk_samples(path, chunk, comp, pred, bits, rows, cols, per, bo,
                           lay.short)
        if out is None:
            out = np.zeros((planes, h, w, per), a.dtype)
        rr, cc = min(rows, h - y), min(cols, w - x)
        out[p, y:y + rr, x:x + cc] = a[:rr, :cc]
    return out[0] if planar == 1 else out[..., 0].transpose(1, 2, 0)


def _first_gray(path, lay: Layout, comp: int, pred: int, bits: int,
                spp: int, bo: str, h: int, w: int) -> np.ndarray:
    """The first sample of a chunky gray image of ``spp`` 8- or 16-bit
    samples as libtiff's RGBA reader takes it (putgreytile, putagreytile,
    put16bitbwtile): in a tile cut by the right edge each row after the
    first starts (tile width - cut width) bytes, not samples, after the
    end of the previous one. [h, w] uint8 or uint16."""
    item = bits // 8
    out = np.zeros((h, w), np.uint8 if item == 1 else np.uint16)
    for (y, x, rows, cols), chunk in zip(lay.boxes, lay.chunks):
        a = _chunk_samples(path, chunk, comp, pred, bits, rows, cols, spp,
                           bo, lay.short)
        rr, cc = min(rows, h - y), min(cols, w - x)
        raw = np.frombuffer(a.astype(f"<u{item}").tobytes(), np.uint8)
        start = (np.arange(rr) * (cc * spp * item + cols - cc))[:, None] \
            + np.arange(cc) * spp * item
        v = raw[start].astype(np.uint16)
        if item == 2:
            v = v | (raw[start + 1].astype(np.uint16) << 8)
        out[y:y + rr, x:x + cc] = v
    return out


@dataclass
class Decoded:
    """The host part of reading a TIFF, which ``tiff_pixels`` finishes:
    ``stage`` "done" (``array`` is the image, orientation applied),
    "jpeg" (``frames``: each strip's or tile's (y, x, rows, cols, plane)
    and its decoded JPEG Frame; ``channels`` 1 or 3; ``invert`` for
    MinIsWhite; ``palette``: the ColorMap the decoded bytes index;
    ``tables``: libtiff's YCbCr tables for planar YCbCr streams), "ycbcr"
    (``array``: uint8 Y, Cb, Cr [H, W, 3] at full resolution; ``tables``:
    libtiff's conversion tables), "cmyk" (``array``: uint8 C, M, Y, K [H,
    W, 4]) or "lab" (``array``: the CIE L*a*b* samples [H, W, 3] as int8
    or int16, L's bits as stored; ``white``: the reference white's X, Y,
    Z); then ``orientation`` 1-4, each horizontal flip mirroring runs of
    ``flip_width`` columns, and ``signed``: the uint8 result read as int8
    (signed 8-bit samples, as OpenCV returns them)."""
    stage: str
    height: int
    width: int
    array: Optional[np.ndarray] = None
    frames: Optional[list] = None
    channels: int = 3
    invert: bool = False
    tables: Optional[np.ndarray] = None
    orientation: int = 1
    flip_width: int = 0
    palette: Optional[np.ndarray] = None
    white: Optional[np.ndarray] = None
    signed: bool = False


def _orient(img, orientation: int, flip_width: int):
    """cv2's orientations 2-4 on an [H, W, ...] numpy array or tensor:
    rows reversed (3, 4), and each run of ``flip_width`` columns reversed
    in place (2, 3); OpenCV's 8-bit path, through libtiff's RGBA reader,
    mirrors each tile on its own and leaves the tiles where they are."""
    if orientation == 1:
        return img
    h, w = img.shape[:2]
    rows = np.arange(h)[::-1].copy() if orientation in (3, 4) else None
    cols = None
    if orientation in (2, 3):
        cols = np.concatenate([np.arange(t, min(t + flip_width, w))[::-1]
                               for t in range(0, w, flip_width)])
    if torch.is_tensor(img):
        rows = None if rows is None else torch.from_numpy(rows).to(
            img.device)
        cols = None if cols is None else torch.from_numpy(cols).to(
            img.device)
    if rows is not None:
        img = img[rows]
    if cols is not None:
        img = img[:, cols]
    return img


def decode_tiff(path) -> Decoded:
    """The host part of reading the first image of a TIFF file: the
    directory, every strip or tile decompressed (LZW, PackBits, CCITT fax,
    ThunderScan, SGILog, Deflate; JPEG through utils/jpeg.py's entropy
    decoder) and the samples laid out (see the module docstring for what
    is read and what raises)."""
    data = Path(path).read_bytes()
    bo, tags = _ifd(path, data)
    w, h = _one(tags, WIDTH), _one(tags, HEIGHT)
    if not w or not h:
        raise ValueError(f"{path}: no image size")
    spp = _one(tags, SAMPLES, 1)
    bits = tags.get(BITS, (1,))
    comp = _one(tags, COMPRESSION, NONE)
    photo = _one(tags, PHOTOMETRIC)
    planar = _one(tags, PLANAR, 1)
    fmt = _one(tags, SAMPLE_FORMAT, 1)
    pred = _one(tags, PREDICTOR, 1)
    orientation = _one(tags, ORIENTATION, 1)
    _check_codec(path, comp, photo, bits, TILE_OFFSETS in tags)
    if orientation in (5, 6, 7, 8):
        _no_image(path, f"a TIFF of orientation {orientation} (rows and "
                  "columns transposed)")
    if orientation not in (1, 2, 3, 4):
        raise ValueError(f"{path}: orientation {orientation}")
    if photo not in PHOTOMETRICS:
        name = "no photometric interpretation" if photo is None else \
            PHOTOMETRIC_NAMES.get(photo, f"photometric {photo}")
        _no_image(path, f"a TIFF of {name} (libtiff's RGBA reader and "
                  "OpenCV's raw path take MinIsWhite, MinIsBlack, RGB, "
                  "palette, CMYK, YCbCr, CIE L*a*b*, LogL and LogLuv)")
    if planar not in (1, 2):
        raise ValueError(f"{path}: planar configuration {planar}")
    if len(set(bits)) != 1:
        _no_image(path, f"a TIFF of {'/'.join(map(str, bits))}-bit samples "
                  "(libtiff takes one BitsPerSample for every sample)")
    bits = bits[0]
    if (fmt, bits) == (3, 16):
        _no_image(path, "a half-float TIFF")
    if fmt not in (1, 2, 3) or (fmt == 3 and bits not in (1, 2, 4, 32, 64)):
        _no_image(path, f"a TIFF of {bits}-bit "
                  f"{SAMPLE_FORMATS.get(fmt, f'format {fmt}')} samples")
    if bits not in DEPTHS:
        _no_image(path, f"a TIFF of {bits}-bit samples (OpenCV reads 1, 2, "
                  "4, 8, 10, 12, 14, 16, 32 and 64)")
    if comp in PREDICTED:
        if pred not in (1, 2, 3) or (pred == 2 and bits not in (
                8, 16, 32, 64)) or (pred == 3 and fmt != 3):
            _no_image(path, f"a TIFF of {bits}-bit {SAMPLE_FORMATS[fmt]} "
                      f"samples with predictor {pred} (libtiff's predictor "
                      "refuses it)")
    else:
        pred = 1                  # libtiff's other codecs ignore the tag
    planes = 1 if planar == 1 else spp
    lay = _layout(path, data, tags, h, w, planes,
                  _one(tags, FILL_ORDER, 1) == 2 and comp != JPEG)
    if comp == NONE:
        _uncompressed_counts(path, data, tags, lay, photo, spp, bits, planar,
                             w, h)
    stored = comp
    if comp in FAX:
        lay.fax(3 if comp == CCITT_G3 and _one(tags, T4_OPTIONS, 0) & 1
                else FAX[comp])
        comp = NONE
    elif comp == THUNDERSCAN:
        lay.thunder()
        comp = NONE
    elif comp not in COMPRESSIONS:
        comp = ZEROS
    if comp == JPEG:
        dec = _jpeg_tiff(path, tags, lay, photo, spp, bits, planar, h, w)
    elif photo == 6:
        dec = _ycbcr_tiff(path, tags, lay, comp, pred, spp, bits, planar, h,
                          w)
    elif photo == 5:
        if _one(tags, INK_SET, 1) != 1 or spp != 4 or bits != 8:
            _no_image(path, f"a {bits}-bit separated TIFF of {spp} samples, "
                      f"ink set {_one(tags, INK_SET, 1)} (libtiff's RGBA "
                      "reader takes 8-bit CMYK)")
        dec = Decoded("cmyk", h, w, _samples(path, lay, comp, pred, 8, 4,
                                             planar, bo, h, w))
    elif photo == 8:
        dec = _lab_tiff(path, tags, lay, bo, comp, pred, spp, bits, planar,
                        h, w)
    elif photo == 32844:
        dec = _logl_tiff(path, lay, comp, spp, bits, fmt, h, w)
    elif photo == 32845:
        dec = _logluv_tiff(path, lay, spp, h, w)
    else:
        img = _plain_tiff(path, tags, lay, bo, comp, photo, planar, fmt,
                          pred, spp, bits, h, w)
        dec = Decoded("done", h, w, img)
    # OpenCV's 8-bit images come through libtiff's RGBA reader (tiles
    # mirrored in place), the deeper ones (and LogLuv's floats) whole
    eight = dec.stage not in ("done", "logluv") or (
        dec.stage == "done" and dec.array.itemsize == 1)
    if lay.short and not eight:
        _no_image(path, f"a strip or tile that decodes to {lay.short[0]} "
                  "bytes, short of its size (OpenCV's raw path fails on it; "
                  "libtiff's RGBA reader keeps what decoded)")
    if comp == ZEROS and not eight:
        _no_image(path, f"a TIFF of compression {stored}, which libtiff has "
                  "no codec for (OpenCV's raw path fails on it)")
    if eight and stored == NONE and TILE_OFFSETS in tags and \
            _one(tags, FILL_ORDER, 1) == 2:
        _no_image(path, "an uncompressed tiled 8-bit TIFF of fill order 2 "
                  "(libtiff's RGBA reader fails on its tiles)")
    dec.signed = eight and dec.stage != "done" and fmt == 2
    dec.orientation = orientation
    dec.flip_width = lay.tile_width if eight else w
    if dec.stage == "done":
        dec.array = np.ascontiguousarray(
            _orient(dec.array, orientation, dec.flip_width))
    return dec


def _uncompressed_counts(path, data: bytes, tags, lay: Layout, photo,
                         spp: int, bits: int, planar: int, w: int,
                         h: int) -> None:
    """libtiff's repairs of an uncompressed image's strip byte counts,
    which it reads from the file whatever follows each strip: one strip
    whose count is 0, past the end of the file or short of the image
    (ByteCountLooksBad), and chunky strips or tiles, more than 2, whose
    first two counts differ, are all sized TIFFScanlineSize x (image rows
    // strips), or TIFFTileSize (EstimateStripByteCounts); no image where
    that runs past the end of the file, or for a tile otherwise shorter
    than its size. A strip then short of its rows decodes to zeros
    (``_decompress``)."""
    tiled = TILE_OFFSETS in tags
    counts = tags.get(TILE_BYTES if tiled else STRIP_BYTES) or (0,)
    rethink = planar == 1 and len(lay.chunks) > 2 and counts[0] != counts[
        1] and counts[0] and counts[1]
    hs, vs = tags.get(YCBCR_SUBSAMPLING_TAG, (2, 2))[:2]
    units = photo == 6 and (hs, vs) != (1, 1) and planar == 1 and spp == 3
    if tiled:
        th = _one(tags, TILE_LENGTH)
        size = (-(-lay.tile_width // hs) * -(-th // vs) * (hs * vs + 2)
                if units else lay.tile_width * th * (
                    spp if planar == 1 else 1)) * bits // 8
        if not rethink:
            if min(len(c) for c in lay.chunks) < size:
                _no_image(path, "an uncompressed tile shorter than its size "
                          "(libtiff: an invalid tile byte count)")
            return
    else:
        if units:
            scanline = -(-w // hs) * (hs * vs + 2) * bits // 8 // vs
        else:
            scanline = -(-w * (spp if planar == 1 else 1) * bits // 8)
        # rows a strip: the image's over the strips', truncated
        size = scanline * (h // len(lay.boxes))
        if len(lay.chunks) == 1:
            at, count = lay.starts[0], counts[0]
            if at == 0 or (count and count <= len(data) - at
                           and count >= scanline * h):
                return
        elif not rethink:
            return
    reverse = _one(tags, FILL_ORDER, 1) == 2
    for i, at in enumerate(lay.starts):
        if at + size > len(data):
            _no_image(path, f"an uncompressed TIFF strip or tile at {at}, "
                      f"which libtiff sizes to {size} bytes past the end of "
                      "the file")
        # a strip of more rows than the estimate decodes to nothing
        chunk = data[at:at + size]
        if reverse:
            chunk = REVERSED_BITS[np.frombuffer(chunk, np.uint8)].tobytes()
        lay.chunks[i] = chunk


def _check_codec(path, comp: int, photo, bits: tuple, tiled: bool) -> None:
    """What libtiff's codecs refuse, as cv2.imread meets it: raises
    ValueError (cv2 returns None) or NotImplementedError (read by cv2, not
    here)."""
    name = COMPRESSIONS.get(comp)
    if comp in UNCONFIGURED:
        _no_image(path, f"a TIFF of compression {comp}, {name} (OpenCV's "
                  "libtiff is built without its codec)")
    if comp == NEXT:
        _no_image(path, "a NeXT TIFF (its codec takes 2-bit samples, which "
                  "OpenCV reads in no kind of image)")
    if comp in FAX and set(bits) != {1}:
        _no_image(path, f"a {name} TIFF of {'/'.join(map(str, bits))}-bit "
                  "samples (libtiff's fax codec takes 1 bit)")
    if comp == THUNDERSCAN:
        if set(bits) != {4}:
            _no_image(path, "a ThunderScan TIFF of other than 4-bit samples "
                      "(libtiff's codec takes 4 bits)")
        if tiled:
            _refuse(path, "a tiled ThunderScan TIFF (libtiff decodes its "
                    "tiles in rows of the image's width)")
    logluv = photo in (32844, 32845)
    if comp in (SGILOG, SGILOG24) or logluv:
        if comp not in (SGILOG, SGILOG24) or not logluv:
            _no_image(path, f"a {PHOTOMETRIC_NAMES.get(photo, 'non-LogLuv')}"
                      f" TIFF of compression {comp} (libtiff's SGILog codec "
                      "and LogL / LogLuv take only each other)")
        if comp == SGILOG24 and photo == 32845:
            _refuse(path, "a SGILog24 LogLuv TIFF (its decoder needs "
                    "tif_luv.c's uv table, uvcode.h, which is not derived "
                    "here)")


def _plain_tiff(path, tags, lay, bo, comp, photo, planar, fmt, pred, spp,
                bits, h, w) -> np.ndarray:
    """Gray, gray with extra samples, RGB(A) and palette images, as
    OpenCV's two paths leave them."""
    gray = photo in (0, 1)
    if spp > 4:
        _no_image(path, f"a TIFF of {spp} samples (OpenCV takes 1 to 4)")
    if photo == 2 and spp < 3:
        if spp == 2 or bits <= 8:
            _no_image(path, f"an RGB TIFF of {spp} {bits}-bit samples")
        gray = True          # OpenCV's raw path reads the sample as gray
    if photo == 3 and bits in (10, 12, 14, 16):
        _no_image(path, f"a {bits}-bit palette TIFF")
    if photo == 3 and bits in (32, 64):
        gray = True          # OpenCV's raw path reads the indices as gray
    if bits in (1, 2, 4):
        if fmt == 3 or spp != 1:
            _no_image(path, f"a {bits}-bit TIFF of {spp} "
                      f"{SAMPLE_FORMATS.get(fmt, fmt)} samples")
        if (gray and bits != 1) or (photo == 3 and bits == 2):
            _no_image(path, f"a {bits}-bit {'gray' if gray else 'palette'} "
                      "TIFF")
        # signed samples take the unsigned path and come back as int8
        out = np.int8 if fmt == 2 else np.uint8
        idx = _samples(path, lay, comp, 1, bits, 1, 1, bo, h, w)[..., 0]
        if gray:                 # libtiff's BWmap: 1 is white, or black
            return ((idx ^ np.uint8(photo == 0)) * np.uint8(255)).view(out)
        rgb = _palette(path, tags, bits)[idx]
        if bits == 4:
            return rgb.view(out)
        # OpenCV returns a 1-bit palette image as gray: its
        # icvCvt_BGRA2Gray_8u weights, 14 bits
        c = rgb.astype(np.int64)
        return ((c[..., 2] * 1868 + c[..., 1] * 9617 + c[..., 0] * 4899
                 + 8192) >> 14).astype(np.uint8).view(out)
    if bits in (10, 12, 14):
        if pred != 1 or (gray and spp == 2):
            _no_image(path, f"a {bits}-bit TIFF of {spp} samples, "
                      f"photometric {photo}, predictor {pred}")
        if gray and spp > 2:
            _refuse(path, f"a {bits}-bit gray TIFF of {spp} samples "
                    "(OpenCV folds them to one through its colour weights)")
        if planar == 2 and spp > 1:
            _refuse(path, f"a {bits}-bit planar (PlanarConfiguration 2) "
                    f"TIFF of {spp} samples (OpenCV's raw path reads the "
                    "first plane as interleaved samples and leaves the rest "
                    "of its buffer as it found it)")
        img = _samples(path, lay, comp, 1, bits, spp, planar, bo, h, w)
        img = img << np.uint16(16 - bits)        # MinIsWhite as stored
        if fmt == 2:                             # saturate_cast<short>
            img = np.minimum(img, 32767).astype(np.int16)
        return img[..., 0] if gray else img
    target = np.dtype(SAMPLE_TYPES[fmt, bits])
    if photo == 3 and bits == 8 and spp > 1 and planar == 2:
        _no_image(path, f"a planar palette TIFF of {spp} samples (libtiff's "
                  "RGBA reader has no separate-plane palette path)")
    if gray and spp > 1:
        if bits > 16 or fmt == 3:
            if spp == 2:
                _no_image(path, f"a gray TIFF of {spp} {bits}-bit "
                          f"{SAMPLE_FORMATS[fmt]} samples")
            gray = False     # OpenCV's raw path keeps 3 or 4 samples
        elif bits == 16 and spp > 2:
            _refuse(path, f"a 16-bit gray TIFF of {spp} samples (OpenCV "
                    "folds them to one through its colour weights)")
    if gray and spp > 1 and bits == 16:
        # libtiff's RGBA reader: the high bytes (put16bitbwtile), in planar
        # files (v + 128) / 257 (BuildMapBitdepth16To8)
        if planar == 1:
            g = _first_gray(path, lay, comp, pred, bits, spp, bo, h, w)
            g = (g >> 8).astype(np.uint8)
            return (255 - g if photo == 0 else g).view(
                np.int8 if fmt == 2 else np.uint8)
        img = _samples(path, lay, comp, pred, bits, spp, planar, bo, h, w)
        img = ((img.astype(np.int64) + 128) // 257).astype(np.uint8)
        return _planar_gray(tags, img).view(np.int8 if fmt == 2
                                            else np.uint8)
    if bits > 8 and planar == 2 and spp > 1:
        _refuse(path, f"a {bits}-bit planar (PlanarConfiguration 2) TIFF of "
                f"{spp} samples (OpenCV's raw path reads the first plane as "
                "interleaved samples and leaves the rest of its buffer as it "
                "found it)")
    if (gray or (photo == 3 and bits == 8)) and spp > 1 and planar == 1:
        # libtiff's RGBA reader: the first sample through BWmap
        # (MinIsWhite inverted) or the ColorMap
        g = _first_gray(path, lay, comp, pred, bits, spp, bo, h, w)
        if photo == 3:
            return _palette(path, tags, 8)[g].view(target)
        return (255 - g if photo == 0 else g).view(target)
    img = _samples(path, lay, comp, pred, bits, spp, planar, bo, h, w)
    if photo == 3 and bits == 8:
        return _palette(path, tags, 8)[img[..., 0]].view(target)
    img = img.view(np.uint8 if bits == 8 else target)
    if gray and spp > 1:
        return _planar_gray(tags, img).view(target)
    if gray:
        img = img[..., 0]
        img = 255 - img if photo == 0 and bits == 8 else img
    elif spp == 4 and bits == 8 and _one(tags, EXTRA_SAMPLES) == 2:
        a = img[..., 3:].astype(np.int64)
        rgb = (img[..., :3].astype(np.int64) * a + 127) // 255
        img = np.concatenate([rgb, a], -1).astype(np.uint8)
    return img.view(target)


def _planar_gray(tags, img: np.ndarray) -> np.ndarray:
    """libtiff's separate-plane RGBA reader on gray with extra samples
    (uint8 [H, W, spp]): the gray as stored, MinIsWhite too, times an
    unassociated alpha."""
    g = img[..., 0]
    if _one(tags, EXTRA_SAMPLES) == 2:
        g = ((g.astype(np.int64) * img[..., 1] + 127) // 255).astype(
            np.uint8)
    return g


def _palette(path, tags, bits: int) -> np.ndarray:
    """The ColorMap as uint8 RGB [2^bits, 3]: entries >> 8 unless every one
    is below 256 (libtiff's checkcmap)."""
    n = 1 << bits
    cmap = np.asarray(tags.get(COLORMAP, ()), np.int64)
    if cmap.size != 3 * n:
        raise ValueError(f"{path}: a {bits}-bit palette image without a "
                         f"{3 * n}-entry ColorMap")
    cmap = cmap.reshape(3, n)
    if cmap.max() >= 256:
        cmap = cmap >> 8
    return cmap.T.astype(np.uint8)


def _jpeg_tiff(path, tags, lay, photo, spp, bits, planar, h, w) -> Decoded:
    """Compression 7: each strip or tile a JPEG stream, whole or
    abbreviated (its tables in JPEGTables), decoded as libtiff's JPEG codec
    with libtiff's RGBA reader has libjpeg decode it: chunky YCbCr converted
    to RGB (JPEGCOLORMODE_RGB), RGB, gray and palette indices as they are;
    in planar files each plane's streams one component, a YCbCr image's
    planes then through libtiff's tables."""
    if bits != 8:
        _no_image(path, f"a {bits}-bit JPEG-in-TIFF (libtiff's JPEG codec "
                  "in OpenCV decodes 8 bits)")
    want = {0: 1, 1: 1, 2: 3, 3: 1, 6: 3}.get(photo)
    if want is None or spp != want:
        _no_image(path, f"a JPEG-in-TIFF of photometric {photo} with {spp} "
                  "samples (libtiff's RGBA reader takes gray, palette, RGB "
                  "and YCbCr)")
    tables = None
    if planar == 2 and photo == 6:
        hs, vs = tags.get(YCBCR_SUBSAMPLING_TAG, (2, 2))[:2]
        if (hs, vs) != (1, 1):
            _no_image(path, f"a planar YCbCr JPEG-in-TIFF subsampled "
                      f"{hs}x{vs} (libtiff's RGBA reader takes 1x1 planes)")
        tables = _ycbcr_tag_tables(tags)
    jpeg_tables = tags.get(JPEG_TABLES)
    jpeg_tables = bytes(jpeg_tables) if jpeg_tables else None
    per = spp if planar == 1 else 1               # components in a stream
    frames = []
    n_box = len(lay.boxes)
    for i, chunk in enumerate(lay.chunks):
        plane, j = divmod(i, n_box)
        y, x, rows, cols = lay.boxes[j]
        frame = J.decode_coefficients(chunk, f"{path} (a JPEG strip or tile)",
                                      tables=jpeg_tables)
        comps = frame.components
        if len(comps) != per or frame.height < min(rows, h - y) or \
                frame.width < min(cols, w - x):
            raise ValueError(f"{path}: a JPEG strip or tile of "
                             f"{frame.width}x{frame.height} and "
                             f"{len(comps)} components in a {cols}x{rows} "
                             f"box of {per} samples")
        if any((c.h, c.v) != (1, 1) for c in comps[1:]) or (
                (photo != 6 or planar == 2) and (comps[0].h, comps[0].v)
                != (1, 1)):
            raise ValueError(f"{path}: JPEG sampling factors "
                             f"{[(c.h, c.v) for c in comps]} that libtiff "
                             "refuses")
        # the TIFF's photometric, not the stream's markers, says whether
        # libjpeg converts the colour
        frame.colour = "gray" if per == 1 else "ycc" if photo == 6 else "rgb"
        frames.append((y, x, rows, cols, plane if planar == 2 and spp > 1
                       else None, frame))
    return Decoded("jpeg", h, w, frames=frames, channels=spp,
                   invert=photo == 0, tables=tables,
                   palette=_palette(path, tags, 8) if photo == 3 else None)


def _ycbcr_tag_tables(tags) -> np.ndarray:
    return ycbcr_tables(tags.get(YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114)),
                        tags.get(REFERENCE_BLACK_WHITE,
                                 (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)))


def _ycbcr_tiff(path, tags, lay, comp, pred, spp, bits, planar, h,
                w) -> Decoded:
    """Uncompressed (or LZW, Deflate, PackBits, unknown) YCbCr: each
    chunk's data units (hs x vs luma samples, then Cb and Cr) spread over
    their pixels, as tif_getimage.c's putcontig8bitYCbCr*tile place them,
    with libtiff's reads: a strip read as (rows rounded up to vs) x
    TIFFScanlineSize bytes, which truncates a row of 4x4 units to a quarter
    (the bytes left out stay 0); the horizontal predictor run over rows of
    TIFFScanlineSize (strips) or TIFFTileRowSize (tiles, at full
    resolution) bytes at a stride of 3, and not at all where those do not
    divide; in a 4x4 tile cut by the right edge each row of units after
    the first taken 10, not 18, bytes a skipped unit after the last."""
    hs, vs = tags.get(YCBCR_SUBSAMPLING_TAG, (2, 2))[:2]
    if bits != 8 or spp != 3:
        _no_image(path, f"a YCbCr TIFF of {spp} {bits}-bit samples")
    if (hs, vs) not in YCBCR_SUBSAMPLING:
        _no_image(path, f"a YCbCr TIFF subsampled {hs}x{vs} (libtiff's "
                  "RGBA reader takes 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4)")
    if planar == 2 and (hs, vs) != (1, 1):
        _no_image(path, f"a planar YCbCr TIFF subsampled {hs}x{vs} "
                  "(libtiff's RGBA reader takes 1x1 planes)")
    tables = _ycbcr_tag_tables(tags)
    if (hs, vs) == (1, 1):
        ycc = _samples(path, lay, comp, pred, 8, 3, planar, "<", h, w)
        return Decoded("ycbcr", h, w, ycc, tables=tables)
    tiled = TILE_OFFSETS in tags
    unit = hs * vs + 2
    scanline = -(-w // hs) * unit // vs           # TIFFScanlineSize
    rowsize = lay.tile_width * 3 if tiled else scanline
    ycc = np.zeros((h, w, 3), np.uint8)
    for (y, x, rows, cols), chunk in zip(lay.boxes, lay.chunks):
        down, across = -(-rows // vs), -(-cols // hs)
        size = down * across * unit
        n = size if tiled else min(size, down * vs * scanline)
        raw = np.zeros(size, np.uint8)
        raw[:n] = np.frombuffer(_decompress(path, comp, chunk, n,
                                            lay.short), np.uint8, n)
        if pred == 2 and n % rowsize == 0 and rowsize % 3 == 0:
            raw[:n] = np.cumsum(raw[:n].reshape(-1, rowsize // 3, 3), axis=1,
                                dtype=np.uint8).reshape(-1)
        rr, cc = min(rows, h - y), min(cols, w - x)
        used = -(-cc // hs)                       # units a row puts
        step = across * unit
        if (hs, vs) == (4, 4) and cc < cols:      # libtiff's fromskew
            step = used * unit + (cols - cc) // 4 * 10
        starts = np.arange(down)[:, None] * step + np.arange(used) * unit
        u = raw[starts[..., None] + np.arange(unit)]
        luma = u[..., :hs * vs].reshape(down, used, vs, hs).transpose(
            0, 2, 1, 3).reshape(down * vs, used * hs)
        chroma = u[..., hs * vs:].repeat(vs, 0).repeat(hs, 1)
        ycc[y:y + rr, x:x + cc, 0] = luma[:rr, :cc]
        ycc[y:y + rr, x:x + cc, 1:] = chroma[:rr, :cc]
    return Decoded("ycbcr", h, w, ycc, tables=tables)


@functools.lru_cache(maxsize=None)
def ycbcr_tables(luma: tuple, ref_black_white: tuple) -> np.ndarray:
    """tif_color.c's TIFFYCbCrToRGBInit in its float32 arithmetic: int64
    [5, 256], the Cr -> R, Cb -> B, Cr -> G and Cb -> G (16 fraction bits,
    the half added) and Y tables, indexed by the stored byte (cached: a
    Python loop of 256 steps, read only)."""
    f32 = np.float32

    def clamp(v, lo, hi):                 # CLAMP, NaN to the minimum
        return f32(lo) if not v >= lo else f32(hi) if v > hi else v

    def code2v(c, rb, rw, cr):
        span = f32(rw - rb)
        return f32(f32(c - int(rb)) * f32(cr)) / (span if span else f32(1))

    def clampw(v):
        return int(min(max(v, f32(-128 * 32)), f32(128 * 32)))

    def fix(v):
        return int(f32(v) * f32(65536) + f32(0.5))

    lr, lg, lb = (f32(v) for v in luma)
    rbw = [f32(v) for v in ref_black_white]
    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d3 = fix(clamp(f1, 0, 2)), fix(clamp(f3, 0, 2))
    d2 = -fix(clamp(f32(lr * f1) / lg, 0, 2))
    d4 = -fix(clamp(f32(lb * f3) / lg, 0, 2))
    out = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127))
        cb = clampw(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127))
        out[:, i] = ((d1 * cr + HALF) >> 16, (d3 * cb + HALF) >> 16,
                     d2 * cr, d4 * cb + HALF,
                     clampw(code2v(x + 128, rbw[0], rbw[1], 255)))
    return out


def _lab_tiff(path, tags, lay, bo, comp, pred, spp, bits, planar, h,
              w) -> Decoded:
    """CIE L*a*b* (photometric 8), which OpenCV reads through libtiff's
    RGBA reader: 3 chunky samples of 8 or 16 bits, L unsigned and a*, b*
    signed, and the WhitePoint (libtiff's default D50); ``tiff_pixels``
    converts them."""
    if spp != 3 or EXTRA_SAMPLES in tags or bits not in (8, 16) or \
            planar != 1:
        _no_image(path, f"a CIE L*a*b* TIFF of {spp} {bits}-bit samples, "
                  f"planar configuration {planar} (libtiff's RGBA reader "
                  "takes 3 chunky samples of 8 or 16 bits)")
    white = tags.get(WHITE_POINT)
    if white is None:
        f = np.float32
        total = f(D50[0]) + f(D50[1]) + f(D50[2])
        white = (f(D50[0]) / total, f(D50[1]) / total)
    if len(white) < 2 or white[1] == 0:
        _no_image(path, f"a CIE L*a*b* TIFF of WhitePoint {white} "
                  "(libtiff refuses a y of 0)")
    lab = _samples(path, lay, comp, pred, bits, 3, 1, bo, h, w)
    return Decoded("lab", h, w, lab.view(np.int8 if bits == 8 else np.int16),
                   white=lab_white(white[0], white[1]))


def _sgilog_words(path, lay: Layout, h: int, w: int,
                  planes: int) -> np.ndarray:
    """Every chunk's SGILog words in place: int64 [h, w]. A chunk short of
    data: its rows from the fault on 0 (libtiff's RGBA reader keeps them),
    LogLuv's no image (OpenCV's float path fails on it)."""
    words = np.zeros((h, w), np.int64)
    for (y, x, rows, cols), chunk in zip(lay.boxes, lay.chunks):
        rr, cc = min(rows, h - y), min(cols, w - x)
        got, done = sgilog_decode(chunk, rows, cols, planes)
        if planes == 4 and done < rows:
            _no_image(path, "a LogLuv strip or tile short of data")
        words[y:y + rr, x:x + cc] = got[:rr, :cc]
    return words


def _logl_tiff(path, lay, comp, spp, bits, fmt, h, w) -> Decoded:
    """LogL (photometric 32844) under SGILog, which libtiff's RGBA reader
    turns to 8-bit gray (L16toGry); ``tiff_pixels`` looks the words up."""
    if comp != SGILOG or spp != 1 or fmt == 3 or bits not in (8, 16):
        _no_image(path, f"a LogL TIFF of {spp} {bits}-bit "
                  f"{SAMPLE_FORMATS[fmt]} samples, compression {comp} "
                  "(libtiff's RGBA reader takes one SGILog sample; OpenCV, "
                  "8 or 16 integer bits)")
    return Decoded("logl", h, w, _sgilog_words(path, lay, h, w, 2))


def _logluv_tiff(path, lay, spp, h, w) -> Decoded:
    """LogLuv (photometric 32845) under SGILog, which OpenCV reads as
    float32 XYZ (tif_luv.c LogLuv32toXYZ) turned to BGR by
    cvtColor(COLOR_XYZ2BGR); ``tiff_pixels`` does both on the device."""
    if spp != 3:
        _no_image(path, f"a LogLuv TIFF of {spp} samples (libtiff takes 3)")
    return Decoded("logluv", h, w, _sgilog_words(path, lay, h, w, 4))


@functools.lru_cache(maxsize=None)
def logluv_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """tif_luv.c's LogLuv32toXYZ in double, as tables: Y (LogL16toY) by the
    word's high 16 bits, x / y and (1 - x - y) / y by its low 16 (u, v),
    each float64 [65536]; X = float(x / y * Y), Y = float(Y), Z =
    float((1 - x - y) / y * Y), 0 where Y <= 0 (cached; C's exp through
    math)."""
    ln2 = math.log(2.0)
    lum = np.zeros(65536)
    for p in range(65536):
        le = p & 0x7FFF
        if le:
            y = math.exp(ln2 / 256.0 * (le + 0.5) - ln2 * 64.0)
            lum[p] = -y if p & 0x8000 else y
    k = np.arange(256, dtype=np.float64)
    u = (1.0 / 410.0 * (k[:, None] + 0.5)).repeat(256, 1)
    v = (1.0 / 410.0 * (k[None, :] + 0.5)).repeat(256, 0)
    s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
    x, y = 9.0 * u * s, 4.0 * v * s
    return lum, (x / y).reshape(-1), ((1.0 - x - y) / y).reshape(-1)


def logluv_rgb(words: torch.Tensor) -> torch.Tensor:
    """LogLuv words (int64 [H, W]) -> float32 RGB [H, W, 3] on their
    device, as OpenCV reads them: libtiff's double XYZ (``logluv_tables``:
    float64 products on the device, then float32) and OpenCV 5.0's float
    XYZ -> BGR with its XYZ2sRGB_D65 matrix, evaluated as its baseline SIMD
    loop does: each row's first (W // 4) * 4 pixels x c0 + (y c1 + z c2),
    the rest (x c0 + y c1) + z c2, one rounding an operation."""
    dev = words.device
    lum, xr, zr = (torch.from_numpy(t).to(dev) for t in logluv_tables())
    big = lum[(words >> 16) & 65535]
    uv = words & 65535
    keep = big > 0
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    xyz = [torch.where(keep, t, zero).to(torch.float32)
           for t in (xr[uv] * big, big, zr[uv] * big)]
    w = words.shape[-1]
    body = torch.arange(w, device=dev) < w // 4 * 4
    out = []
    for row in XYZ_TO_SRGB:              # R, G, B
        c = [torch.tensor(float(v), dtype=torch.float32, device=dev)
             for v in row]
        p = [xyz[k] * c[k] for k in range(3)]
        out.append(torch.where(body, p[0] + (p[1] + p[2]),
                               (p[0] + p[1]) + p[2]))
    return torch.stack(out, -1)


@functools.lru_cache(maxsize=None)
def logl_table() -> np.ndarray:
    """tif_luv.c's L16toGry for every LogL word (its low 16 bits): uint8
    [65536], 0 for Y <= 0, 255 for Y >= 1, else (int)(256 sqrt Y), Y =
    LogL16toY's exp(ln 2 / 256 (Le + 0.5) - 64 ln 2), the words' sign bit
    negating it; C's exp and sqrt through math (cached: 32,767 calls)."""
    out = np.zeros(65536, np.uint8)
    ln2 = math.log(2.0)
    for p in range(1, 32768):
        y = math.exp(ln2 / 256.0 * (p + 0.5) - ln2 * 64.0)
        out[p] = 255 if y >= 1.0 else int(256.0 * math.sqrt(y))
    return out


def lab_white(x: float, y: float) -> np.ndarray:
    """initCIELabConversion's reference white from the WhitePoint's x, y:
    float32 X, Y, Z (Y = 100)."""
    f = np.float32
    x, y = f(x), f(y)
    return np.array([x / y * f(100), f(100), (f(1) - x - y) / y * f(100)],
                    np.float32)


@functools.lru_cache(maxsize=None)
def lab_table() -> np.ndarray:
    """TIFFCIELabToRGBInit's Yr2r table for libtiff's display_sRGB (the
    three guns alike) rounded as TIFFXYZToRGB rounds it (RINT, then at
    most 255): uint8 [1501]. The powers are C's pow (math.pow), each
    rounded to float32 and times 255 in float32, as there."""
    gamma = 1.0 / float(np.float32(SRGB_GAMMA))
    p = np.array([math.pow(i / LAB_TABLE_RANGE, gamma)
                  for i in range(LAB_TABLE_RANGE + 1)], np.float32)
    v = np.float32(255) * p
    return np.minimum(np.floor(v.astype(np.float64) + 0.5), 255).astype(
        np.uint8)


def lab_rgb(lab: torch.Tensor, white: np.ndarray) -> torch.Tensor:
    """libtiff's putcontig8bitCIELab8 / 16 on the device: CIE L*a*b*
    samples (int8 or int16 [..., 3], L's bits as stored) -> uint8 RGB [...,
    3], through TIFFCIELab16ToXYZ (8-bit samples scaled to 16 bits: L *
    257, a* and b* * 256) and TIFFXYZToRGB (display_sRGB's matrix, the
    light clamped to [1, 100], the table index truncated). Each float32
    operation is one tensor operation in libtiff's order, every divisor a
    tensor on the device (a CPU scalar divisor is a multiplication by its
    reciprocal on CUDA), so the card, the CPU and libtiff agree bit for
    bit."""
    dev = lab.device
    f32 = torch.float32

    def c(v):
        return torch.tensor(float(np.float32(v)), dtype=f32, device=dev)

    x = lab.to(torch.int32)
    if lab.dtype == torch.int8:
        l16, a16, b16 = (x[..., 0] & 255) * 257, x[..., 1] * 256, \
            x[..., 2] * 256
    else:
        l16, a16, b16 = x[..., 0] & 65535, x[..., 1], x[..., 2]
    x0, y0, z0 = (c(v) for v in white)
    big_l = l16.to(f32) * c(100) / c(65535)
    small = big_l < c(8.856)
    y_small = big_l * y0 / c(903.292)
    cby_small = c(7.787) * (y_small / y0) + c(np.float32(16) / np.float32(116))
    cby_big = (big_l + c(16)) / c(116)
    y = torch.where(small, y_small, y0 * cby_big * cby_big * cby_big)
    cby = torch.where(small, cby_small, cby_big)

    def component(t, ref):
        return torch.where(t < c(0.2069), ref * (t - c(0.13793)) / c(7.787),
                           ref * t * t * t)

    xx = component(a16.to(f32) / c(256) / c(500) + cby, x0)
    zz = component(cby - b16.to(f32) / c(256) / c(200), z0)
    step = c(np.float32(SRGB_WHITE_Y - SRGB_BLACK_Y)
             / np.float32(LAB_TABLE_RANGE))
    table = torch.from_numpy(lab_table()).to(dev)
    out = []
    for m in SRGB_MATRIX:
        lum = c(m[0]) * xx + c(m[1]) * y + c(m[2]) * zz
        lum = lum.clamp(SRGB_BLACK_Y, SRGB_WHITE_Y)
        i = ((lum - c(SRGB_BLACK_Y)) / step).to(torch.int64)
        out.append(table[i.clamp(max=LAB_TABLE_RANGE)])
    return torch.stack(out, -1)


def _ycbcr_rgb(ycc: torch.Tensor, tables: np.ndarray) -> torch.Tensor:
    """libtiff's YCbCr -> RGB (TIFFYCbCrtoRGB through ``ycbcr_tables``) of
    uint8 Y, Cb, Cr [..., 3] on their device."""
    ycc = ycc.to(torch.int64)
    t = torch.from_numpy(tables).to(ycc.device)
    yv, cb, cr = t[4][ycc[..., 0]], ycc[..., 1], ycc[..., 2]
    return torch.stack([yv + t[0][cr], yv + ((t[3][cb] + t[2][cr]) >> 16),
                        yv + t[1][cb]], -1).clamp(0, 255).to(torch.uint8)


def tiff_pixels(dec: Decoded, device) -> torch.Tensor:
    """The device part of reading a TIFF: JPEG strips' and tiles' IDCT,
    upsampling and colour conversion (utils/jpeg.py ``frame_pixels``),
    libtiff's YCbCr -> RGB, CMYK -> RGB and CIE L*a*b* -> RGB, a JPEG
    palette's lookup, and the orientation, on ``device``; other images are
    copied there as they are."""
    dev = resolve_device(device)
    if dec.stage == "done":
        return torch.from_numpy(dec.array).to(dev)
    h, w = dec.height, dec.width
    if dec.stage == "jpeg":
        shape = (h, w) if dec.channels == 1 else (h, w, 3)
        img = torch.empty(shape, dtype=torch.uint8, device=dev)
        for y, x, rows, cols, plane, frame in dec.frames:
            px = J.frame_pixels(frame, dev)
            rr, cc = min(rows, h - y), min(cols, w - x)
            if plane is None:
                img[y:y + rr, x:x + cc] = px[:rr, :cc]
            else:
                img[y:y + rr, x:x + cc, plane] = px[:rr, :cc]
        if dec.invert:
            img = 255 - img
        if dec.tables is not None:
            img = _ycbcr_rgb(img, dec.tables)
        if dec.palette is not None:
            img = torch.from_numpy(dec.palette).to(dev)[img.to(torch.int64)]
    elif dec.stage == "ycbcr":
        img = _ycbcr_rgb(torch.from_numpy(dec.array).to(dev), dec.tables)
    elif dec.stage == "lab":
        img = lab_rgb(torch.from_numpy(dec.array).to(dev), dec.white)
    elif dec.stage == "logl":
        words = torch.from_numpy(dec.array).to(dev) & 65535
        img = torch.from_numpy(logl_table()).to(dev)[words]
    elif dec.stage == "logluv":               # OpenCV turns, then converts
        return logluv_rgb(_orient(torch.from_numpy(dec.array).to(dev),
                                  dec.orientation, dec.flip_width))
    else:                                            # CMYK
        c = torch.from_numpy(dec.array).to(dev).to(torch.int64)
        k = 255 - c[..., 3:]
        img = torch.cat([k * (255 - c[..., :3]) // 255,
                         torch.full_like(k, 255)], -1).to(torch.uint8)
    if dec.signed:
        img = img.view(torch.int8)
    return _orient(img, dec.orientation, dec.flip_width)


def read_tiff(path) -> np.ndarray:
    """Decode the first image of a TIFF file to what cv2.imread(path,
    IMREAD_UNCHANGED) returns, in RGB(A) order, as a numpy array (the
    pixel stages on the CPU; utils/image.py ``read_image`` runs them on a
    device)."""
    return tiff_pixels(decode_tiff(path), "cpu").numpy()


def _float_predictor(chunk: bytes, rows: int, cols: int, per: int,
                     item: int) -> np.ndarray:
    """libtiff's fpAcc: each row's bytes summed at a stride of ``per``,
    then read as ``item`` byte planes, the most significant first ->
    unsigned samples [rows, cols, per] in the host's order."""
    b = np.frombuffer(chunk, np.uint8, rows * cols * per * item)
    b = np.cumsum(b.reshape(rows, -1, per), axis=1, dtype=np.uint8)
    b = b.reshape(rows, item, cols * per).transpose(0, 2, 1)
    return np.ascontiguousarray(b).view(f">u{item}").astype(
        f"u{item}").reshape(rows, cols, per)


# ------------------------------------------------------------------ writing

def write_tiff(path, image: np.ndarray) -> None:
    """Write a uint8, uint16, uint32, int8, int16, int32, float32 or float64
    [H, W] or [H, W, C] (C in 1, 3, 4; RGB(A) order) image as
    cv2.imwrite(".tif") writes it; uint64 and int64 images as cv2 writes
    them too, as int32 of their low 32 bits."""
    img = np.asarray(image)
    if img.dtype.kind in "ui" and img.itemsize == 8:
        img = (img.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(
            np.uint32).view(np.int32)
    fmt = {"u": 1, "i": 2, "f": 3}.get(img.dtype.kind)
    if (fmt, 8 * img.itemsize) not in SAMPLE_TYPES or img.dtype == np.float16:
        raise ValueError(f"{path}: TIFF writing takes uint8, uint16, uint32, "
                         f"uint64, int8, int16, int32, int64, float32 or "
                         f"float64, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"{path}: image shape {image.shape} is not [H, W] "
                         "or [H, W, 1 | 3 | 4]")
    h, w, spp = img.shape
    bits = 8 * img.itemsize
    word = np.dtype(f"<u{img.itemsize}")
    if fmt == 3:
        strip, comp = img.astype(img.dtype.newbyteorder("<")).tobytes(), NONE
    else:
        u = img.view(f"u{img.itemsize}")
        diff = u.copy()
        diff[:, 1:] -= u[:, :-1]                    # wraps, as unsigned
        strip, comp = lzw_encode(diff.astype(word).tobytes()), LZW
    entries = [(WIDTH, 4, [w]), (HEIGHT, 4, [h]), (BITS, 3, [bits] * spp),
               (COMPRESSION, 3, [comp]),
               (PHOTOMETRIC, 3, [1 if spp == 1 else 2]),
               (STRIP_OFFSETS, 4, [8]), (SAMPLES, 3, [spp]),
               (ROWS_PER_STRIP, 4, [h]), (STRIP_BYTES, 4, [len(strip)]),
               (PLANAR, 3, [1])]
    if fmt != 3:
        entries.append((PREDICTOR, 3, [2]))
    entries.append((SAMPLE_FORMAT, 3, [fmt] * spp))
    body = strip + b"\0" * (len(strip) % 2)
    ifd_at = 8 + len(body)
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    fields, extra = b"", b""
    for tag, typ, vals in entries:
        value = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals)
        if len(value) <= 4:
            field = value.ljust(4, b"\0")
        else:
            field = struct.pack("<I", extra_at + len(extra))
            extra += value + b"\0" * (len(value) % 2)
        fields += struct.pack("<HHI", tag, typ, len(vals)) + field
    Path(path).write_bytes(b"II*\x00" + struct.pack("<I", ifd_at) + body
                           + struct.pack("<H", len(entries)) + fields
                           + b"\0\0\0\0" + extra)
