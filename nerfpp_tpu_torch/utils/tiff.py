"""TIFF reading and writing, as OpenCV's libtiff reads and writes them (no
image library).

The JAX package reads every view with ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes undistorted views with ``cv2.imwrite``; a
RAW converter's or photogrammetry tool's export is often a TIFF of 16 or
fewer bits, JPEG-compressed, YCbCr or CMYK. The machine with the card has
no OpenCV, so the port carries this codec: the compression passes are host
C++ (``csrc/tiff_codec.cpp``: LZW both ways and PackBits, built with g++
at first use by ``native.build_library``; JPEG strips and tiles through
utils/jpeg.py's entropy decoder), Deflate is zlib's, the directory, the
predictor and the sample layout are numpy, and the pixel stages of JPEG,
YCbCr and CMYK images run on the device. tests/test_torch_tiff*.py hold
both directions to cv2.

- ``decode_tiff`` (host) and ``tiff_pixels`` (device) return, and
  ``read_tiff`` returns as numpy, what cv2.imread(IMREAD_UNCHANGED)
  returns, in RGB(A) order, for the first image of a classic TIFF or a
  BigTIFF (8-byte offsets; LONG8, SLONG8 and IFD8 fields), little- or
  big-endian: strips or tiles, PlanarConfiguration 1 (chunky) or 2
  (planar), compression none (1), LZW (5), JPEG (7), Deflate (8, 32946)
  or PackBits (32773), FillOrder 2 (each stored byte's bits reversed,
  except in JPEG data), horizontal predictor 2 (which libtiff applies to
  LZW and Deflate only; with other compressions the tag is ignored, and so
  the differences come back as they are) and, on float samples, the
  floating-point predictor 3 (byte planes, most significant first, each
  row differenced byte by byte); samples of 8, 16 or 32 bits unsigned
  (SampleFormat 1), 8, 16 or 32 bits signed (2) and 32 or 64 bits float
  (3), returned as uint8, uint16, uint32, int8, int16, int32, float32 or
  float64. OpenCV reads 8-bit images through libtiff's RGBA interface
  (tif_getimage.c) and deeper ones raw, and each path leaves its mark,
  kept here:

  - gray (MinIsBlack or MinIsWhite), RGB, RGB with a fourth (extra)
    sample, 8-bit palette: 8-bit MinIsWhite is inverted and deeper
    MinIsWhite is not; an 8-bit fourth sample marked unassociated alpha
    (ExtraSamples 2) premultiplies the colour, (v * a + 127) // 255, and
    any other fourth sample is kept as alpha beside the colour as stored;
    signed 8-bit samples take the same path as unsigned bytes and are then
    read as int8; a palette of 16-bit entries is scaled by >> 8 unless
    every entry is below 256;
  - gray with extra samples (alpha): the gray as stored, [H, W] (8-bit
    MinIsWhite inverted; 16 bits come back as uint8, the high byte); in
    planar files the gray is not inverted and an unassociated alpha
    premultiplies it; in a chunky tile cut by the right edge libtiff steps
    each row by (tile width - cut width) bytes where samples are meant,
    and the reader steps as it does;
  - 1-bit bilevel: uint8 0 / 255 (MinIsWhite inverted); a 1-bit palette
    comes back gray (OpenCV's BGR -> gray weights, 14 bits), a 4-bit
    palette as RGB;
  - 10-, 12- and 14-bit samples (gray, RGB, RGBA): uint16, each sample
    << (16 - bits), MinIsWhite as stored;
  - CMYK (Separated, InkSet 1, 8 bits): RGBA, R = (255 - K)(255 - C) //
    255 and so on, alpha 255;
  - YCbCr, 8 bits: each data unit of hs x vs luma samples and a Cb and a
    Cr spread over its pixels (subsampling 1x1, 1x2, 2x1, 2x2, 4x1 and
    4x2; default 2x2), then tif_color.c's integer tables
    (TIFFYCbCrToRGBInit, in its float32 arithmetic) from
    YCbCrCoefficients and ReferenceBlackWhite (RATIONAL; libtiff's
    defaults when absent);
  - JPEG (compression 7) in strips or tiles, gray, RGB or YCbCr at any
    subsampling of its stream: each strip or tile a whole JPEG stream or
    an abbreviated one primed by JPEGTables (cv2.imwrite's and libtiff's
    own), decoded as libjpeg decodes it under libtiff's RGBA interface
    (utils/jpeg.py: the IDCT, fancy upsampling and, for photometric
    YCbCr alone, the YCbCr -> RGB conversion; the photometric, not the
    stream's markers, decides it);
  - Orientation 2, 3 and 4: mirrored left-right, turned 180 degrees,
    mirrored top-bottom; 8-bit images mirror each tile left-right in its
    place, as OpenCV's reading of libtiff's tiles does.

- ``write_tiff`` writes as cv2.imwrite(".tif") does: little-endian, one
  strip, integer samples LZW with predictor 2, float samples uncompressed
  with no predictor, SampleFormat 1, 2 or 3, no ExtraSamples for a fourth
  channel; uint8, uint16, uint32, int8, int16, int32, float32 or float64
  gray, RGB or RGBA. The pixels read back equal in cv2 and in
  ``read_tiff``; the bytes are not libtiff's.

What cv2.imread returns None for raises ValueError naming the file: 16-bit
CMYK and CMYK of other than 4 samples or of another ink set, 2- and 4-bit
gray, 2-bit and 16-bit palettes, 1-bit colour, 10-14-bit gray with alpha
or with a predictor, gray with alpha of 32-bit or float samples, more than
4 samples, 16-bit YCbCr, half-float (16-bit SampleFormat 3) samples,
Orientation 5-8, uncompressed 8-bit tiles of FillOrder 2, and the
compressions whose codec OpenCV's libtiff leaves out (LZMA, Zstandard,
WebP, LERC); so do malformed files. Still refused with NotImplementedError
naming the file and the kind: old-style JPEG (compression 6), CCITT, JPEG
2000 (34712: cv2 returns zeros) and the other compressions,
64-bit integer and 8-bit float samples, complex samples, Lab, LogLuv and
the other photometric interpretations, YCbCr subsampled 4x4 (OpenCV's
pixels leave the data units' at the right edge where the width left is
not a multiple of 4) or planar and subsampled, planar JPEG-in-TIFF,
signed 16-bit gray with alpha (OpenCV returns zeros), and planar images
deeper than 8 bits of more than one sample (OpenCV's raw path reads their
planes as interleaved samples).
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from dataclasses import dataclass
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
ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR = 278, 279, 284, 317
COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS = 320, 322, 323, 324
TILE_BYTES, INK_SET, EXTRA_SAMPLES, SAMPLE_FORMAT = 325, 332, 338, 339
JPEG_TABLES, YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING_TAG = 347, 529, 530
REFERENCE_BLACK_WHITE = 532

NONE, LZW, JPEG, DEFLATE, DEFLATE_OLD = 1, 5, 7, 8, 32946
PACKBITS = 32773
COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3 fax",
                4: "CCITT Group 4 fax", 6: "JPEG-in-TIFF (old-style JPEG)",
                7: "JPEG-in-TIFF", 34712: "JPEG 2000-in-TIFF",
                34925: "LZMA", 50000: "Zstandard", 50001: "WebP-in-TIFF",
                34887: "LERC"}
# compressions whose codec OpenCV's libtiff leaves out ("compression
# support is not configured": cv2.imread returns None)
UNCONFIGURED = (34925, 50000, 50001, 34887)
PHOTOMETRICS = {4: "transparency mask", 8: "CIE L*a*b*", 9: "ICC L*a*b*",
                10: "ITU L*a*b*", 32844: "LogL", 32845: "LogLuv"}
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
YCBCR_SUBSAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2))
# (SampleFormat, bits) -> the dtype cv2.imread returns
SAMPLE_TYPES = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 8): "i1",
                (2, 16): "i2", (2, 32): "i4", (3, 32): "f4", (3, 64): "f8"}
SAMPLE_FORMATS = {1: "unsigned", 2: "signed", 3: "float", 4: "void",
                  5: "complex signed", 6: "complex float"}
ERRORS = {-1: "a bad LZW code", -2: "no room for the output",
          -3: "old-style LZW (libtiff 4.0 and earlier), which is not read"}

_lib = None


def codec_library() -> ctypes.CDLL:
    """The LZW / PackBits pass, built with g++ on first use (raises
    without it)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX_FLAGS)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for fn in (lib.tiff_lzw_decode, lib.tiff_lzw_encode,
                   lib.tiff_packbits_decode):
            fn.restype = ctypes.c_int64
            fn.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
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
    """TIFF LZW data -> at most ``size`` bytes."""
    return _call(codec_library().tiff_lzw_decode, data, size)


def lzw_encode(data: bytes) -> bytes:
    """Bytes -> TIFF LZW data (at most 12 bits a code, so under 1.5 x the
    input plus the Clear and EOI codes)."""
    return _call(codec_library().tiff_lzw_encode, data,
                 len(data) * 3 // 2 + 16)


def packbits_decode(data: bytes, size: int) -> bytes:
    """PackBits data -> at most ``size`` bytes."""
    return _call(codec_library().tiff_packbits_decode, data, size)


# ------------------------------------------------------------------ reading

def _ifd(path, data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order and the fields of the first IFD of a classic TIFF or
    a BigTIFF: integers as they are, RATIONAL and SRATIONAL as floats
    (libtiff's float of numerator / denominator, 0 over 0), ASCII as
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
            tags[tag] = tuple(float(np.float32(a / b)) if b else 0.0
                              for a, b in zip(v[0::2], v[1::2]))
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
                              "PackBits or JPEG")


def _no_image(path, kind: str):
    raise ValueError(f"{path}: {kind}; cv2.imread returns no image for it")


def _decompress(path, comp: int, data: bytes, size: int) -> bytes:
    if comp == NONE:
        out = data[:size]
    elif comp == LZW:
        out = lzw_decode(data, size)
    elif comp in (DEFLATE, DEFLATE_OLD):
        try:
            out = zlib.decompressobj().decompress(data, size)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt Deflate data ({e})") from None
    else:
        out = packbits_decode(data, size)
    if len(out) < size:
        raise ValueError(f"{path}: a strip or tile of {len(out)} bytes, "
                         f"{size} expected")
    return out


@dataclass
class Layout:
    """Where the first image's strips or tiles lie: each chunk's (y, x,
    rows, cols) box (tiles at their full size, a last strip cut to the
    image), its bytes as stored, planes in turn (PlanarConfiguration 2)."""
    boxes: List[Tuple[int, int, int, int]]
    chunks: List[bytes]
    tile_width: int


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
    chunks = []
    for i in range(planes * len(boxes)):
        start = offsets[i]
        end = start + counts[i] if counts is not None else len(data)
        chunk = data[start:end]
        if reverse:                       # FillOrder 2: libtiff's bit flip
            chunk = REVERSED_BITS[np.frombuffer(chunk, np.uint8)].tobytes()
        chunks.append(chunk)
    return Layout(boxes, chunks, tw)


def _unpack(chunk: bytes, rows: int, n: int, bits: int) -> np.ndarray:
    """Rows of ``n`` samples of ``bits`` bits (most significant first, each
    row padded to a byte) -> uint8 or uint16 [rows, n]."""
    b = np.frombuffer(chunk, np.uint8, rows * (-(-n * bits // 8)))
    b = np.unpackbits(b.reshape(rows, -1), axis=1)[:, :n * bits]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    v = b.reshape(rows, n, bits).astype(np.uint16) @ weights
    return v.astype(np.uint8 if bits <= 8 else np.uint16)


def _chunk_samples(path, chunk: bytes, comp: int, pred: int, bits: int,
                   rows: int, cols: int, per: int, bo: str) -> np.ndarray:
    """One strip or tile decompressed and its predictor undone: unsigned
    samples [rows, cols, per] in the host's order (uint8 or uint16 below 8
    bits and at 10-14 bits, the samples' own width otherwise)."""
    if bits not in (8, 16, 32, 64):
        row = -(-cols * per * bits // 8)
        raw = _decompress(path, comp, chunk, rows * row)
        return _unpack(raw, rows, cols * per, bits).reshape(rows, cols, per)
    item = bits // 8
    dtype = np.dtype(f"{bo}u{item}")
    raw = _decompress(path, comp, chunk, rows * cols * per * item)
    if pred == 3 and comp in (LZW, DEFLATE, DEFLATE_OLD):
        return _float_predictor(raw, rows, cols, per, item)
    a = np.frombuffer(raw, dtype, rows * cols * per).reshape(rows, cols, per)
    native = dtype.newbyteorder("=")
    if pred == 2 and comp in (LZW, DEFLATE, DEFLATE_OLD):
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
        a = _chunk_samples(path, chunk, comp, pred, bits, rows, cols, per, bo)
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
                           bo)
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
    "jpeg" (``frames``: each strip's or tile's (y, x, rows, cols) and its
    decoded JPEG Frame; ``channels`` 1 or 3; ``invert`` for MinIsWhite),
    "ycbcr" (``array``: uint8 Y, Cb, Cr [H, W, 3] at full resolution;
    ``tables``: libtiff's conversion tables) or "cmyk" (``array``: uint8
    C, M, Y, K [H, W, 4]); then ``orientation`` 1-4, each horizontal flip
    mirroring runs of ``flip_width`` columns."""
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
    directory, every strip or tile decompressed (LZW, PackBits, Deflate;
    JPEG through utils/jpeg.py's entropy decoder) and the samples laid out
    (see the module docstring for what is read and what raises)."""
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
    if comp in UNCONFIGURED:
        _no_image(path, f"a {COMPRESSIONS[comp]} TIFF (OpenCV's libtiff has "
                  "no such codec)")
    if comp not in (NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS, JPEG):
        _refuse(path, f"a {COMPRESSIONS.get(comp, f'compression {comp}')}"
                " TIFF")
    if orientation in (5, 6, 7, 8):
        _no_image(path, f"a TIFF of orientation {orientation} (rows and "
                  "columns transposed)")
    if orientation not in (1, 2, 3, 4):
        raise ValueError(f"{path}: orientation {orientation}")
    if photo in PHOTOMETRICS:
        _refuse(path, f"a {PHOTOMETRICS[photo]} TIFF")
    if photo not in (0, 1, 2, 3, 5, 6):
        _refuse(path, f"a TIFF of photometric interpretation {photo}")
    if planar not in (1, 2):
        raise ValueError(f"{path}: planar configuration {planar}")
    if len(set(bits)) != 1:
        _refuse(path, f"a TIFF of {'/'.join(map(str, bits))}-bit samples")
    bits = bits[0]
    if (fmt, bits) == (3, 16):
        _no_image(path, "a half-float TIFF")
    planes = 1 if planar == 1 else spp
    lay = _layout(path, data, tags, h, w, planes,
                  _one(tags, FILL_ORDER, 1) == 2 and comp != JPEG)
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
    else:
        img = _plain_tiff(path, tags, lay, bo, comp, photo, planar, fmt,
                          pred, spp, bits, h, w)
        dec = Decoded("done", h, w, img)
    # OpenCV's 8-bit images come through libtiff's RGBA reader (tiles
    # mirrored in place), the deeper ones whole
    eight = dec.stage != "done" or dec.array.itemsize == 1
    if eight and comp == NONE and TILE_OFFSETS in tags and \
            _one(tags, FILL_ORDER, 1) == 2:
        _no_image(path, "an uncompressed tiled 8-bit TIFF of fill order 2 "
                  "(libtiff's RGBA reader fails on its tiles)")
    dec.orientation = orientation
    dec.flip_width = lay.tile_width if eight else w
    if dec.stage == "done":
        dec.array = np.ascontiguousarray(
            _orient(dec.array, orientation, dec.flip_width))
    return dec


def _plain_tiff(path, tags, lay, bo, comp, photo, planar, fmt, pred, spp,
                bits, h, w) -> np.ndarray:
    """Gray, gray with extra samples, RGB(A) and palette images, as
    OpenCV's two paths leave them."""
    if pred not in (1, 2, 3) or (pred == 3 and fmt != 3):
        _refuse(path, f"a TIFF of {SAMPLE_FORMATS.get(fmt, fmt)} samples "
                f"with predictor {pred}")
    gray = photo in (0, 1)
    if spp > 4:
        _no_image(path, f"a TIFF of {spp} samples (OpenCV takes 1 to 4)")
    if photo == 2 and spp not in (3, 4):
        _refuse(path, f"an RGB TIFF of {spp} samples")
    if photo == 3 and spp != 1:
        _refuse(path, f"a palette TIFF of {spp} samples")
    if bits in (1, 2, 4):
        if fmt != 1 or spp != 1:
            _no_image(path, f"a {bits}-bit TIFF of {spp} "
                      f"{SAMPLE_FORMATS.get(fmt, fmt)} samples")
        if (gray and bits != 1) or (photo == 3 and bits == 2):
            _no_image(path, f"a {bits}-bit {'gray' if gray else 'palette'} "
                      "TIFF")
        idx = _samples(path, lay, comp, 1, bits, 1, 1, bo, h, w)[..., 0]
        if gray:                 # libtiff's BWmap: 1 is white, or black
            return (idx ^ np.uint8(photo == 0)) * np.uint8(255)
        rgb = _palette(path, tags, bits)[idx]
        if bits == 4:
            return rgb
        # OpenCV returns a 1-bit palette image as gray: its
        # icvCvt_BGRA2Gray_8u weights, 14 bits
        c = rgb.astype(np.int64)
        return ((c[..., 2] * 1868 + c[..., 1] * 9617 + c[..., 0] * 4899
                 + 8192) >> 14).astype(np.uint8)
    if bits in (10, 12, 14):
        if fmt != 1:
            _refuse(path, f"a TIFF of {bits}-bit "
                    f"{SAMPLE_FORMATS.get(fmt, fmt)} samples")
        if pred != 1 or photo == 3 or (gray and spp != 1):
            _no_image(path, f"a {bits}-bit TIFF of {spp} samples, "
                      f"photometric {photo}, predictor {pred}")
        if planar == 2 and spp > 1:
            _refuse(path, f"a {bits}-bit planar (PlanarConfiguration 2) "
                    f"TIFF of {spp} samples (OpenCV reads its planes as "
                    "interleaved samples)")
        img = _samples(path, lay, comp, 1, bits, spp, planar, bo, h, w)
        img = img << np.uint16(16 - bits)        # MinIsWhite as stored
        return img[..., 0] if gray else img
    if (fmt, bits) not in SAMPLE_TYPES:
        _refuse(path, f"a TIFF of {bits}-bit "
                f"{SAMPLE_FORMATS.get(fmt, f'format {fmt}')} samples")
    target = np.dtype(SAMPLE_TYPES[fmt, bits])
    if photo == 3 and bits == 16:
        _no_image(path, "a 16-bit palette TIFF")
    if photo == 3 and (bits != 8 or fmt != 1):
        _refuse(path, f"a {bits}-bit {SAMPLE_FORMATS[fmt]} palette TIFF")
    if gray and spp > 1:
        if bits > 16 or fmt == 3:
            _no_image(path, f"a gray TIFF of {spp} {bits}-bit "
                      f"{SAMPLE_FORMATS[fmt]} samples")
        if bits == 16 and fmt == 2:
            _refuse(path, "a signed 16-bit gray TIFF with alpha (OpenCV "
                    "returns zeros for it)")
    if bits > 8 and planar == 2 and spp > 1:
        _refuse(path, f"a {bits}-bit planar (PlanarConfiguration 2) TIFF of "
                f"{spp} samples (OpenCV reads its planes as interleaved "
                "samples)")
    if gray and spp > 1 and planar == 1:
        # libtiff's RGBA reader: the first sample, 16 bits by its high
        # byte, through BWmap (MinIsWhite inverted)
        g = _first_gray(path, lay, comp, pred, bits, spp, bo, h, w)
        g = (g >> 8).astype(np.uint8) if bits == 16 else g
        return (255 - g if photo == 0 else g).view(
            np.uint8 if bits == 16 else target)
    img = _samples(path, lay, comp, pred, bits, spp, planar, bo, h, w)
    if photo == 3:
        return _palette(path, tags, 8)[img[..., 0]]
    img = img.view(np.uint8 if bits == 8 else target)
    if gray and spp > 1:
        # libtiff's separate-plane RGBA reader: the gray as stored, MinIsWhite
        # too, times an unassociated alpha
        g = img[..., 0]
        if _one(tags, EXTRA_SAMPLES) == 2:
            g = ((g.astype(np.int64) * img[..., 1] + 127) // 255).astype(
                np.uint8)
        return g.view(target)
    if gray:
        img = img[..., 0]
        img = 255 - img if photo == 0 and bits == 8 else img
    elif spp == 4 and bits == 8 and _one(tags, EXTRA_SAMPLES) == 2:
        a = img[..., 3:].astype(np.int64)
        rgb = (img[..., :3].astype(np.int64) * a + 127) // 255
        img = np.concatenate([rgb, a], -1).astype(np.uint8)
    return img.view(target)


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
    with libtiff's RGBA reader has libjpeg decode it: YCbCr converted to
    RGB (JPEGCOLORMODE_RGB), RGB and gray as they are."""
    if bits != 8 or planar != 1:
        _refuse(path, f"a {bits}-bit JPEG-in-TIFF of PlanarConfiguration "
                f"{planar}")
    want = {0: 1, 1: 1, 2: 3, 6: 3}.get(photo)
    if want is None or spp != want:
        _refuse(path, f"a JPEG-in-TIFF of photometric {photo} with {spp} "
                "samples")
    jpeg_tables = tags.get(JPEG_TABLES)
    jpeg_tables = bytes(jpeg_tables) if jpeg_tables else None
    frames = []
    for (y, x, rows, cols), chunk in zip(lay.boxes, lay.chunks):
        frame = J.decode_coefficients(chunk, f"{path} (a JPEG strip or tile)",
                                      tables=jpeg_tables)
        comps = frame.components
        if len(comps) != spp or frame.height < min(rows, h - y) or \
                frame.width < min(cols, w - x):
            raise ValueError(f"{path}: a JPEG strip or tile of "
                             f"{frame.width}x{frame.height} and "
                             f"{len(comps)} components in a {cols}x{rows} "
                             f"box of {spp} samples")
        if any((c.h, c.v) != (1, 1) for c in comps[1:]) or (
                photo != 6 and (comps[0].h, comps[0].v) != (1, 1)):
            raise ValueError(f"{path}: JPEG sampling factors "
                             f"{[(c.h, c.v) for c in comps]} that libtiff "
                             "refuses")
        # the TIFF's photometric, not the stream's markers, says whether
        # libjpeg converts the colour
        frame.colour = "gray" if spp == 1 else "ycc" if photo == 6 else "rgb"
        frames.append((y, x, rows, cols, frame))
    return Decoded("jpeg", h, w, frames=frames, channels=spp,
                   invert=photo == 0)



def _ycbcr_tiff(path, tags, lay, comp, pred, spp, bits, planar, h,
                w) -> Decoded:
    """Uncompressed (or LZW, Deflate, PackBits) YCbCr: each chunk's data
    units (hs x vs luma samples, then Cb and Cr) spread over their pixels,
    as tif_getimage.c's putcontig8bitYCbCr*tile place them."""
    hs, vs = tags.get(YCBCR_SUBSAMPLING_TAG, (2, 2))[:2]
    if bits != 8 or spp != 3:
        _no_image(path, f"a YCbCr TIFF of {spp} {bits}-bit samples")
    if (hs, vs) not in YCBCR_SUBSAMPLING:
        _refuse(path, f"a YCbCr TIFF subsampled {hs}x{vs}")
    if planar == 2 and (hs, vs) != (1, 1):
        _refuse(path, f"a planar YCbCr TIFF subsampled {hs}x{vs}")
    if pred != 1 and (hs, vs) != (1, 1):
        _refuse(path, f"a subsampled YCbCr TIFF with predictor {pred}")
    tables = ycbcr_tables(tags.get(YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114)),
                          tags.get(REFERENCE_BLACK_WHITE,
                                   (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)))
    if (hs, vs) == (1, 1):
        ycc = _samples(path, lay, comp, pred, 8, 3, planar, "<", h, w)
        return Decoded("ycbcr", h, w, ycc, tables=tables)
    ycc = np.zeros((h, w, 3), np.uint8)
    unit = hs * vs + 2
    for (y, x, rows, cols), chunk in zip(lay.boxes, lay.chunks):
        down, across = -(-rows // vs), -(-cols // hs)
        raw = _decompress(path, comp, chunk, down * across * unit)
        u = np.frombuffer(raw, np.uint8, down * across * unit).reshape(
            down, across, unit)
        luma = u[..., :hs * vs].reshape(down, across, vs, hs).transpose(
            0, 2, 1, 3).reshape(down * vs, across * hs)
        chroma = u[..., hs * vs:].repeat(vs, 0).repeat(hs, 1)
        rr, cc = min(rows, h - y), min(cols, w - x)
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


def tiff_pixels(dec: Decoded, device) -> torch.Tensor:
    """The device part of reading a TIFF: JPEG strips' and tiles' IDCT,
    upsampling and colour conversion (utils/jpeg.py ``frame_pixels``),
    libtiff's YCbCr -> RGB and CMYK -> RGB, and the orientation, on
    ``device``; other images are copied there as they are."""
    dev = resolve_device(device)
    if dec.stage == "done":
        return torch.from_numpy(dec.array).to(dev)
    h, w = dec.height, dec.width
    if dec.stage == "jpeg":
        shape = (h, w) if dec.channels == 1 else (h, w, 3)
        img = torch.empty(shape, dtype=torch.uint8, device=dev)
        for y, x, rows, cols, frame in dec.frames:
            px = J.frame_pixels(frame, dev)
            rr, cc = min(rows, h - y), min(cols, w - x)
            img[y:y + rr, x:x + cc] = px[:rr, :cc]
        if dec.invert:
            img = 255 - img
    elif dec.stage == "ycbcr":
        ycc = torch.from_numpy(dec.array).to(dev).to(torch.int64)
        t = torch.from_numpy(dec.tables).to(dev)
        yv, cb, cr = t[4][ycc[..., 0]], ycc[..., 1], ycc[..., 2]
        img = torch.stack([yv + t[0][cr],
                           yv + ((t[3][cb] + t[2][cr]) >> 16),
                           yv + t[1][cb]], -1).clamp(0, 255).to(torch.uint8)
    else:                                            # CMYK
        c = torch.from_numpy(dec.array).to(dev).to(torch.int64)
        k = 255 - c[..., 3:]
        img = torch.cat([k * (255 - c[..., :3]) // 255,
                         torch.full_like(k, 255)], -1).to(torch.uint8)
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
    cv2.imwrite(".tif") writes it."""
    img = np.asarray(image)
    fmt = {"u": 1, "i": 2, "f": 3}.get(img.dtype.kind)
    if (fmt, 8 * img.itemsize) not in SAMPLE_TYPES or img.dtype == np.float16:
        raise ValueError(f"{path}: TIFF writing takes uint8, uint16, uint32, "
                         f"int8, int16, int32, float32 or float64, not "
                         f"{img.dtype}")
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
