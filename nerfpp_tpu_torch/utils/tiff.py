"""TIFF reading and writing, as OpenCV's libtiff reads and writes them (no
image library).

The JAX package reads every view with ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes undistorted views with ``cv2.imwrite``; a
RAW converter's export is often a 16-bit TIFF. The machine with the card
has no OpenCV, so the port carries this codec: the compression passes are
host C++ (``csrc/tiff_codec.cpp``: LZW both ways and PackBits, built with
g++ at first use by ``native.build_library``), Deflate is zlib's, and the
predictor and the sample layout are numpy. tests/test_torch_tiff.py holds
both directions to cv2.

- ``read_tiff`` returns what cv2.imread(IMREAD_UNCHANGED) returns, in
  RGB(A) order, for the first image of a classic TIFF (little- or
  big-endian): strips or tiles, PlanarConfiguration 1 (chunky) or 2
  (planar), compression none (1), LZW (5), Deflate (8, 32946) or PackBits
  (32773), horizontal predictor 2 (which libtiff applies to LZW and
  Deflate only; with other compressions the tag is ignored, and so the
  differences come back as they are) and, on float samples, the
  floating-point predictor 3 (byte planes, most significant first, each
  row differenced byte by byte), gray (MinIsBlack or MinIsWhite), RGB, RGB
  with a fourth (extra) sample, and 8-bit palette; samples of 8, 16 or 32
  bits unsigned (SampleFormat 1), 8, 16 or 32 bits signed (2) and 32 or 64
  bits float (3), returned as uint8, uint16, uint32, int8, int16, int32,
  float32 or float64. OpenCV reads 8-bit images through libtiff's RGBA
  interface and deeper ones raw, and each path leaves its mark, kept here:
  8-bit MinIsWhite is inverted and deeper MinIsWhite is not; an 8-bit
  fourth sample marked unassociated alpha (ExtraSamples 2) premultiplies
  the colour, (v * a + 127) // 255, and any other fourth sample is kept as
  alpha beside the colour as stored; signed 8-bit samples take the same
  path as unsigned bytes and are then read as int8; a palette of 16-bit
  entries is scaled by >> 8 unless every entry is below 256. [H, W] (gray)
  or [H, W, 3 | 4].
- ``write_tiff`` writes as cv2.imwrite(".tif") does: little-endian, one
  strip, integer samples LZW with predictor 2, float samples uncompressed
  with no predictor, SampleFormat 1, 2 or 3, no ExtraSamples for a fourth
  channel; uint8, uint16, uint32, int8, int16, int32, float32 or float64
  gray, RGB or RGBA. The pixels read back equal in cv2 and in
  ``read_tiff``; the bytes are not libtiff's.

Still refused with NotImplementedError naming the file and the kind:
BigTIFF, JPEG-in-TIFF (compression 6 and 7) and other compressions, depths
other than 8, 16, 32 and 64 bits (and 64-bit integers, and 8-bit floats),
complex samples, CMYK, YCbCr (subsampled or not) and other photometric
interpretations, gray with alpha, 16-bit and signed palettes, planar
images deeper than 8 bits of more than one sample (OpenCV's raw path reads
their planes as interleaved samples), an Orientation other than 1 and
FillOrder 2. A half-float (16-bit SampleFormat 3) TIFF, which cv2.imread
returns None for, and malformed files raise ValueError naming the file.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from nerfpp_tpu_torch import native

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tiff_codec.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

# baseline and extension tags read here
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, ORIENTATION, SAMPLES = 266, 273, 274, 277
ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR = 278, 279, 284, 317
COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS = 320, 322, 323, 324
TILE_BYTES, EXTRA_SAMPLES, SAMPLE_FORMAT = 325, 338, 339

NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS = 1, 5, 8, 32946, 32773
COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3 fax",
                4: "CCITT Group 4 fax", 6: "JPEG-in-TIFF (old-style JPEG)",
                7: "JPEG-in-TIFF", 34712: "JPEG 2000-in-TIFF",
                34925: "LZMA", 50000: "Zstandard", 50001: "WebP-in-TIFF",
                34887: "LERC"}
PHOTOMETRICS = {4: "transparency mask", 5: "CMYK (separated)",
                6: "YCbCr", 8: "CIE L*a*b*", 9: "ICC L*a*b*",
                10: "ITU L*a*b*", 32844: "LogL", 32845: "LogLuv"}
# field type -> (struct code, size); rationals and floats are not needed
FIELD = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
         7: ("B", 1), 8: ("h", 2), 9: ("i", 4)}
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
    """The byte order and the integer fields of the first IFD."""
    head = data[:4]
    if head[:2] == b"II":
        bo = "<"
    elif head[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    (version,) = struct.unpack(bo + "H", head[2:4])
    if version == 43:
        raise NotImplementedError(f"{path}: a BigTIFF file is not read; "
                                  "classic TIFF is")
    if version != 42 or len(data) < 8:
        raise ValueError(f"{path}: not a TIFF file")
    (off,) = struct.unpack(bo + "I", data[4:8])
    if off + 2 > len(data):
        raise ValueError(f"{path}: the first IFD lies past the end")
    (n,) = struct.unpack(bo + "H", data[off:off + 2])
    if off + 2 + 12 * n > len(data):
        raise ValueError(f"{path}: truncated IFD")
    tags = {}
    for i in range(n):
        e = data[off + 2 + 12 * i:off + 14 + 12 * i]
        tag, typ, count = struct.unpack(bo + "HHI", e[:8])
        if typ not in FIELD:
            continue                        # rational, float: not needed
        code, size = FIELD[typ]
        nbytes = size * count
        if nbytes <= 4:
            raw = e[8:8 + nbytes]
        else:
            (at,) = struct.unpack(bo + "I", e[8:12])
            raw = data[at:at + nbytes]
            if len(raw) != nbytes:
                raise ValueError(f"{path}: field {tag} lies past the end")
        if typ == 2:
            tags[tag] = (raw,)
        else:
            tags[tag] = struct.unpack(f"{bo}{count}{code}", raw)
    return bo, tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def _refuse(path, kind: str):
    raise NotImplementedError(f"{path}: {kind} is not read; the port reads "
                              "8- and 16-bit gray, RGB(A) and 8-bit palette "
                              "TIFF, uncompressed, LZW, Deflate or PackBits")


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


def read_tiff(path) -> np.ndarray:
    """Decode the first image of a TIFF file to what cv2.imread(path,
    IMREAD_UNCHANGED) returns, in RGB(A) order (see the module
    docstring)."""
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
    if comp not in (NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS):
        _refuse(path, f"a {COMPRESSIONS.get(comp, f'compression {comp}')}"
                " TIFF")
    if photo in PHOTOMETRICS:
        _refuse(path, f"a {PHOTOMETRICS[photo]} TIFF")
    if photo not in (0, 1, 2, 3):
        _refuse(path, f"a TIFF of photometric interpretation {photo}")
    if len(set(bits)) != 1:
        _refuse(path, f"a TIFF of {'/'.join(map(str, bits))}-bit samples")
    bits = bits[0]
    if (fmt, bits) == (3, 16):
        raise ValueError(f"{path}: a half-float TIFF; cv2.imread returns no "
                         "image for it")
    if (fmt, bits) not in SAMPLE_TYPES:
        _refuse(path, f"a TIFF of {bits}-bit "
                f"{SAMPLE_FORMATS.get(fmt, f'format {fmt}')} samples")
    target = np.dtype(SAMPLE_TYPES[fmt, bits])
    if photo in (0, 1) and spp != 1:
        _refuse(path, f"a gray TIFF of {spp} samples (gray with alpha)")
    if photo == 2 and spp not in (3, 4):
        _refuse(path, f"an RGB TIFF of {spp} samples")
    if photo == 3 and (spp != 1 or bits != 8 or fmt != 1):
        _refuse(path, f"a {bits}-bit {SAMPLE_FORMATS[fmt]} palette TIFF")
    if bits > 8 and planar == 2 and spp > 1:
        _refuse(path, f"a {bits}-bit planar (PlanarConfiguration 2) TIFF of "
                f"{spp} samples (OpenCV reads its planes as interleaved "
                "samples)")
    if pred not in (1, 2, 3) or (pred == 3 and fmt != 3):
        _refuse(path, f"a TIFF of {SAMPLE_FORMATS[fmt]} samples with "
                f"predictor {pred}")
    if _one(tags, ORIENTATION, 1) != 1:
        _refuse(path, f"a TIFF of orientation {_one(tags, ORIENTATION)}")
    if _one(tags, FILL_ORDER, 1) != 1:
        _refuse(path, "a TIFF of fill order 2 (least significant bit "
                "first)")
    if planar not in (1, 2):
        raise ValueError(f"{path}: planar configuration {planar}")
    item = bits // 8
    # the samples as stored, as unsigned integers of their width
    dtype = np.dtype(f"{bo}u{item}")
    planes = 1 if planar == 1 else spp
    per = spp if planar == 1 else 1               # samples in a chunk
    tiled = TILE_OFFSETS in tags
    if tiled:
        tw, th = _one(tags, TILE_WIDTH), _one(tags, TILE_LENGTH)
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_BYTES)
        across, down = -(-w // tw), -(-h // th)
        boxes = [(ty * th, tx * tw, th, tw) for ty in range(down)
                 for tx in range(across)]
    else:
        rps = min(_one(tags, ROWS_PER_STRIP, h), h)
        offsets, counts = tags.get(STRIP_OFFSETS), tags.get(STRIP_BYTES)
        if offsets is None:
            raise ValueError(f"{path}: no strip offsets")
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    if len(offsets) < planes * len(boxes):
        raise ValueError(f"{path}: {len(offsets)} strips or tiles, "
                         f"{planes * len(boxes)} expected")
    out = np.zeros((planes, h, w, per), dtype)
    for i in range(planes * len(boxes)):
        p, j = divmod(i, len(boxes))
        y, x, rows, cols = boxes[j]
        size = rows * cols * per * item
        start = offsets[i]
        end = start + counts[i] if counts is not None else start + size
        chunk = _decompress(path, comp, data[start:end], size)
        if pred == 3 and comp in (LZW, DEFLATE, DEFLATE_OLD):
            a = _float_predictor(chunk, rows, cols, per, item)
        else:
            a = np.frombuffer(chunk, dtype).reshape(rows, cols, per)
        if pred == 2 and comp in (LZW, DEFLATE, DEFLATE_OLD):
            a = np.cumsum(a.astype(dtype.newbyteorder("=")), axis=1,
                          dtype=dtype.newbyteorder("="))
        rr, cc = min(rows, h - y), min(cols, w - x)
        out[p, y:y + rr, x:x + cc] = a[:rr, :cc]
    img = (out[0] if planar == 1 else out[..., 0].transpose(1, 2, 0))
    img = img.astype(dtype.newbyteorder("=")).view(
        np.uint8 if bits == 8 else target)
    if photo == 3:
        cmap = np.asarray(tags.get(COLORMAP, ()), np.int64)
        if cmap.size != 3 * 256:
            raise ValueError(f"{path}: a palette image without a 768-entry "
                             "ColorMap")
        cmap = cmap.reshape(3, 256)
        if cmap.max() >= 256:
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[img[..., 0]]
    if photo in (0, 1):
        img = img[..., 0]
        img = 255 - img if photo == 0 and bits == 8 else img
    elif spp == 4 and bits == 8 and _one(tags, EXTRA_SAMPLES) == 2:
        a = img[..., 3:].astype(np.int64)
        rgb = (img[..., :3].astype(np.int64) * a + 127) // 255
        img = np.concatenate([rgb, a], -1).astype(np.uint8)
    return img.view(target)


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
