"""PNG reading and writing with zlib, struct and numpy (no image library).

The JAX package reads and writes its images through OpenCV; the port keeps
to torch, numpy and the standard library, so it carries this codec instead.

- ``write_png``: 8-bit gray, RGB or RGBA, every row with filter 0 (none),
  one zlib stream.
- ``read_png``: 8-bit gray, RGB or RGBA, not interlaced, with any of the
  five row filters (what encoders such as OpenCV's write). Rows filtered
  with Sub, Average or Paeth depend on their left neighbour, so they are
  undone along anti-diagonals: pixel (r, c) depends only on (r, c - 1),
  (r - 1, c) and (r - 1, c - 1), all on earlier diagonals, and each
  diagonal is one vectorised step. Everything else (other bit depths,
  palettes, gray with alpha, interlacing) raises with the file's name.

Arrays are [H, W] (gray) or [H, W, C] uint8 in RGB(A) order.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}        # colour type -> channels read / written
COLOUR_TYPE = {v: k for k, v in CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray, level: int = 6) -> None:
    """Write a uint8 [H, W] or [H, W, C] (C in 1, 3, 4) image."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: PNG writing takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in COLOUR_TYPE:
        raise ValueError(f"{path}: image shape {image.shape} is not [H, W] "
                         "or [H, W, 1 | 3 | 4]")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)      # filter byte 0: none
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOUR_TYPE[c], 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + _chunk(b"IHDR", ihdr)
                           + _chunk(b"IDAT", zlib.compress(rows.tobytes(),
                                                           level))
                           + _chunk(b"IEND", b""))


def _chunks(path, data: bytes):
    """(kind, payload) of every chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _header(path, payload: bytes):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              payload)
    if (depth != 8 or ctype not in CHANNELS or comp != 0 or filt != 0
            or interlace != 0):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace}); "
                         "8-bit gray, RGB or RGBA without interlacing is "
                         "read")
    return h, w, CHANNELS[ctype]


def png_shape(path) -> tuple:
    """(H, W, C) from the header alone."""
    with open(path, "rb") as f:
        data = f.read(33)                          # signature + IHDR chunk
    kind, payload = next(_chunks(path, data))
    if kind != b"IHDR":
        raise ValueError(f"{path}: the first chunk is not IHDR")
    return _header(path, payload)


def _unfilter(path, raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the row filters of ``raw`` ([H, 1 + W * C] uint8)."""
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(kinds.max())}")
    filt = raw[:, 1:].reshape(h, w, c)
    if not kinds.any():
        return filt.copy()
    # rec[r + 1, c + 1] is pixel (r, c); row 0 and column 0 are the zeros
    # the filters see beyond the image
    rec = np.zeros((h + 1, w + 1, c), np.int16)
    kinds = kinds.astype(np.int16)
    filt = filt.astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        col = d - r
        a = rec[r + 1, col]                        # left
        b = rec[r, col + 1]                        # up
        cc = rec[r, col]                           # up-left
        k = kinds[r][:, None]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, col + 1] = (filt[r, col] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode to uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)."""
    data = Path(path).read_bytes()
    shape, idat = None, []
    for kind, payload in _chunks(path, data):
        if kind == b"IHDR":
            shape = _header(path, payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if shape is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    h, w, c = shape
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (1 + w * c)}")
    img = _unfilter(path, raw.reshape(h, 1 + w * c), h, w, c)
    return img[..., 0] if c == 1 else img
