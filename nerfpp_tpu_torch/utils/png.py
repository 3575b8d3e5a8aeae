"""PNG reading and writing with zlib, struct and numpy (no image library).

The JAX package reads and writes its images through OpenCV, whose PNG
codec is libpng; the port keeps to torch, numpy and the standard library,
so it carries this codec instead.

- ``read_png``: every PNG that libpng hands to OpenCV, returned as
  ``cv2.imread(path, IMREAD_UNCHANGED)`` returns it (in RGB(A) order):
  colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
  (RGBA) at every bit depth the format allows (1, 2, 4, 8, 16), PLTE with
  tRNS, the tRNS key colour, Adam7 interlacing and all five row filters.
  What OpenCV does with each (tests/test_torch_png_kinds.py holds the
  reader to cv2): gray stays one channel, its low depths scaled to 8 bits
  (x 255, 85, 17) and its tRNS key ignored; gray + alpha becomes four
  channels (g, g, g, a); RGB and palette images are three channels, four
  with a tRNS chunk (alpha 0 at the key colour, the maximum elsewhere; a
  palette entry past the end of tRNS is opaque); 16-bit files come back as
  uint16, everything else as uint8. Rows filtered with Sub, Average or
  Paeth depend on their left neighbour, so they are undone along
  anti-diagonals: unit (r, c) depends only on (r, c - 1), (r - 1, c) and
  (r - 1, c - 1), all on earlier diagonals, and each diagonal is one
  vectorised step. A file of another kind raises NotImplementedError
  naming the file and the kind; a malformed one raises ValueError.
- ``write_png``: uint8 or uint16 gray, RGB or RGBA (as cv2.imwrite writes
  8- and 16-bit images: the same pixels, not the same bytes), every row
  with filter 0 (none), one zlib stream.

Arrays are [H, W] (gray) or [H, W, C] in RGB(A) order.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILE_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
COLOUR_TYPE = {1: 0, 3: 2, 4: 6}                  # channels written -> type
# Adam7 passes: first column, first row, column step, row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


@dataclass
class Header:
    height: int
    width: int
    depth: int
    ctype: int
    interlace: int


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray, level: int = 6) -> None:
    """Write a uint8 or uint16 [H, W] or [H, W, C] (C in 1, 3, 4) image,
    RGB(A) order; 16-bit samples big-endian, as PNG stores them."""
    img = np.asarray(image)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: PNG writing takes uint8 or uint16, not "
                         f"{img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in COLOUR_TYPE:
        raise ValueError(f"{path}: image shape {image.shape} is not [H, W] "
                         "or [H, W, 1 | 3 | 4]")
    h, w, c = img.shape
    depth = 8 * img.itemsize
    data = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = np.zeros((h, 1 + w * c * img.itemsize), np.uint8)  # filter 0
    rows[:, 1:] = data.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, COLOUR_TYPE[c], 0, 0, 0)
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
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated chunk")
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _header(path, payload: bytes) -> Header:
    if len(payload) != 13:
        raise ValueError(f"{path}: bad IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              payload)
    if ctype not in DEPTHS or depth not in DEPTHS[ctype]:
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} "
                         "is not a PNG")
    if comp != 0 or filt != 0 or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"{path}: bad IHDR (compression {comp}, filter "
                         f"{filt}, interlace {interlace}, size {w}x{h})")
    return Header(h, w, depth, ctype, interlace)


def _channels(hdr: Header, trns: bool) -> int:
    """The channels cv2.imread(IMREAD_UNCHANGED) returns."""
    if hdr.ctype in (2, 3):
        return 4 if trns else 3
    return 1 if hdr.ctype == 0 else 4


def _parse(path, data: bytes, stop_at_idat: bool = False):
    """The header, PLTE, tRNS and the concatenated IDAT payloads."""
    hdr, plte, trns, idat = None, None, None, []
    for kind, payload in _chunks(path, data):
        if kind == b"IHDR":
            hdr = _header(path, payload)
        elif kind == b"PLTE":
            plte = payload
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            if stop_at_idat:
                break
            idat.append(payload)
        elif kind[0] & 0x20 == 0 and kind not in (b"IEND",):
            raise NotImplementedError(f"{path}: a PNG with the critical "
                                      f"chunk {kind.decode('latin-1')!r} is "
                                      "not read")
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    return hdr, plte, trns, b"".join(idat)


def png_shape(path) -> tuple:
    """(H, W, C) as read_png returns the image, from the chunks before the
    image data."""
    hdr, _, trns, _ = _parse(path, Path(path).read_bytes(), True)
    return hdr.height, hdr.width, _channels(hdr, trns is not None)


def _unfilter(path, raw: np.ndarray, h: int, units: int, bpp: int
              ) -> np.ndarray:
    """Undo the row filters of ``raw`` ([H, 1 + units * bpp] uint8): the
    filtered bytes [H, units, bpp], the left neighbour of a byte being the
    byte ``bpp`` before it."""
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(kinds.max())}")
    filt = raw[:, 1:].reshape(h, units, bpp)
    if not kinds.any():
        return filt.copy()
    # rec[r + 1, c + 1] is unit (r, c); row 0 and column 0 are the zeros
    # the filters see beyond the image
    rec = np.zeros((h + 1, units + 1, bpp), np.int16)
    kinds = kinds.astype(np.int16)
    filt = filt.astype(np.int16)
    for d in range(h + units - 1):
        r = np.arange(max(0, d - units + 1), min(h, d + 1))
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


def _samples(rows: np.ndarray, width: int, ch: int, depth: int
             ) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] -> samples [h, width, ch] (uint8, or
    uint16 at 16 bits; below 8 bits the packed values, first the high
    bits)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1).view(">u2").astype(np.uint16).reshape(
            h, width, ch)
    if depth == 8:
        return rows.reshape(h, width, ch)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width * ch].reshape(h, width, ch)


def _decode_samples(path, hdr: Header, raw: np.ndarray) -> np.ndarray:
    """The file's samples [H, W, channels in the file], every pass of an
    interlaced file put in place."""
    ch = FILE_CHANNELS[hdr.ctype]
    bits = hdr.depth * ch
    bpp = max(1, bits // 8)
    passes = (ADAM7 if hdr.interlace else ((0, 0, 1, 1),))
    dtype = np.uint16 if hdr.depth == 16 else np.uint8
    out = np.zeros((hdr.height, hdr.width, ch), dtype)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw = max(0, -(-(hdr.width - x0) // dx))
        ph = max(0, -(-(hdr.height - y0) // dy))
        if pw == 0 or ph == 0:
            continue                   # an empty pass has no bytes at all
        rowbytes = -(-pw * bits // 8)
        n = ph * (1 + rowbytes)
        if pos + n > raw.size:
            raise ValueError(f"{path}: {raw.size} bytes of image data, too "
                             "few for its size")
        part = raw[pos:pos + n].reshape(ph, 1 + rowbytes)
        pos += n
        rows = _unfilter(path, part, ph, rowbytes // bpp, bpp)
        out[y0::dy, x0::dx] = _samples(rows.reshape(ph, rowbytes), pw, ch,
                                       hdr.depth)
    if pos != raw.size:
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{pos}")
    return out


def read_png(path) -> np.ndarray:
    """Decode to what cv2.imread(path, IMREAD_UNCHANGED) returns, in RGB(A)
    order: [H, W] gray or [H, W, 3 | 4], uint16 for a 16-bit file, else
    uint8 (see the module docstring for each kind)."""
    hdr, plte, trns, idat = _parse(path, Path(path).read_bytes())
    if not idat:
        raise ValueError(f"{path}: no IDAT chunk")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    s = _decode_samples(path, hdr, raw)
    top = (1 << hdr.depth) - 1
    if hdr.ctype == 0:
        if hdr.depth < 8:
            s = (s.astype(np.uint16) * (255 // top)).astype(np.uint8)
        return s[..., 0]
    if hdr.ctype == 4:
        return s[..., [0, 0, 0, 1]]
    if hdr.ctype == 6:
        return s
    full = np.iinfo(s.dtype).max
    if hdr.ctype == 3:
        if plte is None or len(plte) % 3 or len(plte) == 0:
            raise ValueError(f"{path}: a palette image without a valid PLTE "
                             "chunk")
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        idx = s[..., 0].astype(np.int64)
        if idx.max(initial=0) >= len(pal):
            raise ValueError(f"{path}: palette index {int(idx.max())} past "
                             f"the {len(pal)} PLTE entries")
        rgb = pal[idx]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    if trns is None:                                     # RGB
        return s
    if len(trns) != 6:
        raise ValueError(f"{path}: a tRNS chunk of {len(trns)} bytes in an "
                         "RGB image")
    key = np.frombuffer(trns, ">u2").astype(np.int64)
    hit = np.all(s.astype(np.int64) == key, -1)
    alpha = np.where(hit, 0, full).astype(s.dtype)
    return np.concatenate([s, alpha[..., None]], -1)
