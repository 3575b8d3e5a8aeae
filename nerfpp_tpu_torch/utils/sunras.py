"""Sun raster reading and writing, as OpenCV 5.0's grfmt_sunras.cpp reads
and writes it (numpy; no image library). tests/test_torch_sunras.py holds
both directions to cv2.

- ``read_sunras``: the 32-byte big-endian header (magic, width, height,
  depth, length, type, map type, map length), an RMT_EQUAL_RGB colour map
  (its R, G and B planes, at most 2^depth entries; entries past it read
  black) or none, then rows padded to an even byte count. cv2 5.0 reads
  types 0 (old) and 1 (standard) at 1, 8, 24 and 32 bits and returns None
  for every other type, byte-encoded (run-length) files included, so the
  port raises ValueError for them, naming the file. OpenCV's marks are
  kept: 24-bit pixels are stored B, G, R; 32-bit ones X, B, G, R (three
  channels come back); a 1- or 8-bit file with a colour map gives three
  channels unless every entry is gray, then one (OpenCV's fixed-point gray
  of each entry); a 1- or 8-bit file without a colour map reads as zeros,
  because OpenCV looks such pixels up in a gray table it leaves empty.
  uint8 [H, W] or [H, W, 3] in RGB order.
- ``write_sunras`` writes cv2.imwrite's bytes: type 1, no colour map, 8
  bits a channel (gray 8, BGR 24, BGRA 32), rows of the image's bytes
  padded to even length. OpenCV pads a row of odd length with the next
  row's first byte, and the last row with the byte past its image's end in
  memory; the port writes the next row's first byte and, for the last row,
  0.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from nerfpp_tpu_torch.utils.bmp import bgr_to_gray

MAGIC = b"\x59\xa6\x6a\x95"
TYPES = {0: "old", 1: "standard", 2: "byte-encoded (run-length)",
         3: "RGB", 4: "TIFF", 5: "IFF"}
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def _refuse(path, why: str):
    raise ValueError(f"{path}: {why}; cv2.imread returns no image for it")


def read_sunras(path) -> np.ndarray:
    """Decode a Sun raster file to what cv2.imread(path, IMREAD_UNCHANGED)
    returns, in RGB order: uint8 [H, W] or [H, W, 3]."""
    data = Path(path).read_bytes()
    if len(data) < 32 or data[:4] != MAGIC:
        _refuse(path, "not a Sun raster file")
    w, h, bpp, _, typ, maptype, maplength = struct.unpack(">7i", data[4:32])
    palsize = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32)):
        _refuse(path, f"a {w} x {h} Sun raster of depth {bpp}")
    if typ not in (0, 1):
        _refuse(path, f"a Sun raster of type {typ} "
                f"({TYPES.get(typ, 'unknown')})")
    if not ((maptype == RMT_NONE and maplength == 0) or (
            maptype == RMT_EQUAL_RGB and 0 < maplength <= palsize)):
        _refuse(path, f"a Sun raster colour map of type {maptype} and "
                f"{maplength} bytes at depth {bpp}")
    palette = np.zeros((256, 3), np.uint8)             # B, G, R
    if maplength:
        if 32 + maplength > len(data):
            _refuse(path, "a colour map that ends early")
        n = maplength // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette[:n] = cmap[::-1].T
        used = palette[:1 << bpp]
        color = bool(np.any((used[:, 0] != used[:, 1])
                            | (used[:, 0] != used[:, 2])))
    else:
        color = bpp > 8
    offset = 32 + maplength
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    if offset + h * pitch > len(data):
        _refuse(path, "pixel data that ends early")
    rows = np.frombuffer(data, np.uint8, h * pitch, offset).reshape(h, pitch)
    if bpp == 24:
        return np.array(rows[:, :3 * w].reshape(h, w, 3)[..., ::-1])
    if bpp == 32:
        return np.array(rows[:, :4 * w].reshape(h, w, 4)[..., :0:-1])
    idx = np.unpackbits(rows, axis=1)[:, :w] if bpp == 1 else rows[:, :w]
    if color:
        return np.array(palette[idx][..., ::-1])
    gray = (bgr_to_gray(palette) if maptype == RMT_EQUAL_RGB
            else np.zeros(256, np.uint8))
    return gray[idx]


def write_sunras(path, image: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, 3 | 4] (RGB(A)) image as
    cv2.imwrite(".ras") writes it."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: Sun raster writing takes uint8, not "
                         f"{img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[-1]]]
    elif img.ndim != 2:
        raise ValueError(f"{path}: image shape {image.shape} is not [H, W] "
                         "or [H, W, 1 | 3 | 4]")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    flat = np.concatenate([img.reshape(-1), np.zeros(1, np.uint8)])
    step = (w * ch + 1) & ~1
    rows = np.stack([flat[y * w * ch:y * w * ch + step] for y in range(h)])
    Path(path).write_bytes(MAGIC + struct.pack(">7I", w, h, 8 * ch, step * h,
                                               1, RMT_NONE, 0)
                           + rows.tobytes())
