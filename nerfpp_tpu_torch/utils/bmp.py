"""BMP reading and writing, as OpenCV 5.0's grfmt_bmp.cpp reads and writes
it (no image library).

The JAX package reads every view with ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes undistorted views with ``cv2.imwrite``
under the source's name. The machine with the card has no OpenCV, so the
port carries this codec: the headers, palettes and bit fields are numpy,
and RLE8 / RLE4 are host C++ (``csrc/image_rle.cpp``).
tests/test_torch_bmp.py holds both directions to cv2.

- ``read_bmp`` returns what cv2.imread(IMREAD_UNCHANGED) returns, in RGB(A)
  order, uint8 always:
  - headers: OS/2 (12 bytes) and INFO, V4 and V5 (40, 108, 124 bytes);
  - 1, 4 and 8 bits through a palette (the INFO header's ``clrused``
    entries of 4 bytes, or 2^bits; an index past them reads black), RLE8
    and RLE4 with deltas and an early end of bitmap (skipped pixels take
    the palette's first colour);
  - 16 bits as 5-5-5, or 5-6-5 through BITFIELDS masks (each field shifted
    to the top of its byte, no bit replication);
  - 24 bits, and 32 bits as BGR plus a fourth byte, which is alpha exactly
    when the compression is BITFIELDS; the R, G, B, A masks of a header of
    56 bytes or more then pick and scale each channel (f32(field) * f32(255
    / field maximum), truncated; alpha 255 without its mask; the bytes as
    they are when an R, G or B mask is 0);
  - bottom-up files (a positive height) and top-down ones (negative).

  OpenCV's marks are kept: a palette whose 2^bits entries are all gray
  gives one channel (the entries' values); an OS/2 file always gives one
  channel, each colour converted with OpenCV's fixed-point weights ((1868 B
  + 9617 G + 4899 R + 8192) >> 14); BITFIELDS masks are read after the
  header, so a V4 or V5 16-bit file with BITFIELDS reads only if its
  pixel data begins with the 5-5-5 or 5-6-5 masks. Where cv2.imread
  returns None (other compressions, depths or masks, data that ends
  early, an RLE run past its line) the port raises ValueError naming the
  file.
- ``write_bmp`` writes cv2.imwrite's bytes: gray as 8 bits with a 256-entry
  gray palette, RGB as 24 bits, both with a 40-byte header, RGBA as 32
  bits with a 124-byte V5 header (BITFIELDS, sRGB); bottom-up rows padded
  to 4 bytes. uint8 only, as cv2 writes 8-bit BMP.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from nerfpp_tpu_torch.utils.image_rle import bmp_rle_decode

RGB, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
COMPRESSIONS = {4: "JPEG", 5: "PNG", 6: "ALPHABITFIELDS"}
GRAY_WEIGHTS = (1868, 9617, 4899)      # B, G, R in 1/2^14: OpenCV's cB, cG, cR
MASKS_555 = (0x7C00, 0x3E0, 0x1F)      # R, G, B
MASKS_565 = (0xF800, 0x7E0, 0x1F)
V5_HEADER = 124


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u_C3C1R: uint8 [..., >= 3] BGR -> uint8."""
    b, g, r = (bgr[..., k].astype(np.int32) for k in range(3))
    wb, wg, wr = GRAY_WEIGHTS
    return ((b * wb + g * wg + r * wr + (1 << 13)) >> 14).astype(np.uint8)


def _refuse(path, why: str):
    raise ValueError(f"{path}: {why}; cv2.imread returns no image for it")


def _field(path, data: bytes, fmt: str, at: int):
    size = struct.calcsize(fmt)
    if at + size > len(data):
        _refuse(path, "a BMP header that ends early")
    return struct.unpack_from(fmt, data, at)


def read_bmp(path) -> np.ndarray:
    """Decode a BMP file to what cv2.imread(path, IMREAD_UNCHANGED) returns,
    in RGB(A) order (see the module docstring): uint8 [H, W] or [H, W, 3 |
    4]."""
    data = Path(path).read_bytes()
    offset, size = _field(path, data, "<ii", 10)
    if size <= 0:
        _refuse(path, f"a BMP header size of {size}")
    iscolor, rle, ok = False, RGB, False
    palette = np.zeros((256, 4), np.uint8)             # B, G, R, 0
    if size >= 36:
        w, h, bpp, rle = _field(path, data, "<iiii", 18)
        bpp >>= 16
        if not 0 <= rle <= BITFIELDS:
            _refuse(path, f"a BMP of compression {rle}"
                    + (f" ({COMPRESSIONS[rle]})" if rle in COMPRESSIONS
                       else ""))
        (clrused,) = _field(path, data, "<i", 46)
        pos = 14 + size
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and rle == RGB)
            or (bpp in (16, 32) and rle in (RGB, BITFIELDS))
            or (bpp == 4 and rle == RLE4) or (bpp == 8 and rle == RLE8))
        if ok:
            iscolor = True
            if bpp <= 8:
                if not 0 <= clrused <= 256:
                    _refuse(path, f"a palette of {clrused} entries")
                n = clrused or 1 << bpp
                _field(path, data, f"{4 * n}s", pos)
                palette[:n] = np.frombuffer(data, np.uint8, 4 * n,
                                            pos).reshape(n, 4)
                used = palette[:1 << bpp]
                iscolor = bool(np.any((used[:, 0] != used[:, 1])
                                      | (used[:, 0] != used[:, 2])))
            elif bpp == 16 and rle == BITFIELDS:
                masks = _field(path, data, "<III", pos)
                if masks == MASKS_555:
                    bpp = 15
                elif masks != MASKS_565:
                    ok = False
            elif bpp == 16:
                bpp = 15
    elif size == 12:
        w, h, bpp = _field(path, data, "<HHxxH", 18)
        ok = w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)
        if ok and bpp <= 8:
            n = 1 << bpp
            _field(path, data, f"{3 * n}s", 26)
            palette[:n, :3] = np.frombuffer(data, np.uint8, 3 * n,
                                            26).reshape(n, 3)
    if not ok:
        _refuse(path, "a BMP of this header, depth and compression")
    if offset < 0 or offset > len(data):
        _refuse(path, f"pixel data at {offset}, past the end")
    top_down = h < 0
    h = abs(h)
    channels = (1 if not iscolor else
                4 if bpp == 32 and rle != RGB else 3)
    bits = 16 if bpp == 15 else bpp
    pitch = ((w * bits + 7) // 8 + 3) & ~3
    if rle in (RLE8, RLE4):
        idx = bmp_rle_decode(path, data[offset:], 8 if rle == RLE8 else 4,
                             w, h)
    else:
        if offset + h * pitch > len(data):
            _refuse(path, "pixel data that ends early")
        rows = np.frombuffer(data, np.uint8, h * pitch, offset).reshape(
            h, pitch)
        if bpp == 1:
            idx = np.unpackbits(rows, axis=1)[:, :w]
        elif bpp == 4:
            idx = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        elif bpp == 8:
            idx = rows[:, :w]
    if bpp <= 8:
        img = palette[idx][..., :3] if iscolor else bgr_to_gray(palette)[idx]
    elif bpp in (15, 16):
        t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
        if bpp == 15:
            parts = (t << 3, (t >> 2) & 0xF8, (t >> 7) & 0xF8)
        else:
            parts = (t << 3, (t >> 3) & 0xFC, (t >> 8) & 0xF8)
        img = np.stack([p & 0xFF for p in parts], -1).astype(np.uint8)
    else:
        img = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
        if bpp == 32 and rle == BITFIELDS and size >= 56:
            img = _masked(img, _field(path, data, "<4I", 54))
        img = img[..., :channels] if iscolor else bgr_to_gray(img)
    if not top_down:
        img = img[::-1]
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[-1]]]
    return np.array(img)


def _masked(bgra: np.ndarray, masks) -> np.ndarray:
    """32-bit BITFIELDS pixels through the R, G, B, A masks of a header of
    56 bytes or more, as OpenCV reads them: each field scaled to 0-255 as
    f32(field) * f32(255 / its mask's largest field value), truncated;
    alpha 255 without an alpha mask; with an R, G or B mask of 0 the bytes
    are taken as B, G, R, A."""
    if not all(masks[:3]):
        return bgra
    v = np.ascontiguousarray(bgra).view("<u4")[..., 0].astype(np.int64)
    out = []
    for m in (masks[2], masks[1], masks[0], masks[3]):   # B, G, R, A
        if m == 0:
            out.append(np.full(v.shape, 255, np.int64))
            continue
        shift = (m & -m).bit_length() - 1
        scale = np.float32(255.0 / (m >> shift))
        field = ((v & m) >> shift).astype(np.float32)
        out.append((field * scale).astype(np.int64))
    return np.stack(out, -1).astype(np.uint8)


def write_bmp(path, image: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, 3 | 4] (RGB(A) order) image as
    cv2.imwrite(".bmp") writes it."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: BMP writing takes uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[-1]]]
    elif img.ndim != 2:
        raise ValueError(f"{path}: image shape {image.shape} is not [H, W] "
                         "or [H, W, 1 | 3 | 4]")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    step = (w * ch + 3) & ~3
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * ch] = img[::-1].reshape(h, -1)
    if ch == 4:
        info = struct.pack("<IiiHHIIiiII", V5_HEADER, w, h, 1, 32,
                           BITFIELDS, 0, 0, 0, 0, 0)
        info += struct.pack("<IIII4s", 0x00FF0000, 0x0000FF00, 0x000000FF,
                            0xFF000000, b"BGRs")
        info = info.ljust(V5_HEADER, b"\0")
        extra = b""
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8 * ch, RGB, 0, 0,
                           0, 0, 0)
        extra = (np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
                 * np.array([1, 1, 1, 0], np.uint8)).tobytes() if ch == 1 \
            else b""
    offset = 14 + len(info) + len(extra)
    Path(path).write_bytes(b"BM" + struct.pack("<IHHI", offset + rows.size,
                                               0, 0, offset)
                           + info + extra + rows.tobytes())
