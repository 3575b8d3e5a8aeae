"""Radiance HDR (RGBE) reading and writing, as OpenCV 5.0's grfmt_hdr.cpp
and rgbe.cpp read and write it (no image library).
tests/test_torch_hdr.py holds both directions to cv2.

- ``read_hdr``: the header is read as rgbe.cpp reads it, in lines of at
  most 127 bytes (fgets into 128): it must hold the line
  ``FORMAT=32-bit_rle_rgbe`` before the first empty line, and the line
  after that must begin ``-Y <height> +X <width>`` (sscanf's rules: any
  white space between the parts, a signed number each; no other
  orientation is read). The pixels are flat or run-length coded
  (``csrc/image_rle.cpp``), and each RGBE quadruple becomes m *
  f32(2^(e - 136)) per channel (0 where e = 0; exact in f32, so the
  device's multiply gives cv2's values): float32 [H, W, 3], RGB order,
  on the requested device. Where cv2.imread returns None (no FORMAT line,
  a bad size line, bad or short run-length data) the port raises
  ValueError naming the file.
- ``write_hdr`` writes cv2.imwrite(".hdr")'s bytes for a float32 [H, W]
  (repeated to RGB, as cv2 merges it) or [H, W, 3] image: the header
  ``#?RADIANCE``, ``FORMAT=32-bit_rle_rgbe``, an empty line and ``-Y h +X
  w``, then each row run-length coded (flat when the width is below 8 or
  above 32767); each pixel as rgbe.cpp's float2rgbe: v the largest channel
  (zero RGBE below 1e-32), m, e = frexp(v), each channel times f32(m * 256
  / v) truncated to a byte, e + 128.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.utils.image_rle import hdr_decode, hdr_encode

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
FORMAT_LINE = b"FORMAT=32-bit_rle_rgbe\n"
SIZE_LINE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")
LINE = 127                           # fgets into a buffer of 128 bytes


def _refuse(path, why: str):
    raise ValueError(f"{path}: {why}; cv2.imread returns no image for it")


def _header(path, data: bytes):
    """(height, width, offset of the pixels), as rgbe.cpp's
    RGBE_ReadHeader reads them."""
    pos = 0

    def fgets() -> bytes:
        nonlocal pos
        if pos >= len(data):
            _refuse(path, "an HDR header that ends early")
        end = data.find(b"\n", pos, pos + LINE)
        end = min(pos + LINE, len(data)) if end < 0 else end + 1
        line, pos = data[pos:end], end
        return line.split(b"\0")[0]

    found = False
    while True:
        line = fgets()
        if line[:1] in (b"", b"\n"):
            if not found:
                _refuse(path, "an HDR header without FORMAT=32-bit_rle_rgbe")
            break
        found = found or line == FORMAT_LINE
    m = SIZE_LINE.match(fgets())
    if m is None:
        _refuse(path, "an HDR file without a '-Y <height> +X <width>' line")
    h, w = int(m.group(1)), int(m.group(2))
    if h <= 0 or w <= 0:
        _refuse(path, f"a {w} x {h} HDR image")
    return h, w, pos


def rgbe_scale() -> np.ndarray:
    """f32(2^(e - 136)) for each exponent byte e, 0 for e = 0."""
    e = np.arange(256)
    return np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)


def read_hdr(path, device="cuda") -> torch.Tensor:
    """Decode a Radiance HDR file to what cv2.imread(path,
    IMREAD_UNCHANGED) returns, in RGB order: float32 [H, W, 3] on
    ``device``."""
    data = Path(path).read_bytes()
    h, w, pos = _header(path, data)
    dev = resolve_device(device)
    rgbe = torch.from_numpy(hdr_decode(path, data[pos:], w, h)).to(dev)
    scale = torch.from_numpy(rgbe_scale()).to(dev)
    return rgbe[..., :3].float() * scale[rgbe[..., 3].long()][..., None]


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """rgbe.cpp's float2rgbe: float32 [..., 3] RGB -> uint8 [..., 4]."""
    r, g, b = (img[..., k].astype(np.float32) for k in range(3))
    v = np.where(g > r, g, r)
    v = np.where(b > v, b, v).astype(np.float64)
    with np.errstate(all="ignore"):
        m, e = np.frexp(v)
        scale = (m * 256.0 / v).astype(np.float32)
        out = []
        for c in (r, g, b):
            x = c * scale
            ok = np.isfinite(x) & (np.abs(x) < 2.0 ** 31)
            out.append(np.where(ok, np.trunc(np.where(ok, x, 0)),
                                -2.0 ** 31).astype(np.int64))
    out.append(e.astype(np.int64) + 128)
    rgbe = (np.stack(out, -1) & 0xFF).astype(np.uint8)
    rgbe[v < 1e-32] = 0
    return rgbe


def write_hdr(path, image: np.ndarray) -> None:
    """Write a float32 [H, W] or [H, W, 3] (RGB) image as
    cv2.imwrite(".hdr") writes it."""
    img = np.asarray(image)
    if img.dtype != np.float32:
        raise ValueError(f"{path}: HDR writing takes float32, not "
                         f"{img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"{path}: HDR takes [H, W] or [H, W, 3], not "
                         f"{image.shape}")
    h, w = img.shape[:2]
    rgbe = float_to_rgbe(img)
    body = hdr_encode(rgbe) if 8 <= w <= 0x7FFF else rgbe.tobytes()
    Path(path).write_bytes(b"#?RADIANCE\n" + FORMAT_LINE
                           + f"\n-Y {h} +X {w}\n".encode() + body)
