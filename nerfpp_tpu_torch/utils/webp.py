"""WebP reading and writing, as OpenCV's libwebp reads and writes them (no
image library).

The JAX package reads every view with ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes undistorted views with ``cv2.imwrite``; web
photo collections and phone exports are often WebP. The machine with the
card has no OpenCV, so the port carries this codec: the entropy decoding,
prediction, inverse transforms and loop filter of lossy VP8 (RFC 6386), the
lossless VP8L decoder (RFC 9649), the ALPH chunk and a VP8L encoder are host
C++ (``csrc/webp_codec.cpp``, built with g++ at first use by
``native.build_library``; no g++ raises, and there is no Python fallback);
the chroma upsampling, the YUV -> RGB conversion and the interleaving of
alpha are integer PyTorch on the device, bitwise the same on the card and
the CPU. tests/test_torch_webp.py and tests/test_torch_webp_lossless.py hold
both directions to cv2.

- ``read_webp`` returns what cv2.imread(IMREAD_UNCHANGED) returns, in
  RGB(A) order: a simple lossy (``VP8 ``) or lossless (``VP8L``) file, or
  an extended one (``VP8X``) with an ``ALPH`` chunk beside a lossy image;
  ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks are skipped, as libwebp
  skips them. Like OpenCV, it takes the channel count from the first 32
  bytes (libwebp's WebPGetFeatures on them): 4 channels when the VP8X
  header's alpha flag, or a simple VP8L header's alpha bit, is set, else 3,
  and then decodes as WebPDecodeBGRInto or WebPDecodeBGRAInto do at their
  defaults: the "fancy" upsampler (libwebp's 9-3-3-1 filter of the two
  nearest chroma rows and columns, the edge rows and columns taking the
  nearest sample at 3:1), libwebp's 14-bit fixed-point YUV -> RGB, alpha
  neither premultiplied nor dithered (a lossy image without ALPH reads 255
  there). uint8 [H, W, 3 | 4]. A frame whose dequantised coefficients
  pass the 12-bit range that encoders keep to is decoded as libwebp's C
  code decodes it; its SIMD transforms, which cv2 runs, wrap at 16 bits
  there and may differ.
- ``write_webp`` writes as cv2.imwrite(".webp") does with no parameters:
  lossless VP8L; gray as 3 channels; 4 channels with the alpha bit set only
  when some alpha is below 255 (cv2 reads an opaque RGBA file back as 3
  channels); other dtypes converted to uint8 as OpenCV's convertTo does
  (saturated; floats rounded half to even, NaN, infinities and magnitudes
  of 2^31 and more to 0; bool as 0 and 1). The pixels read back equal in
  cv2 and in ``read_webp``; the bytes are not libwebp's (subtract-green and
  predictor transforms, or a palette of up to 256 colours, then LZ77 and
  prefix codes).

Refused with NotImplementedError naming the file and the kind: an animated
WebP (cv2.imread returns the first frame composited on its canvas) and, in
``write_webp``, an RGBA image with fully transparent pixels (libwebp
rewrites the colour under alpha 0 as its encoder's predictors choose, which
the port does not reproduce). Files cv2.imread returns None for (shorter
than 32 bytes, a broken bitstream, a frame that disagrees with its VP8X
canvas) raise ValueError naming the file.
"""
from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import native, resolve_device

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "webp_codec.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
ERRORS = {-1: "a bitstream error", -2: "data that ends too soon",
          -3: "no room for the output"}
HEADER_BYTES = 32        # what OpenCV hands WebPGetFeatures
MAX_SIDE = 16383         # WEBP_MAX_DIMENSION
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02

_lib = None


def codec_library() -> ctypes.CDLL:
    """The WebP codec, built with g++ on first use (raises without it)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX_FLAGS)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64, i32 = ctypes.c_int64, ctypes.c_int
        lib.webp_vp8_decode.restype = i64
        lib.webp_vp8_decode.argtypes = [u8p, i64, i32, i32, u8p, u8p, u8p]
        lib.webp_vp8l_decode.restype = i64
        lib.webp_vp8l_decode.argtypes = [u8p, i64, i32, i32, u32p]
        lib.webp_alpha_decode.restype = i64
        lib.webp_alpha_decode.argtypes = [u8p, i64, i32, i32, u8p]
        lib.webp_vp8l_encode.restype = i64
        lib.webp_vp8l_encode.argtypes = [u32p, i32, i32, i32, u8p, i64]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check(path, n: int) -> None:
    if n < 0:
        raise ValueError(f"{path}: {ERRORS.get(n, f'error {n}')} in the "
                         "WebP data; cv2.imread returns no image for it")


# ------------------------------------------------------------- container

class Parsed(NamedTuple):
    """A WebP file's image: ``kind`` "VP8" or "VP8L", its payload, the ALPH
    payload (or None), the frame size and the channel count cv2 takes."""
    kind: str
    payload: bytes
    alpha: Optional[bytes]
    width: int
    height: int
    channels: int


def _bad(path, why: str):
    return ValueError(f"{path}: {why}; cv2.imread returns no image for it")


def vp8_size(path, data: bytes) -> Tuple[int, int]:
    """(width, height) of a VP8 key frame, checked as libwebp's
    VP8GetInfo checks it."""
    if len(data) < 10:
        raise _bad(path, "a VP8 frame header cut short")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if (bits & 1) or ((bits >> 1) & 7) > 3 or not ((bits >> 4) & 1) \
            or (bits >> 5) >= len(data) or data[3:6] != b"\x9d\x01\x2a":
        raise _bad(path, "not a displayable VP8 key frame")
    w = struct.unpack_from("<H", data, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", data, 8)[0] & 0x3FFF
    if w == 0 or h == 0:
        raise _bad(path, "a VP8 frame of no pixels")
    return w, h


def vp8l_header(path, data: bytes) -> Tuple[int, int, int]:
    """(width, height, alpha bit) of a VP8L stream (libwebp's
    VP8LGetInfo)."""
    if len(data) < 5 or data[0] != 0x2F:
        raise _bad(path, "not a VP8L stream")
    bits = int.from_bytes(data[1:5], "little")
    if bits >> 29:
        raise _bad(path, f"VP8L version {bits >> 29}")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _chunks(path, data: bytes, start: int, end: int):
    """(tag, payload offset, payload size) of the chunks from ``start``."""
    pos = start
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size > end:
            raise _bad(path, f"a {tag.decode('latin-1')!r} chunk past the "
                       "end of the file")
        yield tag, pos + 8, size
        pos += 8 + size + (size & 1)


def parse(path, data: bytes) -> Parsed:
    """The image of a WebP file, as libwebp's WebPDecode finds it, with the
    channel count OpenCV takes from its first 32 bytes."""
    if len(data) < HEADER_BYTES:
        raise _bad(path, f"{len(data)} bytes (OpenCV needs {HEADER_BYTES})")
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise _bad(path, "no RIFF WEBP header")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 12 or riff > len(data) - 8:
        raise _bad(path, f"RIFF size {riff} of a {len(data)}-byte file")
    end = riff + 8
    tag = data[12:16]
    alpha = None
    if tag == b"VP8X":
        size = struct.unpack_from("<I", data, 16)[0]
        if size != 10:
            raise _bad(path, f"a VP8X chunk of {size} bytes")
        flags = data[20]
        cw = int.from_bytes(data[24:27], "little") + 1
        ch = int.from_bytes(data[27:30], "little") + 1
        if flags & ANIMATION_FLAG:
            raise NotImplementedError(
                f"{path}: an animated WebP (ANIM / ANMF frames; cv2.imread "
                "returns the first frame composited on its canvas), which "
                "the port does not read")
        channels = 4 if flags & ALPHA_FLAG else 3
        image = None
        for t, off, size in _chunks(path, data, 30, end):
            if t == b"ALPH":
                alpha = data[off:off + size]
            elif t in (b"VP8 ", b"VP8L"):
                image = (t, off, size)
                break
        if image is None:
            raise _bad(path, "a VP8X file without an image chunk")
        t, off, size = image
        payload = data[off:off + size]
        if t == b"VP8 ":
            w, h = vp8_size(path, payload)
        else:
            w, h, _ = vp8l_header(path, payload)
        if (w, h) != (cw, ch):
            raise _bad(path, f"a {w}x{h} frame on a {cw}x{ch} canvas")
        return Parsed(t.decode().strip(), payload, alpha, w, h, channels)
    if tag not in (b"VP8 ", b"VP8L"):
        raise _bad(path, f"a {tag.decode('latin-1')!r} chunk where VP8, VP8L "
                   "or VP8X belongs")
    t, off, size = next(_chunks(path, data, 12, end))
    payload = data[off:off + size]
    if t == b"VP8 ":
        w, h = vp8_size(path, payload)
        return Parsed("VP8", payload, None, w, h, 3)
    w, h, a = vp8l_header(path, payload)
    return Parsed("VP8L", payload, None, w, h, 4 if a else 3)


# ----------------------------------------------------------- host stages

def decode_planes(parsed: Parsed, path="<bytes>") -> Dict[str, np.ndarray]:
    """The host part of a decode: for VP8, the Y [h, w], U and V [(h + 1)
    // 2, (w + 1) // 2] planes (and "alpha" [h, w] when the file has 4
    channels); for VP8L, the image itself, "rgb" [h, w, 3 | 4] in RGB(A)
    order."""
    lib = codec_library()
    w, h = parsed.width, parsed.height
    src = np.frombuffer(parsed.payload, np.uint8)
    if parsed.kind == "VP8L":
        argb = np.empty((h, w), np.uint32)
        _check(path, lib.webp_vp8l_decode(_ptr(src[5:], ctypes.c_uint8),
                                          src.size - 5, w, h,
                                          _ptr(argb, ctypes.c_uint32)))
        bgra = argb.view(np.uint8).reshape(h, w, 4)     # little-endian ARGB
        order = [2, 1, 0, 3][:parsed.channels]
        return {"rgb": np.ascontiguousarray(bgra[..., order])}
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    _check(path, lib.webp_vp8_decode(_ptr(src, ctypes.c_uint8), src.size,
                                     w, h, _ptr(y, ctypes.c_uint8),
                                     _ptr(u, ctypes.c_uint8),
                                     _ptr(v, ctypes.c_uint8)))
    out = {"y": y, "u": u, "v": v}
    if parsed.channels == 4:
        alpha = np.full((h, w), 255, np.uint8)
        if parsed.alpha is not None:
            a = np.frombuffer(parsed.alpha, np.uint8)
            _check(path, lib.webp_alpha_decode(_ptr(a, ctypes.c_uint8),
                                               a.size, w, h,
                                               _ptr(alpha, ctypes.c_uint8)))
        out["alpha"] = alpha
    return out


# ---------------------------------------------------------- device stage

def _clip8(x: torch.Tensor) -> torch.Tensor:
    """libwebp's VP8Clip8: 14-bit fixed point -> [0, 255]."""
    return torch.where((x & ~16383) == 0, x >> 6,
                       torch.where(x < 0, 0, 255))


def fancy_upsample(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """libwebp's UpsampleRgbLinePair on one chroma plane [(h + 1) // 2, (w
    + 1) // 2] (int32) -> [h, w]: each output row blends its nearest chroma
    row 3:1 with the next nearest (row 0, and the last row of an even
    height, with themselves), each column likewise, in libwebp's integer
    order."""
    r = torch.arange(h, device=c.device)
    near = r // 2
    far = (near + torch.where(r % 2 == 1, 1, -1)).clamp(0, c.shape[0] - 1)
    n, f = c[near], c[far]
    edge0 = (3 * n[:, :1] + f[:, :1] + 2) >> 2
    a, b, cc, d = n[:, :-1], n[:, 1:], f[:, :-1], f[:, 1:]
    avg = a + b + cc + d + 8
    odd = (((avg + 2 * (b + cc)) >> 3) + a) >> 1
    even = (((avg + 2 * (a + d)) >> 3) + b) >> 1
    parts = [edge0, torch.stack([odd, even], -1).reshape(h, -1)]
    if w % 2 == 0:
        parts.append((3 * n[:, -1:] + f[:, -1:] + 2) >> 2)
    return torch.cat(parts, 1)


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Y [h, w] and the chroma planes (uint8) -> RGB [h, w, 3] uint8 on
    their device: fancy upsampling, then libwebp's VP8YUVToR / G / B."""
    h, w = y.shape
    yy = (y.int() * 19077) >> 8
    uu = fancy_upsample(u.int(), h, w)
    vv = fancy_upsample(v.int(), h, w)
    r = _clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = _clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _clip8(yy + ((uu * 33050) >> 8) - 17685)
    return torch.stack([r, g, b], -1).to(torch.uint8)


def frame_pixels(planes: Dict[str, np.ndarray], device) -> torch.Tensor:
    """decode_planes' output -> RGB(A) uint8 [h, w, 3 | 4] on ``device``
    (VP8: the upsampling, colour conversion and alpha there; VP8L: the
    image copied there)."""
    dev = resolve_device(device)
    if "rgb" in planes:
        return torch.from_numpy(planes["rgb"]).to(dev)
    y, u, v = (torch.from_numpy(planes[k]).to(dev) for k in "yuv")
    rgb = yuv_to_rgb(y, u, v)
    if "alpha" not in planes:
        return rgb
    alpha = torch.from_numpy(planes["alpha"]).to(dev)
    return torch.cat([rgb, alpha[..., None]], -1)


def read_webp(path, device="cuda") -> torch.Tensor:
    """cv2.imread(path, IMREAD_UNCHANGED) of a WebP file in RGB(A) order:
    uint8 [H, W, 3 | 4] on ``device``."""
    dev = resolve_device(device)
    parsed = parse(path, Path(path).read_bytes())
    return frame_pixels(decode_planes(parsed, path), dev)


# ---------------------------------------------------------------- writer

def to_uint8(arr: np.ndarray, name="to_uint8") -> np.ndarray:
    """OpenCV's convertTo(CV_8U) of any other depth: saturated, floats
    rounded half to even, with NaN, infinities and magnitudes of 2^31 and
    more (cvRound's overflow) to 0; bool as 0 and 1."""
    if arr.dtype == np.uint8:
        return arr
    if arr.dtype == np.bool_:
        return arr.astype(np.uint8)
    if arr.dtype.kind == "f":
        x = np.rint(arr.astype(np.float64))
        bad = ~np.isfinite(x) | (x >= 2.0 ** 31) | (x < -(2.0 ** 31))
        return np.where(bad, 0, np.clip(np.nan_to_num(x), 0, 255)
                        ).astype(np.uint8)
    if arr.dtype.kind == "u":
        return np.minimum(arr, 255).astype(np.uint8)
    if arr.dtype.kind == "i":
        return np.clip(arr.astype(np.int64), 0, 255).astype(np.uint8)
    raise TypeError(f"{name}: WebP takes integer, float or bool images, "
                    f"got {arr.dtype}")


def encode_webp(img, name="encode_webp") -> bytes:
    """The bytes cv2.imwrite(".webp") would write at its defaults, up to
    the entropy coding: a lossless RIFF WebP of an [H, W] or [H, W, 3 | 4]
    RGB(A) image (``name``, the file's, heads any error)."""
    arr = img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"{name}: WebP takes gray, RGB or RGBA images, "
                         f"got shape {arr.shape}")
    h, w = arr.shape[:2]
    if not (1 <= w <= MAX_SIDE and 1 <= h <= MAX_SIDE):
        raise ValueError(f"{name}: {w}x{h} is outside WebP's 1 to "
                         f"{MAX_SIDE} pixels a side")
    px = to_uint8(arr, name)
    if px.shape[2] == 4 and (px[..., 3] == 0).any():
        raise NotImplementedError(
            f"{name}: an RGBA WebP with fully transparent pixels: "
            "cv2.imwrite's libwebp rewrites the colour under alpha 0 as its "
            "encoder's predictors choose, which the port does not reproduce")
    alpha = px[..., 3] if px.shape[2] == 4 else np.full((h, w), 255, np.uint8)
    argb = (alpha.astype(np.uint32) << 24) | (px[..., 0].astype(np.uint32)
                                              << 16) \
        | (px[..., 1].astype(np.uint32) << 8) | px[..., 2].astype(np.uint32)
    argb = np.ascontiguousarray(argb)
    cap = 64 + 5 * argb.size + 4096
    out = np.empty(cap, np.uint8)
    n = codec_library().webp_vp8l_encode(
        _ptr(argb, ctypes.c_uint32), w, h, int((alpha != 255).any()),
        _ptr(out, ctypes.c_uint8), cap)
    _check(name, n)
    chunk = out[:n].tobytes()
    body = b"VP8L" + struct.pack("<I", n) + chunk + (b"\x00" if n & 1 else b"")
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def write_webp(path, img) -> None:
    """cv2.imwrite(path, img) for a .webp path at its defaults: lossless
    (see encode_webp)."""
    Path(path).write_bytes(encode_webp(img, str(path)))
