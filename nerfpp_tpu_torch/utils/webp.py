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
- A pixel of alpha 0 is written as cv2's libwebp writes it, which does not
  keep its colour (WebPEncodeLosslessBGRA: quality 70, method 4, "exact"
  off): ``transparent_rewrite`` computes the image libwebp encodes in its
  place (every such pixel set to 0; where libwebp's entropy analysis picks
  the predictor transform, alone or after subtract-green, each such pixel
  given the colour of its prediction under the mode libwebp picks for its
  tile, in libwebp's fixed-point costs), and the encoder then keeps it
  exactly. tests/test_torch_webp_transparent.py holds cv2's read-back of
  both files equal.
- An animated WebP (VP8X with ANIM and ANMF chunks) reads as OpenCV reads
  it through WebPAnimDecoder: the first frame (an optional ALPH and a VP8,
  or a VP8L) decoded into its rectangle (the offset stored halved, the
  size the bitstream's) on a canvas of transparent black, neither blended
  nor composited with the ANIM background colour; 4 channels when the
  VP8X alpha flag is set, else 3. The file is checked as libwebp's
  WebPDemux checks it (ANIM before the frames, every frame inside the
  canvas, at least one frame). tests/test_torch_webp_animated.py holds it
  to cv2.

Files cv2.imread returns None for (shorter than 32 bytes, a broken
bitstream, a frame that disagrees with its VP8X canvas, an animation
WebPDemux refuses) raise ValueError naming the file.
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
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
             "-shared", "-fPIC", "-std=c++17"]
ERRORS = {-1: "a bitstream error", -2: "data that ends too soon",
          -3: "no room for the output"}
HEADER_BYTES = 32        # what OpenCV hands WebPGetFeatures
MAX_SIDE = 16383         # WEBP_MAX_DIMENSION
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
# libwebp's lossless analysis outcomes (AnalyzeEntropy), in its order
TRANSFORMS = ("none", "predictor", "subtract green",
              "subtract green + predictor", "palette")
VALID_FLAGS = 0x3E       # alpha, ICC, EXIF, XMP, animation
MAX_AREA = 1 << 32       # libwebp's MAX_IMAGE_AREA

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
        lib.webp_transparent_rewrite.restype = i64
        lib.webp_transparent_rewrite.argtypes = [u32p, i32, i32]
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
    payload (or None), the frame size and the channel count cv2 takes; for
    an animation, ``canvas`` (x, y, canvas width, canvas height) places the
    first frame."""
    kind: str
    payload: bytes
    alpha: Optional[bytes]
    width: int
    height: int
    channels: int
    canvas: Optional[Tuple[int, int, int, int]] = None


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


def first_frame(path, data: bytes, end: int, flags: int, cw: int,
                ch: int) -> Parsed:
    """The first frame of an animation, checked as libwebp's WebPDemux
    checks the whole file (OpenCV reads animations through
    WebPAnimDecoder): ANIM before the ANMF frames, each frame an optional
    ALPH and a VP8 chunk, or a VP8L chunk, whose bitstream size (not the
    ANMF header's) lies inside the canvas; at least one frame."""
    if flags & ~VALID_FLAGS:
        raise _bad(path, f"VP8X flags {flags:#04x}")
    if cw * ch >= MAX_AREA:
        raise _bad(path, f"a {cw}x{ch} canvas")
    anim = False
    first = None
    pos = 30
    for tag, off, size in _chunks(path, data, pos, end):
        pos = off + size + (size & 1)
        if tag in (b"VP8X", b"ALPH", b"VP8 ", b"VP8L"):
            raise _bad(path, f"a {tag.decode()!r} chunk outside the frames "
                       "of an animation")
        if tag == b"ANIM":
            if size < 6:
                raise _bad(path, f"an ANIM chunk of {size} bytes")
            anim = True
        elif tag == b"ANMF":
            if not anim:
                raise _bad(path, "an ANMF frame before the ANIM chunk")
            if size < 16:
                raise _bad(path, f"an ANMF chunk of {size} bytes")
            frame = _anmf(path, data, off, size, cw, ch)
            if first is None:
                first = frame
    if end - pos > 0:
        raise _bad(path, f"{end - pos} bytes where a chunk belongs")
    if first is None:
        raise _bad(path, "an animation without a frame")
    return first._replace(channels=4 if flags & ALPHA_FLAG else 3)


def _anmf(path, data: bytes, off: int, size: int, cw: int, ch: int
          ) -> Optional[Parsed]:
    """An ANMF chunk's frame (None when it holds no image), placed on the
    ``cw`` x ``ch`` canvas."""
    x = 2 * int.from_bytes(data[off:off + 3], "little")
    y = 2 * int.from_bytes(data[off + 3:off + 6], "little")
    fw = int.from_bytes(data[off + 6:off + 9], "little") + 1
    fh = int.from_bytes(data[off + 9:off + 12], "little") + 1
    if fw * fh >= MAX_AREA:
        raise _bad(path, f"a {fw}x{fh} ANMF frame")
    alpha = None
    for tag, coff, csize in _chunks(path, data, off + 16, off + size):
        payload = data[coff:coff + csize]
        if tag == b"ALPH" and alpha is None:
            alpha = payload
            continue
        if tag == b"VP8 ":
            w, h = vp8_size(path, payload)
        elif tag == b"VP8L":
            if alpha is not None:
                raise _bad(path, "an ALPH chunk before a VP8L frame")
            w, h, _ = vp8l_header(path, payload)
        else:
            break
        if x + w > cw or y + h > ch:
            raise _bad(path, f"a {w}x{h} frame at ({x}, {y}) outside its "
                       f"{cw}x{ch} canvas")
        return Parsed(tag.decode().strip(), payload, alpha, w, h, 4,
                      (x, y, cw, ch))
    return None


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
        channels = 4 if flags & ALPHA_FLAG else 3
        if flags & ANIMATION_FLAG:
            return first_frame(path, data, end, flags, cw, ch)
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
    out = {} if parsed.canvas is None else {
        "canvas": np.array(parsed.canvas, np.int64)}
    if parsed.kind == "VP8L":
        argb = np.empty((h, w), np.uint32)
        _check(path, lib.webp_vp8l_decode(_ptr(src[5:], ctypes.c_uint8),
                                          src.size - 5, w, h,
                                          _ptr(argb, ctypes.c_uint32)))
        bgra = argb.view(np.uint8).reshape(h, w, 4)     # little-endian ARGB
        order = [2, 1, 0, 3][:parsed.channels]
        out["rgb"] = np.ascontiguousarray(bgra[..., order])
        return out
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    _check(path, lib.webp_vp8_decode(_ptr(src, ctypes.c_uint8), src.size,
                                     w, h, _ptr(y, ctypes.c_uint8),
                                     _ptr(u, ctypes.c_uint8),
                                     _ptr(v, ctypes.c_uint8)))
    out.update(y=y, u=u, v=v)
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
        img = torch.from_numpy(planes["rgb"]).to(dev)
    else:
        y, u, v = (torch.from_numpy(planes[k]).to(dev) for k in "yuv")
        img = yuv_to_rgb(y, u, v)
        if "alpha" in planes:
            alpha = torch.from_numpy(planes["alpha"]).to(dev)
            img = torch.cat([img, alpha[..., None]], -1)
    if "canvas" not in planes:
        return img
    x, y0, cw, ch = (int(v) for v in planes["canvas"])
    canvas = torch.zeros((ch, cw, img.shape[2]), dtype=torch.uint8,
                         device=dev)
    canvas[y0:y0 + img.shape[0], x:x + img.shape[1]] = img
    return canvas


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


def transparent_rewrite(argb: np.ndarray) -> str:
    """Rewrites ``argb`` (uint32 [h, w], C order) in place into what
    cv2.imwrite(".webp")'s libwebp encodes in its place: every pixel of
    alpha 0 set to 0 and then, when libwebp's analysis picks the predictor
    transform, given the colour of its prediction under the mode libwebp
    picks for its tile (see csrc/webp_codec.cpp). Returns the transforms
    picked, one of TRANSFORMS."""
    if argb.dtype != np.uint32 or argb.ndim != 2 \
            or not argb.flags.c_contiguous:
        raise ValueError("transparent_rewrite takes a C-ordered uint32 "
                         f"[h, w] array, got {argb.dtype} {argb.shape}")
    h, w = argb.shape
    n = codec_library().webp_transparent_rewrite(
        _ptr(argb, ctypes.c_uint32), w, h)
    _check("transparent_rewrite", n)
    return TRANSFORMS[n]


def argb_image(img, name="argb_image") -> np.ndarray:
    """An [H, W] or [H, W, 3 | 4] RGB(A) image (any dtype cv2 converts) as
    libwebp's ARGB, uint32 [H, W] (``name``, the file's, heads any
    error)."""
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
    alpha = px[..., 3] if px.shape[2] == 4 else np.full((h, w), 255, np.uint8)
    argb = (alpha.astype(np.uint32) << 24) | (px[..., 0].astype(np.uint32)
                                              << 16) \
        | (px[..., 1].astype(np.uint32) << 8) | px[..., 2].astype(np.uint32)
    return np.ascontiguousarray(argb)


def has_transparent(argb: np.ndarray) -> bool:
    """Whether libwebp rewrites any pixel of ``argb`` (one of alpha 0)."""
    return bool((argb < (1 << 24)).any())


def encode_argb(argb: np.ndarray, name="encode_argb") -> bytes:
    """A lossless RIFF WebP that keeps every pixel of ``argb`` (uint32 [H,
    W]; the alpha bit set when some alpha is below 255)."""
    h, w = argb.shape
    cap = 64 + 5 * argb.size + 4096
    out = np.empty(cap, np.uint8)
    n = codec_library().webp_vp8l_encode(
        _ptr(argb, ctypes.c_uint32), w, h, int((argb < 0xFF000000).any()),
        _ptr(out, ctypes.c_uint8), cap)
    _check(name, n)
    chunk = out[:n].tobytes()
    body = b"VP8L" + struct.pack("<I", n) + chunk + (b"\x00" if n & 1 else b"")
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def encode_webp(img, name="encode_webp") -> bytes:
    """The bytes cv2.imwrite(".webp") would write at its defaults, up to
    the entropy coding: a lossless RIFF WebP of an [H, W] or [H, W, 3 | 4]
    RGB(A) image, the colour under alpha 0 rewritten as libwebp rewrites it
    (``name``, the file's, heads any error)."""
    argb = argb_image(img, name)
    if has_transparent(argb):
        transparent_rewrite(argb)
    return encode_argb(argb, name)


def write_webp(path, img) -> None:
    """cv2.imwrite(path, img) for a .webp path at its defaults: lossless
    (see encode_webp)."""
    Path(path).write_bytes(encode_webp(img, str(path)))
