"""GIF reading and writing, as OpenCV 5.0's own GIF codec
(imgcodecs/grfmt_gif.cpp) reads and writes it (no image library).

The JAX package reads every view with ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes undistorted views back under their names
with ``cv2.imwrite``. The machine with the card has no OpenCV, so the port
carries this codec: the LZW decoder and encoder and the writer's error
diffusion are host C++ (``csrc/gif_codec.cpp``, built with g++ at first use
by ``native.build_library``; no g++ raises, and there is no Python
fallback); the container is parsed here, and the palette gather, the
de-interlacing, the canvas and the transparency run as tensor operations on
the device. tests/test_torch_gif.py and tests/test_torch_gif_write.py hold
both directions to cv2. What OpenCV does, found by probing cv2.imread and
cv2.imwrite (scripts/gif_kinds.py builds the kinds neither cv2 nor Pillow
writes):

- ``read_gif`` returns the first frame of a GIF87a or GIF89a file on its
  logical screen, in RGB(A) order, uint8 [H, W, 3 | 4]. Before it decodes
  anything OpenCV walks every block of the file: extensions (their
  sub-blocks), images (descriptor, local table, data sub-blocks) up to the
  trailer; any other byte, or a file that ends first, refuses it. The
  walk misreads a 3-byte sub-block of an application extension that is
  not NETSCAPE2.0's (its loop count): it reads 2 bytes and takes the
  third for the next length, which refuses most such files. The image
  has 4 channels when the last 4-byte sub-block of any graphic control
  extension in the file has its transparency flag set, else 3.
- The screen is filled with the global table's background colour (black
  without a global table), alpha 0; the frame is decoded into its
  rectangle, each pixel its table's colour with alpha 255, except the
  pixels of the transparent index (the last graphic control extension
  before the frame, its first sub-block), which keep the screen's. The
  frame's disposal method plays no part (one above 3 refuses the file).
  The frame's colours are the global table's with its local table's
  entries over them (a gray ramp whose entry 1 is white without either);
  an index past the larger of the two tables refuses the file.
- Interlaced frames take GIF's four passes (rows 0, 8, ...; 4, 12, ...;
  2, 6, ...; 1, 3, ...).
- ``write_gif`` writes the bytes of cv2.imwrite(".gif") at its defaults:
  GIF89a, the fixed 3-3-2 global table, a NETSCAPE2.0 block (loop 0), a
  graphic control extension (disposal 3, delay 100), the frame at (0, 0)
  with no local table, the pixels error-diffused onto the table
  (csrc/gif_codec.cpp ``gif_dither``), LZW at minimum code size 8. An
  image with a pixel of alpha 0 sets the transparency flag with index
  0x92 (whose table entry OpenCV sets to the colour of the last such
  pixel); other alpha values play no part, so an RGBA image whose alpha is
  never 0 reads back with 3 channels. Gray images are refused, as
  cv2.imwrite returns False for them; other dtypes are converted to uint8
  as OpenCV's convertTo does (saturated; floats rounded half to even,
  NaN, infinities and magnitudes of 2^31 and more to 0).

Files cv2.imread returns None for (a signature other than GIF87a or
GIF89a, an empty screen, a background index past the global table, a
walk that fails, a graphic control extension whose first sub-block is not
4 bytes, a frame outside the screen, a minimum code size outside 2..11,
LZW data that decodes to more or fewer pixels than the frame holds or has
a code past the table, a file cut anywhere, no frame) raise ValueError
naming the file.
"""
from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import native, resolve_device

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gif_codec.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC", "-std=c++17"]
ERRORS = {-1: "a minimum code size outside 2..11",
          -2: "LZW data that ends before its block terminator",
          -3: "an LZW code past the table",
          -4: "LZW data past the frame's last pixel",
          -5: "LZW data that ends before the frame's last pixel"}
SIGNATURES = (b"GIF87a", b"GIF89a")
MAGIC = b"GIF"                  # the leading bytes OpenCV routes to GIF
INTERLACE_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))   # (first row, step)
TRANSPARENT = 0x92              # the writer's transparent index
# the writer's blocks after the global table: NETSCAPE2.0, loop 0
LOOP = b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
CONVERTED = (torch.uint8, torch.int8, torch.uint16, torch.int16,
             torch.int32, torch.float32, torch.float64)

_lib = None


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX_FLAGS)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.gif_lzw_decode.restype = i64
        lib.gif_lzw_decode.argtypes = [u8p, i64, i64, u8p]
        lib.gif_lzw_encode.restype = i64
        lib.gif_lzw_encode.argtypes = [u8p, i64, ctypes.c_int, u8p, i64]
        lib.gif_dither.restype = i64
        lib.gif_dither.argtypes = [u8p, i64, i64, ctypes.c_int, u8p, u8p]
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _no_image(name, why: str):
    """A file OpenCV's GIF decoder refuses: cv2.imread returns None."""
    raise ValueError(f"{name}: {why}; cv2.imread returns no image for it")


class GifDecoded(NamedTuple):
    """The host part of a decode: the first frame's palette indices [h, w]
    in stored row order (interlaced rows in pass order), its colours [256,
    3] (RGB), where it lies on the [height, width]
    screen, the screen's colour, the transparent index and the channel
    count."""
    indices: np.ndarray
    palette: np.ndarray
    screen: Tuple[int, int]
    box: Tuple[int, int, int, int]          # top, left, h, w
    background: Tuple[int, int, int]
    transparent: Optional[int]
    channels: int
    interlaced: bool


class _Reader:
    """Bytes of a file with OpenCV's end-of-stream check."""

    def __init__(self, name, data: bytes):
        self.name, self.data, self.pos = name, data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            _no_image(self.name, "a GIF that ends too soon")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def sub_blocks(self):
        """Yield each data sub-block up to the block terminator."""
        n = self.byte()
        while n:
            yield self.take(n)
            n = self.byte()

    def skip_blocks(self) -> None:
        """Skip the data sub-blocks up to the block terminator."""
        d, p = self.data, self.pos
        while p < len(d) and d[p]:
            p += 1 + d[p]
        if p >= len(d):
            _no_image(self.name, "a GIF that ends too soon")
        self.pos = p + 1


def _table(r: _Reader, flags: int) -> np.ndarray:
    n = 2 << (flags & 7)
    return np.frombuffer(r.take(3 * n), np.uint8).reshape(n, 3)


def _scan(name, data: bytes, start: int) -> int:
    """OpenCV's walk over every block after the global table: the channel
    count (4 when the last 4-byte sub-block of a graphic control extension
    has the transparency flag). Refuses a file with a byte that starts no
    block, or that ends before its trailer. A 3-byte sub-block of an
    application extension is NETSCAPE2.0's loop count when the last
    11-byte sub-block before it in that extension reads NETSCAPE2.0; any
    other OpenCV reads as 2 bytes, and takes its third byte for the next
    sub-block's length."""
    r = _Reader(name, data)
    r.pos = start
    channels = 3
    while True:
        kind = r.byte()
        if kind == 0x3B:
            break
        if kind == 0x21:
            label = r.byte()
            netscape = False
            n = r.byte()
            while n:
                blk = r.take(2 if label == 0xFF and n == 3 and not netscape
                             else n)
                if label == 0xF9 and n == 4:
                    channels = 4 if blk[0] & 1 else 3
                elif label == 0xFF and n == 11:
                    netscape = blk == b"NETSCAPE2.0"
                n = r.byte()
        elif kind == 0x2C:
            flags = r.take(9)[8]
            if flags & 0x80:
                r.take(3 * (2 << (flags & 7)))
            r.take(1)
            r.skip_blocks()
        else:
            _no_image(name, f"a byte {kind:#04x} where a GIF block starts")
    return channels


def decode_gif(path) -> GifDecoded:
    """The host part of reading ``path``: the container and the LZW data
    of its first frame."""
    data = Path(path).read_bytes()
    r = _Reader(path, data)
    if r.take(6) not in SIGNATURES:
        _no_image(path, f"a GIF signature {data[:6]!r} (OpenCV reads GIF87a "
                  "and GIF89a)")
    width, height, flags, bg, _ = struct.unpack("<2H3B", r.take(7))
    if width == 0 or height == 0:
        _no_image(path, f"a GIF screen of {width}x{height}")
    global_table = None
    if flags & 0x80:
        global_table = _table(r, flags)
        if bg >= len(global_table):
            _no_image(path, f"a background index {bg} past the global "
                      f"table's {len(global_table)} entries")
    channels = _scan(path, data, r.pos)
    transparent = None
    while True:
        kind = r.byte()
        if kind == 0x2C:
            break
        if kind != 0x21:
            _no_image(path, f"a byte {kind:#04x} before the first frame")
        label = r.byte()
        if label == 0xF9:
            n = r.byte()
            if n != 4:
                _no_image(path, f"a graphic control extension of {n} bytes")
            gce = r.take(4)
            if (gce[0] >> 2) & 7 > 3:
                _no_image(path, f"disposal method {(gce[0] >> 2) & 7}")
            transparent = gce[3] if gce[0] & 1 else None
        r.skip_blocks()
    left, top, w, h, fflags = struct.unpack("<4HB", r.take(9))
    if w == 0 or h == 0 or left + w > width or top + h > height:
        _no_image(path, f"a {w}x{h} frame at ({left}, {top}) on a "
                  f"{width}x{height} screen")
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    palette[1] = 255
    entries = 256
    if global_table is not None:
        palette[:] = 0
        palette[:len(global_table)] = global_table
        entries = len(global_table)
    if fflags & 0x80:
        local = _table(r, fflags)
        palette[:len(local)] = local
        entries = max(len(local), entries if global_table is not None else 0)
    src = np.frombuffer(data, np.uint8)[r.pos:]
    indices = np.empty(h * w, np.uint8)
    n = library().gif_lzw_decode(_u8(src), src.size, h * w, _u8(indices))
    if n < 0:
        _no_image(path, ERRORS.get(n, f"LZW error {n}"))
    used = np.bincount(indices, minlength=256)
    if transparent is not None:
        used[transparent] = 0
    past = np.flatnonzero(used[entries:])
    if past.size:
        _no_image(path, f"a palette index {entries + past[0]} past the "
                  f"colour tables' {entries} entries")
    background = (tuple(int(v) for v in global_table[bg])
                  if global_table is not None else (0, 0, 0))
    return GifDecoded(indices.reshape(h, w), palette, (height, width),
                      (top, left, h, w), background, transparent, channels,
                      bool(fflags & 0x40))


def interlace_order(h: int) -> np.ndarray:
    """The image row of each stored row of an interlaced frame."""
    return np.concatenate([np.arange(first, h, step)
                           for first, step in INTERLACE_PASSES])


def gif_pixels(dec: GifDecoded, device="cuda") -> torch.Tensor:
    """The device part: the frame's indices -> uint8 [H, W, 3 | 4] on
    ``device``, RGB(A): rows de-interlaced, the palette gathered, the
    frame placed on the screen's colour, transparent pixels left at it."""
    dev = resolve_device(device)
    idx = torch.from_numpy(np.ascontiguousarray(dec.indices)).to(dev)
    top, left, h, w = dec.box
    if dec.interlaced:
        rows = torch.empty(h, dtype=torch.long, device=dev)
        rows[torch.from_numpy(interlace_order(h)).to(dev)] = torch.arange(
            h, device=dev)
        idx = idx.index_select(0, rows)
    c = dec.channels
    palette = torch.from_numpy(dec.palette).to(dev)
    screen = torch.tensor([*dec.background, 0][:c], dtype=torch.uint8,
                          device=dev)
    out = screen.expand(*dec.screen, c).clone()
    px = palette.index_select(0, idx.reshape(-1).long()).reshape(h, w, 3)
    if c == 4:
        px = torch.cat([px, torch.full_like(px[..., :1], 255)], -1)
    if dec.transparent is not None:
        px = torch.where((idx == dec.transparent)[..., None], screen, px)
    out[top:top + h, left:left + w] = px
    return out


def read_gif(path, device="cuda") -> torch.Tensor:
    """cv2.imread(path, IMREAD_UNCHANGED) of a GIF in RGB(A) order on
    ``device``."""
    return gif_pixels(decode_gif(path), device)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's convertTo(CV_8U) on the tensor's device: saturated;
    floats rounded half to even, NaN, infinities and magnitudes of 2^31
    and more to 0."""
    if img.dtype == torch.uint8:
        return img
    if img.dtype not in CONVERTED:
        raise TypeError(f"GIF takes uint8, int8, uint16, int16, int32, "
                        f"float32 or float64 images, got {img.dtype}")
    if img.dtype.is_floating_point:
        x = img.double()
        x = torch.where(torch.isfinite(x) & (x.abs() < 2.0 ** 31),
                        torch.round(x), torch.zeros_like(x))
        return x.clamp(0, 255).to(torch.uint8)
    return img.to(torch.int32).clamp(0, 255).to(torch.uint8)


def palette_332() -> np.ndarray:
    """The writer's global table: index (r << 5) | (g << 2) | b -> (36 r,
    36 g, 85 b)."""
    i = np.arange(256)
    return np.stack([(i >> 5) * 36, ((i >> 2) & 7) * 36, (i & 3) * 85],
                    -1).astype(np.uint8)


def encoder_input(img, device="cuda") -> np.ndarray:
    """The device part of an encode: an RGB(A) image [H, W, 3 | 4] of any
    dtype OpenCV converts -> uint8 numpy, converted on ``device``. Gray
    and 2-channel images raise ValueError (cv2.imwrite returns False for
    gray)."""
    x = img if torch.is_tensor(img) else torch.from_numpy(np.asarray(img))
    if x.dim() != 3 or x.shape[2] not in (3, 4):
        raise ValueError(f"GIF writes 3- or 4-channel images, got shape "
                         f"{tuple(x.shape)} (cv2.imwrite returns False for "
                         "gray)")
    if x.shape[0] > 65535 or x.shape[1] > 65535:
        raise ValueError(f"a GIF is at most 65535 pixels a side, got "
                         f"{x.shape[1]}x{x.shape[0]}")
    return np.ascontiguousarray(
        to_uint8(x.to(resolve_device(device))).cpu().numpy())


def encode_rgb(rgb: np.ndarray) -> bytes:
    """The host part of an encode: uint8 [H, W, 3 | 4] -> the file's
    bytes (the dither and LZW in C++)."""
    h, w, c = rgb.shape
    lib = library()
    indices = np.empty((h, w), np.uint8)
    palette = palette_332()
    key = np.zeros(3, np.uint8)
    transparent = lib.gif_dither(_u8(rgb), h, w, c, _u8(indices), _u8(key))
    if transparent:
        palette[TRANSPARENT] = key
    cap = h * w * 2 + 1024
    lzw = np.empty(cap, np.uint8)
    n = lib.gif_lzw_encode(_u8(indices), h * w, 8, _u8(lzw), cap)
    if n < 0:
        raise RuntimeError(f"gif_lzw_encode: error {n}")
    gce = struct.pack("<4BHBB", 0x21, 0xF9, 4, 0x0C | transparent, 100,
                      TRANSPARENT if transparent else 0, 0)
    return (b"GIF89a" + struct.pack("<2H3B", w, h, 0xF7, 0, 0)
            + palette.tobytes() + LOOP + gce
            + struct.pack("<B4HB", 0x2C, 0, 0, w, h, 0x07) + b"\x08"
            + lzw[:n].tobytes() + b"\x3b")


def encode_gif(img, device="cuda") -> bytes:
    """The bytes of cv2.imwrite(".gif") at its defaults for an RGB(A)
    image [H, W, 3 | 4]: ``encoder_input`` on ``device``, then
    ``encode_rgb`` on the host."""
    return encode_rgb(encoder_input(img, device))


def write_gif(path, img, device="cuda") -> None:
    """cv2.imwrite(path, img) for .gif: ``encode_gif``'s bytes; a gray
    image raises ValueError naming the file (cv2.imwrite returns False)."""
    try:
        data = encode_gif(img, device)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    Path(path).write_bytes(data)
