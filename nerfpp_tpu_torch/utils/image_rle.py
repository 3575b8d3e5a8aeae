"""The run-length passes of BMP and Radiance HDR on the host
(``csrc/image_rle.cpp``, built with g++ at first use by
``native.build_library``; no g++ raises, and there is no Python
fallback)."""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from nerfpp_tpu_torch import native

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "image_rle.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
ERRORS = {-1: "run-length data OpenCV refuses (a run past the end of its "
              "line or a bad count)",
          -2: "the data ends before the image does",
          -3: "no room for the output"}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX_FLAGS)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        for fn in (lib.bmp_rle8_decode, lib.bmp_rle4_decode, lib.hdr_decode):
            fn.restype = i64
            fn.argtypes = [u8p, i64, i64, i64, u8p]
        lib.hdr_encode.restype = i64
        lib.hdr_encode.argtypes = [u8p, i64, i64, u8p, i64]
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(path, n: int) -> None:
    if n < 0:
        raise ValueError(f"{path}: {ERRORS.get(n, f'error {n}')}; "
                         "cv2.imread returns no image for it")


def bmp_rle_decode(path, data: bytes, bits: int, w: int, h: int
                   ) -> np.ndarray:
    """BMP RLE8 (``bits`` 8) or RLE4 (4) data -> uint8 palette indices [h,
    w], the first decoded row first."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((h, w), np.uint8)
    fn = library().bmp_rle8_decode if bits == 8 else library().bmp_rle4_decode
    _check(path, fn(_u8(src), src.size, w, h, _u8(out)))
    return out


def hdr_decode(path, data: bytes, w: int, h: int) -> np.ndarray:
    """Radiance HDR pixel data -> uint8 RGBE [h, w, 4]."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((h, w, 4), np.uint8)
    _check(path, library().hdr_decode(_u8(src), src.size, w, h, _u8(out)))
    return out


def hdr_encode(rgbe: np.ndarray) -> bytes:
    """uint8 RGBE [h, w, 4] (8 <= w <= 32767) -> new-style run-length
    scanlines."""
    src = np.ascontiguousarray(rgbe, np.uint8)
    h, w = src.shape[:2]
    cap = h * (4 + 4 * (w + (w + 127) // 128 + 1))
    out = np.empty(cap, np.uint8)
    n = library().hdr_encode(_u8(src), w, h, _u8(out), cap)
    _check("hdr_encode", n)
    return out[:n].tobytes()
