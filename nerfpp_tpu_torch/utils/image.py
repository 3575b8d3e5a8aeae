"""OpenCV's image resampling in PyTorch: resize, the optimal new camera
matrix and undistortion (the counterparts of the cv2 calls of
nerfpp_tpu/data/colmap.py and nerfpp_tpu/data/dataset.py).

The machine with the card has neither OpenCV nor Pillow, so the port
computes these itself, on the device of the tensors it is given (the card,
unless the caller passes CPU tensors). Each follows OpenCV's arithmetic
step by step, so that its results are OpenCV's bit for bit where the tests
can show it (tests/test_torch_colmap.py):

- ``resize_linear``: ``cv2.resize`` with INTER_LINEAR on float images:
  half-pixel centres, no antialiasing, the source coordinate and its
  fraction in double, the horizontal taps clamped at the edges, the 2x2 box
  mean at an exact halving. Values agree with OpenCV's to float rounding
  (measured within 1.2e-7 on [0, 1] images), not bit for bit.
- ``resize_linear_u16``: the same on 16-bit images, which OpenCV hands to
  its IPP HAL: a lerp along x, then along y, each a fused multiply-add in
  f32 (S0 + (S1 - S0) * f with one rounding), the fraction of the
  double-precision source coordinate rounded to f32, the sum rounded half
  to even; an exact halving is no special case. (Measured equal to cv2
  5.0.0 on every shape tried except sources one pixel wide or high, where
  OpenCV leaves the HAL and a few values differ by one.)
- ``resize_linear_u8``: the same on 8-bit images, in OpenCV's fixed point:
  11-bit tap weights (the float weight times 2,048, rounded), the horizontal
  pass in int32, then the vertical pass as OpenCV's vector code computes it
  (each row's sum shifted right by 4, times the 11-bit weight, the high 16
  bits kept, the two added, rounded off 2 bits). Unlike the horizontal
  weights, a vertical weight is not clamped at the edges: a row above the
  first or below the last takes the edge row for both taps, with the split
  weights. An exact halving is the 2x2 mean rounded half up, OpenCV's
  INTER_AREA.
- ``optimal_new_camera_matrix``: ``cv2.getOptimalNewCameraMatrix(k, d, (w,
  h), alpha)``: a 9x9 grid of pixels at (x (w - 1) / 8, y (h - 1) / 8),
  undistorted by OpenCV's iterative inverse (5 fixed-point iterations, in
  float64), its inner and outer rectangles, and the focal lengths and
  principal point that map them onto the image.
- ``undistort``: ``cv2.undistort(img, k, d, None, new_k)`` on 8-bit images:
  ``initUndistortRectifyMap`` in float64 (each output pixel through the
  inverse of new_k, the distortion model, then k), the map quantised to 1/32
  pixel (round half to even), then ``remap`` with INTER_LINEAR and a zero
  border in OpenCV's fixed point: integer weights (32 - fx)(32 - fy) x 32
  and so on, summing to 2^15, the sum rounded off 15 bits; a tap outside the
  image reads 0. On 16-bit images ``remap`` interpolates in f32 instead:
  each tap times its weight from OpenCV's table ((1 - fy)(1 - fx) and so
  on, with f = k / 32), the four products summed left to right, rounded
  half to even.

Distortion coefficients follow OpenCV's order: k1, k2, p1, p2 [, k3 [, k4,
k5, k6]].

``read_image`` and ``write_image`` are ``cv2.imread(path,
IMREAD_UNCHANGED)`` and ``cv2.imwrite`` for the formats the port reads and
writes: PNG of every colour type and depth (utils/png.py), baseline,
extended sequential and progressive Huffman JPEG (utils/jpeg.py) and TIFF
(utils/tiff.py); 16-bit PNG and TIFF come back as uint16, as OpenCV returns
them. Reading goes by the file's leading bytes, as OpenCV's does, writing
by the extension (PNG and TIFF keep 16 bits; JPEG is written baseline at
quality 95, as cv2.imwrite writes it at its defaults). BMP, WebP, JPEG
2000, AVIF and the formats' unread kinds (arithmetic-coded, 12-bit and CMYK
JPEG, float or JPEG-compressed TIFF, ...) raise NotImplementedError naming
the file and the kind.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.utils.jpeg import read_jpeg, write_jpeg
from nerfpp_tpu_torch.utils.png import SIGNATURE as PNG_SIGNATURE
from nerfpp_tpu_torch.utils.png import read_png, write_png
from nerfpp_tpu_torch.utils.tiff import SIGNATURES as TIFF_SIGNATURES
from nerfpp_tpu_torch.utils.tiff import read_tiff, write_tiff

RESIZE_COEF_BITS = 11            # INTER_RESIZE_COEF_BITS
REMAP_BITS = 5                   # INTER_BITS: the map in 1/32 pixel
REMAP_COEF_BITS = 15             # INTER_REMAP_COEF_BITS


# ------------------------------------------------------------------ resize

def _taps(n_src: int, n_dst: int, clamp_weights: bool = True):
    """OpenCV INTER_LINEAR taps along one axis: (i0, i1, w0, w1), the
    source coordinate (d + 0.5) * scale - 0.5 and its fraction in double,
    the weights 1 - fx and fx rounded to f32. Indices are clamped to the
    image; with ``clamp_weights`` a tap left of the first pixel or right of
    the last takes that pixel alone (OpenCV's horizontal pass), else the
    weights stay split (its vertical pass)."""
    scale = 1.0 / (n_dst / n_src)
    f = (np.arange(n_dst) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    if clamp_weights:
        f[(s < 0) | (s >= n_src - 1)] = 0.0
    return (np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1),
            (1.0 - f).astype(np.float32), f.astype(np.float32))


def _fixed(w: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(w * 2^11): round half to even, in f32."""
    return np.rint(w * np.float32(1 << RESIZE_COEF_BITS)).astype(np.int32)


def resize_linear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, (w, h)) with INTER_LINEAR for float images:
    img [..., H, W, C] -> [..., h, w, C] (float32)."""
    img = img.float()
    h_src, w_src = img.shape[-3], img.shape[-2]
    h, w = out_hw
    if (h_src, w_src) == (h, w):
        return img.clone()
    if (h_src, w_src) == (2 * h, 2 * w):
        # OpenCV computes an exact halving as INTER_AREA: the 2x2 mean
        b = img.reshape(*img.shape[:-3], h, 2, w, 2, img.shape[-1])
        return ((b[..., 0, :, 0, :] + b[..., 0, :, 1, :])
                + (b[..., 1, :, 0, :] + b[..., 1, :, 1, :])) * 0.25
    dev = img.device

    def t(x):
        return torch.as_tensor(x, device=dev)

    x0, x1, a0, a1 = (t(v) for v in _taps(w_src, w))
    y0, y1, b0, b1 = (t(v) for v in _taps(h_src, h, clamp_weights=False))
    rows = img[..., x0, :] * a0[:, None] + img[..., x1, :] * a1[:, None]
    return (rows[..., y0, :, :] * b0[:, None, None]
            + rows[..., y1, :, :] * b1[:, None, None])


def resize_linear_u8(img: torch.Tensor, out_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """cv2.resize(img, (w, h)) with INTER_LINEAR for 8-bit images:
    uint8 [H, W] or [H, W, C] -> the same layout at (h, w), on img's
    device."""
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8, got {img.dtype}")
    h_src, w_src = img.shape[0], img.shape[1]
    h, w = out_hw
    if (h_src, w_src) == (h, w):
        return img.clone()
    x = img.to(torch.int32)
    if (h_src, w_src) == (2 * h, 2 * w):
        b = x.reshape(h, 2, w, 2, *x.shape[2:])
        return ((b.sum(dim=(1, 3)) + 2) >> 2).to(torch.uint8)
    dev = img.device
    x0, x1, a0, a1 = _taps(w_src, w)
    y0, y1, b0, b1 = _taps(h_src, h, clamp_weights=False)

    def t(v):
        return torch.as_tensor(v, device=dev)

    # a weight per output column, broadcast over the channels if any
    col = (slice(None),) + (None,) * (img.dim() - 2)
    rows = (x[:, t(x0)] * t(_fixed(a0))[col]
            + x[:, t(x1)] * t(_fixed(a1))[col])                  # [H, w, ...]
    row = (slice(None), None) + (None,) * (img.dim() - 2)
    s0 = (rows[t(y0)] >> 4) * t(_fixed(b0))[row]
    s1 = (rows[t(y1)] >> 4) * t(_fixed(b1))[row]
    out = ((s0 >> 16) + (s1 >> 16) + 2) >> 2
    return torch.clamp(out, 0, 255).to(torch.uint8)


def resize_linear_u16(img: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """cv2.resize(img, (w, h)) with INTER_LINEAR for 16-bit images (through
    OpenCV's IPP HAL): uint16 [H, W] or [H, W, C] -> the same layout at (h,
    w), on img's device. A fused multiply-add is emulated in f64, where the
    product of two f32 values and the sum are exact, then rounded once to
    f32."""
    if img.dtype != torch.uint16:
        raise TypeError(f"resize_linear_u16 takes uint16, got {img.dtype}")
    h_src, w_src = img.shape[0], img.shape[1]
    h, w = out_hw
    if (h_src, w_src) == (h, w):
        return img.clone()
    dev = img.device
    x = img.to(torch.int32).to(torch.float32)
    x0, x1, _, a1 = _taps(w_src, w)
    y0, y1, _, b1 = _taps(h_src, h, clamp_weights=False)

    def t(v):
        return torch.as_tensor(v, device=dev)

    def lerp(s0, s1, f):
        return ((s1 - s0).double() * f.double() + s0.double()).float()

    col = (slice(None),) + (None,) * (img.dim() - 2)
    rows = lerp(x[:, t(x0)], x[:, t(x1)], t(a1)[col])          # [H, w, ...]
    row = (slice(None), None) + (None,) * (img.dim() - 2)
    out = lerp(rows[t(y0)], rows[t(y1)], t(b1)[row])
    return torch.round(out).clamp(0, 65535).to(torch.int32).to(torch.uint16)


# ------------------------------------------------------------ undistortion

def _coeffs(d) -> Tuple[float, ...]:
    """(k1, k2, p1, p2, k3, k4, k5, k6) from 4, 5 or 8 coefficients."""
    d = [float(v) for v in np.asarray(d, np.float64).reshape(-1)]
    if len(d) not in (4, 5, 8):
        raise ValueError(f"expected 4, 5 or 8 distortion coefficients, got "
                         f"{len(d)}")
    return tuple(d + [0.0] * (8 - len(d)))


def undistort_points(pts: torch.Tensor, k, d, iters: int = 5
                     ) -> torch.Tensor:
    """cv2.undistortPoints(pts, k, d) with its default criteria (5
    iterations): float64 pixel coords [N, 2] -> normalised undistorted
    coords [N, 2], on pts' device."""
    k = np.asarray(k, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(d)
    ifx, ify = 1.0 / k[0, 0], 1.0 / k[1, 1]
    u, v = pts[:, 0], pts[:, 1]
    x0 = x = (u - k[0, 2]) * ifx
    y0 = y = (v - k[1, 2]) * ify
    # where the model folds over (a negative inverse factor) OpenCV stops
    # and keeps the distorted point
    stop = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = ((1 + ((k6 * r2 + k5) * r2 + k4) * r2)
                  / (1 + ((k3 * r2 + k2) * r2 + k1) * r2))
        stop = stop | (icdist < 0)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = torch.where(stop, x0, (x0 - dx) * icdist)
        y = torch.where(stop, y0, (y0 - dy) * icdist)
    return torch.stack([x, y], dim=-1)


def optimal_new_camera_matrix(k, d, size_wh: Tuple[int, int],
                              alpha: float = 0.0, device="cuda"
                              ) -> np.ndarray:
    """cv2.getOptimalNewCameraMatrix(k, d, (w, h), alpha) with the new size
    equal to the old: the float64 [3, 3] matrix that maps the undistorted
    image's inner rectangle (alpha 0) or outer rectangle (alpha 1) onto
    the image. The grid is undistorted on ``device``."""
    w, h = size_wh
    n = 9
    dev = resolve_device(device)
    idx = torch.arange(n, dtype=torch.float64, device=dev)
    gy, gx = torch.meshgrid(idx * (h - 1) / (n - 1), idx * (w - 1) / (n - 1),
                            indexing="ij")
    und = undistort_points(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1),
                           k, d).reshape(n, n, 2)
    ux, uy = und[..., 0], und[..., 1]
    inner = (float(ux[:, 0].max()), float(uy[0, :].max()),
             float(ux[:, n - 1].min()), float(uy[n - 1, :].min()))
    outer = (float(ux.min()), float(uy.min()), float(ux.max()),
             float(uy.max()))
    mats = []
    for x0, y0, x1, y1 in (inner, outer):
        fx, fy = (w - 1) / (x1 - x0), (h - 1) / (y1 - y0)
        mats.append((fx, fy, -fx * x0, -fy * y0))
    m = [a * (1 - alpha) + b * alpha for a, b in zip(*mats)]
    return np.array([[m[0], 0.0, m[2]], [0.0, m[1], m[3]], [0.0, 0.0, 1.0]])


def undistort_map(k, d, new_k, size_wh: Tuple[int, int], device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.initUndistortRectifyMap(k, d, None, new_k, (w, h), CV_16SC2) as
    two int64 [h, w] maps of source coords in 1/32 pixel."""
    w, h = size_wh
    dev = resolve_device(device)
    k = np.asarray(k, np.float64)
    ir = np.linalg.inv(np.asarray(new_k, np.float64)).reshape(-1)
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(d)
    i = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    j = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    xw = i * ir[1] + ir[2] + j * ir[0]
    yw = i * ir[4] + ir[5] + j * ir[3]
    ww = 1.0 / (i * ir[7] + ir[8] + j * ir[6])
    x, y = xw * ww, yw * ww
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    u = k[0, 0] * xd + k[0, 2]
    v = k[1, 1] * yd + k[1, 2]
    scale = float(1 << REMAP_BITS)
    return (torch.round(u * scale).to(torch.int64),
            torch.round(v * scale).to(torch.int64))


def remap_linear_u8(img: torch.Tensor, map_u: torch.Tensor,
                    map_v: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, map1, map2, INTER_LINEAR, BORDER_CONSTANT) on uint8
    [H, W] or [H, W, C] with 1/32-pixel int maps [h, w] (undistort_map)."""
    hs, ws = img.shape[0], img.shape[1]
    src = img.reshape(hs * ws, -1).to(torch.int32)
    sx, sy = map_u >> REMAP_BITS, map_v >> REMAP_BITS
    one = 1 << REMAP_BITS
    fx, fy = (map_u & (one - 1)).to(torch.int32), (map_v & (one - 1)).to(
        torch.int32)
    acc = None
    for dy, wy in ((0, one - fy), (1, fy)):
        for dx, wx in ((0, one - fx), (1, fx)):
            xx, yy = sx + dx, sy + dy
            inside = (xx >= 0) & (xx < ws) & (yy >= 0) & (yy < hs)
            at = (torch.clamp(yy, 0, hs - 1) * ws
                  + torch.clamp(xx, 0, ws - 1)).reshape(-1)
            tap = src[at] * (wx * wy * one * inside).reshape(-1, 1)
            acc = tap if acc is None else acc + tap
    out = (acc + (1 << (REMAP_COEF_BITS - 1))) >> REMAP_COEF_BITS
    return torch.clamp(out, 0, 255).to(torch.uint8).reshape(
        *map_u.shape, *img.shape[2:])


def remap_linear_u16(img: torch.Tensor, map_u: torch.Tensor,
                     map_v: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, map1, map2, INTER_LINEAR, BORDER_CONSTANT) on uint16
    [H, W] or [H, W, C] with 1/32-pixel int maps [h, w]: OpenCV's float
    path (the weights of its interpolation table, products and sums in
    f32)."""
    hs, ws = img.shape[0], img.shape[1]
    src = img.reshape(hs * ws, -1).to(torch.int32).to(torch.float32)
    sx, sy = map_u >> REMAP_BITS, map_v >> REMAP_BITS
    one = 1 << REMAP_BITS
    fx = (map_u & (one - 1)).to(torch.float32) / one
    fy = (map_v & (one - 1)).to(torch.float32) / one
    acc = None
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xx, yy = sx + dx, sy + dy
            inside = (xx >= 0) & (xx < ws) & (yy >= 0) & (yy < hs)
            at = (torch.clamp(yy, 0, hs - 1) * ws
                  + torch.clamp(xx, 0, ws - 1)).reshape(-1)
            tap = src[at] * inside.reshape(-1, 1)
            tap = tap * (wy * wx).reshape(-1, 1)
            acc = tap if acc is None else acc + tap
    out = torch.round(acc).clamp(0, 65535).to(torch.int32).to(torch.uint16)
    return out.reshape(*map_u.shape, *img.shape[2:])


def undistort(img: torch.Tensor, k, d, new_k) -> torch.Tensor:
    """cv2.undistort(img, k, d, None, new_k) for uint8 or uint16 [H, W] or
    [H, W, C] on img's device: the same layout, size and dtype."""
    if img.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"undistort takes uint8 or uint16, got {img.dtype}")
    h, w = img.shape[0], img.shape[1]
    mu, mv = undistort_map(k, d, new_k, (w, h), img.device)
    if img.dtype == torch.uint16:
        return remap_linear_u16(img, mu, mv)
    return remap_linear_u8(img, mu, mv)


def resize_stored(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, (w, h)) with INTER_LINEAR in the image's stored
    depth (uint8 or uint16), as the JAX package resizes a view before it
    divides by 255."""
    if img.dtype == torch.uint16:
        return resize_linear_u16(img, out_hw)
    return resize_linear_u8(img, out_hw)


# ---------------------------------------------------------------- files

# leading bytes of formats cv2.imread reads and the port does not
OTHER_FORMATS = ((b"BM", "BMP"),
                 (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
                 (b"\xff\x4f\xff\x51", "JPEG 2000"),
                 (b"P1", "PBM"), (b"P2", "PGM"), (b"P3", "PPM"),
                 (b"P4", "PBM"), (b"P5", "PGM"), (b"P6", "PPM"),
                 (b"Pf", "PFM"), (b"PF", "PFM"), (b"#?RADIANCE", "HDR"),
                 (b"#?RGBE", "HDR"))
JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe")
TIFF_EXTENSIONS = (".tif", ".tiff")
READ = ("PNG (every colour type and depth), baseline and progressive JPEG "
        "and TIFF")


def image_format(path) -> str:
    """"png", "jpeg" or "tiff" from the file's leading bytes; anything else
    raises NotImplementedError naming the file and, where known, its
    format."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head[:4] in TIFF_SIGNATURES:
        return "tiff"
    kind = next((k for sig, k in OTHER_FORMATS if head.startswith(sig)), None)
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        kind = "WebP"
    if head[4:8] == b"ftyp" and head[8:12] in (b"avif", b"avis"):
        kind = "AVIF"
    raise NotImplementedError(
        f"{path}: {'a ' + kind + ' image' if kind else 'an unknown format'} "
        f"(leading bytes {head[:8].hex()}); the port reads {READ}")


def read_image(path, device="cuda") -> torch.Tensor:
    """cv2.imread(path, IMREAD_UNCHANGED) in RGB(A) order: uint8 or (16-bit
    PNG and TIFF) uint16 [H, W] or [H, W, C] on ``device``, by the leading
    bytes."""
    dev = resolve_device(device)
    kind = image_format(path)
    if kind == "jpeg":
        return read_jpeg(path, dev)
    return torch.from_numpy(read_png(path) if kind == "png" else
                            read_tiff(path)).to(dev)


def write_image(path, img, device="cuda") -> None:
    """cv2.imwrite(path, img) of a uint8 or uint16 [H, W] or [H, W, C]
    image in RGB(A) order: PNG for .png and TIFF for .tif and .tiff (both
    keep 16 bits), baseline JPEG at quality 95 (encoded on ``device``) for
    .jpg, .jpeg and .jpe; any other extension raises."""
    ext = Path(path).suffix.lower()
    if ext in JPEG_EXTENSIONS:
        write_jpeg(path, img, device=device)
        return
    arr = img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if ext == ".png":
        write_png(path, arr)
    elif ext in TIFF_EXTENSIONS:
        write_tiff(path, arr)
    else:
        raise NotImplementedError(f"{path}: no writer for {ext or 'a name '
                                  'without extension'}; the port writes PNG, "
                                  "JPEG and TIFF")
