"""Helpers shared by the image I/O tests, tests/test_torch_io.py,
tests/test_torch_io_filters.py and tests/test_torch_io_load.py (a module,
not a test file): test images, a PNG's row filters, a PNG written with
given row filters, cv2's channel order, the row-filter check and the tiny
Blender scene.
"""
import struct
import zlib

import cv2
import numpy as np

from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils.png import png_shape, read_png


def _image(h, w, c, seed):
    """Smooth gradients, a sharp edge and noise: libpng's adaptive
    filtering picks several row filters on it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3 + 40 * k) % 256 for k in range(c)], -1)
    base[h // 3:, w // 2:] = rng.randint(0, 256, (h - h // 3, w - w // 2, c))
    return base.astype(np.uint8)


def _filters_of(path):
    """The row filter bytes of a PNG written as one IDAT stream."""
    h, w, c = png_shape(path)
    data = path.read_bytes()
    idat = b""
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, 1 + w * c)[:, 0]


def _write_filtered(path, img, kinds):
    """A PNG whose row r is filtered with kinds[r] (0 none, 1 Sub, 2 Up,
    3 Average, 4 Paeth), computed from the original pixels."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, c = img.shape
    pad = np.zeros((h + 1, w + 1, c), np.int16)
    pad[1:, 1:] = img
    a, b, cc = pad[1:, :-1], pad[:-1, 1:], pad[:-1, :-1]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(a), a, b, (a + b) >> 1, paeth]
    rows = b"".join(
        bytes([k]) + ((img[r].astype(np.int16) - preds[k][r]) & 0xFF)
        .astype(np.uint8).tobytes() for r, k in enumerate(kinds))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    ctype = {1: 0, 3: 2, 4: 6}[c]
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows))
                     + chunk(b"IEND", b""))


def _cv2_rgb(img):
    """RGB(A) -> the BGR(A) order cv2 reads and writes."""
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[-1]]]


ROW_FILTERS = [0, 1, 2, 3, 4, "mixed"]


def reader_undoes_every_row_filter(tmp_path, kind, channels):
    """A PNG of each row filter (or of a mix) reads as cv2 reads it and
    gives the image it encodes."""
    img = _image(23, 17, channels, 7)
    kinds = (np.random.RandomState(3).randint(0, 5, 23) if kind == "mixed"
             else [kind] * 23)
    path = tmp_path / "f.png"
    _write_filtered(path, img, kinds)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(_cv2_rgb(ref), want)
    np.testing.assert_array_equal(read_png(path), want)


def _scene(channels=3):
    sc = make_synthetic_scene(n_train=3, n_val=1, n_test=2, image_hw=24,
                              n_samples=16, white_bkgr=False, device="cpu")
    if channels == 4:
        # an alpha that varies over the image, so compositing matters
        alpha = np.linspace(0.0, 1.0, 24 * 24, dtype=np.float32)
        alpha = np.broadcast_to(alpha.reshape(1, 24, 24, 1),
                                sc.images.shape[:3] + (1,))
        sc.images = np.concatenate([sc.images, alpha], -1)
    return sc
