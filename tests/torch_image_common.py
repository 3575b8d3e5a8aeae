"""Helpers shared by the image codec tests (a module, not a test file):
test images, cut progressive JPEGs, PNGs and TIFFs of every kind built
with zlib, struct and numpy, and the committed fixtures under
tests/data/image (see ``make_fixtures``).

``make_png`` and ``make_tiff`` write what the format allows, so that each
kind can be held to what ``cv2.imread(IMREAD_UNCHANGED)`` returns for it;
they are test code, independent of the port's readers.
"""
import struct
import zlib
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "data" / "image"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def pattern(h, w, c, seed=0):
    """A smooth image with noise, uint8 [h, w, c] (c = 1: [h, w])."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(xx / 7.0 + k) * np.cos(yy / 5.0 - k)
                    + rng.randn(h, w) * 20 for k in range(c)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def to_rgb(img):
    """cv2's BGR(A) order -> RGB(A) (gray unchanged)."""
    if img is None or img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


# ------------------------------------------------------------------ JPEG

def cut_scans(data: bytes, k: int) -> bytes:
    """The JPEG file cut after its k-th scan, EOI appended (the whole file
    when it has at most k scans)."""
    pos, n = 2, 0
    while True:
        marker = data[pos + 1]
        if marker == 0xD9:
            return data
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        pos += 2 + length
        if marker == 0xDA:
            n += 1
            while not (data[pos] == 0xFF and data[pos + 1] != 0
                       and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
            if n == k:
                return data[:pos] + b"\xff\xd9"


# ------------------------------------------------------------------- PNG

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(samples, depth):
    """Samples [h, n] -> packed rows [h, bytes], the first sample in the
    high bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    n = samples.shape[1]
    pad = np.zeros((h, -(-n // per) * per), np.uint8)
    pad[:, :n] = samples
    pad = pad.reshape(h, -1, per)
    out = np.zeros(pad.shape[:2], np.uint8)
    for i in range(per):
        out |= (pad[:, :, i] << (8 - depth * (i + 1))).astype(np.uint8)
    return out


def _filter(rows, bpp, kinds):
    """PNG's five row filters, forward."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r, k in zip(rows.astype(np.int32), kinds):
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])[:len(r)]
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:len(r)]
        if k == 1:
            f = r - left
        elif k == 2:
            f = r - prev
        elif k == 3:
            f = r - ((left + prev) >> 1)
        elif k == 4:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            f = r - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prev, ul))
        else:
            f = r
        out.append(bytes([int(k)]) + (f & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def make_png(samples, ctype, depth, plte=None, trns=None, interlace=0,
             seed=0):
    """A PNG of samples [h, w, channels in the file] (palette indices for
    colour type 3), each row with a random filter from ``seed``."""
    h, w, ch = samples.shape
    rng = np.random.RandomState(seed)
    bpp = max(1, depth * ch // 8)

    def body(s):
        if s.shape[0] == 0 or s.shape[1] == 0:
            return b""
        rows = _pack(s.reshape(s.shape[0], -1), depth)
        return _filter(rows, bpp, rng.randint(0, 5, rows.shape[0]))

    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(body(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


# ------------------------------------------------------------------ TIFF

def packbits(b: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(b)
    while i < n:
        j = i
        while j + 1 < n and b[j + 1] == b[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), b[i]])
            i = j + 1
            continue
        while j + 1 < n and j - i < 127 and not (j + 2 < n
                                                  and b[j + 1] == b[j + 2]):
            j += 1
        out += bytes([j - i]) + b[i:j + 1]
        i = j + 1
    return bytes(out)


def make_tiff(img, bo="<", comp=1, predictor=1, planar=1, tile=None,
              rows_per_strip=None, photometric=None, extra=None,
              colormap=None, version=42, extra_tags=()):
    """A TIFF of samples [h, w, spp] (uint8 or uint16): ``comp`` 1 (none),
    8 or 32946 (Deflate) or 32773 (PackBits), horizontal ``predictor`` 2,
    ``planar`` 2, ``tile`` (width, length) or strips of ``rows_per_strip``,
    the tags given; ``extra_tags`` [(tag, type, values)] added as they
    are."""
    h, w, spp = img.shape
    bits = img.itemsize * 8
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    dt = np.dtype(bo + ("u1" if bits == 8 else "u2"))

    def encode(a):
        a = a.astype(np.int64)
        if predictor == 2:
            d = a.copy()
            d[:, 1:] = a[:, 1:] - a[:, :-1]
            a = d % (1 << bits)
        raw = a.astype(dt).tobytes()
        if comp == 1:
            return raw
        if comp in (8, 32946):
            return zlib.compress(raw)
        rb = a.shape[1] * a.shape[2] * dt.itemsize
        return b"".join(packbits(raw[i:i + rb])
                        for i in range(0, len(raw), rb))

    planes = [img] if planar == 1 else [img[..., k:k + 1] for k in range(spp)]
    chunks = []
    for p in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), img.dtype)
                    b = p[ty:ty + th, tx:tx + tw]
                    t[:b.shape[0], :b.shape[1]] = b
                    chunks.append(encode(t))
        else:
            for y in range(0, h, rows_per_strip or h):
                chunks.append(encode(p[y:y + (rows_per_strip or h)]))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [comp]), (262, 3, [photometric]), (277, 3, [spp]),
               (284, 3, [planar])] + list(extra_tags)
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra is not None:
        entries.append((338, 3, list(extra)))
    if colormap is not None:
        entries.append((320, 3, [int(v) for v in colormap.reshape(-1)]))
    if tile:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, 4, None),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 4, None), (278, 4, [rows_per_strip or h]),
                    (279, 4, [len(c) for c in chunks])]
    entries.sort(key=lambda e: e[0])
    magic = b"II" if bo == "<" else b"MM"
    out = bytearray(magic + struct.pack(bo + "H", version) + b"\0" * 4)
    offsets = []
    for c in chunks:
        offsets.append(len(out))
        out += c + b"\0" * (len(c) % 2)
    ifd = len(out)
    ext_at = ifd + 2 + 12 * len(entries) + 4
    ents, ext = bytearray(), bytearray()
    for tag, typ, vals in entries:
        vals = offsets if vals is None else vals
        data = struct.pack(f"{bo}{len(vals)}{'H' if typ == 3 else 'I'}",
                           *vals)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", ext_at + len(ext))
            ext += data + b"\0" * (len(data) % 2)
        ents += struct.pack(bo + "HHI", tag, typ, len(vals)) + field
    out += struct.pack(bo + "H", len(entries)) + ents + b"\0" * 4 + ext
    out[4:8] = struct.pack(bo + "I", ifd)
    return bytes(out)


# -------------------------------------------------------------- fixtures

def cv2_read(path):
    """cv2.imread(IMREAD_UNCHANGED) in RGB(A) order."""
    import cv2
    return to_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def fixture_files():
    """{file name: bytes} of the committed fixtures: progressive JPEGs
    (cv2.imencode, whole and cut), PNG kinds and TIFF variants (built
    here), and prog_source.jpg, cv2's progressive encoding of
    prog_source.npy."""
    import cv2
    files = {}
    rgb = pattern(21, 27, 3, 1)
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                            cv2.IMWRITE_JPEG_QUALITY, 90])
    prog = buf.tobytes()
    files["prog_420_21x27.jpg"] = prog
    for k in (5, 7, 9):
        files[f"prog_420_21x27_cut{k}.jpg"] = cut_scans(prog, k)
    ok, buf = cv2.imencode(".jpg", pattern(13, 11, 1, 3),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    files["prog_gray_rst_13x11.jpg"] = buf.tobytes()
    files["prog_gray_rst_13x11_cut3.jpg"] = cut_scans(buf.tobytes(), 3)
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(
        prog_source()[..., ::-1]), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    files["prog_source.jpg"] = buf.tobytes()
    rng = np.random.RandomState(7)
    pal = rng.randint(0, 256, (6, 3))
    files["png_palette4_trns.png"] = make_png(
        rng.randint(0, 6, (9, 13, 1)), 3, 4, pal, bytes([0, 90, 200]), 0, 1)
    files["png_gray2_adam7.png"] = make_png(
        rng.randint(0, 4, (11, 10, 1)), 0, 2, interlace=1, seed=2)
    rgb16 = rng.randint(0, 65536, (7, 9, 3))
    files["png_rgb16_trns.png"] = make_png(
        rgb16, 2, 16, trns=struct.pack(">3H", *rgb16[0, 0]), seed=3)
    files["png_gray_alpha16_adam7.png"] = make_png(
        rng.randint(0, 65536, (10, 9, 2)), 4, 16, interlace=1, seed=4)
    files["png_rgba8.png"] = make_png(rng.randint(0, 256, (8, 12, 4)), 6, 8,
                                      seed=5)
    img16 = rng.randint(0, 65536, (10, 11, 3)).astype(np.uint16)
    files["tif_be_tiled_deflate_rgb16.tif"] = make_tiff(
        img16, ">", 8, 2, tile=(16, 16))
    img8 = pattern(9, 14, 3, 8)
    files["tif_planar_packbits_rgb8.tif"] = make_tiff(img8, comp=32773,
                                                      planar=2,
                                                      rows_per_strip=4)
    files["tif_miniswhite_gray8.tif"] = make_tiff(
        pattern(9, 7, 1, 9)[..., None], photometric=0)
    cmap = rng.randint(0, 65536, (3, 256)).astype(np.uint16)
    files["tif_palette8.tif"] = make_tiff(
        rng.randint(0, 256, (6, 8, 1)).astype(np.uint8), photometric=3,
        colormap=cmap)
    files["tif_rgba_unassoc8.tif"] = make_tiff(
        rng.randint(0, 256, (5, 6, 4)).astype(np.uint8), comp=8, predictor=2,
        extra=(2,))
    return files


def prog_source():
    """The image of the progressive encoding fixture (RGB)."""
    return pattern(19, 23, 3, 5)


def make_fixtures(out=FIXTURES):
    """Write each fixture file and <stem>.npy, cv2.imread's pixels in
    RGB(A) order (prog_source.npy: the image that prog_source.jpg
    encodes)."""
    out.mkdir(parents=True, exist_ok=True)
    for name, data in fixture_files().items():
        (out / name).write_bytes(data)
        stem = Path(name).stem
        np.save(out / f"{stem}.npy", prog_source() if stem == "prog_source"
                else cv2_read(out / name))


if __name__ == "__main__":
    make_fixtures()
