"""Helpers shared by the image codec tests (a module, not a test file):
test images, cut progressive JPEGs, PNGs, TIFFs, BMPs (with RLE8 / RLE4
streams), PAMs, PFMs, Radiance HDRs and Sun rasters of every kind built
with zlib, struct and numpy, JPEG 2000 files from cv2 and Pillow, CCITT
fax TIFFs from Pillow's libtiff and scripts/fax_kinds.py, GIFs from cv2,
Pillow and scripts/gif_kinds.py, and the
committed fixtures under tests/data/image (see ``make_fixtures``; run
``PYTHONPATH=. python tests/torch_image_common.py`` to write them).

The builders write what each format allows, so that each kind can be held
to what ``cv2.imread(IMREAD_UNCHANGED)`` returns for it; they are test
code, independent of the port's readers.
"""
import io
import struct
import tempfile
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
    """cv2's BGR(A) order -> RGB(A) (gray and gray-alpha unchanged)."""
    if img is None or img.ndim == 2 or img.shape[2] == 2:
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


def lzw_old_style(data: bytes) -> bytes:
    """Old-style LZW, as libtiff 4.0 and earlier wrote compression 5: Clear,
    the codes least significant bit first, each as wide as the decoder
    then reads (an entry a code but the first after a Clear, the width
    raised once the next free entry passes the widest code), a Clear before
    the table fills, EOI."""
    out, acc, n_acc = bytearray(), 0, 0
    state = {"free": 258, "bits": 9, "count": 0}

    def put(code, clear=False):
        nonlocal acc, n_acc
        acc |= code << n_acc
        n_acc += state["bits"]
        while n_acc >= 8:
            out.append(acc & 255)
            acc >>= 8
            n_acc -= 8
        if clear:
            state.update(free=258, bits=9, count=0)
            return
        state["count"] += 1
        if state["count"] >= 2:
            state["free"] += 1
            if state["free"] > (1 << state["bits"]) - 1:
                state["bits"] = min(state["bits"] + 1, 12)

    put(256, clear=True)
    table = {bytes([i]): i for i in range(256)}
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = 258 + len(table) - 256
        w = bytes([c])
        if len(table) >= 4093:
            put(table[w])
            put(256, clear=True)
            table = {bytes([i]): i for i in range(256)}
            w = b""
    if w:
        put(table[w])
    put(257)
    if n_acc:
        out.append(acc & 255)
    return bytes(out)


def _float_predict(a):
    """TIFF's floating-point predictor forward on a chunk [rows, cols,
    per]: each row's samples as byte planes, the most significant first,
    differenced byte by byte at a stride of ``per``."""
    rows, cols, per = a.shape
    out = []
    for r in a:
        b = r.astype(r.dtype.newbyteorder(">")).view(np.uint8).reshape(
            cols * per, a.itemsize).T.reshape(-1).astype(np.int64)
        d = b.copy()
        d[per:] = b[per:] - b[:-per]
        out.append((d % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def pack_bits(samples, bits):
    """Integer samples [rows, n] -> rows of ``bits``-bit samples packed
    most significant bit first, each row padded to a whole byte."""
    rows, n = samples.shape
    shifts = np.arange(bits - 1, -1, -1)
    b = (samples.astype(np.uint64)[..., None] >> shifts.astype(np.uint64)) & 1
    b = b.reshape(rows, n * bits).astype(np.uint8)
    return np.packbits(b, axis=1).tobytes()


# field type -> struct code of one value (5 and 10: a numerator and a
# denominator)
TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h",
              9: "i", 10: "i", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}


def _field(bo, typ, vals):
    if isinstance(vals, (bytes, bytearray)):
        return len(vals), bytes(vals)
    n = len(vals) // 2 if typ in (5, 10) else len(vals)
    return n, struct.pack(f"{bo}{len(vals)}{TIFF_TYPES[typ]}", *vals)


def make_tiff(img, bo="<", comp=1, predictor=1, planar=1, tile=None,
              rows_per_strip=None, photometric=None, extra=None,
              colormap=None, version=42, extra_tags=(), sample_format=None,
              bits=None, chunks=None, fill_order=1, orientation=None):
    """A TIFF of samples [h, w, spp] (any integer or float dtype, its
    SampleFormat written unless it is unsigned): ``comp`` 1 (none), 5
    (LZW, through the port's encoder), 8 or 32946 (Deflate) or 32773
    (PackBits), horizontal ``predictor`` 2 or floating-point 3, ``planar``
    2, ``tile`` (width, length) or strips of ``rows_per_strip``, the tags
    given; ``extra_tags`` [(tag, type, values)] added as they are (values
    bytes for types 1 and 7, numerator-denominator pairs for 5).
    ``version`` 43 writes a BigTIFF (8-byte offsets, LONG8 strip and tile
    fields). ``bits`` packs samples of fewer or more bits than the dtype's
    (1, 2, 4, 10, 12, 14) into rows, most significant bit first;
    ``chunks`` gives each strip's or tile's bytes as stored (JPEG,
    subsampled YCbCr), ``img`` then giving only the sizes; ``fill_order``
    2 reverses the bits of every stored byte and writes the tag;
    ``orientation`` writes the tag."""
    h, w, spp = img.shape
    if bits is None:
        bits = img.itemsize * 8
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    if sample_format is None:
        sample_format = {"u": 1, "i": 2, "f": 3}[img.dtype.kind]
    dt = np.dtype(f"{bo}u{img.itemsize}")

    def encode(a):
        if bits != img.itemsize * 8:
            raw = pack_bits(a.reshape(a.shape[0], -1), bits)
        elif predictor == 3:
            raw = _float_predict(a)
        else:
            u = a.view(f"u{a.itemsize}")
            if predictor == 2:
                d = u.copy()
                d[:, 1:] = u[:, 1:] - u[:, :-1]
                u = d
            raw = u.astype(dt).tobytes()
        if comp == 1:
            return raw
        if comp == 5:
            from nerfpp_tpu_torch.utils.tiff import lzw_encode
            return lzw_encode(raw)
        if comp in (8, 32946):
            return zlib.compress(raw)
        rb = len(raw) // a.shape[0]
        return b"".join(packbits(raw[i:i + rb])
                        for i in range(0, len(raw), rb))

    planes = [img] if planar == 1 else [img[..., k:k + 1] for k in range(spp)]
    if chunks is None:
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
    if fill_order == 2:
        rev = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)
        rev = np.packbits(rev[:, ::-1], axis=1)[:, 0]
        chunks = [rev[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    big = version == 43
    word = 16 if big else 4
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [comp]), (262, 3, [photometric]), (277, 3, [spp]),
               (284, 3, [planar])] + list(extra_tags)
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if sample_format != 1:
        entries.append((339, 3, [sample_format] * spp))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra is not None:
        entries.append((338, 3, list(extra)))
    if colormap is not None:
        entries.append((320, 3, [int(v) for v in colormap.reshape(-1)]))
    if tile:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]]),
                    (324, word, None), (325, word, [len(c) for c in chunks])]
    else:
        entries += [(273, word, None), (278, 4, [rows_per_strip or h]),
                    (279, word, [len(c) for c in chunks])]
    entries.sort(key=lambda e: e[0])
    magic = b"II" if bo == "<" else b"MM"
    if big:
        out = bytearray(magic + struct.pack(bo + "HHH", 43, 8, 0) + bytes(8))
    else:
        out = bytearray(magic + struct.pack(bo + "H", version) + b"\0" * 4)
    offsets = []
    for c in chunks:
        offsets.append(len(out))
        out += c + b"\0" * (len(c) % 2)
    ifd = len(out)
    inline, count, size = (8, "Q", 20) if big else (4, "I", 12)
    ext_at = ifd + (8 if big else 2) + size * len(entries) + inline
    ents, ext = bytearray(), bytearray()
    for tag, typ, vals in entries:
        n, data = _field(bo, typ, offsets if vals is None else vals)
        if len(data) <= inline:
            field = data.ljust(inline, b"\0")
        else:
            field = struct.pack(bo + count, ext_at + len(ext))
            ext += data + b"\0" * (len(data) % 2)
        ents += struct.pack(bo + "HH" + count, tag, typ, n) + field
    out += (struct.pack(bo + ("Q" if big else "H"), len(entries))
            + ents + b"\0" * inline + ext)
    if big:
        out[8:16] = struct.pack(bo + "Q", ifd)
    else:
        out[4:8] = struct.pack(bo + "I", ifd)
    return bytes(out)


def fax_image(rng, h, w, p_same=0.0):
    """A bilevel image uint8 [h, w] of 0 / 1 runs of every length class
    (1-3, up to 80, up to 300, up to 2,700 pixels: terminating, make-up and
    extended make-up codes); each row after the first is its upper
    neighbour with probability ``p_same`` (vertical and pass modes)."""
    img = np.zeros((h, w), np.uint8)
    for y in range(h):
        if y and rng.rand() < p_same:
            img[y] = img[y - 1]
            continue
        x, c = 0, rng.rand() < 0.5
        while x < w:
            n = int(rng.choice([1, 2, 3, rng.randint(1, 80),
                                rng.randint(60, 300),
                                rng.randint(1700, 2700)]))
            img[y, x:x + n] = c
            c, x = not c, x + n
    return img


def pillow_fax(bits, compression, **tiffinfo):
    """Pillow's libtiff TIFF of a bilevel image (uint8 [h, w] of 0 / 1, 1
    white in the image) with ``compression`` "tiff_ccitt", "group3" or
    "group4" and the given tags (T4Options 292, FillOrder 266,
    RowsPerStrip 278, Photometric 262)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(bits.astype(bool)).convert("1").save(
        buf, "TIFF", compression=compression,
        tiffinfo={int(k): v for k, v in tiffinfo.items()})
    return buf.getvalue()


def fax_tiff(bits, comp, encode, tile=None, rows_per_strip=None, **kw):
    """A CCITT TIFF of a bilevel image (uint8 [h, w]) with each strip or
    tile coded by ``encode`` (scripts/fax_kinds.py), tiles zero-padded."""
    h, w = bits.shape
    chunks = []
    for y, x, rows, cols in boxes_of(h, w, rows_per_strip, tile):
        box = np.zeros((rows, cols), np.uint8)
        part = bits[y:y + rows, x:x + cols]
        box[:part.shape[0], :part.shape[1]] = part
        chunks.append(encode(box))
    return make_tiff(bits[..., None], comp=comp, bits=1, chunks=chunks,
                     tile=tile, rows_per_strip=rows_per_strip, **kw)


def sgilog_rows(words, planes):
    """SGILog data (tif_luv.c's run-length coding) of rows of LogL (2 byte
    planes) or LogLuv (4) words: each row's byte planes, most significant
    first, as literal runs of at most 127 bytes."""
    out = bytearray()
    for row in np.asarray(words, np.uint64):
        for k in range(planes - 1, -1, -1):
            b = ((row >> np.uint64(8 * k)) & np.uint64(255)).astype(
                np.uint8).tobytes()
            for i in range(0, len(b), 127):
                out += bytes([len(b[i:i + 127])]) + b[i:i + 127]
    return bytes(out)


def split_jpeg(stream: bytes):
    """A whole JPEG stream -> (tables, abbreviated): SOI, its DQT and DHT
    segments and EOI, as a JPEG-in-TIFF's JPEGTables holds them, and the
    stream without them, as libtiff writes each strip or tile."""
    tables, rest, pos = [stream[:2]], [stream[:2]], 2
    while True:
        marker = stream[pos + 1]
        (length,) = struct.unpack(">H", stream[pos + 2:pos + 4])
        seg = stream[pos:pos + 2 + length]
        (tables if marker in (0xC4, 0xDB) else rest).append(seg)
        pos += 2 + length
        if marker == 0xDA:
            return (b"".join(tables) + b"\xff\xd9",
                    b"".join(rest) + stream[pos:])


def ycbcr_units(rng, h, w, hs, vs, boxes):
    """Random YCbCr data units for each (y, x, rows, cols) box: hs x vs
    luma bytes, then Cb and Cr, row by row of units, partial units at the
    right and bottom kept whole. Returns the chunks and the full-resolution
    uint8 Y, Cb, Cr [h, w, 3] that libtiff's RGBA reader spreads them to."""
    ycc = np.zeros((h, w, 3), np.uint8)
    chunks = []
    for y0, x0, rows, cols in boxes:
        down, across = -(-rows // vs), -(-cols // hs)
        u = rng.randint(0, 256, (down, across, hs * vs + 2)).astype(np.uint8)
        chunks.append(u.tobytes())
        luma = u[..., :hs * vs].reshape(down, across, vs, hs).transpose(
            0, 2, 1, 3).reshape(down * vs, across * hs)
        rr, cc = min(rows, h - y0), min(cols, w - x0)
        ycc[y0:y0 + rr, x0:x0 + cc, 0] = luma[:rr, :cc]
        for k in (1, 2):
            full = np.repeat(np.repeat(u[..., hs * vs + k - 1], vs, 0), hs, 1)
            ycc[y0:y0 + rr, x0:x0 + cc, k] = full[:rr, :cc]
    return chunks, ycc


def boxes_of(h, w, rows_per_strip=None, tile=None):
    """Each strip's or tile's (y, x, rows, cols) box, in the file's order
    (a last strip cut to the image, tiles whole)."""
    if tile:
        tw, th = tile
        return [(y, x, th, tw) for y in range(0, h, th)
                for x in range(0, w, tw)]
    rps = rows_per_strip or h
    return [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]


# ------------------------------------------------------------------- BMP

def make_bmp(w, h, bpp, pixels, header=40, comp=0, palette=None,
             clrused=0, masks=None, top_down=False):
    """A BMP of the given pixel data (rows as stored, padded): ``header``
    12 (OS/2, a 3-byte palette), 40, 108 or 124; ``comp`` 0 (RGB), 1
    (RLE8), 2 (RLE4) or 3 (BITFIELDS, ``masks`` (R, G, B[, A]) after a
    40-byte header, inside a larger one); ``palette`` [(B, G, R)];
    ``top_down`` a negative height."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bpp, comp, len(pixels), 2835, 2835, clrused, 0)
        if header > 40 and masks:
            info += struct.pack("<4I", *(list(masks) + [0])[:4])
        info = info.ljust(header, b"\0")
    extra = (struct.pack("<3I", *masks[:3]) if masks and header == 40
             else b"")
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(map(int, p[:3])) + (b"" if header == 12
                                                 else b"\0")
                       for p in palette)
    off = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info
            + extra + pal + pixels)


def bmp_rows(idx, bpp):
    """Palette indices or samples [h, w(, c)] -> bottom-up rows as BMP
    stores them (1, 4, 8, 16 (uint16 samples), 24 or 32 bits), each padded
    to 4 bytes."""
    rows = []
    for r in idx[::-1]:
        if bpp == 1:
            b = np.packbits(r.astype(np.uint8)).tobytes()
        elif bpp == 4:
            r = np.concatenate([r, np.zeros(len(r) % 2, r.dtype)])
            b = ((r[0::2] << 4) | r[1::2]).astype(np.uint8).tobytes()
        elif bpp == 16:
            b = r.astype("<u2").tobytes()
        else:
            b = r.astype(np.uint8).tobytes()
        rows.append(b + b"\0" * (-len(b) % 4))
    return b"".join(rows)


def bmp_rle(w, h, bits, rng, ops=None):
    """A random RLE8 (``bits`` 8) or RLE4 (4) stream for a w x h bitmap:
    runs, literals, end-of-line, deltas (dx + dy * w pixels skipped) and,
    now and then, an early end-of-bitmap; ``ops`` limits the kinds used.
    Each line is ended by an end-of-line; runs and literals stay within
    their line. The decode is what cv2 makes of it."""
    ops = ops or ("run", "literal", "eol", "delta")
    out, x, y = bytearray(), 0, 0
    top = 255 if bits == 8 else 15
    while y < h:
        op = ops[rng.randint(len(ops))]
        room = w - x
        if op == "eol" or room == 0:
            out += b"\0\0"
            x, y = 0, y + 1
            if y < h and rng.rand() < 0.03:
                break
        elif op == "run":
            n = rng.randint(1, min(room, 255) + 1)
            out += bytes([n, rng.randint(0, 256) if bits == 4
                          else rng.randint(top + 1)])
            x += n
        elif op == "literal" and room >= 3:
            n = rng.randint(3, min(room, 255) + 1)
            vals = rng.randint(0, top + 1, n)
            if bits == 4:
                vals = np.concatenate([vals, np.zeros(n % 2, vals.dtype)])
                vals = (vals[0::2] << 4) | vals[1::2]
            data = vals.astype(np.uint8).tobytes()
            out += bytes([0, n]) + data + b"\0" * (len(data) % 2)
            x += n
        elif op == "delta":
            dx = rng.randint(0, room)
            dy = rng.randint(0, 2) if y + 1 < h else 0
            out += bytes([0, 2, dx, dy])
            x, y = x + dx, y + dy
    return bytes(out + b"\0\1")


# ------------------------------------------------- PAM, PFM, HDR, Sun raster

def make_pam(samples, maxval, tupltype=None, extra=""):
    """A PAM of samples [h, w, depth] as stored (big-endian above 255)."""
    h, w, d = samples.shape
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {d}\nMAXVAL {maxval}\n"
            + (f"TUPLTYPE {tupltype}\n" if tupltype else "") + extra
            + "ENDHDR\n")
    body = (samples.astype(">u2") if maxval > 255
            else samples.astype(np.uint8)).tobytes()
    return head.encode() + body


def make_pfm(img, scale=-1.0, header=None):
    """A PFM of float32 [h, w] or [h, w, 3] (RGB), little-endian when the
    scale is negative, rows bottom-up."""
    h, w = img.shape[:2]
    kind = "f" if img.ndim == 2 else "F"
    head = header or f"P{kind}\n{w} {h}\n{scale}\n".encode()
    bo = "<" if float(scale) < 0 else ">"
    return head + img[::-1].astype(bo + "f4").tobytes()


def hdr_rle_plane(b, rng):
    """One byte plane of a new-style scanline as runs and literals chosen
    at random (a valid coding, not rgbe.cpp's)."""
    out, i = bytearray(), 0
    while i < len(b):
        j = i
        while j + 1 < len(b) and b[j + 1] == b[i] and j - i < 126:
            j += 1
        if j > i and rng.rand() < 0.8:
            out += bytes([128 + j - i + 1, b[i]])
            i = j + 1
        else:
            n = rng.randint(1, min(128, len(b) - i) + 1)
            out += bytes([n]) + bytes(b[i:i + n])
            i += n
    return bytes(out)


def make_hdr(rgbe, rng=None, flat_from=None, header=None):
    """A Radiance HDR of RGBE bytes [h, w, 4]: new-style run-length
    scanlines (when ``rng`` is given and 8 <= w <= 32767), flat from row
    ``flat_from`` on."""
    h, w = rgbe.shape[:2]
    head = header or (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                      + f"-Y {h} +X {w}\n".encode())
    body = bytearray()
    for y in range(h):
        if rng is None or (flat_from is not None and y >= flat_from):
            body += rgbe[y].tobytes()
            continue
        body += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            body += hdr_rle_plane(rgbe[y, :, c].tobytes(), rng)
    return head + bytes(body)


def make_sunras(w, h, bpp, pixels, typ=1, cmap=None):
    """A Sun raster of rows as stored; ``cmap`` [3, n] (R, G, B planes) as
    an RMT_EQUAL_RGB colour map."""
    cm = b"" if cmap is None else np.asarray(cmap, np.uint8).tobytes()
    return (struct.pack(">8I", 0x59A66A95, w, h, bpp, len(pixels), typ,
                        0 if cmap is None else 1, len(cm)) + cm + pixels)


def sunras_rows(samples, bpp):
    """Indices or bytes [h, w(, c)] -> rows padded to an even length."""
    rows = []
    for r in samples:
        b = (np.packbits(r.astype(np.uint8)).tobytes() if bpp == 1
             else r.astype(np.uint8).tobytes())
        rows.append(b + b"\0" * (len(b) % 2))
    return b"".join(rows)


# -------------------------------------------------------------- fixtures

def cv2_read(path):
    """cv2.imread(IMREAD_UNCHANGED) in RGB(A) order."""
    import cv2
    return to_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def fixture_files():
    """{file name: bytes} of the committed fixtures: progressive JPEGs
    (cv2.imencode, whole and cut), PNG kinds and TIFF variants (built
    here), prog_source.jpg, cv2's progressive encoding of prog_source.npy,
    ``raw_fixture_files`` and ``tiff_kind_fixture_files``."""
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
    files.update(raw_fixture_files())
    files.update(tiff_kind_fixture_files())
    files.update(tiff_closed_fixture_files())
    files.update(jpeg2000_fixture_files())
    files.update(gif_fixture_files())
    return files


def cv2_jp2(img, params=()) -> bytes:
    """cv2.imencode(".jp2") of an image in cv2's BGR(A) order."""
    import cv2
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(img), list(params))
    assert ok
    return buf.tobytes()


def pillow_jp2(img, mode=None, **options) -> bytes:
    """Pillow's JPEG 2000 of an RGB(A) or gray image (``mode``: converted to
    it first), with Pillow's save options."""
    from PIL import Image
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **options)
    return buf.getvalue()


def codestream(jp2: bytes) -> bytes:
    """The codestream of a JP2 file (its jp2c box's payload)."""
    pos = 12
    while True:
        size, kind = struct.unpack(">I4s", jp2[pos:pos + 8])
        if kind == b"jp2c":
            return jp2[pos + 8:pos + size] if size else jp2[pos + 8:]
        pos += size


def jpeg2000_fixture_files():
    """{file name: bytes} of the JPEG 2000 fixtures: cv2.imwrite's own at
    its defaults (RGB, RGBA, 16-bit gray), lossless, and the RGB file's
    codestream alone (.j2k); Pillow's with the options cv2 never writes:
    9/7 with MCT in 32 x 32 tiles, PCRL, 16 x 16 precincts, 8 x 8
    code-blocks, 3 resolutions, 2 rate layers, PLT and COM; 9/7 without
    MCT in RPCL with dB layers, as a raw codestream; YCbCr (sYCC) in CPRL;
    16-bit gray in RLCP with precincts and 3 rate layers."""
    rgb = pattern(33, 40, 3, 31)
    files = {"jp2_cv2_rgb_40x33.jp2": cv2_jp2(rgb[..., ::-1])}
    files["jp2_cv2_codestream_40x33.j2k"] = codestream(
        files["jp2_cv2_rgb_40x33.jp2"])
    rgba = np.dstack([pattern(32, 33, 3, 32), pattern(32, 33, 1, 33)])
    files["jp2_cv2_rgba_33x32.jp2"] = cv2_jp2(rgba[..., [2, 1, 0, 3]])
    gray16 = (pattern(45, 37, 1, 34).astype(np.uint16) * 257
              + np.random.RandomState(34).randint(0, 257, (45, 37))
              ).astype(np.uint16)
    files["jp2_cv2_gray16_37x45.jp2"] = cv2_jp2(gray16)
    import cv2
    files["jp2_cv2_lossless_gray_36x32.jp2"] = cv2_jp2(
        pattern(32, 36, 1, 35), [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
    files["jp2_pil_97_tiles_pcrl_45x39.jp2"] = pillow_jp2(
        pattern(39, 45, 3, 36), irreversible=True, tile_size=(32, 32),
        progression="PCRL", precinct_size=(16, 16), codeblock_size=(8, 8),
        num_resolutions=3, quality_mode="rates", quality_layers=[12, 4],
        plt=True, comment="nerfpp_tpu fixture")
    files["jp2_pil_97_nomct_rpcl_db_29x34.j2k"] = pillow_jp2(
        pattern(34, 29, 3, 37), irreversible=True, mct=0, progression="RPCL",
        quality_mode="dB", quality_layers=[30, 40], no_jp2=True)
    files["jp2_pil_ycbcr_cprl_31x26.jp2"] = pillow_jp2(
        pattern(26, 31, 3, 38), "YCbCr", progression="CPRL")
    files["jp2_pil_gray16_rlcp_27x30.jp2"] = pillow_jp2(
        gray16[:30, :27].copy(), progression="RLCP", precinct_size=(8, 8),
        num_resolutions=3, quality_mode="rates", quality_layers=[20, 8, 2])
    return files


def tiff_kind_fixture_files():
    """{file name: bytes} of the TIFF kinds beyond the baseline, one a
    kind: BigTIFF, JPEG-in-TIFF (cv2.imwrite's own, whole streams in
    tiles, abbreviated gray strips), YCbCr, CMYK, gray with alpha at 8 and
    16 bits, bilevel with FillOrder 2, 1- and 4-bit palettes, 12- and
    14-bit samples and Orientation 2 and 3."""
    import cv2
    files = {}
    rng = np.random.RandomState(17)
    files["tiff_bigtiff_be_lzw_rgb8_19x13.tif"] = make_tiff(
        pattern(13, 19, 3, 17), ">", 5, version=43, rows_per_strip=4)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cv2.tif"
        cv2.imwrite(str(path), pattern(37, 45, 3, 18),
                    [cv2.IMWRITE_TIFF_COMPRESSION, 7])
        files["tiff_jpeg_cv2_rgb_45x37.tif"] = path.read_bytes()
    img = pattern(37, 45, 3, 19)
    chunks = []
    for y, x, rows, cols in boxes_of(37, 45, tile=(16, 16)):
        box = np.zeros((16, 16, 3), np.uint8)
        part = img[y:y + rows, x:x + cols]
        box[:part.shape[0], :part.shape[1]] = part
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(box[..., ::-1]))
        chunks.append(buf.tobytes())
    files["tiff_jpeg_ycbcr420_tiles_45x37.tif"] = make_tiff(
        img, comp=7, photometric=6, tile=(16, 16), chunks=chunks,
        extra_tags=[(530, 3, [2, 2])])
    gray = pattern(29, 23, 1, 20)
    streams = [split_jpeg(cv2.imencode(".jpg", gray[y:y + 16])[1].tobytes())
               for y in (0, 16)]
    files["tiff_jpeg_gray_tables_23x29.tif"] = make_tiff(
        gray[..., None], ">", 7, rows_per_strip=16,
        chunks=[s for _, s in streams], extra_tags=[(347, 7, streams[0][0])])
    boxes = boxes_of(13, 11, rows_per_strip=4)
    chunks, _ = ycbcr_units(rng, 13, 11, 2, 1, boxes)
    files["tiff_ycbcr422_strips_11x13.tif"] = make_tiff(
        np.zeros((13, 11, 3), np.uint8), photometric=6, chunks=chunks,
        rows_per_strip=4, extra_tags=[(530, 3, [2, 1]), (532, 5, [
            v for r in (16, 235, 128, 240, 128, 240) for v in (r, 1)])])
    chunks, _ = ycbcr_units(rng, 21, 35, 4, 2, boxes_of(21, 35, tile=(16, 16)))
    files["tiff_ycbcr42_tiles_35x21.tif"] = make_tiff(
        np.zeros((21, 35, 3), np.uint8), ">", photometric=6, chunks=chunks,
        tile=(16, 16), extra_tags=[(530, 3, [4, 2])])
    files["tiff_cmyk_planar_9x7.tif"] = make_tiff(
        rng.randint(0, 256, (7, 9, 4)).astype(np.uint8), comp=8, planar=2,
        photometric=5, rows_per_strip=3)
    files["tiff_gray_alpha8_tiles_21x19.tif"] = make_tiff(
        rng.randint(0, 256, (19, 21, 2)).astype(np.uint8), photometric=0,
        extra=(2,), tile=(16, 16))
    files["tiff_gray_alpha16_13x6.tif"] = make_tiff(
        rng.randint(0, 65536, (6, 13, 2)).astype(np.uint16), ">", 5,
        photometric=1, extra=(1,))
    files["tiff_bilevel_fillorder2_13x11.tif"] = make_tiff(
        rng.randint(0, 2, (11, 13, 1)).astype(np.uint8), comp=32773,
        photometric=0, bits=1, fill_order=2, rows_per_strip=5)
    files["tiff_palette1_9x5.tif"] = make_tiff(
        rng.randint(0, 2, (5, 9, 1)).astype(np.uint8), photometric=3, bits=1,
        colormap=rng.randint(0, 65536, (3, 2)).astype(np.uint16))
    files["tiff_palette4_7x6.tif"] = make_tiff(
        rng.randint(0, 16, (6, 7, 1)).astype(np.uint8), photometric=3, bits=4,
        colormap=rng.randint(0, 65536, (3, 16)).astype(np.uint16))
    files["tiff_gray12_lzw_11x7.tif"] = make_tiff(
        rng.randint(0, 4096, (7, 11, 1)).astype(np.uint16), ">", 5, bits=12,
        rows_per_strip=3)
    files["tiff_rgb14_tiles_19x17.tif"] = make_tiff(
        rng.randint(0, 16384, (17, 19, 3)).astype(np.uint16), bits=14,
        tile=(16, 16))
    files["tiff_orientation3_tiles_45x37.tif"] = make_tiff(
        pattern(37, 45, 3, 21), comp=8, orientation=3, tile=(16, 16))
    files["tiff_orientation2_rgb16_9x8.tif"] = make_tiff(
        rng.randint(0, 65536, (8, 9, 3)).astype(np.uint16), ">",
        orientation=2)
    return files


def tiff_closed_fixture_files():
    """{file name: bytes} of the TIFF kinds read since TIFF was closed:
    CCITT Modified Huffman (MinIsWhite), word-aligned RLEW, Group 3
    two-dimensional with fill bits (Pillow's libtiff), Group 4 with
    FillOrder 2 (Pillow's) and in tiles; CIE L*a*b* of 8 bits (LZW,
    predictor 2, a D65 WhitePoint), 16 bits (big-endian tiles) and
    Pillow's LAB; uint64 gray and int64 RGB; YCbCr 4x4 in strips and tiles
    (libtiff's truncated scanline and tile skew); planar YCbCr and palette
    JPEG-in-TIFF; LogL and LogLuv under SGILog; a ThunderScan 4-bit
    palette."""
    from scripts.fax_kinds import encode_g4, encode_rle
    rng = np.random.RandomState(21)
    files = {}
    bits = fax_image(rng, 11, 19)
    files["tiff_rle_miniswhite_19x11.tif"] = fax_tiff(
        bits, 2, encode_rle, rows_per_strip=6, photometric=0)
    files["tiff_rlew_33x9.tif"] = fax_tiff(
        fax_image(rng, 9, 33), 32771, lambda b: encode_rle(b, word=True),
        photometric=0)
    files["tiff_g3_2d_fill_41x23.tif"] = pillow_fax(
        fax_image(rng, 23, 41, 0.5), "group3", **{"292": 5, "278": 8})
    files["tiff_g4_fillorder2_37x29.tif"] = pillow_fax(
        fax_image(rng, 29, 37, 0.5), "group4", **{"266": 2})
    files["tiff_g4_tiles_45x37.tif"] = fax_tiff(
        fax_image(rng, 37, 45, 0.5), 4, encode_g4, tile=(16, 16),
        photometric=0)
    lab8 = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    files["tiff_lab8_lzw_d65_23x17.tif"] = make_tiff(
        lab8, comp=5, predictor=2, photometric=8, rows_per_strip=5,
        extra_tags=[(318, 5, [3127, 10000, 3290, 10000])])
    lab16 = rng.randint(0, 65536, (19, 21, 3)).astype(np.uint16)
    files["tiff_lab16_tiles_be_21x19.tif"] = make_tiff(
        lab16, ">", 8, photometric=8, tile=(16, 16))
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (9, 13, 3)).astype(np.uint8),
                    "LAB").save(buf, "TIFF")
    files["tiff_lab_pillow_13x9.tif"] = buf.getvalue()
    files["tiff_uint64_gray_9x7.tif"] = make_tiff(
        rng.randint(0, 2 ** 63, (7, 9, 1)).astype(np.uint64) * 2 + 1)
    files["tiff_int64_rgb_lzw_7x5.tif"] = make_tiff(
        rng.randint(-2 ** 63, 2 ** 63, (5, 7, 3), dtype=np.int64), ">", 5, 2)
    chunks, _ = ycbcr_units(rng, 13, 11, 4, 4, boxes_of(13, 11, 8))
    files["tiff_ycbcr44_strips_11x13.tif"] = make_tiff(
        np.zeros((13, 11, 3), np.uint8), photometric=6, chunks=chunks,
        rows_per_strip=8, extra_tags=[(530, 3, [4, 4])])
    chunks, _ = ycbcr_units(rng, 21, 40, 4, 4, boxes_of(21, 40, tile=(16, 16)))
    files["tiff_ycbcr44_tiles_40x21.tif"] = make_tiff(
        np.zeros((21, 40, 3), np.uint8), ">", photometric=6, chunks=chunks,
        tile=(16, 16), extra_tags=[(530, 3, [4, 4])])
    import cv2
    img = pattern(16, 24, 3, 22)
    files["tiff_jpeg_planar_ycbcr_24x16.tif"] = make_tiff(
        img, comp=7, planar=2, photometric=6,
        chunks=[cv2.imencode(".jpg", img[..., k])[1].tobytes()
                for k in range(3)], extra_tags=[(530, 3, [1, 1])])
    idx = pattern(16, 16, 1, 23)
    files["tiff_jpeg_palette_16x16.tif"] = make_tiff(
        idx[..., None], comp=7, photometric=3,
        colormap=rng.randint(0, 65536, (3, 256)).astype(np.uint16),
        chunks=[cv2.imencode(".jpg", idx)[1].tobytes()])
    words = rng.randint(0, 65536, (11, 29)).astype(np.uint32)
    words[:, 3:17] = words[:, 3:4]
    files["tiff_logl_sgilog_29x11.tif"] = make_tiff(
        np.zeros((11, 29, 1), np.int16), photometric=32844, comp=34676,
        rows_per_strip=6, chunks=[sgilog_rows(words[:6], 2),
                                  sgilog_rows(words[6:], 2)])
    words = rng.randint(0, 2 ** 32, (6, 11), dtype=np.uint64)
    files["tiff_logluv_sgilog_11x6.tif"] = make_tiff(
        np.zeros((6, 11, 3), np.uint16), photometric=32845, comp=34676,
        sample_format=2, chunks=[sgilog_rows(words, 4)])
    files["tiff_thunderscan_pal4_12x7.tif"] = make_tiff(
        np.zeros((7, 12, 1), np.uint8), comp=32809, bits=4, photometric=3,
        colormap=rng.randint(0, 65536, (3, 16)).astype(np.uint16),
        chunks=[bytes([0xc3, 0x4d, 0x8a, 0x05, 0xc9, 0x81, 0x06]) * 7])
    return files


def hdr_image(h, w, seed):
    """Radiance-like float32 [h, w, 3]: a smooth image times a wide
    exposure range, some pixels black."""
    rng = np.random.RandomState(seed)
    img = pattern(h, w, 3, seed).astype(np.float32) / 255
    img *= np.exp(rng.randn(h, w, 1) * 3).astype(np.float32)
    img[rng.rand(h, w) < 0.1] = 0
    return img


def raw_fixture_files():
    """{file name: bytes} of the uncompressed, run-length and float
    fixtures: BMP kinds, PBM / PGM / PPM / PAM / PFM, Radiance HDR, Sun
    raster and signed and float TIFF, built here."""
    files = {}
    rng = np.random.RandomState(11)
    pal = rng.randint(0, 256, (256, 3))
    files["bmp_rle8_13x10.bmp"] = make_bmp(
        13, 10, 8, bmp_rle(13, 10, 8, rng), comp=1, palette=pal,
        clrused=256)
    files["bmp_rle4_11x9.bmp"] = make_bmp(
        11, 9, 4, bmp_rle(11, 9, 4, rng), comp=2, palette=pal[:16],
        clrused=16)
    files["bmp_os2_pal4_7x5.bmp"] = make_bmp(
        7, 5, 4, bmp_rows(rng.randint(0, 16, (5, 7)), 4), header=12,
        palette=pal[:16])
    files["bmp_v5_1010102_6x4.bmp"] = make_bmp(
        6, 4, 32, bmp_rows(rng.randint(0, 256, (4, 6, 4)), 32), header=124,
        comp=3, masks=(0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000))
    files["bmp_565_9x3.bmp"] = make_bmp(
        9, 3, 16, bmp_rows(rng.randint(0, 65536, (3, 9)), 16), comp=3,
        masks=(0xF800, 0x7E0, 0x1F))
    files["bmp_topdown_gray1_10x3.bmp"] = make_bmp(
        10, 3, 1, bmp_rows(rng.randint(0, 2, (3, 10))[::-1], 1),
        palette=[(0, 0, 0), (200, 200, 200)], clrused=2, top_down=True)
    files["pbm_ascii_5x3.pbm"] = (b"P1\n# a comment\n5 3\n"
                                  + b"1 0 1 1 0\n0 0 1 0 1\n11100\n")
    files["pgm_ascii_maxval100_4x3.pgm"] = b"P2\n4 3\n100\n" + " ".join(
        str(v) for v in rng.randint(0, 110, 12)).encode() + b"\n"
    files["ppm_16_5x4.ppm"] = b"P6\n5 4\n65535\n" + rng.randint(
        0, 65536, 60).astype(">u2").tobytes()
    files["pam_rgba16_4x3.pam"] = make_pam(
        rng.randint(0, 1001, (3, 4, 4)), 1000, "RGB_ALPHA")
    files["pam_bw_9x2.pam"] = make_pam(rng.randint(0, 256, (2, 9, 1)), 1)
    files["pfm_be_scale2_6x5.pfm"] = make_pfm(hdr_image(5, 6, 1), 2.0)
    files["pfm_gray_7x4.pfm"] = make_pfm(hdr_image(4, 7, 2)[..., 1], -1.0)
    rgbe = rng.randint(0, 256, (6, 17, 4)).astype(np.uint8)
    rgbe[:, 3:11] = rgbe[:, 3:4]
    files["hdr_rle_17x6.hdr"] = make_hdr(rgbe, rng, flat_from=4)
    files["hdr_flat_5x3.hdr"] = make_hdr(rgbe[:3, :5])
    cmap = rng.randint(0, 256, (3, 200))
    files["ras_pal8_7x5.ras"] = make_sunras(
        7, 5, 8, sunras_rows(rng.randint(0, 256, (5, 7)), 8), cmap=cmap)
    files["ras_32_5x3.ras"] = make_sunras(
        5, 3, 32, sunras_rows(rng.randint(0, 256, (3, 5, 4)), 32))
    files["ras_1bit_gray_11x3.ras"] = make_sunras(
        11, 3, 1, sunras_rows(rng.randint(0, 2, (3, 11)), 1),
        cmap=[[10, 240]] * 3)
    files["tif_float32_pred3_9x7.tif"] = make_tiff(
        hdr_image(7, 9, 3), comp=8, predictor=3)
    files["tif_float64_lzw_pred2_5x4.tif"] = make_tiff(
        hdr_image(4, 5, 4).astype(np.float64), ">", 5, 2, rows_per_strip=2)
    files["tif_int16_tiles_20x18.tif"] = make_tiff(
        rng.randint(-32768, 32768, (18, 20, 3)).astype(np.int16), comp=8,
        predictor=2, tile=(16, 16))
    files["tif_int8_miniswhite_6x5.tif"] = make_tiff(
        rng.randint(-128, 128, (5, 6, 1)).astype(np.int8), photometric=0)
    files["tif_int32_packbits_4x3.tif"] = make_tiff(
        rng.randint(-2 ** 31, 2 ** 31, (3, 4, 1)).astype(np.int32), comp=32773)
    return files


def prog_source():
    """The image of the progressive encoding fixture (RGB)."""
    return pattern(19, 23, 3, 5)


def cv2_gif(img) -> bytes:
    """cv2.imencode(".gif") of an RGB(A) image at its defaults."""
    import cv2
    bgr = img[..., [2, 1, 0, 3][:img.shape[2]]]
    ok, buf = cv2.imencode(".gif", np.ascontiguousarray(bgr))
    assert ok
    return buf.tobytes()


def pillow_gif(frames, mode, palette=None, **options) -> bytes:
    """Pillow's GIF of the uint8 arrays ``frames``, gray ("L"), RGB or
    palette indices ("P", with ``palette``'s RGB triples), the first frame
    saved with the rest appended."""
    from PIL import Image
    ims = []
    for f in frames:
        a = np.ascontiguousarray(f, np.uint8)
        im = Image.frombytes(mode, (a.shape[1], a.shape[0]), a.tobytes())
        if palette is not None:
            im.putpalette(np.asarray(palette, np.uint8).tobytes())
        ims.append(im)
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", save_all=len(ims) > 1, append_images=ims[1:],
                **options)
    return buf.getvalue()


def disc_alpha(h, w, frac=0.4):
    """255 on a centred disc of ``frac`` of the short side, 0 off it."""
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - (h - 1) / 2, xx - (w - 1) / 2)
    return np.where(r <= frac * min(h, w), 255, 0).astype(np.uint8)


def gif_write_inputs():
    """{stem: seeded RGB(A) input} of the writer's fixtures: RGB, RGBA
    with alpha 0 off a disc (the transparent index), RGBA never 0 (read
    back with 3 channels), uint16 (converted as cv2's convertTo does)."""
    rgba = np.dstack([pattern(40, 52, 3, 31), disc_alpha(40, 52)])
    opaque = np.dstack([pattern(24, 30, 3, 32),
                        np.full((24, 30), 128, np.uint8)])
    u16 = pattern(20, 25, 3, 33).astype(np.uint16) * 3
    return {"gifw_rgb_48x64": pattern(48, 64, 3, 30),
            "gifw_rgba_disc_52x40": rgba, "gifw_rgba_opaque_30x24": opaque,
            "gifw_u16_25x20": u16}


def gif_fixture_files():
    """{file name: bytes} of the GIF fixtures: cv2.imwrite's files of
    ``gif_write_inputs`` (gifw_*), Pillow's palette, interlaced L and
    animated transparent files, and scripts/gif_kinds.py's kinds (a local
    table on a small offset first frame, GIF87a with a deferred clear, a
    2-bit code stream without a leading clear and with the transparent
    index unused, a frame of codes past 4,095 with clears)."""
    from scripts import gif_kinds as G
    files = {f"{stem}.gif": cv2_gif(img)
             for stem, img in gif_write_inputs().items()}
    rng = np.random.RandomState(22)
    files["gif_pillow_p_17x13.gif"] = pillow_gif(
        [rng.randint(0, 200, (13, 17))], "P",
        palette=rng.randint(0, 256, (200, 3)))
    files["gif_pillow_l_interlaced_20x17.gif"] = pillow_gif(
        [pattern(17, 20, 1, 34)], "L", interlace=True)
    anim = [pattern(9, 13, 3, 35), pattern(9, 13, 3, 35)]
    anim[1][2:5, 3:8] = pattern(3, 5, 3, 36)
    # Pillow codes the second frame's unchanged pixels as transparent
    files["gif_pillow_anim_13x9.gif"] = pillow_gif(anim, "RGB", duration=50,
                                                   loop=0)
    pal = rng.randint(0, 256, (16, 3))
    files["gif_kinds_offset_local_9x11.gif"] = G.make_gif(
        9, 11, [G.frame(rng.randint(0, 8, (6, 5)), left=2, top=3,
                        local=rng.randint(0, 256, (8, 3)),
                        extensions=[G.graphic_control(2, transparent=3)])],
        palette=pal, background=5)
    files["gif_kinds_87a_deferred_70x60.gif"] = G.make_gif(
        70, 60, [G.frame(rng.randint(0, 256, (60, 70)), defer_clear=True)],
        palette=rng.randint(0, 256, (256, 3)), version=b"87a")
    files["gif_kinds_2bit_noclear_12x7.gif"] = G.make_gif(
        12, 7, [G.frame(rng.randint(0, 4, (7, 12)), clear_first=False,
                        interlace=True,
                        extensions=[G.comment(b"no clear"),
                                    G.graphic_control(transparent=9)])],
        palette=pal[:4])
    files["gif_kinds_codes_4095_96x80.gif"] = G.make_gif(
        96, 80, [G.frame(rng.randint(0, 64, (80, 96)),
                         extensions=[G.netscape(), G.graphic_control(1)])],
        palette=rng.randint(0, 256, (64, 3)))
    return files


def make_fixtures(out=FIXTURES):
    """Write each fixture file and <stem>.npy, cv2.imread's pixels in
    RGB(A) order (prog_source.npy: the image that prog_source.jpg
    encodes), and each GIF writer input as <stem>.input.npy."""
    out.mkdir(parents=True, exist_ok=True)
    for name, data in fixture_files().items():
        (out / name).write_bytes(data)
        stem = Path(name).stem
        np.save(out / f"{stem}.npy", prog_source() if stem == "prog_source"
                else cv2_read(out / name))
    for stem, img in gif_write_inputs().items():
        np.save(out / f"{stem}.input.npy", img)


if __name__ == "__main__":
    make_fixtures()
