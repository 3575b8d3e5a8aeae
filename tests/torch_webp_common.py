"""Helpers shared by the WebP tests (a module, not a test file): photo-like
test images, cv2's lossy and lossless encodings, RIFF / VP8X / ALPH
builders for the chunk layouts cv2 does not write itself (ICCP and EXIF
chunks, raw alpha with each filter), a VP8 key-frame generator, and the
committed fixtures under tests/data/image/webp_* and the card's timing
file tests/data/webp/timing_800x800.webp (``make_webp_fixtures``; run
``PYTHONPATH=. python tests/torch_webp_common.py`` to write them).

The builders are test code, independent of the port's codec: what they
write is held to what ``cv2.imread(IMREAD_UNCHANGED)`` returns for it.
"""
import struct
from pathlib import Path

import numpy as np

from tests.torch_image_common import FIXTURES, cv2_read, pattern

# the card's timing file (no .npy: test_torch_webp.py holds it to cv2)
TIMING = FIXTURES.parent / "webp" / "timing_800x800.webp"


def photo(h, w, c=3, seed=0):
    """A photo-like uint8 image: smooth colour fields, edges and noise."""
    import cv2
    rng = np.random.RandomState(seed)
    coarse = rng.rand(max(h // 8, 1) + 2, max(w // 8, 1) + 2, c) * 255
    x = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    x = x.reshape(h, w, c) + rng.randn(h, w, c) * 10
    x[:, : w // 3] += 30 * (np.arange(h)[:, None, None] % 7 < 3)
    img = np.clip(x, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def cv2_webp(img, quality=None) -> bytes:
    """cv2.imencode(".webp") of an image in cv2's BGR(A) order: lossless
    without ``quality``, else lossy at that IMWRITE_WEBP_QUALITY."""
    import cv2
    params = [] if quality is None else [cv2.IMWRITE_WEBP_QUALITY, quality]
    ok, buf = cv2.imencode(".webp", img, params)
    assert ok
    return buf.tobytes()


def chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(w, h, flags) -> bytes:
    """A VP8X chunk: flags (0x10 alpha, 0x20 ICC, 0x08 EXIF, 0x04 XMP, 0x02
    animation) and the canvas."""
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def image_chunk(data: bytes):
    """(tag, payload) of a simple file's VP8 / VP8L chunk."""
    assert data[12:16] in (b"VP8 ", b"VP8L"), data[12:16]
    size = struct.unpack_from("<I", data, 16)[0]
    return data[12:16], data[20:20 + size]


def alpha_residuals(a: np.ndarray, filt: int) -> np.ndarray:
    """The ALPH filter's residuals of alpha plane ``a`` (0 none, 1
    horizontal, 2 vertical, 3 gradient; row 0 predicted from the left, the
    first column from above), as libwebp's filters compute them."""
    a = a.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if filt == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1],
                                   0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def fixture_files():
    """{file name: bytes} of the committed WebP fixtures, each written by
    cv2 (the VP8X one wraps cv2's lossy frame in ICCP, EXIF and XMP
    chunks)."""
    rgb = photo(21, 37, 3, 1)
    lossy = cv2_webp(rgb, 80)
    _, frame = image_chunk(lossy)
    rgba = photo(17, 23, 4, 2)
    rgba[..., 3] = np.clip(rgba[..., 3], 1, 255)
    pal = np.random.RandomState(3).randint(1, 256, (4, 4), np.uint8)
    rng = np.random.RandomState(4)
    files = {
        "webp_lossy_q80_37x21.webp": lossy,
        "webp_lossy_q5_1x45.webp": cv2_webp(photo(1, 45, 3, 5), 5),
        "webp_lossy_alpha_q60_23x17.webp": cv2_webp(rgba, 60),
        "webp_lossless_31x19.webp": cv2_webp(photo(19, 31, 3, 6)),
        "webp_lossless_gray_16x12.webp": cv2_webp(photo(12, 16, 1, 7)),
        "webp_lossless_rgba_pal4_13x9.webp": cv2_webp(
            pal[rng.randint(0, 4, (9, 13))]),
        "webp_vp8x_iccp_exif_37x21.webp": riff(
            vp8x(37, 21, 0x2C) + chunk(b"ICCP", rng.bytes(41))
            + chunk(b"VP8 ", frame)
            + chunk(b"EXIF", b"Exif\0\0" + rng.bytes(9))
            + chunk(b"XMP ", b"<x:xmpmeta/>")),
    }
    return files


def timing_file() -> bytes:
    """The 800x800 lossy file the card's decode is timed on."""
    return cv2_webp(pattern(800, 800, 3, 8), 75)


def make_webp_fixtures(out=FIXTURES):
    """Write each fixture and its <stem>.npy, cv2.imread's pixels in RGB(A)
    order, and the timing file."""
    out.mkdir(parents=True, exist_ok=True)
    for name, data in fixture_files().items():
        (out / name).write_bytes(data)
        np.save(out / f"{Path(name).stem}.npy", cv2_read(out / name))
    TIMING.parent.mkdir(parents=True, exist_ok=True)
    TIMING.write_bytes(timing_file())



# ------------------------------------------------- a VP8 frame generator
# cv2's encoder (libwebp at its defaults) never writes the simple loop
# filter, a sharpness, several token partitions, explicit segment features,
# loop-filter deltas or coefficient-probability updates; this writes key
# frames that use them, with random modes and coefficients, for the reader
# to be held to cv2 on. Its probability tables are RFC 6386's, read from the
# port's codec source (the cv2 comparisons of every lossy file hold them).

def _codec_table(name: str) -> np.ndarray:
    import re
    src = (Path(__file__).resolve().parent.parent / "nerfpp_tpu_torch"
           / "csrc" / "webp_codec.cpp").read_text()
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", src, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)])


class BoolWriter:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom = bytearray(), 255, 0
        self.bit_count = 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, n: int, v: int):
        for k in range(n - 1, -1, -1):
            self.put(128, (v >> k) & 1)

    def signed(self, n: int, v: int):
        self.literal(n, abs(v))
        self.put(128, int(v < 0))

    def optional(self, n: int, v, signed=True):
        self.put(128, int(v is not None))
        if v is not None:
            (self.signed if signed else self.literal)(n, v)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's sub-block mode order (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
# as paths through RFC 6386's tree: (probability index, bit)
BMODE_PATHS = (((0, 0),), ((0, 1), (1, 0)), ((0, 1), (1, 1), (2, 0)),
               ((0, 1), (1, 1), (2, 1), (3, 0), (4, 0)),
               ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)),
               ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)),
               ((0, 1), (1, 1), (2, 1), (3, 1), (6, 0)),
               ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)),
               ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)),
               ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)))
YMODE_BITS = {0: ((156, 0), (163, 0)), 2: ((156, 0), (163, 1)),
              3: ((156, 1), (128, 0)), 1: ((156, 1), (128, 1))}
UVMODE_BITS = {0: ((142, 0),), 2: ((142, 1), (114, 0)),
               1: ((142, 1), (114, 1), (183, 1)),
               3: ((142, 1), (114, 1), (183, 0))}


def _large(bw, p, v):
    if v <= 4:
        bw.put(p[3], 0)
        bw.put(p[4], int(v > 2))
        if v > 2:
            bw.put(p[5], v - 3)
    elif v <= 10:
        bw.put(p[3], 1)
        bw.put(p[6], 0)
        bw.put(p[7], int(v > 6))
        if v <= 6:
            bw.put(159, v - 5)
        else:
            bw.put(165, (v - 7) >> 1)
            bw.put(145, (v - 7) & 1)
    else:
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        bw.put(p[3], 1)
        bw.put(p[6], 1)
        bw.put(p[8], cat >> 1)
        bw.put(p[9 + (cat >> 1)], cat & 1)
        e, tab = v - (3 + (8 << cat)), CATS[cat]
        for k, prob in enumerate(tab):
            bw.put(prob, (e >> (len(tab) - 1 - k)) & 1)


def _tokens(bw, probs, ctx, first, coeffs):
    """One block's tokens (values in zigzag order); returns whether any
    coefficient from ``first`` on is non-zero."""
    nz = [n for n in range(first, 16) if coeffs[n]]
    n, p = first, probs[BANDS[first]][ctx]
    if not nz:
        bw.put(p[0], 0)
        return False
    while n <= nz[-1]:
        bw.put(p[0], 1)
        while coeffs[n] == 0:
            bw.put(p[1], 0)
            n += 1
            p = probs[BANDS[n]][0]
        bw.put(p[1], 1)
        v = abs(int(coeffs[n]))
        if v == 1:
            bw.put(p[2], 0)
            nxt = 1
        else:
            bw.put(p[2], 1)
            _large(bw, p, v)
            nxt = 2
        bw.put(128, int(coeffs[n] < 0))
        n += 1
        if n == 16:
            return True
        p = probs[BANDS[n]][nxt]
    bw.put(p[0], 0)
    return True


def vp8_frame(rng, w, h, simple=False, level=20, sharpness=0, parts=1,
              segments=None, lf_delta=None, skip_prob=None, updates=0.0,
              q=40, max_coeff=40) -> bytes:
    """A random VP8 key frame of w x h: ``segments`` (update_map,
    absolute, quantizers, filter strengths) or None; ``lf_delta`` (ref,
    mode deltas) or None; ``updates``, the share of coefficient
    probabilities updated; coefficients up to ``max_coeff`` in size (and
    at most 2,047 once dequantised)."""
    proba = _codec_table("kCoeffsProba0").reshape(4, 8, 3, 11).copy()
    upd = _codec_table("kCoeffsUpdateProba").reshape(4, 8, 3, 11)
    bmodes = _codec_table("kBModesProba").reshape(10, 10, 9)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    bw = BoolWriter()
    bw.literal(1, 0)                    # colour space
    bw.literal(1, 0)                    # clamping
    bw.literal(1, int(segments is not None))
    if segments is not None:
        update_map, absolute, quants, strengths = segments
        bw.literal(1, update_map)
        bw.literal(1, 1)
        bw.literal(1, absolute)
        for v in quants:
            bw.optional(7, v)
        for v in strengths:
            bw.optional(6, v)
        seg_probs = [int(rng.randint(1, 256)) for _ in range(3)]
        if update_map:
            for pr in seg_probs:
                bw.optional(8, pr, signed=False)
    bw.literal(1, int(simple))
    bw.literal(6, level)
    bw.literal(3, sharpness)
    bw.literal(1, int(lf_delta is not None))
    if lf_delta is not None:
        bw.literal(1, 1)
        for v in lf_delta[0] + lf_delta[1]:
            bw.optional(6, v)
    bw.literal(2, {1: 0, 2: 1, 4: 2, 8: 3}[parts])
    bw.literal(7, q)
    deltas = [int(rng.randint(-3, 4)) if rng.rand() < 0.5 else None
              for _ in range(5)]
    for v in deltas:
        bw.optional(4, v)
    # keep every dequantised coefficient within libwebp's 12-bit range, as
    # an encoder's are (its SIMD transforms assume it)
    dc_tab, ac_tab = _codec_table("kDcTable"), _codec_table("kAcTable")
    d1, d2, d3, d4, d5 = (v or 0 for v in deltas)
    qs = [q] if segments is None else [
        (v or 0) + (0 if segments[1] else q) for v in segments[2]]
    steps = [s_ for qq in qs for s_ in (
        dc_tab[np.clip(qq + d1, 0, 127)], ac_tab[np.clip(qq, 0, 127)],
        2 * dc_tab[np.clip(qq + d2, 0, 127)],
        ac_tab[np.clip(qq + d3, 0, 127)] * 155 // 100,
        dc_tab[np.clip(qq + d4, 0, 117)], ac_tab[np.clip(qq + d5, 0, 127)])]
    max_coeff = max(1, min(max_coeff, 2047 // int(max(steps))))
    bw.literal(1, 0)                    # refresh entropy probs
    for i in np.ndindex(proba.shape):
        change = rng.rand() < updates
        bw.put(int(upd[i]), int(change))
        if change:
            proba[i] = rng.randint(1, 256)
            bw.literal(8, int(proba[i]))
    bw.literal(1, int(skip_prob is not None))
    if skip_prob is not None:
        bw.literal(8, skip_prob)
    tbw = [BoolWriter() for _ in range(parts)]
    intra_t = [0] * (4 * mb_w)
    top_nz = [[0] * 9 for _ in range(mb_w)]      # 4 Y, 2 U, 2 V, DC
    for mby in range(mb_h):
        intra_l = [0] * 4
        left_nz = [0] * 9
        tok = tbw[mby % parts]
        for mbx in range(mb_w):
            if segments is not None and segments[0]:
                s = int(rng.randint(4))
                bw.put(seg_probs[0], s >> 1)
                bw.put(seg_probs[1 + (s >> 1)], s & 1)
            skip = skip_prob is not None and rng.rand() < 0.3
            if skip_prob is not None:
                bw.put(skip_prob, int(skip))
            i4x4 = rng.rand() < 0.5
            bw.put(145, int(not i4x4))
            top = intra_t[4 * mbx:4 * mbx + 4]
            if not i4x4:
                ymode = int(rng.randint(4))
                for prob, bit in YMODE_BITS[ymode]:
                    bw.put(prob, bit)
                top[:] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        mode = int(rng.randint(10))
                        p = bmodes[top[x], intra_l[y]]
                        for k, bit in BMODE_PATHS[mode]:
                            bw.put(int(p[k]), bit)
                        top[x] = intra_l[y] = mode
            intra_t[4 * mbx:4 * mbx + 4] = top
            for prob, bit in UVMODE_BITS[int(rng.randint(4))]:
                bw.put(prob, bit)
            tnz, lnz = top_nz[mbx], left_nz
            if skip:
                tnz[:8] = lnz[:8] = [0] * 8
                if not i4x4:
                    tnz[8] = lnz[8] = 0
                continue

            def block():
                c = np.zeros(16, np.int64)
                k = int(rng.randint(0, 17)) if rng.rand() < 0.8 else 0
                pos = rng.choice(16, k, replace=False)
                c[pos] = rng.randint(1, max_coeff + 1, k) * rng.choice(
                    [-1, 1], k)
                small = rng.rand(16) < 0.7
                c[small] = np.sign(c[small]) * np.minimum(abs(c[small]), 2)
                return c
            first = 0
            if not i4x4:
                nz = _tokens(tok, proba[1], tnz[8] + lnz[8], 0, block())
                tnz[8] = lnz[8] = int(nz)
                first = 1
            ytype = proba[0] if not i4x4 else proba[3]
            for y in range(4):
                for x in range(4):
                    nz = _tokens(tok, ytype, tnz[x] + lnz[y], first, block())
                    tnz[x] = lnz[y] = int(nz)
            for base in (4, 6):
                for y in range(2):
                    for x in range(2):
                        nz = _tokens(tok, proba[2],
                                     tnz[base + x] + lnz[base + y], 0, block())
                        tnz[base + x] = lnz[base + y] = int(nz)
    first_part = bw.finish()
    tokens = [t.finish() for t in tbw]
    tag = (1 << 4) | (len(first_part) << 5)
    head = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack(
        "<HH", w, h)
    sizes = b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
    return head + first_part + sizes + b"".join(tokens)


if __name__ == "__main__":
    make_webp_fixtures()
