"""Helpers shared by the WebP tests (a module, not a test file): photo-like
test images, cv2's lossy and lossless encodings, RIFF / VP8X / ALPH /
ANIM / ANMF builders for the chunk layouts cv2 does not write itself (ICCP
and EXIF chunks, raw alpha with each filter, first frames at an offset),
images with fully transparent pixels for each transform libwebp's
analysis picks, a VP8 key-frame generator, and the committed fixtures
under tests/data/image/webp_*, the card's timing file
tests/data/webp/timing_800x800.webp and the transparent and animated
files tests/data/webp/{transparent,anim}_* with the 4,000 x 3,000
upscale's digest (``make_webp_fixtures``; run ``PYTHONPATH=. python
tests/torch_webp_common.py`` to write them).

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


# ------------------------------------- transparent pixels and animations

def alpha_mask(h, w, kind, seed=0) -> np.ndarray:
    """Where an image is fully transparent (bool [h, w]): "holes" (three
    rectangles), "ring", "border" (a frame two pixels wide and the top
    quarter), "masked" (all but a disc of a quarter of the short side, as
    a masked object capture) or "scatter" (30 % of the pixels)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.hypot(yy - (h - 1) / 2, xx - (w - 1) / 2)
    r = min(h, w) / 2
    if kind == "holes":
        m = np.zeros((h, w), bool)
        for _ in range(3):
            y0, x0 = rng.randint(0, h), rng.randint(0, w)
            m[y0:y0 + max(h // 4, 1), x0:x0 + max(w // 3, 1)] = True
        return m
    if kind == "ring":
        return (d > 0.4 * r) & (d < 0.8 * r)
    if kind == "border":
        return (yy < 2) | (xx < 2) | (yy >= h - 2) | (xx >= w - 2) \
            | (yy < h // 4)
    if kind == "masked":
        return d > r / 2
    if kind == "scatter":
        return rng.rand(h, w) < 0.3
    raise ValueError(kind)


def transparent_image(h, w, content, mask, seed=0) -> np.ndarray:
    """An RGBA uint8 image [h, w, 4] of ``content`` with alpha 0 over
    ``alpha_mask(h, w, mask)`` (random colours under it, which libwebp
    drops) and alpha 255 or, for "noise", random elsewhere: "noise" (four
    random channels), "noise3" (three), "photo", "gray" (a ramp shared by
    the channels plus noise of 0-2), "palette" (12 colours) or "ramp" (a
    ramp of at most 256 colours)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.full((h, w), 255)
    if content == "noise":
        rgb = rng.randint(0, 256, (h, w, 3))
        alpha = rng.randint(1, 256, (h, w))
    elif content == "noise3":
        rgb = rng.randint(0, 256, (h, w, 3))
    elif content == "photo":
        rgb = photo(h, w, 3, seed)
    elif content == "gray":
        rgb = ((xx + yy) * 3)[..., None] + rng.randint(0, 3, (h, w, 3))
    elif content == "palette":
        pal = rng.randint(0, 256, (12, 3))
        rgb = pal[(xx // 3 + yy // 2 + rng.randint(0, 2, (h, w))) % 12]
    elif content == "ramp":
        rgb = ((xx + yy) % 80 * 3)[..., None] + rng.randint(0, 3, (h, w, 1)) \
            + np.array([0, 7, 21])
    else:
        raise ValueError(content)
    img = np.dstack([rgb, alpha]).clip(0, 255).astype(np.uint8)
    m = alpha_mask(h, w, mask, seed)
    img[m, 3] = 0
    img[m, :3] = rng.randint(0, 256, (int(m.sum()), 3))
    return img


def bgra(img) -> np.ndarray:
    """RGB(A) -> cv2's BGR(A) order."""
    return np.ascontiguousarray(img[..., [2, 1, 0, 3]] if img.shape[2] == 4
                                else img[..., ::-1])


# (content, mask, h, w, seed, the transform libwebp picks) of the committed
# transparent files: each transform once, and the predictor also over
# palette-sized tiles (an image of at most 256 colours that libwebp codes
# without its palette)
TRANSPARENT_CASES = (
    ("noise", "ring", 25, 31, 0, "none"),
    ("noise3", "holes", 21, 17, 1, "subtract green"),
    ("photo", "ring", 33, 40, 2, "predictor"),
    ("gray", "ring", 70, 64, 9, "subtract green + predictor"),
    ("palette", "holes", 20, 30, 4, "palette"),
    ("ramp", "ring", 19, 16, 5, "subtract green + predictor"))

# the 800x800 masked view and its 4,000 x 3,000 upscale (``upscale``), whose
# cv2 pixels the card is held to by digest
TRANSPARENT_VIEW = FIXTURES.parent / "webp" / "transparent_view_800x800.webp"
UPSCALE_DIGEST = FIXTURES.parent / "webp" / "transparent_4000x3000.sha256"


def transparent_fixture_files():
    """{file name: bytes} of cv2.imwrite's lossless RGBA files of images
    with fully transparent pixels, one for each transform libwebp's
    analysis picks (tests/data/webp/transparent_*; the card holds the
    port's rewrite of each to cv2's pixels)."""
    files = {}
    for content, mask, h, w, seed, _ in TRANSPARENT_CASES:
        img = transparent_image(h, w, content, mask, seed)
        files[f"transparent_{content}_{mask}_{w}x{h}.webp"] = cv2_webp(
            bgra(img))
    files[TRANSPARENT_VIEW.name] = transparent_view_file()
    return files


def transparent_view_file() -> bytes:
    """cv2.imwrite's file of the 800x800 masked view."""
    return cv2_webp(bgra(transparent_image(800, 800, "photo", "masked", 9)))


def upscale(view: np.ndarray) -> np.ndarray:
    """An RGBA view resized to 4,000 x 3,000 by the port's resize_linear_u8
    (the card's resize is bitwise the CPU's), in cv2's BGRA order: as
    uint32 [3000, 4000], libwebp's ARGB."""
    import torch

    from nerfpp_tpu_torch.utils.image import resize_linear_u8
    big = resize_linear_u8(torch.from_numpy(bgra(view)), (3000, 4000))
    return big.numpy().view(np.uint32)[..., 0]


def upscale_digest(view: np.ndarray) -> str:
    """The SHA-256 of cv2.imread's pixels (BGRA, the bytes of libwebp's
    ARGB) of cv2.imwrite's .webp of ``upscale(view)``."""
    import hashlib

    import cv2
    big = upscale(view).view(np.uint8).reshape(3000, 4000, 4)
    back = cv2.imdecode(np.frombuffer(cv2_webp(big), np.uint8),
                        cv2.IMREAD_UNCHANGED)
    return hashlib.sha256(back.tobytes()).hexdigest()


def anmf(x2, y2, w, h, flags, payload, duration=100) -> bytes:
    """An ANMF chunk: the offset halved as stored, the size the header
    states, the duration, the blend / dispose bits and the frame's
    chunks."""
    return chunk(b"ANMF", b"".join(v.to_bytes(3, "little") for v in (
        x2, y2, w - 1, h - 1, duration)) + bytes([flags]) + payload)


def anim(background=0, loops=0) -> bytes:
    return chunk(b"ANIM", struct.pack("<IH", background, loops))


def still_chunks(data: bytes):
    """{tag: chunk} of a still file's ALPH, VP8 and VP8L chunks."""
    out, pos = {}, 12
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            out[tag] = chunk(tag, data[pos + 8:pos + 8 + size])
        pos += 8 + size + (size & 1)
    return out


def cv2_animation(frames, quality=None) -> bytes:
    """cv2.imencodeanimation(".webp") of BGR(A) frames, 100 ms each (lossy
    at its default quality without ``quality``)."""
    import cv2
    a = cv2.Animation()
    a.frames, a.durations = list(frames), [100] * len(frames)
    params = [] if quality is None else [cv2.IMWRITE_WEBP_QUALITY, quality]
    ok, buf = cv2.imencodeanimation(".webp", a, params)
    assert ok
    return buf.tobytes()


def pillow_animation(frames, lossless) -> bytes:
    """Pillow's save_all WebP of RGB(A) frames, 100 ms each."""
    import io

    from PIL import Image
    ims = [Image.fromarray(f) for f in frames]
    bio = io.BytesIO()
    ims[0].save(bio, "WEBP", save_all=True, append_images=ims[1:],
                lossless=lossless, duration=100)
    return bio.getvalue()


def anim_fixture_files():
    """{file name: bytes} of animated WebP files (tests/data/webp/anim_*):
    cv2.imwriteanimation's and Pillow's, lossy and lossless, opaque and
    with alpha, and first frames neither writes, assembled here around
    payloads cv2 wrote as stills: an offset sub-rectangle on a canvas with
    a background colour, an odd stored offset, a lossy frame with ALPH."""
    f1, f2 = photo(20, 24, 4, 11), photo(20, 24, 4, 12)
    f1[..., 3] = np.clip(f1[..., 3], 1, 255)
    small = photo(9, 13, 4, 13)
    small[..., 3] = np.clip(small[..., 3], 1, 255)
    lossy = still_chunks(cv2_webp(bgra(small[..., :3]), 70))[b"VP8 "]
    with_alpha = still_chunks(cv2_webp(bgra(small), 70))
    lossless = still_chunks(cv2_webp(bgra(small)))[b"VP8L"]
    return {
        "anim_cv2_lossy_alpha_24x20.webp": cv2_animation(
            [bgra(f1), bgra(f2)]),
        "anim_cv2_lossless_rgb_24x20.webp": cv2_animation(
            [bgra(f1[..., :3]), bgra(f2[..., :3])], 101),
        "anim_pil_lossy_rgb_24x20.webp": pillow_animation(
            [f1[..., :3], f2[..., :3]], False),
        "anim_pil_lossless_rgba_24x20.webp": pillow_animation([f1, f2],
                                                              True),
        "anim_offset_lossy_40x30.webp": riff(
            vp8x(40, 30, 0x02) + anim(0xFF336699, 3)
            + anmf(3, 5, 13, 9, 0, lossy) + anmf(0, 0, 13, 9, 2, lossy)),
        "anim_odd_offset_lossless_rgba_40x30.webp": riff(
            vp8x(40, 30, 0x12) + anim(0x80FFFFFF)
            + anmf(1, 7, 13, 9, 3, lossless)),
        "anim_alph_lossy_20x12.webp": riff(
            vp8x(20, 12, 0x12) + anim()
            + anmf(2, 1, 13, 9, 1, with_alpha[b"ALPH"] + with_alpha[b"VP8 "])
            + anmf(0, 0, 13, 9, 0, lossy)),
    }


def make_webp_fixtures(out=FIXTURES):
    """Write each fixture and its <stem>.npy, cv2.imread's pixels in RGB(A)
    order, the timing file, the transparent and animated files (with their
    .npy, but for the 800x800 view's) and the upscale's digest."""
    out.mkdir(parents=True, exist_ok=True)
    for name, data in fixture_files().items():
        (out / name).write_bytes(data)
        np.save(out / f"{Path(name).stem}.npy", cv2_read(out / name))
    TIMING.parent.mkdir(parents=True, exist_ok=True)
    TIMING.write_bytes(timing_file())
    for name, data in {**transparent_fixture_files(),
                       **anim_fixture_files()}.items():
        (TIMING.parent / name).write_bytes(data)
        if name != TRANSPARENT_VIEW.name:
            np.save(TIMING.parent / f"{Path(name).stem}.npy",
                    cv2_read(TIMING.parent / name))
    UPSCALE_DIGEST.write_text(upscale_digest(cv2_read(TRANSPARENT_VIEW))
                              + "\n")



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
