"""The portable formats: PBM, PGM and PPM (P1-P6), PAM (P7) and PFM, read
and written as OpenCV 5.0's grfmt_pxm.cpp, grfmt_pam.cpp and
grfmt_pfm.cpp read and write them (numpy; no image library).
tests/test_torch_pxm.py holds both directions to cv2.

- ``read_pxm`` (P1-P6, ASCII and binary, ``#`` comments): a number ends
  at its first non-digit byte, which is consumed, so binary samples begin
  one byte after the header's last number. PBM gives 0 for a set bit and
  255 for a clear one; ASCII samples are clamped to maxval and, at 8 bits,
  scaled by 255 / maxval (integer division); binary 8-bit samples are kept
  as stored, whatever the maxval; a maxval above 255 gives big-endian
  uint16 samples, kept as stored (clamped to maxval in ASCII). PGM gives
  [H, W], PPM [H, W, 3] in RGB order.
- ``read_pam`` (P7): the header lines WIDTH, HEIGHT, DEPTH, MAXVAL,
  TUPLTYPE (BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA, RGB, RGB_ALPHA) and
  comments, ENDHDR; samples are returned as stored, uint16 big-endian when
  MAXVAL > 255, with no scaling, and cv2 takes the stored order for BGR(A)
  whatever the TUPLTYPE (so a 3-channel PAM comes back reversed here, in
  RGB order). Without a TUPLTYPE cv2 reads only 1 channel at MAXVAL up to
  255 and 3 channels at MAXVAL up to 255: cv2 cannot read back its own
  4-channel or 16-bit PAM, and the port raises ValueError there, as it
  does wherever cv2.imread returns None. At MAXVAL 1 cv2 reads each row's
  first bits as a 1-bit bitmap (255 for a set bit) and skips the rest of
  the row's bytes; kept.
- ``read_pfm``: ``Pf`` (1 channel) or ``PF`` (3, RGB), one newline, then
  width, height and scale, each ended by one whitespace byte; rows stored
  bottom-up; a negative scale means little-endian samples, and the samples
  are multiplied by f32(1 / |scale|) (then plus 0, so -0 becomes +0) unless
  |scale| is 1. float32.
- ``write_pxm`` / ``write_pam`` / ``write_pfm`` write cv2.imwrite's bytes:
  binary P4 (a bit set where the sample is 0), P5 and P6 (maxval 255 or
  65535, big-endian at 16 bits) chosen by extension; PAM with no TUPLTYPE,
  samples in cv2's BGR(A) order; PFM little-endian with scale -1, rows
  bottom-up.

Malformed files raise ValueError naming the file.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

INT_MAX = 2 ** 31 - 1
SPACE = b" \t\n\v\f\r"
PAM_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
PAM_TUPLTYPES = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2,
                 "RGB": 3, "RGB_ALPHA": 4}
PXM_EXTENSIONS = (".pbm", ".pgm", ".ppm", ".pnm")


def _refuse(path, why: str):
    raise ValueError(f"{path}: {why}; cv2.imread returns no image for it")


class _Bytes:
    """OpenCV's byte stream over a file's bytes: reading past the end
    raises."""

    def __init__(self, path, data: bytes, pos: int = 0):
        self.path, self.data, self.pos = path, data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            _refuse(self.path, "a file that ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            _refuse(self.path, "pixel data that ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _isdigit(c: int) -> bool:
    return 48 <= c <= 57


def _number(s: _Bytes, maxdigits: int = 0) -> int:
    """grfmt_pxm.cpp ReadNumber: skip white space and comments, read
    decimal digits (at most ``maxdigits`` when it is not 0) and the byte
    after them."""
    c = s.byte()
    while not _isdigit(c):
        if c == ord("#"):
            while c not in (10, 13):
                c = s.byte()
            c = s.byte()
        elif c in SPACE:
            while c in SPACE:
                c = s.byte()
        else:
            _refuse(s.path, f"an unexpected byte 0x{c:02x} in a number")
    val = digits = 0
    while True:
        val = val * 10 + c - 48
        if val > INT_MAX:
            _refuse(s.path, "a number that is too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            return val
        c = s.byte()
        if not _isdigit(c):
            return val


def _bits(rows: np.ndarray, w: int) -> np.ndarray:
    """Each row's first w bits, most significant first, as 0 / 1."""
    return np.unpackbits(rows, axis=1)[:, :w]


def read_pxm(path) -> np.ndarray:
    """Decode a PBM, PGM or PPM file (P1-P6) to what cv2.imread(path,
    IMREAD_UNCHANGED) returns, in RGB order: uint8 or uint16 [H, W] or [H,
    W, 3]."""
    data = Path(path).read_bytes()
    s = _Bytes(path, data)
    if s.byte() != ord("P"):
        _refuse(path, "not a portable bitmap")
    kind = s.byte() - 48
    if kind not in range(1, 7):
        _refuse(path, f"a portable bitmap of kind P{chr(kind + 48)}")
    ch = 3 if kind in (3, 6) else 1
    w = _number(s, INT_MAX)
    h = _number(s, INT_MAX)
    maxval = 1 if kind in (1, 4) else _number(s, INT_MAX)
    if maxval > 65535 or not (w > 0 and h > 0 and maxval > 0):
        _refuse(path, f"a {w} x {h} image of maxval {maxval}")
    wide = maxval > 255
    if kind == 1:
        img = np.array([[_number(s, 1) != 0 for _ in range(w)]
                        for _ in range(h)], np.uint8)
        img = np.where(img == 1, 0, 255).astype(np.uint8)
    elif kind == 4:
        rows = np.frombuffer(s.take(h * ((w + 7) // 8)), np.uint8)
        img = np.where(_bits(rows.reshape(h, -1), w) == 1, 0,
                       255).astype(np.uint8)
    elif kind in (2, 3):
        v = np.minimum(np.array([_number(s) for _ in range(h * w * ch)],
                                np.int64), maxval)
        img = (v.astype(np.uint16) if wide
               else (v * 255 // maxval).astype(np.uint8))
    else:
        n = h * w * ch
        img = (np.frombuffer(s.take(2 * n), ">u2").astype(np.uint16) if wide
               else np.frombuffer(s.take(n), np.uint8).copy())
    return img.reshape(h, w, ch) if ch == 3 else img.reshape(h, w)


def _pam_line(s: _Bytes):
    """grfmt_pam.cpp ReadPAMHeaderLine: (field or None for a comment,
    value)."""
    c = s.byte()
    while c in SPACE:
        c = s.byte()
    if c == ord("#"):
        while c not in (10, 13):
            c = s.byte()
        return None, ""
    ident = bytearray()
    while len(ident) < 8 and c not in SPACE:
        ident.append(c)
        c = s.byte()
    if c not in SPACE or ident.decode("latin-1") not in PAM_FIELDS:
        _refuse(s.path, "an invalid PAM header")
    if c in (10, 13):
        return ident.decode(), ""
    c = s.byte()
    while c in SPACE:
        c = s.byte()
    value = bytearray()
    while len(value) < 255 and c not in (10, 13):
        value.append(c)
        c = s.byte()
    if c not in (10, 13):
        _refuse(s.path, "an invalid PAM header")
    return ident.decode(), value.split(b"\0")[0].rstrip(SPACE).decode(
        "latin-1")


def _pam_int(path, v: str) -> int:
    m = re.fullmatch(r"(-?)(\d*)", v)
    if not m or (m.group(1) and not m.group(2)):
        _refuse(path, f"a PAM header value {v!r}")
    n = int(m.group(2) or 0)
    if n >= INT_MAX:
        _refuse(path, f"a PAM header value {v!r}")
    return -n if m.group(1) else n


def read_pam(path) -> np.ndarray:
    """Decode a PAM file (P7) to what cv2.imread(path, IMREAD_UNCHANGED)
    returns, with cv2's BGR(A) reversed to RGB(A) (see the module
    docstring): uint8 or uint16 [H, W] or [H, W, 2 | 3 | 4]."""
    data = Path(path).read_bytes()
    s = _Bytes(path, data)
    if s.take(2) != b"P7" or s.byte() not in (10, 13):
        _refuse(path, "an invalid PAM header")
    fields, tupltype = {}, None
    while True:
        field, value = _pam_line(s)
        if field is None:
            continue
        if field == "ENDHDR":
            break
        if field == "TUPLTYPE":
            if value not in PAM_TUPLTYPES:
                _refuse(path, f"PAM TUPLTYPE {value!r}")
            tupltype = value
            continue
        if field in fields:
            _refuse(path, f"PAM {field} given twice")
        fields[field] = _pam_int(path, value)
        if field == "MAXVAL" and fields[field] > 65535:
            _refuse(path, "a PAM MAXVAL that is too large")
    if set(fields) != {"WIDTH", "HEIGHT", "DEPTH", "MAXVAL"}:
        _refuse(path, "a PAM header without WIDTH, HEIGHT, DEPTH and MAXVAL")
    w, h, ch, maxval = (fields[k] for k in ("WIDTH", "HEIGHT", "DEPTH",
                                            "MAXVAL"))
    if tupltype is None:
        if ch == 1 and maxval < 256:
            tupltype = "GRAYSCALE"
        elif ch == 3 and maxval < 256:
            tupltype = "RGB"
        else:
            _refuse(path, f"a PAM of {ch} channels at MAXVAL {maxval} "
                    "without a TUPLTYPE (cv2 cannot tell its format)")
    if PAM_TUPLTYPES[tupltype] != ch:
        _refuse(path, f"a PAM of TUPLTYPE {tupltype} and {ch} channels")
    if w <= 0 or h <= 0:
        _refuse(path, f"a {w} x {h} PAM")
    wide = maxval > 255
    if maxval == 1:
        if ch not in (1, 3):
            _refuse(path, f"a {ch}-channel PAM at MAXVAL 1")
        rows = np.frombuffer(s.take(h * w * ch), np.uint8).reshape(h, -1)
        img = np.where(_bits(rows, w) == 1, 255, 0).astype(np.uint8)
        return np.repeat(img[..., None], 3, -1) if ch == 3 else img
    n = h * w * ch
    img = (np.frombuffer(s.take(2 * n), ">u2").astype(np.uint16) if wide
           else np.frombuffer(s.take(n), np.uint8).copy()).reshape(h, w, ch)
    if ch == 1:
        return img[..., 0]
    return img[..., [2, 1, 0, 3][:ch]] if ch > 2 else img


def _cpp_number(text: str, floating: bool):
    """std::istringstream >> int / double on a header token: the longest
    leading number, 0 when there is none."""
    pat = (r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?" if floating
           else r"[+-]?\d+")
    m = re.match(pat, text)
    if not m:
        return 0
    return float(m.group(0)) if floating else int(m.group(0))


def _pfm_token(s: _Bytes) -> str:
    out = bytearray()
    while len(out) < 2048:
        c = s.byte()
        if c >= 128:
            _refuse(s.path, "a PFM header byte past ASCII")
        if c in SPACE:
            break
        out.append(c)
    return out.decode("ascii")


def read_pfm(path) -> np.ndarray:
    """Decode a PFM file to what cv2.imread(path, IMREAD_UNCHANGED) returns,
    in RGB order: float32 [H, W] (Pf) or [H, W, 3] (PF)."""
    data = Path(path).read_bytes()
    s = _Bytes(path, data)
    if s.byte() != ord("P"):
        _refuse(path, "not a PFM file")
    c = s.byte()
    if c not in (ord("f"), ord("F")) or s.byte() != 10:
        _refuse(path, "an invalid PFM header")
    ch = 1 if c == ord("f") else 3
    w = _cpp_number(_pfm_token(s), False)
    h = _cpp_number(_pfm_token(s), False)
    scale = _cpp_number(_pfm_token(s), True)
    if w <= 0 or h <= 0:
        _refuse(path, f"a {w} x {h} PFM")
    if scale == 0:
        _refuse(path, "a PFM scale of 0")
    words = np.frombuffer(s.take(h * w * ch * 4), "<u4" if scale < 0
                          else ">u4")
    img = words.astype(np.uint32).view(np.float32).reshape(h, w, ch)[::-1]
    a = 1.0 / abs(scale)
    if a != 1.0:
        img = img * np.float32(a) + np.float32(0)
    img = np.array(img)
    return img[..., 0] if ch == 1 else img


def _gray_or_color(path, img: np.ndarray):
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2 or (img.ndim == 3 and img.shape[-1] in (2, 3, 4)):
        return img
    raise ValueError(f"{path}: image shape {img.shape} is not [H, W] or [H, "
                     "W, 1 | 2 | 3 | 4]")


def write_pxm(path, image: np.ndarray) -> None:
    """Write a uint8 or uint16 [H, W] or [H, W, 3] (RGB) image as
    cv2.imwrite writes .pbm (P4, uint8 gray only), .pgm (P5, gray), .ppm
    (P6, RGB) and .pnm (P5 or P6)."""
    ext = Path(path).suffix.lower()
    img = _gray_or_color(path, np.asarray(image))
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: {ext} writing takes uint8 or uint16, not "
                         f"{img.dtype}")
    gray = img.ndim == 2
    rgb = img.ndim == 3 and img.shape[-1] == 3
    takes = {".pbm": ("a uint8 gray", gray and img.dtype == np.uint8),
             ".pgm": ("a gray", gray), ".ppm": ("an RGB", rgb),
             ".pnm": ("a gray or RGB", gray or rgb)}
    kind, ok = takes[ext]
    if not ok:
        raise ValueError(f"{path}: {ext} takes {kind} image, not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if ext == ".pbm":
        body = np.packbits((img == 0).astype(np.uint8), axis=1).tobytes()
        Path(path).write_bytes(f"P4\n{w} {h}\n".encode() + body)
        return
    maxval = 65535 if img.dtype == np.uint16 else 255
    body = img.astype(">u2").tobytes() if maxval > 255 else img.tobytes()
    Path(path).write_bytes(f"P{5 if gray else 6}\n{w} {h}\n{maxval}\n"
                           .encode() + body)


def write_pam(path, image: np.ndarray) -> None:
    """Write a uint8 or uint16 [H, W] or [H, W, 2 | 3 | 4] (RGB(A)) image as
    cv2.imwrite(".pam") writes it."""
    img = _gray_or_color(path, np.asarray(image))
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: PAM writing takes uint8 or uint16, not "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[-1]
    if ch > 2:
        img = img[..., [2, 1, 0, 3][:ch]]
    maxval = 65535 if img.dtype == np.uint16 else 255
    body = img.astype(">u2").tobytes() if maxval > 255 else img.tobytes()
    Path(path).write_bytes(f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {ch}\n"
                           f"MAXVAL {maxval}\nENDHDR\n".encode() + body)


def write_pfm(path, image: np.ndarray) -> None:
    """Write a float32 [H, W] or [H, W, 3] (RGB) image as
    cv2.imwrite(".pfm") writes it."""
    img = np.asarray(image)
    if img.dtype != np.float32:
        raise ValueError(f"{path}: PFM writing takes float32, not "
                         f"{img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"{path}: PFM takes [H, W] or [H, W, 3], not "
                         f"{image.shape}")
    h, w = img.shape[:2]
    Path(path).write_bytes(f"P{'f' if img.ndim == 2 else 'F'}\n{w} {h}\n-1\n"
                           .encode() + img[::-1].astype("<f4").tobytes())
