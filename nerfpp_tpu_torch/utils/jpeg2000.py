"""JPEG 2000 reading and writing, as OpenCV's OpenJPEG reads and writes it
(no image library).

The JAX package reads every view with ``cv2.imread(path,
IMREAD_UNCHANGED)`` and writes undistorted views with ``cv2.imwrite``;
aerial and satellite products, archival photogrammetry and cinema frames
often come as JPEG 2000. The machine with the card has no OpenCV, so the
port carries this codec. The boxes and marker segments are parsed here;
tier-2 (packet headers, in all five progression orders, with precincts and
layers) and tier-1 (the MQ coder and the three coding passes) are host C++
(``csrc/jpeg2000_codec.cpp``, built with g++ at first use by
``native.build_library``; no g++ raises, and there is no Python fallback);
the dequantisation, the inverse wavelet transforms, the inverse colour
transforms, the DC shift and OpenCV's colour conversion run in PyTorch on
the device, bitwise the same on the card and the CPU.
tests/test_torch_jpeg2000*.py hold both directions to cv2.

- ``decode_jpeg2000`` (host) and ``jpeg2000_pixels`` (device) return, and
  ``read_jpeg2000`` returns on a device, what cv2.imread(IMREAD_UNCHANGED)
  returns, in RGB(A) order: a JP2 file (signature, ``ftyp``, ``jp2h`` with
  ``ihdr``, ``colr`` and ``cdef``, ``jp2c``; other boxes skipped) or a raw
  codestream (``ff4f ff51``); the main and tile-part headers (SIZ, COD,
  COC, QCD, QCC, COM, TLM, PLM, PLT, several tile-parts per tile); SOP and
  EPH markers; reversible 5/3 (integer lifting) and irreversible 9/7
  (float32 lifting with OpenJPEG's constants, in its order, each multiply
  and add rounded apart), the RCT and the ICT, OpenJPEG's lrintf and
  clamp; 1, 3 or 4 components of 8 bits (uint8) or 16 bits (uint16). An
  sYCC file (``colr`` 18, as Pillow writes its YCbCr mode) comes back
  through OpenCV's YUV -> BGR (14-bit fixed point).
- ``encode_jpeg2000`` / ``write_jpeg2000`` write what cv2.imwrite(".jp2")
  writes at its defaults: a JP2 file of one tile, reversible 5/3 with
  five decompositions, 64 x 64 code-blocks, LRCP, one layer cut to
  OpenJPEG's rate 4 (a quarter of the raw bytes, less the headers) by
  OpenJPEG's distortion estimates and threshold search, no colour
  transform (cv2 asks for none), and OpenJPEG's COM. uint16 stays 16
  bits; other dtypes become uint8 as OpenCV's convertTo makes them.

Refused with NotImplementedError naming the file and the kind: code-block
styles other than 0, region of interest (RGN), progression order changes
(POC), packed packet headers (PPM, PPT), sub-sampled components, palettes
(``pclr``), a ``cdef`` that reorders channels, Part 2 multi-component
transforms and precisions other than 8 and 16 bits. Where cv2.imread
returns None (2 components, signed samples, an image offset, a stream cut
short or broken) ValueError names the file.
"""
from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import native, resolve_device
from nerfpp_tpu_torch.utils.webp import to_uint8

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "jpeg2000_codec.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
             "-shared", "-fPIC", "-std=c++17"]
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
SIGNATURES = (JP2_SIGNATURE, J2K_SIGNATURE)
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
COMMENT = b"Created by OpenJPEG version 2.5.3"
MIN_SIDE = 32            # 2^(resolutions - 1) of cv2's 6 resolutions
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30   # CV_IO_MAX_IMAGE_WIDTH, _PIXELS
RATE = 4.0               # cv2.imwrite's default compression ratio
# OpenJPEG 2.5's 9/7 lifting constants (dwt.c), float32
ALPHA, BETA = np.float32(-1.586134342), np.float32(-0.052980118)
GAMMA, DELTA = np.float32(0.882911075), np.float32(0.443506852)
K97 = np.float32(1.230174105)
C13318 = np.float32(1.625732422)     # OpenJPEG's high-band scale, not 2 / K
# OpenCV's YUV -> RGB (color_yuv: U2BI, U2GI, V2GI, V2RI; 14 bits)
U2B, U2G, V2G, V2R = 33292, -6472, -9519, 18678

_lib = None


def codec_library() -> ctypes.CDLL:
    """The JPEG 2000 codec, built with g++ on first use (raises without
    it)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX_FLAGS)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.j2k_decode_tile.restype = i64
        lib.j2k_decode_tile.argtypes = [u8p, i64, i32p, i32p]
        lib.j2k_encode_tile.restype = i64
        lib.j2k_encode_tile.argtypes = [i32p, i32p, i64, u8p, i64]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _bad(path, why: str):
    return ValueError(f"{path}: {why}; cv2.imread returns no image for it")


def _refuse(path, kind: str):
    return NotImplementedError(
        f"{path}: a JPEG 2000 file with {kind}, which the port does not read")


# ------------------------------------------------------------- JP2 boxes

def _boxes(path, data: bytes, start: int, end: int):
    """(type, payload offset, payload end) of the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise _bad(path, "a box header cut short")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise _bad(path, f"a {kind.decode('latin-1')!r} box of {size} "
                       f"bytes with {end - pos} left")
        yield kind, pos + head, pos + size
        pos += size


class Container(NamedTuple):
    """A JPEG 2000 file's codestream and what its JP2 header says of it
    (``colourspace`` the ``colr`` enumeration, or None)."""
    codestream: bytes
    colourspace: Optional[int]


def parse_container(path, data: bytes) -> Container:
    """The codestream of a JP2 file or a raw codestream."""
    if data.startswith(J2K_SIGNATURE):
        return Container(data, None)
    if not data.startswith(JP2_SIGNATURE):
        raise _bad(path, "no JPEG 2000 signature")
    colourspace, stream, header = None, None, False
    for kind, off, end in _boxes(path, data, 12, len(data)):
        if kind == b"jp2h":
            header = True
            for sub, s0, s1 in _boxes(path, data, off, end):
                if sub == b"colr" and colourspace is None:
                    if s1 - s0 >= 7 and data[s0] == 1:
                        colourspace = struct.unpack_from(">I", data, s0 + 3)[0]
                elif sub in (b"pclr", b"cmap"):
                    raise _refuse(path, "a palette (pclr / cmap)")
                elif sub == b"cdef":
                    n = struct.unpack_from(">H", data, s0)[0]
                    for i in range(n):
                        ch, typ, asoc = struct.unpack_from(">HHH", data,
                                                           s0 + 2 + 6 * i)
                        colour = typ == 0 and asoc == ch + 1
                        alpha = typ in (1, 2) and asoc == 0 and ch == n - 1
                        if not (colour or alpha):
                            raise _refuse(path, "a cdef box that reorders or "
                                          "retypes channels")
        elif kind == b"jp2c":
            if not header:
                raise _bad(path, "a jp2c box before the jp2h box")
            stream = data[off:end]
            break
    if stream is None:
        raise _bad(path, "no jp2c codestream box")
    return Container(stream, colourspace)


# -------------------------------------------------------- marker segments

class Coding(NamedTuple):
    """One component's coding style (code-block style 0): resolutions,
    code-block size exponents, the wavelet (1 reversible 5/3, 0
    irreversible 9/7) and the precinct exponents of each resolution."""
    numres: int
    cblkw: int
    cblkh: int
    qmfbid: int
    precincts: Tuple[Tuple[int, int], ...]


class Quant(NamedTuple):
    """One component's quantisation: guard bits and (exponent, mantissa)
    of each band, in resolution order."""
    guard: int
    steps: Tuple[Tuple[int, int], ...]


class TileCoding(NamedTuple):
    prog: int
    layers: int
    mct: int
    csty: int
    comps: Tuple[Coding, ...]
    quants: Tuple[Quant, ...]


def _spcod(path, seg: bytes, pos: int, precincts: bool) -> Coding:
    if len(seg) < pos + 5:
        raise _bad(path, "a COD / COC segment cut short")
    ndec, xcb, ycb, style, qmf = seg[pos:pos + 5]
    numres = ndec + 1
    if numres > 33 or xcb + 2 > 10 or ycb + 2 > 10 or xcb + ycb + 4 > 12:
        raise _bad(path, f"{ndec} decompositions with {1 << xcb + 2} x "
                   f"{1 << ycb + 2} code-blocks")
    if style:
        names = ("bypass", "reset", "termall", "vertical causal",
                 "predictable termination", "segmentation symbols",
                 "high throughput")
        kinds = [n for i, n in enumerate(names) if style >> i & 1]
        raise _refuse(path, f"code-block style {style:#04x} ("
                      f"{', '.join(kinds)})")
    if qmf > 1:
        raise _refuse(path, f"the Part 2 wavelet {qmf}")
    if precincts:
        if len(seg) < pos + 5 + numres:
            raise _bad(path, "precinct sizes cut short")
        pp = tuple((b & 15, b >> 4) for b in seg[pos + 5:pos + 5 + numres])
        if any((r > 0 and (x == 0 or y == 0)) for r, (x, y) in enumerate(pp)):
            raise _bad(path, "a precinct of one sample in a high band")
    else:
        pp = ((15, 15),) * numres
    return Coding(numres, xcb + 2, ycb + 2, qmf, pp)


def _quant(path, seg: bytes, pos: int) -> Tuple[int, int, Tuple]:
    if len(seg) <= pos:
        raise _bad(path, "a QCD / QCC segment cut short")
    s = seg[pos]
    style, guard = s & 31, s >> 5
    body = seg[pos + 1:]
    if style == 0:
        steps = tuple((b >> 3, 0) for b in body)
    elif style in (1, 2):
        steps = tuple((v >> 11, v & 0x7FF) for v in
                      struct.unpack(f">{len(body) // 2}H", body[:len(body)
                                                                 // 2 * 2]))
    else:
        raise _bad(path, f"quantisation style {style}")
    return style, guard, steps


def _band_steps(path, style: int, guard: int, steps, numres: int) -> Quant:
    n = 3 * numres - 2
    if style == 1:
        if not steps:
            raise _bad(path, "a derived quantisation without its step")
        e0, m0 = steps[0]
        steps = ((e0, m0),) + tuple((max(e0 - (b - 1) // 3, 0), m0)
                                    for b in range(1, n))
    if len(steps) < n:
        raise _bad(path, f"{len(steps)} quantisation steps for {n} bands")
    return Quant(guard, tuple(steps[:n]))


class Header:
    """The codestream's main header (and, per tile, its overrides)."""

    def __init__(self):
        self.cod = None          # (csty, prog, layers, mct, Coding)
        self.coc: Dict[int, Coding] = {}
        self.qcd = None          # (style, guard, steps)
        self.qcc: Dict[int, tuple] = {}

    def apply(self, path, code: int, seg: bytes, ncomp: int) -> None:
        cbytes = 1 if ncomp < 257 else 2
        if code in (0xFF53, 0xFF5D):
            if len(seg) < cbytes + 1:
                raise _bad(path, f"marker {code:#06x} cut short")
            comp = seg[0] if cbytes == 1 else struct.unpack_from(">H", seg)[0]
            if comp >= ncomp:
                raise _bad(path, f"marker {code:#06x} for component {comp} "
                           f"of {ncomp}")
        if code == 0xFF52:       # COD
            if len(seg) < 5:
                raise _bad(path, "a COD segment cut short")
            csty, prog, layers, mct = seg[0], seg[1], \
                struct.unpack_from(">H", seg, 2)[0], seg[4]
            if prog > 4:
                raise _bad(path, f"progression order {prog}")
            if layers == 0:
                raise _bad(path, "zero quality layers")
            if mct > 1:
                raise _refuse(path, f"the Part 2 multi-component transform "
                              f"{mct}")
            self.cod = (csty, prog, layers, mct,
                        _spcod(path, seg, 5, bool(csty & 1)))
        elif code == 0xFF53:     # COC
            self.coc[comp] = _spcod(path, seg, cbytes + 1,
                                    bool(seg[cbytes] & 1))
        elif code == 0xFF5C:     # QCD
            self.qcd = _quant(path, seg, 0)
        elif code == 0xFF5D:     # QCC
            self.qcc[comp] = _quant(path, seg, cbytes)

    def resolve(self, path, main: "Header", ncomp: int) -> TileCoding:
        """The coding of a tile whose own header is ``self``: tile COC >
        tile COD > main COC > main COD, and QCC / QCD likewise."""
        cod = self.cod or main.cod
        if cod is None or (self.qcd or main.qcd) is None:
            raise _bad(path, "no COD or QCD marker")
        csty, prog, layers, mct, default = cod
        comps, quants = [], []
        for c in range(ncomp):
            if c in self.coc:
                coding = self.coc[c]
            elif self.cod is not None:
                coding = self.cod[4]
            else:
                coding = main.coc.get(c, default)
            comps.append(coding)
            if c in self.qcc:
                q = self.qcc[c]
            elif self.qcd is not None:
                q = self.qcd
            else:
                q = main.qcc.get(c, main.qcd)
            quants.append(_band_steps(path, *q, coding.numres))
        return TileCoding(prog, layers, mct, csty, tuple(comps),
                          tuple(quants))


class Siz(NamedTuple):
    width: int
    height: int
    tw: int
    th: int
    tx0: int
    ty0: int
    prec: Tuple[int, ...]


def _siz(path, seg: bytes) -> Siz:
    if len(seg) < 36:
        raise _bad(path, "a SIZ segment cut short")
    (_, xs, ys, x0, y0, tw, th, tx0, ty0, nc) = struct.unpack_from(
        ">HIIIIIIIIH", seg)
    if len(seg) < 36 + 3 * nc or nc == 0:
        raise _bad(path, f"a SIZ segment for {nc} components cut short")
    comps = [seg[36 + 3 * i:39 + 3 * i] for i in range(nc)]
    if xs <= x0 or ys <= y0 or tw == 0 or th == 0 or tx0 > x0 or ty0 > y0 \
            or tx0 + tw <= x0 or ty0 + th <= y0:
        raise _bad(path, f"an image of {xs - x0} x {ys - y0} on tiles of "
                   f"{tw} x {th}")
    if any(s & 0x80 for s, _, _ in comps):
        raise _bad(path, "signed samples")
    if x0 or y0:
        raise _bad(path, f"an image offset of ({x0}, {y0}) (OpenCV takes "
                   "no offset)")
    if nc == 2 or nc > 4:
        raise _bad(path, f"{nc} components")
    if any(dx != 1 or dy != 1 for _, dx, dy in comps):
        raise _refuse(path, "sub-sampled components")
    prec = tuple((s & 0x7F) + 1 for s, _, _ in comps)
    if xs - x0 > MAX_SIDE or ys - y0 > MAX_SIDE or \
            (xs - x0) * (ys - y0) > MAX_PIXELS:
        raise _bad(path, f"an image of {xs - x0} x {ys - y0} (OpenCV's "
                   "limits: 2^20 a side, 2^30 pixels)")
    if any(p not in (8, 16) for p in prec) or len(set(prec)) > 1:
        raise _refuse(path, f"{'/'.join(map(str, prec))}-bit samples "
                      "(the port reads 8 and 16 bits)")
    return Siz(xs, ys, tw, th, tx0, ty0, prec)


class TileData(NamedTuple):
    index: int
    box: Tuple[int, int, int, int]      # x0, y0, x1, y1
    coding: TileCoding
    body: bytes


def parse_codestream(path, cs: bytes) -> Tuple[Siz, List[TileData]]:
    """The SIZ and each tile's coding and packet bytes (its tile-parts'
    bodies in order) of a codestream, checked as OpenJPEG's strict reader
    checks it."""
    if not cs.startswith(J2K_SIGNATURE):
        raise _bad(path, "no SOC and SIZ markers")
    pos = 2
    siz = None
    main = Header()
    tiles: Dict[int, list] = {}

    def segment(p):
        if p + 4 > len(cs):
            raise _bad(path, "a marker segment cut short")
        code, ln = struct.unpack_from(">HH", cs, p)
        if ln < 2 or p + 2 + ln > len(cs):
            raise _bad(path, f"marker {code:#06x} of {ln} bytes past the "
                       "end of the stream")
        return code, cs[p + 4:p + 2 + ln], p + 2 + ln

    while True:
        code, seg, nxt = segment(pos)
        if code == 0xFF90:       # SOT: the main header ends
            break
        if code == 0xFF51:
            siz = _siz(path, seg)
        elif code in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D):
            if siz is None:
                raise _bad(path, "a marker before SIZ")
            main.apply(path, code, seg, len(siz.prec))
        elif code == 0xFF5E:
            raise _refuse(path, "a region of interest (RGN)")
        elif code == 0xFF5F:
            raise _refuse(path, "a progression order change (POC)")
        elif code == 0xFF60:
            raise _refuse(path, "packed packet headers (PPM)")
        elif code == 0xFF50:
            raise _refuse(path, "high-throughput code-blocks (CAP)")
        elif code >> 8 != 0xFF:
            raise _bad(path, f"{code:#06x} where a marker belongs")
        pos = nxt
    if siz is None:
        raise _bad(path, "no SIZ marker")
    nc = len(siz.prec)
    ntx = -(-(siz.width - siz.tx0) // siz.tw)
    nty = -(-(siz.height - siz.ty0) // siz.th)
    while True:
        if pos + 2 <= len(cs) and cs[pos:pos + 2] == b"\xff\xd9":
            break
        code, seg, hdr_end = segment(pos)
        if code != 0xFF90 or len(seg) != 8:
            raise _bad(path, f"{code:#06x} where SOT or EOC belongs")
        isot, psot, tpsot, _ = struct.unpack(">HIBB", seg)
        if isot >= ntx * nty:
            raise _bad(path, f"tile {isot} of {ntx * nty}")
        end = pos + psot if psot else len(cs) - 2
        if end > len(cs) or end < hdr_end:
            raise _bad(path, "a tile-part longer than the stream")
        tile = tiles.setdefault(isot, [Header(), []])
        p = hdr_end
        while True:
            if cs[p:p + 2] == b"\xff\x93":      # SOD
                p += 2
                break
            code, seg, nxt = segment(p)
            if code in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D):
                if tpsot:
                    raise _bad(path, "a coding marker after a tile's first "
                               "tile-part")
                tile[0].apply(path, code, seg, nc)
            elif code == 0xFF5E:
                raise _refuse(path, "a region of interest (RGN)")
            elif code == 0xFF5F:
                raise _refuse(path, "a progression order change (POC)")
            elif code == 0xFF61:
                raise _refuse(path, "packed packet headers (PPT)")
            p = nxt
        if p > end:
            raise _bad(path, "a tile-part header past its length")
        tile[1].append(cs[p:end])
        pos = end
    out = []
    for isot in sorted(tiles):
        hdr, parts = tiles[isot]
        tx, ty = isot % ntx, isot // ntx
        box = (max(siz.tx0 + tx * siz.tw, 0), max(siz.ty0 + ty * siz.th, 0),
               min(siz.tx0 + (tx + 1) * siz.tw, siz.width),
               min(siz.ty0 + (ty + 1) * siz.th, siz.height))
        out.append(TileData(isot, box, hdr.resolve(path, main, nc),
                            b"".join(parts)))
    return siz, out


# ----------------------------------------------------------- host stages

def tile_params(box, coding: TileCoding) -> np.ndarray:
    """The tile description jpeg2000_codec.cpp takes."""
    p = [*box, len(coding.comps), coding.layers, coding.prog, coding.csty]
    for c, q in zip(coding.comps, coding.quants):
        p += [c.numres, c.cblkw, c.cblkh]
        for x, y in c.precincts:
            p += [x, y]
        p += [e + q.guard - 1 for e, _ in q.steps]
    return np.asarray(p, np.int32)


class Decoded(NamedTuple):
    """A decoded JPEG 2000 file before its pixel stages: each tile's box,
    coding and coefficient planes [C, h, w] (OpenJPEG's tile layout, twice
    each coefficient plus its half step), the sample precision and the
    ``colr`` colour space."""
    width: int
    height: int
    prec: int
    colourspace: Optional[int]
    tiles: List[Tuple[Tuple[int, int, int, int], TileCoding, np.ndarray]]


def decode_jpeg2000(path, data: Optional[bytes] = None) -> Decoded:
    """The host part of a decode: boxes, markers, tier-2 and tier-1."""
    data = Path(path).read_bytes() if data is None else data
    box = parse_container(path, data)
    siz, tiles = parse_codestream(path, box.codestream)
    ntiles = -(-(siz.width - siz.tx0) // siz.tw) * \
        -(-(siz.height - siz.ty0) // siz.th)
    if len(tiles) != ntiles:
        raise _bad(path, f"{len(tiles)} of {ntiles} tiles")
    if box.colourspace == 18 and len(siz.prec) != 3:
        raise _refuse(path, f"sYCC of {len(siz.prec)} components")
    lib = codec_library()
    out = []
    for t in tiles:
        x0, y0, x1, y1 = t.box
        planes = np.empty((len(siz.prec), y1 - y0, x1 - x0), np.int32)
        params = tile_params(t.box, t.coding)
        body = np.frombuffer(t.body, np.uint8)
        n = lib.j2k_decode_tile(_ptr(body, ctypes.c_uint8), body.size,
                                _ptr(params, ctypes.c_int32),
                                _ptr(planes, ctypes.c_int32))
        if n < 0:
            raise _bad(path, f"a broken packet in tile {t.index}")
        out.append((t.box, t.coding, planes))
    return Decoded(siz.width, siz.height, siz.prec[0], box.colourspace, out)


# ---------------------------------------------------------- device stages

def _resolutions(x0: int, y0: int, x1: int, y1: int, numres: int):
    """(x0, y0, x1, y1) of each resolution of a tile-component."""
    out = []
    for r in range(numres):
        s = numres - 1 - r
        out.append((-(-x0 >> s), -(-y0 >> s), -(-x1 >> s), -(-y1 >> s)))
    return out


def _neighbours(n: int, dev):
    """Left and right neighbours of each of n samples, mirrored at the
    ends (whole-sample symmetric extension)."""
    i = torch.arange(n, device=dev)
    left = torch.where(i == 0, 1, i - 1)
    right = torch.where(i == n - 1, n - 2, i + 1)
    return left, right


def _interleave(low: torch.Tensor, high: torch.Tensor, cas: int):
    """Low and high halves along the last dimension -> the interleaved
    signal (low on even positions when ``cas`` is 0, odd when 1)."""
    n = low.shape[-1] + high.shape[-1]
    x = torch.empty(*low.shape[:-1], n, dtype=low.dtype, device=low.device)
    x[..., cas::2] = low
    x[..., 1 - cas::2] = high
    return x


def idwt53_1d(low: torch.Tensor, high: torch.Tensor, cas: int
              ) -> torch.Tensor:
    """OpenJPEG's inverse 5/3 along the last dimension (int32)."""
    x = _interleave(low, high, cas)
    n = x.shape[-1]
    if n == 1:
        return x if cas == 0 else torch.div(x, 2, rounding_mode="trunc")
    left, right = _neighbours(n, x.device)
    lo, hi = slice(cas, None, 2), slice(1 - cas, None, 2)
    x[..., lo] -= (x[..., left[lo]] + x[..., right[lo]] + 2) >> 2
    x[..., hi] += (x[..., left[hi]] + x[..., right[hi]]) >> 1
    return x


def fdwt53_1d(x: torch.Tensor, cas: int):
    """OpenJPEG's forward 5/3 along the last dimension (int32): (low,
    high)."""
    n = x.shape[-1]
    x = x.clone()
    lo, hi = slice(cas, None, 2), slice(1 - cas, None, 2)
    if n == 1:
        return (x, x[..., :0]) if cas == 0 else (x[..., :0], x * 2)
    left, right = _neighbours(n, x.device)
    x[..., hi] -= (x[..., left[hi]] + x[..., right[hi]]) >> 1
    x[..., lo] += (x[..., left[lo]] + x[..., right[lo]] + 2) >> 2
    return x[..., lo], x[..., hi]


def idwt97_1d(low: torch.Tensor, high: torch.Tensor, cas: int
              ) -> torch.Tensor:
    """OpenJPEG's inverse 9/7 along the last dimension (float32): the
    scaling, then the four lifting steps, each sum, product and update
    rounded apart."""
    x = _interleave(low, high, cas)
    n = x.shape[-1]
    if n == 1:
        return x
    left, right = _neighbours(n, x.device)
    lo, hi = slice(cas, None, 2), slice(1 - cas, None, 2)
    x[..., lo] = x[..., lo] * K97
    x[..., hi] = x[..., hi] * C13318
    for pos, c in ((lo, -DELTA), (hi, -GAMMA), (lo, -BETA), (hi, -ALPHA)):
        s = x[..., left[pos]] + x[..., right[pos]]
        x[..., pos] = x[..., pos] + s * c
    return x


def inverse_dwt(plane: torch.Tensor, box, numres: int, reversible: bool
                ) -> torch.Tensor:
    """The inverse transform of one tile-component plane in OpenJPEG's
    layout: at each resolution the rows, then the columns."""
    res = _resolutions(*box, numres)
    one = idwt53_1d if reversible else idwt97_1d
    x = plane.clone()
    for r in range(1, numres):
        px0, py0, px1, py1 = res[r - 1]
        rx0, ry0, rx1, ry1 = res[r]
        sw, sh = px1 - px0, py1 - py0
        rw, rh = rx1 - rx0, ry1 - ry0
        if rw and rh:
            reg = x[:rh, :rw]
            reg = one(reg[:, :sw], reg[:, sw:], rx0 % 2)
            reg = one(reg[:sh].T, reg[sh:].T, ry0 % 2).T
            x[:rh, :rw] = reg
    return x


def forward_dwt(plane: torch.Tensor, box, numres: int) -> torch.Tensor:
    """OpenJPEG's forward 5/3 of a tile-component plane (int32) into its
    tile layout: at each resolution the columns, then the rows."""
    res = _resolutions(*box, numres)
    x = plane.clone()
    for r in range(numres - 1, 0, -1):
        rx0, ry0, rx1, ry1 = res[r]
        rw, rh = rx1 - rx0, ry1 - ry0
        if not (rw and rh):
            continue
        reg = x[:rh, :rw]
        low, high = fdwt53_1d(reg.T, ry0 % 2)
        reg = torch.cat([low, high], -1).T
        low, high = fdwt53_1d(reg, rx0 % 2)
        x[:rh, :rw] = torch.cat([low, high], -1)
    return x


def _band_boxes(box, numres: int):
    """(x0, y0, x1, y1) of each band's region in the tile layout, in
    resolution order (LL; then HL, LH, HH of each resolution), with its
    orientation and level."""
    res = _resolutions(*box, numres)
    out = []
    for r in range(numres):
        level = numres - 1 - r
        if r == 0:
            w, h = res[0][2] - res[0][0], res[0][3] - res[0][1]
            out.append(((0, 0, w, h), 0))
            continue
        px0, py0, px1, py1 = res[r - 1]
        for orient in (1, 2, 3):
            xb, yb = orient & 1, orient >> 1
            bx0 = -(-(box[0] - (xb << level)) >> (level + 1))
            bx1 = -(-(box[2] - (xb << level)) >> (level + 1))
            by0 = -(-(box[1] - (yb << level)) >> (level + 1))
            by1 = -(-(box[3] - (yb << level)) >> (level + 1))
            ox = px1 - px0 if xb else 0
            oy = py1 - py0 if yb else 0
            out.append(((ox, oy, ox + bx1 - bx0, oy + by1 - by0), orient))
    return out


def dequantise(plane: torch.Tensor, box, coding: Coding, quant: Quant,
               prec: int) -> torch.Tensor:
    """Tier-1's output -> coefficients: halved toward zero (5/3, int32), or
    times half of each band's step (9/7, float32)."""
    if coding.qmfbid == 1:
        return torch.div(plane, 2, rounding_mode="trunc")
    out = plane.float()
    for ((x0, y0, x1, y1), _), (expn, mant) in zip(
            _band_boxes(box, coding.numres), quant.steps):
        step = np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))
        out[y0:y1, x0:x1] = out[y0:y1, x0:x1] * (np.float32(0.5) * step)
    return out


def _yuv_to_rgb(y, u, v, top: int) -> torch.Tensor:
    """OpenCV's cvtColor(COLOR_YUV2BGR) on [Y, U, V] planes (int64), as
    R, G, B."""
    half = (top + 1) // 2
    u, v = u - half, v - half
    b = y + ((u * U2B + (1 << 13)) >> 14)
    g = y + ((u * U2G + v * V2G + (1 << 13)) >> 14)
    r = y + ((v * V2R + (1 << 13)) >> 14)
    return torch.stack([r, g, b]).clamp(0, top)


def jpeg2000_pixels(dec: Decoded, device) -> torch.Tensor:
    """decode_jpeg2000's output -> cv2.imread's image in RGB(A) order on
    ``device``: [H, W] for one component, else [H, W, C]; uint8 or
    uint16."""
    dev = resolve_device(device)
    top = (1 << dec.prec) - 1
    nc = dec.tiles[0][2].shape[0]
    img = torch.empty((nc, dec.height, dec.width), dtype=torch.int64,
                      device=dev)
    for box, coding, planes in dec.tiles:
        x0, y0, x1, y1 = box
        comps = []
        for c in range(nc):
            plane = torch.from_numpy(planes[c]).to(dev)
            co = dequantise(plane, box, coding.comps[c], coding.quants[c],
                            dec.prec)
            comps.append(inverse_dwt(co, box, coding.comps[c].numres,
                                     coding.comps[c].qmfbid == 1))
        if coding.mct and nc >= 3:
            y, u, v = comps[:3]
            if coding.comps[0].qmfbid == 1:
                g = y - ((u + v) >> 2)
                comps[:3] = [v + g, g, u + g]
            else:
                r = y + v * np.float32(1.402)
                g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
                b = y + u * np.float32(1.772)
                comps[:3] = [r, g, b]
        for c in range(nc):
            x = comps[c]
            if x.dtype == torch.float32:
                x = torch.round(x).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
            x = x.to(torch.int64) + (1 << (dec.prec - 1))
            img[c, y0:y1, x0:x1] = x.clamp(0, top)
    if dec.colourspace == 18 and nc == 3:
        img = _yuv_to_rgb(img[0], img[1], img[2], top)
    out = img.to(torch.uint8 if dec.prec == 8 else torch.uint16)
    out = out[0] if nc == 1 else out.permute(1, 2, 0).contiguous()
    return out


def read_jpeg2000(path, device="cuda") -> torch.Tensor:
    """cv2.imread(path, IMREAD_UNCHANGED) of a JPEG 2000 file in RGB(A)
    order on ``device``."""
    return jpeg2000_pixels(decode_jpeg2000(path), device)


# ---------------------------------------------------------------- writer

def _samples(img, name: str):
    """An image as cv2.imwrite takes it: an [H, W] or [H, W, 3 | 4] tensor
    of uint8 or uint16 (a tensor of those stays on its device; other dtypes
    become uint8 as OpenCV's convertTo makes them)."""
    if torch.is_tensor(img) and img.dtype in (torch.uint8, torch.uint16):
        x = img
    else:
        arr = img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
        if arr.dtype != np.uint16:
            arr = to_uint8(arr, name)
        x = torch.from_numpy(np.ascontiguousarray(arr))
    if x.dim() == 3 and x.shape[2] == 1:
        x = x[..., 0]
    if x.dim() not in (2, 3) or (x.dim() == 3 and x.shape[2] not in (3, 4)):
        raise ValueError(f"{name}: JPEG 2000 takes gray, RGB or RGBA "
                         f"images, got shape {tuple(x.shape)}")
    return x


def encoder_header(h: int, w: int, nc: int, prec: int) -> Tuple[bytes,
                                                                bytes]:
    """The JP2 boxes before the codestream (without the jp2c box's own
    header) and the main header, as OpenJPEG writes them for cv2."""
    ihdr = struct.pack(">4sIIHBBBB", b"ihdr", h, w, nc, prec - 1, 7, 0, 0)
    colr = struct.pack(">4sBBBI", b"colr", 1, 0, 0, 16 if nc >= 3 else 17)
    boxes = [struct.pack(">I", 4 + len(ihdr)) + ihdr,
             struct.pack(">I", 4 + len(colr)) + colr]
    if nc == 4:
        cdef = struct.pack(">4sH", b"cdef", 4) + b"".join(
            struct.pack(">HHH", i, 0, i + 1) for i in range(3)) + \
            struct.pack(">HHH", 3, 1, 0)
        boxes.append(struct.pack(">I", 4 + len(cdef)) + cdef)
    jp2h = b"".join(boxes)
    head = JP2_SIGNATURE + struct.pack(">I4s4sI4s", 20, b"ftyp", b"jp2 ", 0,
                                       b"jp2 ") \
        + struct.pack(">I4s", 8 + len(jp2h), b"jp2h") + jp2h
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + \
        bytes([prec - 1, 1, 1]) * nc
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, 5, 4, 4, 0, 1)
    qcd = bytes([0x40]) + bytes([(prec + g) << 3 for g in
                                 [0] + [1, 1, 2] * 5])
    com = struct.pack(">H", 1) + COMMENT
    main = b"\xff\x4f"
    for code, seg in ((0xFF51, siz), (0xFF52, cod), (0xFF5C, qcd),
                      (0xFF64, com)):
        main += struct.pack(">HH", code, 2 + len(seg)) + seg
    return head, main


def rate_budget(h: int, w: int, nc: int, prec: int, header: int) -> int:
    """OpenJPEG's byte budget for the packets of a one-tile, one-layer
    image at cv2's rate 4 after ``header`` bytes (opj_j2k_update_rates, in
    its float32 arithmetic, then opj_tcd_rateallocate's ceil)."""
    f = np.float32(float(nc * prec) * w * h / float(np.float32(RATE)
                                                   * np.float32(8)))
    f = np.float32(f - np.float32(0))
    f = np.float32(f - np.float32(header))
    if f < 30:
        f = np.float32(30)
    return int(np.ceil(np.float64(f)))


class Planes(NamedTuple):
    """An image's wavelet coefficients as the encoder's host part takes
    them: [C, H, W] int32 in OpenJPEG's tile layout, and the precision."""
    coeffs: np.ndarray
    prec: int


def encoder_planes(img, device="cuda", name="encode_jpeg2000") -> Planes:
    """The device part of writing a .jp2: the DC shift and the forward 5/3
    (five decompositions) of each component on ``device``, copied to the
    host."""
    dev = resolve_device(device)
    x = _samples(img, name)
    h, w = x.shape[:2]
    if min(h, w) < MIN_SIDE:
        raise ValueError(f"{name}: {w}x{h} is smaller than {MIN_SIDE} "
                         "pixels a side, where OpenJPEG's 6 resolutions "
                         "stop cv2.imwrite (it returns False)")
    prec = 16 if x.dtype == torch.uint16 else 8
    x = x.to(dev).to(torch.int32)
    x = (x[None] if x.dim() == 2 else x.permute(2, 0, 1)) - (1 << (prec - 1))
    planes = torch.stack([forward_dwt(c, (0, 0, w, h), 6) for c in x])
    return Planes(np.ascontiguousarray(planes.cpu().numpy()), prec)


def encode_planes(planes: Planes, name="encode_jpeg2000") -> bytes:
    """The host part of writing a .jp2: tier-1, OpenJPEG's rate search for
    one layer, tier-2, the markers and the JP2 boxes."""
    nc, h, w = planes.coeffs.shape
    prec = planes.prec
    head, main = encoder_header(h, w, nc, prec)
    coding = TileCoding(0, 1, 0, 0, (Coding(
        6, 6, 6, 1, ((15, 15),) * 6),) * nc, (Quant(2, tuple(
            (prec + g, 0) for g in [0] + [1, 1, 2] * 5)),) * nc)
    params = tile_params((0, 0, w, h), coding)
    maxlen = rate_budget(h, w, nc, prec, len(head) + 8 + len(main))
    cap = max(planes.coeffs.size * 4, 1 << 16) + 65536
    out = np.empty(cap, np.uint8)
    n = codec_library().j2k_encode_tile(
        _ptr(planes.coeffs, ctypes.c_int32), _ptr(params, ctypes.c_int32),
        maxlen, _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError(f"{name}: the JPEG 2000 encoder failed ({n})")
    sot = struct.pack(">HHHIBB", 0xFF90, 10, 0, 12 + 2 + n, 0, 1)
    cs = main + sot + b"\xff\x93" + out[:n].tobytes() + b"\xff\xd9"
    return head + struct.pack(">I4s", 8 + len(cs), b"jp2c") + cs


def encode_jpeg2000(img, device="cuda", name="encode_jpeg2000") -> bytes:
    """The bytes cv2.imwrite(".jp2") writes for an [H, W] or [H, W, 3 | 4]
    RGB(A) image (``name``, the file's, heads any error): the wavelet
    transform on ``device`` (encoder_planes), then the coding on the host
    (encode_planes)."""
    return encode_planes(encoder_planes(img, device, name), name)


def write_jpeg2000(path, img, device="cuda") -> None:
    """cv2.imwrite(path, img) for a .jp2 path at its defaults."""
    Path(path).write_bytes(encode_jpeg2000(img, device, str(path)))
