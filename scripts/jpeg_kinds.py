"""Writers of the JPEG kinds that cv2.imread reads and neither package
writes: arithmetic-coded files (SOF9 sequential and SOF10 progressive, with
restart intervals and DAC conditioning), 4-component files (CMYK and YCCK,
under an Adobe APP14 marker) and lossless files (SOF3: predictors 1-7, a
point transform, restart intervals, precisions 2-16).

Support for the tests and ``chip_smoke.py``, which holds the port's reader
to them on the card (where no OpenCV or Pillow is installed). It imports
torch, numpy and the port, never OpenCV, Pillow or the JAX package. The
arithmetic coder is C++ (``scripts/jpeg_kinds.cpp``, libjpeg-turbo's
jcarith.c), built with g++ at first use by
``nerfpp_tpu_torch.native.build_library``; the lossless coder is numpy.

    plan = plan_of(jpeg_bytes)            # the quantised blocks of a file
    arith_bytes(plan, progressive=True, restart=4, dac={("dc", 0): (1, 3)})
    huffman_bytes(planes_plan([c, m, y, k]), app=adobe(0))      # CMYK
    lossless_bytes([r, g, b], psv=7, pt=1, app=adobe(0))
    rewrite(path, "arith" | "arith_progressive" | "cmyk" | "lossless", dev)

A file written from ``plan_of`` of a Huffman file holds the same blocks,
so every reader must decode it to the same pixels.
"""
from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import native, resolve_device
from nerfpp_tpu_torch.utils import jpeg as J

SOURCE = Path(__file__).resolve().with_suffix(".cpp")
# rewrite()'s kinds, the view rewrites of chip_smoke.py's phase 20
KINDS = ("arith", "arith_progressive", "cmyk", "lossless")

_lib = None


def encoder_library() -> ctypes.CDLL:
    """The arithmetic coder, built with g++ on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, J.CXX_FLAGS)))
        i32, i32p = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.jpeg_encode_arith_scan.restype = ctypes.c_int64
        lib.jpeg_encode_arith_scan.argtypes = [
            i32, i32p, i32p, i32p, u8p, i32, i32, i32, i32, i32, i32, i32,
            i32, ctypes.POINTER(ctypes.c_void_p), u8p, ctypes.c_int64]
        _lib = lib
    return _lib


@dataclass
class Component:
    id: int
    h: int
    v: int
    tq: int
    blocks: np.ndarray            # int16 [R, C, 64], natural order


@dataclass
class Plan:
    """A DCT frame to write: its size, its components with their blocks
    over the whole MCU grid, its quantisation tables (natural order)."""
    height: int
    width: int
    comps: List[Component]
    quant: Dict[int, np.ndarray]


segment = J._segment          # a marker segment: FF, marker, length, payload
JFIF = segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment: transform 0 (RGB or CMYK), 1 (YCbCr) or 2
    (YCCK)."""
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                transform))


def plan_of(data: bytes) -> Plan:
    """The blocks and tables of a sequential or progressive Huffman file,
    as the port's decoder reads them."""
    frame = J.decode_coefficients(data, "plan_of")
    quant = {c.tq: c.quant for c in frame.components}
    comps = [Component(c.id, c.h, c.v, c.tq, c.coefs)
             for c in frame.components]
    return Plan(frame.height, frame.width, comps, quant)


def _downsample(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """[H, W] -> [ceil(H / fy), ceil(W / fx)], box means rounded (the edge
    repeated out to whole boxes)."""
    h, w = x.shape
    rows, cols = J._ceil_div(h, fy), J._ceil_div(w, fx)
    x = J._pad_edges(x, rows * fy, cols * fx)
    s = x.view(rows, fy, cols, fx).sum((1, 3))
    return (s + fy * fx // 2) // (fy * fx)


def planes_plan(planes, sampling: Optional[Sequence[Tuple[int, int]]] = None,
                quality: int = 95, ids: Optional[Sequence[int]] = None,
                device="cpu") -> Plan:
    """A frame of full-size uint8 planes [H, W] (numpy or torch), each
    downsampled to its ``sampling`` (h, v; 1x1 each by default) by box
    means, transformed and quantised as the port's encoder does (the
    quality-scaled luma table for the first plane, the chroma table for the
    rest)."""
    dev = resolve_device(device)
    planes = [torch.as_tensor(np.asarray(p) if not torch.is_tensor(p) else p)
              .to(dev).to(torch.int64) for p in planes]
    n = len(planes)
    sampling = list(sampling or [(1, 1)] * n)
    ids = list(ids or range(1, n + 1))
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    my, mx = J._ceil_div(height, 8 * vmax), J._ceil_div(width, 8 * hmax)
    quant = {0: J.quality_table(J.LUMA_QUANT, quality)}
    if n > 1:
        quant[1] = J.quality_table(J.CHROMA_QUANT, quality)
    comps = []
    for i, (p, (h, v)) in enumerate(zip(planes, sampling)):
        sub = _downsample(p, vmax // v, hmax // h)
        sub = J._pad_edges(sub, 8 * my * v, 8 * mx * h)
        tq = 0 if i == 0 else 1
        comps.append(Component(ids[i], h, v, tq, np.ascontiguousarray(
            J._blocks(sub, quant[tq]).cpu().numpy())))
    return Plan(height, width, comps, quant)


def _scan_geometry(plan: Plan, comps: Sequence[int]):
    """(blocks per MCU of each component, MCUs down, MCUs across) of a scan
    of ``comps``, as a reader lays it out."""
    hmax = max(c.h for c in plan.comps)
    vmax = max(c.v for c in plan.comps)
    if len(comps) == 1:
        c = plan.comps[comps[0]]
        return ([(1, 1)],
                J._ceil_div(J._ceil_div(plan.height * c.v, vmax), 8),
                J._ceil_div(J._ceil_div(plan.width * c.h, hmax), 8))
    return ([(plan.comps[i].h, plan.comps[i].v) for i in comps],
            J._ceil_div(plan.height, 8 * vmax),
            J._ceil_div(plan.width, 8 * hmax))


def _header(plan: Plan, sof: int, app: bytes, restart: int,
            extra: bytes = b"") -> bytes:
    dqt = b"".join(segment(0xDB, bytes([t]) + q[J.ZIGZAG].astype(np.uint8)
                           .tobytes()) for t, q in sorted(plan.quant.items()))
    frame = struct.pack(">BHHB", 8, plan.height, plan.width, len(plan.comps))
    for c in plan.comps:
        frame += bytes([c.id, (c.h << 4) | c.v, c.tq])
    dri = segment(0xDD, struct.pack(">H", restart)) if restart else b""
    return (b"\xff\xd8" + app + dqt + extra + segment(sof, frame) + dri)


def _sos(plan: Plan, comps, tables, ss, se, ah, al) -> bytes:
    body = bytes([len(comps)])
    for i in comps:
        body += bytes([plan.comps[i].id, (tables[i] << 4) | tables[i]])
    return segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def progression(n: int):
    """libjpeg's jpeg_simple_progression for ``n`` components: (components,
    Ss, Se, Ah, Al) of each scan."""
    if n == 3:
        return J.PROGRESSION_YCC
    allc = tuple(range(n))
    each = lambda ss, se, ah, al: [((c,), ss, se, ah, al) for c in allc]
    return tuple([(allc, 0, 0, 0, 1)] + each(1, 5, 0, 2) + each(6, 63, 0, 2)
                 + each(1, 63, 2, 1) + [(allc, 0, 0, 1, 0)]
                 + each(1, 63, 1, 0))


def conditioning(dac: Optional[dict]):
    """DAC values {("dc", t): (L, U), ("ac", t): Kx} -> (the 48 bytes the
    coders take: L, U and Kx of tables 0-15, libjpeg's defaults 0, 1 and 5
    elsewhere, and the DAC segment, empty without ``dac``)."""
    cond = np.array([0] * 16 + [1] * 16 + [5] * 16, np.uint8)
    body = b""
    for (kind, t), val in sorted((dac or {}).items()):
        if kind == "dc":
            lo, hi = val
            cond[t], cond[16 + t] = lo, hi
            body += bytes([t, (hi << 4) | lo])
        else:
            cond[32 + t] = val
            body += bytes([16 + t, val])
    return cond, (segment(0xCC, body) if body else b"")


def arith_bytes(plan: Plan, progressive: bool = False, restart: int = 0,
                dac: Optional[dict] = None, app: bytes = JFIF,
                script=None, tables: Optional[Sequence[int]] = None) -> bytes:
    """The plan as an arithmetic-coded file: SOF9 with one interleaved
    scan, or SOF10 with ``script`` (progression()'s by default); a DRI of
    ``restart`` MCUs; a DAC segment of ``dac``; the DC and AC conditioning
    table of component i ``tables[i]`` (0 for the first, 1 for the rest by
    default)."""
    n = len(plan.comps)
    tables = list(tables if tables is not None else [0] + [1] * (n - 1))
    cond, dac_seg = conditioning(dac)
    out = [_header(plan, 0xCA if progressive else 0xC9, app, restart,
                   dac_seg)]
    if progressive:
        script = script or progression(n)
    else:
        script = [(tuple(range(n)), 0, 63, 0, 0)]
    lib = encoder_library()
    for comps, ss, se, ah, al in script:
        hv, rows, cols = _scan_geometry(plan, comps)
        grid = np.asarray([plan.comps[i].blocks.shape[:2] for i in comps],
                          np.int32)
        tab = np.asarray([(tables[i], tables[i]) for i in comps], np.int32)
        blocks = [np.ascontiguousarray(plan.comps[i].blocks, np.int16)
                  for i in comps]
        ptrs = (ctypes.c_void_p * len(comps))(*[b.ctypes.data
                                                for b in blocks])
        cap = sum(b.size for b in blocks) * 4 + 1024
        data = np.empty(cap, np.uint8)
        size = lib.jpeg_encode_arith_scan(
            len(comps), J._ptr(np.asarray(hv, np.int32), ctypes.c_int32),
            J._ptr(grid, ctypes.c_int32), J._ptr(tab, ctypes.c_int32),
            J._ptr(cond, ctypes.c_uint8), cols, rows, restart,
            int(progressive), ss, se, ah, al, ptrs,
            J._ptr(data, ctypes.c_uint8), cap)
        if size < 0:
            raise ValueError(f"arithmetic encoding failed ({size})")
        out.append(_sos(plan, comps, tables, ss, se, ah, al)
                   + data[:size].tobytes())
    return b"".join(out) + b"\xff\xd9"


def huffman_bytes(plan: Plan, app: bytes = JFIF, sof: int = 0xC0) -> bytes:
    """The plan as a sequential Huffman file of one interleaved scan with
    the standard tables (table 0 for the first component, 1 for the
    rest)."""
    n = len(plan.comps)
    hv, rows, cols = _scan_geometry(plan, tuple(range(n)))
    parts, owner = [], []
    for i, c in enumerate(plan.comps):
        g = c.blocks[:rows * c.v, :cols * c.h].reshape(
            rows, c.v, cols, c.h, 64).transpose(0, 2, 1, 3, 4)
        parts.append(g.reshape(rows, cols, c.v * c.h, 64))
        owner.append(np.full(c.v * c.h, i, np.int32))
    blocks = np.ascontiguousarray(np.concatenate(parts, 2).reshape(-1, 64),
                                  np.int16)
    comp = np.ascontiguousarray(np.tile(np.concatenate(owner), rows * cols))
    tabs = [0] + [1] * (n - 1)
    comp_tables = np.asarray([(t, t) for t in tabs], np.int32)
    counts, symbols = J._huffman_arrays(J.STD_HUFFMAN)
    cap = blocks.shape[0] * 512 + 64
    data = np.empty(cap, np.uint8)
    size = J.entropy_library().jpeg_encode_scan(
        J._ptr(blocks, ctypes.c_int16), blocks.shape[0],
        J._ptr(comp, ctypes.c_int32), n, J._ptr(comp_tables, ctypes.c_int32),
        J._ptr(counts, ctypes.c_uint8), J._ptr(symbols, ctypes.c_uint8),
        J._ptr(data, ctypes.c_uint8), cap)
    if size < 0:
        raise ValueError(f"Huffman encoding failed ({size})")
    dht = b"".join(segment(0xC4, bytes([(tc << 4) | t]) + J.STD_HUFFMAN[
        (tc, t)]) for t in sorted(set(tabs)) for tc in (0, 1))
    return (_header(plan, sof, app, 0, dht)
            + _sos(plan, tuple(range(n)), tabs, 0, 63, 0, 0)
            + data[:size].tobytes() + b"\xff\xd9")


# ----------------------------------------------------------------- lossless

# the lossless files' Huffman table of the 17 difference sizes: 2 bits for
# size 0, 3 for sizes 1-5, one bit more for each size after (no code all
# ones)
LOSSLESS_TABLE = bytes([0, 1, 5] + [1] * 11 + [0, 0]) + bytes(range(17))


def _codes(spec: bytes):
    """A DHT table's code and length of each symbol (dicts)."""
    code, k, codes, lengths = 0, 16, {}, {}
    for ln in range(1, 17):
        for _ in range(spec[ln - 1]):
            codes[spec[k]], lengths[spec[k]] = code, ln
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Bit strings (each ``lengths`` bits of ``values``, most significant
    first) as entropy-coded bytes: one bits to the byte, FF stuffed."""
    total = int(lengths.sum())
    if total == 0:
        return b""
    starts = np.cumsum(lengths) - lengths
    idx = np.repeat(np.arange(values.size), lengths)
    pos = np.arange(total) - starts[idx]
    bits = (values[idx] >> (lengths[idx] - 1 - pos).astype(np.uint64)) & 1
    bits = np.concatenate([bits.astype(np.uint8),
                           np.ones((-total) % 8, np.uint8)])
    out = np.packbits(bits)
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _differences(x: np.ndarray, psv: int, initial: int,
                 first_rows) -> np.ndarray:
    """The sample differences of a component [rows, cols] (already shifted
    by Pt) under predictor ``psv``: each row in ``first_rows`` predicted
    from ``initial`` and its left neighbour, every other row's first sample
    from the one above, as jdlossls.c undoes them; modulo 2^16, in
    -32767..32768."""
    x = x.astype(np.int64)
    ra = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], 1)
    rb = np.concatenate([np.zeros_like(x[:1]), x[:-1]], 0)
    rc = np.concatenate([np.zeros_like(rb[:, :1]), rb[:, :-1]], 1)
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    first = np.zeros(x.shape[0], bool)
    first[list(first_rows)] = True
    pred[first] = ra[first]
    pred[first, 0] = initial
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def lossless_bytes(planes, sampling=None, precision: int = 8, psv: int = 1,
                   pt: int = 0, restart: int = 0, ids=None, app: bytes = b"",
                   interleave: bool = True) -> bytes:
    """A lossless (SOF3) file of component planes (numpy [rows, cols] of
    samples below 2^precision, each its component's own size) with their
    ``sampling`` (h, v; 1x1 each by default): predictor ``psv``, point
    transform ``pt``, a restart every ``restart`` MCUs (a whole number of
    MCU rows), one interleaved scan or (``interleave`` False) a scan a
    component, every difference coded with LOSSLESS_TABLE."""
    planes = [np.asarray(p).astype(np.int64) >> pt for p in planes]
    n = len(planes)
    sampling = list(sampling or [(1, 1)] * n)
    ids = list(ids or range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    ch, cw = planes[0].shape
    height, width = (J._ceil_div(ch * vmax, sampling[0][1]),
                     J._ceil_div(cw * hmax, sampling[0][0]))
    initial = 1 << (precision - pt - 1)
    frame = struct.pack(">BHHB", precision, height, width, n)
    for i, (h, v) in enumerate(sampling):
        frame += bytes([ids[i], (h << 4) | v, 0])
    head = (b"\xff\xd8" + app + segment(0xC3, frame)
            + segment(0xC4, b"\x00" + LOSSLESS_TABLE)
            + (segment(0xDD, struct.pack(">H", restart)) if restart else b""))
    scans = [tuple(range(n))] if interleave and n > 1 else [(i,) for i in
                                                            range(n)]
    out = [head]
    for comps in scans:
        inter = len(comps) > 1
        if inter:
            mcus_y = J._ceil_div(height, vmax)
            mcus_x = J._ceil_div(width, hmax)
        else:
            mcus_y, mcus_x = planes[comps[0]].shape
        per_row = restart // mcus_x if restart else 0
        parts = []
        for i in comps:
            x = planes[i]
            h, v = sampling[i] if inter else (1, 1)
            vf = sampling[i][1]
            rows_restart = (range(per_row, mcus_y, per_row) if per_row
                            else ())
            if inter:
                first_rows = {0} | {r * v for r in rows_restart}
            else:
                first_rows = {0} | {r // vf * vf for r in rows_restart}
            d = _differences(x, psv, initial, sorted(first_rows))
            full = np.zeros((mcus_y * v, mcus_x * h), np.int64)
            full[:d.shape[0], :d.shape[1]] = d
            parts.append(full.reshape(mcus_y, v, mcus_x, h).transpose(
                0, 2, 1, 3).reshape(mcus_y, mcus_x, v * h))
        diffs = np.concatenate(parts, 2)           # [rows, cols, samples]
        mag = np.abs(diffs)
        size = np.frexp(mag.astype(np.float64))[1].astype(np.int64)
        size[diffs == 32768] = 16
        extra = np.where(diffs < 0, diffs - 1, diffs) & ((1 << size) - 1)
        extra[size == 16] = 0
        codes, lengths = _codes(LOSSLESS_TABLE)
        code = np.array([codes[s] for s in range(17)])[size]
        clen = np.array([lengths[s] for s in range(17)])[size]
        bits = np.where(size == 16, 0, size)
        values = ((code << bits) | extra).astype(np.uint64)
        lengths = (clen + bits).astype(np.int64)
        values, lengths = values.reshape(-1), lengths.reshape(-1)
        step = restart * diffs.shape[2] if restart else values.size
        data = []
        for j, at in enumerate(range(0, values.size, step)):
            if j:
                data.append(bytes([0xFF, 0xD0 + (j - 1) % 8]))
            data.append(_pack(values[at:at + step], lengths[at:at + step]))
        sos = bytes([len(comps)])
        for i in comps:
            sos += bytes([ids[i], 0])
        out.append(segment(0xDA, sos + bytes([psv, 0, pt])) + b"".join(data))
    return b"".join(out) + b"\xff\xd9"


# ------------------------------------------------------------ view rewrites

def cmyk_planes(rgb: torch.Tensor):
    """The Adobe CMYK planes (stored inverted, as Pillow writes an RGB
    image converted to CMYK) of a uint8 [H, W, 3] RGB image: R, G, B and
    255."""
    return [rgb[..., 0], rgb[..., 1], rgb[..., 2],
            torch.full_like(rgb[..., 0], 255)]


def ycck_planes(cmyk):
    """YCCK planes of Adobe CMYK planes, as jccolor.c's cmyk_ycck_convert
    makes them: the YCbCr of 255 - C, 255 - M, 255 - Y, and K."""
    rgb = torch.stack([255 - torch.as_tensor(p).to(torch.int64)
                       for p in cmyk[:3]], -1)
    ycc = J.rgb_to_ycc(rgb)
    return [ycc[..., 0], ycc[..., 1], ycc[..., 2],
            torch.as_tensor(cmyk[3]).to(torch.int64)]


def rewrite(path, kind: str, device="cuda") -> int:
    """Rewrite the baseline JPEG view at ``path`` as ``kind`` (KINDS):
    "arith" (its blocks arithmetic-coded, SOF9, a restart every MCU row,
    DC conditioning L = 1, U = 4 and Kx = 8 on the luma tables),
    "arith_progressive" (its blocks in libjpeg's simple progression, SOF10),
    "cmyk" (Adobe CMYK of its decoded pixels, baseline at quality 95) or
    "lossless" (its decoded pixels as RGB, SOF3, predictor 1). Returns the
    new file's size."""
    from nerfpp_tpu_torch.utils.image import read_image
    path = Path(path)
    data = path.read_bytes()
    if kind in ("arith", "arith_progressive"):
        plan = plan_of(data)
        if kind == "arith":
            _, _, cols = _scan_geometry(plan, tuple(range(len(plan.comps))))
            new = arith_bytes(plan, restart=cols,
                              dac={("dc", 0): (1, 4), ("ac", 0): 8})
        else:
            new = arith_bytes(plan, progressive=True)
    elif kind == "cmyk":
        img = read_image(path, device)
        new = huffman_bytes(planes_plan(cmyk_planes(img), device=device),
                            app=adobe(0))
    elif kind == "lossless":
        img = read_image(path, device).cpu().numpy()
        new = lossless_bytes([img[..., c] for c in range(3)], app=adobe(0))
    else:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    path.write_bytes(new)
    return len(new)
