"""GIF files of every kind, built byte by byte with numpy: GIF87a and
GIF89a, global and local colour tables of 2-256 entries, graphic control,
application, comment and plain-text extensions, interlaced, offset and
animated frames, and LZW streams with or without a leading clear code, at
any minimum code size, with the table allowed to fill without a clear (a
"deferred clear"), with a given code sequence, or cut short.

The CPU tests hold the port's reader (utils/gif.py, csrc/gif_codec.cpp) to
cv2.imread on what these write, for the kinds neither cv2 nor Pillow
writes; they are test code, independent of the port's reader and writer.

    from scripts.gif_kinds import frame, make_gif
    data = make_gif(9, 11, [frame(indices, left=2, top=3)], palette=pal)
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

INTERLACE_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))   # (first row, step)


def lzw_codes(indices, min_code_size: int = 8, clear_first: bool = True,
              defer_clear: bool = False, end: bool = True
              ) -> List[Tuple[int, int]]:
    """The (code, width in bits) sequence of a greedy LZW coding of
    ``indices``: a clear code first (unless ``clear_first`` is false),
    the width grown once the next free code passes 1 << width (at most
    12 bits), a clear code when the table is full (4,096 codes), or none
    with ``defer_clear`` (the table stays full and the coder goes on with
    the codes it has), and the end code last (unless ``end`` is
    false)."""
    clear = 1 << min_code_size
    out: List[Tuple[int, int]] = []
    table, nxt, width = {}, clear + 2, min_code_size + 1
    if clear_first:
        out.append((clear, width))
    s = None
    for p in np.asarray(indices).ravel().tolist():
        if s is None:
            s = p
            continue
        if (s, p) in table:
            s = table[(s, p)]
            continue
        out.append((s, width))
        if nxt < 4096:
            table[(s, p)] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
            if nxt == 4096 and not defer_clear:
                out.append((clear, width))
                table, nxt, width = {}, clear + 2, min_code_size + 1
        s = p
    if s is not None:
        out.append((s, width))
    if end:
        out.append((clear + 1, width))
    return out


def pack_codes(codes: Sequence[Tuple[int, int]]) -> bytes:
    """Codes packed least significant bit first, the last byte padded with
    zeros."""
    acc, n, out = 0, 0, bytearray()
    for code, width in codes:
        acc |= code << n
        n += width
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    if n:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255, terminator: bool = True
               ) -> bytes:
    """``data`` as data sub-blocks of ``size`` bytes (the last shorter),
    then the block terminator."""
    out = bytearray()
    for i in range(0, len(data), size):
        part = data[i:i + size]
        out += bytes([len(part)]) + part
    return bytes(out + (b"\0" if terminator else b""))


def table_bits(n: int) -> int:
    """The size field of a colour table of at least ``n`` entries."""
    return max(0, int(np.ceil(np.log2(max(n, 2)))) - 1)


def color_table(colors, size_field: Optional[int] = None) -> bytes:
    """RGB triples padded with zeros to 2 << size_field entries."""
    c = np.asarray(colors, np.uint8).reshape(-1, 3)
    k = table_bits(len(c)) if size_field is None else size_field
    pad = np.zeros(((2 << k) - len(c), 3), np.uint8)
    return np.concatenate([c, pad]).tobytes() if len(pad) >= 0 else b""


def extension(label: int, blocks: Sequence[bytes]) -> bytes:
    """An extension of sub-blocks ``blocks``, then the block terminator."""
    return bytes([0x21, label]) + b"".join(
        bytes([len(b)]) + b for b in blocks) + b"\0"


def graphic_control(disposal: int = 0, transparent: Optional[int] = None,
                    delay: int = 0, user_input: bool = False) -> bytes:
    """A graphic control extension."""
    flags = (disposal << 2) | (int(user_input) << 1) | int(
        transparent is not None)
    return extension(0xF9, [struct.pack("<BHB", flags, delay,
                                        transparent or 0)])


def netscape(loops: int = 0) -> bytes:
    """The NETSCAPE2.0 application extension (loop count)."""
    return extension(0xFF, [b"NETSCAPE2.0", struct.pack("<BH", 1, loops)])


def comment(text: bytes) -> bytes:
    return extension(0xFE, [text[i:i + 255]
                            for i in range(0, len(text), 255)])


def plain_text(text: bytes, cols: int = 8, rows: int = 2) -> bytes:
    """A plain-text extension: a grid at (0, 0), cells of 8x8, colours 1
    on 0."""
    return extension(0x01, [struct.pack("<4H4B", 0, 0, cols * 8, rows * 8,
                                        8, 8, 1, 0), text])


def interlaced(indices: np.ndarray) -> np.ndarray:
    """Rows in GIF's interlaced order (passes of 8, 8, 4, 2)."""
    h = indices.shape[0]
    order = [r for first, step in INTERLACE_PASSES
             for r in range(first, h, step)]
    return indices[order]


def frame(indices, left: int = 0, top: int = 0, local=None,
          local_size: Optional[int] = None, interlace: bool = False,
          min_code_size: Optional[int] = None, codes=None,
          data: Optional[bytes] = None, block: int = 255,
          extensions: Sequence[bytes] = (), **lzw) -> bytes:
    """Extensions, an image descriptor, a local colour table (``local``:
    RGB triples) and the image data of uint8 ``indices`` [h, w]: coded by
    ``lzw_codes(..., **lzw)``, or the given ``codes`` ((code, width)
    pairs) or raw LZW ``data``, in sub-blocks of ``block`` bytes."""
    idx = np.asarray(indices)
    h, w = idx.shape
    flags = 0x40 if interlace else 0
    table = b""
    if local is not None:
        table = color_table(local, local_size)
        flags |= 0x80 | (len(table) // 3).bit_length() - 2
    if min_code_size is None:
        min_code_size = max(2, int(idx.max(initial=0)).bit_length())
    if data is None:
        rows = interlaced(idx) if interlace else idx
        data = pack_codes(codes if codes is not None
                          else lzw_codes(rows, min_code_size, **lzw))
    return (b"".join(extensions) + b"\x2c"
            + struct.pack("<4HB", left, top, w, h, flags) + table
            + bytes([min_code_size]) + sub_blocks(data, block))


def make_gif(width: int, height: int, frames: Sequence[bytes],
             palette=None, palette_size: Optional[int] = None,
             background: int = 0, version: bytes = b"89a",
             extensions: Sequence[bytes] = (), trailer: bool = True
             ) -> bytes:
    """A GIF file: header, logical screen (``palette``: the global table's
    RGB triples, or none), ``extensions``, then ``frames`` (from
    ``frame``) and the trailer."""
    flags = 0x70
    table = b""
    if palette is not None:
        table = color_table(palette, palette_size)
        flags |= 0x80 | (len(table) // 3).bit_length() - 2
    return (b"GIF" + version
            + struct.pack("<2H3B", width, height, flags, background, 0)
            + table + b"".join(extensions) + b"".join(frames)
            + (b"\x3b" if trailer else b""))
