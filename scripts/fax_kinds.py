"""CCITT fax encoders (ITU-T T.4 and T.6) for bilevel test images, numpy
only: Modified Huffman rows byte- or word-aligned (TIFF compression 2 and
32771), Group 3 one- or two-dimensional rows each after an EOL, with or
without fill bits (compression 3, T4Options bits 0 and 2), and Group 4
(compression 4). Each function codes a strip or tile whose pixels are 0
(a white-coded run) or 1 (a black-coded run) and returns its bytes, most
significant bit first (FillOrder 1). The two-dimensional coder makes the
choices libtiff's Fax3Encode2DRow makes (pass, vertical within 3,
horizontal).

The CPU tests hold the port's decoder (utils/tiff.py, csrc/tiff_codec.cpp)
to cv2.imread on what these write; chip_smoke.py writes its fax views with
them on the GPU machine, which has neither Pillow nor OpenCV.

    from scripts.fax_kinds import encode_g4
    strip = encode_g4(bits)          # bits: uint8 [rows, width] of 0 / 1
"""
from __future__ import annotations

import numpy as np

WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 "
    "01100111 011001100 011001101 011010010 011010011 011010100 011010101 "
    "011010110 011010111 011011000 011011001 011011010 011011011 010011000 "
    "010011001 010011010 011000 010011011").split()
BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111"
).split()
BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 "
    "0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
# 1792..2560, by 64, both colours
EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
EOL = "000000000001"
PASS, HORIZONTAL = "0001", "001"
# vertical mode by b1 - a1 (-3 .. 3): a1 right of b1 first
VERTICAL = ("0000011", "000011", "011", "1", "010", "000010", "0000010")


def span(n: int, black: bool) -> str:
    """A run of ``n`` pixels of one colour as make-up and terminating codes
    (libtiff's putspan)."""
    term = BLACK_TERM if black else WHITE_TERM
    makeup = BLACK_MAKEUP if black else WHITE_MAKEUP
    out = []
    while n >= 2624:
        out.append(EXT_MAKEUP[-1])
        n -= 2560
    if n >= 64:
        k = n >> 6
        out.append(makeup[k - 1] if k <= 27 else EXT_MAKEUP[k - 28])
        n -= k << 6
    out.append(term[n])
    return "".join(out)


def changes(row: np.ndarray) -> np.ndarray:
    """The changing elements of a row (positions whose pixel differs from
    the one before, an imaginary white pixel before the first), then the
    width twice: int64."""
    r = np.asarray(row, np.int8)
    d = np.flatnonzero(np.diff(np.concatenate([[0], r])))
    return np.concatenate([d, [r.size, r.size]]).astype(np.int64)


def mh_row(row: np.ndarray) -> str:
    """One row's Modified Huffman code: runs white, black, ... from white."""
    ch = changes(row)[:-1]
    out, x, black = [], 0, False
    for c in ch:
        out.append(span(int(c) - x, black))
        x, black = int(c), not black
        if x >= row.size:
            break
    return "".join(out)


def _next(ch: np.ndarray, after: int) -> int:
    """The first changing element of ``ch`` at or after ``after``."""
    return int(ch[np.searchsorted(ch, after)])


def mr_row(row: np.ndarray, ref: np.ndarray) -> str:
    """One row coded against the reference row (T.4 4.2 / T.6), with the
    choices of libtiff's Fax3Encode2DRow."""
    width = row.size
    cur, prev = changes(row), changes(ref)
    pixel = np.concatenate([np.asarray(row, np.int8), [0]])
    rpix = np.concatenate([np.asarray(ref, np.int8), [0]])

    def finddiff(pix, ch, start, colour):
        # the first position at or after start whose pixel is not colour
        if start >= width:
            return width
        if pix[start] != colour:
            return start
        return _next(ch, start + 1)

    a0 = 0
    a1 = 0 if pixel[0] else _next(cur, 1)
    b1 = 0 if rpix[0] else _next(prev, 1)
    out = []
    while True:
        b2 = finddiff(rpix, prev, b1, rpix[b1] if b1 < width else 0)
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = finddiff(pixel, cur, a1, pixel[a1] if a1 < width else 0)
                black_first = not (a0 + a1 == 0 or pixel[a0] == 0)
                out.append(HORIZONTAL + span(a1 - a0, black_first)
                           + span(a2 - a1, not black_first))
                a0 = a2
            else:
                out.append(VERTICAL[d + 3])
                a0 = a1
        else:
            out.append(PASS)
            a0 = b2
        if a0 >= width:
            return "".join(out)
        colour = pixel[a0]
        a1 = finddiff(pixel, cur, a0, colour)
        b1 = finddiff(rpix, prev, a0, 1 - colour)
        b1 = finddiff(rpix, prev, b1, colour)


def _bytes(bits: str, align: int = 8) -> bytes:
    bits += "0" * (-len(bits) % align)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def encode_rle(img: np.ndarray, word: bool = False) -> bytes:
    """Compression 2 (or 32771 with ``word``): each row's Modified Huffman
    code padded to a byte (a 16-bit word), no EOL."""
    return b"".join(_bytes(mh_row(r), 16 if word else 8) for r in img)


def encode_g3(img: np.ndarray, k: int = 1, fill: bool = False) -> bytes:
    """Compression 3: each row after an EOL (``fill``: zeros before it so
    that it ends on a byte, T4Options bit 2); ``k`` > 1 codes every k-th row
    one-dimensionally and the rest against the row above, the EOL then
    followed by a tag bit (1: one-dimensional; T4Options bit 0); six EOLs
    (RTC) end the strip."""
    out = []
    n = 0
    ref = np.zeros(img.shape[1], np.int8)
    for y, row in enumerate(img):
        if fill:
            pad = -(n + 12) % 8
            out.append("0" * pad)
            n += pad
        code = EOL
        if k > 1:
            code += "1" if y % k == 0 else "0"
        code += mh_row(row) if k == 1 or y % k == 0 else mr_row(row, ref)
        out.append(code)
        n += len(code)
        ref = row
    out.append((EOL + ("1" if k > 1 else "")) * 6)
    return _bytes("".join(out))


def encode_g4(img: np.ndarray) -> bytes:
    """Compression 4: every row against the row above (an all-white row
    before the first), then EOFB (two EOLs)."""
    out = []
    ref = np.zeros(img.shape[1], np.int8)
    for row in img:
        out.append(mr_row(row, ref))
        ref = row
    out.append(EOL + EOL)
    return _bytes("".join(out))
