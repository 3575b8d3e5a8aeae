"""GIF reading (nerfpp_tpu_torch/utils/gif.py, csrc/gif_codec.cpp) against
cv2.imread(IMREAD_UNCHANGED), OpenCV 5.0.0's own GIF decoder, on the CPU:

- cv2's and Pillow's files (palette, gray, RGB, interlaced, animated with
  transparency) and the kinds neither writes, built by scripts/gif_kinds.py:
  GIF87a and GIF89a, global and local tables of 2-256 entries and none,
  interlaced frames of every height, the transparent index used and
  unused, a first frame smaller than and offset on the screen, animated
  files (the first frame; the channel count from the last graphic control
  extension), minimum code sizes 2-11, codes that reach 4,095 with clears
  and without (a deferred clear), an end code before the last pixel, codes
  after the last pixel, codes past the table;
- files cut at every byte, and every kind cv2 returns None for, raising
  ValueError naming the file (among them most files with a 3-byte
  sub-block in an application extension not named NETSCAPE2.0, which
  OpenCV's walk misreads);
- the committed fixtures (tests/data/image/gif*: cv2's pixels as .npy) and
  a seeded fuzz of random files.
"""
import io
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import gif as G
from nerfpp_tpu_torch.utils.image import image_format, read_image
from scripts import gif_kinds as K
from tests.torch_image_common import (FIXTURES, cv2_gif, cv2_read,
                                      gif_fixture_files, pattern, pillow_gif)

torch.set_num_threads(1)


def pal(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 3))


def check(tmp_path, files):
    """Each {name: bytes} read by the port as cv2.imread reads it; a file
    cv2 returns None for raises ValueError naming it. Returns the names
    cv2 refused."""
    refused = []
    for name, data in files.items():
        p = tmp_path / f"{name}.gif"
        p.write_bytes(data)
        want = cv2_read(p)
        if want is None:
            with pytest.raises(ValueError, match=rf"{p.name}.*cv2\.imread "
                               "returns no image"):
                read_image(p, "cpu")
            refused.append(name)
            continue
        got = read_image(p, "cpu").numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return refused


def tables_kinds():
    rng = np.random.RandomState(1)
    out = {}
    for version in (b"87a", b"89a"):
        for g in (None, 2, 4, 16, 256):
            for lt in (None, 2, 8, 256):
                n = max(g or 0, lt or 0) or 256
                ix = rng.randint(0, n, (6, 7))
                out[f"{version}_g{g}_l{lt}"] = K.make_gif(
                    7, 6, [K.frame(ix, local=None if lt is None else
                                   pal(lt, 2))],
                    palette=None if g is None else pal(g, 3),
                    version=version)
    return out


def interlaced_kinds():
    rng = np.random.RandomState(2)
    return {f"h{h}": K.make_gif(5, h, [K.frame(
        rng.randint(0, 16, (h, 5)), interlace=True)], palette=pal(16))
        for h in range(1, 21)}


def transparency_kinds():
    rng = np.random.RandomState(3)
    ix = rng.randint(0, 16, (5, 6))
    f = K.frame(ix)
    gce = K.graphic_control
    out = {}
    for bg in (0, 5):
        for disposal in range(4):
            for tr in (None, 3, 200):
                out[f"bg{bg}_d{disposal}_t{tr}"] = K.make_gif(
                    6, 5, [K.frame(ix, extensions=[gce(disposal, tr)])],
                    palette=pal(16), background=bg)
    out["last_gce_wins"] = K.make_gif(6, 5, [gce(transparent=2), gce(), f],
                                      palette=pal(16))
    out["last_gce_wins_rev"] = K.make_gif(
        6, 5, [gce(), gce(transparent=2), f], palette=pal(16))
    out["later_frame_decides"] = K.make_gif(
        6, 5, [gce(transparent=2), f, gce(), f], palette=pal(16))
    out["trailing_gce"] = K.make_gif(6, 5, [f, gce(transparent=1)],
                                     palette=pal(16))
    for n in (3, 4, 5):
        for flag in (0, 1):
            blk = bytes([flag]) + bytes(n - 1)
            out[f"later_gce_{n}_{flag}"] = K.make_gif(
                6, 5, [f, K.extension(0xF9, [blk]), f], palette=pal(16))
            out[f"gce_then_block_{n}_{flag}"] = K.make_gif(
                6, 5, [K.extension(0xF9, [b"\x01\x00\x00\x03", blk]), f],
                palette=pal(16))
    return out


def small_frame_kinds():
    rng = np.random.RandomState(4)
    ix = rng.randint(0, 8, (5, 6))
    out = {}
    for g in (None, 8, 16):
        for tr in (None, 3):
            for left, top in ((0, 0), (2, 3), (3, 6), (4, 3)):
                ext = [K.graphic_control(2, tr)]
                out[f"g{g}_t{tr}_{left}_{top}"] = K.make_gif(
                    9, 11, [K.frame(ix, left=left, top=top, extensions=ext,
                                    local=pal(8, 5) if g is None else None)],
                    palette=None if g is None else pal(g, 6), background=7)
    return out


def animated_kinds():
    rng = np.random.RandomState(5)
    ix = rng.randint(0, 16, (5, 6))
    f = K.frame(ix)
    out = {"two": K.make_gif(6, 5, [f, K.frame(ix[:2, :3], left=3)],
                             palette=pal(16)),
           "later_bad_lzw": K.make_gif(6, 5, [f, K.frame(ix, data=b"\xff" *
                                                         20)],
                                       palette=pal(16)),
           "later_outside": K.make_gif(6, 5, [f, K.frame(ix, left=3)],
                                       palette=pal(16)),
           "later_disposal_4": K.make_gif(6, 5, [f, K.frame(
               ix, extensions=[K.graphic_control(4)])], palette=pal(16))}
    frames = [pattern(9, 13, 3, 7), pattern(9, 13, 3, 7)]
    frames[1][3:6, 2:9] = 0
    out["pillow_rgb"] = pillow_gif(frames, "RGB", duration=40)
    out["pillow_rgb_disposal2"] = pillow_gif(frames, "RGB", disposal=2)
    return out


def code_kinds():
    rng = np.random.RandomState(6)
    out = {}
    for mcs in range(2, 12):
        n = min(1 << mcs, 256)
        ix = rng.randint(0, n, (9, 13))
        out[f"mcs{mcs}"] = K.make_gif(13, 9, [K.frame(ix, min_code_size=mcs)],
                                      palette=pal(256))
    for n, (h, w) in ((256, (60, 80)), (64, (64, 96)), (4, (150, 160))):
        ix = rng.randint(0, n, (h, w))
        for defer in (False, True):
            out[f"full_{n}_{defer}"] = K.make_gif(
                w, h, [K.frame(ix, defer_clear=defer)], palette=pal(n))
    ix = rng.randint(0, 16, (9, 13))
    a, b = ix.ravel()[:50], ix.ravel()[50:]
    out["end_then_more"] = K.make_gif(13, 9, [K.frame(
        ix, codes=K.lzw_codes(a, 4) + K.lzw_codes(b, 4, clear_first=False))],
        palette=pal(16))
    out["no_clear_no_end"] = K.make_gif(13, 9, [K.frame(
        ix, clear_first=False, end=False)], palette=pal(16))
    out["block_1"] = K.make_gif(13, 9, [K.frame(ix, block=1)],
                                palette=pal(16))
    return out


def lzw_edge_kinds():
    """1-row frames of 9-bit codes: literals, table codes, ends and clears
    around the last pixel, codes past the table."""
    out = {}
    seqs = {"exact": ([256, 1, 2, 3, 4, 5], 5),
            "one_over": ([256, 1, 2, 3, 4, 5, 6], 5),
            "two_over": ([256, 1, 2, 3, 4, 5, 6, 7], 5),
            "one_over_end": ([256, 1, 2, 3, 4, 5, 6, 257], 5),
            "short_end": ([256, 1, 2, 3, 257], 5),
            "short": ([256, 1, 2, 3], 5),
            "table_over": ([256, 127, 258, 258], 4),
            "table_at_end": ([256, 127, 258, 258, 258], 5),
            "kwkwk_at_end": ([256, 161, 258], 1),
            "kwkwk_at_end_more": ([256, 161, 258, 5], 1),
            "past_table_at_end": ([256, 77, 259], 1),
            "past_table": ([256, 77, 259], 2),
            "past_table_mid": ([256, 1, 2, 262, 4], 4),
            "first_after_clear": ([256, 258, 1], 2),
            "end_end": ([256, 1, 2, 257, 257], 2),
            "clear_at_end_more": ([256, 1, 2, 256, 3, 4], 2),
            "literal_300": ([256, 300, 5], 2)}
    for name, (codes, npix) in seqs.items():
        mcs = 9 if name == "literal_300" else 8
        out[name] = K.make_gif(npix, 1, [K.frame(
            np.zeros((1, npix)), min_code_size=mcs,
            codes=[(c, mcs + 1) for c in codes])], palette=pal(256))
    return out


def refused_kinds():
    ix = np.random.RandomState(7).randint(0, 16, (5, 6))
    f = K.frame(ix)
    good = K.make_gif(6, 5, [f], palette=pal(16))
    return {"gif88a": b"GIF88a" + good[6:], "gifxyz": b"GIFxyz" + good[6:],
            "zero_screen": K.make_gif(0, 5, [f], palette=pal(16)),
            "bg_past_table": K.make_gif(6, 5, [f], palette=pal(16),
                                        background=16),
            "gce_3": K.make_gif(6, 5, [K.extension(0xF9, [b"\x01\0\0"]), f],
                                palette=pal(16)),
            "disposal_5": K.make_gif(6, 5, [K.graphic_control(5), f],
                                     palette=pal(16)),
            "outside": K.make_gif(6, 5, [K.frame(ix, left=1)],
                                  palette=pal(16)),
            "mcs_1": K.make_gif(6, 5, [K.frame(ix % 2, min_code_size=1)],
                                palette=pal(16)),
            "mcs_12": K.make_gif(6, 5, [K.frame(ix, min_code_size=12)],
                                 palette=pal(16)),
            "index_past": K.make_gif(6, 5, [f], palette=pal(8)),
            "no_frame": K.make_gif(6, 5, [], palette=pal(16)),
            "no_trailer": good[:-1], "junk_block": good[:-1] + b"\x99;",
            "junk_after_trailer": good + b"\x99\x98",
            # a 3-byte sub-block of an application extension is read as
            # NETSCAPE2.0's loop count; after no or another 11-byte name
            # OpenCV's walk reads 2 of its bytes and takes the third for
            # the next length, which here ends the extension
            "app_3_misread_then_frame": K.make_gif(6, 5, [
                f, b"\x21\xff\x03\x01\x02\x00", f], palette=pal(16)),
            "app_netscape": K.make_gif(6, 5, [K.netscape(3), f],
                                       palette=pal(16)),
            "app_xmp_3": K.make_gif(6, 5, [K.extension(0xFF, [
                b"XMP DataXMP", b"\x01\x00\x00"]), f], palette=pal(16)),
            "app_xmp_long": K.make_gif(6, 5, [K.extension(0xFF, [
                b"XMP DataXMP", b"<x:xmpmeta/>"]), f], palette=pal(16)),
            "app_netscape_then_xmp_3": K.make_gif(6, 5, [f, K.extension(
                0xFF, [b"NETSCAPE2.0", b"XMP DataXMP", b"\x01\x00\x00"]), f],
                palette=pal(16)),
            "app_xmp_then_netscape_3": K.make_gif(6, 5, [K.extension(0xFF, [
                b"XMP DataXMP", b"NETSCAPE2.0", b"\x01\x00\x00"]), f],
                palette=pal(16)),
            "comment_3": K.make_gif(6, 5, [K.comment(b"abc"), f],
                                    palette=pal(16))}
READ = {"junk_after_trailer", "app_3_misread_then_frame", "app_netscape",
        "app_xmp_long", "app_xmp_then_netscape_3", "comment_3"}


KINDS = {"tables": tables_kinds, "interlaced": interlaced_kinds,
         "transparency": transparency_kinds, "small_frame": small_frame_kinds,
         "animated": animated_kinds, "codes": code_kinds,
         "lzw_edges": lzw_edge_kinds, "refused": refused_kinds}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kinds_read_as_cv2_reads_them(kind, tmp_path):
    refused = check(tmp_path, KINDS[kind]())
    # each group holds files cv2 reads and, where it says so, refuses
    expect = {"tables": 0, "interlaced": 0, "small_frame": 6}
    if kind in expect:
        assert len(refused) == expect[kind], refused
    if kind == "refused":
        assert set(refused) == set(refused_kinds()) - READ


def test_cv2_and_pillow_files_read_as_cv2_reads_them(tmp_path):
    rng = np.random.RandomState(8)
    files = {}
    for h, w in ((1, 1), (7, 300), (33, 17)):
        img = pattern(h, w, 3, h)
        files[f"cv2_rgb_{h}x{w}"] = cv2_gif(img)
        alpha = np.where(rng.rand(h, w) < 0.3, 0, 255).astype(np.uint8)
        files[f"cv2_rgba_{h}x{w}"] = cv2_gif(np.dstack([img, alpha]))
    files["pillow_p"] = pillow_gif([rng.randint(0, 7, (9, 11))], "P",
                                   palette=pal(7, 9))
    files["pillow_l"] = pillow_gif([pattern(30, 40, 1, 9)], "L")
    files["pillow_rgb_interlaced"] = pillow_gif([pattern(24, 18, 3, 10)],
                                                "RGB")
    files["pillow_transparency"] = pillow_gif(
        [rng.randint(0, 4, (8, 8))], "P", palette=pal(4, 11), transparency=2)
    assert check(tmp_path, files) == []
    p = tmp_path / "pillow_transparency.gif"
    img = read_image(p, "cpu")
    assert img.shape == (8, 8, 4) and int((img[..., 3] == 0).sum()) > 0


def test_cut_files_raise_naming_the_file(tmp_path):
    rng = np.random.RandomState(12)
    full = K.make_gif(11, 9, [K.frame(rng.randint(0, 16, (7, 10)), left=1,
                                      local=pal(16, 13),
                                      extensions=[K.graphic_control(
                                          transparent=3), K.comment(b"x")])],
                      palette=pal(16), extensions=[K.netscape()])
    # from the 3 bytes "GIF" on, the leading bytes OpenCV routes to GIF
    files = {f"cut{k}": full[:k] for k in range(3, len(full))}
    assert len(check(tmp_path, files)) == len(files)
    assert check(tmp_path, {"whole": full}) == []


def test_committed_fixtures_match_opencv_and_the_port():
    files = gif_fixture_files()
    names = sorted(p.name for p in FIXTURES.glob("gif*.gif"))
    assert names == sorted(files)
    for name in names:
        p = FIXTURES / name
        assert image_format(p) == "gif"
        want = np.load(FIXTURES / f"{Path(name).stem}.npy")
        np.testing.assert_array_equal(cv2_read(p), want, err_msg=name)
        got = read_image(p, "cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
        # the host part's indices and the device part's pixels
        dec = G.decode_gif(p)
        assert dec.indices.shape == dec.box[2:]
        np.testing.assert_array_equal(G.gif_pixels(dec, "cpu").numpy(), want)
    assert sum(p.stat().st_size for p in FIXTURES.glob("gif*")) < 131072


def test_random_files_read_as_cv2_reads_them(tmp_path):
    # random screens, tables, extensions, frames and LZW options, some
    # cut or with a byte changed
    rng = np.random.RandomState(22)
    files = {}
    for t in range(160):
        w, h = rng.randint(1, 20, 2)
        g = int(rng.choice([0, 2, 4, 16, 256]))
        frames = []
        for _ in range(int(rng.choice([1, 1, 2]))):
            fw, fh = rng.randint(1, w + 1), rng.randint(1, h + 1)
            lt = int(rng.choice([0, 0, 4, 16]))
            n = (max(g, lt) or 256) + int(rng.rand() < 0.1)
            ix = rng.randint(0, min(n, 256), (fh, fw))
            ext = []
            if rng.rand() < 0.5:
                ext.append(K.graphic_control(
                    int(rng.choice([0, 1, 2, 3, 3, 4])),
                    int(rng.randint(0, 256)) if rng.rand() < 0.5 else None))
            frames.append(K.frame(
                ix, left=rng.randint(0, w - fw + 1), top=rng.randint(
                    0, h - fh + 1), local=pal(lt, lt) if lt else None,
                interlace=rng.rand() < 0.3, block=int(rng.choice([255, 3])),
                extensions=ext, clear_first=rng.rand() < 0.9,
                defer_clear=rng.rand() < 0.3, end=rng.rand() < 0.9))
        data = K.make_gif(w, h, frames, palette=pal(g, t) if g else None,
                          background=int(rng.randint(0, max(g, 1))))
        if rng.rand() < 0.1:
            data = data[:rng.randint(3, len(data))]
        elif rng.rand() < 0.1:
            b = bytearray(data)
            b[rng.randint(6, len(b))] = rng.randint(256)
            data = bytes(b)
        files[f"r{t}"] = data
    refused = check(tmp_path, files)
    assert 10 < len(refused) < 100
