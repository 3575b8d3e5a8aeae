"""The last TIFF kinds in the port (utils/tiff.py) against
``cv2.imread(path, IMREAD_UNCHANGED)`` on the CPU, bit for bit (dtype,
shape, values; RGB(A) order), on files built with
tests/torch_image_common.py ``make_tiff``:

- uint64 and int64 samples (gray, RGB, RGBA; strips and tiles, LZW with
  predictor 2, both byte orders), and their writing as cv2.imwrite writes
  them (int32 of the low 32 bits);
- YCbCr subsampled 4x4 with libtiff's reads (a strip's rows of units
  truncated to TIFFScanlineSize, a tile cut by the right edge skewed) and
  subsampled YCbCr with the horizontal predictor;
- planar and palette JPEG-in-TIFF;
- strips and tiles cut short (what decoded kept, zeros after, no
  predictor; uncompressed byte counts re-estimated as libtiff does), and
  compressions libtiff has no codec for: zero samples through the RGBA
  reader; LogL under SGILog (libtiff's 8-bit gray, every 16-bit word),
  LogLuv (float32 RGB: libtiff's XYZ, OpenCV's XYZ -> BGR) and ThunderScan
  4-bit palettes (random streams: runs, deltas and raw nibbles, rows
  short of data or past their end);
- the kinds the port used to refuse that OpenCV reads: palettes of more
  than one sample, signed 1- to 4-bit and 10- to 14-bit samples
  (saturated to int16), signed and planar 16-bit gray with alpha, 32- and
  64-bit palettes and single-sample RGB read as gray, old-style LZW, and
  more;
- every kind cv2.imread returns None for raises ValueError, and the kinds
  still refused raise NotImplementedError, naming the file;
- a COLMAP capture whose views are Group 4, CIE L*a*b* and uint64 TIFF
  through the JAX package's and the port's load_images: element for
  element the same stack.
"""
import shutil

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu.data import colmap as JC
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu_torch.data import colmap as PC
from nerfpp_tpu_torch.data.dataset import load_images
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils import tiff as T
from nerfpp_tpu_torch.utils.image import read_image, write_image
from scripts.colmap_export import export_colmap_scene
from scripts.fax_kinds import encode_g4
from tests.torch_image_common import (boxes_of, cv2_read, fax_tiff,
                                      lzw_old_style, make_tiff, pattern,
                                      sgilog_rows, ycbcr_units)

torch.set_num_threads(1)

LAYOUTS = ({}, {"rows_per_strip": 4}, {"tile": (16, 16)})


def check(path, data):
    """The port's read of ``data`` is cv2's, on the CPU and through
    read_image; returns it."""
    path.write_bytes(data)
    want = cv2_read(path)
    assert want is not None, path
    got = T.read_tiff(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(path, "cpu").numpy(), want)
    return got


def test_64_bit_integer_samples(tmp_path):
    rng = np.random.RandomState(0)
    for i, (dtype, spp) in enumerate(((np.uint64, 1), (np.int64, 3),
                                      (np.uint64, 4), (np.int64, 1),
                                      (np.uint64, 3), (np.int64, 4))):
        h, w = rng.randint(1, 40, 2)
        info = np.iinfo(dtype)
        img = rng.randint(info.min, info.max, (h, w, spp), dtype=dtype)
        comp, pred = ((1, 1), (5, 2), (8, 2))[i % 3]
        got = check(tmp_path / "d.tif", make_tiff(
            img, "<>"[i % 2], comp, pred, **LAYOUTS[i % 3]))
        np.testing.assert_array_equal(got, img[..., 0] if spp == 1 else img)


def test_64_bit_images_write_as_cv2_imwrite_writes_them(tmp_path):
    rng = np.random.RandomState(1)
    for dtype, shape in ((np.uint64, (5, 7)), (np.int64, (6, 4, 3)),
                         (np.int64, (3, 9)), (np.uint64, (4, 5, 4))):
        info = np.iinfo(dtype)
        img = rng.randint(info.min, info.max, shape, dtype=dtype)
        img.flat[:3] = [info.min, info.max, 2 ** 31]
        cv = np.ascontiguousarray(img[..., [2, 1, 0, 3][:shape[-1]]]
                                  if len(shape) == 3 else img)
        assert cv2.imwrite(str(tmp_path / "cv.tif"), cv)
        write_image(tmp_path / "port.tif", torch.from_numpy(img), "cpu")
        T.write_tiff(tmp_path / "np.tif", img)
        want = cv2_read(tmp_path / "cv.tif")
        assert want.dtype == np.int32
        np.testing.assert_array_equal(want, (img.view(np.uint64) & np.uint64(
            0xFFFFFFFF)).astype(np.uint32).view(np.int32))
        for name in ("port.tif", "np.tif"):
            np.testing.assert_array_equal(cv2_read(tmp_path / name), want)
            np.testing.assert_array_equal(T.read_tiff(tmp_path / name), want)
        assert (tmp_path / "port.tif").read_bytes() == (
            tmp_path / "np.tif").read_bytes()


def test_ycbcr_4x4_as_libtiff_reads_it(tmp_path):
    rng = np.random.RandomState(2)
    for i, ((h, w), layout) in enumerate((
            ((13, 11), {}), ((13, 11), LAYOUTS[1]), ((8, 12), {}),
            ((16, 9), {"rows_per_strip": 6}), ((21, 35), LAYOUTS[2]),
            ((20, 40), LAYOUTS[2]), ((9, 13), {}), ((37, 45), LAYOUTS[2]))):
        chunks, _ = ycbcr_units(rng, h, w, 4, 4, boxes_of(h, w, **layout))
        check(tmp_path / "y.tif", make_tiff(
            np.zeros((h, w, 3), np.uint8), "<>"[i % 2], photometric=6,
            chunks=chunks, extra_tags=[(530, 3, [4, 4])], **layout))


def test_subsampled_ycbcr_with_the_horizontal_predictor(tmp_path):
    rng = np.random.RandomState(3)
    for hs, vs in ((2, 2), (4, 2), (2, 1), (4, 1), (1, 2), (4, 4)):
        for (h, w), layout in (((8, 10), {}), ((9, 12), LAYOUTS[1]),
                               ((21, 35), LAYOUTS[2])):
            chunks, _ = ycbcr_units(rng, h, w, hs, vs,
                                    boxes_of(h, w, **layout))
            check(tmp_path / "p.tif", make_tiff(
                np.zeros((h, w, 3), np.uint8), photometric=6, comp=5,
                predictor=2, chunks=[T.lzw_encode(c) for c in chunks],
                extra_tags=[(530, 3, [hs, vs]), (317, 3, [2])], **layout))


def test_planar_and_palette_jpeg_in_tiff(tmp_path):
    rng = np.random.RandomState(4)
    img = pattern(37, 45, 3, 4)

    def planes(box_layout):
        out = []
        for k in range(3):
            for y, x, rows, cols in boxes_of(37, 45, **box_layout):
                box = np.zeros((rows, cols), np.uint8)
                part = img[y:y + rows, x:x + cols, k]
                box[:part.shape[0], :part.shape[1]] = part
                out.append(cv2.imencode(".jpg", box)[1].tobytes())
        return out
    for layout in ({"rows_per_strip": 16}, LAYOUTS[2]):
        for photo, tags in ((2, []), (6, [(530, 3, [1, 1])]),
                            (6, [(530, 3, [1, 1]), (529, 5, [
                                2126, 10000, 7152, 10000, 722, 10000])])):
            check(tmp_path / "planar.tif", make_tiff(
                img, comp=7, planar=2, photometric=photo,
                chunks=planes(layout), extra_tags=tags, **layout))
    idx = img[..., 1]
    cmap = rng.randint(0, 65536, (3, 256)).astype(np.uint16)
    for layout in ({}, LAYOUTS[2]):
        chunks = []
        for y, x, rows, cols in boxes_of(37, 45, **layout):
            box = np.zeros((rows, cols), np.uint8)
            part = idx[y:y + rows, x:x + cols]
            box[:part.shape[0], :part.shape[1]] = part
            chunks.append(cv2.imencode(".jpg", box)[1].tobytes())
        check(tmp_path / "pal.tif", make_tiff(
            idx[..., None], comp=7, photometric=3, colormap=cmap,
            chunks=chunks, **layout))


def test_compressions_libtiff_has_no_codec_for_read_as_zeros(tmp_path):
    rng = np.random.RandomState(5)
    cmap = rng.randint(0, 65536, (3, 256)).astype(np.uint16)
    for comp in (9, 10, 34712, 32908, 65000):
        for photo, spp, kw in ((1, 1, {}), (0, 1, {}), (2, 3, LAYOUTS[2]),
                               (3, 1, {"colormap": cmap}), (5, 4, {}),
                               (8, 3, {})):
            got = check(tmp_path / "z.tif", make_tiff(
                np.zeros((9, 20, spp), np.uint8), comp=comp,
                photometric=photo, chunks=[bytes(16)] * (
                    2 if "tile" in kw else 1), **kw))
            assert (got == got[0, 0]).all()          # one colour
        path = tmp_path / "z16.tif"
        path.write_bytes(make_tiff(np.zeros((4, 4, 1), np.uint16),
                                   comp=comp, chunks=[bytes(16)]))
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match="z16.tif.*no codec"):
            read_image(path, "cpu")


def test_chunks_short_of_their_size_read_as_opencv_reads_them(tmp_path):
    """A strip or tile cut short or corrupt: libtiff's RGBA reader keeps
    what decoded (LZW, Deflate, PackBits; no predictor on it),
    re-estimates uncompressed byte counts and reads on, or fails; the raw
    path fails."""
    rng = np.random.RandomState(8)
    kinds = ((1, 1, np.uint8), (2, 3, np.uint8), (2, 4, np.uint8),
             (5, 4, np.uint8), (8, 3, np.uint8), (1, 2, np.uint8),
             (1, 1, np.uint16))
    for i in range(48):
        comp = (1, 5, 8, 32773)[i % 4]
        photo, spp, dtype = kinds[i % len(kinds)]
        pred = 2 if comp in (5, 8) and i % 3 else 1
        layout = LAYOUTS[1 + i % 2] if i % 5 else {"rows_per_strip": 2}
        h, w = rng.randint(4, 35, 2)
        img = (rng.randint(0, 256, (h, w, spp)) * (
            257 if dtype == np.uint16 else 1)).astype(dtype)
        full = make_tiff(img, comp=comp, predictor=pred, photometric=photo,
                         **layout)
        _, tags = T._ifd("f.tif", full)
        offsets = tags.get(273) or tags.get(324)
        counts = tags.get(279) or tags.get(325)
        chunks = [full[o:o + c] for o, c in zip(offsets, counts)]
        k = rng.randint(len(chunks))
        chunks[k] = chunks[k][:rng.randint(1, max(2, len(chunks[k])))]
        if comp in (5, 32773) and i % 2:     # and a corrupt byte in another
            j = rng.randint(len(chunks))
            c = bytearray(chunks[j])
            c[rng.randint(len(c))] ^= 1 << rng.randint(8)
            chunks[j] = bytes(c)
        path = tmp_path / "short.tif"
        path.write_bytes(make_tiff(img, comp=comp, predictor=pred,
                                   photometric=photo, chunks=chunks,
                                   **layout))
        if cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None:
            with pytest.raises(ValueError, match="cv2.imread returns"):
                read_image(path, "cpu")
        else:
            check(path, path.read_bytes())


def test_formerly_refused_kinds_read_as_opencv_reads_them(tmp_path):
    rng = np.random.RandomState(6)
    cmap = rng.randint(0, 65536, (3, 256)).astype(np.uint16)
    for spp, layout in ((2, {}), (3, LAYOUTS[2]), (4, LAYOUTS[1])):
        idx = rng.randint(0, 256, (21, 37, spp)).astype(np.uint8)
        check(tmp_path / "pal.tif", make_tiff(idx, photometric=3,
                                              colormap=cmap, **layout))
    for bits, photo in ((1, 1), (1, 3), (4, 3)):
        idx = rng.randint(0, 1 << bits, (7, 9, 1)).astype(np.uint8)
        got = check(tmp_path / "s.tif", make_tiff(
            idx, photometric=photo, bits=bits, sample_format=2,
            colormap=cmap[:, :1 << bits] if photo == 3 else None))
        assert got.dtype == np.int8
    for bits in (10, 12, 14):
        v = rng.randint(0, 1 << bits, (5, 7, 3)).astype(np.uint16)
        got = check(tmp_path / "i.tif", make_tiff(v, bits=bits,
                                                  sample_format=2))
        assert got.max() == 32767 and got.dtype == np.int16
    ga = rng.randint(0, 65536, (13, 21, 2)).astype(np.uint16)
    for dtype, photo, extra, planar in ((np.int16, 1, (2,), 1),
                                        (np.int16, 0, (1,), 1),
                                        (np.int16, 1, (2,), 2),
                                        (np.uint16, 0, (2,), 2),
                                        (np.uint16, 1, (1,), 2),
                                        (np.uint16, 1, None, 2)):
        check(tmp_path / "ga.tif", make_tiff(
            ga.view(dtype), photometric=photo, extra=extra, planar=planar,
            tile=(16, 16)))
    for dtype in (np.uint32, np.float32, np.uint64, np.int32):
        a = (rng.rand(6, 11, 1) * 1000).astype(dtype)
        check(tmp_path / "p.tif", make_tiff(a, photometric=3,
                                            colormap=cmap[:, :4]))
        check(tmp_path / "r.tif", make_tiff(a, photometric=2))
        check(tmp_path / "g3.tif", make_tiff(
            (rng.rand(6, 11, 3) * 1000).astype(dtype), photometric=1,
            extra=(2, 0)))
    for comp, pred in ((1, 3), (32773, 5), (1, 2)):
        check(tmp_path / "pr.tif", make_tiff(
            rng.randint(0, 999, (5, 6, 1)).astype(np.int16), comp=comp,
            extra_tags=[(317, 3, [pred])]))
    # old-style LZW (libtiff 4.0 and earlier), a table's worth and more
    for h, w, spp in ((9, 13, 3), (60, 59, 3), (31, 7, 1)):
        img = rng.randint(0, 256, (h, w, spp)).astype(np.uint8)
        img[:, :w // 3] = img[:, :1]
        got = check(tmp_path / "old.tif", make_tiff(
            img, comp=5, rows_per_strip=8,
            chunks=[lzw_old_style(img[y:y + 8].tobytes())
                    for y in range(0, h, 8)]))
        np.testing.assert_array_equal(got, img[..., 0] if spp == 1 else img)


def test_sgilog_and_thunderscan_read_as_opencv_reads_them(tmp_path):
    rng = np.random.RandomState(7)
    for i, layout in enumerate(({}, LAYOUTS[1], LAYOUTS[2])):
        h, w = (9, 33) if i < 2 else (21, 35)     # LogLuv: float32 RGB
        words = rng.randint(0, 2 ** 32, (h, w), dtype=np.uint64)
        words[:, 2:9] = words[:, 2:3]
        chunks = []
        for y, x, rows, cols in boxes_of(h, w, layout.get("rows_per_strip"),
                                         layout.get("tile")):
            box = np.zeros((rows, cols), np.uint64)
            part = words[y:y + rows, x:x + cols]
            box[:part.shape[0], :part.shape[1]] = part
            chunks.append(sgilog_rows(box, 4))
        got = check(tmp_path / "luv.tif", make_tiff(
            np.zeros((h, w, 3), np.uint16), comp=34676, photometric=32845,
            sample_format=2, chunks=chunks, orientation=1 + i, **layout))
        assert got.dtype == np.float32
    words = np.arange(65536, dtype=np.uint32).reshape(256, 256)
    for dtype, fmt in ((np.int16, 2), (np.uint16, 1), (np.uint8, 1)):
        got = check(tmp_path / "l.tif", make_tiff(
            np.zeros((256, 256, 1), dtype), comp=34676, photometric=32844,
            sample_format=fmt, chunks=[sgilog_rows(words, 2)]))
        assert got.dtype == (np.int8 if fmt == 2 else np.uint8)
    for layout in (LAYOUTS[1], LAYOUTS[2], {"fill_order": 2}):
        w = rng.randint(0, 65536, (23, 37)).astype(np.uint32)
        w[:, 5:20] = w[:, 5:6]                       # runs
        chunks = []
        for y, x, rows, cols in boxes_of(23, 37, layout.get(
                "rows_per_strip"), layout.get("tile")):
            box = np.zeros((rows, cols), np.uint32)
            part = w[y:y + rows, x:x + cols]
            box[:part.shape[0], :part.shape[1]] = part
            chunks.append(sgilog_rows(box, 2))
        check(tmp_path / "l.tif", make_tiff(
            np.zeros((23, 37, 1), np.int16), comp=34676, photometric=32844,
            sample_format=2, chunks=chunks, **layout))
    for cut in (10, 300):                            # a strip cut short
        check(tmp_path / "cut.tif", make_tiff(
            np.zeros((10, 40, 1), np.int16), comp=34676, photometric=32844,
            chunks=[sgilog_rows(rng.randint(0, 65536, (10, 40)), 2)[:cut]]))
    cmap = rng.randint(0, 65536, (3, 16)).astype(np.uint16)
    for h, w in ((1, 1), (5, 7), (9, 33), (4, 64)):
        for _ in range(12):          # runs, deltas and raw nibbles, any end
            stream = rng.randint(0, 256, rng.randint(1, 90)).astype(np.uint8)
            check(tmp_path / "t.tif", make_tiff(
                np.zeros((h, w, 1), np.uint8), comp=32809, bits=4,
                photometric=3, colormap=cmap, chunks=[stream.tobytes()]))


def test_kinds_opencv_returns_none_for_raise_value_error(tmp_path):
    u8 = np.zeros((4, 8, 3), np.uint8)
    g8 = u8[..., :1]
    cases = {
        "mask.tif": make_tiff(g8, photometric=4),
        "cfa.tif": make_tiff(g8, photometric=32803),
        "linraw.tif": make_tiff(u8.astype(np.uint16), photometric=34892),
        "photo7.tif": make_tiff(u8, photometric=7),
        "nophoto.tif": make_tiff(g8).replace(
            b"\x06\x01\x03\x00\x01\x00\x00\x00\x01\x00",
            b"\xff\x7f\x03\x00\x01\x00\x00\x00\x01\x00"),
        "float8.tif": make_tiff(u8, sample_format=3),
        "void.tif": make_tiff(g8, sample_format=4),
        "cint.tif": make_tiff(g8.astype(np.int16), sample_format=5),
        "cfloat.tif": make_tiff(g8.astype(np.float32), sample_format=6),
        "bits24.tif": make_tiff(g8.astype(np.uint32), bits=24),
        "bits6.tif": make_tiff(g8, bits=6),
        "mixed.tif": make_tiff(u8).replace(b"\x08\x00\x08\x00\x08\x00",
                                           b"\x08\x00\x10\x00\x08\x00"),
        "ojpeg.tif": make_tiff(u8, comp=6, photometric=6),
        "jbig.tif": make_tiff(g8, comp=34661),
        "pixarlog.tif": make_tiff(u8, comp=32909),
        "next.tif": make_tiff(g8, comp=32766, bits=2),
        "thunder8.tif": make_tiff(g8, comp=32809),
        "sgilog_gray.tif": make_tiff(g8, comp=34676),
        "logl24.tif": make_tiff(g8.astype(np.int16), comp=34677,
                                photometric=32844),
        "logl32.tif": make_tiff(g8.astype(np.uint32), comp=34676,
                                photometric=32844,
                                chunks=[sgilog_rows(np.ones((4, 8)), 2)]),
        "logluv_cut.tif": make_tiff(
            u8.astype(np.uint16), comp=34676, photometric=32845,
            chunks=[sgilog_rows(np.full((4, 8), 0x3A005AA0), 4)[:40]]),
        "logluv_raw.tif": make_tiff(u8.astype(np.uint16), photometric=32845),
        "ycc_planar22.tif": make_tiff(u8, planar=2, photometric=6,
                                      extra_tags=[(530, 3, [2, 2])]),
        "ycc14.tif": make_tiff(u8, photometric=6,
                               extra_tags=[(530, 3, [1, 4])]),
        "jpeg_planar22.tif": make_tiff(u8, comp=7, planar=2, photometric=6,
                                       chunks=[bytes(8)] * 3),
        "jpeg12.tif": make_tiff(g8.astype(np.uint16), comp=7, bits=12,
                                chunks=[bytes(8)]),
        "jpeg_cmyk.tif": make_tiff(np.zeros((4, 8, 4), np.uint8), comp=7,
                                   photometric=5, chunks=[bytes(8)]),
        "pred5.tif": make_tiff(u8, comp=5, extra_tags=[(317, 3, [5])]),
        "pred3int.tif": make_tiff(g8.astype(np.int16), comp=8,
                                  extra_tags=[(317, 3, [3])]),
        "float12.tif": make_tiff(g8.astype(np.uint16), bits=12,
                                 sample_format=3),
        "pal12.tif": make_tiff(g8.astype(np.uint16), bits=12, photometric=3,
                               colormap=np.zeros((3, 4096), np.uint16)),
        "rgb2.tif": make_tiff(u8[..., :2].astype(np.uint32), photometric=2),
        "pal_planar.tif": make_tiff(u8, photometric=3, planar=2,
                                    colormap=np.zeros((3, 256), np.uint16)),
        "ga12.tif": make_tiff(np.zeros((4, 8, 2), np.uint16), bits=12,
                              photometric=1, extra=(2,))}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=f"{name}.*cv2.imread returns"):
            read_image(tmp_path / name, "cpu")


def test_kinds_still_refused_raise_not_implemented_error(tmp_path):
    cases = {"planar16.tif": (make_tiff(np.zeros((4, 4, 3), np.uint16),
                                        planar=2), "16-bit planar"),
             "planar12.tif": (make_tiff(np.zeros((4, 4, 3), np.uint16),
                                        bits=12, planar=2), "12-bit planar"),
             "gray3.tif": (make_tiff(np.zeros((4, 4, 3), np.uint16),
                                     photometric=1, extra=(2, 0)),
                           "16-bit gray TIFF of 3 samples"),
             "logluv24.tif": (make_tiff(
                 np.zeros((4, 4, 3), np.uint16), comp=34677, photometric=32845,
                 chunks=[bytes(range(48))]), "SGILog24 LogLuv")}
    for name, (data, kind) in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) \
            is not None
        with pytest.raises(NotImplementedError, match=f"{name}.*{kind}"):
            read_image(tmp_path / name, "cpu")


def test_a_capture_of_fax_lab_and_uint64_views_loads_as_the_jax_package(
        tmp_path):
    scene = make_synthetic_scene(n_train=4, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    ws = export_colmap_scene(scene, tmp_path / "ws", "cpu", n_samples=32,
                             n_points=1000, image_format="tif").workspace
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "jax"))
    for views in (port.views, ref.views):
        for i, v in enumerate(views[:3]):
            rgb = cv2_read(v.image_path)
            if i == 0:        # Group 4 of the green channel, thresholded
                bits = (rgb[..., 1] > 100).astype(np.uint8)
                data = fax_tiff(bits, 4, encode_g4, rows_per_strip=10,
                                photometric=0)
            elif i == 1:      # the bytes as CIE L*a*b*
                data = make_tiff(rgb, comp=5, predictor=2, photometric=8)
            else:             # uint64 samples
                data = make_tiff(rgb.astype(np.uint64) * (2 ** 40 + 3))
            open(v.image_path, "wb").write(data)
    for a, b in zip(port.views, ref.views):
        np.testing.assert_array_equal(read_image(a.image_path, "cpu").numpy(),
                                      cv2_read(b.image_path))
    v0 = port.views[0]
    idx = list(range(len(port.views)))
    got = load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu")
    want = JD.load_images(ref, idx, target_hw=(v0.h, v0.w))
    assert got.dtype == want.dtype and got.shape == (len(idx), 24, 24, 3)
    assert want[2].max() > 1e10                   # uint64 / 255
    np.testing.assert_array_equal(got, want)
