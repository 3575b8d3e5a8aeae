"""The TIFF kinds OpenCV's libtiff reads beyond the baseline, in the port
(utils/tiff.py) against ``cv2.imread(path, IMREAD_UNCHANGED)`` on the CPU
(dtype, shape and values, RGB(A) order), on files built with
tests/torch_image_common.py ``make_tiff`` in both byte orders, in strips
and tiles, at sizes that are not multiples of 8 or 16:

- BigTIFF (8-byte offsets, LONG8 fields) beside classic TIFF;
- CMYK (R = (255 - K)(255 - C) // 255, alpha 255), chunky and planar;
- gray with alpha: 8 bits as stored (MinIsWhite inverted; planar
  premultiplied by an unassociated alpha), 16 bits as uint8 (the high
  byte);
- 1-bit bilevel (0 / 255, FillOrder 2), 1-bit palettes (gray) and 4-bit
  palettes, and 10-, 12- and 14-bit samples (uint16, << 16 - bits);
- Orientation 2-4 (8-bit tiles mirrored in place, as OpenCV does);
- uncompressed YCbCr at every subsampling libtiff's RGBA reader takes,
  with and without YCbCrCoefficients and ReferenceBlackWhite (RATIONAL);
- the kinds cv2.imread returns None for raise ValueError and the kinds
  the port leaves out NotImplementedError, naming the file (CCITT, YCbCr
  4x4 and signed gray with alpha, once among them, are read since TIFF
  was closed: tests/test_torch_tiff_ccitt.py and test_torch_tiff_rare.py);
- a COLMAP capture of these kinds (JPEG-in-TIFF too) through the JAX
  package's and the port's loaders: the same undistorted images and the
  same stack.
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
from nerfpp_tpu_torch.utils.image import read_image
from scripts.colmap_export import export_colmap_scene
from tests.torch_image_common import (boxes_of, cv2_read, make_tiff,
                                      ycbcr_units)

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


def test_bigtiff_reads_as_classic_tiff_reads(tmp_path):
    rng = np.random.RandomState(0)
    for bo, dtype, spp, comp, layout in (
            ("<", np.uint8, 3, 5, {}), (">", np.uint8, 3, 1, LAYOUTS[2]),
            ("<", np.uint16, 1, 8, LAYOUTS[1]), (">", np.uint16, 4, 32773,
                                                 LAYOUTS[1]),
            ("<", np.float32, 3, 8, LAYOUTS[2]), (">", np.uint8, 1, 5, {})):
        h, w = rng.randint(1, 40, 2)
        img = (rng.rand(h, w, spp) * 1000).astype(dtype) if dtype == \
            np.float32 else rng.randint(0, np.iinfo(dtype).max + 1,
                                        (h, w, spp)).astype(dtype)
        rational = [(282, 5, [72, 1]), (283, 5, [300, 7])]
        big = check(tmp_path / "big.tif", make_tiff(
            img, bo, comp, version=43, extra_tags=rational, **layout))
        classic = check(tmp_path / "classic.tif", make_tiff(
            img, bo, comp, extra_tags=rational, **layout))
        np.testing.assert_array_equal(big, classic)
        _, tags = T._ifd("big.tif", (tmp_path / "big.tif").read_bytes())
        assert tags[283] == (np.float32(300 / 7),)


def test_cmyk_through_libtiffs_formula(tmp_path):
    rng = np.random.RandomState(1)
    for bo, planar, layout, comp in (("<", 1, {}, 1), (">", 1, LAYOUTS[2], 5),
                                     ("<", 2, LAYOUTS[1], 8),
                                     (">", 2, LAYOUTS[2], 32773)):
        h, w = rng.randint(1, 40, 2)
        cmyk = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        got = check(tmp_path / "cmyk.tif", make_tiff(
            cmyk, bo, comp, planar=planar, photometric=5, **layout))
        c = cmyk.astype(np.int64)
        want = (255 - c[..., 3:]) * (255 - c[..., :3]) // 255
        np.testing.assert_array_equal(got[..., :3], want)
        assert (got[..., 3] == 255).all()
    one = np.array([[[174, 233, 215, 171]]], np.uint8)  # K included
    got = check(tmp_path / "one.tif", make_tiff(one, photometric=5))
    np.testing.assert_array_equal(got[0, 0], [26, 7, 13, 255])


def test_gray_with_alpha_at_8_bits(tmp_path):
    rng = np.random.RandomState(2)
    for photo, extra, planar, layout, dtype in (
            (1, None, 1, {}, np.uint8), (0, (0,), 1, LAYOUTS[1], np.uint8),
            (1, (1,), 1, LAYOUTS[2], np.uint8), (0, (2,), 1, {}, np.uint8),
            (1, (2,), 2, LAYOUTS[1], np.uint8), (0, (2,), 2, {}, np.uint8),
            (1, (0,), 2, LAYOUTS[2], np.uint8), (1, (2,), 1, {}, np.int8),
            (0, (2, 0), 1, LAYOUTS[1], np.uint8)):
        h, w = rng.randint(1, 40, 2)
        spp = 1 + len(extra or (0,))
        ga = rng.randint(0, 256, (h, w, spp)).astype(np.uint8).view(dtype)
        got = check(tmp_path / "ga.tif", make_tiff(
            ga, planar=planar, photometric=photo, extra=extra, **layout))
        g, a = ga[..., 0].view(np.uint8), ga[..., 1].astype(np.int64)
        if planar == 2 and extra == (2,):          # premultiplied as stored
            g = ((g * a + 127) // 255).astype(np.uint8)
        elif planar == 1 and photo == 0:           # inverted as gray is
            g = 255 - g
        # libtiff steps a tile cut by the right edge by bytes, not samples
        whole = w // 16 * 16 if planar == 1 and "tile" in layout else w
        np.testing.assert_array_equal(got.view(np.uint8)[:, :whole],
                                      g[:, :whole])


def test_gray_with_alpha_at_16_bits_comes_back_as_its_high_byte(tmp_path):
    rng = np.random.RandomState(3)
    for bo, photo, extra, layout in (("<", 1, (2,), {}),
                                     (">", 0, (1,), LAYOUTS[1]),
                                     ("<", 1, None, LAYOUTS[2])):
        ga = rng.randint(0, 65536, (13, 21, 2)).astype(np.uint16)
        ga[0, :4, 0] = [42428, 255, 256, 65535]     # 165, 0, 1, 255
        got = check(tmp_path / "ga16.tif", make_tiff(
            ga, bo, photometric=photo, extra=extra, **layout))
        assert got.dtype == np.uint8 and got.shape == (13, 21)
        hi = (ga[..., 0] >> 8).astype(np.uint8)
        whole = 16 if "tile" in layout else 21      # as at 8 bits
        np.testing.assert_array_equal(got[:, :whole], (
            255 - hi if photo == 0 else hi)[:, :whole])
    assert list(check(tmp_path / "ga16.tif", make_tiff(
        ga, photometric=1))[0, :4]) == [165, 0, 1, 255]


def test_bilevel_and_small_palettes(tmp_path):
    rng = np.random.RandomState(4)
    for w, photo, fill, comp, layout, bo in (
            (1, 1, 1, 1, {}, "<"), (7, 0, 1, 5, LAYOUTS[1], ">"),
            (13, 1, 2, 5, LAYOUTS[2], "<"), (21, 0, 2, 32773, {}, ">"),
            (16, 1, 2, 8, LAYOUTS[1], "<")):
        b = rng.randint(0, 2, (11, w, 1)).astype(np.uint8)
        got = check(tmp_path / "b.tif", make_tiff(
            b, bo, comp, photometric=photo, bits=1, fill_order=fill,
            **layout))
        np.testing.assert_array_equal(got, (b[..., 0] ^ (photo == 0)) * 255)
    for bits, top in ((1, 65536), (1, 256), (4, 65536), (4, 256)):
        idx = rng.randint(0, 1 << bits, (9, 11, 1)).astype(np.uint8)
        cmap = rng.randint(0, top, (3, 1 << bits)).astype(np.uint16)
        got = check(tmp_path / "p.tif", make_tiff(
            idx, photometric=3, colormap=cmap, bits=bits, tile=(16, 16)))
        assert got.shape == ((9, 11) if bits == 1 else (9, 11, 3))
    eight = rng.randint(0, 256, (5, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(check(tmp_path / "f.tif", make_tiff(
        eight, comp=5, fill_order=2)), eight)


def test_sensor_depths_come_back_shifted_to_16_bits(tmp_path):
    rng = np.random.RandomState(10)
    for bits, (spp, photo, bo, comp, layout) in zip(
            (10, 12, 14, 10, 12, 14, 10, 12, 14), (
                (1, 1, "<", 1, {}), (1, 0, ">", 5, LAYOUTS[1]),
                (3, 2, "<", 8, LAYOUTS[2]), (3, 2, ">", 1, LAYOUTS[1]),
                (4, 2, "<", 32773, {}), (1, 1, ">", 8, LAYOUTS[2]),
                (4, 2, ">", 5, LAYOUTS[2]), (3, 2, "<", 32773, {}),
                (1, 0, "<", 1, LAYOUTS[1]))):
        h, w = rng.randint(1, 30, 2)
        s = rng.randint(0, 1 << bits, (h, w, spp)).astype(np.uint16)
        got = check(tmp_path / "d.tif", make_tiff(
            s, bo, comp, photometric=photo, bits=bits, **layout))
        want = s << (16 - bits)                    # MinIsWhite as stored
        np.testing.assert_array_equal(got, want[..., 0] if spp == 1
                                      else want)
    one = np.array([[[2702]]], np.uint16)
    assert check(tmp_path / "one.tif", make_tiff(one, bits=12))[0, 0] == 43232


def test_orientations_2_to_4(tmp_path):
    rng = np.random.RandomState(5)

    def tile_mirror(x, tw):                        # each tile in place
        return np.concatenate([x[:, t:t + tw][:, ::-1]
                               for t in range(0, x.shape[1], tw)], 1)

    for dtype, bits, layout in ((np.uint8, None, {}),
                                (np.uint8, None, LAYOUTS[2]),
                                (np.uint8, 1, LAYOUTS[2]),
                                (np.uint16, None, LAYOUTS[2]),
                                (np.uint16, 12, LAYOUTS[1]),
                                (np.float32, None, LAYOUTS[2])):
        top = 2 if bits == 1 else 1 << (bits or 8)
        img = rng.randint(0, top, (37, 45, 1 if bits else 3)).astype(dtype)
        base = check(tmp_path / "o1.tif", make_tiff(img, bits=bits,
                                                    **layout))
        per_tile = dtype == np.uint8 and "tile" in layout
        for o in (2, 3, 4):
            got = check(tmp_path / "o.tif", make_tiff(
                img, bits=bits, orientation=o, **layout))
            flipped = base[::-1] if o in (3, 4) else base
            if o in (2, 3):
                flipped = (tile_mirror(flipped, 16) if per_tile
                           else flipped[:, ::-1])
            np.testing.assert_array_equal(got, flipped)


def test_ycbcr_through_libtiffs_tables(tmp_path):
    rng = np.random.RandomState(6)
    cases = [((hs, vs), (h, w), layout)
             for hs, vs in T.YCBCR_SUBSAMPLING
             for (h, w), layout in (((16, 16), {}), ((13, 11), LAYOUTS[1]),
                                    ((21, 35), LAYOUTS[2]))]
    for i, ((hs, vs), (h, w), layout) in enumerate(cases):
        chunks, _ = ycbcr_units(rng, h, w, hs, vs, boxes_of(h, w, **layout))
        check(tmp_path / "y.tif", make_tiff(
            np.zeros((h, w, 3), np.uint8), "<>"[i % 2], photometric=6,
            chunks=chunks, extra_tags=[(530, 3, [hs, vs])], **layout))
    chunks, _ = ycbcr_units(rng, 10, 10, 2, 2, boxes_of(10, 10))
    check(tmp_path / "default.tif", make_tiff(       # no tag: 2x2
        np.zeros((10, 10, 3), np.uint8), photometric=6, chunks=chunks))
    for ref, luma in (((64, 940, 512, 960, 512, 960), None),
                      ((62, 945, 508, 964, 516, 956), (2126, 7152, 722)),
                      ((0, 1020, 0, 1020, 0, 1020), (2990, 5870, 1140))):
        chunks, _ = ycbcr_units(rng, 12, 14, 2, 1, boxes_of(12, 14))
        tags = [(530, 3, [2, 1]), (532, 5, [v for r in ref for v in (r, 4)])]
        if luma:
            tags.append((529, 5, [v for c in luma for v in (c, 10000)]))
        check(tmp_path / "ref.tif", make_tiff(
            np.zeros((12, 14, 3), np.uint8), photometric=6, chunks=chunks,
            extra_tags=tags))
    ycc = rng.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    check(tmp_path / "planar.tif", make_tiff(ycc, planar=2, photometric=6,
                                             extra_tags=[(530, 3, [1, 1])]))


def test_kinds_opencv_returns_none_for_raise_value_error(tmp_path):
    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 4, (4, 5, 1)).astype(np.uint8)
    cases = {
        "cmyk16.tif": make_tiff(np.zeros((4, 4, 4), np.uint16),
                                photometric=5),
        "cmyk3.tif": make_tiff(np.zeros((4, 4, 3), np.uint8), photometric=5),
        "inkset.tif": make_tiff(np.zeros((4, 4, 4), np.uint8), photometric=5,
                                extra_tags=[(332, 3, [2])]),
        "gray2.tif": make_tiff(u8, bits=2),
        "gray4.tif": make_tiff(u8, bits=4),
        "pal2.tif": make_tiff(u8, bits=2, photometric=3,
                              colormap=np.zeros((3, 4), np.uint16)),
        "pal16.tif": make_tiff(u8.astype(np.uint16), photometric=3,
                               colormap=np.zeros((3, 65536), np.uint16)),
        "rgb1.tif": make_tiff(np.zeros((4, 4, 3), np.uint8), bits=1),
        "ga12.tif": make_tiff(np.zeros((4, 4, 2), np.uint16), bits=12,
                              photometric=1, extra=(2,)),
        "pred12.tif": make_tiff(np.zeros((4, 4, 1), np.uint16), bits=12,
                                comp=5, predictor=2),
        "gaf.tif": make_tiff(np.zeros((4, 4, 2), np.float32), extra=(2,),
                              photometric=1),
        "ycc16.tif": make_tiff(np.zeros((4, 4, 3), np.uint16), photometric=6,
                               extra_tags=[(530, 3, [1, 1])]),
        "rgb5.tif": make_tiff(np.zeros((4, 4, 5), np.uint8), extra=(0, 0)),
        "fill2.tif": make_tiff(np.zeros((4, 4, 3), np.uint8), tile=(16, 16),
                               fill_order=2)}
    for o in (5, 6, 7, 8):
        cases[f"orient{o}.tif"] = make_tiff(np.zeros((4, 6, 3), np.uint8),
                                            orientation=o)
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=f"{name}.*cv2.imread returns"):
            read_image(tmp_path / name, "cpu")


def test_kinds_left_out_raise_not_implemented_error(tmp_path):
    cases = {"planar12.tif": (make_tiff(np.zeros((4, 4, 3), np.uint16),
                                        bits=12, planar=2), "12-bit planar"),
             "planar32.tif": (make_tiff(np.zeros((4, 4, 4), np.uint32),
                                        planar=2), "32-bit planar"),
             "gray4.tif": (make_tiff(np.zeros((4, 4, 4), np.uint16),
                                     photometric=1, extra=(2, 0, 0)),
                           "16-bit gray TIFF of 4 samples")}
    for name, (data, kind) in cases.items():
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name),
                          cv2.IMREAD_UNCHANGED) is not None
        with pytest.raises(NotImplementedError, match=f"{name}.*{kind}"):
            read_image(tmp_path / name, "cpu")


def write_kinds(images_dir):
    """Rewrite a capture's TIFF views, one a kind: BigTIFF, CMYK with K =
    0 stored turned under Orientation 3 (the view's RGB back), the view's
    bytes as YCbCr 1x1 in tiles, JPEG-in-TIFF as cv2.imwrite writes it,
    YCbCr 4:2:0 JPEG tiles (cv2.imencode's streams) and 12-bit gray."""
    views = sorted(images_dir.glob("*.tif"))
    for j, f in enumerate(views):
        rgb = cv2_read(f)
        kind = j % 6
        if kind == 0:
            data = make_tiff(rgb, ">", 5, version=43, rows_per_strip=7)
        elif kind == 1:
            cmyk = np.concatenate([255 - rgb, np.zeros_like(rgb[..., :1])],
                                  -1)[::-1, ::-1]
            data = make_tiff(np.ascontiguousarray(cmyk), photometric=5,
                             orientation=3, comp=8)
        elif kind == 2:
            data = make_tiff(rgb, photometric=6, tile=(16, 16),
                             extra_tags=[(530, 3, [1, 1])])
        elif kind == 3:
            cv2.imwrite(str(f), rgb[..., ::-1],
                        [cv2.IMWRITE_TIFF_COMPRESSION, 7])
            continue
        elif kind == 4:
            h, w = rgb.shape[:2]
            chunks = []
            for y, x, rows, cols in boxes_of(h, w, tile=(16, 16)):
                box = np.zeros((16, 16, 3), np.uint8)
                part = rgb[y:y + 16, x:x + 16]
                box[:part.shape[0], :part.shape[1]] = part
                chunks.append(cv2.imencode(".jpg", np.ascontiguousarray(
                    box[..., ::-1]))[1].tobytes())
            data = make_tiff(rgb, comp=7, photometric=6, tile=(16, 16),
                             chunks=chunks, extra_tags=[(530, 3, [2, 2])])
        else:
            gray = (rgb[..., 1:2].astype(np.uint16) * 16 + 7)
            data = make_tiff(gray, bits=12, rows_per_strip=5)
        f.write_bytes(data)
    return len(views)


def test_a_capture_of_these_kinds_loads_as_the_jax_package_loads_it(
        tmp_path):
    scene = make_synthetic_scene(n_train=6, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    ws = export_colmap_scene(scene, tmp_path / "ws", "cpu", n_samples=32,
                             n_points=1000, image_format="tif").workspace
    assert write_kinds(ws / "images") == 6
    for f in sorted((ws / "images").iterdir()):
        np.testing.assert_array_equal(read_image(f, "cpu").numpy(),
                                      cv2_read(f), err_msg=f.name)
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "jax"))
    for a, b in zip(port.views, ref.views):
        np.testing.assert_array_equal(cv2_read(a.image_path),
                                      cv2_read(b.image_path))
    v0 = port.views[0]
    idx = list(range(6))
    got = load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu")
    want = JD.load_images(ref, idx, target_hw=(v0.h, v0.w))
    assert got.dtype == want.dtype and got.shape == (6, 24, 24, 3)
    np.testing.assert_array_equal(got, want)
