"""Port parity: image I/O (utils/png.py) and MetricsWriter.

The port reads and writes PNG with zlib and numpy; OpenCV, which the JAX
package uses, is imported here only, as the reference: the reader bitwise
against cv2.imread on files cv2.imwrite writes (its default row filter and
adaptive ones), the writer round-tripped through cv2.imread, the reader's
refusals, the Blender writer's refusal of mixed intrinsics, and the
metrics CSV written by both writers. Files of every row filter:
tests/test_torch_io_filters.py and tests/test_torch_io_load.py; the
Blender loaders and load_images: tests/test_torch_io_load.py.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest

from nerfpp_tpu.utils.metrics import MetricsWriter as JaxMetricsWriter
from nerfpp_tpu_torch.data import blender as TB
from nerfpp_tpu_torch.utils.metrics import MetricsWriter
from nerfpp_tpu_torch.utils.png import png_shape, read_png, write_png
from tests.torch_io_common import _cv2_rgb, _filters_of, _image, _scene


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_reader_matches_cv2_on_cv2_files(tmp_path, channels, adaptive):
    # cv2's default row filter (Sub), and libpng's adaptive choice per row
    img = _image(29, 31, channels, channels)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / "a.png"
    flags = ([cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]
             if adaptive else [])
    assert cv2.imwrite(str(path), _cv2_rgb(img), flags)
    if adaptive:
        assert len(set(_filters_of(path).tolist())) > 2  # mixed row filters
    got = read_png(path)
    np.testing.assert_array_equal(
        got, _cv2_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)))
    assert png_shape(path) == (29, 31, channels)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_writer_round_trips_through_cv2(tmp_path, channels):
    img = _image(20, 24, channels, 11)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / "w.png"
    write_png(path, img)
    np.testing.assert_array_equal(
        _cv2_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_reader_refuses_what_it_does_not_read(tmp_path):
    # every PNG kind is read (tests/test_torch_png_kinds.py); an unknown
    # critical chunk is a kind the reader cannot take, and raises
    # NotImplementedError naming the file and the chunk
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), np.zeros((4, 4, 3), np.uint16))
    assert read_png(deep).dtype == np.uint16
    data = deep.read_bytes()
    crit = struct.pack(">I", 2) + b"ABCD\0\0" + struct.pack(
        ">I", zlib.crc32(b"ABCD\0\0") & 0xFFFFFFFF)
    odd = tmp_path / "odd.png"
    odd.write_bytes(data[:33] + crit + data[33:])
    with pytest.raises(NotImplementedError, match="odd.png.*ABCD"):
        read_png(odd)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="bad.png: not a PNG"):
        read_png(bad)
    with pytest.raises(FileNotFoundError):
        read_png(tmp_path / "missing.png")
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "x.png", np.zeros((2, 2, 3), np.float32))


def test_export_refuses_mixed_intrinsics(tmp_path):
    sc = _scene()
    sc.views[1].k = sc.views[1].k * np.float32(1.5)
    with pytest.raises(ValueError, match="mixes intrinsics"):
        TB.export_blender_scene(sc, tmp_path)


def test_metrics_writer_matches_jax(tmp_path):
    rows = [(5, {"loss": 0.5, "psnr": 10.25}),
            (10, {"loss": 0.25, "psnr": 12.5, "mse": 0.125}),  # widens
            (15, {"loss": 0.125})]
    for cls, sub in ((MetricsWriter, "port"), (JaxMetricsWriter, "jax")):
        w = cls(tmp_path / sub)
        for step, m in rows[:2]:
            w.write_scalars(step, m)
        cls(tmp_path / sub).write_scalars(*rows[2])            # resumed
    assert ((tmp_path / "port" / "metrics.csv").read_text()
            == (tmp_path / "jax" / "metrics.csv").read_text())
    img = np.random.RandomState(0).uniform(-0.2, 1.2, (8, 10, 3))
    MetricsWriter(tmp_path / "port").write_image(7, "val_rgb", img)
    JaxMetricsWriter(tmp_path / "jax").write_image(7, "val_rgb", img)
    name = "images/val_rgb_00000007.png"
    np.testing.assert_array_equal(read_png(tmp_path / "port" / name),
                                  read_png(tmp_path / "jax" / name))
