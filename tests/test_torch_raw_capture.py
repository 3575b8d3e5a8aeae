"""The uncompressed, run-length and float image formats through the slice
as a whole on the CPU, against the JAX package: tiny COLMAP captures
written by scripts/colmap_export.py (8 views at 24x24 and 30x30, two
distorted OPENCV cameras), each view in its own format:

- "mixed": BMP, PPM, Sun raster, PAM, progressive JPEG and TIFF at 8 bits;
- "deep": 16-bit PPM, PFM, Radiance HDR, int16 TIFF and float32 TIFF
  (the int16 and HDR views are the second camera's, resized to 24x24).

Both packages run ``load_from_colmap_reconstruction`` (undistortion: cv2 in
the JAX package, utils/image.py in the port; each view written back in its
own format as cv2.imwrite writes it) and ``load_images``:

- the undistorted files byte for byte the JAX package's (TIFF: pixel for
  pixel under cv2.imread, as the port's TIFF bytes are not libtiff's);
- the image stacks bitwise equal for 8- and 16-bit views (int16 too, the
  resize included); float views
  differ only through the float resize of the 30x30 views to 24x24
  (utils/image.py: within 1e-6 of the view's largest magnitude), and come
  out divided by 255 as the JAX package divides them (its behaviour,
  mirrored; ROADMAP.md);
- then ``cli train --dataset-type colmap`` takes 4 steps on the mixed
  capture.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfpp_tpu.data import colmap as JC
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.data import colmap as PC
from nerfpp_tpu_torch.data.dataset import load_images
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils.image import read_image
from scripts.colmap_export import FORMATS, export_colmap_scene
from tests.torch_image_common import cv2_read

torch.set_num_threads(1)

CAPTURES = {"mixed": ("bmp", "ppm", "ras", "pam", "pjpg", "tif", "bmp",
                      "ppm"),
            "deep": ("ppm16", "pfm", "hdr", "itif", "ftif")}


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    return {name: export_colmap_scene(
        scene, tmp_path_factory.mktemp(name), "cpu", n_samples=32,
        n_points=1500, image_format=fmts).workspace
        for name, fmts in CAPTURES.items()}


def test_export_writes_views_opencv_reads(captures):
    for name, fmts in CAPTURES.items():
        files = sorted((captures[name] / "images").iterdir())
        assert [f.name for f in files] == [
            f"view_{j:03d}{FORMATS[fmts[j % len(fmts)]][0]}"
            for j in range(8)]
        for j, f in enumerate(files):
            want = cv2_read(f)
            assert want.dtype == FORMATS[fmts[j % len(fmts)]][1]
            assert want.shape in ((24, 24, 3), (30, 30, 3))
            got = read_image(f, "cpu").numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("capture", sorted(CAPTURES))
def test_undistorted_files_and_images_equal_the_jax_packages(
        captures, capture, tmp_path):
    ws = captures[capture]
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "jax"))
    assert len(port.views) == len(ref.views) == 8
    for a, b in zip(port.views, ref.views):
        pa, pb = Path(a.image_path), Path(b.image_path)
        assert pa.parent.name == "undistorted" and pa.name == pb.name
        np.testing.assert_array_equal(a.k, b.k)
        if pa.suffix == ".tif":
            want, got = cv2_read(pb), cv2_read(pa)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=pa.name)
        else:
            assert pa.read_bytes() == pb.read_bytes(), pa.name
    v0 = port.views[0]
    idx = list(range(8))
    got = load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu")
    want = JD.load_images(ref, idx, target_hw=(v0.h, v0.w))
    assert got.dtype == want.dtype and got.shape == (8, 24, 24, 3)
    fmts = CAPTURES[capture]
    for j in idx:
        stored = FORMATS[fmts[j % len(fmts)]][1]
        if stored != "float32" or port.views[j].w == v0.w:
            np.testing.assert_array_equal(got[j], want[j], err_msg=str(j))
        else:                   # a float view resized: the documented bound
            np.testing.assert_allclose(got[j], want[j], rtol=0,
                                       atol=1e-6 * np.abs(want[j]).max())
    if capture == "deep":
        assert 1.0 < got[0].max() <= 65535 / 255       # 16-bit / 255
        assert got[1].max() <= 1.0 / 255               # float / 255
        assert port.views[3].w != v0.w                 # int16, resized
        lo = np.float32(-32768) / np.float32(255)      # as load_images
        assert lo <= got[3].min() < -1.0 < 1.0 < got[3].max()


def test_cli_trains_on_the_mixed_capture(captures, tmp_path):
    ws = shutil.copytree(captures["mixed"], tmp_path / "ws")
    out = tmp_path / "out"
    cli.main(["train", "--dataset-type", "colmap", "--data-dir", str(ws),
              "--base-dir", str(out), "--device", "cpu",
              "--set", "n_levels=4", "--set", "log2_hashmap_size=10",
              "--set", "finest_resolution=64", "--set", "n_importance=0",
              "--set", "use_occupancy_grid=true",
              "--set", "occ_grid_resolution=16",
              "--set-train", "NRand=256", "--set-train", "Chunk=256",
              "--set-train", "NSamples=8", "--set-train", "NIters=5",
              "--set-train", "IPrint=1", "--set-train", "IImg=0",
              "--set-train", "IWeights=0"])
    rows = (out / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2", "3", "4"]
    assert all(np.isfinite(float(x)) for r in rows[1:]
               for x in r.split(",")[1:])
    assert len(json.loads((out / "data.json").read_text())["Views"]) == 8
    assert sorted(p.name for p in (ws / "undistorted").iterdir()) == sorted(
        p.name for p in (ws / "images").iterdir())
