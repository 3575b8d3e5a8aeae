"""The image-format slice as a whole on the CPU, against the JAX package:
tiny COLMAP captures written by scripts/colmap_export.py (8 views at 24x24
and 30x30, two distorted OPENCV cameras) in the formats a real capture
carries: a mixed one (the first camera's views as progressive JPEG, the
second's as 8-bit TIFF) and a 16-bit PNG one. Both packages run
``load_from_colmap_reconstruction`` (undistortion: cv2 in the JAX package,
utils/image.py in the port; a progressive view is written back as baseline
JPEG at quality 95, a TIFF as TIFF, a 16-bit PNG as 16-bit PNG, as
cv2.imwrite writes them) and ``load_images``:

- the undistorted JPEGs byte for byte the JAX package's, the TIFFs and
  16-bit PNGs pixel for pixel under cv2.imread;
- the image stacks bitwise equal, the 16-bit capture's with values up to
  65535 / 255 = 257 (the JAX package divides every depth by 255 after the
  resize: its behaviour, mirrored, ROADMAP.md);
- then ``cli train --dataset-type colmap`` takes 4 steps on the mixed
  capture.
"""
import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu.data import colmap as JC
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.data import colmap as PC
from nerfpp_tpu_torch.data.dataset import load_images
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils import jpeg as J
from nerfpp_tpu_torch.utils.image import read_image
from scripts.colmap_export import export_colmap_scene
from tests.torch_image_common import cv2_read

torch.set_num_threads(1)

CAPTURES = {"mixed": ("pjpg", "tif"), "png16": ("png16", "png16")}


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    return {name: export_colmap_scene(
        scene, tmp_path_factory.mktemp(name), "cpu", n_samples=32,
        n_points=1500, image_format=fmt).workspace
        for name, fmt in CAPTURES.items()}


def test_export_writes_views_opencv_reads(captures):
    names = sorted(p.name for p in (captures["mixed"] / "images").iterdir())
    assert names == [f"view_{j:03d}.{'tif' if j % 4 == 3 else 'jpg'}"
                     for j in range(8)]
    for name in names:
        p = captures["mixed"] / "images" / name
        if p.suffix == ".jpg":
            assert J.decode_coefficients(p.read_bytes()).progressive
        want = cv2_read(p)
        assert want.dtype == np.uint8
        assert want.shape in ((24, 24, 3), (30, 30, 3))
        np.testing.assert_array_equal(read_image(p, "cpu").numpy(), want)
    for p in sorted((captures["png16"] / "images").iterdir()):
        got = read_image(p, "cpu")
        assert got.dtype == torch.uint16
        np.testing.assert_array_equal(got.numpy(), cv2_read(p))


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
        if pa.suffix == ".jpg":
            assert pa.read_bytes() == pb.read_bytes(), pa.name
            assert not J.decode_coefficients(pa.read_bytes()).progressive
        else:
            want = cv2_read(pb)
            got = cv2_read(pa)
            assert got.dtype == want.dtype == (
                np.uint16 if capture == "png16" else np.uint8)
            np.testing.assert_array_equal(got, want, err_msg=pa.name)
    v0 = port.views[0]
    idx = list(range(8))
    got = load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu")
    want = JD.load_images(ref, idx, target_hw=(v0.h, v0.w))
    assert got.dtype == want.dtype and got.shape == (8, 24, 24, 3)
    np.testing.assert_array_equal(got, want)
    if capture == "png16":
        assert 1.0 < got.max() <= 65535 / 255


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
    assert sorted(p.name for p in (ws / "undistorted").iterdir()) == [
        f"view_{j:03d}.{'tif' if j % 4 == 3 else 'jpg'}" for j in range(8)]
