"""The JPEG slice as a whole on the CPU, against the JAX package: a tiny
COLMAP capture written by scripts/colmap_export.py with JPEG views (8
views at 24x24 and 30x30, two distorted OPENCV cameras), loaded by both
packages' ``load_from_colmap_reconstruction`` (undistortion re-encodes each
view as JPEG at quality 95: cv2.imwrite in the JAX package, utils/jpeg.py
in the port) and ``load_images``. The undistorted files must be equal byte
for byte and the image stacks bit for bit; then ``cli train --dataset-type
colmap`` runs 4 steps on the capture.
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
from nerfpp_tpu_torch.utils.jpeg import read_jpeg
from scripts.colmap_export import export_colmap_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    return export_colmap_scene(scene, tmp_path_factory.mktemp("jpeg"), "cpu",
                               n_samples=32, n_points=1500,
                               image_format="jpg").workspace


def test_export_writes_jpeg_views_opencv_reads(capture):
    files = sorted((capture / "images").iterdir())
    assert [p.name for p in files] == [f"view_{j:03d}.jpg" for j in range(8)]
    for p in files:
        want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)[..., ::-1]
        assert want.shape in ((24, 24, 3), (30, 30, 3))
        np.testing.assert_array_equal(read_jpeg(p, "cpu").numpy(), want)


def test_undistorted_jpegs_and_images_equal_the_jax_packages(capture,
                                                              tmp_path):
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "jax"))
    assert len(port.views) == len(ref.views) == 8
    for a, b in zip(port.views, ref.views):
        pa, pb = Path(a.image_path), Path(b.image_path)
        assert pa.parent.name == "undistorted" and pa.name == pb.name
        assert pa.suffix == ".jpg"
        assert pa.read_bytes() == pb.read_bytes(), pa.name
        np.testing.assert_array_equal(a.k, b.k)
    v0 = port.views[0]
    idx = list(range(8))
    got = load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu")
    want = JD.load_images(ref, idx, target_hw=(v0.h, v0.w))
    assert got.dtype == want.dtype and got.shape == (8, 24, 24, 3)
    np.testing.assert_array_equal(got, want)


def test_cli_trains_on_a_jpeg_capture(capture, tmp_path):
    ws = shutil.copytree(capture, tmp_path / "ws")
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
    views = json.loads((out / "data.json").read_text())["Views"]
    assert len(views) == 8
    assert sorted(p.name for p in (ws / "undistorted").iterdir()) == [
        f"view_{j:03d}.jpg" for j in range(8)]
