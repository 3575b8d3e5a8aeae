"""The JPEG 2000 slice as a whole on the CPU, against the JAX package: a
tiny COLMAP capture written by scripts/colmap_export.py with .jp2 views (8
views at 32x32 and 40x40, two distorted OPENCV cameras; the export writes
each view as cv2.imwrite writes .jp2 at its defaults, through the port's
writer), then some views re-encoded: by cv2 lossless and at rates 10 and 2,
and by Pillow as 9/7 in tiles with layers, as YCbCr and as a raw .j2k
codestream under the .jp2 name. Both packages run
``load_from_colmap_reconstruction`` (undistortion: cv2 in the JAX package,
utils/image.py in the port; each view written back as cv2.imwrite writes
.jp2) and ``load_images``:

- every view read as cv2.imread reads it;
- the undistorted files byte for byte the JAX package's, K and near/far
  bitwise;
- the image stacks bitwise equal;
- then ``cli train --dataset-type colmap`` takes 4 steps on the capture.
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
from nerfpp_tpu_torch.utils.image import read_image
from scripts.colmap_export import export_colmap_scene
from tests.torch_image_common import codestream, cv2_jp2, cv2_read, pillow_jp2

torch.set_num_threads(1)


def reencode(j, img):
    """View j's file: the port's own (None), or cv2's or Pillow's of its
    pixels (RGB)."""
    bgr = np.ascontiguousarray(img[..., ::-1])
    rate = cv2.IMWRITE_JPEG2000_COMPRESSION_X1000
    return (None, cv2_jp2(bgr, [rate, 1000]), cv2_jp2(bgr, [rate, 100]),
            pillow_jp2(img, irreversible=True, tile_size=(16, 16),
                       quality_mode="rates", quality_layers=[12, 4]),
            None, pillow_jp2(img, "YCbCr", progression="RPCL"),
            codestream(cv2_jp2(bgr, [rate, 500])), None)[j]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=32,
                                 n_samples=8, white_bkgr=False, device="cpu")
    ws = export_colmap_scene(scene, tmp_path_factory.mktemp("jp2"), "cpu",
                             n_samples=32, n_points=1500,
                             image_format="jp2").workspace
    for j, p in enumerate(sorted((ws / "images").iterdir())):
        data = reencode(j, cv2_read(p))
        if data is not None:
            p.write_bytes(data)
    return ws


def test_capture_views_read_as_cv2_reads_them(capture):
    files = sorted((capture / "images").iterdir())
    assert [p.name for p in files] == [f"view_{j:03d}.jp2" for j in range(8)]
    kinds = set()
    for p in files:
        want = cv2_read(p)
        assert want.shape in ((32, 32, 3), (40, 40, 3))
        np.testing.assert_array_equal(read_image(p, "cpu").numpy(), want,
                                      err_msg=p.name)
        kinds.add(p.read_bytes()[:4])
    assert kinds == {b"\x00\x00\x00\x0c", b"\xff\x4f\xff\x51"}


def test_undistorted_jp2_and_stack_equal_the_jax_packages(capture, tmp_path):
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "jax"))
    assert len(port.views) == len(ref.views) == 8
    for a, b in zip(port.views, ref.views):
        pa, pb = Path(a.image_path), Path(b.image_path)
        assert pa.parent.name == "undistorted" and pa.name == pb.name
        assert pa.read_bytes() == pb.read_bytes(), pa.name
        np.testing.assert_array_equal(read_image(pa, "cpu").numpy(),
                                      cv2_read(pb))
        np.testing.assert_array_equal(a.k, b.k)
        assert (a.near, a.far) == (b.near, b.far)
    idx = list(range(8))
    for hw in ((32, 32), (24, 24)):
        got = load_images(port, idx, target_hw=hw, device="cpu")
        want = JD.load_images(ref, idx, target_hw=hw)
        assert got.dtype == want.dtype and got.shape == (8, *hw, 3)
        np.testing.assert_array_equal(got, want)


def test_cli_trains_on_a_jp2_capture(capture, tmp_path):
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
    assert len(json.loads((out / "data.json").read_text())["Views"]) == 8
    assert sorted(p.name for p in (ws / "undistorted").iterdir()) == [
        f"view_{j:03d}.jp2" for j in range(8)]
