"""The WebP slice as a whole on the CPU, against the JAX package: tiny COLMAP
captures written by scripts/colmap_export.py with WebP views (8 views at
24x24 and 30x30, two distorted OPENCV cameras; the export writes lossless
WebP through the port's writer, then views are re-encoded by cv2: lossy at
qualities 30, 75 and 95, and lossless), and an RGBA capture (lossy with
alpha and lossless, alpha between 40 and 255). Both packages run
``load_from_colmap_reconstruction`` (undistortion: cv2 in the JAX package,
utils/image.py in the port; each view written back as lossless WebP, as
cv2.imwrite writes it) and ``load_images``:

- the undistorted files pixel for pixel the JAX package's under
  cv2.imread, K and near/far bitwise;
- the image stacks bitwise equal;
- the RGBA capture the same (getOptimalNewCameraMatrix at alpha 0 keeps
  the undistortion's zero border out of the image), and with a fully
  transparent hole cut into one view (cv2's libwebp rewrites the colour
  under alpha 0, and load_images keeps it) the undistorted views and the
  stack bitwise the JAX package's too;
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
from tests.torch_image_common import cv2_read
from tests.torch_webp_common import cv2_webp

torch.set_num_threads(1)

# views re-encoded by cv2: None keeps the port's lossless file
QUALITIES = (30, None, 75, 95, None, 30, 95, 75)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    out = {}
    for name in ("mixed", "rgba"):
        ws = export_colmap_scene(scene, tmp_path_factory.mktemp(name), "cpu",
                                 n_samples=32, n_points=1500,
                                 image_format="webp").workspace
        rng = np.random.RandomState(0)
        for j, p in enumerate(sorted((ws / "images").iterdir())):
            img = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            q = QUALITIES[j]
            if name == "rgba":
                img = np.dstack([img, rng.randint(40, 256, img.shape[:2])
                                 .astype(np.uint8)])
                q = 80 if j % 2 else None
            if q is not None or name == "rgba":
                p.write_bytes(cv2_webp(img, q))
        out[name] = ws
    return out


def test_capture_views_read_as_cv2_reads_them(captures):
    for name, channels in (("mixed", 3), ("rgba", 4)):
        files = sorted((captures[name] / "images").iterdir())
        assert [p.name for p in files] == [f"view_{j:03d}.webp"
                                           for j in range(8)]
        kinds = set()
        for p in files:
            data = p.read_bytes()
            kinds.add(data[12:16])
            want = cv2_read(p)
            assert want.shape[2] == channels
            assert want.shape[:2] in ((24, 24), (30, 30))
            np.testing.assert_array_equal(read_image(p, "cpu").numpy(), want)
        assert kinds == ({b"VP8 ", b"VP8L"} if name == "mixed"
                         else {b"VP8X", b"VP8L"})


def test_undistorted_webp_and_stack_equal_the_jax_packages(captures,
                                                           tmp_path):
    ws = captures["mixed"]
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "jax"))
    assert len(port.views) == len(ref.views) == 8
    for a, b in zip(port.views, ref.views):
        pa, pb = Path(a.image_path), Path(b.image_path)
        assert pa.parent.name == "undistorted" and pa.name == pb.name
        assert pa.read_bytes()[12:16] == pb.read_bytes()[12:16] == b"VP8L"
        np.testing.assert_array_equal(cv2_read(pa), cv2_read(pb),
                                      err_msg=pa.name)
        np.testing.assert_array_equal(read_image(pa, "cpu").numpy(),
                                      cv2_read(pb))
        np.testing.assert_array_equal(a.k, b.k)
        assert (a.near, a.far) == (b.near, b.far)
    v0 = port.views[0]
    idx = list(range(8))
    got = load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu")
    want = JD.load_images(ref, idx, target_hw=(v0.h, v0.w))
    assert got.dtype == want.dtype and got.shape == (8, 24, 24, 3)
    np.testing.assert_array_equal(got, want)


def test_rgba_capture_is_the_jax_packages_or_refused_by_name(captures,
                                                            tmp_path):
    ws = captures["rgba"]
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(ws, tmp_path / "jax"))
    # alpha 0 of getOptimalNewCameraMatrix keeps the border inside the
    # image: no fully transparent pixel, so the port writes every view
    for a, b in zip(port.views, ref.views):
        want = cv2_read(b.image_path)
        assert want.shape[2] == 4 and (want[..., 3] > 0).all()
        np.testing.assert_array_equal(cv2_read(a.image_path), want)
        np.testing.assert_array_equal(a.k, b.k)
    v0 = port.views[0]
    idx = list(range(8))
    np.testing.assert_array_equal(
        load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu"),
        JD.load_images(ref, idx, target_hw=(v0.h, v0.w)))
    # a view with a fully transparent hole: cv2's libwebp rewrites the
    # colour under it when the undistorted view is written, and load_images
    # keeps that colour (it drops alpha); the port writes it alike
    holed = shutil.copytree(ws, tmp_path / "holed")
    view = holed / "images" / "view_002.webp"
    img = cv2.imread(str(view), cv2.IMREAD_UNCHANGED)
    # a ramp over the view: libwebp picks its predictor transform, whose
    # predictions it writes under alpha 0
    ramp = 2 * np.add.outer(np.arange(img.shape[0]), np.arange(img.shape[1]))
    img[..., :3] = np.clip(img[..., :3] + ramp[..., None], 0, 255)
    img[..., 3] = 255
    img[6:14, 6:14, 3] = 0
    view.write_bytes(cv2_webp(img))
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(holed, tmp_path / "holed_jax"))
    port = PC.load_from_colmap_reconstruction(holed, device="cpu")
    back = cv2_read(ref.views[2].image_path)
    assert (back[..., 3] == 0).any()
    assert (back[back[..., 3] == 0, :3] != 0).any()
    for a, b in zip(port.views, ref.views):
        np.testing.assert_array_equal(cv2_read(a.image_path),
                                      cv2_read(b.image_path))
        np.testing.assert_array_equal(read_image(a.image_path, "cpu").numpy(),
                                      cv2_read(b.image_path))
        np.testing.assert_array_equal(a.k, b.k)
        assert (a.near, a.far) == (b.near, b.far)
    np.testing.assert_array_equal(
        load_images(port, idx, target_hw=(v0.h, v0.w), device="cpu"),
        JD.load_images(ref, idx, target_hw=(v0.h, v0.w)))


def test_cli_trains_on_a_webp_capture(captures, tmp_path):
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
        f"view_{j:03d}.webp" for j in range(8)]
