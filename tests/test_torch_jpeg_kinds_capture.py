"""The JPEG kinds as a whole on the CPU, against the JAX package: a tiny
COLMAP capture written by scripts/colmap_export.py with JPEG views (8 views
at 32x32 and 40x40, two distorted OPENCV cameras), then views rewritten by
scripts/jpeg_kinds.py as arithmetic-coded sequential (restarts, DAC) and
progressive, Adobe CMYK, YCCK, lossless RGB and lossless gray-precision
files, and one as Pillow's progressive CMYK. Both packages run
``load_from_colmap_reconstruction`` (undistortion: cv2 in the JAX package,
utils/image.py in the port; each view written back as cv2.imwrite's
baseline JPEG at quality 95, the writer the port already has) and
``load_images``:

- every view read as cv2.imread reads it;
- the undistorted files byte for byte the JAX package's (all baseline
  JPEG), K and near/far bitwise;
- the image stacks bitwise equal;
- then ``cli train --dataset-type colmap`` takes 4 steps on the capture.
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
from nerfpp_tpu_torch.utils import jpeg as J
from nerfpp_tpu_torch.utils.image import read_image
from scripts import jpeg_kinds as K
from scripts.colmap_export import export_colmap_scene
from tests.torch_jpeg_kinds_common import cv2_read, pillow_cmyk

torch.set_num_threads(1)

# view j's kind; None keeps the export's baseline file
KINDS = ("arith", "arith_progressive", "cmyk", "lossless", "ycck",
         "pillow_cmyk", None, "arith_restart_dac")


def rewrite(path: Path, kind):
    if kind in ("arith", "arith_progressive", "cmyk", "lossless"):
        K.rewrite(path, kind, "cpu")
        return
    img = read_image(path, "cpu")
    if kind == "ycck":
        path.write_bytes(K.huffman_bytes(K.planes_plan(
            K.ycck_planes(K.cmyk_planes(img)), [(2, 2), (1, 1), (1, 1),
                                                (2, 2)]), app=K.adobe(2)))
    elif kind == "pillow_cmyk":
        cmyk = torch.stack(K.cmyk_planes(img), -1).numpy()
        path.write_bytes(pillow_cmyk(cmyk, progressive=True, quality=90))
    elif kind == "arith_restart_dac":
        path.write_bytes(K.arith_bytes(K.plan_of(path.read_bytes()),
                                       restart=2, dac={("dc", 1): (1, 2),
                                                       ("ac", 1): 3}))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=32,
                                 n_samples=8, white_bkgr=False, device="cpu")
    ws = export_colmap_scene(scene, tmp_path_factory.mktemp("kinds"), "cpu",
                             n_samples=32, n_points=1500,
                             image_format="jpg").workspace
    for j, p in enumerate(sorted((ws / "images").iterdir())):
        if KINDS[j] is not None:
            rewrite(p, KINDS[j])
    return ws


def test_capture_views_read_as_cv2_reads_them(capture, tmp_path):
    files = sorted((capture / "images").iterdir())
    assert [p.name for p in files] == [f"view_{j:03d}.jpg" for j in range(8)]
    colours, coded = [], []
    for p in files:
        want = cv2_read(p.read_bytes(), tmp_path)
        assert want.shape in ((32, 32, 3), (40, 40, 3)), p.name
        np.testing.assert_array_equal(read_image(p, "cpu").numpy(), want,
                                      err_msg=p.name)
        frame = J.decode_coefficients(p.read_bytes(), p)
        colours.append(frame.colour)
        coded.append((frame.arithmetic, frame.progressive, frame.lossless))
    assert colours == ["ycc", "ycc", "cmyk", "rgb", "ycck", "cmyk", "ycc",
                       "ycc"]
    assert coded[:4] == [(True, False, False), (True, True, False),
                         (False, False, False), (False, False, True)]


def test_undistorted_files_and_stack_equal_the_jax_packages(capture,
                                                            tmp_path):
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "jax"))
    assert len(port.views) == len(ref.views) == 8
    for a, b in zip(port.views, ref.views):
        pa, pb = Path(a.image_path), Path(b.image_path)
        assert pa.parent.name == "undistorted" and pa.name == pb.name
        assert pa.read_bytes() == pb.read_bytes(), pa.name
        # written back as baseline JPEG: no new writer
        frame = J.decode_coefficients(pa.read_bytes(), pa)
        assert (frame.colour, frame.arithmetic, frame.progressive,
                frame.lossless) == ("ycc", False, False, False)
        np.testing.assert_array_equal(a.k, b.k)
        assert (a.near, a.far) == (b.near, b.far)
    idx = list(range(8))
    for hw in ((32, 32), (24, 24)):
        got = load_images(port, idx, target_hw=hw, device="cpu")
        want = JD.load_images(ref, idx, target_hw=hw)
        assert got.dtype == want.dtype and got.shape == (8, *hw, 3)
        np.testing.assert_array_equal(got, want)


def test_cli_trains_on_the_capture(capture, tmp_path):
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
