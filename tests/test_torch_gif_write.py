"""GIF writing (nerfpp_tpu_torch/utils/gif.py, csrc/gif_codec.cpp) against
cv2.imwrite(".gif") at its defaults, OpenCV 5.0.0's own GIF encoder, on the
CPU, and the GIF slice as a whole against the JAX package:

- the whole file byte for byte: uint8 RGB, RGBA with alpha 0 (the
  transparent index 0x92, its table entry, 0x8e in its place elsewhere)
  and RGBA without (3 channels back), ties of the error diffusion, the LZW
  coder's clears and sub-blocks; uint16, int16 and float images converted
  as cv2's convertTo does;
- gray and 2-channel images refused, naming the file, as cv2.imwrite
  refuses them;
- the committed writer fixtures (tests/data/image/gifw_*: the seeded input
  as .input.npy, cv2's bytes as .gif);
- a COLMAP workspace of .gif views with distortion (one RGBA masked view)
  through ``load_from_colmap_reconstruction`` (the undistortion writes each
  view back as .gif: cv2.imwrite in the JAX package, the port's writer
  here) and ``load_images``: the same bytes and bitwise equal stacks;
  then ``cli train --dataset-type colmap`` takes 4 steps on it.
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
from nerfpp_tpu_torch.utils import gif as G
from nerfpp_tpu_torch.utils.image import read_image, write_image
from scripts.colmap_export import export_colmap_scene
from tests.torch_image_common import (FIXTURES, cv2_gif, cv2_read,
                                      disc_alpha, gif_write_inputs, pattern)

torch.set_num_threads(1)


def gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 3 % 256], -1).astype(np.uint8)


def rgba(img, alpha):
    return np.dstack([img, alpha.astype(np.uint8)])


def images(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "rgb":
        return [pattern(h, w, 3, h) for h, w in ((1, 1), (1, 300), (300, 1),
                                                  (37, 41), (90, 120))] + [
            rng.randint(0, 256, (60, 70, 3)).astype(np.uint8),
            np.full((30, 30, 3), 77, np.uint8)]
    if kind == "ties":
        # gradients sum dyadic errors to exact midpoints between levels
        return [gradient(h, w) for h, w in ((43, 54), (43, 46), (64, 64),
                                            (17, 200))]
    if kind == "rgba":
        out = []
        for h, w in ((9, 13), (40, 52), (80, 60)):
            img = pattern(h, w, 3, w)
            out.append(rgba(img, np.where(rng.rand(h, w) < 0.3, 0, 255)))
            out.append(rgba(img, disc_alpha(h, w)))
            out.append(rgba(img, rng.randint(1, 256, (h, w))))
        # opaque pixels of the transparent index's colour
        flat = np.zeros((6, 8, 3), np.uint8) + np.uint8([144, 144, 170])
        alpha = np.full((6, 8), 255)
        alpha[-1, -1] = 0
        out += [rgba(flat, alpha), rgba(flat, alpha * 0 + 128),
                rgba(pattern(7, 9, 3, 1), np.zeros((7, 9)))]
        return out
    u16 = rng.randint(0, 65536, (15, 22, 3)).astype(np.uint16)
    u16[0, :4] = [[0, 0, 0], [255, 256, 257], [1000, 2, 3], [77, 78, 79]]
    f32 = (rng.rand(12, 14, 3) * 300 - 20).astype(np.float32)
    f32[0, :3] = [[np.nan, np.inf, -np.inf], [2.5, 3.5, 1e10],
                  [254.5, 255.5, -0.5]]
    i16 = rng.randint(-300, 600, (10, 11, 4)).astype(np.int16)
    return [u16, f32, i16, f32.astype(np.float64),
            rng.randint(-128, 128, (5, 6, 3)).astype(np.int8)]


@pytest.mark.parametrize("kind", ["rgb", "ties", "rgba", "converted"])
def test_bytes_match_opencv(kind, tmp_path):
    for j, img in enumerate(images(kind)):
        want = cv2_gif(img)
        assert G.encode_gif(img, "cpu") == want, (kind, j, img.shape)
        write_image(tmp_path / "a.gif", torch.from_numpy(img), "cpu")
        assert (tmp_path / "a.gif").read_bytes() == want
        # read back as cv2 reads its own file
        got = read_image(tmp_path / "a.gif", "cpu").numpy()
        np.testing.assert_array_equal(got, cv2_read(tmp_path / "a.gif"))
        if kind == "rgba":
            assert got.shape[2] == (4 if (img[..., 3] == 0).any() else 3)


def test_lzw_coder_matches_opencv():
    # runs that grow strings to the table's end, clears at 4,096 codes,
    # one pixel, a sub-block boundary
    rng = np.random.RandomState(5)
    for h, w in ((1, 1), (1, 2), (2, 255), (256, 256)):
        flat = np.zeros((h, w, 3), np.uint8)
        assert G.encode_gif(flat, "cpu") == cv2_gif(flat)
    noise = rng.randint(0, 256, (200, 230, 3)).astype(np.uint8)
    data = G.encode_gif(noise, "cpu")
    assert data == cv2_gif(noise)
    lib = G.library()
    idx = rng.randint(0, 256, 20000).astype(np.uint8)
    out = np.empty(40000, np.uint8)
    n = lib.gif_lzw_encode(G._u8(idx), idx.size, 8, G._u8(out), out.size)
    back = np.empty(idx.size, np.uint8)
    src = np.concatenate([[8], out[:n]]).astype(np.uint8)
    assert lib.gif_lzw_decode(G._u8(src), src.size, idx.size,
                              G._u8(back)) == src.size
    np.testing.assert_array_equal(back, idx)
    assert lib.gif_lzw_encode(G._u8(idx), idx.size, 8, G._u8(out), 100) < 0


def test_refused_images_raise_naming_the_file(tmp_path):
    for shape in ((5, 7), (5, 7, 1), (5, 7, 2)):
        img = np.zeros(shape, np.uint8)
        if len(shape) == 2 or shape[2] == 1:
            assert not cv2.imwrite(str(tmp_path / "cv2.gif"), img)
        with pytest.raises(ValueError, match=r"g\.gif.*3- or 4-channel"):
            write_image(tmp_path / "g.gif", img, "cpu")
        assert not (tmp_path / "g.gif").exists()
    with pytest.raises(TypeError, match="GIF takes"):
        G.encode_gif(np.zeros((2, 2, 3), np.uint32), "cpu")


def test_committed_writer_fixtures_match_opencv_and_the_port():
    inputs = gif_write_inputs()
    assert sorted(p.name for p in FIXTURES.glob("gifw_*.input.npy")) == \
        sorted(f"{s}.input.npy" for s in inputs)
    for stem, img in inputs.items():
        committed = np.load(FIXTURES / f"{stem}.input.npy")
        np.testing.assert_array_equal(committed, img)
        want = (FIXTURES / f"{stem}.gif").read_bytes()
        assert cv2_gif(img) == want, stem
        assert G.encode_gif(torch.from_numpy(committed), "cpu") == want
        # the host and device parts apart
        assert G.encode_rgb(G.encoder_input(committed, "cpu")) == want


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=32,
                                 n_samples=8, white_bkgr=False, device="cpu")
    ws = export_colmap_scene(scene, tmp_path_factory.mktemp("gif"), "cpu",
                             n_samples=32, n_points=1500,
                             image_format="gif").workspace
    # view 2 as cv2 writes an RGBA masked view (alpha 0 off a disc)
    p = sorted((ws / "images").iterdir())[2]
    img = cv2_read(p)
    p.write_bytes(cv2_gif(rgba(img, disc_alpha(*img.shape[:2]))))
    return ws


def test_gif_capture_equals_the_jax_packages(capture, tmp_path):
    files = sorted((capture / "images").iterdir())
    assert [p.name for p in files] == [f"view_{j:03d}.gif" for j in range(8)]
    for p in files:
        np.testing.assert_array_equal(read_image(p, "cpu").numpy(),
                                      cv2_read(p), err_msg=p.name)
    assert read_image(files[2], "cpu").shape[2] == 4
    port = PC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        shutil.copytree(capture, tmp_path / "jax"))
    assert len(port.views) == len(ref.views) == 8
    for a, b in zip(port.views, ref.views):
        pa, pb = Path(a.image_path), Path(b.image_path)
        assert pa.parent.name == "undistorted" and pa.name == pb.name
        assert pa.read_bytes() == pb.read_bytes(), pa.name
        np.testing.assert_array_equal(a.k, b.k)
        assert (a.near, a.far) == (b.near, b.far)
    assert read_image(Path(port.views[2].image_path), "cpu").shape[2] == 4
    idx = list(range(8))
    for hw in ((32, 32), (24, 24)):
        for white in (False, True):
            got = load_images(port, idx, white_bkgr=white, target_hw=hw,
                              device="cpu")
            want = JD.load_images(ref, idx, white_bkgr=white, target_hw=hw)
            assert got.dtype == want.dtype and got.shape == (8, *hw, 3)
            np.testing.assert_array_equal(got, want)


def test_cli_trains_on_a_gif_capture(capture, tmp_path):
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
        f"view_{j:03d}.gif" for j in range(8)]
