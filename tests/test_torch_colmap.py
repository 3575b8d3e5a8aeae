"""Port parity: the COLMAP loader (data/colmap.py), the port's native
parser (native.py), OpenCV's resampling in PyTorch (utils/image.py) and the
sampler on a capture with two image sizes, against the JAX package and its
cv2 calls.

The workspaces are the JAX tests' synthetic model (tests/test_colmap.py)
and a tiny capture written by scripts/colmap_export.py: 8 views at 24x24
and 30x30, two OPENCV cameras, distorted PNGs, the model in .bin and .txt.
Measured against cv2 5.0.0 on the CPU: the new camera matrices, the
undistorted images and the 8-bit resizes are OpenCV's bit for bit (the
tests hold them exactly; the bound asked of them was one gray level), the
float resize within 1e-6.

OpenCV's resampling without a workspace (resize, the new camera matrix,
undistortion), the .txt model as the JAX test writes it and the SfM
shell-out: tests/test_torch_colmap_resample.py.
"""
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu import native as jax_native
from nerfpp_tpu.data import colmap as JC
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu_torch import native
from nerfpp_tpu_torch.data import colmap as PC
from nerfpp_tpu_torch.data.dataset import RayBatchSampler, load_images
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils.png import read_png
from tests.torch_colmap_common import (ROOT, _copy, _same_reconstruction,
                                       capture, synthetic_model)

torch.set_num_threads(1)


# ----------------------------------------------------------------- parsers

@pytest.mark.parametrize("which", ["model", "capture"])
def test_bin_parsers_match_the_jax_package(which, synthetic_model, capture):
    # the port's Python .bin readers and its native parser, each against
    # the JAX package's read_model
    sparse = (synthetic_model if which == "model"
              else capture.workspace / "sparse" / "0")
    ref = JC.read_model(sparse)
    py = PC.ColmapReconstruction(
        PC._read_cameras_bin(sparse / "cameras.bin"),
        PC._read_images_bin(sparse / "images.bin"),
        *PC._read_points3d_bin(sparse / "points3D.bin"))
    _same_reconstruction(py, ref)
    nat = PC._read_model_native(sparse)
    assert nat is not None
    _same_reconstruction(nat, ref)
    _same_reconstruction(PC.read_model(sparse), ref)


def test_txt_parser_matches_the_bin_model(capture):
    # the exporter's .txt copy reads back to the .bin model exactly (floats
    # written as their shortest round-trip text); without the .bin files
    # read_model takes the .txt, as the JAX package's does
    sparse = capture.workspace / "sparse" / "0"
    txt = PC.ColmapReconstruction(
        PC._read_cameras_txt(sparse / "cameras.txt"),
        PC._read_images_txt(sparse / "images.txt"),
        *PC._read_points3d_txt(sparse / "points3D.txt"))
    _same_reconstruction(txt, PC.read_model(sparse))
    ref = JC.ColmapReconstruction(
        JC._read_cameras_txt(sparse / "cameras.txt"),
        JC._read_images_txt(sparse / "images.txt"),
        *JC._read_points3d_txt(sparse / "points3D.txt"))
    _same_reconstruction(txt, ref)


def test_native_library_builds_into_the_port(synthetic_model):
    # the port's own build, beside its kernels, never into native/; its
    # near/far and pyramid lookup return what the JAX package's library
    # returns
    lib = native.load()
    assert lib is not None and lib.nerfpp_native_version() == 1
    path = native.lib_path()
    assert path.exists() and path.parent == ROOT / "nerfpp_tpu_torch" / "_build"
    rng = np.random.RandomState(0)
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    t, pts = rng.randn(3), rng.randn(500, 3) * 2.0
    if jax_native.load() is not None:
        assert native.compute_near_far(q, t, pts) == \
            jax_native.compute_near_far(q, t, pts)
        grids = {z: rng.rand(3 + z, 4 + z, 8).astype(np.float32)
                 for z in (0, 1)}
        xs, ys = (rng.rand(50).astype(np.float32) * 63 for _ in range(2))
        args = (grids, 0, 1, 8, 16.0, 0.5, xs, ys, 0.75)
        np.testing.assert_array_equal(native.pyramid_lookup(*args),
                                      jax_native.pyramid_lookup(*args))


# ---------------------------------------------------------------- geometry

def test_poses_rotations_exact(capture):
    rng = np.random.RandomState(3)
    for _ in range(20):
        q, t = rng.randn(4), rng.randn(3)
        np.testing.assert_array_equal(PC.qvec_to_rotmat(q),
                                      JC.qvec_to_rotmat(q))
        np.testing.assert_array_equal(PC.colmap_w2c_to_nerf_c2w(q, t),
                                      JC.colmap_w2c_to_nerf_c2w(q, t))
    # the exported poses come back within 1e-5 (f32 c2w through f64 w2c)
    rec = PC.read_model(capture.workspace / "sparse" / "0")
    for i, iid in enumerate(sorted(rec.images)):
        im = rec.images[iid]
        pose = PC.colmap_w2c_to_nerf_c2w(im.qvec, im.tvec)
        assert np.abs(pose - capture.poses[i]).max() <= 1e-5


@pytest.mark.parametrize("quirk", [False, True])
def test_near_far_and_bbox_exact(quirk, synthetic_model, capture):
    # both origins (camera centre, and the reference's w2c translation)
    for sparse in (synthetic_model, capture.workspace / "sparse" / "0"):
        prec, jrec = PC.read_model(sparse), JC.read_model(sparse)
        rows = {pid: i for i, pid in enumerate(prec.points_ids)}
        for iid in prec.images:
            got = PC.compute_near_far_for_image(prec.images[iid], prec,
                                                reference_quirk=quirk,
                                                id_to_row=rows)
            assert got == JC.compute_near_far_for_image(
                jrec.images[iid], jrec, reference_quirk=quirk)
            assert got[0] < got[1]
        np.testing.assert_array_equal(PC.compute_bounding_box(prec),
                                      JC.compute_bounding_box(jrec))


def test_loading_without_undistortion_gives_the_same_scene(synthetic_model,
                                                           capture, tmp_path):
    ws = tmp_path / "ws"
    (ws / "sparse" / "0").mkdir(parents=True)
    for f in synthetic_model.iterdir():
        shutil.copy(f, ws / "sparse" / "0")
    for root, image_path in ((ws, ws), (capture.workspace, None)):
        got = PC.load_from_colmap_reconstruction(root, image_path,
                                                 undistort=False)
        ref = JC.load_from_colmap_reconstruction(root, image_path,
                                                 undistort=False)
        assert got.to_json() == ref.to_json()
        for a, b in zip(got.views, ref.views):
            np.testing.assert_array_equal(a.d, b.d)
            assert a.k.dtype == b.k.dtype and a.pose.dtype == b.pose.dtype
    assert got.splits_idx == [8, 0, 0]
    assert {(v.h, v.w) for v in got.views} == {(24, 24), (30, 30)}


def test_undistortion_matches_opencv(capture, tmp_path):
    # new K and the undistorted PNGs against the JAX package's cv2 path:
    # measured equal, every pixel and every entry
    mine = PC.load_from_colmap_reconstruction(
        _copy(capture.workspace, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        _copy(capture.workspace, tmp_path / "jax"))
    for a, b in zip(mine.views, ref.views):
        assert a.d is None and b.d is None
        assert Path(a.image_path).parent.name == "undistorted"
        np.testing.assert_array_equal(a.k, b.k)
        got = read_png(a.image_path)
        want = cv2.imread(b.image_path, cv2.IMREAD_UNCHANGED)[..., ::-1]
        np.testing.assert_array_equal(got, want)
    assert mine.to_json()["Views"][0]["K"] == ref.to_json()["Views"][0]["K"]


def test_non_png_images_raise_naming_the_file(synthetic_model, tmp_path):
    # PNG, JPEG, TIFF, BMP, WebP, GIF, JPEG 2000 and the other formats the
    # port reads are read; an AVIF view raises when the undistortion reads
    # it, a JPEG 2000 view of a kind the port does not read (its code-block
    # style set to bypass) when load_images does, each naming the file and
    # its kind
    from scripts.colmap_export import write_images_bin
    img = np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8)
    for ext, params, kind in ((".avif", [], "AVIF"),
                              (".jp2", [], "JPEG 2000")):
        ws = tmp_path / ext[1:]
        (ws / "sparse" / "0").mkdir(parents=True)
        for f in synthetic_model.iterdir():
            shutil.copy(f, ws / "sparse" / "0")
        rec = JC.read_model(ws / "sparse" / "0")
        for im in rec.images.values():
            im.name = im.name.replace(".png", ext)
            assert cv2.imwrite(str(ws / im.name), img, params)
            if ext == ".jp2":
                data = bytearray((ws / im.name).read_bytes())
                data[data.find(b"\xff\x52\x00\x0c") + 12] = 1
                (ws / im.name).write_bytes(bytes(data))
        write_images_bin(ws / "sparse" / "0" / "images.bin",
                         [rec.images[i] for i in sorted(rec.images)])
        match = rf"img_1\{ext}.*{kind}"
        if kind == "AVIF":
            with pytest.raises(NotImplementedError, match=match):
                PC.load_from_colmap_reconstruction(ws, device="cpu")
        else:
            sc = PC.load_from_colmap_reconstruction(ws, undistort=False,
                                                    device="cpu")
            with pytest.raises(NotImplementedError, match=match):
                load_images(sc, [0], device="cpu")


# ----------------------------------------------------------------- sampler

def test_sampler_on_two_sizes_matches_the_jax_package(capture, tmp_path):
    # the 30x30 views resized to view 0's 24x24 (8-bit, before the
    # conversion) and their intrinsics scaled, as the JAX sampler does
    mine = PC.load_from_colmap_reconstruction(
        _copy(capture.workspace, tmp_path / "port"), device="cpu")
    ref = JC.load_from_colmap_reconstruction(
        _copy(capture.workspace, tmp_path / "jax"))
    ps = RayBatchSampler.from_scene(mine, 128, device="cpu")
    js = JD.RayBatchSampler.from_scene(ref, 128)
    np.testing.assert_array_equal(ps.images.numpy(), np.asarray(js.images))
    np.testing.assert_array_equal(ps.intrinsics.numpy(),
                                  np.asarray(js.intrinsics))
    np.testing.assert_array_equal(ps.poses.numpy(), np.asarray(js.poses))
    # attached float images resize in float, as cv2.resize does
    sc = make_synthetic_scene(n_train=2, n_val=0, n_test=0, image_hw=10,
                              n_samples=4, white_bkgr=False, device="cpu")
    got = load_images(sc, [0, 1], target_hw=(7, 13), device="cpu")
    want = np.stack([cv2.resize(np.asarray(im, np.float32), (13, 7))
                     for im in sc.images])
    assert np.abs(got - want).max() <= 1e-6
