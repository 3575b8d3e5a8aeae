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
from nerfpp_tpu_torch.utils import image as I
from nerfpp_tpu_torch.utils.png import read_png
from scripts.colmap_export import export_colmap_scene
from tests.test_colmap import _synthetic_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A tiny exported capture: 8 train views, every 4th by the second
    camera at 30x30."""
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    ws = tmp_path_factory.mktemp("capture")
    return export_colmap_scene(scene, ws, "cpu", n_samples=32,
                               n_points=1500)


@pytest.fixture(scope="module")
def synthetic_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    _synthetic_model(d)
    return d


def _copy(ws: Path, dst: Path) -> Path:
    shutil.copytree(ws, dst)
    return dst


def _same_reconstruction(a, b):
    """Field by field, exactly."""
    assert sorted(a.cameras) == sorted(b.cameras)
    for cid in a.cameras:
        x, y = a.cameras[cid], b.cameras[cid]
        assert (x.model, x.width, x.height) == (y.model, y.width, y.height)
        np.testing.assert_array_equal(x.params, y.params)
    assert sorted(a.images) == sorted(b.images)
    for iid in a.images:
        x, y = a.images[iid], b.images[iid]
        assert (x.image_id, x.camera_id, x.name) == (y.image_id, y.camera_id,
                                                     y.name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
    np.testing.assert_array_equal(a.points_xyz, b.points_xyz)
    np.testing.assert_array_equal(a.points_ids, b.points_ids)


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


def test_txt_model_as_the_jax_test_writes_it(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 64 48 60.0 61.0 32.0 24.0\n")
    (tmp_path / "images.txt").write_text(
        "# comment\n1 1 0 0 0 0.5 0.5 0.5 1 img.png\n"
        "1.0 2.0 15 3.0 4.0 -1\n")
    (tmp_path / "points3D.txt").write_text(
        "# comment\n15 1.0 2.0 3.0 128 128 128 0.5\n")
    _same_reconstruction(PC.read_model(tmp_path), JC.read_model(tmp_path))


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
    # PNG, JPEG and TIFF views are read; a BMP view raises when the
    # undistortion reads it, a WebP view when load_images does, each naming
    # the file and its kind
    from scripts.colmap_export import write_images_bin
    img = np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8)
    for ext, params, kind in ((".bmp", [], "BMP"), (".webp", [], "WebP")):
        ws = tmp_path / ext[1:]
        (ws / "sparse" / "0").mkdir(parents=True)
        for f in synthetic_model.iterdir():
            shutil.copy(f, ws / "sparse" / "0")
        rec = JC.read_model(ws / "sparse" / "0")
        for im in rec.images.values():
            im.name = im.name.replace(".png", ext)
            assert cv2.imwrite(str(ws / im.name), img, params)
        write_images_bin(ws / "sparse" / "0" / "images.bin",
                         [rec.images[i] for i in sorted(rec.images)])
        match = rf"img_1\{ext}.*{kind}"
        if kind == "BMP":
            with pytest.raises(NotImplementedError, match=match):
                PC.load_from_colmap_reconstruction(ws, device="cpu")
        else:
            sc = PC.load_from_colmap_reconstruction(ws, undistort=False,
                                                    device="cpu")
            with pytest.raises(NotImplementedError, match=match):
                load_images(sc, [0], device="cpu")


def test_without_a_colmap_binary_sfm_raises(tmp_path):
    if shutil.which("colmap") is not None:
        pytest.skip("a colmap binary is installed")
    with pytest.raises(RuntimeError, match="colmap binary not found"):
        PC.run_colmap_reconstruction(tmp_path, tmp_path / "ws")


# ---------------------------------------------------------- image module

RESIZES = [((37, 53), (23, 41)), ((23, 41), (37, 53)), ((17, 19), (31, 29)),
           ((45, 33), (20, 70)), ((30, 30), (24, 24)), ((24, 24), (30, 30)),
           ((40, 26), (20, 13)), ((5, 3), (1, 1))]


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_resize_u8_matches_opencv(channels):
    # odd sizes up and down, gray, RGB and RGBA, and the exact halving;
    # equal to cv2.resize's INTER_LINEAR bit for bit
    rng = np.random.RandomState(channels)
    for (h, w), (oh, ow) in RESIZES:
        shape = (h, w) if channels == 0 else (h, w, channels)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got = I.resize_linear_u8(torch.from_numpy(img), (oh, ow)).numpy()
        np.testing.assert_array_equal(got, cv2.resize(img, (ow, oh)),
                                      f"{(h, w)} -> {(oh, ow)}")


def test_resize_float_matches_opencv():
    rng = np.random.RandomState(5)
    for (h, w), (oh, ow) in RESIZES:
        img = rng.rand(h, w, 3).astype(np.float32)
        got = I.resize_linear(torch.from_numpy(img), (oh, ow)).numpy()
        assert np.abs(got - cv2.resize(img, (ow, oh))).max() <= 1e-6


@pytest.mark.parametrize("d", [(0.01, -0.002, 0.0, 0.0),
                               (-0.05, 0.02, 0.002, 0.001),
                               (0.1, 0.05, 0.01, -0.02, 0.01),
                               (0.1, 0.05, 0.01, -0.02, 0.01, 0.02, 0.01,
                                0.003)])
def test_camera_matrix_and_undistort_match_opencv(d):
    # 4, 5 and 8 coefficients; alpha 0 and 1; gray, RGB and RGBA images
    rng = np.random.RandomState(len(d))
    d = np.asarray(d, np.float64)
    for (w, h), c in (((64, 48), 3), ((37, 29), 0), ((50, 40), 4)):
        k = np.array([[1.1 * w, 0, w / 2 + 0.3], [0, 1.11 * w, h / 2 - 0.7],
                      [0, 0, 1]])
        for alpha in (0.0, 1.0):
            want, _ = cv2.getOptimalNewCameraMatrix(k, d, (w, h), alpha,
                                                    (w, h))
            got = I.optimal_new_camera_matrix(k, d, (w, h), alpha, "cpu")
            np.testing.assert_array_equal(got, want)
        img = rng.randint(0, 256, (h, w) if c == 0 else (h, w, c)).astype(
            np.uint8)
        out = I.undistort(torch.from_numpy(img), k, d, got).numpy()
        np.testing.assert_array_equal(out, cv2.undistort(img, k, d, None,
                                                         got))


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
