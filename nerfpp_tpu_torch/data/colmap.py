"""COLMAP reconstruction loading (port of nerfpp_tpu/data/colmap.py):
sparse-model parsing, pose conversion, per-image near/far, scene bbox,
undistortion, and the optional SfM shell-out.

- The sparse model (cameras, images, points3D; .bin or .txt) is read
  directly, .bin first and through the native parser first
  (nerfpp_tpu_torch/native.py), with the Python readers behind it.
- ``colmap_w2c_to_nerf_c2w``: invert the world-to-camera transform, then
  flip the y and z columns (OpenCV -> OpenGL).
- ``compute_near_far_for_image``: the 1 % / 99 % entries of the sorted
  distances to the image's visible points, from the camera centre (or with
  ``reference_quirk`` from the w2c translation vector, as the reference
  measures them).
- ``compute_bounding_box``: per-axis 0.5 % / 99.5 % quantiles of all points
  (numpy's default method) with a margin of 1 % of the diagonal.
- ``undistort_images``: OPENCV-model undistortion of every distorted view
  into ``workspace/undistorted/`` with utils/image.py (OpenCV's
  getOptimalNewCameraMatrix at alpha 0 and undistort, in PyTorch on the
  given device), written under the source's own name and format as
  cv2.imwrite writes it: a .png as PNG and a .tif / .tiff as LZW TIFF, both
  in the source's depth (8 or 16 bits), a .jpg (baseline or progressive)
  re-encoded as baseline JPEG at quality 95, 4:2:0 (utils/jpeg.py, byte for
  byte OpenCV's).
- ``run_colmap_reconstruction``: a ``colmap automatic_reconstructor`` run,
  when the binary is installed.

Images are what utils/image.py ``read_image`` reads, as cv2.imread reads
them: PNG of every colour type and depth, baseline and progressive JPEG,
and TIFF (8 or 16 bits, LZW, Deflate, PackBits or none). A view in another
format (BMP, WebP, JPEG 2000, AVIF, arithmetic-coded, 12-bit or CMYK JPEG,
float or JPEG-compressed TIFF, ...) raises NotImplementedError naming the
file and the kind when it is read.
"""
from __future__ import annotations

import shutil
import struct
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from nerfpp_tpu_torch import native, resolve_device
from nerfpp_tpu_torch.data.dataset import SceneData, View
from nerfpp_tpu_torch.utils.image import (optimal_new_camera_matrix,
                                          read_image, undistort, write_image)

# model_id -> (name, num_params); params ordered as COLMAP documents them
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),   # fx, fy, cx, cy, k1, k2, k3, k4
    6: ("FULL_OPENCV", 12),     # fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
# models whose params start with one focal length f
_ONE_FOCAL = ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
              "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV")


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[0] if self.model in _ONE_FOCAL else self.params[1]

    @property
    def cx(self):
        return self.params[1] if self.model in _ONE_FOCAL else self.params[2]

    @property
    def cy(self):
        return self.params[2] if self.model in _ONE_FOCAL else self.params[3]

    def k_matrix(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                         [0, 0, 1]], np.float32)

    def distortion(self) -> Optional[np.ndarray]:
        """OpenCV-order distortion coefficients (k1 k2 p1 p2 [k3 ...]) or
        None."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            return None
        if self.model == "SIMPLE_RADIAL":
            return np.array([p[3], 0, 0, 0], np.float32)
        if self.model == "RADIAL":
            return np.array([p[3], p[4], 0, 0], np.float32)
        if self.model == "OPENCV":
            return np.array([p[4], p[5], p[6], p[7]], np.float32)
        if self.model == "FULL_OPENCV":
            return np.array([p[4], p[5], p[6], p[7], p[8], p[9], p[10],
                             p[11]], np.float32)
        raise NotImplementedError(f"distortion for model {self.model}")


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray               # w, x, y, z (w2c rotation)
    tvec: np.ndarray               # w2c translation
    camera_id: int
    name: str
    xys: np.ndarray                # [n, 2]
    point3d_ids: np.ndarray        # [n] int64, -1 where none


@dataclass
class ColmapReconstruction:
    cameras: Dict[int, ColmapCamera]
    images: Dict[int, ColmapImage]
    points_xyz: np.ndarray         # [m, 3]
    points_ids: np.ndarray         # [m] int64


# ------------------------------------------------------------- bin parsing

def _read_cameras_bin(path: Path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model_id = struct.unpack("<ii", f.read(8))
            w, h = struct.unpack("<QQ", f.read(16))
            name, nparams = CAMERA_MODELS[model_id]
            params = np.frombuffer(f.read(8 * nparams), "<f8").copy()
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def _read_images_bin(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.frombuffer(f.read(32), "<f8").copy()
            tvec = np.frombuffer(f.read(24), "<f8").copy()
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            npts = struct.unpack("<Q", f.read(8))[0]
            data = np.frombuffer(f.read(24 * npts), "<f8").reshape(npts, 3)
            xys = data[:, :2].astype(np.float64)
            p3d = data[:, 2].view("<i8").copy()
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, p3d)
    return images


def _read_points3d_bin(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    ids, xyz = [], []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            pid = struct.unpack("<q", f.read(8))[0]
            p = np.frombuffer(f.read(24), "<f8")
            f.read(3)         # rgb
            f.read(8)         # error
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
            ids.append(pid)
            xyz.append(p.copy())
    return (np.asarray(xyz, np.float64).reshape(-1, 3),
            np.asarray(ids, np.int64))


# ------------------------------------------------------------- txt parsing

def _read_cameras_txt(path: Path) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid, model = int(parts[0]), parts[1]
        w, h = int(parts[2]), int(parts[3])
        params = np.asarray([float(x) for x in parts[4:]], np.float64)
        cams[cid] = ColmapCamera(cid, model, w, h, params)
    return cams


def _read_images_txt(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    lines = [ln for ln in Path(path).read_text().splitlines()
             if ln and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.asarray([float(x) for x in parts[1:5]])
        tvec = np.asarray([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        trip = (np.asarray([float(x) for x in pts]).reshape(-1, 3)
                if pts else np.zeros((0, 3)))
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                                  trip[:, :2], trip[:, 2].astype(np.int64))
    return images


def _read_points3d_txt(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    ids, xyz = [], []
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        ids.append(int(parts[0]))
        xyz.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return (np.asarray(xyz, np.float64).reshape(-1, 3),
            np.asarray(ids, np.int64))


def _read_model_native(sparse_dir: Path) -> Optional[ColmapReconstruction]:
    """The .bin model through the native parser, or None without it."""
    c = native.read_cameras_bin(sparse_dir / "cameras.bin")
    if c is None:
        return None
    im = native.read_images_bin(sparse_dir / "images.bin")
    pts = native.read_points3d_bin(sparse_dir / "points3D.bin")
    if im is None or pts is None:
        return None
    cams = {}
    for i in range(len(c["ids"])):
        name, _ = CAMERA_MODELS[int(c["model_ids"][i])]
        cams[int(c["ids"][i])] = ColmapCamera(
            int(c["ids"][i]), name, int(c["widths"][i]), int(c["heights"][i]),
            c["params"][i][:int(c["n_params"][i])].copy())
    images = {}
    offs = im["pt_offsets"]
    for i in range(len(im["image_ids"])):
        lo, hi = int(offs[i]), int(offs[i + 1])
        images[int(im["image_ids"][i])] = ColmapImage(
            int(im["image_ids"][i]), im["qvecs"][i].copy(),
            im["tvecs"][i].copy(), int(im["camera_ids"][i]), im["names"][i],
            im["xys"][lo:hi].copy(), im["point3d_ids"][lo:hi].copy())
    return ColmapReconstruction(cams, images, pts["xyz"], pts["ids"])


def read_model(sparse_dir) -> ColmapReconstruction:
    """A COLMAP sparse model directory: .bin first (the native parser where
    it builds, else the Python readers), else .txt."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        rec = _read_model_native(sparse_dir)
        if rec is not None:
            return rec
        cams = _read_cameras_bin(sparse_dir / "cameras.bin")
        images = _read_images_bin(sparse_dir / "images.bin")
        xyz, pids = _read_points3d_bin(sparse_dir / "points3D.bin")
    elif (sparse_dir / "cameras.txt").exists():
        cams = _read_cameras_txt(sparse_dir / "cameras.txt")
        images = _read_images_txt(sparse_dir / "images.txt")
        xyz, pids = _read_points3d_txt(sparse_dir / "points3D.txt")
    else:
        raise FileNotFoundError(f"no COLMAP model in {sparse_dir}")
    return ColmapReconstruction(cams, images, xyz, pids)


# ---------------------------------------------------------------- geometry

def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = qvec / np.linalg.norm(qvec)
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


def colmap_w2c_to_nerf_c2w(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """Invert the w2c transform and flip the y and z columns (OpenCV ->
    OpenGL): a float32 [4, 4] c2w pose."""
    r = qvec_to_rotmat(qvec)
    r_inv = r.T
    t_inv = -r_inv @ tvec
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = r_inv
    pose[:3, 3] = t_inv
    pose[:3, 1:3] *= -1.0
    return pose


def compute_near_far_for_image(image: ColmapImage,
                               rec: ColmapReconstruction,
                               near_percentile: float = 0.01,
                               far_percentile: float = 0.99,
                               reference_quirk: bool = False,
                               id_to_row: Optional[dict] = None
                               ) -> Tuple[float, float]:
    """The near_percentile and far_percentile entries of the image's sorted
    distances (f32) to its visible points; (0, 0) without any.

    ``reference_quirk`` measures from the w2c translation vector, as the
    reference does, instead of the camera centre. ``id_to_row``: a
    {point3d_id: row} index built once for all images of a model."""
    valid = image.point3d_ids >= 0
    if not valid.any():
        return 0.0, 0.0
    if id_to_row is None:
        id_to_row = {pid: i for i, pid in enumerate(rec.points_ids)}
    rows = [id_to_row[pid] for pid in image.point3d_ids[valid]
            if pid in id_to_row]
    if not rows:
        return 0.0, 0.0
    pts = rec.points_xyz[rows]
    if reference_quirk:
        origin = image.tvec
    else:
        r = qvec_to_rotmat(image.qvec)
        origin = -r.T @ image.tvec
    d = np.sort(np.linalg.norm(pts - origin, axis=-1).astype(np.float32))
    near_idx = min(int(near_percentile * len(d)), len(d) - 1)
    far_idx = min(int(far_percentile * len(d)), len(d) - 1)
    return float(d[near_idx]), float(d[far_idx])


def compute_bounding_box(rec: ColmapReconstruction,
                         lo: float = 0.005, hi: float = 0.995) -> np.ndarray:
    """Per-axis quantile box of all points plus 1 % of its diagonal on each
    side, float32 [6]."""
    mn = np.quantile(rec.points_xyz, lo, axis=0)
    mx = np.quantile(rec.points_xyz, hi, axis=0)
    d = np.linalg.norm(mx - mn)
    return np.concatenate([mn - 0.01 * d, mx + 0.01 * d]).astype(np.float32)


def undistort_images(scene: SceneData, out_dir, device="cuda") -> SceneData:
    """Undistort every view with non-zero distortion into out_dir on
    ``device`` (new K by getOptimalNewCameraMatrix at alpha 0, then
    undistort), written under the source's name in its format, pointing
    the views at the new files with their new K and no distortion."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for v in scene.views:
        if v.d is None or not np.any(v.d):
            continue
        k = v.k.astype(np.float64)
        d = v.d.astype(np.float64)
        new_k = optimal_new_camera_matrix(k, d, (v.w, v.h), 0.0, dev)
        und = undistort(read_image(v.image_path, dev), k, d, new_k)
        out_path = out_dir / Path(v.image_path).name
        write_image(out_path, und, dev)
        v.image_path = str(out_path)
        v.k = new_k.astype(np.float32)
        v.d = None
    return scene


def load_from_colmap_reconstruction(workspace, image_path: Optional[str] = None,
                                    undistort: bool = True,
                                    device="cuda") -> SceneData:
    """A COLMAP workspace (sparse/0, else sparse, else the workspace itself;
    images under images/, else the workspace) as a SceneData: one view per
    image in image-id order, all in the train split, with the camera's K and
    distortion, the converted pose, near/far from the image's points, and
    the points' box. With ``undistort`` distorted views are undistorted on
    ``device`` into workspace/undistorted."""
    workspace = Path(workspace)
    sparse = workspace / "sparse" / "0"
    if not sparse.exists():
        sparse = workspace / "sparse"
    if not sparse.exists():
        sparse = workspace
    rec = read_model(sparse)

    if image_path is None:
        for cand in [workspace / "images", workspace]:
            if cand.exists():
                image_path = cand
                break
    image_path = Path(image_path)

    scene = SceneData()
    needs_undistort = False
    id_to_row = {pid: i for i, pid in enumerate(rec.points_ids)}
    for iid in sorted(rec.images.keys()):
        im = rec.images[iid]
        cam = rec.cameras[im.camera_id]
        near, far = compute_near_far_for_image(im, rec, id_to_row=id_to_row)
        dist = cam.distortion()
        if dist is not None and np.any(dist):
            needs_undistort = True
        scene.views.append(View(
            id=im.image_id, h=cam.height, w=cam.width,
            focal=float(np.sqrt(cam.fx * cam.fy)),
            near=near, far=far, k=cam.k_matrix(),
            pose=colmap_w2c_to_nerf_c2w(im.qvec, im.tvec),
            d=dist, image_path=str(image_path / im.name)))
        scene.splits_idx[0] += 1

    scene.bounding_box = compute_bounding_box(rec)
    if undistort and needs_undistort:
        undistort_images(scene, workspace / "undistorted", device)
    return scene


def run_colmap_reconstruction(image_path, workspace_path,
                              quality: str = "high") -> None:
    """Full SfM through an installed ``colmap`` binary (SIFT extraction,
    matching and sparse mapping; OPENCV camera model, one camera)."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "colmap binary not found; install COLMAP or provide an existing "
            "sparse reconstruction")
    workspace_path = Path(workspace_path)
    workspace_path.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["colmap", "automatic_reconstructor",
         "--workspace_path", str(workspace_path),
         "--image_path", str(image_path),
         "--camera_model", "OPENCV",
         "--single_camera", "1",
         "--quality", quality,
         "--use_gpu", "0"],
        check=True)
