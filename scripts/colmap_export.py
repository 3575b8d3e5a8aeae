"""Write a synthetic scene as a COLMAP workspace: a capture with two
distorted cameras, its sparse model (.bin and a .txt copy) and its images,
in a format chosen for each view (PNG, JPEG, progressive
JPEG, TIFF, BMP, PPM, PAM, Sun raster, PFM or Radiance HDR, at 8 or 16 bits
or in float where the format has them).

The writer is support for the tests and for ``chip_smoke.py`` (which trains
the port on the workspace it writes); neither package has a COLMAP writer.
It imports torch, numpy and the port, never OpenCV or the JAX package.

    export_colmap_scene(scene, workspace, device=...)

takes a SceneData with poses on a sphere (data/synthetic.py's
``make_synthetic_scene``; attached images are not used) and writes:

- ``images/view_NNN.<ext>``, in ``image_format`` (one of ``FORMATS``, or
  a sequence of them cycled over the views): "png" and "png16" (8- and
  16-bit PNG), "jpg" (baseline JPEG as cv2.imwrite writes it at quality
  95), "pjpg" (progressive JPEG, ``.jpg``, as cv2.imwrite writes it with
  IMWRITE_JPEG_PROGRESSIVE), "tif" (8-bit LZW TIFF as cv2.imwrite writes
  it), "itif" and "ftif" (int16 and float32 TIFF), "bmp" (24-bit BMP),
  "ppm" and "ppm16" (binary PPM at 8 and 16 bits), "pam" (3-channel PAM),
  "ras" (24-bit Sun raster), "pfm" and "hdr" (float32 PFM and run-length
  RGBE), "webp" (lossless WebP, read back to the pixels of cv2.imwrite's
  own file), "jp2" (JPEG 2000 at OpenJPEG's rate 4, cv2.imwrite's bytes),
  "gif" (error-diffused onto the fixed 3-3-2 palette, cv2.imwrite's
  bytes), each as cv2.imwrite writes it; integer views are the render
  spread over their type's range and rounded, float views the render as
  it is. Encoded on the device where the format has device stages:
  every train view rendered from the scene's
  analytic field, distorted: each pixel's ray goes through the undistorted
  point of that pixel (OpenCV's model inverted to convergence), so the
  image is the pinhole render resampled through the distortion model.
  Every fourth view (3, 7, ...) is taken by a second camera at 1.25 times
  the size with the same field of view.
- ``sparse/0/{cameras,images,points3D}.bin`` and the same model as .txt:
  OPENCV cameras with the given coefficients; each image's w2c pose; about
  ``n_points`` surface points backprojected from the train views' rendered
  depths, each observed (its distorted pixel and a track entry) in every
  train view where it projects inside the image onto a surface whose
  rendered distance agrees within 2 %.

The scene's other splits stay out of the workspace. Returns an
``Export`` with what was written. The writers take the port's
ColmapCamera and ColmapImage (or objects with the same fields).
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import List

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.core.integrate import weights_from_alpha
from nerfpp_tpu_torch.data.colmap import (MODEL_NAME_TO_ID, ColmapCamera,
                                          ColmapImage, qvec_to_rotmat)
from nerfpp_tpu_torch.data.synthetic import scene_field
from nerfpp_tpu_torch.utils.image import write_image
from nerfpp_tpu_torch.utils.jpeg import write_jpeg

# small, non-zero OPENCV coefficients (k1, k2, p1, p2) of the two cameras
DISTORTION = ((-0.03, 0.01, 0.001, -0.0008), (0.02, -0.006, -0.0006, 0.0009))
SECOND_EVERY = 4                # every 4th view by the second camera
SECOND_SCALE = 1.25             # its size over the first camera's
DEPTH_TOL = 0.02                # an observation's distance test
RENDER_CHUNK = 16384
# image format -> (extension, stored dtype, progressive)
FORMATS = {"png": (".png", "uint8", False), "png16": (".png", "uint16", False),
           "jpg": (".jpg", "uint8", False), "pjpg": (".jpg", "uint8", True),
           "tif": (".tif", "uint8", False), "itif": (".tif", "int16", False),
           "ftif": (".tif", "float32", False),
           "bmp": (".bmp", "uint8", False), "ppm": (".ppm", "uint8", False),
           "ppm16": (".ppm", "uint16", False), "pam": (".pam", "uint8", False),
           "ras": (".ras", "uint8", False), "pfm": (".pfm", "float32", False),
           "hdr": (".hdr", "float32", False),
           "webp": (".webp", "uint8", False),
           "jp2": (".jp2", "uint8", False), "gif": (".gif", "uint8", False)}


@dataclasses.dataclass
class Points:
    ids: np.ndarray                # [m] int64
    xyz: np.ndarray                # [m, 3] float64
    rgb: np.ndarray                # [m, 3] uint8
    errors: np.ndarray             # [m] float64
    tracks: List[np.ndarray]       # per point [t, 2] int32 (image, point2d)


@dataclasses.dataclass
class Export:
    workspace: Path
    cameras: List[ColmapCamera]
    poses: np.ndarray              # [n, 4, 4] float32 c2w, as exported


# ------------------------------------------------------------------ writing

def write_cameras_bin(path, cameras) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras:
            f.write(struct.pack("<iiQQ", cam.camera_id,
                                MODEL_NAME_TO_ID[cam.model],
                                cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_bin(path, images) -> None:
    rec = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im.image_id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            obs = np.empty(len(im.point3d_ids), rec)
            obs["x"], obs["y"] = im.xys[:, 0], im.xys[:, 1]
            obs["id"] = im.point3d_ids
            f.write(struct.pack("<Q", len(obs)))
            f.write(obs.tobytes())


def write_points3d_bin(path, points: Points) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points.ids)))
        for i in range(len(points.ids)):
            f.write(struct.pack("<q", int(points.ids[i])))
            f.write(np.asarray(points.xyz[i], "<f8").tobytes())
            f.write(np.asarray(points.rgb[i], np.uint8).tobytes())
            f.write(struct.pack("<dQ", float(points.errors[i]),
                                len(points.tracks[i])))
            f.write(np.asarray(points.tracks[i], "<i4").tobytes())


def _num(values) -> str:
    # repr of a Python float is the shortest text that reads back exactly
    return " ".join(repr(float(v)) for v in values)


def write_model_txt(sparse_dir, cameras, images, points: Points) -> None:
    sparse_dir = Path(sparse_dir)
    lines = ["# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]"]
    lines += [f"{c.camera_id} {c.model} {c.width} {c.height} "
              f"{_num(c.params)}" for c in cameras]
    (sparse_dir / "cameras.txt").write_text("\n".join(lines) + "\n")
    lines = ["# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
             "# POINTS2D[] as (X, Y, POINT3D_ID)"]
    for im in images:
        lines.append(f"{im.image_id} {_num(im.qvec)} {_num(im.tvec)} "
                     f"{im.camera_id} {im.name}")
        lines.append(" ".join(f"{float(x)!r} {float(y)!r} {int(p)}"
                              for (x, y), p in zip(im.xys, im.point3d_ids)))
    (sparse_dir / "images.txt").write_text("\n".join(lines) + "\n")
    lines = ["# POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
             "TRACK[] as (IMAGE_ID, POINT2D_IDX)"]
    for i in range(len(points.ids)):
        r, g, b = (int(v) for v in points.rgb[i])
        track = " ".join(f"{int(a)} {int(c)}" for a, c in points.tracks[i])
        lines.append(f"{int(points.ids[i])} {_num(points.xyz[i])} {r} {g} {b} "
                     f"{float(points.errors[i])!r} {track}")
    (sparse_dir / "points3D.txt").write_text("\n".join(lines) + "\n")


def write_model(sparse_dir, cameras, images, points: Points) -> None:
    """The sparse model as .bin and as .txt."""
    sparse_dir = Path(sparse_dir)
    sparse_dir.mkdir(parents=True, exist_ok=True)
    write_cameras_bin(sparse_dir / "cameras.bin", cameras)
    write_images_bin(sparse_dir / "images.bin", images)
    write_points3d_bin(sparse_dir / "points3D.bin", points)
    write_model_txt(sparse_dir, cameras, images, points)


# ----------------------------------------------------------------- geometry

def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) unit quaternion, w >= 0."""
    tr = np.trace(r)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
        q = [0.0] * 4
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    q = np.asarray(q, np.float64)
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def c2w_to_colmap(pose: np.ndarray):
    """OpenGL c2w [4, 4] -> COLMAP w2c (qvec, tvec) in float64."""
    c2w = np.asarray(pose, np.float64).copy()
    c2w[:3, 1:3] *= -1.0                      # OpenGL -> OpenCV camera axes
    r = c2w[:3, :3].T
    return rotmat_to_qvec(r), -r @ c2w[:3, 3]


def distort(x, y, d):
    """OpenCV's model (k1, k2, p1, p2) on normalised coords."""
    k1, k2, p1, p2 = d
    r2 = x * x + y * y
    radial = 1 + (k1 + k2 * r2) * r2
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def undistort(xd, yd, d, iters: int = 30):
    """The inverse of ``distort`` by fixed-point iteration (float64)."""
    k1, k2, p1, p2 = d
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + (k1 + k2 * r2) * r2
        x = (xd - 2 * p1 * x * y - p2 * (r2 + 2 * x * x)) / radial
        y = (yd - p1 * (r2 + 2 * y * y) - 2 * p2 * x * y) / radial
    return x, y


# ---------------------------------------------------------------- rendering

def render_rgb_depth(rays_o, rays_d, near: float, far: float,
                     n_samples: int):
    """The scene field composited along rays (render_gt_rays' arithmetic,
    black background): rgb [N, 3], the expected ray parameter t [N] and the
    opacity [N]."""
    t = torch.linspace(near, far, n_samples, dtype=torch.float32,
                       device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    sigma, rgb = scene_field(pts)
    dists = torch.diff(t, append=(t[-1] + (far - near) / n_samples)[None])
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    w = weights_from_alpha(1.0 - torch.exp(-sigma * dists))
    acc = torch.sum(w, dim=-1)
    depth = torch.sum(w * t, dim=-1) / torch.clamp(acc, min=1e-10)
    return torch.sum(w[..., None] * rgb, dim=-2), depth, acc


def view_rays(cam: ColmapCamera, pose: np.ndarray, dev):
    """Rays through every pixel of a distorted camera: origins, directions
    [h * w, 3] (float32, the camera frame's z = -1 plane)."""
    fx, fy, cx, cy = (float(v) for v in cam.params[:4])
    d = tuple(float(v) for v in cam.params[4:8])
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float64, device=dev),
        torch.arange(cam.width, dtype=torch.float64, device=dev),
        indexing="ij")
    x, y = undistort((u - cx) / fx, (v - cy) / fy, d)
    dirs = torch.stack([x, -y, -torch.ones_like(x)], -1).reshape(-1, 3)
    c2w = torch.as_tensor(np.asarray(pose, np.float64), device=dev)
    rays_d = (dirs @ c2w[:3, :3].T).float()
    return c2w[:3, 3].float().expand(rays_d.shape), rays_d


# ------------------------------------------------------------------- export

def write_view(path_stem: Path, rgb: torch.Tensor, fmt: str, dev) -> Path:
    """Write a float [h, w, 3] image in [0, 1] as ``fmt`` (FORMATS) at
    ``path_stem`` + the format's extension: spread over the stored integer
    type's range and rounded (x 255, x 65535, or x 65535 - 32768 for
    int16), or float32 as it is."""
    ext, dtype, progressive = FORMATS[fmt]
    path = path_stem.with_suffix(ext)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    if dtype == "float32":
        write_image(path, rgb.float(), dev)
        return path
    info = torch.iinfo(getattr(torch, dtype))
    img = (rgb * (info.max - info.min) + info.min).round().to(torch.int32)
    img = img.to(getattr(torch, dtype))
    if progressive:
        write_jpeg(path, img, device=dev, progressive=True)
    else:
        write_image(path, img, dev)
    return path


def export_colmap_scene(scene, workspace, device="cuda", n_samples: int = 64,
                        n_points: int = 50_000, log=None,
                        image_format="png") -> Export:
    """Write the scene's train views as a COLMAP workspace (see the module
    docstring), rendered at ``n_samples`` a ray, with about ``n_points``
    points drawn from numpy seed 0, the images as ``image_format`` (a key
    of FORMATS, or a sequence of them cycled over the views: view j takes
    ``image_format[j % len(image_format)]``); ``log`` takes a summary
    line."""
    formats = ((image_format,) if isinstance(image_format, str)
               else tuple(image_format))
    if not formats or any(f not in FORMATS for f in formats):
        raise ValueError(f"image_format {image_format!r}: one of "
                         f"{sorted(FORMATS)} or a sequence of them")
    dev = resolve_device(device)
    workspace = Path(workspace)
    (workspace / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    idx = list(scene.split_indices("train"))
    v0 = scene.views[idx[0]]
    size2 = int(round(v0.w * SECOND_SCALE)), int(round(v0.h * SECOND_SCALE))
    cameras = []
    for cid, (w, h), d in ((1, (v0.w, v0.h), DISTORTION[0]),
                           (2, size2, DISTORTION[1])):
        s = w / v0.w
        cameras.append(ColmapCamera(cid, "OPENCV", w, h, np.array(
            [float(v0.k[0, 0]) * s, float(v0.k[1, 1]) * s, 0.5 * w, 0.5 * h,
             *d], np.float64)))
    near, far = float(v0.near), float(v0.far)
    maps, images, poses = [], [], []
    with torch.no_grad():
        for j, vi in enumerate(idx):
            second = int(j % SECOND_EVERY == SECOND_EVERY - 1)
            cam = cameras[second]
            pose = np.asarray(scene.views[vi].pose, np.float32)
            ro, rd = view_rays(cam, pose, dev)
            parts = [render_rgb_depth(ro[c:c + RENDER_CHUNK],
                                      rd[c:c + RENDER_CHUNK], near, far,
                                      n_samples)
                     for c in range(0, ro.shape[0], RENDER_CHUNK)]
            rgb, t, acc = (torch.cat(x) for x in zip(*parts))
            dist = t * torch.linalg.norm(rd, dim=-1)
            rgb8 = (torch.clamp(rgb, 0.0, 1.0) * 255.0).round().to(torch.uint8)
            name = write_view(workspace / "images" / f"view_{j:03d}",
                              rgb.reshape(cam.height, cam.width, 3),
                              formats[j % len(formats)], dev).name
            maps.append((cam, rd.cpu().numpy(), dist.cpu().numpy(),
                         acc.cpu().numpy(), rgb8.cpu().numpy()))
            qvec, tvec = c2w_to_colmap(pose)
            images.append(ColmapImage(j + 1, qvec, tvec, cam.camera_id,
                                      name, np.zeros((0, 2)),
                                      np.zeros(0, np.int64)))
            poses.append(pose)

    # surface points: opaque pixels of every view, backprojected
    per_view = -(-n_points // len(idx))
    xyz, rgb = [], []
    for j, (cam, rd, dist, acc, rgb8) in enumerate(maps):
        opaque = np.nonzero(acc > 0.99)[0]
        pick = rng.choice(opaque, min(per_view, opaque.size), replace=False)
        dirs = rd[pick] / np.linalg.norm(rd[pick], axis=-1, keepdims=True)
        xyz.append(poses[j][:3, 3].astype(np.float64)
                   + dirs.astype(np.float64) * dist[pick, None])
        rgb.append(rgb8[pick])
    xyz, rgb = np.concatenate(xyz), np.concatenate(rgb)
    ids = np.arange(1, len(xyz) + 1, dtype=np.int64)

    # observations: in the image, in front, on the rendered surface
    tracks = [[] for _ in ids]
    for j, (cam, rd, dist, acc, _) in enumerate(maps):
        im = images[j]
        r = qvec_to_rotmat(im.qvec)
        pc = xyz @ r.T + im.tvec                  # OpenCV camera frame
        zs = pc[:, 2]
        front = zs > 1e-6
        xd, yd = distort(pc[:, 0] / np.where(front, zs, 1.0),
                         pc[:, 1] / np.where(front, zs, 1.0),
                         cam.params[4:8])
        u = cam.params[0] * xd + cam.params[2]
        v = cam.params[1] * yd + cam.params[3]
        ui, vi = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
        ok = front & (ui >= 0) & (ui < cam.width) & (vi >= 0) & (
            vi < cam.height)
        pix = np.where(ok, vi * cam.width + ui, 0)
        rng_dist = np.linalg.norm(pc, axis=-1)
        ok &= (acc[pix] > 0.99) & (np.abs(dist[pix] - rng_dist)
                                   < DEPTH_TOL * rng_dist)
        sel = np.nonzero(ok)[0]
        im.xys = np.stack([u[sel], v[sel]], -1)
        im.point3d_ids = ids[sel]
        for k, p in enumerate(sel):
            tracks[p].append((im.image_id, k))
    points = Points(ids, xyz, rgb, np.full(len(ids), 0.5),
                    [np.asarray(t, np.int32).reshape(-1, 2) for t in tracks])
    write_model(workspace / "sparse" / "0", cameras, images, points)
    if log is not None:
        n_obs = sum(len(im.point3d_ids) for im in images)
        log(f"COLMAP workspace: {len(images)} images ({len(maps)} train views;"
            f" cameras {[(c.width, c.height) for c in cameras]}), "
            f"{len(ids)} points, {n_obs} observations "
            f"({n_obs / len(ids):.2f} a point)")
    return Export(workspace, cameras, np.stack(poses))
