"""Blender-synthetic dataset loader and writer (port of
nerfpp_tpu/data/blender.py): transforms_{train,val,test}.json with a 4x4
c2w pose per frame and the focal from camera_angle_x; half_res halves H, W
and the focal; testskip drops the test split; near/far from the spread of
the train cameras (0.15 d, 0.6 d) and the scene box from the 4 corner rays
of every train view at near and far. Images are referenced by path and
decoded when the sampler loads them (data/dataset.py load_images: any
PNG, 8- or 16-bit, as the JAX package's cv2.imread reads it); their size
is read from the first PNG header of each split.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from nerfpp_tpu_torch.core import rays as ray_math
from nerfpp_tpu_torch.data.dataset import SceneData, View
from nerfpp_tpu_torch.utils.png import png_shape, write_png


def get_bounds_for_obj(scene: SceneData) -> tuple:
    """(near, far) = (0.15 d, 0.6 d), d the diagonal of the box around the
    train cameras' positions."""
    mn = np.full(3, 1e8, np.float32)
    mx = np.full(3, -1e8, np.float32)
    for i in scene.split_indices("train"):
        o = scene.views[i].pose[:3, 3]
        mn = np.minimum(mn, o)
        mx = np.maximum(mx, o)
    d = float(np.linalg.norm(mx - mn))
    return 0.15 * d, 0.6 * d


def get_bbox3d_for_obj(scene: SceneData) -> np.ndarray:
    """Scene box spanned by the 4 corner rays of each train view at near
    and far (f32 rays, on the CPU)."""
    mn = np.full(3, 1e8, np.float32)
    mx = np.full(3, -1e8, np.float32)
    for i in scene.split_indices("train"):
        v = scene.views[i]
        rays_o, rays_d, _ = ray_math.get_rays(
            v.h, v.w, torch.as_tensor(np.asarray(v.k, np.float32)),
            torch.as_tensor(np.asarray(v.pose, np.float32)))
        rays_o, rays_d = rays_o.numpy(), rays_d.numpy()
        for (x, y) in [(0, 0), (v.w - 1, 0), (0, v.h - 1), (v.w - 1, v.h - 1)]:
            p_near = rays_o[y, x] + v.near * rays_d[y, x]
            p_far = rays_o[y, x] + v.far * rays_d[y, x]
            mn = np.minimum(mn, np.minimum(p_near, p_far))
            mx = np.maximum(mx, np.maximum(p_near, p_far))
    return np.concatenate([mn, mx]).astype(np.float32)


def export_blender_scene(scene: SceneData, basedir) -> Path:
    """Write a scene with attached images as a Blender-synthetic tree: per
    split ``transforms_{split}.json`` (camera_angle_x, 4x4
    transform_matrix frames) and 8-bit PNGs under ``./{split}/`` (RGBA
    where the images carry alpha). The format has one camera_angle_x per
    split, so a split that mixes intrinsics is refused."""
    basedir = Path(basedir)
    for split in scene.splits:
        idx = list(scene.split_indices(split))
        if not idx:
            continue
        v0 = scene.views[idx[0]]
        for i in idx:
            v = scene.views[i]
            if (v.h, v.w) != (v0.h, v0.w) or not np.isclose(
                    float(v.k[0, 0]), float(v0.k[0, 0])):
                raise ValueError(
                    f"export_blender_scene: split '{split}' mixes "
                    f"intrinsics (view {v.id} vs {v0.id}); the "
                    "transforms_*.json format shares one camera_angle_x")
        (basedir / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for j, i in enumerate(idx):
            v = scene.views[i]
            rel = f"./{split}/r_{j}"
            img = np.clip(np.asarray(scene.images[v.id]), 0.0, 1.0)
            write_png(basedir / f"{rel}.png",
                      np.round(img * 255.0).astype(np.uint8))
            frames.append({
                "file_path": rel,
                "transform_matrix":
                    np.asarray(v.pose, np.float64).reshape(4, 4).tolist(),
            })
        camera_angle_x = 2.0 * float(np.arctan(0.5 * v0.w / v0.k[0, 0]))
        (basedir / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": camera_angle_x, "frames": frames}, indent=1))
    return basedir


def load_blender_data(basedir, near: float = 0.0, far: float = 0.0,
                      half_res: bool = False, testskip: bool = True,
                      white_bkgr: bool = False) -> SceneData:
    """Parse transforms_{train,val,test}.json into a SceneData. Each split's
    image size is read from its first frame's PNG header; every frame must
    exist. ``white_bkgr`` is recorded on the scene: RGBA frames are then
    composited onto white when loaded."""
    basedir = Path(basedir)
    scene = SceneData(white_bkgr=white_bkgr)
    for i_split, split in enumerate(scene.splits):
        if testskip and split == "test":
            continue
        path = basedir / f"transforms_{split}.json"
        if not path.exists():
            continue
        data = json.loads(path.read_text())
        camera_angle_x = float(data["camera_angle_x"])
        split_hw = None
        for frame in data["frames"]:
            img_path = basedir / (frame["file_path"] + ".png")
            if not img_path.exists():
                raise FileNotFoundError(img_path)
            if split_hw is None:
                split_hw = png_shape(img_path)[:2]
            h, w = split_hw
            focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
            if half_res:
                h, w, focal = h // 2, w // 2, focal / 2
            pose = np.asarray(frame["transform_matrix"],
                              np.float32).reshape(4, 4)
            scene.views.append(View(
                id=len(scene.views), h=h, w=w, focal=float(focal),
                near=0.0, far=0.0,
                k=ray_math.calibration_matrix(focal, w, h),
                pose=pose, image_path=str(img_path)))
            scene.splits_idx[i_split] += 1
    if near == 0.0 or far == 0.0:
        near, far = get_bounds_for_obj(scene)
    for v in scene.views:
        v.near, v.far = near, far
    scene.bounding_box = get_bbox3d_for_obj(scene)
    return scene
