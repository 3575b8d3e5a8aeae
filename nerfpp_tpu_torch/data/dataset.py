"""Scene description and the on-device ray-batch sampler (port of
nerfpp_tpu/data/dataset.py).

``View`` and ``SceneData`` read and write the JAX package's JSON (the same
keys), so a scene saved by one package loads in the other. The sampler keeps
the training images on the device and draws each step's rays there: step i
trains on train view i % n_train, in random 8x16 pixel tiles (or single
pixels), from the centre crop while step < precrop_iters. For LeRF it draws
each ray's supervision embedding at the same pixel, from the CLIP pyramid's
grids on the device (``DevicePyramid``) or from a dense stack.

Images attached to the scene (``SceneData.images``, as the synthetic scene
has them) are float; image files (PNG, JPEG, TIFF) are decoded by
utils/image.py ``read_image``. An image of another size than asked for (the
Blender loader's half_res, COLMAP's captures with one size per camera) is
resized as the JAX package resizes it with OpenCV's INTER_LINEAR: a file in
its stored depth (8-bit fixed point, or the 16-bit path), an attached image
in float (utils/image.py), on the device given.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.core import rays as ray_math
from nerfpp_tpu_torch.core.sampling import draw
from nerfpp_tpu_torch.utils.image import (read_image, resize_linear,
                                          resize_stored)


@dataclasses.dataclass
class View:
    """One camera view."""
    id: int
    h: int
    w: int
    focal: float
    near: float
    far: float
    k: np.ndarray                  # [3, 3]
    pose: np.ndarray               # [4, 4] c2w
    d: Optional[np.ndarray] = None  # distortion coefficients, or None
    image_path: str = ""

    def to_json(self) -> dict:
        return {
            "ID": self.id, "H": self.h, "W": self.w, "Focal": self.focal,
            "Near": self.near, "Far": self.far,
            "K": np.asarray(self.k).reshape(-1).tolist(),
            "Pose": np.asarray(self.pose).reshape(-1).tolist(),
            "D": (np.asarray(self.d).reshape(-1).tolist()
                  if self.d is not None else []),
            "ImagePath": str(self.image_path),
        }

    @classmethod
    def from_json(cls, j: dict) -> "View":
        d = np.asarray(j.get("D", []), np.float32)
        return cls(
            id=int(j["ID"]), h=int(j["H"]), w=int(j["W"]),
            focal=float(j["Focal"]), near=float(j["Near"]),
            far=float(j["Far"]),
            k=np.asarray(j["K"], np.float32).reshape(3, 3),
            pose=np.asarray(j["Pose"], np.float32).reshape(4, 4),
            d=d if d.size else None, image_path=j.get("ImagePath", ""))


@dataclasses.dataclass
class SceneData:
    """Scene-level parameters: views, split sizes, bbox, background."""
    views: List[View] = dataclasses.field(default_factory=list)
    splits_idx: List[int] = dataclasses.field(
        default_factory=lambda: [0, 0, 0])
    splits: List[str] = dataclasses.field(
        default_factory=lambda: ["train", "val", "test"])
    bounding_box: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-1, -1, -1, 1, 1, 1], np.float32))
    white_bkgr: bool = False
    images: Optional[np.ndarray] = None   # [n_views, H, W, 3] f32 in [0, 1]

    @property
    def n_train(self) -> int:
        return self.splits_idx[0]

    def split_indices(self, split: str) -> range:
        i = self.splits.index(split)
        start = sum(self.splits_idx[:i])
        return range(start, start + self.splits_idx[i])

    def to_json(self) -> dict:
        return {
            "WhiteBgr": self.white_bkgr,
            "SplitsIdx": list(self.splits_idx),
            "Splits": list(self.splits),
            "BoundingBox": np.asarray(self.bounding_box).reshape(-1).tolist(),
            "Views": [v.to_json() for v in self.views],
        }

    @classmethod
    def from_json(cls, j: dict) -> "SceneData":
        return cls(views=[View.from_json(v) for v in j["Views"]],
                   splits_idx=list(j["SplitsIdx"]), splits=list(j["Splits"]),
                   bounding_box=np.asarray(j["BoundingBox"], np.float32),
                   white_bkgr=bool(j["WhiteBgr"]))

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_json()))

    @classmethod
    def load(cls, path) -> "SceneData":
        return cls.from_json(json.loads(Path(path).read_text()))


def load_images(scene: SceneData, indices, white_bkgr: Optional[bool] = None,
                target_hw: Optional[tuple] = None,
                device="cuda") -> np.ndarray:
    """Decode view images into one [n, H, W, 3] f32 stack, as
    nerfpp_tpu/data/dataset.py ``load_images`` does. The files are what
    utils/image.py ``read_image`` reads on ``device``: PNG of any colour
    type and depth, JPEG (baseline, progressive, arithmetic-coded and
    lossless; gray, YCbCr, RGB, CMYK and YCCK), TIFF (integer samples to
    64 bits or float, CMYK, YCbCr, CIE L*a*b*, JPEG- or CCITT
    fax-compressed, BigTIFF), BMP, PBM / PGM / PPM / PAM / PFM, Radiance
    HDR, Sun raster, WebP (lossy, lossless, with
    alpha or animated), GIF (the first frame; 4 channels with
    transparency) and JPEG 2000 (JP2 or raw codestreams, 8 or 16
    bits); a file cv2.imread returns no image for (a 12-bit or
    hierarchical JPEG, a GIF cut short, ...) raises ValueError naming the
    file, and other formats (AVIF, ...) raise NotImplementedError naming
    it.
    Each image is resized in its stored type (uint8, uint16, int16,
    float32 or float64, as cv2.resize; int8, int32, uint32, int64 and
    uint64 raise when a resize is needed), then cast to f32 and divided by 255, whatever its
    type: a 16-bit file's values reach 65535 / 255 = 257, and a float
    file's (PFM, HDR, float TIFF) radiance or depth values come out divided
    by 255, as the JAX package's do (the reference's behaviour, mirrored;
    ROADMAP.md). RGBA images lose their alpha, or with ``white_bkgr``
    (default: the scene's) are composited onto white, on those values;
    gray images are repeated to 3 channels. Each image takes its view's
    (h, w), or ``target_hw``: an image of another size is resized on
    ``device`` (alpha included, as OpenCV resizes it), and the caller
    scales the intrinsics (RayBatchSampler.from_scene does)."""
    if white_bkgr is None:
        white_bkgr = scene.white_bkgr
    out = []
    for i in indices:
        v = scene.views[i]
        want = tuple(target_hw or (v.h, v.w))
        if scene.images is not None:
            img = np.asarray(scene.images[i], np.float32)
            if img.shape[:2] != want:
                img = resize_linear(torch.from_numpy(img).to(
                    resolve_device(device)), want).cpu().numpy()
            out.append(img)
            continue
        img = read_image(v.image_path, device)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[:2] != want:
            img = resize_stored(img, want)
        img = img.cpu().numpy().astype(np.float32) / 255.0
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 4:
            rgb, a = img[..., :3], img[..., 3:4]
            img = rgb * a + (1.0 - a) if white_bkgr else rgb
        out.append(img)
    return np.stack(out)


@dataclasses.dataclass
class DevicePyramid:
    """The CLIP patch grids of the training views on the device, with the
    trilinear pixel lookup of a fixed scale (data/pyramid_clip.py
    ``make_device_pyramid``): one [n_imgs, nh_z, nw_z, E] grid for each of
    the (at most two) zoom levels bracketing log2(scale), their windows and
    strides in pixels, and the blend factor t toward the second."""
    grids: tuple
    wins: tuple
    strides: tuple
    t: float

    def lookup(self, img_idx: int, xs: torch.Tensor, ys: torch.Tensor
               ) -> torch.Tensor:
        """Pixel coords [B] -> [B, E] normalised supervision embeddings."""
        levels = []
        for g, win, stride in zip(self.grids, self.wins, self.strides):
            nh, nw = g.shape[1], g.shape[2]
            fx = (xs.float() - win / 2.0) / stride
            fy = (ys.float() - win / 2.0) / stride
            x0 = torch.clamp(torch.floor(fx).long(), 0, nw - 1)
            x1 = torch.clamp(x0 + 1, 0, nw - 1)
            y0 = torch.clamp(torch.floor(fy).long(), 0, nh - 1)
            y1 = torch.clamp(y0 + 1, 0, nh - 1)
            tx = torch.clamp(fx - x0, 0.0, 1.0)[..., None]
            ty = torch.clamp(fy - y0, 0.0, 1.0)[..., None]
            gi = g[img_idx]
            top = gi[y0, x0] * (1 - tx) + gi[y0, x1] * tx
            bot = gi[y1, x0] * (1 - tx) + gi[y1, x1] * tx
            levels.append(top * (1 - ty) + bot * ty)
        out = levels[0] if len(levels) == 1 else (
            levels[0] * (1.0 - self.t) + levels[1] * self.t)
        norm = torch.linalg.norm(out, dim=-1, keepdim=True)
        return out / torch.clamp(norm, min=1e-8)


class RayBatchSampler:
    """Device-resident random ray sampler for training. For LeRF it also
    draws each ray's supervision embedding (``target_lang``) at the same
    pixel: from a DevicePyramid, or from a dense [n_train, H, W, E] stack."""

    def __init__(self, images: torch.Tensor, poses: torch.Tensor,
                 intrinsics: torch.Tensor, batch_size: int,
                 precrop_iters: int = 0, precrop_frac: float = 0.5,
                 tile_h: int = 0, tile_w: int = 0,
                 lang_embeddings: Optional[torch.Tensor] = None,
                 pyramid: Optional[DevicePyramid] = None):
        self.images = images              # [n_train, H, W, 3]
        self.poses = poses                # [n_train, 4, 4]
        self.intrinsics = intrinsics      # [n_train, 3, 3]
        self.h, self.w = int(images.shape[1]), int(images.shape[2])
        self.batch_size = batch_size
        self.precrop_iters = precrop_iters
        self.precrop_frac = precrop_frac
        self.tile_h, self.tile_w = tile_h, tile_w
        self.lang_embeddings = lang_embeddings
        self.pyramid = pyramid

    @classmethod
    def from_scene(cls, scene: SceneData, batch_size: int,
                   precrop_iters: int = 0, precrop_frac: float = 0.5,
                   tile_h: int = 0, tile_w: int = 0,
                   device="cuda", lang_embeddings=None,
                   pyramid: Optional[DevicePyramid] = None
                   ) -> "RayBatchSampler":
        dev = resolve_device(device)
        idx = list(scene.split_indices("train"))
        v0 = scene.views[idx[0]]
        # every view at view 0's size, its intrinsics scaled to match
        images = load_images(scene, idx, target_hw=(v0.h, v0.w),
                             device=dev)
        poses = np.stack([scene.views[i].pose for i in idx])
        ks = []
        for i in idx:
            v = scene.views[i]
            k = np.asarray(v.k, np.float32).copy()
            k[0, :] *= v0.w / v.w
            k[1, :] *= v0.h / v.h
            ks.append(k)
        ks = np.stack(ks)

        def t(x):
            if torch.is_tensor(x):
                return x.to(dev, torch.float32)
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return cls(t(images), t(poses), t(ks), batch_size, precrop_iters,
                   precrop_frac, tile_h, tile_w,
                   t(lang_embeddings) if lang_embeddings is not None
                   else None, pyramid)

    @property
    def device(self) -> torch.device:
        return self.images.device

    def bounds(self, step: int):
        """Sampling rectangle (h0, h1, w0, w1): the full image, or the centre
        crop while step < precrop_iters."""
        if self.precrop_iters <= 0 or step >= self.precrop_iters:
            return 0, self.h, 0, self.w
        dh = int(self.h / 2 * self.precrop_frac)
        dw = int(self.w / 2 * self.precrop_frac)
        return (self.h // 2 - dh, self.h // 2 + dh,
                self.w // 2 - dw, self.w // 2 + dw)

    def n_draws(self) -> int:
        """Uniforms per axis that one ``sample`` consumes."""
        if self.tile_h > 0 and self.tile_w > 0:
            return self.batch_size // (self.tile_h * self.tile_w)
        return self.batch_size

    def sample(self, step: int, generator: Optional[torch.Generator] = None,
               u_h: Optional[torch.Tensor] = None,
               u_w: Optional[torch.Tensor] = None) -> dict:
        """The batch of step ``step``: rays_o, rays_d [B, 3], cone_angle,
        target_rgb [B, 3] (and target_lang [B, E] for LeRF). ``u_h``/``u_w``
        ([n_draws()] uniforms) place the tiles (or pixels); otherwise they come from ``generator``."""
        dev = self.device
        nd = self.n_draws()
        if u_h is None or u_w is None:
            u_h, u_w = (draw(torch.rand, (nd,), generator, dev)
                        for _ in range(2))
        u_h, u_w = u_h.to(dev), u_w.to(dev)
        img_idx = step % self.images.shape[0]
        h0, h1, w0, w1 = self.bounds(step)
        if self.tile_h > 0 and self.tile_w > 0:
            th, tw = self.tile_h, self.tile_w
            if nd * th * tw != self.batch_size:
                raise ValueError(f"batch_size {self.batch_size} must divide "
                                 f"by tile {th}x{tw}")
            if self.h < th or self.w < tw:
                raise ValueError(f"image {self.h}x{self.w} smaller than "
                                 f"tile {th}x{tw}")
            # origins uniform over where the tile fits the rectangle, kept
            # inside the image when precrop shrinks it below the tile
            oy = h0 + (u_h * float(max(h1 - h0 - th + 1, 1))).to(torch.int32)
            ox = w0 + (u_w * float(max(w1 - w0 - tw + 1, 1))).to(torch.int32)
            oy = torch.clamp(oy, max=self.h - th)
            ox = torch.clamp(ox, max=self.w - tw)
            dy = torch.arange(th, dtype=torch.int32, device=dev)
            dx = torch.arange(tw, dtype=torch.int32, device=dev)
            rand_h = (oy[:, None, None] + dy[None, :, None]).expand(
                nd, th, tw).reshape(-1)
            rand_w = (ox[:, None, None] + dx[None, None, :]).expand(
                nd, th, tw).reshape(-1)
        else:
            rand_h = h0 + (u_h * float(h1 - h0)).to(torch.int32)
            rand_w = w0 + (u_w * float(w1 - w0)).to(torch.int32)
        rh, rw = rand_h.long(), rand_w.long()
        target = self.images[img_idx][rh, rw]
        rays_o, rays_d, cone = ray_math.get_ray_batch(
            rand_w, rand_h, self.intrinsics[img_idx], self.poses[img_idx])
        batch = {"rays_o": rays_o, "rays_d": rays_d, "cone_angle": cone,
                 "target_rgb": target}
        if self.pyramid is not None:
            batch["target_lang"] = self.pyramid.lookup(img_idx, rand_w,
                                                       rand_h)
        elif self.lang_embeddings is not None:
            batch["target_lang"] = self.lang_embeddings[img_idx][rh, rw]
        return batch
