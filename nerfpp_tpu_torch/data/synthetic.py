"""Procedural synthetic scenes with analytic ground truth (port of
nerfpp_tpu/data/synthetic.py).

A handful of coloured primitives with constant interior density, rendered to
ground-truth images by compositing the true field along rays with dense
samples, in chunks of rays on the given device. The views, splits and bbox
are the JAX package's for the same arguments (the camera path is drawn from
the same numpy seed), so both packages train on the same scene.
"""
from __future__ import annotations

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.core import rays as ray_math
from nerfpp_tpu_torch.core.integrate import weights_from_alpha
from nerfpp_tpu_torch.data.dataset import SceneData, View

# center xyz, half-extents xyz, rgb, sigma, kind (0 sphere, 1 box)
_PRIMS = np.array([
    [0.0, 0.0, 0.0, 0.42, 0.42, 0.42, 0.9, 0.25, 0.2, 28.0, 0],
    [0.55, 0.0, 0.25, 0.22, 0.22, 0.22, 0.2, 0.5, 0.9, 35.0, 0],
    [-0.5, 0.45, -0.2, 0.25, 0.25, 0.25, 0.95, 0.8, 0.15, 30.0, 1],
    [0.1, -0.55, 0.4, 0.18, 0.18, 0.18, 0.3, 0.9, 0.35, 40.0, 1],
    [-0.25, -0.3, -0.5, 0.2, 0.2, 0.2, 0.7, 0.3, 0.85, 33.0, 0],
], np.float32)

# thin rods and a plate (down to 0.015 half-width) plus two bulk prims
_PRIMS_THIN = np.array([
    [0.0, 0.0, 0.0, 0.35, 0.35, 0.35, 0.85, 0.3, 0.2, 28.0, 0],
    [0.0, 0.0, 0.55, 0.02, 0.02, 0.55, 0.95, 0.9, 0.2, 60.0, 1],
    [0.45, -0.3, 0.0, 0.02, 0.6, 0.02, 0.2, 0.9, 0.5, 60.0, 1],
    [-0.5, 0.3, 0.1, 0.5, 0.015, 0.4, 0.3, 0.5, 0.95, 55.0, 1],
    [0.35, 0.45, -0.35, 0.18, 0.18, 0.18, 0.9, 0.6, 0.15, 35.0, 0],
    [-0.3, -0.5, -0.3, 0.025, 0.025, 0.45, 0.8, 0.25, 0.9, 60.0, 1],
], np.float32)

_VARIANTS = {"default": _PRIMS, "thin": _PRIMS_THIN}
GT_CHUNK = 16384                   # rays per ground-truth render step


def scene_field(pts: torch.Tensor, variant: str = "default",
                textured: bool = False):
    """Ground-truth field. pts [..., 3] -> (sigma [...], rgb [..., 3])."""
    prims = torch.as_tensor(_VARIANTS[variant], device=pts.device)
    centers, sizes, colors = prims[:, 0:3], prims[:, 3:6], prims[:, 6:9]
    sigmas, kinds = prims[:, 9], prims[:, 10]
    rel = pts[..., None, :] - centers                    # [..., P, 3]
    d_sphere = torch.linalg.norm(rel / sizes, dim=-1)
    d_box = torch.amax(torch.abs(rel) / sizes, dim=-1)
    d = torch.where(kinds > 0.5, d_box, d_sphere)        # [..., P]
    inside = torch.sigmoid((1.0 - d) * 40.0)
    sigma = torch.sum(sigmas * inside, dim=-1)
    if textured:
        stripe = 0.75 + 0.25 * torch.sin(
            14.0 * pts[..., 0] + 11.0 * pts[..., 1] + 9.0 * pts[..., 2])
        colors = colors * stripe[..., None, None]
    w = inside + 1e-8
    rgb = torch.sum(w[..., None] * colors, dim=-2) / torch.sum(
        w, dim=-1)[..., None]
    return sigma, torch.clamp(rgb, 0.0, 1.0)


def render_gt_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
                   far: float, n_samples: int = 256, white_bkgr: bool = True,
                   variant: str = "default",
                   textured: bool = False) -> torch.Tensor:
    """Composite the ground-truth field along rays. [..., 3] rgb."""
    t = torch.linspace(near, far, n_samples, dtype=torch.float32,
                       device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    sigma, rgb = scene_field(pts, variant, textured)
    dists = torch.diff(t, append=(t[-1] + (far - near) / n_samples)[None])
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    weights = weights_from_alpha(1.0 - torch.exp(-sigma * dists))
    out = torch.sum(weights[..., None] * rgb, dim=-2)
    if white_bkgr:
        out = out + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return out


def make_synthetic_scene(n_train: int = 24, n_val: int = 2, n_test: int = 4,
                         image_hw: int = 64, n_samples: int = 256,
                         radius: float = 3.0, seed: int = 0,
                         white_bkgr: bool = True, variant: str = "default",
                         textured: bool = False,
                         device="cuda") -> SceneData:
    """A SceneData with ground-truth images rendered on ``device`` from
    views on a sphere; held-out views interleave with the training views
    around the azimuth circle. Images come back as a numpy stack."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    h = w = image_hw
    focal = 1.1 * image_hw
    k = ray_math.calibration_matrix(focal, w, h)
    n_total = n_train + n_val + n_test
    thetas = (np.linspace(-180, 180, n_total, endpoint=False)
              + rng.uniform(0, 5, n_total))
    phis = -30.0 + 20.0 * np.sin(np.linspace(0, 4 * np.pi, n_total))
    held_out = set(rng.choice(n_total, n_val + n_test, replace=False).tolist())
    train_ids = [i for i in range(n_total) if i not in held_out]
    order = np.asarray(train_ids + sorted(held_out), np.int64)
    thetas, phis = thetas[order], phis[order]
    near, far = 0.5 * radius, 1.5 * radius
    k_t = torch.as_tensor(k, device=dev)
    views, images = [], []
    with torch.no_grad():
        for i in range(n_total):
            pose = ray_math.pose_spherical(float(thetas[i]), float(phis[i]),
                                           radius)
            rays_o, rays_d, _ = ray_math.get_rays(
                h, w, k_t, torch.as_tensor(pose, device=dev))
            flat_o, flat_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
            out = torch.cat([
                render_gt_rays(flat_o[c:c + GT_CHUNK], flat_d[c:c + GT_CHUNK],
                               near, far, n_samples, white_bkgr, variant,
                               textured)
                for c in range(0, flat_o.shape[0], GT_CHUNK)])
            images.append(torch.clamp(out.reshape(h, w, 3), 0.0, 1.0)
                          .cpu().numpy())
            views.append(View(id=i, h=h, w=w, focal=focal, near=near,
                              far=far, k=k.copy(), pose=pose))
    bbox = np.array([-1.2, -1.2, -1.2, 1.2, 1.2, 1.2], np.float32)
    return SceneData(views=views, splits_idx=[n_train, n_val, n_test],
                     bounding_box=bbox, white_bkgr=white_bkgr,
                     images=np.stack(images))
