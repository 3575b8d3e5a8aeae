"""Ray generation and geometry (port of nerfpp_tpu/core/rays.py).

OpenGL camera convention: pixel (x, y) maps to the camera-frame direction
((x - cx) / fx, -(y - cy) / fy, -1). The rotation into the world frame is
written out as three products and two sums, not a matrix product, so the CPU
and the GPU give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch


def get_directions(h: int, w: int, k: torch.Tensor) -> torch.Tensor:
    """Camera-frame directions [h, w, 3] (z = -1 plane)."""
    dev = k.device
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    dir_x = (x - cx) / fx * ones
    dir_y = -(y - cy) / fy * ones
    return torch.stack([dir_x, dir_y, -ones], dim=-1)


def pixel_directions(px_x: torch.Tensor, px_y: torch.Tensor,
                     k: torch.Tensor) -> torch.Tensor:
    """Camera-frame directions [B, 3] for a flat batch of pixel coords."""
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    dir_x = (px_x.to(torch.float32) - cx) / fx
    dir_y = -(px_y.to(torch.float32) - cy) / fy
    return torch.stack([dir_x, dir_y, -torch.ones_like(dir_x)], dim=-1)


def cone_angle_of(k: torch.Tensor) -> torch.Tensor:
    """Per-camera cone-angle derivative: 1.1 * mean(1/fx, 1/fy)."""
    return 1.1 * (1.0 / k[0, 0] + 1.0 / k[1, 1]) / 2.0


def rotate_dirs(dirs: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """Rotate camera-frame dirs [..., 3] into the world frame by c2w[:3, :3]."""
    r = c2w[:3, :3]
    return torch.stack([dirs[..., 0] * r[i, 0] + dirs[..., 1] * r[i, 1]
                        + dirs[..., 2] * r[i, 2] for i in range(3)], dim=-1)


def get_rays(h: int, w: int, k: torch.Tensor, c2w: torch.Tensor):
    """Full-image rays: origins [h, w, 3], directions [h, w, 3], cone angle."""
    rays_d = rotate_dirs(get_directions(h, w, k), c2w)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d, cone_angle_of(k)


def ndc_rays(h: int, w: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor, cone_angle=None):
    """Project rays into normalized device coordinates (forward-facing
    scenes): the origins moved to the plane z = -near, then both mapped into
    NDC for an h x w image of the given focal. A cone angle (None in thin-ray
    mode) is rescaled per ray by the ratio of the NDC direction's norm to
    the original's: -> [..., 1]. Returns (origins, directions, cone angle)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    new_o = torch.stack([o0, o1, o2], dim=-1)
    new_d = torch.stack([d0, d1, d2], dim=-1)
    if cone_angle is not None:
        scale = (torch.sqrt(d0 ** 2 + d1 ** 2 + d2 ** 2)
                 / torch.linalg.norm(rays_d, dim=-1))
        cone_angle = cone_angle * scale[..., None]
    return new_o, new_d, cone_angle


def intersect_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                   bounding_box: torch.Tensor, near_plane: float = 0.0):
    """Per-ray (near, far) from slab intersection with the box [6]; the
    division is guarded by +1e-6 and far is forced above near by 1e-6."""
    aabb = bounding_box.reshape(2, 3)
    dir_fraction = 1.0 / (rays_d + 1e-6)
    t_lo = (aabb[0] - rays_o) * dir_fraction
    t_hi = (aabb[1] - rays_o) * dir_fraction
    nears = torch.minimum(t_lo, t_hi).amax(dim=-1)
    fars = torch.maximum(t_lo, t_hi).amin(dim=-1)
    nears = torch.clamp(nears, min=near_plane)
    fars = torch.maximum(fars, nears + 1e-6)
    return nears, fars


def get_ray_batch(px_x: torch.Tensor, px_y: torch.Tensor, k: torch.Tensor,
                  c2w: torch.Tensor):
    """Rays through a flat batch of pixel coords: (origins [B, 3],
    directions [B, 3], cone angle)."""
    rays_d = rotate_dirs(pixel_directions(px_x, px_y, k), c2w)
    return c2w[:3, -1].expand(rays_d.shape), rays_d, cone_angle_of(k)


def c2w_to_w2c(pose: torch.Tensor) -> torch.Tensor:
    """Invert a rigid camera pose [4, 4] (c2w <-> w2c): the rotation
    inverted, the translation -R^-1 t."""
    r_inv = torch.linalg.inv(pose[:3, :3])
    out = torch.eye(4, dtype=pose.dtype, device=pose.device)
    out[:3, :3] = r_inv
    out[:3, 3] = -(r_inv @ pose[:3, 3])
    return out


# -- host-side pose helpers (numpy) ------------------------------------------

def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    np.float32)


def _rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float,
                   x: float = 0.0, y: float = 0.0, z: float = 0.0
                   ) -> np.ndarray:
    """Camera-to-world pose on a sphere looking at the origin."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    np.float32)
    c2w = flip @ c2w
    c2w[0, 3] += x
    c2w[1, 3] += y
    c2w[2, 3] += z
    return c2w


def calibration_matrix(focal: float, w: float, h: float) -> np.ndarray:
    """3x3 intrinsics with the principal point at the image centre."""
    return np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1]],
                    np.float32)


def same_fov_calibration_matrix(k: np.ndarray, new_w: float,
                                new_h: float) -> np.ndarray:
    """Intrinsics ``k`` (principal point at the centre) rescaled to a new
    resolution with the same field of view across the longer side."""
    focal = float(k[0, 0])
    w, h = float(k[0, 2]) * 2, float(k[1, 2]) * 2
    camera_angle = 2.0 * np.arctan(max(w, h) / 2.0 / focal)
    new_focal = 0.5 * max(new_w, new_h) / np.tan(0.5 * camera_angle)
    return calibration_matrix(new_focal, new_w, new_h)
