"""Occupancy-grid guided ray sampling, serving side (port of
nerfpp_tpu/core/occupancy.py).

A [G, G, G] density grid over the scene AABB is the sampling prior: per ray
(or per tile of rays) the grid is read at uniform depth-bin midpoints,
normalised, blended with a uniform floor, and the sample depths come from the
inverse CDF. The grid updates (``update_grid``, ``update_grid_phased``)
belong to training and come with the training slice.
"""
from __future__ import annotations

import dataclasses

import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.core.integrate import apply_density_activation  # noqa: F401
from nerfpp_tpu_torch.core.sampling import sample_pdf, unit_linspace


@dataclasses.dataclass
class OccupancyGrid:
    """Non-trainable density EMA over the scene AABB."""
    density: torch.Tensor                      # [G, G, G] f32, >= 0

    @property
    def resolution(self) -> int:
        return self.density.shape[0]


def make_occupancy_grid(resolution: int = 128,
                        device="cuda") -> OccupancyGrid:
    """Fresh grid = uniform prior (sampling reduces to uniform depths)."""
    return OccupancyGrid(density=torch.ones(
        (resolution,) * 3, dtype=torch.float32,
        device=resolve_device(device)))


def _inv_extent(bounding_box: torch.Tensor) -> torch.Tensor:
    """f32 reciprocal of the bbox extent. The JAX package divides by the
    constant extent and XLA folds that into this multiply, so grid cell
    indices match the jitted reference bit for bit."""
    return 1.0 / (bounding_box[3:] - bounding_box[:3])


def ray_bin_densities(grid: OccupancyGrid, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, near: torch.Tensor,
                      far: torch.Tensor, bounding_box: torch.Tensor,
                      n_bins: int):
    """Raw grid density at M uniform bin midpoints per ray.
    Returns (edges [R, M+1], d [R, M])."""
    g = grid.resolution
    t = unit_linspace(n_bins + 1, rays_o.device)
    edges = near + (far - near) * t
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
    rel = (pts - bounding_box[:3]) * _inv_extent(bounding_box)
    idx = torch.clamp((rel * g).to(torch.int64), 0, g - 1)
    d = grid.density[idx[..., 0], idx[..., 1], idx[..., 2]]
    return edges, d


def ray_bin_weights(grid: OccupancyGrid, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, near: torch.Tensor,
                    far: torch.Tensor, bounding_box: torch.Tensor,
                    n_bins: int, uniform_frac: float = 0.1):
    """Per-ray prior: (edges [R, M+1], weights [R, M]) — normalised grid
    density blended with ``uniform_frac`` of uniform mass."""
    edges, d = ray_bin_densities(grid, rays_o, rays_d, near, far,
                                 bounding_box, n_bins)
    pdf = d / torch.clamp(d.sum(dim=-1, keepdim=True), min=1e-8)
    return edges, (1.0 - uniform_frac) * pdf + uniform_frac / n_bins


def tiled_prior(grid: OccupancyGrid, rays_o: torch.Tensor,
                rays_d: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                bounding_box: torch.Tensor, n_bins: int,
                uniform_frac: float = 0.1, tile: int = 128):
    """Per-tile prior over ``tile`` consecutive rays: (edges [T, M+1],
    weights [T, M], mass [T]); the depth range is the tile's [min near,
    max far], every ray of the tile probes the grid, and mass is the tile's
    mean raw density (the empty-tile ranking signal)."""
    nt = rays_o.shape[0] // tile
    near_t = near.reshape(nt, tile).amin(dim=1, keepdim=True)
    far_t = far.reshape(nt, tile).amax(dim=1, keepdim=True)
    edges_s, d_s = ray_bin_densities(
        grid, rays_o, rays_d, near_t.repeat_interleave(tile, dim=0),
        far_t.repeat_interleave(tile, dim=0), bounding_box, n_bins)
    mass = d_s.reshape(nt, tile, -1).sum(dim=(1, 2)) / tile
    pdf = d_s / torch.clamp(d_s.sum(dim=-1, keepdim=True), min=1e-8)
    w_s = (1.0 - uniform_frac) * pdf + uniform_frac / n_bins
    edges_t = edges_s.reshape(nt, tile, -1)[:, 0, :]
    w_t = w_s.reshape(nt, tile, -1).mean(dim=1)
    return edges_t, w_t, mass


def tiled_ray_z_mass(grid: OccupancyGrid, rays_o, rays_d, near, far,
                     bounding_box, n_bins: int, n_samples: int,
                     uniform_frac: float = 0.1, tile: int = 128,
                     det: bool = True, generator=None):
    """Per-tile depths [T, n_samples] and tile masses [T]."""
    edges_t, w_t, mass = tiled_prior(grid, rays_o, rays_d, near, far,
                                     bounding_box, n_bins, uniform_frac, tile)
    return sample_pdf(edges_t, w_t, n_samples, det=det,
                      generator=generator), mass


def tiled_ray_z(grid: OccupancyGrid, rays_o, rays_d, near, far,
                bounding_box, n_bins: int, n_samples: int,
                uniform_frac: float = 0.1, tile: int = 128,
                det: bool = True, generator=None) -> torch.Tensor:
    """Occupancy-guided depths [R, n_samples] shared by each ``tile``
    consecutive rays (one inverse CDF per tile)."""
    z_t, _ = tiled_ray_z_mass(grid, rays_o, rays_d, near, far, bounding_box,
                              n_bins, n_samples, uniform_frac, tile, det,
                              generator)
    return z_t.repeat_interleave(tile, dim=0)
