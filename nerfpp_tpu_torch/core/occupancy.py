"""Occupancy-grid guided ray sampling (port of nerfpp_tpu/core/occupancy.py).

A [G, G, G] density grid over the scene AABB is the sampling prior: per ray
(or per tile of rays) the grid is read at uniform depth-bin midpoints,
normalised, blended with a uniform floor, and the sample depths come from the
inverse CDF. Training refreshes it from the field (``update_grid``, or one
octant per call with ``update_grid_phased``); the jitter of the probe points
is passed in as a tensor or drawn from a generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.core.integrate import apply_density_activation  # noqa: F401
from nerfpp_tpu_torch.core.sampling import draw, sample_pdf, unit_linspace


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


def _jitter(shape, jitter, generator, device) -> torch.Tensor:
    if jitter is not None:
        return jitter.to(device)
    return draw(torch.rand, shape, generator, device)


def _brick(x: torch.Tensor, g: int) -> torch.Tensor:
    """[g, g, g, 3] -> [g^3, 3] in 4x4x8-cell bricks: each 128-point run of
    the probe is a compact brick, which keeps the blocked encoder's window
    lists short (g % 8 == 0)."""
    return (x.reshape(g // 4, 4, g // 4, 4, g // 8, 8, 3)
            .permute(0, 2, 4, 1, 3, 5, 6).reshape(-1, 3))


def _unbrick(s: torch.Tensor, g: int) -> torch.Tensor:
    return (s.reshape(g // 4, g // 4, g // 8, 4, 4, 8)
            .permute(0, 3, 1, 4, 2, 5).reshape(g, g, g))


def _probe_points(bounding_box, n: int, spacing: float, offset, g: int,
                  jitter):
    """box_min + (corner + offset + jitter) * cell for the n^3 corners
    spacing apart, cell = extent / g."""
    dev = bounding_box.device
    cell = (bounding_box[3:] - bounding_box[:3]) / g
    ii = torch.arange(n, dtype=torch.float32, device=dev) * spacing
    corners = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), dim=-1)
    if offset is not None:
        corners = corners + offset
    return bounding_box[:3] + (corners + jitter) * cell


@torch.no_grad()
def update_grid(grid: OccupancyGrid, sigma_fn, bounding_box: torch.Tensor,
                decay: float = 0.95, jitter: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> OccupancyGrid:
    """EMA-max refresh: density <- max(decay * density, activated sigma at
    one jittered point per cell). ``sigma_fn(pts [N, 3]) -> [N]``; jitter
    [G, G, G, 3] uniforms, else drawn from ``generator``."""
    g = grid.resolution
    dev = grid.density.device
    jit = _jitter((g, g, g, 3), jitter, generator, dev)
    pts = _probe_points(bounding_box, g, 1.0, None, g, jit)
    sigma = sigma_fn(_brick(pts, g))
    return OccupancyGrid(density=torch.maximum(decay * grid.density,
                                               _unbrick(sigma, g)))


@torch.no_grad()
def update_grid_phased(grid: OccupancyGrid, sigma_fn,
                       bounding_box: torch.Tensor, phase: int,
                       decay: float = 0.95,
                       jitter: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> OccupancyGrid:
    """Octant-phased refresh: probe only the (i%2, j%2, k%2) sub-lattice that
    ``phase`` selects (1/8 of the cells), while the decay applies to the
    whole grid at every call. jitter: [G/2, G/2, G/2, 3] uniforms."""
    g = grid.resolution
    if g % 16:
        raise ValueError("phased update needs G % 16 == 0")
    h = g // 2
    dev = grid.density.device
    phase = int(phase) % 8
    pi, pj, pk = phase & 1, (phase >> 1) & 1, (phase >> 2) & 1
    off = torch.tensor([pi, pj, pk], dtype=torch.float32, device=dev)
    jit = _jitter((h, h, h, 3), jitter, generator, dev)
    pts = _probe_points(bounding_box, h, 2.0, off, g, jit)
    sigma = sigma_fn(_brick(pts, h))
    d = grid.density * decay
    d6 = d.view(h, 2, h, 2, h, 2)
    d6[:, pi, :, pj, :, pk] = torch.maximum(d6[:, pi, :, pj, :, pk],
                                            _unbrick(sigma, h))
    return OccupancyGrid(density=d)


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
