"""Sampling along rays (port of nerfpp_tpu/core/sampling.py).

Randomness is passed in: stochastic paths take uniform draws as tensors (or a
``torch.Generator`` to draw them), so tests can feed the JAX package and the
port the same numbers. ``fork`` derives a generator from a seed and a path
(as JAX's fold_in derives a key); ``RowDraws`` gives a subset of rows the
draws made for all of them.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class RowDraws:
    """Rows ``rows`` (a slice or an index tensor) of draws made at ``n``
    rows from ``generator``: every draw is made whole and then sliced, so a
    rank that renders some of a batch's rays gets the numbers one device
    draws for them. Pass it where a generator goes."""

    def __init__(self, generator: torch.Generator, n: int, rows):
        self.generator, self.n, self.rows = generator, n, rows

    @property
    def device(self) -> torch.device:
        return self.generator.device


def row_draws(generator: Optional[torch.Generator], n: int, rows):
    """RowDraws of ``generator``, or None without one."""
    return None if generator is None else RowDraws(generator, n, rows)


def fork(generator: Optional[torch.Generator], *path: int):
    """A new generator on ``generator``'s device seeded from its seed
    (``initial_seed()``, not its state) and the integers ``path``, as JAX
    derives a key with fold_in: what it draws depends on the seed and the
    path only. None without a generator. Host arithmetic (splitmix64), no
    device sync."""
    if generator is None:
        return None
    mask = (1 << 64) - 1
    s = generator.initial_seed() & mask
    for i in path:
        s = (s ^ (int(i) * 0xBF58476D1CE4E5B9 + 0x9E3779B97F4A7C15)) & mask
        s = ((s ^ (s >> 30)) * 0xBF58476D1CE4E5B9) & mask
        s = ((s ^ (s >> 27)) * 0x94D049BB133111EB) & mask
        s ^= s >> 31
    return torch.Generator(device=generator.device).manual_seed(
        s & ((1 << 63) - 1))


def draw(fn, shape, generator, device) -> torch.Tensor:
    """``fn`` (torch.rand / torch.randn) on the generator's device, moved to
    ``device``: one CPU generator gives the same draws to every device. A
    RowDraws draws ``(n, *shape[1:])`` and keeps its rows."""
    if generator is None:
        raise ValueError("a random draw needs a generator or a passed-in "
                         "tensor")
    if isinstance(generator, RowDraws):
        full = fn((generator.n, *shape[1:]), generator=generator.generator,
                  device=generator.device)
        rows = generator.rows
        out = full[rows if isinstance(rows, slice) else rows.to(full.device)]
        if out.shape[0] != shape[0]:
            raise ValueError(f"a row draw of {out.shape[0]} rows for a "
                             f"shape of {shape[0]}")
        return out.to(device)
    return fn(shape, generator=generator, device=generator.device).to(device)


def unit_linspace(n: int, device=None) -> torch.Tensor:
    """linspace(0, 1, n) in f32 with the JAX package's bits: i * f32(1/(n-1)),
    last value exactly 1."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = float(np.float32(1.0) / np.float32(n - 1))
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    t[-1] = 1.0
    return t


def _safe_inv(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return torch.where(x.abs() < eps, torch.full_like(x, 1.0 / eps), 1.0 / x)


def sample_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                  lin_disp: bool = False, perturb: float = 0.0,
                  t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-ray depths [n_rays, n_samples] from near/far [n_rays, 1], linear in
    depth or in disparity; ``perturb`` > 0 jitters within each bin by the
    uniforms ``t_rand`` (intervals below 1e-8 stay unjittered)."""
    t_vals = unit_linspace(n_samples, near.device)
    if not lin_disp:
        z_vals = near + (far - near) * t_vals
    else:
        inv_n = _safe_inv(near)
        z_vals = _safe_inv(inv_n + (_safe_inv(far) - inv_n) * t_vals)
    if perturb > 0.0:
        if t_rand is None:
            raise ValueError("perturb > 0 requires uniform draws t_rand")
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        intervals = upper - lower
        z_vals = lower + torch.where(intervals > 1e-8, intervals * t_rand,
                                     torch.zeros_like(intervals))
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False,
               generator: Optional[torch.Generator] = None,
               draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling. bins [R, m] edges, weights [R, m-1]
    -> [R, n_samples], sorted per ray.

    +1e-8 weight floor, zero-prefix CDF, right bisect (``searchsorted``
    with right=True equals the JAX package's count of cdf <= u), bins whose
    CDF span is below 1e-5 fall back to the lower edge, and a final cummax.
    Stochastic u are sorted uniforms made from normalised exponential gaps
    of ``draws`` ([R, n_samples + 1] uniforms, else drawn from
    ``generator`` on its device)."""
    weights = weights + 1e-8
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u_shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = unit_linspace(n_samples, cdf.device).expand(u_shape)
    else:
        if draws is None:
            draws = draw(torch.rand, cdf.shape[:-1] + (n_samples + 1,),
                         generator, cdf.device)
        draws = draws.to(cdf.device)
        gaps = -torch.log(torch.clamp(draws, min=np.finfo(np.float32).tiny))
        s = torch.cumsum(gaps, dim=-1)
        u = s[..., :-1] / s[..., -1:]
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    m = cdf.shape[-1]
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    hi = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=hi))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=hi))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    z = bins_below + t * (bins_above - bins_below)
    return torch.cummax(z, dim=-1).values


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two row-sorted arrays [R, n1], [R, n2] -> [R, n1 + n2] sorted,
    ties ranking ``a`` first (a stable merge), with a final cummax as in the
    JAX package. Both inputs MUST be row-sorted. The JAX version places
    values by a one-hot bf16 3-way-split matmul (~1e-7 relative noise); here
    each value lands exactly at its rank: rank(a_i) = i + #{b_j < a_i},
    rank(b_j) = j + #{a_i <= b_j}."""
    a, b = a.contiguous(), b.contiguous()
    n1, n2 = a.shape[-1], b.shape[-1]
    rank_a = (torch.arange(n1, device=a.device)
              + torch.searchsorted(b, a, right=False))
    rank_b = (torch.arange(n2, device=b.device)
              + torch.searchsorted(a, b, right=True))
    out = torch.empty(a.shape[:-1] + (n1 + n2,), dtype=a.dtype,
                      device=a.device)
    out.scatter_(-1, torch.cat([rank_a, rank_b], dim=-1),
                 torch.cat([a, b], dim=-1))
    return torch.cummax(out, dim=-1).values


def reflect_boundary(pts: torch.Tensor, min_bound: torch.Tensor,
                     max_bound: torch.Tensor) -> torch.Tensor:
    """Fold points back into the box by mirror reflection at the faces
    (stochastic preconditioning keeps its perturbed points in the bbox)."""
    normalized = (pts - min_bound) / (max_bound - min_bound)
    x = torch.remainder(normalized, 2.0)
    x = torch.where(x > 1.0, 2.0 - x, x)
    return x * (max_bound - min_bound) + min_bound


def scatter_uniforms(n_rays: int, n_samples: int,
                     generator: torch.Generator, device) -> tuple:
    """The two uniform draws tangent_scatter consumes, [n_rays, n_samples, 1]
    each (radius, then angle), drawn on the generator's device."""
    shape = (n_rays, n_samples, 1)
    return tuple(draw(torch.rand, shape, generator, device) for _ in range(2))


def tangent_scatter(pts: torch.Tensor, z_vals: torch.Tensor, cone_angle,
                    rays_d: torch.Tensor, u_r: torch.Tensor,
                    u_t: torch.Tensor,
                    bounding_box: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Jitter each sample uniformly over the disk of radius cone_angle * z
    perpendicular to its ray (anti-aliasing), then clamp to the bbox.

    pts [R, S, 3], z_vals [R, S], rays_d [R, 3]; u_r and u_t are uniforms
    [R, S, 1] for the radius and the angle. cone_angle=None is a no-op."""
    if cone_angle is None:
        return pts

    def safe_normalize(v, eps=1e-8):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=eps)

    cone_radii = cone_angle * z_vals
    d = safe_normalize(rays_d)
    abs_d = d.abs()
    mask_x = (abs_d[..., 0] < abs_d[..., 1]) & (abs_d[..., 0] < abs_d[..., 2])
    mask_y = (abs_d[..., 1] < abs_d[..., 0]) & (abs_d[..., 1] < abs_d[..., 2])
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    up = torch.where(mask_x[..., None], eye[0],
                     torch.where(mask_y[..., None], eye[1], eye[2]))
    tangent = safe_normalize(torch.linalg.cross(d, up, dim=-1))
    bitangent = safe_normalize(torch.linalg.cross(d, tangent, dim=-1))
    r = torch.sqrt(torch.clamp(u_r, 1e-8, 1.0 - 1e-8))
    theta = u_t * 2.0 * math.pi
    offset = (tangent[:, None, :] * (r * torch.cos(theta))
              + bitangent[:, None, :] * (r * torch.sin(theta)))
    pts = pts + offset * cone_radii[..., None]
    if bounding_box is not None:
        pts = torch.minimum(torch.maximum(pts, bounding_box[:3]),
                            bounding_box[3:])
    return pts
