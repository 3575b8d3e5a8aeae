"""Volume integration: density -> alpha -> transmittance-weighted compositing
(port of nerfpp_tpu/core/integrate.py).

The transmittance product is taken in log space with a 1e-10 clamp on
(1 - alpha), as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class _TruncExp(torch.autograd.Function):
    """exp(x) whose gradient uses exp(clamp(x, -100, 5))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -100.0, 5.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


class RenderOutputs(NamedTuple):
    """Per-ray compositing results."""
    rgb: torch.Tensor      # [n_rays, 3]
    disp: torch.Tensor     # [n_rays]
    acc: torch.Tensor      # [n_rays]
    weights: torch.Tensor  # [n_rays, n_samples]
    depth: torch.Tensor    # [n_rays]


def dists_from_z(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Inter-sample distances with a 1e10 tail, scaled by ||rays_d||."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    return dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def apply_density_activation(sigma: torch.Tensor,
                             activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(sigma)
    if activation == "trunc_exp":
        return trunc_exp(sigma)
    if activation == "softplus":
        return torch.nn.functional.softplus(sigma)
    raise ValueError(f"unknown density activation {activation!r}")


def alpha_from_density(density: torch.Tensor, dists: torch.Tensor,
                       activation: str = "relu") -> torch.Tensor:
    """alpha = 1 - trunc_exp(-act(sigma) * dists)."""
    act = apply_density_activation(density, activation)
    return 1.0 - trunc_exp(-act * dists)


def weights_from_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """weights_i = alpha_i * exp(sum_{j<i} log(clamp(1 - alpha_j, 1e-10)))."""
    log_1m = torch.log(torch.clamp(1.0 - alpha, min=1e-10))
    log_trans = torch.cat([torch.zeros_like(log_1m[..., :1]),
                           torch.cumsum(log_1m, dim=-1)[..., :-1]], dim=-1)
    return alpha * trunc_exp(log_trans)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor, raw_noise_std: float = 0.0,
                white_bkgr: bool = False,
                noise: Optional[torch.Tensor] = None,
                density_activation: str = "relu") -> RenderOutputs:
    """Model outputs [n_rays, n_samples, 4] -> composited ray values.

    raw[..., :3] are rgb logits (sigmoid here), raw[..., 3] the density
    before activation. ``noise`` (standard normal, shaped like the density)
    enables the training-time density noise scaled by ``raw_noise_std``."""
    dists = dists_from_z(z_vals, rays_d)
    rgb = torch.sigmoid(raw[..., :3])
    density = raw[..., 3]
    if noise is not None:
        density = density + noise * raw_noise_std
    alpha = alpha_from_density(density, dists, density_activation)
    weights = weights_from_alpha(alpha)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * z_vals, dim=-1) / torch.clamp(acc, min=1e-10)
    disp = 1.0 / torch.clamp(depth, min=1e-10)
    if white_bkgr:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return RenderOutputs(rgb=rgb_map, disp=disp, acc=acc, weights=weights,
                         depth=depth)


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 log10(mse), mse floored at 1e-12."""
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss, torch convention: 0.5 e^2 inside ``delta``,
    delta * (|e| - delta / 2) outside."""
    err = pred - target
    abs_err = torch.abs(err)
    return torch.where(abs_err <= delta, 0.5 * err ** 2,
                       delta * (abs_err - 0.5 * delta))
