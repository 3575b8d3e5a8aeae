"""Auxiliary regularization losses (port of nerfpp_tpu/core/losses.py).

The hash grid's total-variation loss lives beside the encoder
(encoders/hashgrid.py). Nothing on the train step calls these, as in the
JAX executor: they are the reference's losses, kept as functions on
tensors with the JAX shapes and reductions.
"""
from __future__ import annotations

import torch


def sigma_sparsity_loss(sigmas: torch.Tensor) -> torch.Tensor:
    """Cauchy sparsity on densities: sum log(1 + 2 sigma^2) over the last
    axis."""
    return torch.sum(torch.log(1.0 + 2.0 * sigmas ** 2), dim=-1)


def orientation_loss(weights: torch.Tensor, normals: torch.Tensor,
                     viewdirs: torch.Tensor) -> torch.Tensor:
    """Visible normals facing away from the camera, per ray.

    weights [bs, n_samples, 1], normals [bs, n_samples, 3], viewdirs
    [bs, 3] -> [bs]."""
    n_dot_minus_v = torch.sum(normals * (-viewdirs)[..., None, :], dim=-1)
    return torch.sum(weights[..., 0]
                     * torch.clamp(n_dot_minus_v, max=0.0) ** 2, dim=-1)


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor,
                     pred_normals: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of the weighted analytic and predicted
    normals (a scalar)."""
    return torch.mean((weights * pred_normals - weights * normals) ** 2)
