"""NeRFSmall — compact field head for hash encodings (port of
nerfpp_tpu/models/nerf_small.py).

Bias-free sigma net (hash features -> 1 + geo_feat_dim), colour net (dir
features ++ geo features -> 3) and, with ``use_pred_normal``, normals net
(sigma ++ geo features ++ hash features -> 3). Output channels are
[rgb(3), sigma(1)] and with the normals head [rgb, sigma, normals(3)];
activations are applied later by raw2outputs, which reads rgb and sigma.
The JAX signature's num_layers_normals and hidden_dim_normals are keywords
here, after the arguments the port had before the head.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.nn import MLP


class NeRFSmall(nn.Module):
    def __init__(self, num_layers: int = 3, hidden_dim: int = 64,
                 geo_feat_dim: int = 15, num_layers_color: int = 4,
                 hidden_dim_color: int = 64, use_pred_normal: bool = False,
                 input_ch: int = 3, input_ch_views: int = 3,
                 compute_dtype: Optional[str] = None, init_gain: float = 0.1,
                 device="cuda", num_layers_normals: int = 3,
                 hidden_dim_normals: int = 64):
        super().__init__()
        device = resolve_device(device)
        self.input_ch = input_ch
        self.input_ch_views = input_ch_views
        self.geo_feat_dim = geo_feat_dim
        self.init_gain = init_gain
        self.sigma_net = MLP([input_ch] + [hidden_dim] * (num_layers - 1)
                             + [1 + geo_feat_dim], compute_dtype, device)
        self.color_net = MLP([input_ch_views + geo_feat_dim]
                             + [hidden_dim_color] * (num_layers_color - 1)
                             + [3], compute_dtype, device)
        self.normals_net = None
        if use_pred_normal:
            self.normals_net = MLP(
                [1 + geo_feat_dim + input_ch]
                + [hidden_dim_normals] * (num_layers_normals - 1) + [3],
                compute_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The sigma and colour nets, in that order. The normals net draws
        separately (``reset_normals``): the executor draws it after every
        other parameter, so that a seed gives the stack the same weights
        with and without the head."""
        self.sigma_net.reset_parameters(self.init_gain, generator)
        self.color_net.reset_parameters(self.init_gain, generator)

    def reset_normals(self, generator: torch.Generator) -> None:
        if self.normals_net is not None:
            self.normals_net.reset_parameters(self.init_gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, input_ch + input_ch_views] (hash features ++ dir features)."""
        input_pts = x[..., :self.input_ch]
        input_views = x[..., self.input_ch:self.input_ch + self.input_ch_views]
        h = self.sigma_net(input_pts)
        sigma, geo_feat = h[..., 0:1], h[..., 1:]
        color = self.color_net(torch.cat([input_views, geo_feat], dim=-1))
        outs = [color, sigma]
        if self.normals_net is not None:
            outs.append(self.normals_net(
                torch.cat([sigma, geo_feat, input_pts], dim=-1)))
        return torch.cat(outs, dim=-1)
