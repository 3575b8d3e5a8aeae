"""LeRF field — the language-embedding radiance field (port of
nerfpp_tpu/models/lerf_field.py).

An independent head on the language hash grid's features, with its own
density: a bias-free sigma net (features -> 1 + geo_feat_dim_le) and a
bias-free language net (geo features ++ hash features -> lang_embed_dim),
both xavier-normal at gain 0.1, with the MLPs' bf16-operand / f32-sum
arithmetic (nn.py). The embedding is normalised by rsqrt(sum(e^2) + 1e-12),
which keeps the gradient finite where a bias-free ReLU stack gives exactly
zero. Output channels are [embedding (lang_embed_dim), sigma_le].
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.nn import MLP


class LeRFField(nn.Module):
    def __init__(self, geo_feat_dim_le: int = 32, num_layers_le: int = 3,
                 hidden_dim_le: int = 64, lang_embed_dim: int = 768,
                 input_ch_le: int = 0, compute_dtype: Optional[str] = None,
                 init_gain: float = 0.1, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.geo_feat_dim_le = geo_feat_dim_le
        self.lang_embed_dim = lang_embed_dim
        self.init_gain = init_gain
        hidden = [hidden_dim_le] * (num_layers_le - 1)
        self.sigma_le_net = MLP([input_ch_le] + hidden
                                + [1 + geo_feat_dim_le], compute_dtype, device)
        self.le_net = MLP([geo_feat_dim_le + input_ch_le] + hidden
                          + [lang_embed_dim], compute_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.sigma_le_net.reset_parameters(self.init_gain, generator)
        self.le_net.reset_parameters(self.init_gain, generator)

    def embed_and_density(self, x: torch.Tensor):
        """x: [N, input_ch_le] -> (normalised embedding [N, E], sigma_le
        [N]), before the concatenation of ``forward``."""
        h = self.sigma_le_net(x)
        le = self.le_net(torch.cat([h[..., 1:], x], dim=-1))
        le = le * torch.rsqrt(torch.sum(le * le, dim=-1, keepdim=True)
                              + 1e-12)
        return le, h[..., 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, input_ch_le] -> [N, lang_embed_dim + 1]."""
        le, sigma = self.embed_and_density(x)
        return torch.cat([le, sigma[..., None]], dim=-1)
