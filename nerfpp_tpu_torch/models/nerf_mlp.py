"""Classic NeRF MLP (port of nerfpp_tpu/models/nerf_mlp.py).

A depth x width trunk with biases and the embedded input concatenated back
after each skip layer (layer 4), then either the viewdirs branch (feature
linear -> concat dir features -> width/2 -> rgb, with a separate alpha head
off the trunk) or one output head after a final input skip. Output channels
are [rgb(3), sigma(1)] (output_ch of the plain head otherwise); activations
are applied later by raw2outputs. ``compute_dtype`` has nn.py's meaning.
"""
from __future__ import annotations

from typing import FrozenSet, Optional

import torch
from torch import nn

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.nn import dense, xavier_normal_


class NeRFMLP(nn.Module):
    def __init__(self, depth: int = 8, width: int = 256, input_ch: int = 3,
                 input_ch_views: int = 3, output_ch: int = 4,
                 skips: FrozenSet[int] = frozenset({4}),
                 use_viewdirs: bool = False, init_gain: float = 0.1,
                 compute_dtype: Optional[str] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.input_ch = input_ch
        self.input_ch_views = input_ch_views
        self.skips = frozenset(skips)
        self.use_viewdirs = use_viewdirs
        self.init_gain = init_gain
        self.compute_dtype = compute_dtype

        def linear(i, o):
            return nn.Linear(i, o, device=dev)
        # layer i + 1 takes width (+ input_ch after a skip layer i)
        self.pts_linears = nn.ModuleList(
            [linear(input_ch, width)]
            + [linear(width + (input_ch if i in self.skips else 0), width)
               for i in range(depth - 1)])
        if use_viewdirs:
            self.views_linears = nn.ModuleList(
                [linear(input_ch_views + width, width // 2)])
            self.feature_linear = linear(width, width)
            self.alpha_linear = linear(width, 1)
            self.rgb_linear = linear(width // 2, 3)
        else:
            self.output_linear = linear(width + input_ch, output_ch)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-normal weights with ``init_gain`` (drawn in module order
        from the CPU generator), zero biases."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                xavier_normal_(layer.weight, self.init_gain, generator)
                with torch.no_grad():
                    layer.bias.zero_()

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(x, layer.weight, self.compute_dtype) + layer.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, input_ch + input_ch_views] embedded points (++ dirs)."""
        input_pts = x[..., :self.input_ch]
        input_views = x[..., self.input_ch:self.input_ch + self.input_ch_views]
        h = input_pts
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(self._dense(layer, h))
            if i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if self.use_viewdirs:
            alpha = self._dense(self.alpha_linear, h)
            feature = self._dense(self.feature_linear, h)
            h = torch.cat([feature, input_views], dim=-1)
            for layer in self.views_linears:
                h = torch.relu(self._dense(layer, h))
            rgb = self._dense(self.rgb_linear, h)
            return torch.cat([rgb, alpha], dim=-1)
        h = torch.cat([h, input_pts], dim=-1)
        return self._dense(self.output_linear, h)
