"""Bias-free dense stacks (port of nerfpp_tpu/nn.py).

``compute_dtype="bfloat16"`` has the JAX package's meaning: bf16 inputs and
weights, f32 accumulation, f32 output (``preferred_element_type=f32``). A
bf16 ``torch.matmul`` would round its output to bf16, a different function,
so the port rounds both operands to bf16, widens them back to f32, and
multiplies in f32 (exact products of bf16 values, f32 sums). The caller keeps
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from nerfpp_tpu_torch import resolve_device


def xavier_normal_(w: torch.Tensor, gain: float,
                   generator: torch.Generator) -> None:
    """std = gain * sqrt(2 / (fan_in + fan_out)), drawn on the CPU generator
    so a seed gives the same weights on every device."""
    fan_out, fan_in = w.shape
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) * std)


def dense(x: torch.Tensor, w: torch.Tensor,
          compute_dtype: Optional[str] = None) -> torch.Tensor:
    """x [N, in] @ w.T with w [out, in] (nn.Linear layout)."""
    if compute_dtype == "bfloat16":
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    elif compute_dtype not in (None, "float32"):
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return x @ w.t()


class MLP(nn.Module):
    """Bias-free dense layers, ReLU between them, none after the last."""

    def __init__(self, dims: Sequence[int], compute_dtype: Optional[str] = None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=False, device=dev)
            for i in range(len(dims) - 1))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, gain: float,
                         generator: torch.Generator) -> None:
        for layer in self.layers:
            xavier_normal_(layer.weight, gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = dense(x, layer.weight, self.compute_dtype)
            if i != len(self.layers) - 1:
                x = torch.relu(x)
        return x
