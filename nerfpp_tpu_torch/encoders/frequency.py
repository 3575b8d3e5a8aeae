"""Frequency (sinusoidal) positional encoding of classic NeRF (port of
nerfpp_tpu/encoders/frequency.py): optional input passthrough, then per band
f: sin(x * f), cos(x * f). Bands are log-spaced 2^(max_freq * i / (N - 1))
or linearly spaced from 2^0 to 2^max_freq, computed in double and stored as
f32 as the JAX module stores them. Output order [x, sin(f0 x), cos(f0 x),
sin(f1 x), cos(f1 x), ...]."""
from __future__ import annotations

import numpy as np
import torch


class FrequencyEncoder:
    """Stateless encoder; construction fixes the band list."""

    def __init__(self, num_freqs: int, max_freq_log2: float,
                 include_input: bool = True, input_dims: int = 3,
                 log_sampling: bool = True):
        self.num_freqs = num_freqs
        self.include_input = include_input
        self.input_dims = input_dims
        if num_freqs > 1:
            if log_sampling:
                bands = [2.0 ** (max_freq_log2 / (num_freqs - 1) * i)
                         for i in range(num_freqs)]
            else:
                bands = [1.0 + (2.0 ** max_freq_log2 - 1.0) / (num_freqs - 1)
                         * i for i in range(num_freqs)]
        else:
            bands = [1.0] * num_freqs
        self.freq_bands = np.asarray(bands, np.float32)
        self.output_dims = ((input_dims if include_input else 0)
                            + num_freqs * 2 * input_dims)

    def __call__(self, x: torch.Tensor):
        """x: [..., input_dims] -> (embedding [..., output_dims], None)."""
        bands = torch.as_tensor(self.freq_bands, device=x.device)
        scaled = x[..., None, :] * bands[:, None]                  # [..., F, D]
        per_band = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
        flat = per_band.reshape(*x.shape[:-1], -1)                 # [..., F*2D]
        if self.include_input:
            flat = torch.cat([x, flat], dim=-1)
        return flat, None
