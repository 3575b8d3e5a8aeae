"""Multiresolution hash-grid encoder, blocked scheme (port of
nerfpp_tpu/encoders/hashgrid.py).

The blocked scheme organises each level's 2^T entries as 4^3-cell blocks with
a one-vertex halo: 5^3 = 125 vertices in one 128-lane table row, so all 8
trilinear corners of a cell live in one row at lanes u*25 + v*5 + w. Rows are
addressed by the Morton code of per-level-offset block coordinates:
slot = morton3(cell // 4 + offset_l) & (S - 1), S = 2^T / 128.

Level scales and block offsets are drawn exactly as the JAX package draws them
(np.random.RandomState(primes_seed + 7)), so a [L * 2^T, 2] table moves
between the two packages unchanged.

Cell arithmetic: the JAX oracle writes (x - min) / (max - min) * scale, and
under jit XLA folds the division by the constant extent into a multiply by its
f32 reciprocal. The port computes that folded form, (x - min) * inv_ext *
scale with inv_ext = f32(1) / f32(max - min), in both the plain version and
the CUDA kernels, so cell indices match the jitted oracle bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerfpp_tpu_torch import resolve_device

BLOCK_CELLS = 4
BLOCK_LANES = 128
# 8 corner offsets, z fastest: corner d has bits (x, y, z) = (d>>2, d>>1, d)&1
_CORNER_OFFSETS = np.array(
    [[(d >> 2) & 1, (d >> 1) & 1, d & 1] for d in range(8)], np.int64)
CORNER_LANE_OFFSETS = tuple(int(dx * 25 + dy * 5 + dz)
                            for (dx, dy, dz) in _CORNER_OFFSETS)


def morton3(x, y, z):
    """Interleave the low 10 bits of three non-negative ints (torch or numpy):
    bit 3i of the result is bit i of x, 3i+1 of y, 3i+2 of z."""
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def level_scales_of(n_levels: int, base_resolution: int,
                    finest_resolution: int) -> np.ndarray:
    """Exp-spaced per-level scales, hit exactly at both ends."""
    l = np.arange(n_levels, dtype=np.float64)
    log2b, log2f = np.log2(base_resolution), np.log2(finest_resolution)
    return np.exp2((log2f - log2b) * l / max(n_levels - 1, 1)
                   + log2b).astype(np.float32)


def block_offsets_of(primes_seed: int, n_levels: int) -> np.ndarray:
    """Per-level random block offsets [L, 3] int32."""
    rng = np.random.RandomState(primes_seed + 7)
    return rng.randint(0, 1 << 10, size=(n_levels, 3)).astype(np.int32)


def trilerp_weights(frac: torch.Tensor) -> torch.Tensor:
    """frac: [..., 3] -> [..., 8] corner weights, (wx * wy) * wz, z fastest."""
    a, b, c = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    wx = torch.cat([1.0 - a, a], dim=-1)
    wy = torch.cat([1.0 - b, b], dim=-1)
    wz = torch.cat([1.0 - c, c], dim=-1)
    w = wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    return w.reshape(*frac.shape[:-1], 8)


def gather_trilerp_reference(table: torch.Tensor, idx: torch.Tensor,
                             frac: torch.Tensor) -> torch.Tensor:
    """Plain gather + trilinear blend. table [R, F], idx [N, L, 8] (int64),
    frac [N, L, 3] -> [N, L, F] f32."""
    w = trilerp_weights(frac)                                # [N, L, 8]
    outs = [torch.sum(table[:, c][idx].float() * w, dim=-1)
            for c in range(table.shape[-1])]
    return torch.stack(outs, dim=-1)


class HashGridEncoder(nn.Module):
    """Blocked multiresolution hash encoder; the table is a parameter.

    ``use_kernel`` routes the forward through the hand-written CUDA kernel
    pair (kernels/hash_encode_blocked.py: bf16-packed table, f32 weights),
    whose wrappers run their plain versions on CPU tensors. Without it the
    plain gather reads the f32 table (the JAX XLA path); that function has
    no CUDA kernel, so it runs on CPU tensors only and raises on CUDA ones.
    """

    def __init__(self, bounding_box, n_levels: int = 16,
                 n_features_per_level: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, finest_resolution: int = 512,
                 scheme: str = "blocked", primes_seed: int = 0,
                 use_kernel: bool = True, device="cuda"):
        super().__init__()
        if scheme in ("fixed", "random"):
            raise NotImplementedError(
                f"hash scheme {scheme!r} belongs to the small-table slice of "
                "the port (kernel K4), not yet ported; use scheme='blocked'")
        if scheme != "blocked":
            raise ValueError(f"unknown hash scheme {scheme!r}")
        if log2_hashmap_size < 7:
            raise ValueError("blocked scheme requires log2_hashmap_size >= 7")
        dev = resolve_device(device)
        bb = np.asarray(bounding_box, np.float32).reshape(6)
        self.bounding_box = bb
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.finest_resolution = finest_resolution
        self.scheme = scheme
        self.use_kernel = use_kernel
        self.output_dims = n_levels * n_features_per_level
        self.level_scales = level_scales_of(n_levels, base_resolution,
                                            finest_resolution)
        if float(self.level_scales[-1]) / BLOCK_CELLS + 2 > 1024:
            raise ValueError("blocked scheme supports finest_resolution "
                             "up to 4x Morton range (~4096)")
        self.level_size = 1 << log2_hashmap_size
        self.block_slots = self.level_size // BLOCK_LANES         # S, pow2
        self.block_offsets = block_offsets_of(primes_seed, n_levels)
        self.table_rows = n_levels * self.level_size
        # f32 reciprocal of the extent: the division XLA folds (see module doc)
        self.inv_extent = (np.float32(1.0) / (bb[3:] - bb[:3])).astype(
            np.float32)
        self.register_buffer("box_min", torch.tensor(bb[:3], device=dev),
                             persistent=False)
        self.register_buffer("box_max", torch.tensor(bb[3:], device=dev),
                             persistent=False)
        self.register_buffer("inv_ext", torch.tensor(self.inv_extent,
                                                     device=dev),
                             persistent=False)
        self.register_buffer("scales", torch.tensor(self.level_scales,
                                                    device=dev),
                             persistent=False)
        self.register_buffer("boffs", torch.tensor(self.block_offsets,
                                                   device=dev),
                             persistent=False)
        self.table = nn.Parameter(torch.zeros(
            self.table_rows, n_features_per_level, device=dev))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Uniform(-1e-4, 1e-4) table, drawn on the CPU generator so a seed
        gives the same table on every device."""
        t = torch.rand(self.table.shape, generator=generator) * 2e-4 - 1e-4
        self.table.copy_(t)

    # -- blocked geometry --------------------------------------------------

    def blocked_cell_frac(self, x: torch.Tensor):
        """x: [N, 3] (clamped) -> (cell [N, L, 3] int32, frac [N, L, 3])."""
        rel = (x[:, None, :] - self.box_min) * self.inv_ext
        rel = rel * self.scales[:, None]
        cell = torch.floor(rel)
        return cell.to(torch.int32), rel - cell

    def blocked_oct(self, cell: torch.Tensor) -> torch.Tensor:
        """Offset block coords [..., L, 3]; >> 1 gives the 2x2x2 window cube."""
        return (cell >> 2) + self.boffs

    def blocked_slot(self, cell: torch.Tensor) -> torch.Tensor:
        ob = self.blocked_oct(cell)
        m = morton3(ob[..., 0], ob[..., 1], ob[..., 2])
        return m & (self.block_slots - 1)

    def corner_indices(self, x: torch.Tensor):
        """Flat [L * 2^T] entry indices of the 8 corners (int64 [N, L, 8])
        and the in-cell fractions [N, L, 3]."""
        cell, frac = self.blocked_cell_frac(x)
        slot = self.blocked_slot(cell).to(torch.int64)               # [N, L]
        local = (cell % BLOCK_CELLS).to(torch.int64)
        base_lane = local[..., 0] * 25 + local[..., 1] * 5 + local[..., 2]
        lane = base_lane[..., None] + torch.tensor(
            CORNER_LANE_OFFSETS, dtype=torch.int64, device=x.device)
        level_offset = (torch.arange(self.n_levels, device=x.device)
                        * self.level_size)[None, :, None]
        return slot[..., None] * BLOCK_LANES + lane + level_offset, frac

    # -- forward -------------------------------------------------------------

    def forward(self, x: torch.Tensor):
        """x: [N, 3] -> (features [N, L*F] level-major, keep_mask [N]).
        Out-of-bbox points are clamped; keep_mask marks the inside ones."""
        inside = (x >= self.box_min) & (x <= self.box_max)
        keep_mask = inside.all(dim=-1)
        xc = torch.minimum(torch.maximum(x, self.box_min), self.box_max)
        if self.use_kernel:
            from nerfpp_tpu_torch.kernels.hash_encode_blocked import (
                hash_encode_blocked)
            return hash_encode_blocked(self.table, xc, self), keep_mask
        if x.device.type != "cpu":
            raise NotImplementedError(
                "the f32-table blocked encode (use_pallas_encoder=False) has "
                "no CUDA kernel in nerfpp_tpu_torch; use the bf16 kernel pair "
                "(use_kernel=True / use_pallas_encoder=True) on the GPU")
        idx, frac = self.corner_indices(xc)
        feats = gather_trilerp_reference(self.table, idx, frac)
        return feats.reshape(x.shape[0], self.output_dims), keep_mask
