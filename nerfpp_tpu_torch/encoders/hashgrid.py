"""Multiresolution hash-grid encoder (port of
nerfpp_tpu/encoders/hashgrid.py): the blocked, fixed and random schemes.

Blocked: each level's 2^T entries are 4^3-cell blocks with a one-vertex halo:
5^3 = 125 vertices in one 128-lane table row, so all 8 trilinear corners of a
cell live in one row at lanes u*25 + v*5 + w. Rows are addressed by the Morton
code of per-level-offset block coordinates:
slot = morton3(cell // 4 + offset_l) & (S - 1), S = 2^T / 128.

Fixed (the reference's CPU variant): integer per-level resolutions
floor(base * b^l), corners hashed with the fixed prime triplet,
xor(x * 1, y * 2654435761, z * 805459861) & (2^T - 1). Random (the CUDA
variant): exp-spaced level scales, per-level random prime triplets from
[2^28, 2^30), hash % level_size with level_size = (2^T >> 4) << 4. PyTorch has
no uint32 arithmetic: the hash wraps in int64, ``& 0xFFFFFFFF`` after each
product (corner coordinates are below 2^21 and primes below 2^32, so no
product overflows).

Level scales, block offsets and primes are drawn exactly as the JAX package
draws them (np.random.RandomState), so a [L * T, 2] table moves between the
two packages unchanged.

Cell arithmetic follows what ``jax.jit(enc.corner_indices)`` computes, which
is not the line as written: XLA folds a division by a constant into a
multiply by its f32 reciprocal. Blocked and random: (x - min) * inv_ext *
scale with inv_ext = f32(1) / f32(max - min). Fixed: (x - min) / cell with
cell = f32(extent * f32(1 / res)). The plain versions and the CUDA kernels
compute exactly these forms, so cell indices match the jitted oracle bit for
bit.
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


# Fixed primes of the reference's CPU variant (index 0..6 for up to 7-D)
FIXED_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
                2165219737)
U32 = 0xFFFFFFFF


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def draw_random_primes(seed: int, n_levels: int) -> np.ndarray:
    """Per-level random prime triplets [L, 3] uint32 from [2^28, 2^30), the
    JAX package's draws from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    primes = []
    while len(primes) < 3 * n_levels:
        val = int(rng.randint(1 << 28, 1 << 30))
        if _is_prime(val):
            primes.append(val)
    return np.asarray(primes, np.uint32).reshape(n_levels, 3)


def fixed_resolutions_of(n_levels: int, base_resolution: int,
                         finest_resolution: int) -> np.ndarray:
    """Per-level integer resolutions floor(base * b^l) of the fixed scheme."""
    b = np.exp((np.log(finest_resolution) - np.log(base_resolution))
               / max(n_levels - 1, 1))
    return np.floor(base_resolution * b ** np.arange(n_levels)).astype(
        np.int64)


def hash_corners(corners: torch.Tensor, primes: torch.Tensor) -> torch.Tensor:
    """uint32 xor-of-products hash in int64. corners [..., 3] non-negative,
    primes [..., 3] (broadcast) -> [...] in [0, 2^32)."""
    h = (corners[..., 0] * primes[..., 0]) & U32
    h = h ^ ((corners[..., 1] * primes[..., 1]) & U32)
    return h ^ ((corners[..., 2] * primes[..., 2]) & U32)


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
    """Multiresolution hash encoder; the table is a parameter.

    ``use_kernel`` routes the forward through the hand-written CUDA kernels
    of the JAX package's Pallas path (blocked: kernels/hash_encode_blocked.py;
    fixed and random: the small-table kernel of kernels/hash_encode.py, which
    accepts exactly what the JAX package's fused kernel accepts). Without it
    the encoder reads the f32 table of any size, the JAX XLA path, through
    the large-table kernels (kernels/hash_encode_large.py). Every wrapper
    runs its plain version on CPU tensors and its kernel on CUDA tensors.
    """

    def __init__(self, bounding_box, n_levels: int = 16,
                 n_features_per_level: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, finest_resolution: int = 512,
                 scheme: str = "blocked", primes_seed: int = 0,
                 use_kernel: bool = True, device="cuda"):
        super().__init__()
        if scheme not in ("fixed", "random", "blocked"):
            raise ValueError(f"unknown hash scheme {scheme!r}")
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
        self.resolutions = self.level_scales = self.primes = None
        # f32 reciprocal of the extent: the division XLA folds (see module doc)
        self.inv_extent = (np.float32(1.0) / (bb[3:] - bb[:3])).astype(
            np.float32)
        if scheme == "blocked":
            if log2_hashmap_size < 7:
                raise ValueError("blocked scheme requires "
                                 "log2_hashmap_size >= 7")
            self.level_scales = level_scales_of(n_levels, base_resolution,
                                                finest_resolution)
            if float(self.level_scales[-1]) / BLOCK_CELLS + 2 > 1024:
                raise ValueError("blocked scheme supports finest_resolution "
                                 "up to 4x Morton range (~4096)")
            self.level_size = 1 << log2_hashmap_size
            self.block_slots = self.level_size // BLOCK_LANES      # S, pow2
            self.block_offsets = block_offsets_of(primes_seed, n_levels)
            self.register_buffer("boffs", torch.tensor(self.block_offsets,
                                                       device=dev),
                                 persistent=False)
            self.register_buffer("scales", torch.tensor(self.level_scales,
                                                        device=dev),
                                 persistent=False)
            # the scale per (level, axis), for the large-table kernels
            self.register_buffer("level_geom", torch.tensor(
                np.repeat(self.level_scales[:, None], 3, axis=1), device=dev),
                persistent=False)
        elif scheme == "fixed":
            self.resolutions = fixed_resolutions_of(
                n_levels, base_resolution, finest_resolution)
            self.level_size = 1 << log2_hashmap_size
            primes = np.tile(np.asarray(FIXED_PRIMES[:3], np.uint32),
                             (n_levels, 1))
            # cell = f32(extent * f32(1 / res)), XLA's folded grid size
            ext = (bb[3:] - bb[:3]).astype(np.float32)
            inv_res = (np.float32(1.0)
                       / self.resolutions.astype(np.float32))
            per_level = (ext[None, :] * inv_res[:, None]).astype(np.float32)
        else:
            self.level_scales = level_scales_of(n_levels, base_resolution,
                                                finest_resolution)
            self.level_size = ((1 << log2_hashmap_size) >> 4) << 4
            if self.level_size == 0:
                raise ValueError("random scheme requires "
                                 "log2_hashmap_size >= 4")
            self.primes = draw_random_primes(primes_seed, n_levels)
            primes = self.primes
            per_level = np.repeat(self.level_scales[:, None], 3, axis=1)
        if scheme != "blocked":
            # the kernel's & (size - 1) equals % size only for a power of 2
            assert self.level_size & (self.level_size - 1) == 0
            self.register_buffer("primes_t", torch.tensor(
                primes.astype(np.int64), device=dev), persistent=False)
            # the same primes as uint32 bit patterns, for the CUDA kernels
            self.register_buffer("primes_bits", torch.tensor(
                primes.astype(np.uint32).view(np.int32), device=dev),
                persistent=False)
            # per (level, axis): the scale (random) or the cell size (fixed)
            self.register_buffer("level_geom", torch.tensor(
                np.ascontiguousarray(per_level, np.float32), device=dev),
                persistent=False)
            if use_kernel:
                from nerfpp_tpu_torch.kernels.hash_encode import (
                    check_supported)
                check_supported(n_levels, self.level_size,
                                n_features_per_level)
        self.table_rows = n_levels * self.level_size
        self.register_buffer("box_min", torch.tensor(bb[:3], device=dev),
                             persistent=False)
        self.register_buffer("box_max", torch.tensor(bb[3:], device=dev),
                             persistent=False)
        self.register_buffer("inv_ext", torch.tensor(self.inv_extent,
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
        """Flat [L * T] entry indices of the 8 corners (int64 [N, L, 8])
        and the in-cell fractions [N, L, 3]."""
        if self.scheme != "blocked":
            return self._corner_indices_hashed(x)
        cell, frac = self.blocked_cell_frac(x)
        slot = self.blocked_slot(cell).to(torch.int64)               # [N, L]
        local = (cell % BLOCK_CELLS).to(torch.int64)
        base_lane = local[..., 0] * 25 + local[..., 1] * 5 + local[..., 2]
        lane = base_lane[..., None] + torch.tensor(
            CORNER_LANE_OFFSETS, dtype=torch.int64, device=x.device)
        level_offset = (torch.arange(self.n_levels, device=x.device)
                        * self.level_size)[None, :, None]
        return slot[..., None] * BLOCK_LANES + lane + level_offset, frac

    # -- fixed and random geometry ---------------------------------------

    def hashed_rel(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 3] (clamped) -> cell coordinates [N, L, 3] in XLA's
        folded form (module doc)."""
        d = x[:, None, :] - self.box_min
        if self.scheme == "fixed":
            return d / self.level_geom
        return (d * self.inv_ext) * self.level_geom

    def _corner_indices_hashed(self, x: torch.Tensor):
        rel = self.hashed_rel(x)
        bottom = torch.floor(rel)
        frac = rel - bottom
        corners = (bottom.to(torch.int64)[:, :, None, :]
                   + torch.as_tensor(_CORNER_OFFSETS, device=x.device))
        h = hash_corners(corners, self.primes_t[None, :, None, :])
        if self.scheme == "fixed":
            idx = h & (self.level_size - 1)
        else:
            idx = h % self.level_size
        level_offset = (torch.arange(self.n_levels, device=x.device)
                        * self.level_size)[None, :, None]
        return idx + level_offset, frac

    # -- forward -------------------------------------------------------------

    def forward(self, x: torch.Tensor):
        """x: [N, 3] -> (features [N, L*F] level-major, keep_mask [N]).
        Out-of-bbox points are clamped; keep_mask marks the inside ones."""
        inside = (x >= self.box_min) & (x <= self.box_max)
        keep_mask = inside.all(dim=-1)
        xc = torch.minimum(torch.maximum(x, self.box_min), self.box_max)
        if self.use_kernel and self.scheme == "blocked":
            from nerfpp_tpu_torch.kernels.hash_encode_blocked import (
                hash_encode_blocked)
            return hash_encode_blocked(self.table, xc, self), keep_mask
        if self.use_kernel:
            from nerfpp_tpu_torch.kernels.hash_encode import hash_encode_small
            return hash_encode_small(self.table, xc, self), keep_mask
        from nerfpp_tpu_torch.kernels.hash_encode_large import (
            hash_encode_large)
        return hash_encode_large(self.table, xc, self), keep_mask


def total_variation_loss(encoder: HashGridEncoder, table: torch.Tensor,
                         level: int, min_vertex: torch.Tensor
                         ) -> torch.Tensor:
    """Random-cube total variation of one level of a fixed-scheme table:
    the lattice points of a cube of static size floor(clip(res / 10, base -
    1, finest - 1)) from ``min_vertex`` (int [3], drawn in [0, max(res -
    cube, 1)) by the caller, see ``tv_cube_size``), hashed with the fixed
    primes; squared feature differences along each axis over the cube size.
    """
    if encoder.scheme != "fixed":
        raise ValueError("total_variation_loss follows the fixed-prime "
                         "scheme")
    res, cube = tv_cube_size(encoder, level)
    ar = torch.arange(cube + 1, device=table.device)
    mv = min_vertex.to(device=table.device, dtype=torch.int64)
    grid = torch.stack(torch.meshgrid(mv[0] + ar, mv[1] + ar, mv[2] + ar,
                                      indexing="ij"), dim=-1)  # [c, c, c, 3]
    h = hash_corners(grid, encoder.primes_t[level])
    idx = (h & (encoder.level_size - 1)) + level * encoder.level_size
    emb = table[idx].float()                                  # [c, c, c, F]
    tv_x = torch.sum((emb[1:] - emb[:-1]) ** 2)
    tv_y = torch.sum((emb[:, 1:] - emb[:, :-1]) ** 2)
    tv_z = torch.sum((emb[:, :, 1:] - emb[:, :, :-1]) ** 2)
    return (tv_x + tv_y + tv_z) / cube


def tv_cube_size(encoder: HashGridEncoder, level: int):
    """(resolution, cube size) of the TV loss at ``level``; the cube's
    origin is drawn per axis from [0, max(res - cube, 1))."""
    res = int(encoder.resolutions[level])
    cube = int(np.floor(np.clip(res / 10.0, encoder.base_resolution - 1,
                                encoder.finest_resolution - 1)))
    return res, cube
