"""Small-table hash-encode kernels: wrappers, plain versions, autograd.

Port of nerfpp_tpu/pallas/hash_encode.py, the fused encode of the fixed and
random hash schemes with the whole table resident on chip:

- ``encode_small`` (csrc/encode_small.cu): hash the 8 corners of each
  point's cell per level and blend them with f32 trilinear weights, from the
  bf16-packed table (``packed``) or the f32 table. Replaces both Pallas
  kernels, ``_hash_encode_v2`` / ``_make_kernel_v2`` (K4) and
  ``hash_encode_fused(version="v1")`` / ``_make_kernel`` (K5): they compute
  the same function, so ``hash_encode_fused`` sends either version to this
  one kernel (v1, as in the JAX package, always reads the f32 table).
  ``small_plan`` is its launch plan: persistent blocks, each staging one
  group of levels' tables once and writing that group's slice of the rows.
- ``grad_small``: the f32 table gradient, each point's 8 corners getting
  ``w_corner * g``. The JAX package computes it outside Pallas, as a
  factorised bf16 one-hot matmul (ops/scatter_matmul.py, called from
  encoders/hashgrid.py's custom VJP). It runs the large-table gradient's
  two kernels (csrc/grad_large.cu through hash_encode_large.grad_hashed:
  the bin pass, counted as grad_large_bins', and the owner pass) at the
  small table's bins of 512 entries, summed in an order fixed by the
  inputs with no float atomics, so two launches give bitwise equal
  gradients (the shared-memory copies flushed by float atomics of the
  earlier csrc/grad_small.cu did not).
- ``HashEncodeSmall`` / ``hash_encode_small``: the differentiable entry
  (points already clamped): the forward packs the table and runs
  ``encode_small``, the backward runs ``grad_small`` straight through the
  packing into the f32 master table and gives the points no gradient.

Each wrapper runs its plain PyTorch version for CPU tensors, and launches its
kernel for CUDA tensors or raises; it never falls back. Each keeps a launch
count (``encode_small.launches``, ``grad_small.launches``) that only a kernel
launch increments.

Numerics: the plain encode is the gather over the bf16-rounded (or f32) table
with f32 trilinear weights, as the CUDA kernel computes it and as the Pallas
kernels do. The Pallas kernels place points by (x - min) * f32(inv_ext *
scale) with the product folded in double; the port uses the jitted XLA form
of encoders/hashgrid.py in the forward and the backward alike, so at a cell
boundary it may pick the neighbouring cell where the Pallas forward does not
(ROADMAP.md, faults). The gradient is f32 throughout (the JAX backward rounds
each term's operands to bf16).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from nerfpp_tpu_torch.kernels.build import load
from nerfpp_tpu_torch.kernels.hash_encode_blocked import (_check, _launch,
                                                          pack_table_bf16,
                                                          unpack_table_bf16)
from nerfpp_tpu_torch.kernels.hash_encode_large import (encode_large_plain,
                                                        grad_hashed,
                                                        grad_large_plain)

MAX_TABLE_BYTES = 4 * 1024 * 1024    # the JAX kernel's VMEM-resident limit
TILE = 1024                          # encode_small's points per tile (ES_TILE)
SMEM_BLOCK_MAX = 232448              # H100: dynamic shared memory per block
SLICE_LEVELS = 4                     # levels whose features fill a sector
SMEM_STATIC = 128                    # encode_small's static shared memory


def supports(n_levels: int, level_size: int, n_features: int) -> bool:
    """Whether the fused kernel takes this table: the JAX package's rule
    (F = 2, level size a multiple of 1,024, whole f32 table <= 4 MB)."""
    return (n_features == 2 and level_size % 1024 == 0
            and n_levels * level_size * n_features * 4 <= MAX_TABLE_BYTES)


def check_supported(n_levels: int, level_size: int, n_features: int):
    if not supports(n_levels, level_size, n_features):
        raise ValueError(
            f"fused kernel requires F=2 and n_levels*T*F*4 <= "
            f"{MAX_TABLE_BYTES} bytes; got L={n_levels} T={level_size}")


def _scheme_id(enc) -> int:
    return {"fixed": 0, "random": 1}[enc.scheme]


def _check_enc(enc, dev):
    if enc.scheme not in ("fixed", "random"):
        raise ValueError(f"scheme {enc.scheme!r} is not a small-table scheme")
    check_supported(enc.n_levels, enc.level_size, enc.n_features_per_level)
    nl = enc.n_levels
    _check(enc.level_geom, "level geometry", torch.float32, (nl, 3), dev)
    _check(enc.primes_bits, "primes", torch.int32, (nl, 3), dev)


def _geometry_args(enc):
    vals = [float(v) for v in enc.bounding_box[:3]]
    vals += [float(v) for v in enc.inv_extent]
    return [ctypes.c_float(v) for v in vals]


# ------------------------------------------------------------ K4 / K5

@dataclass(frozen=True)
class SmallPlan:
    """Launch plan of encode_small. The levels fall into n_groups groups of
    group_levels (the last one shorter); block b serves group b % n_groups
    and the 1,024-point tiles b // n_groups + k * grid / n_groups. A block
    stages the tables of its group's first ``staged_levels`` levels and
    gathers the rest from L2; its stage and its warps' output tiles take
    ``smem`` bytes of shared memory."""
    group_levels: int
    n_groups: int
    staged_levels: int
    smem: int
    grid: int


def small_tile_bytes(group_levels: int) -> int:
    """Bytes of a block's output tiles (csrc/encode_small.cu): 1,024 rows of
    ceil(G / 2) 16-byte chunks."""
    return TILE * ((group_levels + 1) // 2) * 16


def small_stage(n_levels: int, level_size: int, packed: bool):
    """(G, S, smem): levels per group and staged levels per group. Groups
    take the most levels, a power of two up to L, whose tables fit a
    block's shared memory beside the output tiles: all staged. Where that
    leaves fewer than min(4, L) levels a group, each point's row slice
    would be under one 32-byte sector and not the whole row; such groups
    take min(4, L) levels instead, stage as many as fit and gather the
    rest from L2. Levels too large to
    stage at all make one group of every level, gathered from L2, written
    as whole rows (at most 16 levels: supports() admits no more of a level
    that large)."""
    level_bytes = level_size * (4 if packed else 8)

    def budget(g):
        return SMEM_BLOCK_MAX - SMEM_STATIC - small_tile_bytes(g)
    g, c = 0, 1
    while c <= n_levels and c * level_bytes <= budget(c):
        g, c = c, 2 * c
    if g == 0:
        return n_levels, 0, small_tile_bytes(n_levels)
    g = max(g, min(SLICE_LEVELS, n_levels))
    staged = min(g, budget(g) // level_bytes)
    return g, staged, staged * level_bytes + small_tile_bytes(g)


def encode_small_plain(table: torch.Tensor, points: torch.Tensor, enc,
                       packed: bool) -> torch.Tensor:
    """Gather + trilinear blend with f32 weights over the bf16-unpacked
    (``packed``: table [R] int32) or the f32 table ([R, 2]): the large-table
    plain version over that table. points: [N, 3] clamped. Returns [N, 2L]
    level-major, feature-minor."""
    return encode_large_plain(unpack_table_bf16(table) if packed else table,
                              points, enc)


def small_plan(n: int, n_levels: int, level_size: int, packed: bool,
               blocks: int) -> SmallPlan:
    """encode_small's launch plan for n points: the groups of small_stage,
    and as many persistent blocks as the card holds at once (``blocks``),
    a multiple of the group count (at least one block per group), but no
    more than the groups times the 1,024-point tiles."""
    g, staged, smem = small_stage(n_levels, level_size, packed)
    if smem + SMEM_STATIC > SMEM_BLOCK_MAX:
        raise ValueError(f"encode_small needs {smem} bytes of shared memory "
                         "per block")
    n_groups = -(-n_levels // g)
    tiles = max(1, -(-n // TILE))
    per_group = max(1, min(tiles, blocks // n_groups))
    return SmallPlan(g, n_groups, staged, smem, per_group * n_groups)


@functools.lru_cache(maxsize=None)
def _resident_blocks(scheme: int, packed: bool, group_levels: int,
                     staged_levels: int, smem: int) -> int:
    """Blocks of the kernel variant that the card holds at once (registers
    included): blocks per SM times the SM count."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    err = load("encode_small").encode_small_occupancy(
        ctypes.c_int(scheme), ctypes.c_int(int(packed)),
        ctypes.c_int(group_levels), ctypes.c_int(staged_levels),
        ctypes.c_int(smem), ctypes.byref(per_sm),
        ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"CUDA occupancy query failed with cudaError_t "
                           f"{err}")
    if per_sm.value < 1:
        raise ValueError(f"encode_small cannot launch a block with {smem} "
                         "bytes of shared memory")
    return per_sm.value * sms.value


def device_small_plan(n: int, enc, packed: bool, device) -> SmallPlan:
    """small_plan with the card's occupancy of the kernel."""
    return _device_small_plan(n, enc.n_levels, enc.level_size,
                              _scheme_id(enc), packed, torch.device(device))


@functools.lru_cache(maxsize=256)
def _device_small_plan(n, n_levels, level_size, scheme, packed, device):
    g, staged, smem = small_stage(n_levels, level_size, packed)
    with torch.cuda.device(device):
        blocks = _resident_blocks(scheme, packed, g, staged, smem)
    return small_plan(n, n_levels, level_size, packed, blocks)


def encode_small(table: torch.Tensor, points: torch.Tensor, enc,
                 packed: bool = True) -> torch.Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors. table: packed
    [L*T] int32 or f32 [L*T, 2]; points: [N, 3] f32 clamped."""
    if points.device.type == "cpu":
        return encode_small_plain(table, points, enc, packed)
    return encode_small_planned(table, points, enc, packed, None)


def encode_small_planned(table: torch.Tensor, points: torch.Tensor, enc,
                         packed: bool, plan: SmallPlan | None
                         ) -> torch.Tensor:
    """K4's launch on CUDA tensors with ``plan`` (None: device_small_plan),
    so that a script can time other plans; counts as encode_small's."""
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    dev, n, nl = points.device, points.shape[0], enc.n_levels
    _check_enc(enc, dev)
    if packed:
        _check(table, "packed table", torch.int32, (enc.table_rows,), dev)
    else:
        _check(table, "table", torch.float32, (enc.table_rows, 2), dev)
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    _check(points, "points", torch.float32, (n, 3), dev)
    out = torch.empty((n, 2 * nl), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    if plan is None:
        plan = device_small_plan(n, enc, packed, dev)
    _launch(load("encode_small").encode_small_launch,
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.level_geom.data_ptr()),
            ctypes.c_void_p(enc.primes_bits.data_ptr()), *_geometry_args(enc),
            ctypes.c_int(n), ctypes.c_int(nl), ctypes.c_int(enc.level_size),
            ctypes.c_int(_scheme_id(enc)), ctypes.c_int(int(packed)),
            ctypes.c_int(plan.group_levels), ctypes.c_int(plan.staged_levels),
            ctypes.c_int(plan.grid), ctypes.c_int(plan.smem),
            ctypes.c_void_p(out.data_ptr()))
    encode_small.launches += 1
    return out


encode_small.launches = 0


def hash_encode_fused(table: torch.Tensor, points: torch.Tensor, enc,
                      version: str = "v2", packed: bool = True
                      ) -> torch.Tensor:
    """The JAX package's entry: f32 table [L*T, 2], points [N, 3] clamped ->
    [N, 2L]. v2 packs the table to bf16 pairs when ``packed``; v1 reads the
    f32 table. Both run encode_small."""
    if version not in ("v1", "v2"):
        raise ValueError(f"unknown version {version!r}")
    packed = packed and version == "v2"
    tab = pack_table_bf16(table) if packed else table.float().contiguous()
    return encode_small(tab, points.float().contiguous(), enc, packed)


# ------------------------------------------------------------ gradient

# the table gradient of the f32 gather (the XLA-autodiff oracle), the same
# function for a table of any size
grad_small_plain = grad_large_plain


def grad_small(g: torch.Tensor, points: torch.Tensor, enc) -> torch.Tensor:
    """The gradient kernels on CUDA tensors, the plain version on CPU
    tensors. g: [N, 2L] f32; points: [N, 3] f32 clamped. Two launches on
    the same inputs give bitwise equal results."""
    if points.device.type == "cpu":
        return grad_small_plain(g, points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_enc(enc, points.device)
    out = grad_hashed(g, points, enc)
    if points.shape[0]:
        grad_small.launches += 1
    return out


grad_small.launches = 0


# ------------------------------------------------------------ entry

class HashEncodeSmall(torch.autograd.Function):
    """Forward: encode_small over the bf16-packed table (the JAX encoder's
    default, ``pallas_packed=True``); backward:
    grad_small into the f32 master table, straight through the packing.
    The points get no gradient, as in the JAX custom_vjp."""

    @staticmethod
    def forward(ctx, table, points, enc):
        pts = points.detach().float().contiguous()
        out = hash_encode_fused(table.detach(), pts, enc, "v2", packed=True)
        ctx.save_for_backward(pts)
        ctx.enc = enc
        ctx.table_dtype = table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (pts,) = ctx.saved_tensors
        gt = grad_small(g.float().contiguous(), pts, ctx.enc)
        return gt.to(ctx.table_dtype), None, None


def hash_encode_small(table: torch.Tensor, points: torch.Tensor, enc
                      ) -> torch.Tensor:
    """Differentiable encode. table: [L * T, 2] f32; points: [N, 3] f32
    already clamped to the bbox. Returns [N, 2L]; a backward pass launches
    grad_small for the table."""
    return HashEncodeSmall.apply(table, points, enc)
