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
- ``grad_small`` (csrc/grad_small.cu): the f32 table gradient, each point's
  8 corners getting ``w_corner * g``. The JAX package computes it outside
  Pallas, as a factorised bf16 one-hot matmul (ops/scatter_matmul.py,
  called from encoders/hashgrid.py's custom VJP).
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

import torch

from nerfpp_tpu_torch.encoders.hashgrid import (gather_trilerp_reference,
                                               trilerp_weights)
from nerfpp_tpu_torch.kernels.build import load
from nerfpp_tpu_torch.kernels.hash_encode_blocked import (_check, _launch,
                                                          pack_table_bf16,
                                                          unpack_table_bf16)

MAX_TABLE_BYTES = 4 * 1024 * 1024    # the JAX kernel's VMEM-resident limit
PLAIN_CHUNK = 1 << 20                # points per plain step (bounds memory)
GRAD_LEVELS_MAX = 47                 # grad_small's cotangent tile in 48 KB


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

def encode_small_plain(table: torch.Tensor, points: torch.Tensor, enc,
                       packed: bool) -> torch.Tensor:
    """Gather + trilinear blend with f32 weights over the bf16-unpacked
    (``packed``: table [R] int32) or the f32 table ([R, 2]). points: [N, 3]
    clamped. Returns [N, 2L] level-major, feature-minor."""
    tab = unpack_table_bf16(table) if packed else table
    outs = []
    for i in range(0, points.shape[0], PLAIN_CHUNK):
        idx, frac = enc.corner_indices(points[i:i + PLAIN_CHUNK])
        outs.append(gather_trilerp_reference(tab, idx, frac)
                    .reshape(idx.shape[0], -1))
    if not outs:
        return points.new_zeros((0, 2 * enc.n_levels))
    return torch.cat(outs) if len(outs) != 1 else outs[0]


def encode_small(table: torch.Tensor, points: torch.Tensor, enc,
                 packed: bool = True) -> torch.Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors. table: packed
    [L*T] int32 or f32 [L*T, 2]; points: [N, 3] f32 clamped."""
    if points.device.type == "cpu":
        return encode_small_plain(table, points, enc, packed)
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
    _launch(load("encode_small").encode_small_launch,
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.level_geom.data_ptr()),
            ctypes.c_void_p(enc.primes_bits.data_ptr()), *_geometry_args(enc),
            ctypes.c_int(n), ctypes.c_int(nl), ctypes.c_int(enc.level_size),
            ctypes.c_int(_scheme_id(enc)), ctypes.c_int(int(packed)),
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

def grad_small_plain(g: torch.Tensor, points: torch.Tensor, enc
                     ) -> torch.Tensor:
    """index_add_ of w_corner * g over corner_indices: the table gradient of
    the f32 gather (the XLA-autodiff oracle). g: [N, 2L]; points: [N, 3]
    clamped. Returns [L * T, 2] f32."""
    n, nl = g.shape[0], enc.n_levels
    out = torch.zeros((enc.table_rows, 2), dtype=torch.float32,
                      device=points.device)
    for i in range(0, n, PLAIN_CHUNK):
        idx, frac = enc.corner_indices(points[i:i + PLAIN_CHUNK])
        gl = g[i:i + PLAIN_CHUNK].float().reshape(-1, nl, 1, 2)
        vals = trilerp_weights(frac)[..., None] * gl            # [c, L, 8, 2]
        out.index_add_(0, idx.reshape(-1), vals.reshape(-1, 2))
    return out


def grad_small(g: torch.Tensor, points: torch.Tensor, enc) -> torch.Tensor:
    """The gradient kernel on CUDA tensors, the plain version on CPU
    tensors. g: [N, 2L] f32; points: [N, 3] f32 clamped."""
    if points.device.type == "cpu":
        return grad_small_plain(g, points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    dev, n, nl = points.device, points.shape[0], enc.n_levels
    _check_enc(enc, dev)
    if nl > GRAD_LEVELS_MAX:
        raise ValueError(f"{nl} levels exceed the kernel's shared memory")
    _check(g, "cotangent", torch.float32, (n, 2 * nl), dev)
    _check(points, "points", torch.float32, (n, 3), dev)
    out = torch.zeros((enc.table_rows, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    _launch(load("grad_small").grad_small_launch,
            ctypes.c_void_p(g.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.level_geom.data_ptr()),
            ctypes.c_void_p(enc.primes_bits.data_ptr()), *_geometry_args(enc),
            ctypes.c_int(n), ctypes.c_int(nl), ctypes.c_int(enc.level_size),
            ctypes.c_int(_scheme_id(enc)), ctypes.c_void_p(out.data_ptr()))
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
