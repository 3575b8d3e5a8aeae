"""Large-table hash-encode kernels: wrappers, plain versions, autograd.

Port of the JAX package's XLA path of the hash encoder
(``use_pallas_encoder=False``; nerfpp_tpu/encoders/hashgrid.py:408
``gather_trilerp_reference`` after ``corner_indices``, and the XLA
scatter-add that autodiff makes of it), which ``hashnerf_preset()`` runs
with 16 levels x 2^19 f32 entries, a 64 MiB table:

- ``encode_large`` (csrc/encode_large.cu): the 8 corners of each point's
  cell per level, read from the f32 table in global memory and blended with
  f32 trilinear weights. Fixed, random and blocked schemes, any power-of-two
  level size.
- ``grad_large`` (csrc/grad_large.cu): the table gradient, each corner's
  entry getting ``w_corner * g`` by a float2 global atomic; not bitwise
  repeatable.
- ``HashEncodeLarge`` / ``hash_encode_large``: the differentiable entry
  (points already clamped), the points getting no gradient, as in the
  port's other encoders.

Each wrapper runs its plain PyTorch version for CPU tensors, and launches its
kernel for CUDA tensors or raises; it never falls back. Each keeps a launch
count (``encode_large.launches``, ``grad_large.launches``) that only a kernel
launch increments. The plain versions compute the same cell, hash and weight
arithmetic as the kernels (encoders/hashgrid.py), so both put every point in
the same cell; only the order of the sums differs.
"""
from __future__ import annotations

import ctypes

import torch

from nerfpp_tpu_torch.encoders.hashgrid import (gather_trilerp_reference,
                                               trilerp_weights)
from nerfpp_tpu_torch.kernels.build import load
from nerfpp_tpu_torch.kernels.hash_encode_blocked import _check, _launch

PLAIN_CHUNK = 1 << 20                # points per plain step (bounds memory)
LEVELS_MAX = 64                      # levels the wrappers take
SCHEMES = {"fixed": 0, "random": 1, "blocked": 2}


def encode_large_plain(table: torch.Tensor, points: torch.Tensor, enc
                       ) -> torch.Tensor:
    """corner_indices + gather_trilerp_reference over the f32 table
    [L * T, 2]. points: [N, 3] clamped. Returns [N, 2L] level-major,
    feature-minor."""
    outs = []
    for i in range(0, points.shape[0], PLAIN_CHUNK):
        idx, frac = enc.corner_indices(points[i:i + PLAIN_CHUNK])
        outs.append(gather_trilerp_reference(table, idx, frac)
                    .reshape(idx.shape[0], -1))
    if not outs:
        return points.new_zeros((0, 2 * enc.n_levels))
    return torch.cat(outs) if len(outs) != 1 else outs[0]


def grad_large_plain(g: torch.Tensor, points: torch.Tensor, enc
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


def _args(enc, points: torch.Tensor):
    """Checks common to both kernels; -> (level ints, ctypes geometry)."""
    dev, nl = points.device, enc.n_levels
    if enc.n_features_per_level != 2:
        raise ValueError("the large-table kernels take 2 features a level, "
                         f"not {enc.n_features_per_level}")
    if not 1 <= nl <= LEVELS_MAX:
        raise ValueError(f"the large-table kernels take 1-{LEVELS_MAX} "
                         f"levels, not {nl}")
    ints = enc.boffs if enc.scheme == "blocked" else enc.primes_bits
    _check(enc.level_geom, "level geometry", torch.float32, (nl, 3), dev)
    _check(ints, "level integers", torch.int32, (nl, 3), dev)
    _check(points, "points", torch.float32, (points.shape[0], 3), dev)
    vals = [float(v) for v in enc.bounding_box[:3]]
    vals += [float(v) for v in enc.inv_extent]
    return ints, [ctypes.c_float(v) for v in vals]


def _aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"the {name} must be 16-byte aligned")


def encode_large(table: torch.Tensor, points: torch.Tensor, enc
                 ) -> torch.Tensor:
    """The encode kernel on CUDA tensors, the plain version on CPU tensors.
    table: f32 [L * T, 2]; points: [N, 3] f32 clamped."""
    if points.device.type == "cpu":
        return encode_large_plain(table, points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ints, geom = _args(enc, points)
    dev, n, nl = points.device, points.shape[0], enc.n_levels
    _check(table, "table", torch.float32, (enc.table_rows, 2), dev)
    _aligned(table, "table")
    out = torch.empty((n, 2 * nl), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    _launch(load("encode_large").encode_large_launch,
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.level_geom.data_ptr()),
            ctypes.c_void_p(ints.data_ptr()), *geom, ctypes.c_longlong(n),
            ctypes.c_int(nl), ctypes.c_int(enc.level_size),
            ctypes.c_int(SCHEMES[enc.scheme]),
            ctypes.c_void_p(out.data_ptr()))
    encode_large.launches += 1
    return out


encode_large.launches = 0


def grad_large(g: torch.Tensor, points: torch.Tensor, enc) -> torch.Tensor:
    """The gradient kernel on CUDA tensors, the plain version on CPU
    tensors. g: [N, 2L] f32; points: [N, 3] f32 clamped."""
    if points.device.type == "cpu":
        return grad_large_plain(g, points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ints, geom = _args(enc, points)
    dev, n, nl = points.device, points.shape[0], enc.n_levels
    _check(g, "cotangent", torch.float32, (n, 2 * nl), dev)
    _aligned(g, "cotangent")
    # the kernel adds into zeros
    out = torch.zeros((enc.table_rows, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    _launch(load("grad_large").grad_large_launch,
            ctypes.c_void_p(g.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.level_geom.data_ptr()),
            ctypes.c_void_p(ints.data_ptr()), *geom, ctypes.c_longlong(n),
            ctypes.c_int(nl), ctypes.c_int(enc.level_size),
            ctypes.c_int(SCHEMES[enc.scheme]),
            ctypes.c_void_p(out.data_ptr()))
    grad_large.launches += 1
    return out


grad_large.launches = 0


class HashEncodeLarge(torch.autograd.Function):
    """Forward: encode_large over the f32 table; backward: grad_large into
    it. The points get no gradient."""

    @staticmethod
    def forward(ctx, table, points, enc):
        pts = points.detach().float().contiguous()
        out = encode_large(table.detach().float().contiguous(), pts, enc)
        ctx.save_for_backward(pts)
        ctx.enc = enc
        ctx.table_dtype = table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (pts,) = ctx.saved_tensors
        gt = grad_large(g.float().contiguous(), pts, ctx.enc)
        return gt.to(ctx.table_dtype), None, None


def hash_encode_large(table: torch.Tensor, points: torch.Tensor, enc
                      ) -> torch.Tensor:
    """Differentiable encode. table: [L * T, 2] f32; points: [N, 3] f32
    already clamped to the bbox. Returns [N, 2L]; a backward pass launches
    grad_large for the table."""
    return HashEncodeLarge.apply(table, points, enc)
