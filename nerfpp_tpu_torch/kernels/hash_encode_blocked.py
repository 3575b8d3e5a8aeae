"""Blocked hash-encode kernels: wrappers, plain versions, table packing.

Port of nerfpp_tpu/pallas/hash_encode_blocked.py:

- ``window_lists`` (K1, csrc/window_lists.cu): per (128-point group, level)
  the sorted unique 2x2x2-block window Morton codes, sentinel-padded, and the
  unique count. Replaces ``_windows_call`` / ``_make_windows_kernel``.
- ``encode_blocked`` (K2, csrc/encode_blocked.cu): the trilinear blend over
  the bf16-packed table; each 128-point group walks all levels in one team,
  stages the first table rows its window list says it uses, reads the rest
  from L2, and writes its rows in 32-byte slices of 4 levels. Replaces
  ``_fwd_call`` / ``_make_fwd_kernel``.
- ``grad_blocked`` (K3, csrc/grad_blocked.cu): the f32 table gradient, each
  point's 8 corners getting ``w_corner * g``. Replaces ``_bwd_call`` /
  ``_make_bwd_kernel`` (entry ``grad_prepared``).
- ``HashEncodeBlocked`` / ``hash_encode_blocked``: the differentiable entry
  (points already clamped): pack the table, pad to whole groups, run K1 then
  K2; the backward runs K3 for the table and gives the points no gradient.

Each wrapper runs its plain PyTorch version for CPU tensors, and launches its
kernel for CUDA tensors or raises; it never falls back. Each keeps a launch
count (``window_lists.launches``, ``encode_blocked.launches``,
``grad_blocked.launches``) that only a kernel launch increments.

Numerics: the plain encode is the gather over the bf16-rounded table with f32
trilinear weights, as the CUDA kernel computes it. The Pallas kernel instead
rounds each weight to bf16 in its MXU pattern matrix, so against the Pallas
kernel the port differs by up to 8 corners x 2^-9 relative weight error x
|table|max per feature. The gradient is f32 throughout (the Pallas backward
rounds the weight pattern and the cotangent to bf16), and it passes straight
through the bf16 packing to the f32 master table.
"""
from __future__ import annotations

import ctypes

import torch

from nerfpp_tpu_torch.encoders.hashgrid import (gather_trilerp_reference,
                                               morton3, trilerp_weights)
from nerfpp_tpu_torch.kernels.build import load

LANES = 128
SENTINEL = 0x7FFFFFFF
PLAIN_CHUNK = 1 << 20          # points per plain-encode step (bounds memory)


def pack_table_bf16(table: torch.Tensor) -> torch.Tensor:
    """[R, 2] f32 -> [R] int32 holding bf16(f0) in the high and bf16(f1) in
    the low 16 bits (round to nearest even), the bit pattern of the JAX
    package's uint32 packing."""
    halves = torch.stack([table[:, 1], table[:, 0]], dim=-1).to(torch.bfloat16)
    return halves.contiguous().view(torch.int32).reshape(-1)


def unpack_table_bf16(packed: torch.Tensor) -> torch.Tensor:
    """[R] int32 packed pairs -> [R, 2] f32 (the bf16-rounded table)."""
    halves = packed.contiguous().view(torch.bfloat16).reshape(-1, 2).float()
    return torch.stack([halves[:, 1], halves[:, 0]], dim=-1)


def _geometry_args(enc):
    bmin = [float(v) for v in enc.bounding_box[:3]]
    inv = [float(v) for v in enc.inv_extent]
    return [ctypes.c_float(v) for v in bmin + inv]


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, *args):
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA launch failed with cudaError_t {err}")


# ------------------------------------------------------------ K1: prepass

def window_lists_plain(points: torch.Tensor, enc):
    """Direct transcription of build_window_lists. points: [NG*128, 3]
    clamped. Returns (wids [L, NG, 128] int32, counts [L, NG] int32)."""
    ng = points.shape[0] // LANES
    cell, _ = enc.blocked_cell_frac(points)
    oct_ = enc.blocked_oct(cell) >> 1
    m = morton3(oct_[..., 0], oct_[..., 1], oct_[..., 2])          # [N, L]
    m = m.reshape(ng, LANES, enc.n_levels).permute(2, 0, 1)
    s = torch.sort(m, dim=-1).values
    flags = torch.cat([torch.ones_like(s[..., :1], dtype=torch.bool),
                       s[..., 1:] != s[..., :-1]], dim=-1)
    counts = flags.sum(dim=-1).to(torch.int32)
    ids = torch.where(flags, s, torch.full_like(s, SENTINEL))
    ids = torch.sort(ids, dim=-1).values                    # unique ids first
    return ids.to(torch.int32).contiguous(), counts


def window_lists(points: torch.Tensor, enc):
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    if points.device.type == "cpu":
        return window_lists_plain(points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    n = points.shape[0]
    if n % LANES:
        raise ValueError(f"{n} points is not a multiple of {LANES}")
    ng, nl = n // LANES, enc.n_levels
    _check(points, "points", torch.float32, (n, 3), points.device)
    _check(enc.scales, "level scales", torch.float32, (nl,), points.device)
    _check(enc.boffs, "block offsets", torch.int32, (nl, 3), points.device)
    wids = torch.empty((nl, ng, LANES), dtype=torch.int32,
                       device=points.device)
    counts = torch.empty((nl, ng), dtype=torch.int32, device=points.device)
    _launch(load("window_lists").window_lists_launch,
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.scales.data_ptr()),
            ctypes.c_void_p(enc.boffs.data_ptr()), *_geometry_args(enc),
            ctypes.c_int(ng), ctypes.c_int(nl),
            ctypes.c_void_p(wids.data_ptr()),
            ctypes.c_void_p(counts.data_ptr()))
    window_lists.launches += 1
    return wids, counts


window_lists.launches = 0


# ------------------------------------------------------------ K2: encode

def encode_blocked_plain(packed: torch.Tensor, points: torch.Tensor,
                         wids: torch.Tensor, counts: torch.Tensor, enc):
    """Gather + trilinear blend over the bf16-rounded table with f32
    weights. The window lists only steer the kernel's loop; the result does
    not depend on them. Returns [N, 2L] level-major, feature-minor."""
    table = unpack_table_bf16(packed)
    outs = []
    for i in range(0, points.shape[0], PLAIN_CHUNK):
        idx, frac = enc.corner_indices(points[i:i + PLAIN_CHUNK])
        outs.append(gather_trilerp_reference(table, idx, frac)
                    .reshape(idx.shape[0], -1))
    return torch.cat(outs) if len(outs) != 1 else outs[0]


def encode_blocked(packed: torch.Tensor, points: torch.Tensor,
                   wids: torch.Tensor, counts: torch.Tensor, enc):
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if points.device.type == "cpu":
        return encode_blocked_plain(packed, points, wids, counts, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    n = points.shape[0]
    if n % LANES:
        raise ValueError(f"{n} points is not a multiple of {LANES}")
    ng, nl, s = n // LANES, enc.n_levels, enc.block_slots
    dev = points.device
    _check(packed, "packed table", torch.int32, (nl * s * LANES,), dev)
    _check(points, "points", torch.float32, (n, 3), dev)
    _check(wids, "window ids", torch.int32, (nl, ng, LANES), dev)
    _check(counts, "window counts", torch.int32, (nl, ng), dev)
    _check(enc.scales, "level scales", torch.float32, (nl,), dev)
    _check(enc.boffs, "block offsets", torch.int32, (nl, 3), dev)
    out = torch.empty((n, 2 * nl), dtype=torch.float32, device=dev)
    _launch(load("encode_blocked").encode_blocked_launch,
            ctypes.c_void_p(packed.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(wids.data_ptr()),
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(enc.scales.data_ptr()),
            ctypes.c_void_p(enc.boffs.data_ptr()), *_geometry_args(enc),
            ctypes.c_int(ng), ctypes.c_int(nl), ctypes.c_int(s),
            ctypes.c_void_p(out.data_ptr()))
    encode_blocked.launches += 1
    return out


encode_blocked.launches = 0


# ------------------------------------------------------------ K3: gradient

def grad_blocked_plain(g: torch.Tensor, points: torch.Tensor, enc
                       ) -> torch.Tensor:
    """index_add_ of w_corner * g over corner_indices: the table gradient of
    the f32 gather (the XLA-autodiff oracle). g: [n, 2L]; points: [M, 3]
    clamped, M >= n (rows past n, the padding, contribute nothing).
    Returns [L * 2^T, 2] f32."""
    n, nl = g.shape[0], enc.n_levels
    out = torch.zeros((enc.table_rows, 2), dtype=torch.float32,
                      device=points.device)
    for i in range(0, n, PLAIN_CHUNK):
        idx, frac = enc.corner_indices(points[i:min(i + PLAIN_CHUNK, n)])
        gl = g[i:i + PLAIN_CHUNK].float().reshape(-1, nl, 1, 2)
        vals = trilerp_weights(frac)[..., None] * gl            # [c, L, 8, 2]
        out.index_add_(0, idx.reshape(-1), vals.reshape(-1, 2))
    return out


def grad_blocked(g: torch.Tensor, points: torch.Tensor, enc) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU tensors. points: padded
    to whole 128-point groups; g: [n, 2L] for the first n of them."""
    if points.device.type == "cpu":
        return grad_blocked_plain(g, points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    m, n = points.shape[0], g.shape[0]
    if m % LANES:
        raise ValueError(f"{m} points is not a multiple of {LANES}")
    if n > m:
        raise ValueError(f"cotangent has {n} rows for {m} points")
    nl, dev = enc.n_levels, points.device
    if (2 * nl + 1) * LANES * 4 > 48 * 1024:
        raise ValueError(f"{nl} levels exceed the kernel's shared memory")
    _check(g, "cotangent", torch.float32, (n, 2 * nl), dev)
    _check(points, "points", torch.float32, (m, 3), dev)
    _check(enc.scales, "level scales", torch.float32, (nl,), dev)
    _check(enc.boffs, "block offsets", torch.int32, (nl, 3), dev)
    out = torch.zeros((enc.table_rows, 2), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    _launch(load("grad_blocked").grad_blocked_launch,
            ctypes.c_void_p(g.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.scales.data_ptr()),
            ctypes.c_void_p(enc.boffs.data_ptr()), *_geometry_args(enc),
            ctypes.c_int(m // LANES), ctypes.c_int(n), ctypes.c_int(nl),
            ctypes.c_int(enc.block_slots), ctypes.c_void_p(out.data_ptr()))
    grad_blocked.launches += 1
    return out


grad_blocked.launches = 0


# ------------------------------------------------------------ entry

def pad_points(points: torch.Tensor, enc) -> torch.Tensor:
    """Pad [N, 3] to a multiple of 128 rows with box_min (valid coordinates
    whose results are dropped)."""
    n = points.shape[0]
    n_pad = -(-max(n, 1) // LANES) * LANES
    if n_pad == n:
        return points.contiguous()
    pad = enc.box_min.expand(n_pad - n, 3)
    return torch.cat([points, pad.to(points.dtype)]).contiguous()


class HashEncodeBlocked(torch.autograd.Function):
    """Forward K1 + K2 over the bf16-packed table; backward K3 into the f32
    master table, straight through the packing. The points get no gradient,
    as in the JAX custom_vjp; padded points get zero cotangent."""

    @staticmethod
    def forward(ctx, table, points, enc):
        n = points.shape[0]
        packed = pack_table_bf16(table.detach())
        pts = pad_points(points.detach().float(), enc)
        wids, counts = window_lists(pts, enc)
        out = encode_blocked(packed, pts, wids, counts, enc)
        ctx.save_for_backward(pts)
        ctx.enc = enc
        ctx.table_dtype = table.dtype
        return out[:n]

    @staticmethod
    def backward(ctx, g):
        (pts,) = ctx.saved_tensors
        gt = grad_blocked(g.float().contiguous(), pts, ctx.enc)
        return gt.to(ctx.table_dtype), None, None


def hash_encode_blocked(table: torch.Tensor, points: torch.Tensor, enc
                        ) -> torch.Tensor:
    """Differentiable encode. table: [L * 2^T, 2] f32; points: [N, 3] f32
    already clamped to the bbox. Returns [N, 2L] (level-major,
    feature-minor); a backward pass launches K3 for the table."""
    if enc.n_features_per_level != 2:
        raise ValueError("the blocked kernels require 2 features per level")
    return HashEncodeBlocked.apply(table, points, enc)
