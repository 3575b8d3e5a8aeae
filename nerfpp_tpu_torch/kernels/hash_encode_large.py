"""Large-table hash-encode kernels: wrappers, plain versions, autograd.

Port of the JAX package's XLA path of the hash encoder
(``use_pallas_encoder=False``; nerfpp_tpu/encoders/hashgrid.py:408
``gather_trilerp_reference`` after ``corner_indices``, and the XLA
scatter-add that autodiff makes of it), which ``hashnerf_preset()`` runs
with 16 levels x 2^19 f32 entries, a 64 MiB table:

- ``encode_large`` (csrc/encode_large.cu): the 8 corners of each point's
  cell per level, read from the f32 table in global memory and blended with
  f32 trilinear weights; a warp takes 32 consecutive points of one level,
  and the launch passes level group by level group. Fixed, random and
  blocked schemes, any power-of-two level size.
- ``grad_large_bins`` and ``grad_large`` (csrc/grad_large.cu): the table
  gradient, each corner's entry getting ``w_corner * g``, summed in an
  order fixed by the inputs with no float atomics, so that two launches
  give bitwise equal gradients (the float2 atomics of the first version
  did not), at any power-of-two level size. ``grad_large_bins`` is its
  bin pass: every (point, level, corner) listed in its entry's bin of
  2^bin_log2 entries, each bin's records one run in a fixed order, and the
  owner pass's plan (``bin_geometry``); ``grad_large`` runs it and then
  the owner pass, which sums each bin in its own tile and writes every
  entry once. The small-table backward (kernels/hash_encode.py
  ``grad_small``) runs the same kernels.
- ``HashEncodeLarge`` / ``hash_encode_large``: the differentiable entry
  (points already clamped), the points getting no gradient, as in the
  port's other encoders.

Each wrapper runs its plain PyTorch version for CPU tensors, and launches its
kernel for CUDA tensors or raises; it never falls back. Each keeps a launch
count (``encode_large.launches``, ``grad_large_bins.launches``,
``grad_large.launches``) that only a kernel launch increments. The plain
versions compute the same cell, hash and weight arithmetic as the kernels
(encoders/hashgrid.py), so both put every point in the same cell; the bin
pass's plain version gives its records, run offsets and plan exactly, and
``grad_large_binned_plain`` sums the terms in that plan's order.
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
BIN_LOG2_MIN, BIN_LOG2_MAX = 9, 11   # bins of 512 to 2,048 entries
TILE_POINTS = 512                    # points of a bin-pass tile (GL_TILE_MAX)
RECORDS_MAX = 2**31 - 1              # (point, level, corner)s of a launch


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


def bin_geometry(level_size: int):
    """(bin_log2, bins a level B, points a tile P, records a part) of the
    gradient's bin pass at level size T (any power of two): a bin is
    2^bin_log2 entries (T / 512 clamped to 512-2,048, or the whole level up
    to T = 512), so that a level has at most 512 bins up to T = 2^20 and
    the run offsets, B x tiles a level, are at most one int a (point,
    level) there; a tile is 512 points (its records staged in a warp's
    shared memory); a part is max(4,096, 8 x bin) records (a split bin's
    partial tiles cost at most as much as its records)."""
    log2_t = level_size.bit_length() - 1
    if log2_t <= BIN_LOG2_MIN:
        bl = log2_t
    else:
        bl = min(max(log2_t - 9, BIN_LOG2_MIN), BIN_LOG2_MAX)
    n_bins = level_size >> bl
    return bl, n_bins, TILE_POINTS, max(4096, 8 << bl)


def bins_shape(n: int, enc):
    """(bin_log2, B, P, part, tiles, plan length) of the bin pass for n
    points: the plan holds (items, slots, 0, 0), per bin its records,
    parts, first partial slot and first record, and at most B L +
    ceil(8 N L / part) items."""
    bl, nb, tp, part = bin_geometry(enc.level_size)
    nl = enc.n_levels
    most_items = nl * nb + -(-8 * n * nl // part)
    return bl, nb, tp, part, -(-n // tp), 4 + 4 * nl * nb + 2 * most_items


def _bin_keys(points: torch.Tensor, enc):
    """Per (point, level, corner): its entry, its weight's fractions, its
    record (p << 3 | d) and its place in the bin pass's order, the key
    ((level * B + bin) * tiles + tile) * 8P + its order within the tile
    (points 32 at a time, corners in order, lanes ascending: ((q // 32) *
    8 + d) * 32 + q % 32, q the point within the tile); and the (level,
    bin, tile) run it belongs to."""
    n, nl = points.shape[0], enc.n_levels
    bl, nb, tp, _, nt, _ = bins_shape(n, enc)
    dev = points.device
    idx, frac = enc.corner_indices(points)
    lvl = torch.arange(nl, device=dev)[None, :, None]
    b = (idx - lvl * enc.level_size) >> bl
    p = torch.arange(n, device=dev)[:, None, None]
    d = torch.arange(8, device=dev)[None, None, :]
    q = p % tp
    run = (lvl * nb + b) * nt + p // tp
    key = run * (8 * tp) + ((q // 32) * 8 + d) * 32 + q % 32
    return idx, frac, ((p << 3) | d).expand_as(b), key, run


def grad_large_bins_plain(points: torch.Tensor, enc):
    """The gradient's bin pass. points: [N, 3] clamped, N > 0. Returns
    - recs int32 [8 N L]: every (point, level, corner)'s record (p << 3 |
      d) in the order (level, bin, tile, order within the tile) of
      ``_bin_keys``, so that each bin's records are one run;
    - offs int32 [L, B, tiles]: where each (level, bin, tile)'s records
      begin, the exclusive scan of their counts in that order;
    - plan int32: (items, slots, 0, 0), then per (level, bin) its records
      n, its parts ceil(n / part) (one if n = 0), the first of its
      partial-sum slots (0 for one part; slots numbered in bin order) and
      its first record, then the items (bin, part) in bin order, zeros
      after them."""
    n, nl = points.shape[0], enc.n_levels
    _, nb, _, part, nt, plan_len = bins_shape(n, enc)
    dev = points.device
    _, _, rec, key, run = _bin_keys(points, enc)
    order = torch.argsort(key.reshape(-1))
    recs = rec.reshape(-1)[order].to(torch.int32)
    counts = torch.bincount(run.reshape(-1), minlength=nl * nb * nt)
    offs = (torch.cumsum(counts, 0) - counts).reshape(nl, nb, nt)
    totals = counts.reshape(nl * nb, nt).sum(1)
    parts = torch.where(totals == 0, 1, -(-totals // part))
    split = torch.where(parts > 1, parts, 0)
    slots = torch.where(parts > 1, torch.cumsum(split, 0) - split, 0)
    n_items = int(parts.sum())
    first = torch.cumsum(parts, 0) - parts
    bins = torch.repeat_interleave(torch.arange(nl * nb, device=dev), parts)
    items = torch.stack([bins, torch.arange(n_items, device=dev)
                         - first[bins]], dim=-1).reshape(-1)
    plan = torch.zeros(plan_len, dtype=torch.int64, device=dev)
    plan[0], plan[1] = n_items, int(split.sum())
    plan[4:4 + 4 * nl * nb] = torch.cat([totals, parts, slots,
                                         offs.reshape(nl * nb, nt)[:, 0]])
    plan[4 + 4 * nl * nb:4 + 4 * nl * nb + 2 * n_items] = items
    return recs, offs.to(torch.int32), plan.to(torch.int32)


def grad_large_binned_plain(g: torch.Tensor, points: torch.Tensor, enc
                            ) -> torch.Tensor:
    """The table gradient summed term by term in the bin pass's order: each
    bin's run of records in turn (index_add_ on the CPU adds in that
    order). g: [N, 2L]; points: [N, 3] clamped. Returns [L * T, 2] f32."""
    n, nl = points.shape[0], enc.n_levels
    out = torch.zeros((enc.table_rows, 2), dtype=torch.float32,
                      device=points.device)
    if n == 0:
        return out
    idx, frac, _, key, _ = _bin_keys(points, enc)
    order = torch.argsort(key.reshape(-1))
    vals = (trilerp_weights(frac)[..., None]
            * g.float().reshape(n, nl, 1, 2)).reshape(-1, 2)
    out.index_add_(0, idx.reshape(-1)[order], vals[order])
    return out


def _grad_args(enc, points: torch.Tensor):
    """_args, and the points the gradient kernels take: a 32-bit record
    (p << 3 | d) for each of at most 2^31 - 1 (point, level, corner)s."""
    if 8 * points.shape[0] * enc.n_levels > RECORDS_MAX:
        raise ValueError(f"the table gradient takes at most {RECORDS_MAX} "
                         f"records (8 x points x levels), not "
                         f"{8 * points.shape[0] * enc.n_levels}")
    return _args(enc, points)


def grad_large_bins(points: torch.Tensor, enc):
    """The bin pass's kernels on CUDA tensors, the plain version on CPU
    tensors. points: [N, 3] f32 clamped, N > 0. Returns (recs, offs, plan)
    as grad_large_bins_plain; the kernels leave the plan past its items
    unwritten."""
    if points.device.type == "cpu":
        return grad_large_bins_plain(points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ints, geom = _grad_args(enc, points)
    dev, n, nl = points.device, points.shape[0], enc.n_levels
    if n == 0:
        raise ValueError("the bin pass takes at least one point")
    bl, nb, tp, part, nt, plan_len = bins_shape(n, enc)
    recs = torch.empty(8 * n * nl, dtype=torch.int32, device=dev)
    offs = torch.empty((nl, nb, nt), dtype=torch.int32, device=dev)
    plan = torch.empty(plan_len, dtype=torch.int32, device=dev)
    _launch(load("grad_large").grad_large_bins_launch,
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.level_geom.data_ptr()),
            ctypes.c_void_p(ints.data_ptr()), *geom, ctypes.c_longlong(n),
            ctypes.c_int(nl), ctypes.c_int(enc.level_size),
            ctypes.c_int(SCHEMES[enc.scheme]), ctypes.c_int(bl),
            ctypes.c_int(tp), ctypes.c_int(part),
            ctypes.c_void_p(recs.data_ptr()),
            ctypes.c_void_p(offs.data_ptr()),
            ctypes.c_void_p(plan.data_ptr()), ctypes.c_int(plan_len))
    grad_large_bins.launches += 1
    return recs, offs, plan


grad_large_bins.launches = 0


def grad_hashed(g: torch.Tensor, points: torch.Tensor, enc) -> torch.Tensor:
    """The bin pass (counted as grad_large_bins') and the owner pass on
    CUDA tensors, uncounted: the launches of grad_large and grad_small.
    g: [N, 2L] f32; points: [N, 3] f32 clamped. Zeros for N = 0."""
    ints, geom = _grad_args(enc, points)
    dev, n, nl = points.device, points.shape[0], enc.n_levels
    _check(g, "cotangent", torch.float32, (n, 2 * nl), dev)
    if n == 0:
        return torch.zeros((enc.table_rows, 2), dtype=torch.float32,
                           device=dev)
    recs, _, plan = grad_large_bins(points, enc)
    bl, nb, _, part, _, _ = bins_shape(n, enc)
    # the owner kernel's item counter and parts finished per bin, and the
    # partial tiles of split bins (fewer than 2 x 8 N L / part of them)
    state = torch.empty(nl * nb + 1, dtype=torch.int32, device=dev)
    most = 2 * -(-8 * n * nl // part) + 1
    partial = torch.empty((most, 2 << bl), dtype=torch.float32, device=dev)
    # every entry is written once, by its bin's owner
    out = torch.empty((enc.table_rows, 2), dtype=torch.float32, device=dev)
    # the cotangent level-major, so that a warp's reads of one level's
    # points are contiguous
    g_lm = g.view(n, nl, 2).transpose(0, 1).contiguous()
    _launch(load("grad_large").grad_large_launch,
            ctypes.c_void_p(g_lm.data_ptr()),
            ctypes.c_void_p(points.data_ptr()),
            ctypes.c_void_p(enc.level_geom.data_ptr()),
            ctypes.c_void_p(ints.data_ptr()), *geom, ctypes.c_longlong(n),
            ctypes.c_int(nl), ctypes.c_int(enc.level_size),
            ctypes.c_int(SCHEMES[enc.scheme]), ctypes.c_int(bl),
            ctypes.c_int(part), ctypes.c_void_p(recs.data_ptr()),
            ctypes.c_void_p(plan.data_ptr()),
            ctypes.c_void_p(state.data_ptr()),
            ctypes.c_void_p(partial.data_ptr()),
            ctypes.c_void_p(out.data_ptr()))
    return out


def grad_large(g: torch.Tensor, points: torch.Tensor, enc) -> torch.Tensor:
    """The gradient kernels (grad_large_bins, then the owner pass) on CUDA
    tensors, the plain version on CPU tensors. g: [N, 2L] f32; points:
    [N, 3] f32 clamped. Two launches on the same inputs give bitwise equal
    results."""
    if points.device.type == "cpu":
        return grad_large_plain(g, points, enc)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    out = grad_hashed(g, points, enc)
    if points.shape[0]:
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
