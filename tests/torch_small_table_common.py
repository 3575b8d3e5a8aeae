"""Helpers shared by the small-table tests, tests/test_torch_small_table*.py
(a module, not a test file): the JAX package's oracles and encodes at
given shapes, the inputs from a seed, the planned bin pass against its
definition and small_plan's coverage check.
"""
import numpy as np
import torch

from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.kernels import hash_encode as KS


BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)


KW = dict(n_levels=4, log2_hashmap_size=10, base_resolution=16,
          finest_resolution=128, primes_seed=5)


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _pair(scheme, use_kernel=False, **kw):
    args = dict(KW, scheme=scheme, **kw)
    return (JaxEncoder(BBOX, **args),
            HashGridEncoder(BBOX, use_kernel=use_kernel, device="cpu",
                            **args))


def _pts(n, seed, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    lo = BBOX[:3] if lo is None else lo
    hi = BBOX[3:] if hi is None else hi
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def _table(rows, seed):
    """|table| <= 1, so 1e-6 is a few ulps of any feature."""
    return np.random.RandomState(seed).uniform(-1, 1, (rows, 2)).astype(
        np.float32)


def _faces_and_boundaries(enc, n, seed):
    """Points on the box faces and corners, and within +-2 ulps of cell
    boundaries of random levels, where another rounding of the cell
    coordinate changes the cell."""
    rng = np.random.RandomState(seed)
    lvl = rng.randint(0, enc.n_levels, n)
    if enc.scheme == "fixed":
        res = enc.resolutions[lvl].astype(np.float64)[:, None]
    else:
        res = enc.level_scales[lvl].astype(np.float64)[:, None]
    cell = np.floor(rng.uniform(0, 1, (n, 3)) * res)
    x = (BBOX[:3] + cell / res * (BBOX[3:] - BBOX[:3])).astype(np.float32)
    steps = rng.randint(-2, 3, (n, 3))
    for s in range(2):
        x = np.where(steps > s, np.nextafter(x, np.float32(np.inf)), x)
        x = np.where(steps < -s, np.nextafter(x, np.float32(-np.inf)), x)
    corners = np.array([[BBOX[3 * ((d >> (2 - a)) & 1) + a] for a in range(3)]
                        for d in range(8)], np.float32)
    faces = _pts(64, seed + 1)
    axis, side = np.arange(64) % 3, (np.arange(64) // 3) % 2
    faces[np.arange(64), axis] = BBOX[3 * side + axis]
    return np.clip(np.concatenate([x, corners, faces]), BBOX[:3], BBOX[3:])


def _fused_kwargs(je, version, packed):
    if je.scheme == "random":
        primes = tuple(tuple(int(v) for v in row) for row in je.primes)
        scales = tuple(float(s) for s in je.level_scales)
        res = (0.0,) * je.n_levels
    else:
        primes = (tuple(int(v) for v in (1, 2654435761, 805459861)),) \
            * je.n_levels
        scales = (0.0,) * je.n_levels
        res = tuple(float(r) for r in je.resolutions)
    return dict(n_levels=je.n_levels, level_size=je.level_size,
                scheme=je.scheme,
                box_min=tuple(float(v) for v in BBOX[:3]),
                box_max=tuple(float(v) for v in BBOX[3:]),
                level_scales=scales, primes=primes, resolutions=res,
                version=version, packed=packed)


def _pallas_rel(je, pts):
    """The Pallas kernels' cell coordinate, (x - min) * f32(inv_extent *
    scale) with the product folded in double ([N, L, 3])."""
    scale = je.level_scales if je.scheme == "random" else je.resolutions
    inv = 1.0 / (BBOX[3:].astype(np.float64) - BBOX[:3].astype(np.float64))
    fold = (inv[None, :] * np.asarray(scale, np.float64)[:, None]).astype(
        np.float32)
    return (pts - BBOX[:3])[:, None, :] * fold[None]


def _grad_case(scheme, n, seed):
    je, te = _pair(scheme)
    pts = _pts(n, seed)
    g = np.random.RandomState(seed + 1).standard_normal(
        (n, je.output_dims)).astype(np.float32)
    return je, te, pts, g


def small_plan_covers_every_level_and_tile_once(log2_t, packed):
    """small_plan's level groups and persistent blocks cover every level
    and tile once, within the card's shared memory."""
    # every (L, T, packed) that supports() admits at this T: the level
    # groups partition the levels, each group's slice of a row is a whole
    # 32-byte sector or more (or the whole row), the persistent blocks of
    # each group visit every 1,024-point tile exactly once (as the kernel
    # strides them), and a block's stage and output tiles fit its 232,448
    # bytes
    size = 1 << log2_t
    esize = 4 if packed else 8
    for levels in range(1, (1 << 19) // size + 1):
        assert KS.supports(levels, size, 2)
        g, staged, smem = KS.small_stage(levels, size, packed)
        assert 0 <= staged <= g <= levels
        assert smem == staged * size * esize + KS.small_tile_bytes(g)
        assert smem + KS.SMEM_STATIC <= 232448
        # a row slice is a whole sector or more, or the whole row
        assert g >= min(4, levels)
        if staged == g > min(4, levels):
            assert g & (g - 1) == 0
        if staged < g:       # as many levels staged as fit
            assert smem + size * esize + KS.SMEM_STATIC > 232448
        for n in (1, 1023, 1025, 1_000_003, 3_000_000):
            for blocks in (132, 264, 3):
                plan = KS.small_plan(n, levels, size, packed, blocks)
                assert (plan.group_levels, plan.staged_levels,
                        plan.smem) == (g, staged, smem)
                first = np.arange(plan.n_groups) * plan.group_levels
                span = np.minimum(first + plan.group_levels, levels) - first
                assert span.min() >= 1 and span.sum() == levels
                # block b: group b % n_groups, tiles b // n_groups + k *
                # grid / n_groups
                assert plan.grid % plan.n_groups == 0
                assert plan.grid <= max(blocks, plan.n_groups)
                b = np.arange(plan.grid)
                per_group = plan.grid // plan.n_groups
                tiles = -(-n // KS.TILE)
                assert per_group <= tiles
                t = (b // plan.n_groups)[:, None] + per_group * np.arange(
                    -(-tiles // per_group))[None, :]
                grp = np.broadcast_to((b % plan.n_groups)[:, None], t.shape)
                cell = (grp * tiles + t)[t < tiles]
                assert np.array_equal(
                    np.bincount(cell, minlength=plan.n_groups * tiles),
                    np.ones(plan.n_groups * tiles, np.int64))


# --------------------------- the order-fixed gradient at the small table

def _crowded(te, n, seed):
    """n points in one cell of the finest level."""
    rng = np.random.RandomState(seed)
    res = float((te.resolutions if te.scheme == "fixed"
                 else te.level_scales)[-1])
    cell = np.floor(rng.uniform(0, res - 1, (1, 3)))
    x = BBOX[:3] + (cell + rng.uniform(0.1, 0.9, (n, 3))) / res * (
        BBOX[3:] - BBOX[:3])
    return np.clip(x.astype(np.float32), BBOX[:3], BBOX[3:])
