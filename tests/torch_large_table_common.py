"""Helpers shared by the large-table tests, tests/test_torch_large_table*.py
(a module, not a test file): the preset's geometry, the JAX package's
oracle, gather and gradient, the inputs from a seed, and the bin pass's
plan against its definition.
"""
import numpy as np
import torch

from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.kernels import hash_encode_large as KL


BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)


KW = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16,
          finest_resolution=256)


def _pair(scheme, **kw):
    args = dict(KW, scheme=scheme, **kw)
    return (JaxEncoder(BBOX, use_pallas=False, **args),
            HashGridEncoder(BBOX, use_kernel=False, device="cpu", **args))


def _points(enc, n, seed):
    """Uniform points, points within +-2 ulps of cell boundaries of random
    levels, and points on the box faces."""
    rng = np.random.RandomState(seed)
    uniform = rng.uniform(BBOX[:3], BBOX[3:], (n, 3)).astype(np.float32)
    lvl = rng.randint(0, enc.n_levels, n)
    res = (enc.resolutions if enc.scheme == "fixed"
           else enc.level_scales)[lvl].astype(np.float64)[:, None]
    cell = np.floor(rng.uniform(0, 1, (n, 3)) * res)
    x = (BBOX[:3] + cell / res * (BBOX[3:] - BBOX[:3])).astype(np.float32)
    steps = rng.randint(-2, 3, (n, 3))
    for s in range(2):
        x = np.where(steps > s, np.nextafter(x, np.float32(np.inf)), x)
        x = np.where(steps < -s, np.nextafter(x, np.float32(-np.inf)), x)
    faces = uniform[:64].copy()
    axis, side = np.arange(64) % 3, (np.arange(64) // 3) % 2
    faces[np.arange(64), axis] = BBOX[3 * side + axis]
    return np.clip(np.concatenate([uniform, x, faces]), BBOX[:3], BBOX[3:])


# finest 64: at finest 128 a fine sample an ulp from a cell boundary (the
# fine depths follow the coarse weights, summed in another order) moves
# the first sigma layer's gradient, a sum with heavy cancellation, past
# the bulk tolerance (88 % of entries within 1e-4 of the largest, all
# within 1e-3)
TINY = dict(n_levels=4, log2_hashmap_size=12, finest_resolution=64,
            n_importance=16, hier_sparse_importance=4, multires_views=4,
            compute_dtype="float32", thin_ray=True)


TINY_TP = dict(n_samples=8, n_rand=512, n_iters=100, chunk=512)


# the density noise is 0 from step 100 / 8 and the preconditioning alpha
# from step 100 / 6, so the step draws nothing but the batch
STEP = 17


# ------------------------------------ the order-fixed gradient's bin pass

def _cases():
    """(scheme, log2 T, levels, case): a partial last tile, one crowded
    cell (bins of more records than a part: split), few points (empty
    bins), at the small table's bins of 512 entries and the large one's,
    and tables of more bins than a bin-pass chunk (T = 2^23) or fewer
    entries than a bin (T = 2^4)."""
    out = []
    for scheme in ("fixed", "random", "blocked"):
        out += [(scheme, 10, 3, "partial tile"), (scheme, 13, 2, "crowded"),
                (scheme, 19, 1, "empty bins")]
    return out + [("random", 13, 4, "empty bins"), ("fixed", 12, 4,
                                                     "crowded"),
                  ("random", 23, 1, "empty bins"), ("fixed", 4, 2,
                                                    "partial tile")]


def _case_points(te, case):
    rng = np.random.RandomState(len(case) + te.level_size % 97)
    if case == "partial tile":
        return _points(te, 1300, 8)                     # 1,300 + 2 tiles
    if case == "empty bins":
        return _points(te, 64, 9)[:6]
    res = float((te.resolutions if te.scheme == "fixed"
                 else te.level_scales)[-1])
    cell = np.floor(rng.uniform(0, res - 1, (1, 3)))
    frac = rng.uniform(0.1, 0.9, (4500, 3))
    x = BBOX[:3] + (cell + frac) / res * (BBOX[3:] - BBOX[:3])
    return np.clip(x.astype(np.float32), BBOX[:3], BBOX[3:])


def _bins_by_definition(local, bl, nb, tp, part):
    """The bin pass built from its definition, record by record: every
    (point, level, corner)'s record (p << 3 | d) sorted by (level, bin,
    tile, ((q // 32) * 8 + d) * 32 + q % 32), q = p % tp; each run's offset
    the exclusive scan of the counts in (level, bin, tile) order; the
    plan."""
    n, nl, _ = local.shape
    nt = -(-n // tp)
    rows = sorted((l, int(local[p, l, d]) >> bl, p // tp,
                   (((p % tp) // 32) * 8 + d) * 32 + p % 32, (p << 3) | d)
                  for l in range(nl) for p in range(n) for d in range(8))
    recs = np.asarray([r[4] for r in rows], np.int64)
    counts = np.zeros((nl, nb, nt), np.int64)
    for r in rows:
        counts[r[0], r[1], r[2]] += 1
    offs = (np.cumsum(counts) - counts.reshape(-1)).reshape(nl, nb, nt)
    totals = counts.sum(-1).reshape(-1)
    parts = np.where(totals == 0, 1, -(-totals // part))
    split = np.where(parts > 1, parts, 0)
    items = [(i, j) for i in range(nl * nb) for j in range(parts[i])]
    head = np.concatenate([[len(items), split.sum(), 0, 0], totals, parts,
                           np.where(parts > 1, np.cumsum(split) - split, 0),
                           offs[:, :, 0].reshape(-1),
                           np.asarray(items, np.int64).reshape(-1)])
    return recs, offs, head


def _check_runs(recs, plan, local, bl, nb, tp):
    """Read off the records: each bin's run (the plan's first record and
    count) holds only records of its bin, in the fixed order (tile, then
    order within the tile), and every (point, level, corner) once."""
    n, nl, _ = local.shape
    totals = plan[4:4 + nl * nb].astype(np.int64)
    firsts = plan[4 + 3 * nl * nb:4 + 4 * nl * nb].astype(np.int64)
    assert (firsts == np.cumsum(totals) - totals).all()
    lb = np.repeat(np.arange(nl * nb), totals)
    r = recs.astype(np.int64)
    p, d, l = r >> 3, r & 7, lb // nb
    assert (local[p, l, d] >> bl == lb % nb).all()
    q = p % tp
    key = (p // tp) * 8 * tp + ((q // 32) * 8 + d) * 32 + q % 32
    assert (np.diff(key)[lb[1:] == lb[:-1]] > 0).all()
    seen = np.zeros((n, nl, 8), np.int64)
    np.add.at(seen, (p, l, d), 1)
    assert (seen == 1).all()


BIN_PASS_CASES = _cases()


def bin_pass_plan_is_its_definition(scheme, log2_t, levels, case):
    """The bin pass's records, read back, are its definition: every
    (point, level, corner) once, each bin's records one run in a fixed
    order."""
    # every (point, level, corner) once, in its entry's bin, each bin's
    # records one run in the fixed order; the run offsets the exclusive
    # scan of the counts in (level, bin, tile) order; the plan's parts,
    # slots, first records and items; exactly
    _, te = _pair(scheme, n_levels=levels, log2_hashmap_size=log2_t)
    pts = torch.from_numpy(_case_points(te, case))
    n = pts.shape[0]
    bl, nb, tp, part, nt, plan_len = KL.bins_shape(n, te)
    recs, offs, plan = KL.grad_large_bins(pts, te)       # the plain version
    assert recs.dtype == torch.int32 and offs.dtype == torch.int32
    assert recs.shape == (8 * n * levels,)
    assert offs.shape == (levels, nb, nt) and plan.shape == (plan_len,)
    idx, _ = te.corner_indices(pts)
    local = (idx - torch.arange(levels)[None, :, None]
             * te.level_size).numpy()
    ref_recs, ref_offs, ref_head = _bins_by_definition(local, bl, nb, tp,
                                                       part)
    np.testing.assert_array_equal(recs.numpy(), ref_recs)
    np.testing.assert_array_equal(offs.numpy(), ref_offs)
    np.testing.assert_array_equal(plan.numpy()[:ref_head.size], ref_head)
    assert not plan.numpy()[ref_head.size:].any()
    _check_runs(recs.numpy(), plan.numpy(), local, bl, nb, tp)
    if case == "crowded":
        assert int(plan[1]) > 0, "no bin was split into parts"
    if case == "empty bins":
        assert bool((plan[4:4 + levels * nb] == 0).any())
