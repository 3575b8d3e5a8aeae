"""Port parity: the large-table hash encode (the JAX package's XLA path,
use_pallas_encoder=False) and one hierarchical train step of
hashnerf_preset(), the CLI's default preset.

The port on the CPU, where encode_large and grad_large run their plain
versions, against the JAX package on the same numpy inputs: corner indices
exactly (against the jitted oracle) at the preset's geometry (16 levels,
T = 2^19), the encode against the XLA gather, the table gradient against
jax.grad, and one train step from the same converted state. The order-fixed
gradient's bin pass (grad_large_bins_plain, the kernel's plain version)
against a construction from its definition, and the sum in its order
against jax.vjp of the XLA gather.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.kernels import hash_encode_large as KL
from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts

torch.set_num_threads(1)

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


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_corner_indices_exact(scheme):
    # hashnerf_preset()'s geometry: 16 levels, T = 2^19, base 16 -> 1024
    je, te = _pair(scheme, n_levels=16, log2_hashmap_size=19,
                   finest_resolution=1024)
    pts = _points(te, 2048, 1)
    idx_j, frac_j = jax.jit(je.corner_indices)(jnp.asarray(pts))
    idx_t, frac_t = te.corner_indices(torch.from_numpy(pts))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
def test_encode_and_grad_match_the_xla_path(scheme):
    # encode_large_plain against the XLA gather within 1e-6 x max|table|
    # (f32 weights and products on both sides, the 8 corner sums in another
    # order); grad_large_plain against jax.grad of <feats, g> within 1e-5
    # of each entry's sum of |w g| (index_add_ and XLA's scatter-add sum in
    # other orders)
    je, te = _pair(scheme)
    table = np.random.RandomState(2).uniform(
        -1, 1, (te.table_rows, 2)).astype(np.float32)
    pts = _points(te, 2048, 3)
    cot = np.random.RandomState(4).standard_normal(
        (pts.shape[0], te.output_dims)).astype(np.float32)

    def feats_of(tab, x):
        return je({"table": tab}, x)[0]
    feats_j = jax.jit(feats_of)(jnp.asarray(table), jnp.asarray(pts))
    grad_j = jax.jit(jax.grad(lambda tab, x: jnp.sum(feats_of(tab, x)
                                                     * jnp.asarray(cot))))(
        jnp.asarray(table), jnp.asarray(pts))
    tab_t, pts_t = torch.from_numpy(table), torch.from_numpy(pts)
    feats_t = KL.encode_large(tab_t, pts_t, te)
    assert feats_t.shape == (pts.shape[0], te.output_dims)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                               rtol=0, atol=1e-6 * np.abs(table).max())
    grad_t = KL.grad_large(torch.from_numpy(cot), pts_t, te).numpy()
    mag = KL.grad_large_plain(torch.from_numpy(np.abs(cot)), pts_t,
                              te).numpy()
    assert np.all(np.abs(grad_t - np.asarray(grad_j)) <= 1e-5 * mag + 1e-30)
    assert np.abs(grad_t).max() > 0


def test_encoder_routes_the_f32_gather_through_the_large_kernels():
    # use_kernel=False: the forward is HashEncodeLarge (on CPU tensors its
    # plain versions, no launch counted), the backward reaches the table
    # only; the points get no gradient, as through the port's other kernels
    _, te = _pair("random")
    with torch.no_grad():
        te.table.uniform_(-1, 1, generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(_points(te, 256, 6)) * 1.2       # some outside
    x.requires_grad_(True)
    reset_launch_counts()
    feats, keep = te(x)
    assert type(feats.grad_fn).__name__ == "HashEncodeLargeBackward"
    assert bool(keep.any()) and not bool(keep.all())
    feats.sum().backward()
    assert x.grad is None or not bool(x.grad.any())
    xc = torch.minimum(torch.maximum(x.detach(), te.box_min), te.box_max)
    ref = KL.grad_large_plain(torch.ones_like(feats), xc, te)
    assert torch.allclose(te.table.grad, ref, rtol=0, atol=1e-6)
    assert set(launch_counts().values()) == {0}


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


def test_hashnerf_preset_train_step_matches_jax():
    # one step of hashnerf_preset() (random scheme, the f32 gather, the
    # coarse-ranked fine budget, the importance pass) at tiny widths from
    # the same converted state; tolerances of tests/test_torch_hier_train.py
    # for an f32 MLP
    jx = JaxExecutor(jax_hashnerf_preset(**TINY))
    assert not jx.params.use_pallas_encoder
    tp = JaxTrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
    params["embed"]["table"] = np.random.RandomState(2).uniform(
        -0.05, 0.05, params["embed"]["table"].shape).astype(np.float32)
    jx.state["params"] = jax.tree.map(jnp.asarray, params)
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    images = np.random.RandomState(1).uniform(0, 1, (3, h, w, 3))
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(images, jnp.float32), poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand)
    key = jax.random.PRNGKey(1)
    new, jm = jx._build_train_step(tp)({**jx.state, "step": jnp.int32(STEP)},
                                       sampler, key)
    k_batch = jax.random.split(jax.random.fold_in(key, STEP), 5)[0]
    batch = {k: torch.as_tensor(np.array(v, np.float32))
             for k, v in sampler.sample(k_batch, jnp.int32(STEP)).items()}
    tx = NeRFExecutor(hashnerf_preset(**TINY), device="cpu")
    tx.initialize(BBOX, TrainParams().lrate_decay, seed=0)
    assert not tx.embedder.use_kernel and tx.embedder.scheme == "random"
    tx.load_state(state_from_jax(params, device="cpu"))
    tm = tx._build_train_step(TrainParams(**TINY_TP))(STEP, batch)
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    mu = state_from_jax(jax.tree.map(np.asarray, new["opt_state"][0].mu),
                        device="cpu")
    for name, prm in tx.named_parameters().items():
        gj = mu[name].numpy() / 0.1          # fresh moments: mu = 0.1 g
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        diff = np.abs(prm.grad.numpy() - gj)
        assert np.mean(diff <= 1e-4 * scale) >= 0.95, name
        assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)


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


@pytest.mark.parametrize("scheme,log2_t,levels,case", _cases())
def test_bin_pass_plan_is_its_definition(scheme, log2_t, levels, case):
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


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
@pytest.mark.parametrize("case", ["partial tile", "crowded"])
def test_binned_sum_matches_jax_vjp(scheme, case):
    # the terms summed in the bin pass's order (grad_large_binned_plain)
    # against jax.vjp of the JAX package's gather_trilerp_reference, each
    # entry within 1e-5 of the sum of its terms' magnitudes
    je, te = _pair(scheme, n_levels=3, log2_hashmap_size=12)
    pts = _case_points(te, case)
    g = np.random.RandomState(12).standard_normal(
        (pts.shape[0], te.output_dims)).astype(np.float32)
    idx, frac = jax.jit(je.corner_indices)(jnp.asarray(pts))
    _, vjp = jax.vjp(lambda tab: gather_trilerp_reference(tab, idx, frac),
                     jnp.zeros((je.table_rows, 2), jnp.float32))
    ref = np.asarray(vjp(jnp.asarray(g.reshape(len(pts), -1, 2)))[0])
    got = KL.grad_large_binned_plain(torch.from_numpy(g),
                                     torch.from_numpy(pts), te).numpy()
    mag = KL.grad_large_plain(torch.from_numpy(np.abs(g)),
                              torch.from_numpy(pts), te).numpy()
    assert np.all(np.abs(got - ref) <= 1e-5 * mag + 1e-30)
    assert np.abs(got).max() > 0
