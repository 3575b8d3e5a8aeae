"""Port parity: the small-table (fixed and random) hash schemes, the plain
versions of their CUDA kernels, and the fixed scheme's TV loss.

The port on the CPU, where each kernel wrapper runs its plain PyTorch
version, against the JAX package on the same numpy inputs: primes,
resolutions and corner indices exactly (against the jitted oracle), the
encode against the Pallas kernels in interpret mode (v2 packed and f32, v1)
and the XLA gather, the table gradient against XLA autodiff and the JAX
custom VJP, and the TV loss with the same cube origins. The order-fixed
gradient that grad_small launches on the card, at the small table's bins:
its bin pass's plan read back against its definition, and the sum in the
plan's order against jax.vjp of the XLA gather.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference
from nerfpp_tpu.encoders.hashgrid import total_variation_loss as jax_tv
from nerfpp_tpu.pallas import hash_encode as JHE
from nerfpp_tpu_torch.encoders.hashgrid import (HashGridEncoder,
                                               total_variation_loss,
                                               trilerp_weights, tv_cube_size)
from nerfpp_tpu_torch.kernels import hash_encode as KS
from nerfpp_tpu_torch.kernels import hash_encode_large as KL

torch.set_num_threads(1)

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


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(n_levels=16, log2_hashmap_size=13, finest_resolution=1024),
    dict(primes_seed=3, base_resolution=8, finest_resolution=512)])
def test_primes_and_resolutions_exact(scheme, cfg):
    je, te = _pair(scheme, **cfg)
    assert te.level_size == je.level_size
    assert te.table_rows == je.table_rows
    if scheme == "fixed":
        np.testing.assert_array_equal(te.resolutions, je.resolutions)
    else:
        np.testing.assert_array_equal(te.primes, je.primes)
        np.testing.assert_array_equal(te.level_scales, je.level_scales)


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("box", ["whole", "corner", "thin"])
def test_corner_indices_exact(scheme, box):
    # exact against jax.jit(enc.corner_indices), boundaries and faces too:
    # XLA folds the divisions by constants into reciprocal multiplies
    # (random: (x - min) * f32(1/extent) * scale; fixed: (x - min) /
    # f32(extent * f32(1/res))), and the port computes those forms
    je, te = _pair(scheme, n_levels=6, log2_hashmap_size=12,
                   finest_resolution=600)
    lo, hi = {"whole": (None, None),
              "corner": (BBOX[3:] - 0.2, None),
              "thin": (np.float32([0.1, -0.9, 0.0]),
                       np.float32([0.1001, 0.9, 0.05]))}[box]
    pts = np.concatenate([_pts(4096, 3, lo, hi),
                          _faces_and_boundaries(te, 2048, 4)])
    idx_j, frac_j = jax.jit(je.corner_indices)(jnp.asarray(pts))
    idx_t, frac_t = te.corner_indices(torch.from_numpy(pts))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))


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


@pytest.mark.parametrize("scheme,version,packed", [
    ("random", "v2", True), ("fixed", "v2", True), ("random", "v2", False),
    ("fixed", "v1", False)])
def test_plain_matches_pallas_interpret(scheme, version, packed):
    # The same packed bits (or f32 table) and f32 weights on both sides;
    # N = 300 is not a multiple of the Pallas kernels' point blocks. The
    # Pallas kernels place points by another rounding of the cell
    # coordinate than the jitted oracle the port follows (ROADMAP.md,
    # faults): on points where both forms give the same coordinate on every
    # level the outputs agree to 1e-6 (|table| <= 1); elsewhere a feature
    # moves by at most its trilinear slope, 2 max|table| per unit, times
    # the coordinates' difference (an ulp or two of a coordinate up to 128).
    # Few levels: the interpreter's cost grows with the unrolled levels
    je, te = _pair(scheme, n_levels=1 if version == "v1" else 2)
    pts = _pts(300, 6)
    tab = _table(je.table_rows, 7)
    want = np.asarray(JHE.hash_encode_fused(
        jnp.asarray(tab), jnp.asarray(pts), **_fused_kwargs(je, version,
                                                            packed)))
    got = KS.hash_encode_fused(t(tab), t(pts), te, version, packed).numpy()
    assert got.shape == (300, 2 * te.n_levels)
    rel_p = _pallas_rel(je, pts)
    rel_j = te.hashed_rel(t(pts)).numpy()
    np.testing.assert_array_equal(np.floor(rel_p), np.floor(rel_j))
    same = (rel_p == rel_j).all(axis=(1, 2))
    assert same.sum() >= 30
    np.testing.assert_allclose(got[same], want[same], atol=1e-6)
    bound = 2.0 * np.abs(rel_p - rel_j).sum(-1)            # [N, L]
    assert (np.abs(got - want).reshape(300, -1, 2)
            <= bound[..., None] + 1e-6).all()


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_plain_matches_xla_and_v1_equals_v2(scheme):
    # the f32-table plain version against the jitted XLA gather, and the
    # port's v1 route is its v2 f32 route, bit for bit
    je, te = _pair(scheme)
    pts = np.concatenate([_pts(2000, 8), _faces_and_boundaries(te, 500, 9)])
    tab = _table(je.table_rows, 10)
    ref = np.asarray(jax.jit(lambda tb, p: gather_trilerp_reference(
        tb, *je.corner_indices(p)))(jnp.asarray(tab), jnp.asarray(pts)))
    v2 = KS.hash_encode_fused(t(tab), t(pts), te, "v2", packed=False)
    v1 = KS.hash_encode_fused(t(tab), t(pts), te, "v1", packed=True)
    np.testing.assert_allclose(v2.numpy(), ref.reshape(len(pts), -1),
                               atol=1e-6)
    assert torch.equal(v1, v2)


def _grad_case(scheme, n, seed):
    je, te = _pair(scheme)
    pts = _pts(n, seed)
    g = np.random.RandomState(seed + 1).standard_normal(
        (n, je.output_dims)).astype(np.float32)
    return je, te, pts, g


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_grad_plain_matches_xla_autodiff(scheme):
    # index_add_ of w * g against XLA's gradient of the f32 gather, and
    # each entry within 1e-6 of the sum of its terms' magnitudes of the
    # float64 sum
    je, te, pts, g = _grad_case(scheme, 1500, 3)

    @jax.jit
    def oracle(table):
        def f(tab):
            out = gather_trilerp_reference(
                tab, *je.corner_indices(jnp.asarray(pts)))
            return jnp.sum(out.reshape(len(pts), -1) * g)
        return jax.grad(f)(table)

    ref = np.asarray(oracle(jnp.zeros((je.table_rows, 2), jnp.float32)))
    got = KS.grad_small(t(g), t(pts), te).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=5e-5)
    idx, frac = te.corner_indices(t(pts))
    terms = (trilerp_weights(frac.double()).numpy()[..., None]
             * g.astype(np.float64).reshape(len(pts), -1, 1, 2)).reshape(-1, 2)
    exact = np.zeros((te.table_rows, 2))
    mag = np.zeros((te.table_rows, 2))
    np.add.at(exact, idx.numpy().reshape(-1), terms)
    np.add.at(mag, idx.numpy().reshape(-1), np.abs(terms))
    assert (np.abs(got - exact) <= 1e-6 * mag + 1e-12).all()


@pytest.mark.parametrize("scheme", ["random"])
def test_encoder_autograd_matches_jax_custom_vjp(scheme):
    # loss sum(f * g) through both packages' kernel paths: the JAX custom
    # VJP (Pallas forward in interpret mode, bf16 one-hot matmul backward)
    # and the port's HashEncodeSmall (plain versions). The JAX backward
    # rounds each term's operands to bf16: 5e-3 of the largest entry, as
    # tests/test_pallas_kernel.py holds it
    kw = dict(KW, n_levels=2, scheme=scheme)
    jk = JaxEncoder(BBOX, use_pallas=True, **kw)
    pts = _pts(256, 11)
    g = np.random.RandomState(12).standard_normal(
        (256, jk.output_dims)).astype(np.float32)
    tab = _table(jk.table_rows, 12)
    gj = jax.grad(lambda p: jnp.sum(jk(p, jnp.asarray(pts))[0] * g))(
        {"table": jnp.asarray(tab)})["table"]
    tk = HashGridEncoder(BBOX, use_kernel=True, device="cpu", **kw)
    with torch.no_grad():
        tk.table.copy_(t(tab))
    feats, keep = tk(t(pts))
    torch.sum(feats * t(g)).backward()
    got = tk.table.grad.numpy()
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(got / scale, np.asarray(gj) / scale,
                               atol=5e-3)
    # the forward is K4 over the bf16-packed table, no point gradient
    assert torch.equal(feats.detach(), KS.hash_encode_fused(
        t(tab), t(pts), tk, "v2", packed=True))
    assert keep.all()


@pytest.mark.parametrize("level", [0, 3])
def test_tv_loss_matches_jax(level):
    # value and gradient with the same cube origin: JAX draws it from its
    # key, the port takes it as a tensor
    je, te = _pair("fixed")
    tab = _table(je.table_rows, 13)
    key = jax.random.PRNGKey(level)
    res, cube = tv_cube_size(te, level)
    mv = np.asarray(jax.random.randint(key, (3,), 0, max(res - cube, 1)))
    val_j, g_j = jax.value_and_grad(lambda p: jax_tv(
        je, {"table": p}, level, key))(jnp.asarray(tab))
    tt = t(tab).requires_grad_(True)
    val_t = total_variation_loss(te, tt, level, torch.tensor(mv))
    val_t.backward()
    assert float(val_t.detach()) == pytest.approx(float(val_j), rel=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-7)
    with pytest.raises(ValueError, match="fixed"):
        total_variation_loss(_pair("random")[1], tt, 0, torch.tensor(mv))


def test_kernel_accepts_what_the_jax_kernel_accepts():
    # supports(): F = 2, T a multiple of 1,024, L * T * 2 * 4 <= 4 MB
    for lv, log2t, ok in ((16, 13, True), (16, 15, True), (16, 16, False),
                          (1, 19, True), (1, 20, False), (4, 9, False)):
        cfg = dict(n_levels=lv, log2_hashmap_size=log2t)
        assert KS.supports(lv, 1 << log2t, 2) == ok
        if ok:
            HashGridEncoder(BBOX, use_kernel=True, device="cpu",
                            scheme="random", **cfg)
            JaxEncoder(BBOX, use_pallas=True, scheme="random", **cfg)
            continue
        with pytest.raises(ValueError, match="fused kernel"):
            HashGridEncoder(BBOX, use_kernel=True, device="cpu",
                            scheme="random", **cfg)
        with pytest.raises(ValueError):
            JaxEncoder(BBOX, use_pallas=True, scheme="random", **cfg)
    # the f32 gather has no CUDA kernel: CPU tensors only (see the GPU
    # tests); the kernel wrappers check their inputs
    _, te = _pair("random")
    with pytest.raises(ValueError, match="unsupported device"):
        KS.encode_small(torch.zeros(te.table_rows, dtype=torch.int32,
                                    device="meta"),
                        torch.zeros(8, 3, device="meta"), te)
    with pytest.raises(ValueError, match="not a small-table"):
        KS._check_enc(_pair("blocked", log2_hashmap_size=12)[1], "cpu")


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("log2_t", range(10, 20))
def test_small_plan_covers_every_level_and_tile_once(log2_t, packed):
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


def test_small_plan_at_the_serving_shape():
    # 16 levels, T = 2^13: four levels a group (one 32-byte sector of each
    # row), all staged packed, three of four with the f32 table. T = 2^15:
    # four levels a group, one staged packed; the f32 table is gathered
    # from L2 in whole rows
    serving = 8_388_608
    assert KS.small_stage(16, 1 << 13, True) == (4, 4, 163840)
    assert KS.small_stage(16, 1 << 13, False) == (4, 3, 229376)
    assert KS.small_stage(16, 1 << 15, True) == (4, 1, 163840)
    assert KS.small_stage(16, 1 << 15, False) == (16, 0, 131072)
    plan = KS.small_plan(serving, 16, 1 << 13, True, 132)
    assert (plan.n_groups, plan.grid) == (4, 132)
    assert KS.small_plan(1000, 16, 1 << 13, True, 132).grid == 4


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


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("log2_t,levels,case", [(10, 4, "uniform"),
                                                (13, 2, "crowded"),
                                                (13, 1, "few")])
def test_small_bin_pass_plan(scheme, log2_t, levels, case):
    # at the small table's bins (512 entries; the whole level at 2^9 and
    # less): every (point, level, corner) once, in its entry's bin, each
    # bin's records one run in the fixed order (tile, then points 32 at a
    # time, corners in order, lanes ascending); the run offsets the
    # exclusive scan of the counts; a crowded cell splits its bins into
    # parts, few points leave bins empty; the plan's items list each bin's
    # parts in order
    _, te = _pair(scheme, use_kernel=True, n_levels=levels,
                  log2_hashmap_size=log2_t)
    pts = {"uniform": _pts(1100, 21), "crowded": _crowded(te, 4500, 22),
           "few": _pts(5, 23)}[case]
    n = len(pts)
    bl, nb, tp, part, nt, _ = KL.bins_shape(n, te)
    recs, offs, plan = KL.grad_large_bins(t(pts), te)
    idx, _ = te.corner_indices(t(pts))
    local = (idx - torch.arange(levels)[None, :, None]
             * te.level_size).numpy()
    r = recs.numpy().astype(np.int64)
    p, d = r >> 3, r & 7
    # the counts per (level, bin, tile), read off the records themselves
    l_of = np.repeat(np.arange(levels), 8 * n)
    counts = np.zeros((levels, nb, nt), np.int64)
    np.add.at(counts, (l_of, local[p, l_of, d] >> bl, p // tp), 1)
    flat = counts.reshape(-1)
    np.testing.assert_array_equal(offs.numpy().reshape(-1),
                                  np.cumsum(flat) - flat)
    # each (level, bin, tile) run holds its records
    run = (l_of * nb + (local[p, l_of, d] >> bl)) * nt + p // tp
    assert (np.diff(run) >= 0).all()
    seen = np.zeros((n, levels, 8), np.int64)
    np.add.at(seen, (p, l_of, d), 1)
    assert (seen == 1).all()
    q = p % tp
    key = run * 8 * tp + ((q // 32) * 8 + d) * 32 + q % 32
    assert (np.diff(key) > 0).all()
    totals = counts.sum(-1).reshape(-1)
    parts = np.where(totals == 0, 1, -(-totals // part))
    n_items = int(parts.sum())
    head = 4 + 4 * levels * nb
    assert int(plan[0]) == n_items
    np.testing.assert_array_equal(plan[4:head].numpy(), np.concatenate(
        [totals, parts, plan[4 + 2 * levels * nb:4 + 3 * levels * nb].numpy(),
         np.cumsum(totals) - totals]))
    items = plan[head:head + 2 * n_items].numpy().reshape(-1, 2)
    np.testing.assert_array_equal(items[:, 0], np.repeat(
        np.arange(levels * nb), parts))
    np.testing.assert_array_equal(items[:, 1], np.concatenate(
        [np.arange(k) for k in parts]))
    if case == "crowded":
        assert int(plan[1]) > 0
    if case == "few":
        assert (totals == 0).any()


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("log2_t,levels,case", [(10, 4, "uniform"),
                                                (13, 2, "crowded")])
def test_small_binned_sum_matches_jax_vjp(scheme, log2_t, levels, case):
    # the terms summed in the bin pass's order against jax.vjp of the JAX
    # package's gather_trilerp_reference over the JAX encoder's corners,
    # each entry within 1e-5 of the sum of its terms' magnitudes
    je, te = _pair(scheme, n_levels=levels, log2_hashmap_size=log2_t)
    pts = _pts(1100, 24) if case == "uniform" else _crowded(te, 4500, 25)
    g = np.random.RandomState(26).standard_normal(
        (len(pts), je.output_dims)).astype(np.float32)
    idx, frac = jax.jit(je.corner_indices)(jnp.asarray(pts))
    _, vjp = jax.vjp(lambda tab: gather_trilerp_reference(tab, idx, frac),
                     jnp.zeros((je.table_rows, 2), jnp.float32))
    ref = np.asarray(vjp(jnp.asarray(g.reshape(len(pts), -1, 2)))[0])
    got = KL.grad_large_binned_plain(t(g), t(pts), te).numpy()
    mag = KS.grad_small_plain(t(np.abs(g)), t(pts), te).numpy()
    assert np.all(np.abs(got - ref) <= 1e-5 * mag + 1e-30)
    assert np.abs(got).max() > 0
