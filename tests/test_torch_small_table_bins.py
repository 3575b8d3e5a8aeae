"""Port parity: the order-fixed gradient that grad_small launches on the card,
at the small table's bins, on the CPU: its bin pass's plan read back
against its definition, and the sum in the plan's order against jax.vjp of
the XLA gather.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference
from nerfpp_tpu_torch.kernels import hash_encode as KS
from nerfpp_tpu_torch.kernels import hash_encode_large as KL
from tests.torch_small_table_common import _crowded, _pair, _pts, t

torch.set_num_threads(1)


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
