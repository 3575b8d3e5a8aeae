"""Port parity: blocked hash encoder and its kernels' plain versions.

The port (nerfpp_tpu_torch, on the CPU, where every kernel wrapper runs its
plain PyTorch version) against the JAX package on the same numpy inputs.
Integer layouts must match exactly, so tables move between the packages.

The exact integer layouts (Morton codes, level scales and block offsets,
corner indices, the packed table's bits) and the wrappers' checks:
tests/test_torch_hashgrid_exact.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference as jax_gather
from nerfpp_tpu.pallas import hash_encode_blocked as JB
from nerfpp_tpu.pallas.hash_encode_blocked import build_window_lists
from nerfpp_tpu.pallas.hash_encode_blocked import (
    hash_encode_blocked as jax_heb)
from nerfpp_tpu_torch.encoders.hashgrid import morton3
from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
from tests.torch_hashgrid_common import (KW, _bf16, _boundary_pts, _pair,
                                         _pallas_form_codes, _pts)

torch.set_num_threads(1)


@pytest.mark.parametrize("coherent", [False, True])
def test_window_lists_plain_matches_build_window_lists(coherent):
    # exact: the sorted unique window ids, sentinel padding and counts
    je, te = _pair()
    if coherent:
        pts = _pts(4096, seed=5, lo=np.float32([0.1, 0.1, 0.1]),
                   hi=np.float32([0.25, 0.2, 0.3]))
    else:
        pts = _pts(4096, seed=4)
    ng = pts.shape[0] // 128
    wids_j, _ = jax.jit(lambda p: build_window_lists(p, je))(
        jnp.asarray(pts).reshape(ng, 128, 3))
    wids_j = np.asarray(wids_j).reshape(KW["n_levels"], ng, 128)
    wids_t, counts_t = K.window_lists(torch.from_numpy(pts), te)
    np.testing.assert_array_equal(wids_t.numpy(), wids_j)
    np.testing.assert_array_equal(
        counts_t.numpy(), (wids_j != K.SENTINEL).sum(-1).astype(np.int32))


@pytest.mark.parametrize("points", ["random", "coherent", "boundary"])
def test_window_lists_plain_matches_pallas_kernel(points):
    # the Pallas K1 itself (_windows_call, interpret mode) against the
    # port's plain K1 at 2 levels on 2,048 points: ids and counts equal in
    # every (level, group) except where a point's cell differs between the
    # Pallas form (x - min) * (inv * scale) and the port's jitted form
    # (x - min) * inv * scale (ROADMAP.md section 3); such points are
    # counted, and their groups must hold the Pallas form's own lists.
    # Scales 24 and 200: at powers of two the two forms round alike.
    je, te = _pair(n_levels=2, base_resolution=24, finest_resolution=200)
    n, nl = 2048, 2
    if points == "coherent":
        pts = _pts(n, seed=13, lo=np.float32([0.1, 0.1, 0.1]),
                   hi=np.float32([0.25, 0.2, 0.3]))
    elif points == "boundary":
        pts = _boundary_pts(te, n, 14)
    else:
        pts = _pts(n, seed=15)
    gp = JB.PREPASS_GROUPS
    pts_p = jnp.asarray(pts).reshape(n // (gp * 128), gp, 128, 3).transpose(
        0, 3, 1, 2)
    wids_k, cnts_k = JB._windows_call(
        pts_p, jnp.asarray(je.level_scales, jnp.float32),
        jnp.asarray(je.block_offsets, jnp.int32).reshape(-1), n_levels=nl,
        box_min=tuple(float(v) for v in je.bounding_box[:3]),
        box_max=tuple(float(v) for v in je.bounding_box[3:]))
    # [blocks, L, 8 groups, 128] -> [L, NG, 128]
    wids_k = np.asarray(wids_k).transpose(1, 0, 2, 3).reshape(nl, -1, 128)
    cnts_k = np.asarray(cnts_k)[..., 0].transpose(1, 0, 2).reshape(nl, -1)
    wids_t, counts_t = (v.numpy() for v in
                        K.window_lists(torch.from_numpy(pts), te))
    cell, _ = te.blocked_cell_frac(torch.from_numpy(pts))
    o = te.blocked_oct(cell) >> 1
    port = morton3(o[..., 0], o[..., 1], o[..., 2]).numpy().reshape(
        -1, 128, nl).transpose(2, 0, 1)
    pallas = _pallas_form_codes(pts, je)
    moved = port != pallas                                  # [L, NG, 128]
    differs = moved.any(-1)
    same = ~differs
    np.testing.assert_array_equal(wids_t[same], wids_k[same])
    np.testing.assert_array_equal(counts_t[same], cnts_k[same])
    for l, grp in zip(*np.nonzero(differs)):
        u = np.unique(pallas[l, grp])
        np.testing.assert_array_equal(wids_k[l, grp, :u.size], u)
        assert (wids_k[l, grp, u.size:] == K.SENTINEL).all()
        assert cnts_k[l, grp] == u.size
    # the two forms disagree only at cell boundaries
    assert int(moved.sum()) <= (n * nl // 10 if points == "boundary"
                                else n * nl // 1000), int(moved.sum())


def test_plain_encode_matches_xla_oracle():
    # bf16-rounded table, |values| <= 1: f32 weights on both sides, so only
    # the order of the eight corner products differs (~1 ulp of |v| <= 1)
    je, te = _pair()
    pts = _pts(3000, seed=6)
    tab = np.random.RandomState(7).uniform(-1, 1, (je.table_rows, 2)
                                           ).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t, p: jax_gather(
        t, *je.corner_indices(p)))(jnp.asarray(_bf16(tab)), jnp.asarray(pts)))
    got = K.hash_encode_blocked(torch.from_numpy(tab), torch.from_numpy(pts),
                                te)
    np.testing.assert_allclose(got.numpy(), ref.reshape(3000, -1), atol=5e-7)


def test_plain_encode_matches_pallas_interpret():
    # the Pallas kernel in interpret mode rounds each trilinear weight to
    # bf16; at the init scale (|table| <= 1e-4) that bounds the gap by
    # 8 corners x 2^-9 x 1e-4 ~ 2e-6, and the JAX test's atol=5e-7 holds
    je, te = _pair()
    pts = _pts(2048, seed=8)
    tab = np.array(je.init(jax.random.PRNGKey(0))["table"])
    want = np.asarray(jax_heb(jnp.asarray(tab), jnp.asarray(pts), je))
    got = K.hash_encode_blocked(torch.from_numpy(tab), torch.from_numpy(pts),
                                te)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-7)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encoder_forward_clamps_and_masks(use_kernel):
    # out-of-bbox points are clamped and masked; without the kernel the
    # plain gather reads the f32 table (the JAX XLA path), with it the
    # bf16-packed table
    je, te = _pair(use_kernel=use_kernel)
    rng = np.random.RandomState(9)
    tab = rng.uniform(-1, 1, (je.table_rows, 2)).astype(np.float32)
    pts = np.concatenate([_pts(500, seed=10),
                          [[2.0, 0.0, 0.0], [-5.0, -5.0, -5.0],
                           [1.5, 1.0, 1.3]]]).astype(np.float32)
    jtab = _bf16(tab) if use_kernel else tab
    feats_j, keep_j = jax.jit(lambda t, p: je({"table": t}, p))(
        jnp.asarray(jtab), jnp.asarray(pts))
    with torch.no_grad():
        te.table.copy_(torch.from_numpy(tab))
        feats_t, keep_t = te(torch.from_numpy(pts))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                               atol=5e-7)


@pytest.mark.parametrize("points", ["uniform", "coherent", "aliasing"])
def test_grad_index_plain_matches_k1_lists(points):
    # K3's window index (plain version) against a numpy construction from
    # the plain K1 lists: one bit per (level, window, group), each segment
    # the window's groups in ascending order, each once; each listed
    # window's run in the group's permutation holds exactly the group's
    # points in that window, ascending; the plan splits a window of n points
    # into ceil(n / 2048) parts, in window order (8,192 coherent points put
    # more than 2,048 in a coarse window). At T = 2^12 a level has 4
    # windows, so many of the uniform points' distinct codes alias
    log2_t = 12 if points == "aliasing" else 16
    _, te = _pair(log2_hashmap_size=log2_t)
    if points == "coherent":
        pts = _pts(8192, seed=21, lo=np.float32([0.1, 0.1, 0.1]),
                   hi=np.float32([0.25, 0.2, 0.3]))
    else:
        pts = _pts(4096, seed=22)
    pts = torch.from_numpy(pts)
    wids, counts = K.window_lists_plain(pts, te)
    mask, perm, table, plan = K.grad_blocked_index_plain(pts, wids, counts,
                                                         te)
    nl, ng = counts.shape
    nw = max(te.block_slots // 8, 1)
    assert mask.shape == (nl, nw, -(-ng // 32)) and mask.dtype == torch.int32
    assert perm.shape == (nl, ng * 128) and perm.dtype == torch.uint8
    assert table.shape == (nl, nw, ng) and table.dtype == torch.int16
    cell, _ = te.blocked_cell_frac(pts)
    pwin = (te.blocked_slot(cell) >> 3).t().numpy()          # [L, N]
    perm, table = perm.numpy().astype(np.int64), table.numpy()
    wids, counts = wids.numpy(), counts.numpy()
    want = np.zeros(mask.shape, np.uint32)
    segments = {}
    aliased = 0
    for lvl in range(nl):
        for grp in range(ng):
            listed = wids[lvl, grp, :counts[lvl, grp]] & (nw - 1)
            aliased += len(listed) - len(set(listed.tolist()))
            for w in listed:
                want[lvl, w, grp // 32] |= np.uint32(1 << (grp % 32))
                segments.setdefault((lvl, int(w)), []).append(grp)
            own = pwin[lvl, grp * 128:(grp + 1) * 128]
            assert set(own.tolist()) == set(listed.tolist()), (lvl, grp)
            row = perm[lvl, grp * 128:(grp + 1) * 128]
            assert sorted(row.tolist()) == list(range(128))
            for w in set(listed.tolist()):
                run = int(table[lvl, w, grp])
                got = row[run & 255:(run >> 8) + 1]
                np.testing.assert_array_equal(got, np.flatnonzero(own == w))
    np.testing.assert_array_equal(mask.numpy().view(np.uint32), want)
    bits = np.unpackbits(mask.numpy().view(np.uint8), bitorder="little")
    bits = bits.reshape(nl, nw, -1)[..., :ng]
    for (lvl, w), grps in segments.items():
        seg = np.flatnonzero(bits[lvl, w])
        assert seg.tolist() == sorted(set(grps)), (lvl, w)
    assert bits.sum() == sum(len(set(g)) for g in segments.values())
    assert aliased > 0 or points != "aliasing"
    # the plan, built in numpy from each point's window
    plan = plan.numpy()
    npts = np.stack([np.bincount(pwin[lvl], minlength=nw)
                     for lvl in range(nl)]).reshape(-1)
    assert ((npts > 0) == bits.any(-1).reshape(-1)).all()
    items, slots, n_slots = [], [], 0
    for wi, c in enumerate(npts):
        n_parts = max(1, -(-int(c) // K.GRAD_PART_POINTS))
        items += [(wi, p) for p in range(n_parts)]
        slots.append(n_slots if n_parts > 1 else 0)
        n_slots += n_parts if n_parts > 1 else 0
    parts = np.maximum(1, -(-npts // K.GRAD_PART_POINTS))
    assert (parts > 1).any() == (points == "coherent")
    lw = nl * nw
    np.testing.assert_array_equal(plan[:4], [len(items), n_slots, 0, 0])
    np.testing.assert_array_equal(plan[4:4 + 3 * lw],
                                  np.concatenate([npts, parts, slots]))
    tail = plan[4 + 3 * lw:]
    np.testing.assert_array_equal(tail[:2 * len(items)],
                                  np.asarray(items).reshape(-1))
    assert not tail[2 * len(items):].any()
