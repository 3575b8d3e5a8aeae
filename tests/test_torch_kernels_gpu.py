"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These run only where CUDA is available (marker ``cuda``); elsewhere each
test skips with a reason. The JAX package is not installed beside the card, and the repo's
tests/conftest.py imports it, so run this file without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

chip_smoke.py holds the kernels at the main paths' shapes; these tests cover
the edges: small tables whose 8-row windows wrap (S < 8), points within a few
ulps of cell boundaries, out-of-box points, padded groups, the gradient's
unused lanes, the launch counters, and the wrappers' input checks; for the
small-table kernels (encode_small, grad_small) the table sizes from 2^10 to
2^15 entries at 4 and 16 levels and one 2^19-entry level (staged and direct
gathers), point counts that fill no block, points on the box faces, packed
and f32 tables, the v1 route, and inputs the wrappers refuse; the launch
plans at their edges: encode_small's persistent grid at 1 to many tiles,
1-64 levels (odd counts too) and every staging mode, encode_blocked at 1-64
levels, a partial block of teams, and 1 and 128 windows per group.
"""
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.kernels import hash_encode as KS
from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts

BBOX = [-1.5, -1.0, -1.2, 1.5, 1.0, 1.3]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _encoder(dev, log2_t=12, levels=4, finest=128):
    return HashGridEncoder(BBOX, levels, 2, log2_t, 16, finest,
                           use_kernel=True, device=dev)


def _boundary_points(enc, n, seed):
    """Points within +-3 ulps of cell boundaries of random levels."""
    rng = np.random.RandomState(seed)
    bb = np.asarray(BBOX, np.float32)
    lvl = rng.randint(0, enc.n_levels, n)
    scale = enc.level_scales[lvl][:, None].astype(np.float64)
    cell = np.floor(rng.uniform(0, 1, (n, 3)) * scale)
    x = (bb[:3] + cell / scale * (bb[3:] - bb[:3])).astype(np.float32)
    steps = rng.randint(-3, 4, (n, 3))
    for s in range(3):
        x = np.where(steps > s, np.nextafter(x, np.float32(np.inf)), x)
        x = np.where(steps < -s, np.nextafter(x, np.float32(-np.inf)), x)
    return np.clip(x, bb[:3], bb[3:])


def _point_sets(enc, dev):
    g = torch.Generator().manual_seed(0)
    lo = torch.tensor(BBOX[:3])
    ext = torch.tensor(BBOX[3:]) - lo
    uniform = torch.rand(4096, 3, generator=g) * ext + lo
    coherent = torch.rand(4096, 3, generator=g) * 0.05 * ext + lo + 0.4 * ext
    edges = torch.from_numpy(_boundary_points(enc, 4096, 1))
    return {name: p.to(dev).contiguous() for name, p in
            (("uniform", uniform), ("coherent", coherent), ("edges", edges))}


@pytest.mark.parametrize("log2_t", [7, 9, 12, 19])
def test_kernels_match_plain_versions(cuda, log2_t):
    # K1 exactly; K2 within 1e-6 at |table| <= 1 (f32 weights on both
    # sides, only the order of the corner products differs). log2_t 7 and 9
    # give S = 1 and 4 block rows per level, so the staged windows wrap.
    enc = _encoder(cuda, log2_t)
    g = torch.Generator().manual_seed(log2_t)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    packed = K.pack_table_bf16(table)
    for name, pts in _point_sets(enc, cuda).items():
        wids, counts = K.window_lists(pts, enc)
        wids_p, counts_p = K.window_lists_plain(pts, enc)
        assert torch.equal(wids, wids_p), name
        assert torch.equal(counts, counts_p), name
        out = K.encode_blocked(packed, pts, wids, counts, enc)
        out_p = K.encode_blocked_plain(packed, pts, wids, counts, enc)
        torch.cuda.synchronize()
        err = float((out - out_p).abs().max())
        assert err <= 1e-6, (name, err)


def test_encoder_forward_kernel_matches_plain_gather(cuda):
    # the kernel path reads the bf16-packed table; the plain gather on the
    # bf16-rounded f32 table computes the same function. Out-of-box points
    # are clamped and masked the same way on both paths.
    enc = _encoder(cuda)
    plain = HashGridEncoder(BBOX, 4, 2, 12, 16, 128, use_kernel=False,
                            device="cpu")
    g = torch.Generator().manual_seed(3)
    table = torch.rand(enc.table_rows, 2, generator=g) * 2 - 1
    with torch.no_grad():
        enc.table.copy_(table)
        plain.table.copy_(table.to(torch.bfloat16).float())
    pts = torch.cat([_point_sets(enc, "cpu")["uniform"][:999],
                     torch.tensor([[2.0, 0.0, 0.0], [-5.0, -5.0, -5.0]])])
    with torch.no_grad():
        f_k, keep_k = enc(pts.to(cuda))
        f_p, keep_p = plain(pts)
    assert f_k.shape == (1001, 8)
    keep_k = keep_k.cpu()
    assert torch.equal(keep_k, keep_p) and not bool(keep_k[-2:].any())
    assert float((f_k.cpu() - f_p).abs().max()) <= 1e-6


def test_encoder_f32_gather_raises_on_cuda(cuda):
    # the f32-table gather has no kernel: on the card the encoder launches
    # the bf16 kernel pair or raises, never the plain gather
    enc = HashGridEncoder(BBOX, 4, 2, 12, 16, 128, use_kernel=False,
                          device=cuda)
    pts = _point_sets(enc, cuda)["uniform"][:256]
    reset_launch_counts()
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        enc(pts)
    assert set(launch_counts().values()) == {0}


def test_launch_counts_move_once_per_launch(cuda):
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["uniform"][:300]
    reset_launch_counts()
    K.hash_encode_blocked(enc.table.detach(), pts, enc)
    K.window_lists_plain(K.pad_points(pts, enc), enc)
    assert launch_counts() == {"window_lists": 1, "encode_blocked": 1,
                               "grad_blocked": 0, "encode_small": 0,
                               "grad_small": 0}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["uniform"][:256]
    with pytest.raises(TypeError, match="dtype"):
        K.window_lists(pts.double(), enc)
    with pytest.raises(ValueError, match="contiguous"):
        K.window_lists(pts.t().contiguous().t(), enc)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.window_lists(pts[:200].contiguous(), enc)
    wids, counts = K.window_lists(pts, enc)
    packed = K.pack_table_bf16(enc.table.detach())
    with pytest.raises(ValueError, match="shape"):
        K.encode_blocked(packed[:-1], pts, wids, counts, enc)
    with pytest.raises(ValueError, match="window ids is on cpu"):
        K.encode_blocked(packed, pts, wids.cpu(), counts, enc)


def _grad_close(got, plain, mag):
    """K3's atomics sum in a run-dependent order: each entry within 1e-5 of
    the sum of its terms' magnitudes."""
    return bool(((got - plain).abs() <= 1e-5 * mag + 1e-30).all())


@pytest.mark.parametrize("log2_t", [12, 19])
def test_grad_kernel_matches_plain_version(cuda, log2_t):
    # uniform, coherent (the warp-aggregated same-cell case) and
    # cell-boundary points; lanes 125-127 of every row stay zero
    enc = _encoder(cuda, log2_t, levels=16 if log2_t == 19 else 4,
                   finest=1024 if log2_t == 19 else 128)
    g = torch.Generator().manual_seed(log2_t)
    for name, pts in _point_sets(enc, cuda).items():
        cot = torch.randn(pts.shape[0], 2 * enc.n_levels, generator=g).to(cuda)
        got = K.grad_blocked(cot, pts, enc)
        torch.cuda.synchronize()
        plain = K.grad_blocked_plain(cot, pts, enc)
        mag = K.grad_blocked_plain(cot.abs(), pts, enc)
        assert _grad_close(got, plain, mag), name
        assert not bool(got.reshape(-1, 128, 2)[:, 125:].any()), name


def test_grad_kernel_padded_points_contribute_nothing(cuda):
    # 300 points padded to 384: the cotangent covers the first 300 only
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["uniform"][:300]
    cot = torch.randn(300, 8, generator=torch.Generator().manual_seed(5))
    cot = cot.to(cuda)
    padded = K.pad_points(pts, enc)
    assert padded.shape[0] == 384
    got = K.grad_blocked(cot, padded, enc)
    torch.cuda.synchronize()
    plain = K.grad_blocked_plain(cot, pts, enc)
    assert _grad_close(got, plain, K.grad_blocked_plain(cot.abs(), pts, enc))
    # the padding sits at box_min: its corner entries get nothing from it
    lone = K.grad_blocked(cot[:0], padded, enc)
    assert not bool(lone.any())


def test_grad_launch_count_moves_once_per_backward(cuda):
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["coherent"][:1000]
    reset_launch_counts()
    feats, _ = enc(pts)
    torch.sin(3.0 * feats).sum().backward()
    assert launch_counts() == {"window_lists": 1, "encode_blocked": 1,
                               "grad_blocked": 1, "encode_small": 0,
                               "grad_small": 0}
    # the gradient is K3's: equal to the plain version of the same cotangent
    cot = 3.0 * torch.cos(3.0 * feats.detach())
    padded = K.pad_points(pts, enc)
    plain = K.grad_blocked_plain(cot, padded, enc)
    mag = K.grad_blocked_plain(cot.abs(), padded, enc)
    assert _grad_close(enc.table.grad, plain, mag)


def test_grad_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["uniform"][:256]
    cot = torch.zeros(256, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        K.grad_blocked(cot.double(), pts, enc)
    with pytest.raises(ValueError, match="shape"):
        K.grad_blocked(cot[:, :6].contiguous(), pts, enc)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.grad_blocked(cot[:200].contiguous(), pts[:200].contiguous(), enc)
    with pytest.raises(ValueError, match="rows for"):
        K.grad_blocked(torch.zeros(384, 8, device=cuda), pts, enc)
    with pytest.raises(ValueError, match="contiguous"):
        K.grad_blocked(torch.zeros(8, 256, device=cuda).t(), pts, enc)
    with pytest.raises(ValueError, match="cotangent is on cpu"):
        K.grad_blocked(cot.cpu(), pts, enc)


# ------------------------------------------------------ small-table kernels

def _small_encoder(dev, scheme, log2_t, levels):
    return HashGridEncoder(BBOX, levels, 2, log2_t, 16, 1024, scheme=scheme,
                           use_kernel=True, device=dev)


def _small_points(enc, dev, n=4001):
    """Uniform, coherent, cell-boundary and box-face points; n fills no
    block of the kernels (1,024 and 128 points)."""
    g = torch.Generator().manual_seed(n)
    bb = np.asarray(BBOX, np.float32)
    lo, ext = torch.tensor(bb[:3]), torch.tensor(bb[3:] - bb[:3])
    uniform = torch.rand(n, 3, generator=g) * ext + lo
    coherent = torch.rand(n, 3, generator=g) * 0.02 * ext + lo + 0.4 * ext
    rng = np.random.RandomState(n)
    scale = (enc.resolutions if enc.scheme == "fixed"
             else enc.level_scales)[rng.randint(0, enc.n_levels, n)]
    scale = np.asarray(scale, np.float64)[:, None]
    cell = np.floor(rng.uniform(0, 1, (n, 3)) * scale)
    edges = (bb[:3] + cell / scale * (bb[3:] - bb[:3])).astype(np.float32)
    edges = np.nextafter(edges, np.where(rng.uniform(size=(n, 3)) < 0.5,
                                         np.float32(-np.inf),
                                         np.float32(np.inf)))
    faces = uniform.clone()
    axis = torch.arange(n) % 3
    side = (torch.arange(n) // 3) % 2
    faces[torch.arange(n), axis] = torch.tensor(bb)[3 * side + axis]
    sets = {"uniform": uniform, "coherent": coherent, "faces": faces,
            "edges": torch.from_numpy(np.clip(edges, bb[:3], bb[3:]))}
    return {k: v.to(dev).contiguous() for k, v in sets.items()}


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("log2_t,levels", [(10, 4), (13, 16), (15, 16),
                                           (19, 1), (10, 64)])
def test_small_encode_matches_plain_version(cuda, scheme, log2_t, levels):
    # within 1e-6 at |table| <= 1 for the packed and the f32 table (T = 2^10
    # and 2^13 stage each level in shared memory, 2^15 and 2^19 gather from
    # device memory; at 64 levels the output rows no longer fit the tile
    # and each level's pair is stored directly); v1 is the f32 route, bit
    # for bit
    enc = _small_encoder(cuda, scheme, log2_t, levels)
    g = torch.Generator().manual_seed(log2_t)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    packed = K.pack_table_bf16(table)
    for name, pts in _small_points(enc, cuda).items():
        for pk, tab in ((True, packed), (False, table)):
            out = KS.encode_small(tab, pts, enc, pk)
            torch.cuda.synchronize()
            err = float((out - KS.encode_small_plain(tab, pts, enc, pk))
                        .abs().max())
            assert err <= 1e-6, (name, pk, err)
        assert torch.equal(KS.hash_encode_fused(table, pts, enc, "v1"),
                           KS.hash_encode_fused(table, pts, enc, "v2",
                                                packed=False)), name


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("log2_t,levels", [(10, 4), (15, 16), (19, 1)])
def test_small_grad_matches_plain_version(cuda, scheme, log2_t, levels):
    # atomics sum in a run-dependent order: each entry within 1e-5 of the
    # sum of its terms' magnitudes; coherent points exercise the warp's
    # same-cell sums, 4,001 points a partial block
    enc = _small_encoder(cuda, scheme, log2_t, levels)
    g = torch.Generator().manual_seed(log2_t + 1)
    for name, pts in _small_points(enc, cuda).items():
        cot = torch.randn(pts.shape[0], 2 * levels, generator=g).to(cuda)
        got = KS.grad_small(cot, pts, enc)
        torch.cuda.synchronize()
        plain = KS.grad_small_plain(cot, pts, enc)
        mag = KS.grad_small_plain(cot.abs(), pts, enc)
        assert _grad_close(got, plain, mag), name
    assert not bool(KS.grad_small(cot[:0], pts[:0], enc).any())


def test_small_launch_counts_move_once_per_launch(cuda):
    # the encoder's forward launches encode_small, its backward grad_small;
    # the plain versions count nothing; the table gradient is the kernel's
    enc = _small_encoder(cuda, "random", 13, 16)
    pts = _small_points(enc, cuda, 3000)["coherent"]
    reset_launch_counts()
    feats, _ = enc(pts)
    torch.sin(3.0 * feats).sum().backward()
    KS.encode_small_plain(K.pack_table_bf16(enc.table.detach()), pts, enc,
                          True)
    assert launch_counts() == {"window_lists": 0, "encode_blocked": 0,
                               "grad_blocked": 0, "encode_small": 1,
                               "grad_small": 1}
    cot = 3.0 * torch.cos(3.0 * feats.detach())
    assert _grad_close(enc.table.grad, KS.grad_small_plain(cot, pts, enc),
                       KS.grad_small_plain(cot.abs(), pts, enc))


def test_small_wrappers_reject_what_the_kernels_do_not_take(cuda):
    # a bad input raises before any launch, and never runs the plain version
    enc = _small_encoder(cuda, "random", 10, 4)
    pts = _small_points(enc, cuda, 256)["uniform"]
    packed = K.pack_table_bf16(enc.table.detach())
    cot = torch.zeros(256, 8, device=cuda)
    reset_launch_counts()
    with pytest.raises(TypeError, match="dtype"):
        KS.encode_small(packed, pts.double(), enc)
    with pytest.raises(TypeError, match="dtype"):
        KS.encode_small(packed.float(), pts, enc)
    with pytest.raises(ValueError, match="shape"):
        KS.encode_small(packed[:-4], pts, enc)
    with pytest.raises(ValueError, match="packed table is on cpu"):
        KS.encode_small(packed.cpu(), pts, enc)
    with pytest.raises(ValueError, match="contiguous"):
        KS.encode_small(packed, pts.t().contiguous().t(), enc)
    shifted = torch.zeros(enc.table_rows * 2 + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        KS.encode_small(shifted.view(-1, 2), pts, enc, packed=False)
    with pytest.raises(TypeError, match="dtype"):
        KS.grad_small(cot.double(), pts, enc)
    with pytest.raises(ValueError, match="shape"):
        KS.grad_small(cot[:200].contiguous(), pts, enc)
    with pytest.raises(ValueError, match="cotangent is on cpu"):
        KS.grad_small(cot.cpu(), pts, enc)
    assert set(launch_counts().values()) == {0}
    # the f32-table gather has no kernel: the encoder raises on the card
    plain = HashGridEncoder(BBOX, 4, 2, 10, 16, 1024, scheme="fixed",
                            use_kernel=False, device=cuda)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        plain(pts)


# ------------------------------------------- launch plans at their edges

def _with_box_max(pts, enc):
    """Every 7th point moved onto box_max (the last cell of each level)."""
    pts = pts.clone()
    pts[::7] = enc.box_max
    return pts.contiguous()


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("levels,log2_t", [(1, 10), (3, 11), (16, 12),
                                           (17, 13), (64, 13), (16, 14),
                                           (16, 15), (8, 16), (1, 19)])
def test_small_encode_plans_cover_every_tile_and_level(cuda, scheme, levels,
                                                       log2_t):
    # persistent blocks over level groups: N of 1, one 1,024-point tile
    # less one, one more than a tile, and three times the persistent grid's
    # tiles; groups staged whole (2^10-2^13 packed), in part (2^13 f32,
    # 2^14-2^15 packed) and not at all (2^15 f32, 2^16, 2^19); odd L
    # (8-byte slices); points on box_max
    enc = _small_encoder(cuda, scheme, log2_t, levels)
    g = torch.Generator().manual_seed(levels * 100 + log2_t)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    packed = K.pack_table_bf16(table)
    full = KS.device_small_plan(1 << 30, enc, True, cuda)
    n_many = 3 * KS.TILE * full.grid // full.n_groups
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    for n in (1, KS.TILE - 1, KS.TILE + 1, n_many):
        pts = (torch.rand(n, 3, generator=g) * ext + lo).to(cuda)
        pts = _with_box_max(pts, enc)
        for pk, tab in ((True, packed), (False, table)):
            out = KS.encode_small(tab, pts, enc, pk)
            torch.cuda.synchronize()
            err = float((out - KS.encode_small_plain(tab, pts, enc, pk))
                        .abs().max())
            assert err <= 1e-6, (n, pk, err)
        assert torch.equal(KS.hash_encode_fused(table, pts, enc, "v1"),
                           KS.hash_encode_fused(table, pts, enc, "v2",
                                                packed=False)), n


def test_small_encode_refuses_a_plan_it_cannot_run(cuda):
    # a grid that is no multiple of the level groups, an empty group, a
    # stage larger than the plan's shared memory, or more staged levels
    # than a group holds, raises before anything runs
    enc = _small_encoder(cuda, "random", 13, 16)
    pts = _small_points(enc, cuda, 1000)["uniform"]
    packed = K.pack_table_bf16(enc.table.detach())
    plan = KS.device_small_plan(1000, enc, True, cuda)
    assert (plan.n_groups, plan.group_levels, plan.staged_levels) == (4, 4,
                                                                      4)
    for bad in (dict(grid=plan.grid + 1), dict(group_levels=0),
                dict(smem=plan.smem // 2), dict(staged_levels=5)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            KS.encode_small_planned(packed, pts, enc, True,
                                    KS.SmallPlan(**{**plan.__dict__, **bad}))


@pytest.mark.parametrize("levels", [1, 3, 16, 17, 64])
def test_blocked_encode_levels_and_group_counts(cuda, levels):
    # one group; one block of 4 teams less one team; many groups; points on
    # box_max; T = 2^19 at 16 levels, 2^12 otherwise
    enc = HashGridEncoder(BBOX, levels, 2, 19 if levels == 16 else 12, 16,
                          1024, use_kernel=True, device=cuda)
    g = torch.Generator().manual_seed(levels)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    packed = K.pack_table_bf16(table)
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    for n in (128, 3 * 128, 1 << 15):
        pts = _with_box_max((torch.rand(n, 3, generator=g) * ext
                             + lo).to(cuda), enc)
        wids, counts = K.window_lists(pts, enc)
        out = K.encode_blocked(packed, pts, wids, counts, enc)
        torch.cuda.synchronize()
        err = float((out - K.encode_blocked_plain(packed, pts, wids, counts,
                                                  enc)).abs().max())
        assert err <= 1e-6, (n, err)


def test_blocked_encode_one_and_128_windows_per_group(cuda):
    # each group's 128 points at one place (one window at every level), and
    # scattered points (128 windows per group at the finest levels, so most
    # used rows are read from L2 past the staged ones)
    enc = HashGridEncoder(BBOX, 16, 2, 19, 16, 1024, use_kernel=True,
                          device=cuda)
    g = torch.Generator().manual_seed(7)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    packed = K.pack_table_bf16(table)
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    same = (torch.rand(64, 1, 3, generator=g) * ext + lo).expand(64, 128, 3)
    scattered = torch.rand(64 * 128, 3, generator=g) * ext + lo
    for name, pts, want in (("one window", same.reshape(-1, 3), 1),
                            ("scattered", scattered, 128)):
        pts = torch.minimum(torch.maximum(pts.to(cuda), enc.box_min),
                            enc.box_max).contiguous()
        wids, counts = K.window_lists(pts, enc)
        assert int(counts.max()) == want, name
        ref = K.encode_blocked_plain(packed, pts, wids, counts, enc)
        out = K.encode_blocked(packed, pts, wids, counts, enc)
        torch.cuda.synchronize()
        assert float((out - ref).abs().max()) <= 1e-6, name


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_small_encode_points_outside_the_box(cuda, scheme):
    # points up to one extent outside the box (negative cell coordinates,
    # which the hash wraps in uint32): the kernel still equals its plain
    # version
    enc = _small_encoder(cuda, scheme, 13, 16)
    g = torch.Generator().manual_seed(11)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    packed = K.pack_table_bf16(table)
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    pts = ((torch.rand(50_000, 3, generator=g) * 3 - 1) * ext + lo).to(cuda)
    for pk, tab in ((True, packed), (False, table)):
        out = KS.encode_small(tab, pts, enc, pk)
        torch.cuda.synchronize()
        err = float((out - KS.encode_small_plain(tab, pts, enc, pk))
                    .abs().max())
        assert err <= 1e-6, (pk, err)
