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
levels, a partial block of teams, and 1 and 128 windows per group; K1
(window_lists) bit-exact with one window per group, 128 distinct windows in
ascending, descending and shuffled order, box faces, 1-64 levels and 1-257
groups; grad_small with every point in one cell (the worst collisions) at
T = 2^10-2^19, a ragged last block of a level's cluster, and no points; K3
(grad_blocked and its index) bitwise equal over two launches, its index
exactly its plain version's, exact zeros in untouched windows, groups whose
window codes alias, every group in one window (8,300 groups), 128 windows
per group, no cotangent rows and a partial last group; the large-table
kernels at the LeRF language table (2^16 entries, 10-15 levels), a LeRF
render and train step on the card against the CPU; utils/image.py's
undistortion and resizes on the card against the CPU, K1-K3 on the box
of a bbox refit, and the JPEG codec's device stages (utils/jpeg.py) on the
card against the CPU and the committed cv2 fixtures (tests/data/jpeg),
and every committed image fixture of tests/data/image (progressive JPEG
whole and cut, PNG kinds, TIFF variants) decoded on the card to cv2's
pixels, with the 16-bit resize and undistortion on the card against the
CPU.
"""
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.kernels import hash_encode as KS
from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
from nerfpp_tpu_torch.kernels import hash_encode_large as KL
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
    # the f32-table gather (use_kernel=False) no longer raises on the card:
    # it launches the large-table kernels (the gradient through its bin
    # pass), never the plain gather
    enc = HashGridEncoder(BBOX, 4, 2, 12, 16, 128, use_kernel=False,
                          device=cuda)
    pts = _point_sets(enc, cuda)["uniform"][:256]
    reset_launch_counts()
    feats, _ = enc(pts)
    feats.sum().backward()
    counts = launch_counts()
    assert counts.pop("encode_large") == 1 and counts.pop("grad_large") == 1
    assert counts.pop("grad_large_bins") == 1
    assert set(counts.values()) == {0}
    torch.cuda.synchronize()
    ref = KL.encode_large_plain(enc.table.detach(), pts, enc)
    assert float((feats.detach() - ref).abs().max()) <= 1e-6


def test_launch_counts_move_once_per_launch(cuda):
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["uniform"][:300]
    reset_launch_counts()
    K.hash_encode_blocked(enc.table.detach(), pts, enc)
    K.window_lists_plain(K.pad_points(pts, enc), enc)
    assert launch_counts() == {"window_lists": 1, "encode_blocked": 1,
                               "grad_blocked_index": 0, "grad_blocked": 0,
                               "encode_small": 0, "grad_small": 0,
                               "encode_large": 0, "grad_large_bins": 0,
                               "grad_large": 0}


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
    """The kernels and index_add_ sum each entry's terms in different
    orders (K3, grad_small and grad_large each in an order fixed by its
    inputs): each entry within 1e-5 of the sum of its terms' magnitudes."""
    return bool(((got - plain).abs() <= 1e-5 * mag + 1e-30).all())


def _k3(cot, pts, enc):
    """K3 over the points' own K1 lists."""
    wids, counts = K.window_lists(pts, enc)
    return K.grad_blocked(cot, pts, wids, counts, enc)


def _index_equal(a, b):
    """K3's index kernel against its plain version: mask, permutation and
    plan exactly, the run table where the mask is set (the kernel writes
    nothing elsewhere)."""
    lst = K.listed(b[0], b[2].shape[-1])
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][lst], b[2][lst]) and torch.equal(a[3], b[3]))


def _k3_checked(cot, pts, enc, name):
    """K3 against its plain version, bitwise equal over two launches, its
    index exactly its plain version's, exact zeros wherever no term falls
    (untouched windows and lanes 125-127 among them)."""
    wids, counts = K.window_lists(pts, enc)
    got = K.grad_blocked(cot, pts, wids, counts, enc)
    again = K.grad_blocked(cot, pts, wids, counts, enc)
    index = K.grad_blocked_index(pts, wids, counts, enc)
    torch.cuda.synchronize()
    assert torch.equal(got, again), name
    assert _index_equal(index, K.grad_blocked_index_plain(pts, wids, counts,
                                                          enc)), name
    plain = K.grad_blocked_plain(cot, pts, enc)
    mag = K.grad_blocked_plain(cot.abs(), pts, enc)
    assert _grad_close(got, plain, mag), name
    assert not bool(got[mag == 0].any()), name
    assert not bool(got.reshape(-1, 128, 2)[:, 125:].any()), name
    return got, counts


@pytest.mark.parametrize("log2_t", [12, 19])
def test_grad_kernel_matches_plain_version(cuda, log2_t):
    # uniform, coherent (the warp-aggregated same-cell case) and
    # cell-boundary points; two launches bitwise equal; lanes 125-127 of
    # every row and every untouched window exactly zero
    enc = _encoder(cuda, log2_t, levels=16 if log2_t == 19 else 4,
                   finest=1024 if log2_t == 19 else 128)
    g = torch.Generator().manual_seed(log2_t)
    for name, pts in _point_sets(enc, cuda).items():
        cot = torch.randn(pts.shape[0], 2 * enc.n_levels, generator=g).to(cuda)
        _k3_checked(cot, pts, enc, name)


def test_grad_kernel_padded_points_contribute_nothing(cuda):
    # 300 points padded to 384: the cotangent covers the first 300 only
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["uniform"][:300]
    cot = torch.randn(300, 8, generator=torch.Generator().manual_seed(5))
    cot = cot.to(cuda)
    padded = K.pad_points(pts, enc)
    assert padded.shape[0] == 384
    got = _k3(cot, padded, enc)
    torch.cuda.synchronize()
    plain = K.grad_blocked_plain(cot, pts, enc)
    assert _grad_close(got, plain, K.grad_blocked_plain(cot.abs(), pts, enc))
    # the padding sits at box_min: its corner entries get nothing from it
    lone = _k3(cot[:0], padded, enc)
    assert not bool(lone.any())


def test_grad_launch_count_moves_once_per_backward(cuda):
    enc = _encoder(cuda)
    pts = _point_sets(enc, cuda)["coherent"][:1000]
    reset_launch_counts()
    feats, _ = enc(pts)
    torch.sin(3.0 * feats).sum().backward()
    assert launch_counts() == {"window_lists": 1, "encode_blocked": 1,
                               "grad_blocked_index": 1, "grad_blocked": 1,
                               "encode_small": 0, "grad_small": 0,
                               "encode_large": 0, "grad_large_bins": 0,
                               "grad_large": 0}
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
    wids, counts = K.window_lists(pts, enc)
    lists = (wids, counts)
    with pytest.raises(TypeError, match="dtype"):
        K.grad_blocked(cot.double(), pts, *lists, enc)
    with pytest.raises(ValueError, match="shape"):
        K.grad_blocked(cot[:, :6].contiguous(), pts, *lists, enc)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.grad_blocked(cot[:200].contiguous(), pts[:200].contiguous(),
                       *lists, enc)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.grad_blocked(cot[:0], pts[:0], wids[:, :0].contiguous(),
                       counts[:, :0].contiguous(), enc)
    with pytest.raises(ValueError, match="rows for"):
        K.grad_blocked(torch.zeros(384, 8, device=cuda), pts, *lists, enc)
    with pytest.raises(ValueError, match="contiguous"):
        K.grad_blocked(torch.zeros(8, 256, device=cuda).t(), pts, *lists,
                       enc)
    with pytest.raises(ValueError, match="cotangent is on cpu"):
        K.grad_blocked(cot.cpu(), pts, *lists, enc)
    with pytest.raises(ValueError, match="window ids is on cpu"):
        K.grad_blocked(cot, pts, wids.cpu(), counts, enc)
    with pytest.raises(ValueError, match="window counts has shape"):
        K.grad_blocked(cot, pts, wids, counts[:, :1].contiguous(), enc)
    with pytest.raises(ValueError, match="window ids has shape"):
        K.grad_blocked_index(pts, wids[:1].contiguous(), counts, enc)


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
    # the kernels sum in another order than index_add_: each entry within
    # 1e-5 of the sum of its terms' magnitudes; coherent points exercise the
    # warp's same-entry sums, 4,001 points a partial tile
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
    # the encoder's forward launches encode_small, its backward grad_small
    # (through the bin pass, grad_large_bins); the plain versions count
    # nothing; the table gradient is the kernel's
    enc = _small_encoder(cuda, "random", 13, 16)
    pts = _small_points(enc, cuda, 3000)["coherent"]
    reset_launch_counts()
    feats, _ = enc(pts)
    torch.sin(3.0 * feats).sum().backward()
    KS.encode_small_plain(K.pack_table_bf16(enc.table.detach()), pts, enc,
                          True)
    assert launch_counts() == {"window_lists": 0, "encode_blocked": 0,
                               "grad_blocked_index": 0, "grad_blocked": 0,
                               "encode_small": 1, "grad_small": 1,
                               "encode_large": 0, "grad_large_bins": 1,
                               "grad_large": 0}
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
    # the f32-table gather goes to the large-table kernel on the card
    plain = HashGridEncoder(BBOX, 4, 2, 10, 16, 1024, scheme="fixed",
                            use_kernel=False, device=cuda)
    plain(pts)
    assert launch_counts()["encode_large"] == 1


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


# ------------------------------------ K1 and grad_small at their worst cases

def _window_points(enc, order, g):
    """128 points a group whose windows at the finest level are 128 distinct
    x-windows (cells 8i + 4 along x, i = 0..127), in ascending, descending
    or shuffled order of their codes, three groups."""
    scale = float(enc.level_scales[-1])
    lo, ext = enc.box_min.cpu().double(), (enc.box_max - enc.box_min).cpu()
    i = torch.arange(128, dtype=torch.float64)
    if order == "descending":
        i = i.flip(0)
    elif order == "shuffled":
        i = i[torch.randperm(128, generator=g)]
    pts = lo.expand(128, 3).clone()
    pts[:, 0] += (8 * i + 4.5) / scale * float(ext[0])
    pts[:, 1:] += 0.5 * ext[1:].double()
    return pts.float().repeat(3, 1)


@pytest.mark.parametrize("levels", [1, 16, 64])
def test_window_lists_exact_at_its_edges(cuda, levels):
    # bit-exact against the plain version: every point of a group in one
    # window (the no-sort exit at every level), 128 distinct windows in
    # ascending, descending and shuffled order, points on the box faces,
    # uniform points; 1, 3 and 257 groups
    # one level: at the finest resolution, so that 128 windows fit an axis
    enc = HashGridEncoder(BBOX, levels, 2, 19 if levels == 16 else 12,
                          1024 if levels == 1 else 16, 1024, use_kernel=True,
                          device=cuda)
    g = torch.Generator().manual_seed(100 + levels)
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    one = (torch.rand(257, 1, 3, generator=g) * ext + lo).expand(257, 128, 3)
    faces = torch.rand(3 * 128, 3, generator=g) * ext + lo
    k = torch.arange(3 * 128)
    faces[k, k % 3] = torch.where((k // 3) % 2 == 0, enc.box_min.cpu()[k % 3],
                                  enc.box_max.cpu()[k % 3])
    sets = {"one window": one.reshape(-1, 3),
            "faces": faces,
            "uniform": torch.rand(128, 3, generator=g) * ext + lo}
    for order in ("ascending", "descending", "shuffled"):
        sets[order] = _window_points(enc, order, g)
    for name, pts in sets.items():
        pts = torch.minimum(torch.maximum(pts.to(cuda), enc.box_min),
                            enc.box_max).contiguous()
        wids, counts = K.window_lists(pts, enc)
        torch.cuda.synchronize()
        wids_p, counts_p = K.window_lists_plain(pts, enc)
        assert torch.equal(wids, wids_p), name
        assert torch.equal(counts, counts_p), name
        if name == "one window":
            assert bool((counts == 1).all())
        if name in ("ascending", "descending", "shuffled"):
            assert bool((counts[-1] == 128).all()), name


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("log2_t,levels", [(10, 4), (13, 16), (15, 16),
                                           (19, 1)])
def test_small_grad_all_points_in_one_cell(cuda, scheme, log2_t, levels):
    # the worst collisions: every point in one cell of the finest level (so
    # in one or two cells at every level), each entry within 1e-5 of the sum
    # of its terms' magnitudes; 4,001 points leave a ragged last block of
    # each (level, range); 0 points give zeros
    enc = _small_encoder(cuda, scheme, log2_t, levels)
    g = torch.Generator().manual_seed(log2_t * 10 + levels)
    res = float(enc.resolutions[-1] if scheme == "fixed"
                else enc.level_scales[-1])
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    cell = torch.floor(torch.rand(1, 3, generator=g) * (res - 1))
    frac = 0.1 + 0.8 * torch.rand(4001, 3, generator=g)
    pts = ((cell + frac) / res * ext + lo).to(cuda).contiguous()
    cot = torch.randn(4001, 2 * levels, generator=g).to(cuda)
    got = KS.grad_small(cot, pts, enc)
    torch.cuda.synchronize()
    plain = KS.grad_small_plain(cot, pts, enc)
    assert _grad_close(got, plain, KS.grad_small_plain(cot.abs(), pts, enc))
    # the kernel writes every entry: what no corner touches is zero
    assert torch.equal(got != 0, plain != 0)
    assert int((plain != 0).any(-1).sum()) <= 16 * levels
    empty = KS.grad_small(cot[:0], pts[:0], enc)
    assert empty.shape == (enc.table_rows, 2) and not bool(empty.any())


# ------------------------------------------------------ K3 at its worst cases

def _flagship(dev):
    return HashGridEncoder(BBOX, 16, 2, 19, 16, 1024, use_kernel=True,
                           device=dev)


def _clamped(pts, enc):
    return torch.minimum(torch.maximum(pts, enc.box_min),
                         enc.box_max).contiguous()


def test_grad_kernel_groups_whose_codes_alias(cuda):
    # T = 2^12: 4 windows a level, so a group's distinct window codes alias
    # to one window (the index lists the group once, each point counts once)
    enc = _encoder(cuda, 12)
    pts = _point_sets(enc, cuda)["uniform"]
    wids, counts = K.window_lists(pts, enc)
    nw = enc.block_slots // 8
    aliased = [len(set((row[:c] & (nw - 1)).tolist())) < int(c)
               for row, c in zip(wids.reshape(-1, 128).cpu(),
                                 counts.reshape(-1).cpu())]
    assert any(aliased)
    cot = torch.randn(pts.shape[0], 8,
                      generator=torch.Generator().manual_seed(31)).to(cuda)
    _k3_checked(cot, pts, enc, "aliasing")


def test_grad_kernel_every_group_in_one_window(cuda):
    # 8,300 groups at one point: one window's segment lists every group
    # (two chunks of 256 mask words), all lanes of a warp in one cell
    enc = _flagship(cuda)
    g = torch.Generator().manual_seed(32)
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    one = torch.rand(1, 3, generator=g) * ext + lo
    pts = _clamped(one.expand(8300 * 128, 3).to(cuda), enc)
    cot = torch.randn(pts.shape[0], 32, generator=g).to(cuda)
    _, counts = _k3_checked(cot, pts, enc, "one window")
    assert bool((counts == 1).all())


def test_grad_kernel_128_windows_per_group(cuda):
    # at the finest level each group's 128 points in 128 distinct windows
    # (octants k + c per axis, k over 8 x 8 x 2), and the orders of the
    # K1 edge test (128 codes that alias to 8 windows)
    enc = _flagship(cuda)
    scale = float(enc.level_scales[-1])
    lo, ext = enc.box_min.cpu().double(), (enc.box_max - enc.box_min).cpu()
    i = torch.arange(128)
    k = torch.stack([i & 7, (i >> 3) & 7, i >> 6], dim=-1).double()
    spread = (lo + (8 * k + 4.5) / scale * ext.double()).float().repeat(3, 1)
    g = torch.Generator().manual_seed(33)
    sets = {"128 windows": spread}
    for order in ("ascending", "descending", "shuffled"):
        sets[order] = _window_points(enc, order, g)
    for name, pts in sets.items():
        pts = _clamped(pts.to(cuda), enc)
        cot = torch.randn(pts.shape[0], 32, generator=g).to(cuda)
        _, counts = _k3_checked(cot, pts, enc, name)
        assert bool((counts[-1] == 128).all()), name
        if name == "128 windows":
            wids, _ = K.window_lists(pts, enc)
            for row in wids[-1] & (enc.block_slots // 8 - 1):
                assert torch.unique(row).numel() == 128


@pytest.mark.parametrize("n_valid", [0, 4001])
def test_grad_kernel_no_cotangent_and_a_partial_group(cuda, n_valid):
    # n = 0: every entry zero; 4,001 of 4,096 points: a partial last group
    enc = _flagship(cuda)
    g = torch.Generator().manual_seed(34 + n_valid)
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    pts = (torch.rand(4096, 3, generator=g) * ext + lo).to(cuda)
    cot = torch.randn(n_valid, 32, generator=g).to(cuda)
    got = _k3(cot, pts, enc)
    torch.cuda.synchronize()
    plain = K.grad_blocked_plain(cot, pts, enc)
    mag = K.grad_blocked_plain(cot.abs(), pts, enc)
    assert _grad_close(got, plain, mag)
    assert not bool(got[mag == 0].any())
    assert bool(got.any()) == (n_valid > 0)


# ------------------------------------------------------ large-table kernels

def _large_encoder(dev, scheme, log2_t, levels):
    return HashGridEncoder(BBOX, levels, 2, log2_t, 16, 1024, scheme=scheme,
                           use_kernel=False, device=dev)


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
@pytest.mark.parametrize("log2_t,levels", [(10, 1), (10, 4), (12, 16),
                                           (19, 16), (20, 16), (19, 5),
                                           (7, 3), (23, 2), (24, 2)])
def test_large_kernels_match_plain_versions(cuda, scheme, log2_t, levels):
    # encode within 1e-6 at |table| <= 1 (f32 weights and products on both
    # sides; the order of the 8 corner sums differs); the gradient, summed
    # in another order than index_add_, each entry within 1e-5 of the sum
    # of its terms' magnitudes; uniform, coherent, cell-boundary and
    # box-face points, 4,001 of them, and a single point; T = 2^7 is one
    # bin a level, T = 2^23 and 2^24 count their bins in 2 and 4 chunks
    enc = _large_encoder(cuda, scheme, log2_t, levels)
    g = torch.Generator().manual_seed(log2_t * 100 + levels)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    sets = _small_points(enc, cuda)
    sets["single"] = sets["uniform"][:1].contiguous()
    for name, pts in sets.items():
        out = KL.encode_large(table, pts, enc)
        cot = torch.randn(pts.shape[0], 2 * levels, generator=g).to(cuda)
        got = KL.grad_large(cot, pts, enc)
        torch.cuda.synchronize()
        ref = KL.encode_large_plain(table, pts, enc)
        assert float((out - ref).abs().max()) <= 1e-6, name
        plain = KL.grad_large_plain(cot, pts, enc)
        mag = KL.grad_large_plain(cot.abs(), pts, enc)
        assert _grad_close(got, plain, mag), name
        assert torch.equal(got != 0, plain != 0), name
    empty = KL.grad_large(cot[:0], pts[:0], enc)
    assert empty.shape == (enc.table_rows, 2) and not bool(empty.any())
    assert KL.encode_large(table, pts[:0], enc).shape == (0, 2 * levels)


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
def test_large_grad_all_points_in_one_cell(cuda, scheme):
    # every point in one cell of the finest level: the terms of 4,001
    # points meet on the same 8 entries of every level
    enc = _large_encoder(cuda, scheme, 19, 16)
    g = torch.Generator().manual_seed(7)
    res = float(enc.resolutions[-1] if scheme == "fixed"
                else enc.level_scales[-1])
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    cell = torch.floor(torch.rand(1, 3, generator=g) * (res - 1))
    frac = 0.1 + 0.8 * torch.rand(4001, 3, generator=g)
    pts = ((cell + frac) / res * ext + lo).to(cuda).contiguous()
    cot = torch.randn(4001, 32, generator=g).to(cuda)
    got = KL.grad_large(cot, pts, enc)
    torch.cuda.synchronize()
    plain = KL.grad_large_plain(cot, pts, enc)
    assert _grad_close(got, plain, KL.grad_large_plain(cot.abs(), pts, enc))
    assert torch.equal(got != 0, plain != 0)
    assert int((plain != 0).any(-1).sum()) <= 16 * 16


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
def test_large_launch_counts_move_once_per_launch(cuda, scheme):
    # the encoder's forward launches encode_large, its backward grad_large
    # (and its bin pass, grad_large_bins); the plain versions count nothing;
    # the table gradient is the kernel's
    enc = _large_encoder(cuda, scheme, 14, 8)
    with torch.no_grad():
        enc.table.uniform_(-1, 1)
    pts = _small_points(enc, cuda, 3000)["coherent"]
    reset_launch_counts()
    feats, _ = enc(pts)
    torch.sin(3.0 * feats).sum().backward()
    KL.encode_large_plain(enc.table.detach(), pts, enc)
    assert launch_counts() == {"window_lists": 0, "encode_blocked": 0,
                               "grad_blocked_index": 0, "grad_blocked": 0,
                               "encode_small": 0, "grad_small": 0,
                               "encode_large": 1, "grad_large_bins": 1,
                               "grad_large": 1}
    cot = 3.0 * torch.cos(3.0 * feats.detach())
    assert _grad_close(enc.table.grad, KL.grad_large_plain(cot, pts, enc),
                       KL.grad_large_plain(cot.abs(), pts, enc))
    assert enc.table.grad.dtype == torch.float32


def test_large_wrappers_reject_what_the_kernels_do_not_take(cuda):
    # a bad input raises before any launch, and never runs the plain version
    enc = _large_encoder(cuda, "random", 10, 4)
    pts = _small_points(enc, cuda, 256)["uniform"]
    table = enc.table.detach()
    cot = torch.zeros(256, 8, device=cuda)
    reset_launch_counts()
    with pytest.raises(TypeError, match="dtype"):
        KL.encode_large(table, pts.double(), enc)
    with pytest.raises(TypeError, match="dtype"):
        KL.encode_large(table.double(), pts, enc)
    with pytest.raises(ValueError, match="shape"):
        KL.encode_large(table[:-1], pts, enc)
    with pytest.raises(ValueError, match="table is on cpu"):
        KL.encode_large(table.cpu(), pts, enc)
    with pytest.raises(ValueError, match="contiguous"):
        KL.encode_large(table, pts.t().contiguous().t(), enc)
    shifted = torch.zeros(enc.table_rows * 2 + 2, device=cuda)[2:]
    with pytest.raises(ValueError, match="aligned"):
        KL.encode_large(shifted.view(-1, 2), pts, enc)
    with pytest.raises(TypeError, match="dtype"):
        KL.grad_large(cot.double(), pts, enc)
    with pytest.raises(ValueError, match="shape"):
        KL.grad_large(cot[:200].contiguous(), pts, enc)
    with pytest.raises(ValueError, match="cotangent is on cpu"):
        KL.grad_large(cot.cpu(), pts, enc)
    many = HashGridEncoder(BBOX, 65, 2, 10, 16, 1024, scheme="random",
                           use_kernel=False, device=cuda)
    with pytest.raises(ValueError, match="levels"):
        KL.encode_large(many.table.detach(), pts, many)
    assert set(launch_counts().values()) == {0}
    # a cotangent at any 4-byte offset is taken: the owner pass reads a
    # level-major copy of it
    shifted = torch.zeros(256 * 8 + 2, device=cuda)[2:].view(256, 8)
    shifted.copy_(torch.randn(256, 8, generator=torch.Generator()
                              .manual_seed(3)).to(cuda))
    got = KL.grad_large(shifted, pts, enc)
    torch.cuda.synchronize()
    assert _grad_close(got, KL.grad_large_plain(shifted, pts, enc),
                       KL.grad_large_plain(shifted.abs(), pts, enc))


# ------------------------------- the order-fixed gradient and its bin pass

def _bins_equal(got, plain, n, enc):
    """The bin pass against its plain version: the records, the run
    offsets, and the plan up to its last item (the kernels write nothing
    past it)."""
    recs, offs, plan = got
    recs_p, offs_p, plan_p = plain
    nb = KL.bins_shape(n, enc)[1]
    head = 4 + 4 * enc.n_levels * nb + 2 * int(plan_p[0])
    return (torch.equal(recs, recs_p) and torch.equal(offs, offs_p)
            and torch.equal(plan[:head], plan_p[:head]))


def _one_cell(enc, n, seed):
    """n points in one cell of the finest level."""
    g = torch.Generator().manual_seed(seed)
    res = float(enc.resolutions[-1] if enc.scheme == "fixed"
                else enc.level_scales[-1])
    lo, ext = enc.box_min.cpu(), (enc.box_max - enc.box_min).cpu()
    cell = torch.floor(torch.rand(1, 3, generator=g) * (res - 1))
    frac = 0.1 + 0.8 * torch.rand(n, 3, generator=g)
    return ((cell + frac) / res * ext + lo).contiguous()


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
@pytest.mark.parametrize("log2_t,levels", [(10, 4), (13, 16), (19, 16),
                                           (20, 3), (7, 2), (23, 2)])
def test_grad_large_bins_match_plain_version(cuda, scheme, log2_t, levels):
    # the records, run offsets and plan exactly: uniform points (empty bins
    # at T = 2^19 and more), coherent, cell-boundary and box-face points
    # (4,001: a partial last tile), a single point, and 20,000 points in one
    # cell (its corners' bins hold more records than a part: split bins);
    # T = 2^7 is one bin a level, T = 2^23 two chunks of bins
    enc = _large_encoder(cuda, scheme, log2_t, levels)
    sets = _small_points(enc, cuda)
    sets["single"] = sets["uniform"][:1].contiguous()
    sets["one cell"] = _one_cell(enc, 20000, log2_t).to(cuda)
    reset_launch_counts()
    for name, pts in sets.items():
        got = KL.grad_large_bins(pts, enc)
        torch.cuda.synchronize()
        plain = KL.grad_large_bins_plain(pts, enc)
        assert _bins_equal(got, plain, pts.shape[0], enc), name
        if name == "one cell":
            assert int(plain[2][1]) > 0, "no bin was split"
    assert launch_counts()["grad_large_bins"] == len(sets)


def _repeat_checked(fn, plain_fn, cot, pts, enc):
    """Two launches bitwise equal, each entry within 1e-5 of the sum of its
    terms' magnitudes, zero exactly where no term falls."""
    got = fn(cot, pts, enc)
    again = fn(cot, pts, enc)
    torch.cuda.synchronize()
    plain = plain_fn(cot, pts, enc)
    mag = plain_fn(cot.abs(), pts, enc)
    return (torch.equal(got, again) and _grad_close(got, plain, mag)
            and torch.equal(got != 0, plain != 0))


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
def test_large_grad_two_launches_bitwise_equal(cuda, scheme):
    # 16 x 2^19 (hashnerf_preset()'s table) and 3 x 2^10: uniform,
    # coherent, cell-boundary and box-face points, and 20,000 in one cell
    # (split bins, their partial tiles added in part order)
    for log2_t, levels in ((19, 16), (10, 3)):
        enc = _large_encoder(cuda, scheme, log2_t, levels)
        g = torch.Generator().manual_seed(levels)
        sets = _small_points(enc, cuda)
        sets["one cell"] = _one_cell(enc, 20000, levels).to(cuda)
        for name, pts in sets.items():
            cot = torch.randn(pts.shape[0], 2 * levels, generator=g).to(cuda)
            assert _repeat_checked(KL.grad_large, KL.grad_large_plain, cot,
                                   pts, enc), (log2_t, name)


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("log2_t,levels", [(10, 4), (13, 16), (15, 16)])
def test_small_grad_two_launches_bitwise_equal(cuda, scheme, log2_t, levels):
    # the small table's bins (512 entries) are crowded: a part of 4,096
    # records at most, so most bins are split; 20,000 points in one cell
    enc = _small_encoder(cuda, scheme, log2_t, levels)
    g = torch.Generator().manual_seed(log2_t + levels)
    sets = _small_points(enc, cuda)
    sets["one cell"] = _one_cell(enc, 20000, log2_t).to(cuda)
    for name, pts in sets.items():
        cot = torch.randn(pts.shape[0], 2 * levels, generator=g).to(cuda)
        assert _repeat_checked(KS.grad_small, KS.grad_small_plain, cot, pts,
                               enc), name


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
@pytest.mark.parametrize("levels", [1, 2, 3, 5, 6, 7, 9, 13, 17])
def test_large_encode_level_groups(cuda, scheme, levels):
    # a block serves 4 levels: levels not a multiple of 4 leave a short last
    # group, and odd levels rows that are not 16-byte aligned; 4,001 and 255
    # points leave a partial last tile; T = 2^10 and 2^19
    for log2_t in (10, 19):
        enc = _large_encoder(cuda, scheme, log2_t, levels)
        g = torch.Generator().manual_seed(levels)
        table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
        for name, pts in _small_points(enc, cuda).items():
            for m in (pts.shape[0], 255):
                out = KL.encode_large(table, pts[:m], enc)
                torch.cuda.synchronize()
                ref = KL.encode_large_plain(table, pts[:m], enc)
                assert float((out - ref).abs().max()) <= 1e-6, (name, m)


def test_grad_large_bins_rejects_what_it_does_not_take(cuda):
    enc = _large_encoder(cuda, "random", 10, 4)
    pts = _small_points(enc, cuda, 256)["uniform"]
    reset_launch_counts()
    with pytest.raises(ValueError, match="at least one point"):
        KL.grad_large_bins(pts[:0], enc)
    with pytest.raises(TypeError, match="dtype"):
        KL.grad_large_bins(pts.double(), enc)
    # 8 x 2^28 records do not fit the 32-bit records
    huge = torch.zeros(1, 3, device=cuda).expand(1 << 28, 3)
    with pytest.raises(ValueError, match="records"):
        KL.grad_large_bins(huge, enc)
    with pytest.raises(ValueError, match="records"):
        KL.grad_large(torch.zeros(1, 8, device=cuda).expand(1 << 28, 8),
                      huge, enc)
    assert set(launch_counts().values()) == {0}


def _le_encoder(dev, levels):
    """The LeRF language table: 2^16 entries a level, base 16 -> finest
    128, random primes from seed 1 (hashnerf_preset(use_lerf=True) has 14
    levels)."""
    return HashGridEncoder(BBOX, levels, 2, 16, 16, 128, scheme="random",
                           primes_seed=1, use_kernel=False, device=dev)


@pytest.mark.parametrize("levels", [14, 10, 11, 13, 15])
def test_large_kernels_at_the_language_table(cuda, levels):
    # level counts that are not a multiple of 4: a short last level group;
    # encode within 1e-6, the gradient's entries within 1e-5 of sum |w * g|
    # and zero where no term falls, two gradient launches bitwise equal, the
    # bin pass exactly its plain version; 20,000 points in one cell too
    enc = _le_encoder(cuda, levels)
    g = torch.Generator().manual_seed(levels)
    table = (torch.rand(enc.table_rows, 2, generator=g) * 2 - 1).to(cuda)
    sets = _small_points(enc, cuda)
    sets["one cell"] = _one_cell(enc, 20000, levels).to(cuda)
    for name, pts in sets.items():
        out = KL.encode_large(table, pts, enc)
        torch.cuda.synchronize()
        ref = KL.encode_large_plain(table, pts, enc)
        assert float((out - ref).abs().max()) <= 1e-6, name
        cot = torch.randn(pts.shape[0], 2 * levels, generator=g).to(cuda)
        assert _repeat_checked(KL.grad_large, KL.grad_large_plain, cot, pts,
                               enc), name
        got = KL.grad_large_bins(pts, enc)
        torch.cuda.synchronize()
        assert _bins_equal(got, KL.grad_large_bins_plain(pts, enc),
                           pts.shape[0], enc), name


def _lerf_preset():
    from nerfpp_tpu_torch.config import hashnerf_preset
    return hashnerf_preset(n_levels=4, log2_hashmap_size=12,
                           n_importance=16, hier_sparse_importance=4,
                           compute_dtype="float32", use_lerf=True,
                           lang_embed_dim=32, n_levels_le=6,
                           log2_hashmap_size_le=12, finest_resolution_le=64)


def test_lerf_render_gpu_against_cpu(cuda):
    # a 32x32 LeRF render with relevancy from the same seeded state: the
    # large-table kernels on the card, their plain versions on the CPU
    from nerfpp_tpu_torch.config import TrainParams
    from nerfpp_tpu_torch.core.rays import calibration_matrix, pose_spherical
    from nerfpp_tpu_torch.executor import NeRFExecutor
    p = _lerf_preset()
    p.thin_ray = True
    g = torch.Generator().manual_seed(0)
    tables = [torch.rand(4 * 4096, 2, generator=g) - 0.5,
              torch.rand(6 * 4096, 2, generator=g) - 0.5]
    prompts = torch.randn(3, 32, generator=g)
    pose = pose_spherical(30.0, -30.0, 3.0)
    k = calibration_matrix(35.0, 32, 32)
    outs = {}
    for name in ("cuda", "cpu"):
        ex = NeRFExecutor(p, device=name).initialize(BBOX, seed=0)
        with torch.no_grad():
            ex.embedder.table.copy_(tables[0])
            ex.lang_embedder.table.copy_(tables[1])
        ex.set_lerf_prompts(prompts[:1], prompts[1:])
        reset_launch_counts()
        outs[name] = ex.render_view(pose, 32, 32, k,
                                    TrainParams(n_samples=16))["lerf"]
        if name == "cuda":
            assert launch_counts()["encode_large"] > 0
    for f in ("rendered_lang_embedding", "acc", "depth", "relevancy"):
        a, b = getattr(outs["cuda"], f).cpu(), getattr(outs["cpu"], f)
        assert a.shape == b.shape, f
        assert float((a - b).abs().max()) <= 2e-3 * max(
            float(b.abs().max()), 1.0), f
    assert float(outs["cpu"].acc.max()) > 0.05


def test_lerf_train_step_gpu_against_cpu(cuda):
    # one tiny dual-loss step from the same seeded state with the same
    # draws: loss and lang_loss to 1e-4; 99 % of each gradient's entries
    # within 1e-3 of its tensor's largest and every entry within 1e-2 (the
    # importance passes move depths in near-empty bins with the rounding of
    # the weights: 2 ulps of them move the table gradients by up to 4.7e-3
    # of their largest on the CPU alone); both tables' kernels launch
    from nerfpp_tpu_torch.config import TrainParams
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.data.pyramid_clip import (
        PyramidEmbedder, PyramidEmbedderProperties,
        RandomProjectionPatchEncoder, make_device_pyramid)
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfpp_tpu_torch.executor import NeRFExecutor
    scene = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=32,
                                 n_samples=32, white_bkgr=False, device="cpu")
    emb = PyramidEmbedder(RandomProjectionPatchEncoder(32, 8),
                          PyramidEmbedderProperties(img_size=8, overlap=0.5),
                          device="cpu")(scene.images[:2])
    tp = TrainParams(n_samples=8, n_rand=512, chunk=256, n_iters=100)
    runs = {}
    for name in ("cuda", "cpu"):
        ex = NeRFExecutor(_lerf_preset(), device=name)
        ex.initialize(scene.bounding_box, tp.lrate_decay, seed=0)
        sampler = RayBatchSampler.from_scene(
            scene, tp.n_rand, device=name,
            pyramid=make_device_pyramid(emb, 0.5, device=name))
        reset_launch_counts()
        m = ex._build_train_step(tp)(0, sampler,
                                     torch.Generator().manual_seed(7))
        if name == "cuda":
            c = launch_counts()
            assert c["encode_large"] >= 4 and c["grad_large"] >= 4, c
        runs[name] = (m, {k: v.grad.cpu()
                          for k, v in ex.named_parameters().items()})
    (mg, gg), (mc, gc) = runs["cuda"], runs["cpu"]
    for k in ("loss", "lang_loss"):
        assert float(mg[k]) == pytest.approx(float(mc[k]), rel=1e-4), k
    for k, v in gc.items():
        diff, top = (gg[k] - v).abs(), float(v.abs().max())
        assert float(diff.max()) <= 1e-2 * top, k
        assert float((diff <= 1e-3 * top).float().mean()) >= 0.99, k


def test_image_ops_on_the_card_equal_the_cpu(cuda):
    # utils/image.py on the card: the new camera matrix, the undistortion
    # and the 8-bit resize equal the CPU's bit for bit (the CPU's equal
    # OpenCV's, tests/test_torch_colmap.py); the float resize within 1e-6
    from nerfpp_tpu_torch.utils import image as I
    rng = np.random.RandomState(0)
    for (w, h), c, d in (((64, 48), 3, (0.01, -0.002, 0.001, -0.001)),
                         ((37, 29), 0, (-0.05, 0.02, 0.002, 0.001, 0.01)),
                         ((50, 40), 4, (0.1, 0.05, 0.01, -0.02, 0.01, 0.02,
                                        0.01, 0.003))):
        k = np.array([[1.1 * w, 0, w / 2 + 0.3], [0, 1.11 * w, h / 2 - 0.7],
                      [0, 0, 1]])
        nk = I.optimal_new_camera_matrix(k, d, (w, h), 0.0, "cpu")
        assert np.array_equal(
            I.optimal_new_camera_matrix(k, d, (w, h), 0.0, cuda), nk)
        img = torch.from_numpy(rng.randint(
            0, 256, (h, w) if c == 0 else (h, w, c)).astype(np.uint8))
        assert torch.equal(I.undistort(img.to(cuda), k, d, nk).cpu(),
                           I.undistort(img, k, d, nk))
        fimg = (img if c else img[..., None]).float() / 255.0
        for oh, ow in ((h // 2, w // 2), (h + 7, w - 5), (2 * h + 1, 3 * w)):
            assert torch.equal(
                I.resize_linear_u8(img.to(cuda), (oh, ow)).cpu(),
                I.resize_linear_u8(img, (oh, ow))), (oh, ow)
            diff = (I.resize_linear(fimg.to(cuda), (oh, ow)).cpu()
                    - I.resize_linear(fimg, (oh, ow))).abs().max()
            assert float(diff) <= 1e-6, (oh, ow)


def test_blocked_kernels_after_a_refit_use_the_new_box(cuda):
    # the bbox refit rebuilds the encoder: K1, K2 and K3 launch once each
    # on the new box and equal their plain versions on an encoder built on
    # that box, which encodes other features than the old box would
    from nerfpp_tpu_torch.config import hashnerf_blocked_preset
    from nerfpp_tpu_torch.executor import NeRFExecutor
    loose = [-4.8, -4.8, -4.8, 4.8, 4.8, 4.8]
    p = hashnerf_blocked_preset(n_importance=0, use_occupancy_grid=True,
                                n_levels=4, log2_hashmap_size=12,
                                finest_resolution=128, occ_grid_resolution=16)
    ex = NeRFExecutor(p, device=cuda).initialize(loose, seed=0)
    d = torch.zeros(16, 16, 16)
    d[6:10, 6:10, 6:10] = 1000.0
    ex.load_state({"occupancy": d})
    assert ex.refit_bbox_from_grid()
    enc, box = ex.embedder, ex.bounding_box
    assert np.array_equal(enc.bounding_box, box)
    g = torch.Generator().manual_seed(0)
    lo, hi = torch.tensor(box[:3]), torch.tensor(box[3:])
    pts = (torch.rand(4096, 3, generator=g) * (hi - lo) + lo).to(cuda)
    with torch.no_grad():
        enc.table.copy_(torch.rand(enc.table_rows, 2, generator=g) * 2 - 1)
    reset_launch_counts()
    feats, _ = enc(pts)
    torch.sin(3.0 * feats).sum().backward()
    c = launch_counts()
    assert [c[k] for k in ("window_lists", "encode_blocked",
                           "grad_blocked_index", "grad_blocked")] == [1] * 4
    fresh = HashGridEncoder(box, 4, 2, 12, 16, 128, use_kernel=True,
                            device=cuda)
    padded = K.pad_points(pts, fresh)
    wids, counts = K.window_lists_plain(padded, fresh)
    packed = K.pack_table_bf16(enc.table.detach())
    want = K.encode_blocked_plain(packed, padded, wids, counts, fresh)[:4096]
    assert float((feats.detach() - want).abs().max()) <= 1e-6
    cot = 3.0 * torch.cos(3.0 * feats.detach())
    plain = K.grad_blocked_plain(cot, padded, fresh)
    assert _grad_close(enc.table.grad, plain,
                       K.grad_blocked_plain(cot.abs(), padded, fresh))
    old = HashGridEncoder(loose, 4, 2, 12, 16, 128, use_kernel=True,
                          device=cuda)
    owids, ocounts = K.window_lists_plain(K.pad_points(pts, old), old)
    other = K.encode_blocked_plain(packed, K.pad_points(pts, old), owids,
                                   ocounts, old)[:4096]
    assert float((other - want).abs().max()) > 1e-3


def test_jpeg_codec_on_the_card_is_the_cpus_and_opencvs(cuda):
    # integer stages: the card's pixels and bytes are the CPU's, and the
    # fixtures' (written by OpenCV 5.0.0's libjpeg-turbo 3.1.2) exactly
    from pathlib import Path

    from nerfpp_tpu_torch.utils import jpeg as J
    fixtures = Path(__file__).resolve().parent / "data" / "jpeg"
    for f in sorted(fixtures.glob("*.jpg")):
        if f.stem != "source":
            np.testing.assert_array_equal(J.read_jpeg(f, cuda).cpu().numpy(),
                                          np.load(f.with_suffix(".npy")))
    src = np.load(fixtures / "source.npy")
    assert J.encode_jpeg(src, device=cuda) == (fixtures / "source.jpg"
                                               ).read_bytes()
    rng = np.random.RandomState(0)
    for h, w in [(1, 1), (17, 33), (64, 48), (129, 255)]:
        for c in (3, 1):
            img = rng.randint(0, 256, (h, w, c), np.uint8)
            data = J.encode_jpeg(img, 90, device="cpu")
            assert J.encode_jpeg(img, 90, device=cuda) == data, (h, w, c)
            frame = J.decode_coefficients(data)
            assert torch.equal(J.frame_pixels(frame, cuda).cpu(),
                               J.frame_pixels(frame, "cpu")), (h, w, c)


def test_image_files_on_the_card_are_the_cpus_and_opencvs(cuda):
    # the committed cv2 fixtures of tests/data/image (progressive JPEG whole
    # and cut, PNG kinds, TIFF variants) decode on the card to cv2's pixels,
    # prog_source.npy encodes progressive to cv2's bytes, and the 16-bit
    # resize and undistortion on the card equal the CPU's bit for bit
    from pathlib import Path

    from nerfpp_tpu_torch.utils import image as I
    from nerfpp_tpu_torch.utils import jpeg as J
    fixtures = Path(__file__).resolve().parent / "data" / "image"
    files = sorted(f for f in fixtures.iterdir()
                   if f.suffix != ".npy" and f.stem != "prog_source")
    assert len(files) >= 15
    for f in files:
        got = I.read_image(f, cuda)
        assert got.device.type == cuda.type
        want = np.load(f.with_suffix(".npy"))
        got = got.cpu().numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    src = np.load(fixtures / "prog_source.npy")
    assert J.encode_jpeg(src, device=cuda, progressive=True) == (
        fixtures / "prog_source.jpg").read_bytes()
    for k in (5, 7, 9):                  # block smoothing, card against CPU
        frame = J.decode_coefficients(
            (fixtures / f"prog_420_21x27_cut{k}.jpg").read_bytes())
        assert frame.smooth
        assert torch.equal(J.frame_pixels(frame, cuda).cpu(),
                           J.frame_pixels(frame, "cpu"))
    rng = np.random.RandomState(1)
    for (w, h), c in (((64, 48), 3), ((37, 29), 0), ((50, 40), 4)):
        img = torch.from_numpy(rng.randint(0, 65536, (h, w) if c == 0 else
                                           (h, w, c)).astype(np.uint16))
        k = np.array([[1.1 * w, 0, w / 2 + 0.3], [0, 1.11 * w, h / 2 - 0.7],
                      [0, 0, 1]])
        d = (0.01, -0.002, 0.001, -0.001)
        nk = I.optimal_new_camera_matrix(k, d, (w, h), 0.0, "cpu")
        card = I.undistort(img.to(cuda), k, d, nk).cpu()
        assert card.dtype == torch.uint16
        assert torch.equal(card.to(torch.int32),
                           I.undistort(img, k, d, nk).to(torch.int32))
        for oh, ow in ((h // 2, w // 2), (h + 7, w - 5), (2 * h + 1, 3 * w)):
            assert torch.equal(
                I.resize_linear_u16(img.to(cuda), (oh, ow)).cpu().to(
                    torch.int32),
                I.resize_linear_u16(img, (oh, ow)).to(torch.int32))
