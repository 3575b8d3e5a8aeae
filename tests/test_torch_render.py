"""Port parity: whole renders against the JAX package.

render_image on the budget path and on the unbudgeted paths, in float32 and
at the preset's bf16, with both sides built from the plain (XLA) encoder on a
bf16-rounded table; then the executor's render_view of the miniature
flagship, JAX running its Pallas kernels in interpret mode, after carrying
the JAX state across with state_from_jax.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_blocked_preset as jax_preset
from nerfpp_tpu.core.occupancy import OccupancyGrid as JaxGrid
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.sh import SHEncoder as JaxSH
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu.models.nerf_small import NeRFSmall as JaxNeRFSmall
from nerfpp_tpu.render import renderer as JR
from nerfpp_tpu_torch.config import TrainParams, hashnerf_blocked_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.core.occupancy import OccupancyGrid
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.encoders.sh import SHEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.render import renderer as TR

torch.set_num_threads(1)

BBOX = np.array([-1.2] * 3 + [1.2] * 3, np.float32)
ENC = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
           base_resolution=16, finest_resolution=64, scheme="blocked")
H = W = 24
K = calibration_matrix(1.1 * 24, 24, 24)
POSE = pose_spherical(30.0, -30.0, 3.0)
FIELDS = ("rgb", "depth", "acc", "disp")


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _sphere_grid(g=16, r=4.0, density=10.0):
    ii = np.indices((g, g, g)).transpose(1, 2, 3, 0)
    d = np.zeros((g, g, g), np.float32)
    d[((ii - (g - 1) / 2) ** 2).sum(-1) < r * r] = density
    return d


def _stacks(dtype):
    """JAX and port renderer closures over the same weights: a bf16-rounded
    table with |values| <= 1 and a gain-1 NeRFSmall."""
    je = JaxEncoder(BBOX, **ENC)
    te = HashGridEncoder(BBOX, use_kernel=False, device="cpu", **ENC)
    tab = _bf16(np.random.RandomState(0).uniform(
        -1, 1, (je.table_rows, 2)).astype(np.float32))
    jm = JaxNeRFSmall(3, 64, 15, 4, 64, False, 3, 64, 8, 16,
                      compute_dtype=(jnp.bfloat16 if dtype == "bfloat16"
                                     else None), init_gain=1.0)
    mparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    params = {"embed": {"table": tab}, "model": mparams}
    tm = NeRFSmall(3, 64, 15, 4, 64, False, 8, 16, compute_dtype=dtype,
                   init_gain=1.0, device="cpu")
    st = state_from_jax(params, device="cpu")
    te.load_state_dict({"table": st["embed.table"]})
    tm.load_state_dict({k[6:]: v for k, v in st.items()
                        if k.startswith("model.")})
    jsh, tsh = JaxSH(4), SHEncoder(4)

    def jnet(sample_major):
        return JR.make_nerf_network_fn(
            lambda p, x: je(p["embed"], x), lambda p, x: jsh(x),
            lambda p, x: jm(p["model"], x), sample_major=sample_major)

    def tnet(sample_major):
        return TR.make_nerf_network_fn(te, tsh, tm, sample_major=sample_major)

    return params, jnet, tnet


def _render_both(dtype, dense_frac, tile_order, occ_ray_tile, chunk=256,
                 hier_ray_tile=0):
    """occ_ray_tile < 0 renders without the occupancy grid."""
    params, jnet, tnet = _stacks(dtype)
    use_occ = occ_ray_tile >= 0
    cfg = dict(n_samples=16, n_importance=0, chunk=chunk, use_viewdirs=True,
               thin_ray=True, density_activation="trunc_exp",
               tile_order=tile_order, n_occ_bins=8 if use_occ else 0,
               occ_ray_tile=max(occ_ray_tile, 0),
               hier_ray_tile=hier_ray_tile)
    jcfg, tcfg = JR.RenderConfig(**cfg), TR.RenderConfig(**cfg)
    grid = _sphere_grid()
    jnetf = jnet(tile_order)
    budget = dict(dense_frac=dense_frac, sparse_samples=4, prior_bins=8)

    @jax.jit
    def jax_render(p, k, pose, occ):
        return JR.render_image(
            p, jnetf, JR.make_nerf_integrate_fn(jcfg), H, W, k, pose,
            jax.random.PRNGKey(0), jcfg, jnp.asarray(BBOX),
            occupancy=JaxGrid(density=occ) if use_occ else None, **budget)

    jo, jnf = jax_render(params, jnp.asarray(K), jnp.asarray(POSE),
                         jnp.asarray(grid))
    with torch.no_grad():
        to, tnf = TR.render_image(
            tnet(tile_order), TR.make_nerf_integrate_fn(tcfg), H, W,
            torch.tensor(K), torch.tensor(POSE), tcfg, torch.tensor(BBOX),
            occupancy=(OccupancyGrid(density=torch.tensor(grid)) if use_occ
                       else None), **budget)
    assert float(tnf[0]) == pytest.approx(float(jnf[0]), rel=1e-6)
    assert float(tnf[1]) == pytest.approx(float(jnf[1]), rel=1e-6)
    return jo, to


@pytest.mark.parametrize("dense_frac,tile_order,occ_ray_tile,chunk,hier", [
    (0.3, True, 128, 256, 0),   # two-class budget, probe-narrowed prior
    (0.0, True, 128, 256, 0),   # unbudgeted, tile-shared occupancy depths
    (0.0, False, 0, 256, 0),    # unbudgeted, per-ray occupancy prior
    # chunks of 320 rays do not divide into 128-ray tiles, so JAX samples
    # per ray in every chunk, the last (128 rays, padded to 320) included
    (0.0, True, 128, 320, 0),   # occupancy prior
    (0.0, True, -1, 320, 128),  # no grid: per-ray uniform depths
    (0.0, True, -1, 256, 128),  # no grid: tile-shared uniform depths
])
def test_render_image_float32(dense_frac, tile_order, occ_ray_tile, chunk,
                              hier):
    # float32 everywhere: this checks the algorithm (tile order, chunking,
    # probe ranking, narrowing, scatter back) to f32 rounding, ~1e-6
    jo, to = _render_both("float32", dense_frac, tile_order, occ_ray_tile,
                          chunk, hier)
    # Per-ray uniform depths: XLA:CPU fuses near + (far - near) * t into one
    # FMA where PyTorch rounds twice, so a depth can differ by an ulp and a
    # rare sample cross a hash-cell boundary (|table| <= 1 here). There the
    # bulk holds at 1e-5 and the few crossings at 2e-3.
    per_ray_uniform = occ_ray_tile < 0 and chunk % hier != 0
    for f in FIELDS:
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
        assert a.shape == b.shape == ((H, W, 3) if f == "rgb" else (H, W))
        if per_ray_uniform:
            close = np.abs(b - a) <= 1e-5 + 1e-5 * np.abs(a)
            assert close.mean() >= 0.99, f
            np.testing.assert_allclose(b, a, atol=2e-3, rtol=1e-5)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


def test_render_image_bf16_budget():
    # the preset's bf16 MLP: rare hidden values round to the neighbouring
    # bf16 value on one side only, so rgb and depth move by up to ~1e-4
    jo, to = _render_both("bfloat16", 0.3, True, 128)
    for f, tol in (("rgb", 1e-3), ("depth", 1e-3), ("acc", 1e-5),
                   ("disp", 1e-3)):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   np.asarray(getattr(jo, f)), atol=tol)


def test_executor_render_view_matches_jax():
    """The miniature flagship (blocked scheme, kernels, occupancy grid, auto
    budget): JAX's render_view with its Pallas kernels in interpret mode,
    the port's with its kernels' plain versions, after state_from_jax.

    Tolerance: the Pallas kernel rounds each trilinear weight to bf16 (2^-9
    relative), so at table scale s = 0.05 a feature differs by up to
    8 x 2^-9 x s = 7.8e-4; rgb (a sigmoid, slope <= 1/4, of gain-1 nets of
    those features) is held to that bound, depth to 2e-3 of its ~2 range."""
    kw = dict(n_importance=0, log2_hashmap_size=12, n_levels=4,
              finest_resolution=64, use_occupancy_grid=True,
              occ_grid_resolution=16, occ_n_bins=8, thin_ray=True)
    jx = JaxExecutor(jax_preset(**kw))
    jx.initialize(BBOX, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
    params["embed"]["table"] = _bf16(np.random.RandomState(0).uniform(
        -0.05, 0.05, params["embed"]["table"].shape).astype(np.float32))
    jx.state["params"] = jax.tree.map(jnp.asarray, params)
    grid = _sphere_grid()
    jx.state["occupancy"] = JaxGrid(density=jnp.asarray(grid))
    jout = jx.render_view(POSE, H, W, K, JaxTrainParams(n_samples=16,
                                                        chunk=256))
    tx = NeRFExecutor(hashnerf_blocked_preset(**kw), device="cpu")
    tx.initialize(BBOX, seed=0)
    tx.load_state(state_from_jax(params, grid, device="cpu"))
    assert tx._sample_major() and tx.embedder.use_kernel
    tout = tx.render_view(POSE, H, W, K, TrainParams(n_samples=16, chunk=256))
    frac = tx._auto_dense_frac(H, W, K, POSE)
    assert frac == jx._auto_dense_frac(H, W, K, POSE)
    assert 0.0 < frac < 1.0
    for f, tol in (("rgb", 7.8e-4), ("depth", 2e-3), ("acc", 1e-5),
                   ("disp", 2e-3)):
        np.testing.assert_allclose(getattr(tout["nerf"], f).numpy(),
                                   np.asarray(getattr(jout["nerf"], f)),
                                   atol=tol)
    d8 = (tout["rgb8"].numpy().astype(int)
          - np.asarray(jout["rgb8"]).astype(int))
    assert np.abs(d8).max() <= 1
    assert [float(v) for v in tout["near_far"]] == pytest.approx(
        [float(v) for v in jout["near_far"]], rel=1e-6)
