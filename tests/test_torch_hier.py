"""Port parity: the hierarchical importance pass, against the JAX package.

merge_sorted and reflect_boundary; render_rays with the importance pass
(tile-shared and per-ray CDF, the stochastic-preconditioning noise on and
off) and render_ray_batch_hier_budgeted, with JAX's random draws handed to
the port; and the executor's render_view of the small-table hashnerf_tpu
preset, JAX running its Pallas kernel in interpret mode, from a JAX state
carried across with state_from_jax.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_tpu_preset as jax_tpu_preset
from nerfpp_tpu.core import sampling as JS
from nerfpp_tpu.core.rays import calibration_matrix, get_ray_batch
from nerfpp_tpu.core.rays import pose_spherical
from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.sh import SHEncoder as JaxSH
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu.models.nerf_small import NeRFSmall as JaxNeRFSmall
from nerfpp_tpu.render import renderer as JR
from nerfpp_tpu_torch.config import TrainParams, hashnerf_tpu_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.core import sampling as TS
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.encoders.sh import SHEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.render import renderer as TR

torch.set_num_threads(1)

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
ENC = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
           base_resolution=16, finest_resolution=64, scheme="random")


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# ------------------------------------------------------------- sampling

def test_merge_sorted_matches_jax():
    # row-sorted inputs with ties inside and across them; JAX places values
    # by a bf16 3-way-split one-hot matmul (~1e-7 relative noise), the port
    # exactly, so rtol 1e-6; both end with a cummax
    rng = np.random.RandomState(0)
    a = np.sort(rng.uniform(0.5, 4.0, (64, 24)), axis=-1).astype(np.float32)
    b = np.sort(rng.uniform(0.5, 4.0, (64, 40)), axis=-1).astype(np.float32)
    a[:, 5] = a[:, 4]
    b[:, 7:9] = a[:, 10:11]
    b = np.sort(b, axis=-1)
    want = np.asarray(jax.jit(JS.merge_sorted)(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = TS.merge_sorted(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], -1),
                                               axis=-1))


def test_reflect_boundary_matches_jax():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-4.0, 4.0, (500, 7, 3)).astype(np.float32)
    pts[0, 0] = BBOX[:3]
    pts[0, 1] = BBOX[3:]
    want = np.asarray(JS.reflect_boundary(jnp.asarray(pts),
                                          jnp.asarray(BBOX[:3]),
                                          jnp.asarray(BBOX[3:])))
    got = TS.reflect_boundary(t(pts), t(BBOX[:3]), t(BBOX[3:])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got >= BBOX[:3] - 1e-6).all() and (got <= BBOX[3:] + 1e-6).all()


# ------------------------------------------------------------- renderer

def _stacks():
    """JAX and port network closures over the same weights: a random-scheme
    table with |values| <= 1 through the f32 gather, a gain-1 f32
    NeRFSmall, SH degree 4."""
    je = JaxEncoder(BBOX, **ENC)
    te = HashGridEncoder(BBOX, use_kernel=False, device="cpu", **ENC)
    tab = np.random.RandomState(0).uniform(
        -1, 1, (je.table_rows, 2)).astype(np.float32)
    jm = JaxNeRFSmall(3, 64, 15, 4, 64, False, 3, 64, 8, 16, init_gain=1.0)
    params = {"embed": {"table": tab},
              "model": jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))}
    tm = NeRFSmall(3, 64, 15, 4, 64, False, 8, 16, init_gain=1.0,
                   device="cpu")
    st = state_from_jax(params, device="cpu")
    te.load_state_dict({"table": st["embed.table"]})
    tm.load_state_dict({k[6:]: v for k, v in st.items()
                        if k.startswith("model.")})
    jsh, tsh = JaxSH(4), SHEncoder(4)
    jnet = JR.make_nerf_network_fn(
        lambda p, x: je(p["embed"], x), lambda p, x: jsh(x),
        lambda p, x: jm(p["model"], x))
    return params, jnet, TR.make_nerf_network_fn(te, tsh, tm)


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    pose = pose_spherical(rng.uniform(0, 360), -30.0, 3.0)
    k = calibration_matrix(30.0, 32, 32)
    xs = rng.uniform(0, 32, n).astype(np.float32)
    ys = rng.uniform(0, 32, n).astype(np.float32)
    o, d, cone = get_ray_batch(jnp.asarray(xs), jnp.asarray(ys),
                               jnp.asarray(k), jnp.asarray(pose))
    return np.asarray(o), np.asarray(d), float(cone)


def _scatter(key, shape):
    kr, kt = jax.random.split(key)
    return (t(jax.random.uniform(kr, shape)), t(jax.random.uniform(kt, shape)))


def _cfg(**kw):
    cfg = dict(n_samples=8, n_importance=16, use_viewdirs=True,
               thin_ray=False, density_activation="trunc_exp",
               use_raw_noise=True, use_sp_noise=True)
    cfg.update(kw)
    return JR.RenderConfig(**cfg), TR.RenderConfig(**cfg)


def _close(got, want, f):
    # f32 on both sides; the fine depths follow the coarse weights through
    # JAX's one-hot bf16-split picks (~1e-7 relative), and XLA:CPU fuses
    # some lerps into FMAs: the bulk holds to 1e-5, and a rare sample that
    # crosses a hash cell moves a pixel by up to 2e-3
    a, b = np.asarray(want), got.detach().numpy()
    assert (np.abs(b - a) <= 1e-5 + 1e-5 * np.abs(a)).mean() >= 0.99, f
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=1e-5, err_msg=f)


def _close_z(got, want):
    # Depths: the coarse ones to 1e-6. The importance depths invert a CDF
    # whose near-empty bins (weights at the 1e-8 floor, span just above the
    # 1e-5 clamp) have slopes up to a bin width / 1e-5, so where XLA:CPU
    # fuses the lerp into an FMA (and JAX's picks add ~1e-7) a depth there
    # moves by up to ~1e-3; 99% hold to 1e-6
    a, b = np.asarray(want), got.numpy()
    assert (np.abs(b - a) <= 1e-6 + 1e-6 * np.abs(a)).mean() >= 0.99
    np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-6)


@pytest.mark.parametrize("tiled,sp", [(True, True), (False, False)])
def test_render_rays_importance_matches_jax(tiled, sp):
    # 256 rays: hier_ray_tile 128 shares the coarse depths and the
    # importance CDF per tile; 0 places them per ray. Cone scatter, density
    # noise and the preconditioning noise with JAX's draws
    params, jnet, tnet = _stacks()
    jcfg, tcfg = _cfg(hier_ray_tile=128 if tiled else 0, use_sp_noise=sp)
    o, d, cone = _rays(256, 3)
    key = jax.random.PRNGKey(5)
    near, far = 1.2, 4.6
    jn = jnp.full((256, 1), near)
    jf = jnp.full((256, 1), far)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    bbox = jnp.asarray(BBOX)
    jres = jax.jit(lambda p: JR.render_rays(
        p, jnet, JR.make_nerf_integrate_fn(jcfg), jnp.asarray(o),
        jnp.asarray(d), jn, jf, jnp.asarray(vd), cone, key, jcfg, 0.7, 0.05,
        bbox))(params)
    keys = jax.random.split(key, 7)
    k_all = 8 + 16
    draws = {"scatter_u": _scatter(keys[1], (256, 8, 1)),
             "scatter_u_fine": _scatter(keys[4], (256, k_all, 1)),
             "noise": t(jax.random.normal(keys[5], (256, 8))),
             "noise_fine": t(jax.random.normal(keys[6], (256, k_all))),
             "sp_noise": t(jax.random.normal(keys[3], (256, k_all, 3)))}
    tres = TR.render_rays(
        tnet, TR.make_nerf_integrate_fn(tcfg), t(o), t(d),
        torch.full((256, 1), near), torch.full((256, 1), far), t(vd),
        torch.tensor(cone), tcfg, None, t(BBOX), raw_noise_std=0.7,
        sp_alpha=0.05, draws=draws)
    assert tres.z_vals.shape == (256, k_all)
    _close_z(tres.z_vals, jres.z_vals)
    assert (np.diff(tres.z_vals.numpy(), axis=-1) >= 0).all()
    if tiled:
        # the fine depths are shared by each tile's 128 rays
        z = tres.z_vals.numpy().reshape(2, 128, -1)
        assert (z == z[:, :1]).all()
    for f in ("rgb", "depth", "acc"):
        _close(getattr(tres.outputs, f), getattr(jres.outputs, f), f)
        _close(getattr(tres.coarse, f), getattr(jres.coarse, f), f)


def test_hier_budgeted_matches_jax():
    # 512 rays in 4 tiles: the top quarter by coarse weight mass gets 16
    # importance samples, the rest 4; JAX's draws handed to the port
    params, jnet, tnet = _stacks()
    jcfg, tcfg = _cfg(hier_ray_tile=128)
    o, d, cone = _rays(512, 4)
    key = jax.random.PRNGKey(6)
    jres = jax.jit(lambda p: JR.render_ray_batch_hier_budgeted(
        p, jnet, JR.make_nerf_integrate_fn(jcfg), jnp.asarray(o),
        jnp.asarray(d), cone, key, jcfg, jnp.asarray(BBOX), 0.7, 0.05,
        dense_frac=0.25, sparse_importance=4))(params)
    k_strat, k_cone1, k_noise1, kd, ks = jax.random.split(key, 5)
    draws = {"scatter_u": _scatter(k_cone1, (512, 8, 1)),
             "noise": t(jax.random.normal(k_noise1, (512, 8)))}
    for name, kk, n_rays, n_imp in (("dense", kd, 128, 16),
                                    ("sparse", ks, 384, 4)):
        _, k_sp, k_cone, k_noise = jax.random.split(kk, 4)
        k_all = 8 + n_imp
        draws[name] = {
            "sp_noise": t(jax.random.normal(k_sp, (n_rays, k_all, 3))),
            "scatter_u_fine": _scatter(k_cone, (n_rays, k_all, 1)),
            "noise_fine": t(jax.random.normal(k_noise, (n_rays, k_all)))}
    tres = TR.render_ray_batch_hier_budgeted(
        tnet, TR.make_nerf_integrate_fn(tcfg), t(o), t(d),
        torch.tensor(cone), tcfg, t(BBOX), 0.7, 0.05, 0.25, 4, draws=draws)
    np.testing.assert_array_equal(tres[2].numpy(), np.asarray(jres[2]))
    np.testing.assert_array_equal(tres[3].numpy(), np.asarray(jres[3]))
    for tr, jr in ((tres[0], jres[0]), (tres[1], jres[1])):
        _close_z(tr.z_vals, jr.z_vals)
        for f in ("rgb", "depth", "acc"):
            _close(getattr(tr.outputs, f), getattr(jr.outputs, f), f)
            _close(getattr(tr.coarse, f), getattr(jr.coarse, f), f)
    with pytest.raises(ValueError, match="hier_ray_tile"):
        TR.render_ray_batch_hier_budgeted(
            tnet, None, t(o), t(d), None, _cfg()[1], t(BBOX))


# ------------------------------------------------------------- executor

def test_executor_render_view_matches_jax():
    """hashnerf_tpu_preset at small size (random scheme, T = 2^10, 2
    levels, SH degree 4, 8 + 16 samples): JAX's render_view with its Pallas kernel in
    interpret mode, the port's with encode_small's plain version, after
    carrying the JAX state across with state_from_jax (the same table under
    the same name; the primes are drawn from the seed on both sides).

    Tolerance: the Pallas kernel's cell coordinate rounds differently from
    the jitted form the port follows (an ulp of a coordinate up to 64,
    4e-6, times a feature slope of 2 x 0.05), and the fine depths follow
    the coarse weights; rgb and acc hold to 1e-4, depth to 1e-3."""
    kw = dict(n_levels=2, log2_hashmap_size=10, finest_resolution=64,
              n_importance=16, multires_views=4, thin_ray=True)
    jx = JaxExecutor(jax_tpu_preset(**kw))
    jx.initialize(BBOX, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
    params["embed"]["table"] = np.random.RandomState(0).uniform(
        -0.05, 0.05, params["embed"]["table"].shape).astype(np.float32)
    jx.state["params"] = jax.tree.map(jnp.asarray, params)
    h = w = 24
    k = calibration_matrix(1.1 * 24, 24, 24)
    pose = pose_spherical(30.0, -30.0, 3.0)
    jout = jx.render_view(pose, h, w, k, JaxTrainParams(n_samples=8,
                                                        chunk=256))
    tx = NeRFExecutor(hashnerf_tpu_preset(**kw), device="cpu")
    tx.initialize(BBOX, seed=0)
    assert tx.embedder.use_kernel and not tx._sample_major()
    np.testing.assert_array_equal(tx.embedder.primes, jx.embedder.primes)
    st = state_from_jax(params, device="cpu")
    assert st["embed.table"].shape == (2 * 1024, 2)
    tx.load_state(st)
    assert torch.equal(tx.embedder.table.detach(), t(params["embed"]["table"]))
    tout = tx.render_view(pose, h, w, k, TrainParams(n_samples=8, chunk=256))
    for f, tol in (("rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3),
                   ("disp", 1e-3)):
        got = getattr(tout["nerf"], f).numpy()
        assert got.shape == ((h, w, 3) if f == "rgb" else (h, w))
        np.testing.assert_allclose(got, np.asarray(getattr(jout["nerf"], f)),
                                   atol=tol)
    d8 = (tout["rgb8"].numpy().astype(int)
          - np.asarray(jout["rgb8"]).astype(int))
    assert np.abs(d8).max() <= 1
