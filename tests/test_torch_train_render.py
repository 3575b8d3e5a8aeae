"""Port parity for the training slice's rendering side, against the JAX
package on the CPU: the occupancy refresh (full and phased), the training
renderer (plain and budgeted) with the same random draws, the ray sampler
and the synthetic scene. Shared helpers: torch_train_common.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfpp_tpu.core import occupancy as JO
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.sh import SHEncoder as JaxSH
from nerfpp_tpu.models.nerf_small import NeRFSmall as JaxNeRFSmall
from nerfpp_tpu.render import renderer as JR
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.core import occupancy as TO
from nerfpp_tpu_torch.data import dataset as TD
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.encoders.sh import SHEncoder
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.render import renderer as TR
from nerfpp_tpu_torch.utils.png import write_png
from torch_train_common import (BBOX, ENC, _batch_rays, _images,
                                _sphere_grid, t)

torch.set_num_threads(1)


# ------------------------------------------------------------ occupancy

def _sigma_fns():
    """One analytic density field in both frameworks."""
    def jf(params, p):
        return jax.nn.relu(jnp.sin(3.0 * p[:, 0]) + jnp.cos(2.0 * p[:, 1])
                           + p[:, 2])

    def tf(p):
        return torch.relu(torch.sin(3.0 * p[:, 0]) + torch.cos(2.0 * p[:, 1])
                          + p[:, 2])
    return jf, tf


@pytest.mark.parametrize("phase", [None, 0, 5])
def test_update_grid_matches_jax(phase):
    # the brick order, the octant select and the whole-grid decay, with the
    # JAX key's jitter handed to the port; f32 rounding only
    g = 16
    jf, tf = _sigma_fns()
    d0 = np.random.RandomState(4).uniform(0, 2, (g, g, g)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    n = g if phase is None else g // 2
    jitter = np.asarray(jax.random.uniform(key, (n, n, n, 3)))
    grid = JO.OccupancyGrid(density=jnp.asarray(d0))
    if phase is None:
        want = JO.update_grid(grid, jf, None, jnp.asarray(BBOX), key, 0.9)
        got = TO.update_grid(TO.OccupancyGrid(density=t(d0)), tf, t(BBOX),
                             0.9, jitter=t(jitter))
    else:
        want = JO.update_grid_phased(grid, jf, None, jnp.asarray(BBOX), key,
                                     phase, 0.9)
        got = TO.update_grid_phased(TO.OccupancyGrid(density=t(d0)), tf,
                                    t(BBOX), phase, 0.9, jitter=t(jitter))
        # cells off the phase's sub-lattice only decay
        pi, pj, pk = phase & 1, (phase >> 1) & 1, (phase >> 2) & 1
        off = np.ones((g, g, g), bool)
        off[pi::2, pj::2, pk::2] = False
        np.testing.assert_array_equal(got.density.numpy()[off],
                                      (t(d0) * 0.9).numpy()[off])
    np.testing.assert_allclose(got.density.numpy(),
                               np.asarray(want.density), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- renderer

def _render_stacks():
    """JAX and port network closures over the same weights: a bf16-rounded
    table with |values| <= 1, gain-1 f32 NeRFSmall, SH degree 4."""
    enc = dict(ENC, finest_resolution=64)
    je = JaxEncoder(BBOX, **enc)
    te = HashGridEncoder(BBOX, use_kernel=False, device="cpu", **enc)
    tab = np.random.RandomState(0).uniform(
        -1, 1, (je.table_rows, 2)).astype(np.float32)
    jm = JaxNeRFSmall(3, 64, 15, 4, 64, False, 3, 64, 8, 16, init_gain=1.0)
    mparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    params = {"embed": {"table": tab}, "model": mparams}
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
    tnet = TR.make_nerf_network_fn(te, tsh, tm)
    return params, jnet, tnet


def _jax_draws(key, n_rays, n_samples):
    """The draws JAX's render_rays makes from ``key``: the cone scatter's
    two uniforms (keys[1]) and the density noise (keys[5])."""
    keys = jax.random.split(key, 7)
    kr, kt = jax.random.split(keys[1])
    shape = (n_rays, n_samples, 1)
    return {"scatter_u": (t(jax.random.uniform(kr, shape)),
                          t(jax.random.uniform(kt, shape))),
            "noise": t(jax.random.normal(keys[5], (n_rays, n_samples)))}


@pytest.mark.parametrize("budget", [False, True])
def test_training_render_matches_jax(budget):
    # cone scatter and density noise on, with JAX's draws handed to the port;
    # the sphere grid makes the budget split the tiles. f32 everywhere:
    # the bulk holds to 1e-5; XLA:CPU fuses the inverse-CDF lerp into one
    # FMA, so a rare sample lands an ulp away and may cross a cell (2e-3)
    params, jnet, tnet = _render_stacks()
    cfg = dict(n_samples=16, n_importance=0, use_viewdirs=True,
               thin_ray=False, density_activation="trunc_exp",
               use_raw_noise=True, n_occ_bins=8, occ_ray_tile=128)
    jcfg, tcfg = JR.RenderConfig(**cfg), TR.RenderConfig(**cfg)
    o, d, cone = _batch_rays(512, 3)
    grid = _sphere_grid()
    key = jax.random.PRNGKey(5)
    tgrid = TO.OccupancyGrid(density=t(grid))
    jint = JR.make_nerf_integrate_fn(jcfg)
    if budget:
        jres = jax.jit(lambda p, o_, d_, g_: JR.render_ray_batch_budgeted(
            p, jnet, jint, o_, d_, cone, key, jcfg, jnp.asarray(BBOX), 0.7,
            0.0, occupancy=JO.OccupancyGrid(density=g_), dense_frac=0.5,
            sparse_samples=4))(params, o, d, grid)
        kd, ks = jax.random.split(key)
        nd = int(jres[2].shape[0])
        draws = {"dense": _jax_draws(kd, nd, 16),
                 "sparse": _jax_draws(ks, 512 - nd, 4)}
        tres = TR.render_ray_batch_budgeted(
            tnet, TR.make_nerf_integrate_fn(tcfg), t(o), t(d),
            torch.tensor(cone), tcfg, t(BBOX), 0.7, tgrid, 0.5, 4,
            draws=draws)
        np.testing.assert_array_equal(tres[2].numpy(), np.asarray(jres[2]))
        np.testing.assert_array_equal(tres[3].numpy(), np.asarray(jres[3]))
        pairs = [(tres[0], jres[0]), (tres[1], jres[1])]
    else:
        jres = jax.jit(lambda p, o_, d_, g_: JR.render_ray_batch(
            p, jnet, jint, o_, d_, cone, key, jcfg, jnp.asarray(BBOX), 0.7,
            0.0, occupancy=JO.OccupancyGrid(density=g_)))(params, o, d, grid)
        tres = TR.render_ray_batch(
            tnet, TR.make_nerf_integrate_fn(tcfg), t(o), t(d),
            torch.tensor(cone), tcfg, t(BBOX), 0.7, tgrid,
            draws=_jax_draws(key, 512, 16))
        pairs = [(tres, jres)]
    for tr, jr in pairs:
        np.testing.assert_allclose(tr.z_vals.numpy(), np.asarray(jr.z_vals),
                                   rtol=1e-6, atol=1e-6)
        for f in ("rgb", "depth", "acc"):
            a = np.asarray(getattr(jr.outputs, f))
            b = getattr(tr.outputs, f).detach().numpy()
            assert (np.abs(b - a) <= 1e-5 + 1e-5 * np.abs(a)).mean() >= 0.99
            np.testing.assert_allclose(b, a, atol=2e-3, rtol=1e-5)


# --------------------------------------------------------------- sampler

@pytest.mark.parametrize("tiles,step", [((8, 16), 3), ((8, 16), 12),
                                        ((0, 0), 3)])
def test_ray_sampler_matches_jax(tiles, step):
    # precrop for steps < 10: tile origins stay inside the centre crop; the
    # JAX sampler's uniforms (split(key) -> kh, kw) are handed to the port
    h, w, b = 24, 40, 256
    imgs = _images(3, h, w)
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 90, 180)])
    ks = np.stack([calibration_matrix(30.0, w, h)] * 3)
    th, tw = tiles
    js = JD.RayBatchSampler(images=jnp.asarray(imgs), poses=jnp.asarray(poses),
                            intrinsics=jnp.asarray(ks), h=h, w=w,
                            batch_size=b, precrop_iters=10, precrop_frac=0.5,
                            tile_h=th, tile_w=tw)
    key = jax.random.PRNGKey(step)
    jb = js.sample(key, jnp.int32(step))
    ts = TD.RayBatchSampler(t(imgs), t(poses), t(ks), b, 10, 0.5, th, tw)
    kh, kw = jax.random.split(key)
    nd = ts.n_draws()
    tb = ts.sample(step, u_h=t(jax.random.uniform(kh, (nd,))),
                   u_w=t(jax.random.uniform(kw, (nd,))))
    np.testing.assert_array_equal(tb["target_rgb"].numpy(),
                                  np.asarray(jb["target_rgb"]))
    np.testing.assert_allclose(tb["rays_d"].numpy(), np.asarray(jb["rays_d"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tb["rays_o"].numpy(),
                                  np.asarray(jb["rays_o"]))
    assert float(tb["cone_angle"]) == pytest.approx(float(jb["cone_angle"]),
                                                    rel=1e-6)
    # which pixels: recover them from the targets' image
    img = imgs[step % 3]
    flat = img.reshape(-1, 3)
    pix = [int(np.flatnonzero((flat == v).all(-1))[0])
           for v in tb["target_rgb"].numpy()[:128]]
    ys, xs = np.divmod(np.asarray(pix), w)
    h0, h1, w0, w1 = ts.bounds(step)
    assert (h0, h1, w0, w1) == ((6, 18, 10, 30) if step < 10
                                else (0, h, 0, w))
    assert ys.min() >= h0 and ys.max() < max(h1, h0 + max(th, 1))
    assert xs.min() >= w0 and xs.max() < max(w1, w0 + max(tw, 1))
    if th:
        # one 8x16 tile, row-major: contiguous rows of 16 pixels
        assert ys.max() - ys.min() == th - 1 and xs.max() - xs.min() == tw - 1


def test_sampler_refuses_what_needs_the_loaders(tmp_path):
    # an image file that is not there raises; a file of another size than
    # its view (COLMAP's multi-size views) is resized as the JAX sampler
    # resizes it with cv2 (tests/test_torch_colmap.py holds the resize)
    sc = TD.SceneData(views=[TD.View(0, 8, 8, 8.0, 1, 2, np.eye(3),
                                     np.eye(4),
                                     image_path=str(tmp_path / "a.png"))],
                      splits_idx=[1, 0, 0])
    with pytest.raises(FileNotFoundError):
        TD.RayBatchSampler.from_scene(sc, 128, device="cpu")
    write_png(tmp_path / "a.png", np.random.RandomState(0).randint(
        0, 256, (12, 12, 3)).astype(np.uint8))
    got = TD.RayBatchSampler.from_scene(sc, 128, device="cpu").images
    want = JD.RayBatchSampler.from_scene(
        JD.SceneData.from_json(sc.to_json()), 128).images
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- synthetic

def test_synthetic_scene_matches_jax(tmp_path):
    kw = dict(n_train=2, n_val=1, n_test=1, image_hw=8, n_samples=32,
              white_bkgr=False)
    js = jax_scene(**kw)
    ts = make_synthetic_scene(device="cpu", **kw)
    # the views (numpy on both sides) agree exactly; the images are the same
    # f32 compositing of 32 samples, up to rounding
    assert ts.to_json() == js.to_json()
    np.testing.assert_allclose(ts.images, js.images, atol=2e-5)
    # a scene file written by the port loads in the JAX package
    ts.save(tmp_path / "scene.json")
    back = JD.SceneData.load(tmp_path / "scene.json")
    assert back.to_json() == js.to_json()
    assert TD.SceneData.load(tmp_path / "scene.json").to_json() == \
        js.to_json()
