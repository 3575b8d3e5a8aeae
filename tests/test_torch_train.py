"""Port parity for the training slice, against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its port: the
table gradient (K3's plain version) against XLA autodiff and the Pallas
backward in interpret mode, the differentiable encoder, the occupancy
refresh, the training renderer with the same random draws, the ray sampler,
the synthetic scene, and one whole train step (loss, gradients, Adam
moments, parameters), also from a state carried across with its optax
moments. Checkpoints and the train loop run on the port alone.
"""
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core import occupancy as JO
from nerfpp_tpu.core.rays import (calibration_matrix, get_ray_batch,
                                  pose_spherical)
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference
from nerfpp_tpu.encoders.sh import SHEncoder as JaxSH
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu.models.nerf_small import NeRFSmall as JaxNeRFSmall
from nerfpp_tpu.pallas.hash_encode_blocked import hash_encode_blocked_bwd
from nerfpp_tpu.render import renderer as JR
from nerfpp_tpu_torch.config import TrainParams, hashnerf_blocked_preset
from nerfpp_tpu_torch.config import hashnerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.core import occupancy as TO
from nerfpp_tpu_torch.data import dataset as TD
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.encoders.hashgrid import (HashGridEncoder,
                                               trilerp_weights)
from nerfpp_tpu_torch.encoders.sh import SHEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.parallel import mesh as mesh_utils
from nerfpp_tpu_torch.render import renderer as TR
from nerfpp_tpu_torch.utils import checkpoint as ckpt
from nerfpp_tpu_torch.utils.png import write_png

torch.set_num_threads(1)

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
ENC = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
           base_resolution=16, finest_resolution=128, scheme="blocked")


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _pts(n, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(BBOX[:3], BBOX[3:], (n, 3)).astype(np.float32)


def _sphere_grid(g=16, r=4.0, density=10.0):
    ii = np.indices((g, g, g)).transpose(1, 2, 3, 0)
    d = np.zeros((g, g, g), np.float32)
    d[((ii - (g - 1) / 2) ** 2).sum(-1) < r * r] = density
    return d


# ------------------------------------------------------------------ K3

def _grad_case(n, seed):
    je = JaxEncoder(BBOX, **ENC)
    te = HashGridEncoder(BBOX, use_kernel=False, device="cpu", **ENC)
    pts = _pts(n, seed)
    g = np.random.RandomState(seed + 1).standard_normal(
        (n, je.output_dims)).astype(np.float32)
    return je, te, pts, g


def test_grad_plain_matches_xla_autodiff():
    # Against the float64 sum of the same terms, tight: each entry within
    # 1e-6 of the sum of its terms' magnitudes (f32 rounding of a handful of
    # products and sums). Against the jitted XLA-autodiff oracle: XLA:CPU
    # fuses the cell and weight arithmetic of its gradient differently from
    # its forward, and sits up to 2e-5 off the float64 sum on this input
    # (the port 4e-7), so that comparison holds at 5e-5
    je, te, pts, g = _grad_case(1500, 3)

    @jax.jit
    def oracle(table):
        def f(tab):
            idx, frac = je.corner_indices(jnp.asarray(pts))
            out = gather_trilerp_reference(tab, idx, frac).reshape(len(pts), -1)
            return jnp.sum(out * g)
        return jax.grad(f)(table)

    ref = np.asarray(oracle(jnp.zeros((je.table_rows, 2), jnp.float32)))
    got = K.grad_blocked_plain(t(g), t(pts), te).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=5e-5)
    idx, frac = te.corner_indices(t(pts))
    terms = (trilerp_weights(frac.double()).numpy()[..., None]
             * g.astype(np.float64).reshape(len(pts), -1, 1, 2)).reshape(-1, 2)
    exact = np.zeros((te.table_rows, 2))
    mag = np.zeros((te.table_rows, 2))
    np.add.at(exact, idx.numpy().reshape(-1), terms)
    np.add.at(mag, idx.numpy().reshape(-1), np.abs(terms))
    assert (np.abs(got - exact) <= 1e-6 * mag + 1e-12).all()
    # the padding of a partial group contributes nothing
    padded = K.pad_points(t(pts), te)
    assert padded.shape[0] == 1536
    wids, counts = K.window_lists(padded, te)
    np.testing.assert_array_equal(
        K.grad_blocked(t(g), padded, wids, counts, te).numpy(), got)
    # lanes 125-127 of every 128-lane row are never a corner
    assert not got.reshape(-1, 128, 2)[:, 125:].any()


@pytest.mark.parametrize("n", [100, 1500])
def test_grad_plain_matches_pallas_interpret(n):
    # the Pallas backward rounds its weight pattern and cotangent to bf16:
    # the JAX test's own bound, atol 1e-2 and rtol 2e-2
    je, te, pts, g = _grad_case(n, 5)
    want = np.asarray(hash_encode_blocked_bwd(jnp.asarray(g),
                                              jnp.asarray(pts), je))
    got = K.grad_blocked_plain(t(g), t(pts), te).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=2e-2)


def test_encoder_autograd_matches_jax_custom_vjp():
    # loss sum(sin(3 f)) through both packages' kernel paths: the JAX
    # custom_vjp (Pallas, interpret) and the port's HashEncodeBlocked
    # (plain versions on the CPU). The Pallas forward and backward round to
    # bf16, so the JAX test's bound holds. Against the f32 XLA gradient only
    # the bf16 forward table moves the cotangent, but XLA:CPU's gradient is
    # itself up to 2e-5 per unit cotangent off the exact sum (see the test
    # above), and the cotangent 3 cos(3 f) reaches 3: atol 2e-4
    jk = JaxEncoder(BBOX, use_pallas=True, **ENC)
    jx = JaxEncoder(BBOX, **ENC)
    params = jk.init(jax.random.PRNGKey(0))
    pts = _pts(300, 7)

    def loss(p, e):
        feats, keep = e(p, jnp.asarray(pts))
        return jnp.sum(jnp.sin(3.0 * feats)), keep

    (lk, keep_k), gk = jax.value_and_grad(loss, has_aux=True)(params, jk)
    (lx, _), gx = jax.value_and_grad(loss, has_aux=True)(params, jx)
    te = HashGridEncoder(BBOX, use_kernel=True, device="cpu", **ENC)
    with torch.no_grad():
        te.table.copy_(t(params["table"]))
    feats, keep = te(t(pts))
    loss_t = torch.sum(torch.sin(3.0 * feats))
    loss_t.backward()
    lt = loss_t.detach()
    assert feats.shape == (300, 8)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_k))
    np.testing.assert_allclose(float(lt), float(lk), atol=1e-4)
    gt_ = te.table.grad.numpy()
    np.testing.assert_allclose(gt_, np.asarray(gk["table"]), atol=1e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(gt_, np.asarray(gx["table"]), atol=2e-4,
                               rtol=1e-5)
    # the bf16-packed table moves each feature by up to 2^-9 of itself
    np.testing.assert_allclose(float(lt), float(lx), atol=1e-5)


def test_f32_encoder_autograd_matches_xla():
    # use_kernel=False: the f32 gather differentiates through plain autograd.
    # Tolerance as above: XLA:CPU's own gradient error, cotangent up to 3
    jx = JaxEncoder(BBOX, **ENC)
    tab = np.random.RandomState(2).uniform(
        -1, 1, (jx.table_rows, 2)).astype(np.float32)
    pts = _pts(200, 8)
    gx = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(
        3.0 * jx({"table": p}, jnp.asarray(pts))[0]))))(jnp.asarray(tab))
    te = HashGridEncoder(BBOX, use_kernel=False, device="cpu", **ENC)
    with torch.no_grad():
        te.table.copy_(t(tab))
    torch.sum(torch.sin(3.0 * te(t(pts))[0])).backward()
    np.testing.assert_allclose(te.table.grad.numpy(), np.asarray(gx),
                               rtol=1e-5, atol=2e-4)


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


def _batch_rays(n, seed):
    rng = np.random.RandomState(seed)
    pose = pose_spherical(rng.uniform(0, 360), -30.0, 3.0)
    k = calibration_matrix(30.0, 32, 32)
    xs = rng.uniform(0, 32, n).astype(np.float32)
    ys = rng.uniform(0, 32, n).astype(np.float32)
    o, d, cone = get_ray_batch(jnp.asarray(xs), jnp.asarray(ys),
                               jnp.asarray(k), jnp.asarray(pose))
    return np.asarray(o), np.asarray(d), float(cone)


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

def _images(n, h, w, seed=0):
    return np.random.RandomState(seed).uniform(
        0, 1, (n, h, w, 3)).astype(np.float32)


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


# ------------------------------------------------------------ train step

TINY = dict(n_importance=0, log2_hashmap_size=10, finest_resolution=64,
            n_levels=4, density_activation="trunc_exp",
            use_occupancy_grid=True, occ_grid_resolution=16,
            occ_update_every=2, occ_n_bins=8, occ_phased_refresh=True,
            occ_phased_warmup=2, occ_ray_tile=128, occ_tile_budget_frac=0.5,
            occ_sparse_samples=4, occ_tile_budget_warmup=1,
            hash_scheme="blocked", use_pallas_encoder=False, thin_ray=True)
TINY_TP = dict(n_samples=8, n_rand=2048, n_iters=100, chunk=256)
STEP = 13      # raw_noise_std is 0 from step 100 / 8; not a refresh step


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_step(request):
    """The JAX executor at the tiny shapes (blocked scheme, XLA encoder, no
    importance pass), its jitted train step and a tile sampler."""
    dtype = request.param
    jx = JaxExecutor(jax_hashnerf_preset(compute_dtype=dtype, **TINY))
    tp = JaxTrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    jx.state["occupancy"] = JO.OccupancyGrid(
        density=jnp.asarray(_sphere_grid()))
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(_images(3, h, w, seed=1)),
        poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand, tile_h=8, tile_w=16)
    return dtype, jx, jx._build_train_step(tp), sampler


def _batch(sampler, key, step):
    """The train step's own batch: split(fold_in(key, step), 5)[0]."""
    kb = jax.random.split(jax.random.fold_in(key, step), 5)[0]
    jb = sampler.sample(kb, jnp.int32(step))
    return {k: t(v) for k, v in jb.items()}


def _port_from(dtype, jstate):
    tx = NeRFExecutor(hashnerf_preset(compute_dtype=dtype, **TINY),
                      device="cpu")
    tx.initialize(BBOX, TrainParams().lrate_decay, seed=0)
    st = jax.tree.map(np.asarray, jax.device_get(jstate))
    tx.load_state(state_from_jax(st["params"], st["occupancy"].density,
                                 st["opt_state"], int(st["step"]),
                                 device="cpu"))
    return tx


def _leaves(tree):
    """A params-shaped JAX tree as {port name: numpy [out, in]}."""
    return {k: v.numpy() for k, v in state_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu").items()}


def _compare_step(dtype, jx, step_fn, sampler, jstate, step, mu_prev):
    key = jax.random.PRNGKey(1)
    jstate = {**jstate, "step": jnp.int32(step)}
    tx = _port_from(dtype, jstate)
    new, jm = step_fn(jstate, sampler, key)
    tm = tx._build_train_step(TrainParams(**TINY_TP))(
        step, _batch(sampler, key, step))
    f32 = dtype == "float32"
    # bf16 MLP operands round at other places in the two frameworks, so a
    # few hidden values land on the neighbouring bf16 value: loose bounds
    rtol = 1e-5 if f32 else 2e-3
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rtol), k
    # pred_std = sqrt(E[x^2] - E[x]^2) of values near 0.5 with a spread near
    # 0.02: the difference cancels ~3 digits of the f32 sums' rounding
    assert float(tm["pred_std"]) == pytest.approx(float(jm["pred_std"]),
                                                  rel=1000 * rtol)
    adam = new["opt_state"][0]
    mu, nu = _leaves(adam.mu), _leaves(adam.nu)
    params = _leaves(new["params"])
    assert int(adam.count) == int(tx.optimizer.count)
    assert tx.step == step + 1
    for name, prm in tx.named_parameters().items():
        # the gradient JAX used, recovered from its new first moment
        gj = (mu[name] - 0.9 * mu_prev[name]) / 0.1
        gt_ = prm.grad.numpy()
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        # Gradients: every entry within 5e-3 of the largest, and 95% (f32)
        # within 1e-4, or 99% (bf16) within 1e-3. The colour net agrees to
        # ~3e-7 in f32; the sigma net and the table sum many samples' terms
        # that cancel, and XLA:CPU's own gather gradient is off by up to
        # 2e-5 per term (test_grad_plain_matches_xla_autodiff). In bf16 a
        # few MLP operands round to the neighbouring bf16 value
        bulk, frac = (1e-4, 0.95) if f32 else (1e-3, 0.99)
        diff = np.abs(gt_ - gj)
        assert np.mean(diff <= bulk * scale) >= frac, name
        assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)
        np.testing.assert_allclose(tx.optimizer.mu[name].numpy(), mu[name],
                                   atol=5e-4 * scale, err_msg=name)
        np.testing.assert_allclose(tx.optimizer.nu[name].numpy(), nu[name],
                                   atol=2e-3 * float(nu[name].max()),
                                   err_msg=name)
        # Parameters where the update is well defined: an Adam update is a
        # smooth function of g except where g is tiny (with eps 1e-15 the
        # first update is ~ lr * sign(g), and a tiny gradient may flip sign
        # between implementations). So compare where |g| > 1e-3 max|g| and
        # the two gradients agree to 1e-2 (95% of those entries or more)
        p_t = prm.detach().numpy()
        clear = np.abs(gj) > 1e-3 * scale
        same = clear & (diff <= 1e-2 * np.abs(gj))
        assert same.sum() >= 0.95 * clear.sum(), name
        np.testing.assert_allclose(p_t[same], params[name][same], rtol=1e-5,
                                   atol=1e-4, err_msg=name)
        # untouched entries (g == 0 on both sides) move only by the decayed
        # moments of earlier steps: not at all from a fresh optimizer
        untouched = (gj == 0) & (gt_ == 0)
        if not mu_prev[name].any():
            np.testing.assert_array_equal(p_t[untouched],
                                          params[name][untouched])
        np.testing.assert_allclose(p_t[untouched], params[name][untouched],
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    return new


def test_train_step_matches_jax(jax_step):
    # one whole step from a fresh optimizer: budgeted render (the sphere grid
    # splits the tiles), Huber loss, gradients through NeRFSmall and the
    # f32 gather, Adam (eps 1e-15, betas 0.9/0.99)
    dtype, jx, step_fn, sampler = jax_step
    zeros = {k: np.zeros_like(v) for k, v in _leaves(
        jx.state["params"]).items()}
    _compare_step(dtype, jx, step_fn, sampler, jx.state, STEP, zeros)


def test_converted_state_takes_the_same_next_step(jax_step):
    # a JAX state with nonzero optax moments (after one step) is carried
    # across by convert.state_from_jax, loaded, and both take step 15
    dtype, jx, step_fn, sampler = jax_step
    state, _ = step_fn({**jx.state, "step": jnp.int32(STEP)}, sampler,
                       jax.random.PRNGKey(1))
    mu_prev = _leaves(state["opt_state"][0].mu)
    tx = _port_from(dtype, state)
    assert int(tx.optimizer.count) == 1 and tx.step == STEP + 1
    np.testing.assert_array_equal(tx.optimizer.nu["embed.table"].numpy(),
                                  _leaves(state["opt_state"][0].nu)
                                  ["embed.table"])
    _compare_step(dtype, jx, step_fn, sampler, state, STEP + 2, mu_prev)


# ----------------------------------------------- checkpoints and the loop

def _tiny_port(**kw):
    p = hashnerf_blocked_preset(
        n_importance=0, use_occupancy_grid=True, log2_hashmap_size=10,
        n_levels=2, finest_resolution=32, occ_grid_resolution=16,
        occ_update_every=2, occ_phased_warmup=4, occ_tile_budget_warmup=4,
        **kw)
    return NeRFExecutor(p, device="cpu")


def test_checkpoint_round_trip_and_restore_latest(tmp_path):
    ex = _tiny_port().initialize(BBOX, seed=1)
    ex.step = 7
    ex.optimizer.count.fill_(5)
    ex.optimizer.mu["embed.table"].fill_(0.25)
    path = ex.save_checkpoint(tmp_path)
    assert path.name == "step_7"
    other = _tiny_port().initialize(BBOX, seed=2)
    other.load_state(ckpt.restore_latest(tmp_path))
    for k, v in ex.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # the most recently saved wins over a higher step; equal mtimes fall
    # back to the step
    ex.step = 9
    ex.save_checkpoint(tmp_path)
    ex.step = 3
    ex.save_checkpoint(tmp_path)
    now = time.time()
    os.utime(tmp_path / "step_7", (now - 20, now - 20))
    os.utime(tmp_path / "step_9", (now - 10, now - 10))
    os.utime(tmp_path / "step_3", (now, now))
    assert int(ckpt.restore_latest(tmp_path)["step"]) == 3
    os.utime(tmp_path / "step_9", (now, now))
    assert int(ckpt.restore_latest(tmp_path)["step"]) == 9
    assert ckpt.restore_latest(tmp_path / "none") is None
    # ft_path restores at initialize
    ft = _tiny_port(ft_path=str(tmp_path)).initialize(BBOX, seed=1)
    assert ft.step == 9


def test_train_loop(tmp_path, capsys):
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=16, white_bkgr=False, device="cpu")
    tp = TrainParams(n_samples=8, n_rand=256, chunk=256, n_iters=12,
                     i_print=5, i_img=0, i_weights=10, i_testset=0,
                     steps_per_call=4, base_dir=str(tmp_path))
    ex = _tiny_port()
    seen = []
    m = ex.train(sc, tp, progress_fn=lambda i, mm: seen.append(i))
    # steps 0..10 as in the JAX loop; steps_per_call 4 shrinks to gcd 1
    assert ex.step == 11 and seen == [5, 10]
    assert sorted(d.name for d in tmp_path.iterdir()) == ["metrics.csv",
                                                          "step_10",
                                                          "step_11"]
    # metrics.csv holds the i_print rows
    rows = (tmp_path / "metrics.csv").read_text().splitlines()
    assert rows[0] == "step,mse,img_loss,pred_std,loss,psnr"
    assert [r.split(",")[0] for r in rows[1:]] == ["5", "10"]
    # the same run in stages (7 steps, then the rest) ends in the same
    # state: step i's draws depend on (seed, i) only
    staged = _tiny_port()
    staged.train(sc, TrainParams(**{**tp.__dict__, "i_weights": 0}),
                 steps=7)
    assert staged.step == 7
    staged.train(sc, TrainParams(**{**tp.__dict__, "i_weights": 0}))
    for k, v in ex.state_dict().items():
        assert torch.allclose(staged.state_dict()[k], v, rtol=1e-5,
                              atol=1e-7), k
    assert set(m) == {"mse", "img_loss", "pred_std", "loss", "psnr"}
    assert np.isfinite(list(m.values())).all()
    assert "[TRAIN] Iter: 10 of 12" in capsys.readouterr().out
    # both refresh branches ran (full before step 4, phased after) and the
    # grid is no longer the uniform prior
    assert not torch.equal(ex.occupancy.density, torch.ones(16, 16, 16))
    # the bbox refit is ported (tests/test_torch_refit.py;
    # tests/test_torch_cli.py covers i_img and i_testset)
    ex.train(sc, TrainParams(**{**tp.__dict__, "bbox_refit_step": 5}))
    # a device mesh of one rank (gloo) trains bitwise as no mesh, as the
    # JAX step takes its plain path at one device (more ranks:
    # tests/test_torch_parallel.py)
    once = TrainParams(**{**tp.__dict__, "i_weights": 0})
    plain, meshed = _tiny_port(), _tiny_port()
    plain.train(sc, once)
    with mesh_utils.one_rank("cpu") as mesh:
        meshed.train(sc, once, mesh=mesh)
    assert meshed.step == plain.step == 11
    for k, v in plain.state_dict().items():
        assert torch.equal(meshed.state_dict()[k], v), k


def test_non_finite_loss_skips_the_update():
    ex = _tiny_port().initialize(BBOX, seed=1)
    before = {k: v.clone() for k, v in ex.state_dict().items()
              if k != "step"}
    step = ex._build_train_step(TrainParams(n_samples=8, n_rand=256,
                                            chunk=256, n_iters=100))
    o = torch.zeros(256, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(256, 3).contiguous()
    batch = {"rays_o": o + torch.tensor([0.0, 0.0, 3.0]), "rays_d": d,
             "cone_angle": torch.tensor(0.01),
             "target_rgb": torch.full((256, 3), float("nan"))}
    m = step(5, batch, torch.Generator().manual_seed(0))
    assert not torch.isfinite(m["loss"])
    assert ex.step == 6
    for k, v in ex.state_dict().items():
        if k != "step":
            assert torch.equal(v, before[k]), k
