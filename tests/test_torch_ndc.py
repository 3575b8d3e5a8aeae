"""Port parity: NDC rays (core/rays.py ndc_rays, the renderer under
cfg.ndc) and render_image's c2w_staticcam, against the JAX package.

ndc_rays with and without cone angles; render_ray_batch(focal=, hw=)
forward and gradient on forward-facing rays (thin rays, perturb 0, no
noise: deterministic); render_image under NDC in both pixel orders at a
size that is not a multiple of the chunk, with and without c2w_staticcam,
and the per-ray cone angle each chunk takes; the four guards with the JAX
package's messages; the executor: render_view serving NDC (where the JAX
executor's jitted render fails), and the train step's ValueError where the
JAX step stops at its assert.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core import occupancy as JO
from nerfpp_tpu.core import rays as JRays
from nerfpp_tpu.core.rays import calibration_matrix
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.sh import SHEncoder as JaxSH
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu.models.nerf_small import NeRFSmall as JaxNeRFSmall
from nerfpp_tpu.render import renderer as JR
from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.core import rays as TRays
from nerfpp_tpu_torch.core import sampling as TS
from nerfpp_tpu_torch.core.occupancy import OccupancyGrid
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.encoders.sh import SHEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.render import renderer as TR

torch.set_num_threads(1)

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
ENC = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
           base_resolution=16, finest_resolution=64, scheme="random")
# forward-facing: the camera at z = 0.5 looking down -z
POSE = np.eye(4, dtype=np.float32)
POSE[2, 3] = 0.5
# a second pose for c2w_staticcam: turned 10 degrees about y, moved in x
STATIC = POSE.copy()
c, s = np.cos(np.radians(10.0)), np.sin(np.radians(10.0))
STATIC[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
STATIC[0, 3] = 0.1


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _stacks():
    """JAX and port closures over the same weights: a random-scheme table
    with |values| <= 0.5 through the f32 gather, a f32 NeRFSmall of gain-1
    numpy weights, SH degree 4. -> (params, jax network_fn, port
    network_fn, port modules by state name prefix)."""
    je = JaxEncoder(BBOX, **ENC)
    jm = JaxNeRFSmall(3, 64, 15, 4, 64, False, 3, 64, 8, 16)
    rng = np.random.RandomState(0)
    params = {"embed": {"table": rng.uniform(
        -0.5, 0.5, (je.table_rows, 2)).astype(np.float32)}, "model": {
        net: [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32)} for a, b in zip(dims[:-1], dims[1:])]
        for net, dims in (("sigma_net", jm._dims_sigma()),
                          ("color_net", jm._dims_color()))}}
    te = HashGridEncoder(BBOX, use_kernel=False, device="cpu", **ENC)
    tm = NeRFSmall(3, 64, 15, 4, 64, False, 8, 16, device="cpu")
    st = state_from_jax(params, device="cpu")
    te.load_state_dict({"table": st["embed.table"]})
    tm.load_state_dict({k[6:]: v for k, v in st.items()
                        if k.startswith("model.")})
    jsh, tsh = JaxSH(4), SHEncoder(4)
    jnet = JR.make_nerf_network_fn(
        lambda p, x: je(p["embed"], x), lambda p, x: jsh(x),
        lambda p, x: jm(p["model"], x))
    return (params, jnet, TR.make_nerf_network_fn(te, tsh, tm),
            {"embed": te, "model": tm})


def _cfg(**kw):
    cfg = dict(n_samples=8, n_importance=16, use_viewdirs=True,
               thin_ray=True, ndc=True, density_activation="trunc_exp")
    cfg.update(kw)
    return JR.RenderConfig(**cfg), TR.RenderConfig(**cfg)


def _close(got, want, f):
    # f32 on both sides; the fine depths follow the coarse weights through
    # JAX's one-hot bf16-split picks and XLA:CPU's FMAs (as in
    # tests/test_torch_hier.py): 99% within 1e-5, every value within 2e-3
    a, b = np.asarray(want), got.detach().numpy()
    assert (np.abs(b - a) <= 1e-5 + 1e-5 * np.abs(a)).mean() >= 0.99, f
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=1e-5, err_msg=f)


def _ff_rays(n, seed, h=24, w=32, focal=30.0):
    """Forward-facing rays through random pixels of an h x w view."""
    rng = np.random.RandomState(seed)
    k = calibration_matrix(focal, w, h)
    xs = rng.uniform(0, w, n).astype(np.float32)
    ys = rng.uniform(0, h, n).astype(np.float32)
    o, d, cone = JRays.get_ray_batch(jnp.asarray(xs), jnp.asarray(ys),
                                     jnp.asarray(k), jnp.asarray(POSE))
    return np.asarray(o), np.asarray(d), float(cone)


@pytest.mark.parametrize("cone", [False, True])
def test_ndc_rays_matches_jax(cone):
    # 1,000 rays off several origins; the cone angle rescaled per ray by
    # the direction-norm ratio. f32 with the same operations: rtol 1e-6
    rng = np.random.RandomState(1)
    o = rng.uniform(-0.3, 0.3, (1000, 3)).astype(np.float32)
    d = rng.standard_normal((1000, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    ca = 0.004 if cone else None
    jo, jd, jc = JRays.ndc_rays(24, 32, 30.0, 1.0, jnp.asarray(o),
                                jnp.asarray(d), ca)
    to, td, tc = TRays.ndc_rays(24, 32, 30.0, 1.0, t(o), t(d),
                                None if ca is None else torch.tensor(ca))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    if cone:
        assert tc.shape == (1000, 1)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    else:
        assert tc is None and jc is None
    # the origins land on the near plane: NDC z = -1
    np.testing.assert_allclose(to[:, 2].numpy(), -1.0, atol=1e-5)


def test_render_ray_batch_ndc_matches_jax():
    # 256 forward-facing rays, 8 + 16 samples, view directions from the
    # pre-NDC directions; the loss sum(rgb * w) differentiated into the
    # table and both nets
    params, jnet, tnet, mods = _stacks()
    jcfg, tcfg = _cfg()
    o, d, cone = _ff_rays(256, 2)
    wts = np.random.RandomState(3).uniform(0, 1, (256, 3)).astype(np.float32)

    def jloss(p):
        res = JR.render_ray_batch(p, jnet, JR.make_nerf_integrate_fn(jcfg),
                                  jnp.asarray(o), jnp.asarray(d), cone,
                                  jax.random.PRNGKey(0), jcfg,
                                  jnp.asarray(BBOX), focal=30.0, hw=(24, 32))
        return jnp.sum(res.outputs.rgb * wts), res

    (_, jres), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tres = TR.render_ray_batch(tnet, TR.make_nerf_integrate_fn(tcfg), t(o),
                               t(d), torch.tensor(cone), tcfg, t(BBOX),
                               focal=30.0, hw=(24, 32))
    (tres.outputs.rgb * t(wts)).sum().backward()
    # the coarse depths to 1e-6, the importance ones as test_torch_hier.py
    # bounds them (near-empty bins: 99% to 1e-6, all to 1e-3)
    a, b = np.asarray(jres.z_vals), tres.z_vals.detach().numpy()
    assert (np.abs(b - a) <= 1e-6 + 1e-6 * np.abs(a)).mean() >= 0.99
    np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-6)
    assert float(tres.outputs.acc.detach().mean()) > 0.05
    for f in ("rgb", "depth", "acc"):
        _close(getattr(tres.outputs, f), getattr(jres.outputs, f), f)
        _close(getattr(tres.coarse, f), getattr(jres.coarse, f), f)
    # gradients: 99% within 1e-4 of each tensor's largest entry, every
    # entry within 5e-3 (sums of many samples' terms; a depth that moves
    # in a near-empty bin moves its sample's terms)
    want = state_from_jax(jax.tree.map(np.asarray, jgrad), device="cpu")
    for head, mod in mods.items():
        for name, prm in mod.named_parameters():
            gj, gt_ = want[f"{head}.{name}"].numpy(), prm.grad.numpy()
            scale = float(np.abs(gj).max())
            diff = np.abs(gt_ - gj)
            assert scale > 0 and np.mean(diff <= 1e-4 * scale) >= 0.99, name
            assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)
    with pytest.raises(ValueError, match="focal"):
        TR.render_ray_batch(tnet, None, t(o), t(d), None, tcfg, t(BBOX))


def test_render_image_ndc_matches_jax(monkeypatch):
    # 13x13 (169 pixels, chunk 64): the last chunk is short, and the tile
    # order pads the view to 16x16. Thin rays, tile order and the static
    # camera (the rays from STATIC, the view directions from POSE) against
    # JAX; the row-major order against the tile order (rays are
    # independent: the same values)
    params, jnet, tnet, _ = _stacks()
    jcfg, tcfg = _cfg(chunk=64, tile_order=True, n_importance=0)
    k = calibration_matrix(15.0, 13, 13)
    jo, jnf = JR.render_image(
        jax.tree.map(jnp.asarray, params), jnet,
        JR.make_nerf_integrate_fn(jcfg), 13, 13, jnp.asarray(k),
        jnp.asarray(POSE), jax.random.PRNGKey(0), jcfg, jnp.asarray(BBOX),
        c2w_staticcam=jnp.asarray(STATIC))

    def render(cfg, **kw):
        with torch.no_grad():
            return TR.render_image(tnet, TR.make_nerf_integrate_fn(cfg), 13,
                                   13, t(k), t(POSE), cfg, t(BBOX), **kw)

    to, tnf = render(tcfg, c2w_staticcam=t(STATIC))
    assert to.rgb.shape == (13, 13, 3)
    for f in ("rgb", "depth", "acc"):
        _close(getattr(to, f), getattr(jo, f), f)
    np.testing.assert_allclose(float(tnf[1]), float(jnf[1]), rtol=1e-6)
    rows = TR.RenderConfig(**{**vars(tcfg), "tile_order": False})
    flat, _ = render(rows, c2w_staticcam=t(STATIC))
    for f in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(getattr(flat, f).numpy(),
                                   getattr(to, f).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    plain, _ = render(tcfg)
    same, _ = render(tcfg, c2w_staticcam=t(POSE))
    assert not torch.equal(plain.rgb, to.rgb)
    assert torch.equal(plain.rgb, same.rgb)
    # cone rays, both orders: each chunk scatters with its own rays' NDC
    # cone angles, the view's angles flattened in the render's pixel order
    scatter = TS.tangent_scatter
    for cfg in (tcfg, rows):
        seen = []

        def spy(pts, z, cone_angle, *args):
            seen.append(cone_angle.reshape(-1).clone())
            return scatter(pts, z, cone_angle, *args)

        monkeypatch.setattr(TS, "tangent_scatter", spy)
        ccfg = TR.RenderConfig(**{**vars(cfg), "thin_ray": False})
        out, _ = render(ccfg, generator=torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(out.rgb).all())
        hp, wp = (16, 16) if cfg.tile_order else (13, 13)
        ro, rd, ca = TRays.get_rays(hp, wp, t(k), t(POSE))
        ca = TRays.ndc_rays(13, 13, 15.0, 1.0, ro, rd, ca)[2]
        if cfg.tile_order:
            ca = TR._tile_flatten(ca, hp, wp)
        got = torch.cat(seen)
        assert [x.numel() for x in seen] == [64] * (hp * wp // 64) + (
            [hp * wp % 64] if hp * wp % 64 else [])
        assert torch.equal(got, ca.reshape(-1))


def test_ndc_guards_match_jax():
    # the occupancy grid and both budgets live in world space: the port
    # raises the JAX package's ValueError with its message
    jcfg, tcfg = _cfg(n_importance=4, n_occ_bins=8, occ_ray_tile=128,
                      hier_ray_tile=128)
    o, d, cone = _ff_rays(256, 4)
    grid = np.ones((8, 8, 8), np.float32)
    jocc = JO.OccupancyGrid(density=jnp.asarray(grid))
    tocc = OccupancyGrid(density=t(grid))
    k = calibration_matrix(15.0, 13, 13)
    jargs = (jnp.asarray(o), jnp.asarray(d), cone, jax.random.PRNGKey(0),
             jcfg, jnp.asarray(BBOX))
    targs = (t(o), t(d), torch.tensor(cone), tcfg, t(BBOX))
    calls = [
        (lambda: JR.render_ray_batch({}, None, None, *jargs, focal=15.0,
                                     hw=(13, 13), occupancy=jocc),
         lambda: TR.render_ray_batch(None, None, *targs, occupancy=tocc,
                                     focal=15.0, hw=(13, 13))),
        (lambda: JR.render_ray_batch_budgeted({}, None, None, *jargs,
                                              occupancy=jocc),
         lambda: TR.render_ray_batch_budgeted(None, None, *targs,
                                              occupancy=tocc)),
        (lambda: JR.render_ray_batch_hier_budgeted({}, None, None, *jargs),
         lambda: TR.render_ray_batch_hier_budgeted(None, None, *targs)),
        (lambda: JR.render_image({}, None, None, 13, 13, jnp.asarray(k),
                                 jnp.asarray(POSE), jax.random.PRNGKey(0),
                                 jcfg, jnp.asarray(BBOX), occupancy=jocc),
         lambda: TR.render_image(None, None, 13, 13, t(k), t(POSE), tcfg,
                                 t(BBOX), occupancy=tocc))]
    for jcall, tcall in calls:
        with pytest.raises(ValueError) as jerr:
            jcall()
        with pytest.raises(ValueError) as terr:
            tcall()
        assert str(terr.value) == str(jerr.value)
        assert "NDC" in str(terr.value)


def test_executor_serves_ndc_and_refuses_to_train_it():
    # hashnerf_preset without hierarchical tiles (their near/far sharing is
    # world-space), tiny: the port's render_view under TrainParams(ndc=True)
    # is its render_image (held against JAX above) through the executor's
    # stack, bitwise; the JAX executor's own render_view fails (its jitted
    # render reads k[0, 0] as a Python float), and its train step stops at
    # render_ray_batch's assert: the port raises ValueError there
    kw = dict(n_levels=2, log2_hashmap_size=10, finest_resolution=32,
              n_importance=8, multires_views=4, thin_ray=True,
              hier_ray_tile=0, hier_tile_budget_frac=0.0)
    jx = JaxExecutor(jax_hashnerf_preset(**kw))
    jtp = JaxTrainParams(ndc=True, n_samples=8, chunk=256, n_rand=256,
                         n_iters=10)
    jx.initialize(BBOX, jtp.lrate_decay, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
    params["embed"]["table"] = np.random.RandomState(5).uniform(
        -0.5, 0.5, params["embed"]["table"].shape).astype(np.float32)
    k = calibration_matrix(20.0, 16, 16)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jx.render_view(POSE, 16, 16, k, jtp)
    tx = NeRFExecutor(hashnerf_preset(**kw), device="cpu")
    tx.initialize(BBOX, seed=0)
    tx.load_state(state_from_jax(params, device="cpu"))
    tp = TrainParams(ndc=True, n_samples=8, chunk=256, n_rand=256,
                     n_iters=10)
    tout = tx.render_view(POSE, 16, 16, k, tp, c2w_staticcam=STATIC)
    cfg = tx.make_render_config(tp, train=False)
    assert cfg.ndc and cfg.n_importance == 8
    with torch.no_grad():
        want, _ = TR.render_image(
            tx._nerf_fns(), TR.make_nerf_integrate_fn(cfg), 16, 16, t(k),
            t(POSE), cfg, t(BBOX), c2w_staticcam=t(STATIC),
            generator=torch.Generator().manual_seed(0))
    for f in ("rgb", "depth", "acc"):
        assert torch.equal(getattr(tout["nerf"], f), getattr(want, f)), f
    assert float(want.acc.mean()) > 0.01
    assert tout["rgb8"].shape == (16, 16, 3)
    # training: the JAX step stops at its assert, the port raises
    poses = np.stack([POSE] * 2)
    sampler = JD.RayBatchSampler(
        images=jnp.zeros((2, 16, 16, 3)), poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([k] * 2)), h=16, w=16,
        batch_size=256)
    with pytest.raises(AssertionError):
        jx._build_train_step(jtp)(jx.state, sampler, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="NDC training is not supported"):
        tx._build_train_step(tp)
