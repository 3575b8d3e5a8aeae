"""Port parity: core math, SH, NeRFSmall, occupancy prior and tile probe.

The port on the CPU against the JAX package on the same numpy inputs; the
JAX side runs jitted, as the renderer runs it. Tolerances are stated per test.

Sampling (sample_pdf, z values, the unit linspace):
tests/test_torch_core_sampling.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.core import integrate as JI
from nerfpp_tpu.core import occupancy as JO
from nerfpp_tpu.core import rays as JR
from nerfpp_tpu.core import sampling as JS
from nerfpp_tpu.encoders.sh import sh_encode as jax_sh
from nerfpp_tpu.models.nerf_small import NeRFSmall as JaxNeRFSmall
from nerfpp_tpu.render.renderer import probe_tile_mass as jax_probe
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.core import integrate as TI
from nerfpp_tpu_torch.core import occupancy as TO
from nerfpp_tpu_torch.core import rays as TR
from nerfpp_tpu_torch.core import sampling as TS
from nerfpp_tpu_torch.encoders.sh import SHEncoder, sh_encode
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.render.renderer import probe_tile_mass
from tests.torch_core_common import BBOX, _rays, _sphere_grid, t

torch.set_num_threads(1)


def test_get_rays_and_intersect_aabb():
    # exact: the port writes the rotation as the same three products
    k = JR.calibration_matrix(26.4, 24, 20)
    pose = JR.pose_spherical(40.0, -30.0, 3.0)
    ro_j, rd_j, ca_j = jax.jit(lambda k, p: JR.get_rays(20, 24, k, p))(
        jnp.asarray(k), jnp.asarray(pose))
    ro_t, rd_t, ca_t = TR.get_rays(20, 24, t(k), t(pose))
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-7)
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    assert float(ca_t) == pytest.approx(float(ca_j), rel=1e-7)
    n_j, f_j = jax.jit(JR.intersect_aabb)(rd_j * 0 + ro_j, rd_j,
                                          jnp.asarray(BBOX))
    n_t, f_t = TR.intersect_aabb(ro_t, rd_t, t(BBOX))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6)


@pytest.mark.parametrize("degree", [1, 4, 8])
def test_sh_encode(degree):
    # float32 polynomials of the same coefficients: |basis| <= ~3, so a few
    # ulps of the largest terms
    rng = np.random.RandomState(degree)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jax.jit(lambda x: jax_sh(x, degree))(jnp.asarray(d)))
    got, none = SHEncoder(degree)(t(d))
    assert none is None and got.shape == (500, degree * degree)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    with pytest.raises(ValueError):
        sh_encode(t(d), 9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_small_with_converted_weights(dtype):
    # bf16 means bf16 operands, f32 accumulation and f32 output on both
    # sides; the products are exact, so only the summation order differs
    jm = JaxNeRFSmall(3, 64, 15, 4, 64, False, 3, 64, 32, 16,
                      compute_dtype=(jnp.bfloat16 if dtype == "bfloat16"
                                     else None), init_gain=1.0)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    x = np.random.RandomState(4).standard_normal((300, 48)).astype(np.float32)
    want = np.asarray(jax.jit(jm)(params, jnp.asarray(x)))
    tm = NeRFSmall(3, 64, 15, 4, 64, False, 32, 16, compute_dtype=dtype,
                   init_gain=1.0, device="cpu")
    st = state_from_jax({"embed": {"table": np.zeros((1, 2))},
                         "model": params}, device="cpu")
    tm.load_state_dict({k[6:]: v for k, v in st.items()
                        if k.startswith("model.")})
    with torch.no_grad():
        got = tm(t(x))
    assert got.shape == (300, 4) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    else:
        # a hidden value one f32 ulp from a bf16 rounding boundary rounds to
        # the neighbouring bf16 value (2^-8 relative) on one side: rare
        # outputs move by up to ~1e-2, the bulk agrees to f32 rounding
        np.testing.assert_allclose(got.numpy(), want, atol=1e-2)
        assert float(np.mean(np.abs(got.numpy() - want))) < 2e-5


@pytest.mark.parametrize("act", ["relu", "trunc_exp"])
def test_raw2outputs(act):
    rng = np.random.RandomState(5)
    raw = rng.standard_normal((64, 12, 4)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 4.0, (64, 12)), -1).astype(np.float32)
    rd = rng.standard_normal((64, 3)).astype(np.float32)
    want = jax.jit(lambda r, z, d: JI.raw2outputs(
        r, z, d, white_bkgr=True, density_activation=act))(raw, z, rd)
    got = TI.raw2outputs(t(raw), t(z), t(rd), white_bkgr=True,
                         density_activation=act)
    for f in ("rgb", "acc", "weights", "depth", "disp"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=2e-5, atol=2e-6)


def test_trunc_exp_gradient():
    x = torch.tensor([-200.0, -1.0, 0.0, 4.0, 8.0], requires_grad=True)
    TI.trunc_exp(x).sum().backward()
    np.testing.assert_allclose(
        x.grad.numpy(), np.exp(np.clip(x.detach().numpy(), -100.0, 5.0)),
        rtol=1e-6)


def test_tangent_scatter_shared_uniforms():
    # the JAX function draws from its key; the port takes those same draws
    rng = np.random.RandomState(7)
    o, d = _rays(40, seed=7)
    z = np.sort(rng.uniform(1.0, 5.0, (40, 10)), -1).astype(np.float32)
    pts = o[:, None] + d[:, None] * z[..., None]
    key = jax.random.PRNGKey(11)
    kr, kt = jax.random.split(key)
    u_r = np.asarray(jax.random.uniform(kr, (40, 10, 1)))
    u_t = np.asarray(jax.random.uniform(kt, (40, 10, 1)))
    want = np.asarray(jax.jit(lambda p, z, d: JS.tangent_scatter(
        p, z, 0.02, d, key, jnp.asarray(BBOX)))(pts, z, d))
    got = TS.tangent_scatter(t(pts), t(z), 0.02, t(d), t(u_r), t(u_t),
                             t(BBOX)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert TS.tangent_scatter(t(pts), t(z), None, t(d), None, None) is not None


def test_tiled_prior_and_ray_bin_weights():
    # the grid lookups are integer cell picks: depths and weights agree to
    # f32 rounding, masses (sums of grid values) exactly
    o, d = _rays(256, seed=8)
    near_j, far_j = JR.intersect_aabb(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(BBOX))
    near, far = np.asarray(near_j)[:, None], np.asarray(far_j)[:, None]
    grid = _sphere_grid()
    jgrid = JO.OccupancyGrid(density=jnp.asarray(grid))
    tgrid = TO.OccupancyGrid(density=t(grid))
    e_j, w_j, m_j = jax.jit(lambda o, d, n, f: JO.tiled_prior(
        jgrid, o, d, n, f, jnp.asarray(BBOX), 8, 0.1, 128))(o, d, near, far)
    e_t, w_t, m_t = TO.tiled_prior(tgrid, t(o), t(d), t(near), t(far),
                                   t(BBOX), 8, 0.1, 128)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    z_j = jax.jit(lambda o, d, n, f: JO.tiled_ray_z(
        jgrid, o, d, n[..., 0], f[..., 0], jnp.asarray(BBOX), 8, 12))(
        o, d, near, far)
    z_t = TO.tiled_ray_z(tgrid, t(o), t(d), t(near[:, 0]), t(far[:, 0]),
                         t(BBOX), 8, 12)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=2e-6)
    e_j, w_j = jax.jit(lambda o, d, n, f: JO.ray_bin_weights(
        jgrid, o, d, n, f, jnp.asarray(BBOX), 8))(o, d, near, far)
    e_t, w_t = TO.ray_bin_weights(tgrid, t(o), t(d), t(near), t(far),
                                  t(BBOX), 8)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)


def test_probe_tile_mass():
    k = JR.calibration_matrix(35.2, 32, 32)
    pose = JR.pose_spherical(20.0, -30.0, 3.0)
    grid = _sphere_grid()
    want = np.asarray(jax.jit(lambda k, p, g: jax_probe(
        JO.OccupancyGrid(density=g), 30, 40, k, p, jnp.asarray(BBOX)))(
        jnp.asarray(k), jnp.asarray(pose), jnp.asarray(grid)))
    got = probe_tile_mass(TO.OccupancyGrid(density=t(grid)), 30, 40, t(k),
                          t(pose), t(BBOX)).numpy()
    assert got.shape == want.shape == (4 * 3,)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0 and got.min() == 0
