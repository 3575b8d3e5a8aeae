"""Port parity: sampling along rays (sample_pdf, deterministic and
stochastic, linear and disparity z values, the unit linspace's bits), and
two pose helpers of core/rays.py (c2w_to_w2c, same_fov_calibration_matrix).

The port on the CPU against the JAX package on the same numpy inputs; the
JAX side runs jitted, as the renderer runs it. Tolerances are stated per
test.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.core import rays as JR
from nerfpp_tpu.core import sampling as JS
from nerfpp_tpu_torch.core import rays as TR
from nerfpp_tpu_torch.core import sampling as TS
from tests.torch_core_common import t

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 8, 16, 17, 33, 64, 65])
def test_unit_linspace_bits(n):
    want = np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32))
    np.testing.assert_array_equal(TS.unit_linspace(n).numpy(), want)


def test_sample_pdf_det():
    rng = np.random.RandomState(6)
    bins = np.sort(rng.uniform(0.0, 5.0, (50, 17)), -1).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (50, 16)).astype(np.float32)
    w[:5] = 0.0                                   # degenerate rays
    # small, not zero, tails: with exactly zero weights the CDF plateaus
    # within one ulp of 1, and whether u = 1 lands before the plateau
    # depends on the cumsum's summation order (XLA's associative scan vs a
    # sequential sum) -- a discrete, order-dependent edge the occupancy
    # prior never reaches (it has a uniform floor)
    w[5:10, 3:] = 1e-3
    want = np.asarray(jax.jit(lambda b, w: JS.sample_pdf(
        b, w, 24, det=True))(bins, w))
    got = TS.sample_pdf(t(bins), t(w), 24, det=True).numpy()
    # a depth moves by ~ulp(cdf) x bin width / bin mass when the two cumsums
    # round differently: ~2e-4 in the 1e-4-mass tail bins, 1e-6 elsewhere
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert np.mean(np.abs(got - want) <= 2e-6) >= 0.98
    assert (np.diff(got, axis=-1) >= 0).all()


def test_sample_pdf_stochastic_sorted_in_range():
    # the draws differ from JAX's, so this holds the law: sorted depths
    # inside the bins, reproducible from the generator's seed, and the
    # inverse CDF of uniform weights on [0, 1] has mean 1/2
    bins = t(np.tile(np.linspace(0.0, 1.0, 9, dtype=np.float32), (400, 1)))
    w = torch.ones(400, 8)
    z = TS.sample_pdf(bins, w, 32, generator=torch.Generator().manual_seed(1))
    again = TS.sample_pdf(bins, w, 32,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(z, again)
    assert bool((z.diff(dim=-1) >= 0).all())
    assert 0.0 <= float(z.min()) and float(z.max()) <= 1.0
    assert abs(float(z.mean()) - 0.5) < 0.01
    with pytest.raises(ValueError, match="generator"):
        TS.sample_pdf(bins, w, 4)


def test_sample_z_vals_linear_and_disparity():
    near = np.full((8, 1), 0.5, np.float32)
    far = np.linspace(1.0, 6.0, 8, dtype=np.float32)[:, None]
    for lin_disp in (False, True):
        want = np.asarray(jax.jit(lambda n, f: JS.sample_z_vals(
            n, f, 16, lin_disp))(near, far))
        got = TS.sample_z_vals(t(near), t(far), 16, lin_disp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_c2w_to_w2c_inverts_the_pose_as_jax_does():
    for theta, phi, radius in ((30.0, -20.0, 4.0), (-170.0, 75.0, 2.5)):
        pose = JR.pose_spherical(theta, phi, radius, x=0.3, y=-0.1)
        want = np.asarray(JR.c2w_to_w2c(jnp.asarray(pose)))
        got = TR.c2w_to_w2c(t(pose))
        assert got.dtype == torch.float32
        # float32 inverses of a rotation: within 1e-6 of each other
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose((got @ t(pose)).numpy(), np.eye(4),
                                   rtol=0, atol=1e-6)


def test_same_fov_calibration_matrix_is_jaxs():
    for focal, (w, h), (nw, nh) in ((1111.0, (800, 800), (400, 400)),
                                    (525.5, (640, 480), (320, 241)),
                                    (300.0, (200, 500), (1000, 999))):
        k = JR.calibration_matrix(focal, w, h)
        got = TR.same_fov_calibration_matrix(k, nw, nh)
        want = JR.same_fov_calibration_matrix(k, nw, nh)
        assert got.dtype == want.dtype                  # exact: numpy both
        np.testing.assert_array_equal(got, want)
