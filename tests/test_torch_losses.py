"""Port parity: the auxiliary losses (core/losses.py) against the JAX
package's, and utils/profiling.py's StepTimer as tests/test_utils_extra.py
checks the JAX one.

The inputs come from a numpy seed; f32 on both sides, each loss a sum or a
mean of at most 64 terms: rtol 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.core import losses as JL
from nerfpp_tpu_torch.core import losses as TL
from nerfpp_tpu_torch.utils.profiling import StepTimer

torch.set_num_threads(1)


def _inputs(seed=0, bs=16, n=64):
    rng = np.random.RandomState(seed)
    sig = rng.standard_normal((bs, n)).astype(np.float32) * 3
    w = rng.uniform(0, 1, (bs, n, 1)).astype(np.float32)
    nrm = rng.standard_normal((bs, n, 3)).astype(np.float32)
    pred = rng.standard_normal((bs, n, 3)).astype(np.float32)
    vd = rng.standard_normal((bs, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return sig, w, nrm, pred, vd


@pytest.mark.parametrize("name", ["sigma_sparsity_loss", "orientation_loss",
                                  "pred_normal_loss"])
def test_loss_matches_jax(name):
    sig, w, nrm, pred, vd = _inputs()
    args = {"sigma_sparsity_loss": (sig,),
            "orientation_loss": (w, nrm, vd),
            "pred_normal_loss": (w, nrm, pred)}[name]
    want = np.asarray(getattr(JL, name)(*map(jnp.asarray, args)))
    got = getattr(TL, name)(*map(torch.as_tensor, args)).numpy()
    assert got.shape == want.shape
    assert want.shape == {"sigma_sparsity_loss": (16,),
                          "orientation_loss": (16,),
                          "pred_normal_loss": ()}[name]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if name == "orientation_loss":
        # a normal that faces the camera costs nothing
        facing = TL.orientation_loss(torch.ones(1, 2, 1),
                                     -torch.as_tensor(vd[:1, None, :])
                                     .expand(1, 2, 3),
                                     torch.as_tensor(vd[:1]))
        assert float(facing) == 0.0


def test_losses_differentiate():
    sig, w, nrm, pred, vd = (torch.as_tensor(x).requires_grad_()
                             for x in _inputs(1))
    total = (TL.sigma_sparsity_loss(sig).sum()
             + TL.orientation_loss(w, nrm, vd).sum()
             + TL.pred_normal_loss(w, nrm, pred))
    total.backward()
    for x in (sig, w, nrm, pred, vd):
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_step_timer():
    t = StepTimer(rays_per_step=1000)
    assert t.rays_per_sec == 0.0
    t.tick()
    t.tick()
    assert t.rays_per_sec > 0
    first = t.step_time
    t.tick()
    # the moving average: 0.9 of the last estimate, 0.1 of the new step
    assert t.step_time >= 0.9 * first
