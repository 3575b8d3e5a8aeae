"""Port parity for the training slice's encoder, against the JAX package on
the CPU: the table gradient (K3's plain version) against XLA autodiff and
the Pallas backward in interpret mode, and the differentiable encoder (bf16
table through the blocked kernels' plain versions, and the f32 gather)
against the JAX custom VJP and XLA. The renderer, sampler and scene are in
test_torch_train_render.py, the whole train step, checkpoints and the loop
in test_torch_train_step.py; the shared helpers in torch_train_common.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference
from nerfpp_tpu.pallas.hash_encode_blocked import hash_encode_blocked_bwd
from nerfpp_tpu_torch.encoders.hashgrid import (HashGridEncoder,
                                               trilerp_weights)
from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
from torch_train_common import BBOX, ENC, _pts, t

torch.set_num_threads(1)


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
