"""Port parity: the small-table (fixed and random) hash schemes, the plain
versions of their CUDA kernels, and the fixed scheme's TV loss.

The port on the CPU, where each kernel wrapper runs its plain PyTorch
version, against the JAX package on the same numpy inputs: primes,
resolutions and corner indices exactly (against the jitted oracle), the
encode against the Pallas kernels in interpret mode (v2 packed and f32, v1)
and the XLA gather, the table gradient against XLA autodiff and the JAX
custom VJP, and the TV loss with the same cube origins. The order-fixed
gradient that grad_small launches on the card, at the small table's bins:
its bin pass's plan read back against its definition, and the sum in the
plan's order against jax.vjp of the XLA gather.

This file: the encode against the Pallas kernels and the XLA gather, the
table gradient, the kernel's accepted inputs and the TV loss; the exact
integer parts are in tests/test_torch_small_table_exact.py, the bin pass
and the sum in its order in tests/test_torch_small_table_bins.py, the
launch plan in tests/test_torch_small_table_plan.py and
tests/test_torch_small_table_plan_deep.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference
from nerfpp_tpu.encoders.hashgrid import total_variation_loss as jax_tv
from nerfpp_tpu.pallas import hash_encode as JHE
from nerfpp_tpu_torch.encoders.hashgrid import (HashGridEncoder,
                                                total_variation_loss,
                                                trilerp_weights, tv_cube_size)
from nerfpp_tpu_torch.kernels import hash_encode as KS
from tests.torch_small_table_common import (BBOX, KW, _faces_and_boundaries,
                                            _fused_kwargs, _grad_case, _pair,
                                            _pallas_rel, _pts, _table, t)

torch.set_num_threads(1)


@pytest.mark.parametrize("scheme,version,packed", [
    ("random", "v2", True), ("fixed", "v2", True), ("random", "v2", False),
    ("fixed", "v1", False)])
def test_plain_matches_pallas_interpret(scheme, version, packed):
    # The same packed bits (or f32 table) and f32 weights on both sides;
    # N = 300 is not a multiple of the Pallas kernels' point blocks. The
    # Pallas kernels place points by another rounding of the cell
    # coordinate than the jitted oracle the port follows (ROADMAP.md,
    # faults): on points where both forms give the same coordinate on every
    # level the outputs agree to 1e-6 (|table| <= 1); elsewhere a feature
    # moves by at most its trilinear slope, 2 max|table| per unit, times
    # the coordinates' difference (an ulp or two of a coordinate up to 128).
    # Few levels: the interpreter's cost grows with the unrolled levels
    je, te = _pair(scheme, n_levels=1 if version == "v1" else 2)
    pts = _pts(300, 6)
    tab = _table(je.table_rows, 7)
    want = np.asarray(JHE.hash_encode_fused(
        jnp.asarray(tab), jnp.asarray(pts), **_fused_kwargs(je, version,
                                                            packed)))
    got = KS.hash_encode_fused(t(tab), t(pts), te, version, packed).numpy()
    assert got.shape == (300, 2 * te.n_levels)
    rel_p = _pallas_rel(je, pts)
    rel_j = te.hashed_rel(t(pts)).numpy()
    np.testing.assert_array_equal(np.floor(rel_p), np.floor(rel_j))
    same = (rel_p == rel_j).all(axis=(1, 2))
    assert same.sum() >= 30
    np.testing.assert_allclose(got[same], want[same], atol=1e-6)
    bound = 2.0 * np.abs(rel_p - rel_j).sum(-1)            # [N, L]
    assert (np.abs(got - want).reshape(300, -1, 2)
            <= bound[..., None] + 1e-6).all()


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_plain_matches_xla_and_v1_equals_v2(scheme):
    # the f32-table plain version against the jitted XLA gather, and the
    # port's v1 route is its v2 f32 route, bit for bit
    je, te = _pair(scheme)
    pts = np.concatenate([_pts(2000, 8), _faces_and_boundaries(te, 500, 9)])
    tab = _table(je.table_rows, 10)
    ref = np.asarray(jax.jit(lambda tb, p: gather_trilerp_reference(
        tb, *je.corner_indices(p)))(jnp.asarray(tab), jnp.asarray(pts)))
    v2 = KS.hash_encode_fused(t(tab), t(pts), te, "v2", packed=False)
    v1 = KS.hash_encode_fused(t(tab), t(pts), te, "v1", packed=True)
    np.testing.assert_allclose(v2.numpy(), ref.reshape(len(pts), -1),
                               atol=1e-6)
    assert torch.equal(v1, v2)


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_grad_plain_matches_xla_autodiff(scheme):
    # index_add_ of w * g against XLA's gradient of the f32 gather, and
    # each entry within 1e-6 of the sum of its terms' magnitudes of the
    # float64 sum
    je, te, pts, g = _grad_case(scheme, 1500, 3)

    @jax.jit
    def oracle(table):
        def f(tab):
            out = gather_trilerp_reference(
                tab, *je.corner_indices(jnp.asarray(pts)))
            return jnp.sum(out.reshape(len(pts), -1) * g)
        return jax.grad(f)(table)

    ref = np.asarray(oracle(jnp.zeros((je.table_rows, 2), jnp.float32)))
    got = KS.grad_small(t(g), t(pts), te).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=5e-5)
    idx, frac = te.corner_indices(t(pts))
    terms = (trilerp_weights(frac.double()).numpy()[..., None]
             * g.astype(np.float64).reshape(len(pts), -1, 1, 2)).reshape(-1, 2)
    exact = np.zeros((te.table_rows, 2))
    mag = np.zeros((te.table_rows, 2))
    np.add.at(exact, idx.numpy().reshape(-1), terms)
    np.add.at(mag, idx.numpy().reshape(-1), np.abs(terms))
    assert (np.abs(got - exact) <= 1e-6 * mag + 1e-12).all()


@pytest.mark.parametrize("scheme", ["random"])
def test_encoder_autograd_matches_jax_custom_vjp(scheme):
    # loss sum(f * g) through both packages' kernel paths: the JAX custom
    # VJP (Pallas forward in interpret mode, bf16 one-hot matmul backward)
    # and the port's HashEncodeSmall (plain versions). The JAX backward
    # rounds each term's operands to bf16: 5e-3 of the largest entry, as
    # tests/test_pallas_kernel.py holds it
    kw = dict(KW, n_levels=2, scheme=scheme)
    jk = JaxEncoder(BBOX, use_pallas=True, **kw)
    pts = _pts(256, 11)
    g = np.random.RandomState(12).standard_normal(
        (256, jk.output_dims)).astype(np.float32)
    tab = _table(jk.table_rows, 12)
    gj = jax.grad(lambda p: jnp.sum(jk(p, jnp.asarray(pts))[0] * g))(
        {"table": jnp.asarray(tab)})["table"]
    tk = HashGridEncoder(BBOX, use_kernel=True, device="cpu", **kw)
    with torch.no_grad():
        tk.table.copy_(t(tab))
    feats, keep = tk(t(pts))
    torch.sum(feats * t(g)).backward()
    got = tk.table.grad.numpy()
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(got / scale, np.asarray(gj) / scale,
                               atol=5e-3)
    # the forward is K4 over the bf16-packed table, no point gradient
    assert torch.equal(feats.detach(), KS.hash_encode_fused(
        t(tab), t(pts), tk, "v2", packed=True))
    assert keep.all()


@pytest.mark.parametrize("level", [0, 3])
def test_tv_loss_matches_jax(level):
    # value and gradient with the same cube origin: JAX draws it from its
    # key, the port takes it as a tensor
    je, te = _pair("fixed")
    tab = _table(je.table_rows, 13)
    key = jax.random.PRNGKey(level)
    res, cube = tv_cube_size(te, level)
    mv = np.asarray(jax.random.randint(key, (3,), 0, max(res - cube, 1)))
    val_j, g_j = jax.value_and_grad(lambda p: jax_tv(
        je, {"table": p}, level, key))(jnp.asarray(tab))
    tt = t(tab).requires_grad_(True)
    val_t = total_variation_loss(te, tt, level, torch.tensor(mv))
    val_t.backward()
    assert float(val_t.detach()) == pytest.approx(float(val_j), rel=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-7)
    with pytest.raises(ValueError, match="fixed"):
        total_variation_loss(_pair("random")[1], tt, 0, torch.tensor(mv))


def test_kernel_accepts_what_the_jax_kernel_accepts():
    # supports(): F = 2, T a multiple of 1,024, L * T * 2 * 4 <= 4 MB
    for lv, log2t, ok in ((16, 13, True), (16, 15, True), (16, 16, False),
                          (1, 19, True), (1, 20, False), (4, 9, False)):
        cfg = dict(n_levels=lv, log2_hashmap_size=log2t)
        assert KS.supports(lv, 1 << log2t, 2) == ok
        if ok:
            HashGridEncoder(BBOX, use_kernel=True, device="cpu",
                            scheme="random", **cfg)
            JaxEncoder(BBOX, use_pallas=True, scheme="random", **cfg)
            continue
        with pytest.raises(ValueError, match="fused kernel"):
            HashGridEncoder(BBOX, use_kernel=True, device="cpu",
                            scheme="random", **cfg)
        with pytest.raises(ValueError):
            JaxEncoder(BBOX, use_pallas=True, scheme="random", **cfg)
    # the f32 gather has no CUDA kernel: CPU tensors only (see the GPU
    # tests); the kernel wrappers check their inputs
    _, te = _pair("random")
    with pytest.raises(ValueError, match="unsupported device"):
        KS.encode_small(torch.zeros(te.table_rows, dtype=torch.int32,
                                    device="meta"),
                        torch.zeros(8, 3, device="meta"), te)
    with pytest.raises(ValueError, match="not a small-table"):
        KS._check_enc(_pair("blocked", log2_hashmap_size=12)[1], "cpu")
