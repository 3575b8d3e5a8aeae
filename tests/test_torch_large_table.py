"""Port parity: the large-table hash encode (the JAX package's XLA path,
use_pallas_encoder=False) and one hierarchical train step of
hashnerf_preset(), the CLI's default preset.

The port on the CPU, where encode_large and grad_large run their plain
versions, against the JAX package on the same numpy inputs: corner indices
exactly (against the jitted oracle) at the preset's geometry (16 levels,
T = 2^19), the encode against the XLA gather, the table gradient against
jax.grad, and one train step from the same converted state. The order-fixed
gradient's bin pass (grad_large_bins_plain, the kernel's plain version)
against a construction from its definition, and the sum in its order
against jax.vjp of the XLA gather.

This file: the corner indices, the encode and gradient, the encoder's
route and the train step; the sum in the bin pass's order and the plan
against its definition are in tests/test_torch_large_table_bins.py and
tests/test_torch_large_table_plan.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.kernels import hash_encode_large as KL
from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
from tests.torch_large_table_common import (BBOX, STEP, TINY, TINY_TP, _pair,
                                            _points)

torch.set_num_threads(1)


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_corner_indices_exact(scheme):
    # hashnerf_preset()'s geometry: 16 levels, T = 2^19, base 16 -> 1024
    je, te = _pair(scheme, n_levels=16, log2_hashmap_size=19,
                   finest_resolution=1024)
    pts = _points(te, 2048, 1)
    idx_j, frac_j = jax.jit(je.corner_indices)(jnp.asarray(pts))
    idx_t, frac_t = te.corner_indices(torch.from_numpy(pts))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
def test_encode_and_grad_match_the_xla_path(scheme):
    # encode_large_plain against the XLA gather within 1e-6 x max|table|
    # (f32 weights and products on both sides, the 8 corner sums in another
    # order); grad_large_plain against jax.grad of <feats, g> within 1e-5
    # of each entry's sum of |w g| (index_add_ and XLA's scatter-add sum in
    # other orders)
    je, te = _pair(scheme)
    table = np.random.RandomState(2).uniform(
        -1, 1, (te.table_rows, 2)).astype(np.float32)
    pts = _points(te, 2048, 3)
    cot = np.random.RandomState(4).standard_normal(
        (pts.shape[0], te.output_dims)).astype(np.float32)

    def feats_of(tab, x):
        return je({"table": tab}, x)[0]
    feats_j = jax.jit(feats_of)(jnp.asarray(table), jnp.asarray(pts))
    grad_j = jax.jit(jax.grad(lambda tab, x: jnp.sum(feats_of(tab, x)
                                                     * jnp.asarray(cot))))(
        jnp.asarray(table), jnp.asarray(pts))
    tab_t, pts_t = torch.from_numpy(table), torch.from_numpy(pts)
    feats_t = KL.encode_large(tab_t, pts_t, te)
    assert feats_t.shape == (pts.shape[0], te.output_dims)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                               rtol=0, atol=1e-6 * np.abs(table).max())
    grad_t = KL.grad_large(torch.from_numpy(cot), pts_t, te).numpy()
    mag = KL.grad_large_plain(torch.from_numpy(np.abs(cot)), pts_t,
                              te).numpy()
    assert np.all(np.abs(grad_t - np.asarray(grad_j)) <= 1e-5 * mag + 1e-30)
    assert np.abs(grad_t).max() > 0


def test_encoder_routes_the_f32_gather_through_the_large_kernels():
    # use_kernel=False: the forward is HashEncodeLarge (on CPU tensors its
    # plain versions, no launch counted), the backward reaches the table
    # only; the points get no gradient, as through the port's other kernels
    _, te = _pair("random")
    with torch.no_grad():
        te.table.uniform_(-1, 1, generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(_points(te, 256, 6)) * 1.2       # some outside
    x.requires_grad_(True)
    reset_launch_counts()
    feats, keep = te(x)
    assert type(feats.grad_fn).__name__ == "HashEncodeLargeBackward"
    assert bool(keep.any()) and not bool(keep.all())
    feats.sum().backward()
    assert x.grad is None or not bool(x.grad.any())
    xc = torch.minimum(torch.maximum(x.detach(), te.box_min), te.box_max)
    ref = KL.grad_large_plain(torch.ones_like(feats), xc, te)
    assert torch.allclose(te.table.grad, ref, rtol=0, atol=1e-6)
    assert set(launch_counts().values()) == {0}


def test_hashnerf_preset_train_step_matches_jax():
    # one step of hashnerf_preset() (random scheme, the f32 gather, the
    # coarse-ranked fine budget, the importance pass) at tiny widths from
    # the same converted state; tolerances of tests/test_torch_hier_train.py
    # for an f32 MLP
    jx = JaxExecutor(jax_hashnerf_preset(**TINY))
    assert not jx.params.use_pallas_encoder
    tp = JaxTrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
    params["embed"]["table"] = np.random.RandomState(2).uniform(
        -0.05, 0.05, params["embed"]["table"].shape).astype(np.float32)
    jx.state["params"] = jax.tree.map(jnp.asarray, params)
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    images = np.random.RandomState(1).uniform(0, 1, (3, h, w, 3))
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(images, jnp.float32), poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand)
    key = jax.random.PRNGKey(1)
    new, jm = jx._build_train_step(tp)({**jx.state, "step": jnp.int32(STEP)},
                                       sampler, key)
    k_batch = jax.random.split(jax.random.fold_in(key, STEP), 5)[0]
    batch = {k: torch.as_tensor(np.array(v, np.float32))
             for k, v in sampler.sample(k_batch, jnp.int32(STEP)).items()}
    tx = NeRFExecutor(hashnerf_preset(**TINY), device="cpu")
    tx.initialize(BBOX, TrainParams().lrate_decay, seed=0)
    assert not tx.embedder.use_kernel and tx.embedder.scheme == "random"
    tx.load_state(state_from_jax(params, device="cpu"))
    tm = tx._build_train_step(TrainParams(**TINY_TP))(STEP, batch)
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    mu = state_from_jax(jax.tree.map(np.asarray, new["opt_state"][0].mu),
                        device="cpu")
    for name, prm in tx.named_parameters().items():
        gj = mu[name].numpy() / 0.1          # fresh moments: mu = 0.1 g
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        diff = np.abs(prm.grad.numpy() - gj)
        assert np.mean(diff <= 1e-4 * scale) >= 0.95, name
        assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)
