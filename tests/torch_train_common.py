"""Shared shapes and helpers of the training slice's port-parity tests
(tests/test_torch_train.py, test_torch_train_render.py,
test_torch_train_step.py, and test_torch_normals.py): the box and
encoder, numpy-seeded points, images and ray batches, the tiny train-step
configuration and the JAX state carried into the port. A module, not a
test file, so that each test file imports it without running the others.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfpp_tpu.core.rays import (calibration_matrix, get_ray_batch,
                                  pose_spherical)
from nerfpp_tpu_torch.config import (TrainParams, hashnerf_blocked_preset,
                                     hashnerf_preset)
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.executor import NeRFExecutor

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


def _batch_rays(n, seed):
    rng = np.random.RandomState(seed)
    pose = pose_spherical(rng.uniform(0, 360), -30.0, 3.0)
    k = calibration_matrix(30.0, 32, 32)
    xs = rng.uniform(0, 32, n).astype(np.float32)
    ys = rng.uniform(0, 32, n).astype(np.float32)
    o, d, cone = get_ray_batch(jnp.asarray(xs), jnp.asarray(ys),
                               jnp.asarray(k), jnp.asarray(pose))
    return np.asarray(o), np.asarray(d), float(cone)


def _images(n, h, w, seed=0):
    return np.random.RandomState(seed).uniform(
        0, 1, (n, h, w, 3)).astype(np.float32)


# the tiny train step

TINY = dict(n_importance=0, log2_hashmap_size=10, finest_resolution=64,
            n_levels=4, density_activation="trunc_exp",
            use_occupancy_grid=True, occ_grid_resolution=16,
            occ_update_every=2, occ_n_bins=8, occ_phased_refresh=True,
            occ_phased_warmup=2, occ_ray_tile=128, occ_tile_budget_frac=0.5,
            occ_sparse_samples=4, occ_tile_budget_warmup=1,
            hash_scheme="blocked", use_pallas_encoder=False, thin_ray=True)
TINY_TP = dict(n_samples=8, n_rand=2048, n_iters=100, chunk=256)
STEP = 13      # raw_noise_std is 0 from step 100 / 8; not a refresh step


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


def _tiny_port(**kw):
    p = hashnerf_blocked_preset(
        n_importance=0, use_occupancy_grid=True, log2_hashmap_size=10,
        n_levels=2, finest_resolution=32, occ_grid_resolution=16,
        occ_update_every=2, occ_phased_warmup=4, occ_tile_budget_warmup=4,
        **kw)
    return NeRFExecutor(p, device="cpu")
