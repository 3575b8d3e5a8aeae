"""The JAX package's explicit data-parallel step for
tests/test_torch_parallel.py (case (a)).

A module of its own that imports JAX and the JAX package but no torch: the
test runs one of the two steps in a spawned process, which imports only
this module. Results are numpy (the Adam moments as the params pytree of
numpy arrays), so they pickle without JAX types.
"""
import numpy as np
import jax
import jax.numpy as jnp

from nerfpp_tpu.config import TrainParams, hashnerf_preset
from nerfpp_tpu.core import occupancy as JO
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.executor import NeRFExecutor
from nerfpp_tpu.parallel import mesh as jax_mesh

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
# tests/torch_train_common.py's TINY: blocked scheme, plain encoder, the
# occupancy grid with its two-class budget after step 1, thin rays
TINY = dict(n_importance=0, log2_hashmap_size=10, finest_resolution=64,
            n_levels=4, density_activation="trunc_exp",
            use_occupancy_grid=True, occ_grid_resolution=16,
            occ_update_every=2, occ_n_bins=8, occ_phased_refresh=True,
            occ_phased_warmup=2, occ_ray_tile=128, occ_tile_budget_frac=0.5,
            occ_sparse_samples=4, occ_tile_budget_warmup=1,
            hash_scheme="blocked", use_pallas_encoder=False, thin_ray=True)
TINY_TP = dict(n_samples=8, n_rand=2048, n_iters=100, chunk=256)
STEP = 13      # raw_noise_std is 0 from step 100 / 8; not a refresh step
KEY = 1


def sphere_grid(g=16, r=4.0, density=10.0):
    ii = np.indices((g, g, g)).transpose(1, 2, 3, 0)
    d = np.zeros((g, g, g), np.float32)
    d[((ii - (g - 1) / 2) ** 2).sum(-1) < r * r] = density
    return d


_SETUPS = {}


def setup(mode):
    """The JAX executor at TINY (f32 MLP, ``dp_grad_reduce=mode``) with
    the planted grid, and the tile sampler of tests/test_torch_train_step.py
    (made once a process and mode)."""
    if mode not in _SETUPS:
        _SETUPS[mode] = _setup(mode)
    return _SETUPS[mode]


def _setup(mode):
    jx = NeRFExecutor(hashnerf_preset(compute_dtype="float32",
                                      dp_grad_reduce=mode, **TINY))
    tp = TrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    jx.state["occupancy"] = JO.OccupancyGrid(
        density=jnp.asarray(sphere_grid()))
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    images = np.random.RandomState(1).rand(3, h, w, 3).astype(np.float32)
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(images), poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand, tile_h=8, tile_w=16)
    return jx, tp, sampler


def inputs(mode):
    """The state at step 13 (params, grid, optax state; numpy trees) and
    the step's own batch (split(fold_in(key, step), 5)[0]); the same in
    every mode."""
    jx, _, sampler = setup(mode)
    st = jax.tree.map(np.asarray, jax.device_get(jx.state))
    kb = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), STEP),
                          5)[0]
    batch = sampler.sample(kb, jnp.int32(STEP))
    return st, {k: np.asarray(v) for k, v in batch.items()}


def explicit_step(mode):
    """The explicit step (``mode``: the all-reduce dtype) on make_mesh(2)
    at step 13 from the initial state: its metrics, new Adam moments
    (params pytrees of numpy) and count."""
    jx, tp, sampler = setup(mode)
    mesh = jax_mesh.make_mesh(2)
    state = jax_mesh.put_replicated({**jx.state, "step": jnp.int32(STEP)},
                                    mesh)
    new, m = jx._build_train_step(tp, mesh=mesh)(state, sampler,
                                                 jax.random.PRNGKey(KEY))
    adam = new["opt_state"][0]
    return ({k: float(v) for k, v in m.items()},
            jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu), int(adam.count))
