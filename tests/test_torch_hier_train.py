"""Port parity: the hierarchical train step of the small-table preset, and
the collapse auto-recovery of the train loop.

One step of hashnerf_tpu_preset at tiny shapes (the coarse-ranked fine
budget, the importance pass, the fixed scheme's TV loss) against the JAX
step: loss, gradients and Adam moments, with the tolerances of
tests/test_torch_train_step.py. Then the train loop's collapse recovery, forced
by a large auto_fine_rel_std, with the JAX package's quirks mirrored on
purpose.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_tpu_preset as jax_tpu_preset
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu_torch.config import TrainParams, hashnerf_tpu_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.encoders.hashgrid import tv_cube_size
from nerfpp_tpu_torch.executor import NeRFExecutor

torch.set_num_threads(1)

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
TINY = dict(n_levels=4, log2_hashmap_size=10, finest_resolution=64,
            n_importance=16, hier_sparse_importance=4, multires_views=4,
            density_activation="trunc_exp", use_pallas_encoder=False,
            thin_ray=True)
TINY_TP = dict(n_samples=8, n_rand=512, n_iters=100, chunk=512)
# the density noise is 0 from step 100 / 8 and the preconditioning alpha
# from step 100 / 6, so the step draws nothing but the batch (and TV cubes)
STEP = 17


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


@pytest.fixture(scope="module", params=[("random", "float32"),
                                        ("random", "bfloat16"),
                                        ("fixed", "float32")])
def jax_step(request):
    """The JAX executor of the tiny preset (XLA encoder, no occupancy grid:
    the coarse-ranked fine budget), its jitted train step and a sampler."""
    scheme, dtype = request.param
    jx = JaxExecutor(jax_tpu_preset(hash_scheme=scheme, compute_dtype=dtype,
                                    **TINY))
    tp = JaxTrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    # a table at 0.05 rather than the init's 1e-4: the first layer's
    # gradient is then not a sum dominated by cancellation, and the fixed
    # scheme's TV term (1e-6 x ~3) shows in the f32 loss
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
    return scheme, dtype, jx, jx._build_train_step(tp), sampler


def _leaves(tree):
    return {k: v.numpy() for k, v in state_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu").items()}


def test_hier_train_step_matches_jax(jax_step):
    scheme, dtype, jx, step_fn, sampler = jax_step
    key = jax.random.PRNGKey(1)
    jstate = {**jx.state, "step": jnp.int32(STEP)}
    new, jm = step_fn(jstate, sampler, key)
    k_batch, _, _, k_tv, _ = jax.random.split(jax.random.fold_in(key, STEP),
                                              5)
    batch = {k: t(v) for k, v in sampler.sample(k_batch,
                                                jnp.int32(STEP)).items()}
    tx = NeRFExecutor(hashnerf_tpu_preset(hash_scheme=scheme,
                                          compute_dtype=dtype, **TINY),
                      device="cpu")
    tx.initialize(BBOX, TrainParams().lrate_decay, seed=0)
    tx.load_state(state_from_jax(jax.tree.map(np.asarray, jx.state["params"]),
                                 device="cpu"))
    draws = {}
    if scheme == "fixed":
        # the TV cube origins JAX draws from k_tv, one key per level
        origins = []
        for lvl, kl in enumerate(jax.random.split(k_tv, 4)):
            res, cube = tv_cube_size(tx.embedder, lvl)
            origins.append(np.asarray(jax.random.randint(
                kl, (3,), 0, max(res - cube, 1))))
        draws["tv"] = torch.tensor(np.stack(origins))
    tm = tx._build_train_step(TrainParams(**TINY_TP))(STEP, batch,
                                                      draws=draws)
    assert tx.step == STEP + 1
    # tolerances of tests/test_torch_train_step.py: f32 to 1e-5; in bf16 a few
    # MLP operands round to the neighbouring bf16 value
    rtol = 1e-5 if dtype == "float32" else 2e-3
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rtol), k
    tv_t = float(tm["loss"]) - float(tm["img_loss"])
    tv_j = float(jm["loss"]) - float(jm["img_loss"])
    if scheme == "fixed":
        assert tv_t > 0 and tv_t == pytest.approx(tv_j, rel=1e-2)
    else:
        assert tv_t == tv_j == 0.0
    adam = new["opt_state"][0]
    mu, nu = _leaves(adam.mu), _leaves(adam.nu)
    for name, prm in tx.named_parameters().items():
        gj = mu[name] / 0.1              # fresh moments: mu = 0.1 g
        gt_ = prm.grad.numpy()
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        bulk, frac = (1e-4, 0.95) if dtype == "float32" else (1e-3, 0.99)
        diff = np.abs(gt_ - gj)
        assert np.mean(diff <= bulk * scale) >= frac, name
        top = 5e-3
        assert diff.max() <= top * scale, (name, diff.max() / scale)
        # the moments follow from the gradient bound: mu = 0.1 g moves by
        # 0.1 top of the largest g, nu = 0.01 g^2 by 2 top of its largest
        np.testing.assert_allclose(tx.optimizer.mu[name].numpy(), mu[name],
                                   atol=0.1 * top * scale, err_msg=name)
        np.testing.assert_allclose(tx.optimizer.nu[name].numpy(), nu[name],
                                   atol=2 * top * float(nu[name].max()),
                                   err_msg=name)


def _tiny_port(**kw):
    p = hashnerf_tpu_preset(n_importance=0, use_occupancy_grid=True,
                            n_levels=2, log2_hashmap_size=10,
                            finest_resolution=32, occ_grid_resolution=16,
                            occ_update_every=2, occ_tile_budget_frac=0.5,
                            occ_sparse_samples=4, occ_tile_budget_warmup=0,
                            **kw)
    return p, NeRFExecutor(p, device="cpu")


def test_collapse_recovery_restarts_the_state(tmp_path, capsys):
    # A large auto_fine_rel_std makes the first check at step 2 see a
    # collapse. Mirrored JAX quirks, on purpose: (1) the restart draws from
    # the constant seed 23, so runs with other seeds recover to the same
    # state; (2) it sets the caller's ExecutorParams in place; (3) the
    # executor's render config reads n_importance as it was at
    # construction, so the rebuilt step still renders without the fine
    # pass, as JAX's does (checked on the JAX executor below)
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=8, white_bkgr=False, device="cpu")
    tp = TrainParams(n_samples=8, n_rand=256, chunk=256, n_iters=20,
                     i_print=0, i_img=0, i_weights=0, i_testset=0,
                     base_dir=str(tmp_path))
    states = []
    for seed in (0, 1):
        p, ex = _tiny_port(auto_fine_check_from=2, auto_fine_rel_std=1e3)
        ex.train(sc, tp, seed=seed, steps=2)
        assert "collapse detected at step 2" in capsys.readouterr().out
        assert ex.params is p
        assert p.n_importance == p.auto_fine_samples == 16
        assert p.occ_tile_budget_frac == 0.0
        assert ex.n_importance == 0
        assert ex.make_render_config(tp).n_importance == 0
        assert ex.step == 0 and int(ex.optimizer.count) == 0
        assert torch.equal(ex.occupancy.density, torch.ones(16, 16, 16))
        states.append(ex.state_dict())
    _, fresh = _tiny_port()
    fresh.initialize(sc.bounding_box, tp.lrate_decay, seed=23)
    for k, v in fresh.state_dict().items():
        assert torch.equal(states[0][k], v), k
        assert torch.equal(states[1][k], v), k
    # the loop goes on from the restarted state: steps 0.. of the new run
    # while the loop counter runs on to n_iters - 1
    p, ex = _tiny_port(auto_fine_check_from=2, auto_fine_rel_std=1e3)
    m = ex.train(sc, tp, steps=6)
    assert ex.step == 4 and np.isfinite(list(m.values())).all()
    # the JAX executor's recovery leaves the same render config
    jx = JaxExecutor(jax_tpu_preset(n_importance=0, use_occupancy_grid=True))
    jx.params.n_importance = jx.params.auto_fine_samples
    assert jx.make_render_config(JaxTrainParams()).n_importance == 0
