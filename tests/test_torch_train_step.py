"""Port parity for the training slice's whole train step, against the JAX
package on the CPU: one step (loss, gradients, Adam moments, parameters) in
f32 and bf16, also from a JAX state carried across with its optax moments;
then checkpoints, the train loop and the non-finite guard on the port
alone. Shared helpers: torch_train_common.py.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core import occupancy as JO
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu_torch.config import TrainParams
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.parallel import mesh as mesh_utils
from nerfpp_tpu_torch.utils import checkpoint as ckpt
from torch_train_common import (BBOX, STEP, TINY, TINY_TP, _images, _leaves,
                                _port_from, _sphere_grid, _tiny_port, t)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_step(request):
    """The JAX executor at the tiny shapes (blocked scheme, XLA encoder, no
    importance pass), its jitted train step and a tile sampler."""
    dtype = request.param
    jx = JaxExecutor(jax_hashnerf_preset(compute_dtype=dtype, **TINY))
    tp = JaxTrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    jx.state["occupancy"] = JO.OccupancyGrid(
        density=jnp.asarray(_sphere_grid()))
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(_images(3, h, w, seed=1)),
        poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand, tile_h=8, tile_w=16)
    return dtype, jx, jx._build_train_step(tp), sampler


def _batch(sampler, key, step):
    """The train step's own batch: split(fold_in(key, step), 5)[0]."""
    kb = jax.random.split(jax.random.fold_in(key, step), 5)[0]
    jb = sampler.sample(kb, jnp.int32(step))
    return {k: t(v) for k, v in jb.items()}


def _compare_step(dtype, jx, step_fn, sampler, jstate, step, mu_prev):
    key = jax.random.PRNGKey(1)
    jstate = {**jstate, "step": jnp.int32(step)}
    tx = _port_from(dtype, jstate)
    new, jm = step_fn(jstate, sampler, key)
    tm = tx._build_train_step(TrainParams(**TINY_TP))(
        step, _batch(sampler, key, step))
    f32 = dtype == "float32"
    # bf16 MLP operands round at other places in the two frameworks, so a
    # few hidden values land on the neighbouring bf16 value: loose bounds
    rtol = 1e-5 if f32 else 2e-3
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rtol), k
    # pred_std = sqrt(E[x^2] - E[x]^2) of values near 0.5 with a spread near
    # 0.02: the difference cancels ~3 digits of the f32 sums' rounding
    assert float(tm["pred_std"]) == pytest.approx(float(jm["pred_std"]),
                                                  rel=1000 * rtol)
    adam = new["opt_state"][0]
    mu, nu = _leaves(adam.mu), _leaves(adam.nu)
    params = _leaves(new["params"])
    assert int(adam.count) == int(tx.optimizer.count)
    assert tx.step == step + 1
    for name, prm in tx.named_parameters().items():
        # the gradient JAX used, recovered from its new first moment
        gj = (mu[name] - 0.9 * mu_prev[name]) / 0.1
        gt_ = prm.grad.numpy()
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        # Gradients: every entry within 5e-3 of the largest, and 95% (f32)
        # within 1e-4, or 99% (bf16) within 1e-3. The colour net agrees to
        # ~3e-7 in f32; the sigma net and the table sum many samples' terms
        # that cancel, and XLA:CPU's own gather gradient is off by up to
        # 2e-5 per term (test_grad_plain_matches_xla_autodiff). In bf16 a
        # few MLP operands round to the neighbouring bf16 value
        bulk, frac = (1e-4, 0.95) if f32 else (1e-3, 0.99)
        diff = np.abs(gt_ - gj)
        assert np.mean(diff <= bulk * scale) >= frac, name
        assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)
        np.testing.assert_allclose(tx.optimizer.mu[name].numpy(), mu[name],
                                   atol=5e-4 * scale, err_msg=name)
        np.testing.assert_allclose(tx.optimizer.nu[name].numpy(), nu[name],
                                   atol=2e-3 * float(nu[name].max()),
                                   err_msg=name)
        # Parameters where the update is well defined: an Adam update is a
        # smooth function of g except where g is tiny (with eps 1e-15 the
        # first update is ~ lr * sign(g), and a tiny gradient may flip sign
        # between implementations). So compare where |g| > 1e-3 max|g| and
        # the two gradients agree to 1e-2 (95% of those entries or more)
        p_t = prm.detach().numpy()
        clear = np.abs(gj) > 1e-3 * scale
        same = clear & (diff <= 1e-2 * np.abs(gj))
        assert same.sum() >= 0.95 * clear.sum(), name
        np.testing.assert_allclose(p_t[same], params[name][same], rtol=1e-5,
                                   atol=1e-4, err_msg=name)
        # untouched entries (g == 0 on both sides) move only by the decayed
        # moments of earlier steps: not at all from a fresh optimizer
        untouched = (gj == 0) & (gt_ == 0)
        if not mu_prev[name].any():
            np.testing.assert_array_equal(p_t[untouched],
                                          params[name][untouched])
        np.testing.assert_allclose(p_t[untouched], params[name][untouched],
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    return new


def test_train_step_matches_jax(jax_step):
    # one whole step from a fresh optimizer: budgeted render (the sphere grid
    # splits the tiles), Huber loss, gradients through NeRFSmall and the
    # f32 gather, Adam (eps 1e-15, betas 0.9/0.99)
    dtype, jx, step_fn, sampler = jax_step
    zeros = {k: np.zeros_like(v) for k, v in _leaves(
        jx.state["params"]).items()}
    _compare_step(dtype, jx, step_fn, sampler, jx.state, STEP, zeros)


def test_converted_state_takes_the_same_next_step(jax_step):
    # a JAX state with nonzero optax moments (after one step) is carried
    # across by convert.state_from_jax, loaded, and both take step 15
    dtype, jx, step_fn, sampler = jax_step
    state, _ = step_fn({**jx.state, "step": jnp.int32(STEP)}, sampler,
                       jax.random.PRNGKey(1))
    mu_prev = _leaves(state["opt_state"][0].mu)
    tx = _port_from(dtype, state)
    assert int(tx.optimizer.count) == 1 and tx.step == STEP + 1
    np.testing.assert_array_equal(tx.optimizer.nu["embed.table"].numpy(),
                                  _leaves(state["opt_state"][0].nu)
                                  ["embed.table"])
    _compare_step(dtype, jx, step_fn, sampler, state, STEP + 2, mu_prev)


# ----------------------------------------------- checkpoints and the loop


def test_checkpoint_round_trip_and_restore_latest(tmp_path):
    ex = _tiny_port().initialize(BBOX, seed=1)
    ex.step = 7
    ex.optimizer.count.fill_(5)
    ex.optimizer.mu["embed.table"].fill_(0.25)
    path = ex.save_checkpoint(tmp_path)
    assert path.name == "step_7"
    other = _tiny_port().initialize(BBOX, seed=2)
    other.load_state(ckpt.restore_latest(tmp_path))
    for k, v in ex.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # the most recently saved wins over a higher step; equal mtimes fall
    # back to the step
    ex.step = 9
    ex.save_checkpoint(tmp_path)
    ex.step = 3
    ex.save_checkpoint(tmp_path)
    now = time.time()
    os.utime(tmp_path / "step_7", (now - 20, now - 20))
    os.utime(tmp_path / "step_9", (now - 10, now - 10))
    os.utime(tmp_path / "step_3", (now, now))
    assert int(ckpt.restore_latest(tmp_path)["step"]) == 3
    os.utime(tmp_path / "step_9", (now, now))
    assert int(ckpt.restore_latest(tmp_path)["step"]) == 9
    assert ckpt.restore_latest(tmp_path / "none") is None
    # ft_path restores at initialize
    ft = _tiny_port(ft_path=str(tmp_path)).initialize(BBOX, seed=1)
    assert ft.step == 9


def test_train_loop(tmp_path, capsys):
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=16, white_bkgr=False, device="cpu")
    tp = TrainParams(n_samples=8, n_rand=256, chunk=256, n_iters=12,
                     i_print=5, i_img=0, i_weights=10, i_testset=0,
                     steps_per_call=4, base_dir=str(tmp_path))
    ex = _tiny_port()
    seen = []
    m = ex.train(sc, tp, progress_fn=lambda i, mm: seen.append(i))
    # steps 0..10 as in the JAX loop; steps_per_call 4 shrinks to gcd 1
    assert ex.step == 11 and seen == [5, 10]
    assert sorted(d.name for d in tmp_path.iterdir()) == ["metrics.csv",
                                                          "step_10",
                                                          "step_11"]
    # metrics.csv holds the i_print rows
    rows = (tmp_path / "metrics.csv").read_text().splitlines()
    assert rows[0] == "step,mse,img_loss,pred_std,loss,psnr"
    assert [r.split(",")[0] for r in rows[1:]] == ["5", "10"]
    # the same run in stages (7 steps, then the rest) ends in the same
    # state: step i's draws depend on (seed, i) only
    staged = _tiny_port()
    staged.train(sc, TrainParams(**{**tp.__dict__, "i_weights": 0}),
                 steps=7)
    assert staged.step == 7
    staged.train(sc, TrainParams(**{**tp.__dict__, "i_weights": 0}))
    for k, v in ex.state_dict().items():
        assert torch.allclose(staged.state_dict()[k], v, rtol=1e-5,
                              atol=1e-7), k
    assert set(m) == {"mse", "img_loss", "pred_std", "loss", "psnr"}
    assert np.isfinite(list(m.values())).all()
    assert "[TRAIN] Iter: 10 of 12" in capsys.readouterr().out
    # both refresh branches ran (full before step 4, phased after) and the
    # grid is no longer the uniform prior
    assert not torch.equal(ex.occupancy.density, torch.ones(16, 16, 16))
    # the bbox refit is ported (tests/test_torch_refit.py;
    # tests/test_torch_cli.py covers i_img and i_testset)
    ex.train(sc, TrainParams(**{**tp.__dict__, "bbox_refit_step": 5}))
    # a device mesh of one rank (gloo) trains bitwise as no mesh, as the
    # JAX step takes its plain path at one device (more ranks:
    # tests/test_torch_parallel.py)
    once = TrainParams(**{**tp.__dict__, "i_weights": 0})
    plain, meshed = _tiny_port(), _tiny_port()
    plain.train(sc, once)
    with mesh_utils.one_rank("cpu") as mesh:
        meshed.train(sc, once, mesh=mesh)
    assert meshed.step == plain.step == 11
    for k, v in plain.state_dict().items():
        assert torch.equal(meshed.state_dict()[k], v), k


def test_non_finite_loss_skips_the_update():
    ex = _tiny_port().initialize(BBOX, seed=1)
    before = {k: v.clone() for k, v in ex.state_dict().items()
              if k != "step"}
    step = ex._build_train_step(TrainParams(n_samples=8, n_rand=256,
                                            chunk=256, n_iters=100))
    o = torch.zeros(256, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(256, 3).contiguous()
    batch = {"rays_o": o + torch.tensor([0.0, 0.0, 3.0]), "rays_d": d,
             "cone_angle": torch.tensor(0.01),
             "target_rgb": torch.full((256, 3), float("nan"))}
    m = step(5, batch, torch.Generator().manual_seed(0))
    assert not torch.isfinite(m["loss"])
    assert ex.step == 6
    for k, v in ex.state_dict().items():
        if k != "step":
            assert torch.equal(v, before[k]), k
