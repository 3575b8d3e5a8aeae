"""Port parity: classic NeRF (frequency encoders, NeRFMLP with its skip
and viewdirs head, classic_nerf_preset).

The port on the CPU against the JAX package on the same numpy inputs: the
frequency encoding, the MLP in f32 and bf16 from weights carried by
convert.state_from_jax, and one train step of a narrow classic_nerf_preset
(8 layers, the skip at layer 4, the 2^9 position band, importance samples)
from the same converted state.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import classic_nerf_preset as jax_classic_preset
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.encoders.frequency import FrequencyEncoder as JaxFrequency
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu.models.nerf_mlp import NeRFMLP as JaxNeRFMLP
from nerfpp_tpu_torch.config import TrainParams, classic_nerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.encoders.frequency import FrequencyEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.models.nerf_mlp import NeRFMLP

torch.set_num_threads(1)

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)


@pytest.mark.parametrize("num_freqs,include_input,log_sampling", [
    (10, True, True), (4, True, True), (6, False, False)])
def test_frequency_encoder_matches_jax(num_freqs, include_input,
                                       log_sampling):
    # the same f32 bands; sin and cos of arguments up to 2^9 x 1.5: the two
    # libraries' f32 sin/cos differ by a few ulps of the argument's
    # reduction, so the tolerance is 2e-6 absolute (the values lie in
    # [-1, 1])
    je = JaxFrequency(num_freqs, float(num_freqs - 1), include_input,
                      log_sampling=log_sampling)
    te = FrequencyEncoder(num_freqs, float(num_freqs - 1), include_input,
                          log_sampling=log_sampling)
    np.testing.assert_array_equal(te.freq_bands, je.freq_bands)
    assert te.output_dims == je.output_dims
    x = np.random.RandomState(0).uniform(-1.5, 1.5, (4096, 3)).astype(
        np.float32)
    out_j, keep_j = jax.jit(je)(jnp.asarray(x))
    out_t, keep_t = te(torch.from_numpy(x))
    assert keep_j is None and keep_t is None
    assert out_t.shape == (4096, te.output_dims)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_nerf_mlp_matches_jax(dtype, use_viewdirs):
    # weights from the JAX init (gain 1, biases made non-zero), carried by
    # state_from_jax; f32 to 1e-5 of the output's largest value; in bf16 a
    # few hidden values round to the neighbouring bf16 value in one
    # framework and not the other (2^-8 relative), so 99 % within 1e-3 and
    # all within 2e-2
    jm = JaxNeRFMLP(8, 64, 63, 27, 5, frozenset({4}), use_viewdirs,
                    init_gain=1.0,
                    compute_dtype=jnp.bfloat16 if dtype == "bfloat16"
                    else None)
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: (rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
                   if a.ndim == 1 else a), params)
    x = rng.uniform(-1, 1, (2048, 63 + 27)).astype(np.float32)
    out_j = np.asarray(jax.jit(jm.__call__)(params, jnp.asarray(x)))
    tm = NeRFMLP(8, 64, 63, 27, 5, frozenset({4}), use_viewdirs,
                 init_gain=1.0, compute_dtype=dtype, device="cpu")
    st = state_from_jax({"embed": {}, "model": params}, device="cpu")
    tm.load_state_dict({k[len("model."):]: v for k, v in st.items()})
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x)).numpy()
    assert out_t.shape == out_j.shape == (2048, 4 if use_viewdirs else 5)
    scale = float(np.abs(out_j).max())
    diff = np.abs(out_t - out_j)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * scale
    else:
        assert np.mean(diff <= 1e-3 * scale) >= 0.99
        assert diff.max() <= 2e-2 * scale


# bench.py's classic configuration (gain 1, trunc_exp density) at width 32:
# with the preset's gain of 0.1 the first layers' gradients vanish (1e-12
# of the loss) and their comparison would be one of rounding noise
TINY = dict(net_width=32, compute_dtype="float32", thin_ray=True,
            mlp_init_gain=1.0, density_activation="trunc_exp")
TINY_TP = dict(n_samples=8, n_rand=256, n_iters=100, chunk=256)
# the density noise is 0 from step 100 / 8 and the preconditioning alpha
# from step 100 / 6, so the step draws nothing but the batch
STEP = 17


@pytest.mark.parametrize("n_importance", [0, 8])
def test_classic_train_step_matches_jax(n_importance):
    # one step of classic_nerf_preset (8 layers of 32, the skip at 4,
    # frequency encodings 10 / 4, 8 coarse samples, and 8 importance
    # samples or none) from the same converted state; the loss to 1e-5.
    # Coarse only: the gradients as tests/test_torch_hier_train.py holds
    # them in f32. With importance samples the fine depths follow the
    # coarse weights, summed in another order, and the 2^9 band turns a
    # depth moved by 1e-7 into a feature moved by 5e-5: each gradient
    # within 1e-2 of its largest entry (measured: 4.2e-3)
    jx = JaxExecutor(jax_classic_preset(n_importance=n_importance, **TINY))
    tp = JaxTrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
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
    tx = NeRFExecutor(classic_nerf_preset(n_importance=n_importance, **TINY),
                      device="cpu")
    tx.initialize(BBOX, TrainParams().lrate_decay, seed=0)
    assert isinstance(tx.embedder, FrequencyEncoder)
    assert isinstance(tx.model, NeRFMLP)
    tx.load_state(state_from_jax(params, device="cpu"))
    tm = tx._build_train_step(TrainParams(**TINY_TP))(STEP, batch)
    assert tx.step == STEP + 1
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    mu = state_from_jax(jax.tree.map(np.asarray, new["opt_state"][0].mu),
                        device="cpu")
    assert set(mu) == set(tx.named_parameters())
    for name, prm in tx.named_parameters().items():
        gj = mu[name].numpy() / 0.1          # fresh moments: mu = 0.1 g
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        diff = np.abs(prm.grad.numpy() - gj)
        if n_importance == 0:
            assert np.mean(diff <= 1e-4 * scale) >= 0.95, name
            assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)
        else:
            assert diff.max() <= 1e-2 * scale, (name, diff.max() / scale)
