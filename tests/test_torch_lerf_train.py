"""Port parity: the LeRF train step of hashnerf_preset(use_lerf=True), and
the LeRF paths of the executor and the command line.

One step at tiny shapes with two chunks (the NeRF branch with the
coarse-ranked fine budget, the language branch against the CLIP pyramid's
per-pixel embeddings) against the JAX step: loss, img_loss, lang_loss,
every parameter group's gradient (NeRF and language tables and fields) and
Adam moments, with the tolerances of tests/test_torch_hier_train.py. Then,
on the port alone: sub-chunked LeRF serving against unchunked, and the
checkpoint round trip of the language parameters.
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
from nerfpp_tpu.data import pyramid_clip as JP
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu_torch import executor as executor_mod
from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data.pyramid_clip import (PyramidEmbedder,
                                                PyramidEmbedderProperties,
                                                RandomProjectionPatchEncoder,
                                                make_device_pyramid)
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.executor import NeRFExecutor

torch.set_num_threads(1)

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
E = 24
TINY = dict(n_levels=4, log2_hashmap_size=10, finest_resolution=64,
            n_importance=16, hier_sparse_importance=4, multires_views=4,
            thin_ray=True, compute_dtype="float32", use_lerf=True,
            lang_embed_dim=E, n_levels_le=3, log2_hashmap_size_le=10,
            finest_resolution_le=64)
TINY_TP = dict(n_samples=8, n_rand=512, n_iters=100, chunk=256)
# past both anneals (noise 0 from step 100 / 8, preconditioning from
# 100 / 6): the step draws nothing but the batch
STEP = 17


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _leaves(tree):
    return {k: v.numpy() for k, v in state_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu").items()}


def test_lerf_train_step_matches_jax():
    jx = JaxExecutor(jax_hashnerf_preset(**TINY))
    tp = JaxTrainParams(**TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    # tables at 0.05 rather than the init's 1e-4: the first layers'
    # gradients are then not sums dominated by cancellation
    params = jax.tree.map(np.array, jx.state["params"])
    rng = np.random.RandomState(2)
    for head in ("embed", "lang_embed"):
        params[head]["table"] = rng.uniform(
            -0.05, 0.05, params[head]["table"].shape).astype(np.float32)
    jx.state["params"] = jax.tree.map(jnp.asarray, params)
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    images = np.random.RandomState(1).uniform(0, 1, (3, h, w, 3)).astype(
        np.float32)
    emb = JP.PyramidEmbedder(
        JP.RandomProjectionPatchEncoder(embed_dim=E, input_size=8),
        JP.PyramidEmbedderProperties(img_size=8, overlap=0.5))(images)
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(images), poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand,
        pyramid=JP.make_device_pyramid(emb, 0.5))
    key = jax.random.PRNGKey(1)
    new, jm = jx._build_train_step(tp)({**jx.state, "step": jnp.int32(STEP)},
                                       sampler, key)
    k_batch = jax.random.split(jax.random.fold_in(key, STEP), 5)[0]
    batch = {k: t(v) for k, v in sampler.sample(k_batch,
                                                jnp.int32(STEP)).items()}
    assert batch["target_lang"].shape == (512, E)
    tx = NeRFExecutor(hashnerf_preset(**TINY), device="cpu")
    tx.initialize(BBOX, TrainParams().lrate_decay, seed=0)
    tx.load_state(state_from_jax(params, device="cpu"))
    tm = tx._build_train_step(TrainParams(**TINY_TP))(STEP, batch)
    assert tx.step == STEP + 1
    for k in ("loss", "mse", "img_loss", "lang_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert float(tm["lang_loss"]) > 0.0
    assert float(tm["loss"]) == pytest.approx(
        float(tm["img_loss"]) + float(tm["lang_loss"]), rel=1e-6)
    adam = new["opt_state"][0]
    mu, nu = _leaves(adam.mu), _leaves(adam.nu)
    names = tx.named_parameters()
    assert {n.split(".")[0] for n in names} == {"embed", "model",
                                                "lang_embed", "lang_model"}
    assert set(names) == set(mu)
    for name, prm in names.items():
        gj = mu[name] / 0.1              # fresh moments: mu = 0.1 g
        gt_ = prm.grad.numpy()
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        diff = np.abs(gt_ - gj)
        assert np.mean(diff <= 1e-4 * scale) >= 0.95, name
        top = 5e-3
        assert diff.max() <= top * scale, (name, diff.max() / scale)
        np.testing.assert_allclose(tx.optimizer.mu[name].numpy(), mu[name],
                                   atol=0.1 * top * scale, err_msg=name)
        np.testing.assert_allclose(tx.optimizer.nu[name].numpy(), nu[name],
                                   atol=2 * top * float(nu[name].max()),
                                   err_msg=name)


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=24,
                                n_samples=16, white_bkgr=False, device="cpu")


def _pyramid(scene):
    enc = RandomProjectionPatchEncoder(embed_dim=E, input_size=8)
    emb = PyramidEmbedder(enc, PyramidEmbedderProperties(img_size=8,
                                                         overlap=0.5),
                          device="cpu")(
        scene.images[list(scene.split_indices("train"))])
    return make_device_pyramid(emb, 0.5, device="cpu"), enc


def test_lerf_serving_in_parts_equals_unchunked(scene, monkeypatch):
    # 32x32 (8 tiles of 128 rays): one chunk, or parts of one tile each
    ex = NeRFExecutor(hashnerf_preset(**TINY), device="cpu")
    ex.initialize(scene.bounding_box, seed=0)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        ex.lang_embedder.table.copy_(
            torch.rand(ex.lang_embedder.table.shape, generator=g) - 0.5)
    ex.set_lerf_prompts(torch.randn(1, E, generator=g),
                        torch.randn(2, E, generator=g))
    v = scene.views[0]
    k = calibration_matrix(35.0, 32, 32)
    tp = TrainParams(n_samples=8, chunk=1024)
    whole = ex.render_view(v.pose, 32, 32, k, tp)["lerf"]
    cfg = ex.make_render_config(tp, train=False)
    # parts of 200 rays -> whole tiles of 128
    monkeypatch.setattr(executor_mod, "LERF_CHUNK_BYTES",
                        200 * (8 + 16) * (E + 1) * 4)
    assert ex._lerf_max_rays(cfg) == 200
    parts = ex.render_view(v.pose, 32, 32, k, tp)["lerf"]
    for f in ("rendered_lang_embedding", "acc", "depth", "disp",
              "relevancy"):
        a, b = getattr(parts, f), getattr(whole, f)
        assert a.shape == b.shape and a.shape[:2] == (32, 32), f
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   err_msg=f)
    assert float(whole.acc.max()) > 0.05


def test_lerf_checkpoint_round_trip(scene, tmp_path):
    pyr, _ = _pyramid(scene)
    tp = TrainParams(n_samples=8, n_rand=256, chunk=256, n_iters=4,
                     i_print=0, i_img=0, i_testset=0, i_weights=3,
                     base_dir=str(tmp_path))
    ex = NeRFExecutor(hashnerf_preset(**TINY), device="cpu")
    m = ex.train(scene, tp, lang_embeddings=pyr)
    assert np.isfinite(m["lang_loss"]) and m["lang_loss"] > 0
    st = ex.state_dict()
    assert {"lang_embed.table", "adam.mu.lang_embed.table",
            "adam.nu.lang_model.le_net.layers.2.weight"} <= set(st)
    back = NeRFExecutor(hashnerf_preset(ft_path=str(tmp_path), **TINY),
                        device="cpu")
    back.initialize(scene.bounding_box, seed=5)
    assert back.step == 3
    for key, v in back.state_dict().items():
        assert torch.equal(v, st[key]), key
    # a dense [n_train, H, W, E] stack trains as well
    dense = torch.nn.functional.normalize(
        torch.rand(2, 24, 24, E, generator=torch.Generator().manual_seed(4)),
        dim=-1)
    ex2 = NeRFExecutor(hashnerf_preset(**TINY), device="cpu")
    m2 = ex2.train(scene, TrainParams(**{**vars(tp), "i_weights": 0,
                                         "n_iters": 3}),
                   lang_embeddings=dense)
    assert np.isfinite(m2["lang_loss"])
